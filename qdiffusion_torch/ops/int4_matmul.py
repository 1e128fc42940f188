"""int4 (nibble-packed) weight-streaming matmul: kernel B6 (port of
qdiffusion_tpu/ops/pallas/int4_matmul.py).

The stream engine keeps weights of 4 bits or fewer resident in device
memory as one uint8 per two values. A calibrated affine weight quantizer
gives, per output column n, w[k, n] = nib[k, n] * delta[n] + off[n] with
nib in [0, 15], so

    y[m, n] = delta[n] * (bf16(x) . nib)[m, n] + off[n] * S(bf16(x))[m]
              + const[n]

with S the row sum of x and the bias in const: one bf16 product against
the raw nibbles (exact in bf16) and the epilogue of the int8 kernels.

Packing layout (kept byte for byte, so the port reads the JAX package's
packs): K is folded in half; wp[k, n] holds nib[k, n] in its low nibble
and nib[k + K/2, n] in its high nibble (`pack_int4_weight`). K must be
even: the stream pack pads an odd K with a zero row and the consumer pads
x with a zero column (ops/qlayers.py).

B6 replaces `int4_stream_matmul` (pallas_call :129; wrapper
`int4_dense_stream` :170) with the CUDA C++ kernel in csrc/int_matmul.cu
that B5 uses, on B5's launch plan (int8_matmul.py::stream_plan): a ring
stage holds packed rows [k0, k0+32) as bytes, and their low and high
nibbles, widened to bf16 in registers, multiply x columns [k0, k0+32) and
[K/2+k0, K/2+k0+32). A K split covers packed rows, so each split keeps
that pairing. `int4_dense_stream` takes any device: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel through
`int4_stream_matmul`, which counts its launches and raises on what the
kernel does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from qdiffusion_torch.ops.int8_matmul import launch_stream, per_column

__all__ = ["pack_int4_weight", "unpack_int4_weight", "int4_stream_plain",
           "int4_stream_matmul", "int4_dense_stream"]


def pack_int4_weight(nib: torch.Tensor) -> torch.Tensor:
    """(K, N) nibble grid in [0, 15] -> (K/2, N) uint8, K-halves packed.
    K must be even (zero-pad first; a zero x column makes a pad row
    inert)."""
    K = nib.shape[0]
    if K % 2:
        raise ValueError(f"pack_int4_weight: K={K} must be even")
    nib = nib.to(torch.uint8)
    return (nib[: K // 2] | (nib[K // 2:] << 4)).contiguous()


def unpack_int4_weight(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4_weight: (K/2, N) uint8 -> (K, N) int32."""
    w32 = wp.to(torch.int32)
    return torch.cat([w32 & 0xF, w32 >> 4], dim=0)


def int4_stream_plain(x: torch.Tensor, wp: torch.Tensor,
                      scale: torch.Tensor, off: torch.Tensor,
                      const: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """B6's function in PyTorch: (M, K) x . packed (K/2, N) -> (M, N).
    bf16 x nibble products are exact in f32, so an f32 matmul (TF32 off)
    computes the kernel's products and sums them in another order."""
    xb = x.to(torch.bfloat16).float()
    acc = torch.matmul(xb, unpack_int4_weight(wp).float())
    s = xb.sum(dim=-1, keepdim=True)
    return (acc * scale + s * off + const).to(out_dtype or x.dtype)


def int4_stream_matmul(x: torch.Tensor, wp: torch.Tensor,
                       scale: torch.Tensor, off: torch.Tensor,
                       const: torch.Tensor, *,
                       out_dtype=torch.float32) -> torch.Tensor:
    """One launch of B6 on CUDA tensors: (M, K) f32/bf16 x . (K/2, N)
    uint8 pack -> (M, N) out_dtype. scale / off / const: contiguous f32
    (N,). Adds one to `int4_stream_matmul.launches`."""
    y = launch_stream("int4_stream_matmul", x, wp, scale, off, const,
                      out_dtype, int4=True)
    int4_stream_matmul.launches += 1
    return y


int4_stream_matmul.launches = 0


def int4_dense_stream(x: torch.Tensor, wp: torch.Tensor, scale, off,
                      bias: Optional[torch.Tensor] = None, *,
                      out_dtype=None) -> torch.Tensor:
    """x (..., K) . packed wp (K/2, N) -> (..., N) in out_dtype (default
    x's); scale / off: the per-column delta and nibble offset; the bias
    rides in the epilogue (JAX int4_matmul.py:170). CPU tensor: the plain
    version; CUDA tensor: kernel B6."""
    lead, K = x.shape[:-1], x.shape[-1]
    K2, n = wp.shape
    if K != 2 * K2:
        raise ValueError(f"int4_dense_stream: x has K={K}, the pack "
                         f"{2 * K2} rows")
    dev = x.device
    xm = x.reshape(-1, K)
    scale, off = per_column(scale, n, dev), per_column(off, n, dev)
    const = per_column(0.0 if bias is None else bias, n, dev)
    out_dtype = out_dtype or x.dtype
    if dev.type == "cpu":
        y = int4_stream_plain(xm, wp, scale, off, const, out_dtype)
    else:
        y = int4_stream_matmul(xm.contiguous(), wp, scale, off, const,
                               out_dtype=out_dtype)
    return y.reshape(*lead, n)
