"""Flash attention with exact static-delta quantization: kernel B2.

Replaces qdiffusion_tpu/ops/pallas/flash_attention.py::flash_attention
(the pallas_call at :170, kernel body `_kernel` at :87-135) with the CUDA
C++ kernel in csrc/flash_attention.cu (B2's switches: normalise after PV
when there is no softmax quantizer).

The function, over (B, T, H, D) queries and (B, S, H, D) keys/values:
scores q.k^T * scale in f32 (bf16 operands, f32 sums; f32 inputs: all
f32), the row softmax through the row reciprocal, then
  * without sm_q: (bf16(exp(s - m)) . v) * (1/sum)   (TPU :117-124);
  * with sm_q: p = exp(s - m) * (1/sum), rounded to bf16 for bf16 inputs
    (TPU :126-129), fake-quantized by `_fq`, then bf16(p) . v.
V is fake-quantized before the kernel (hoisted, TPU :266-270).

What bounds it on an H100: at the SD shapes (S = 4096, D = 40 and
S = 1024, D = 80) the exponent unit, then the QK^T and PV passes; see the
source note in csrc/flash_attention.cu for the design. The TPU kernel
holds one whole (tile_q, S) score tile in VMEM; shared memory cannot, so
the CUDA kernel streams key blocks twice (row statistics, then p and PV),
which gives the same normalized probabilities the quantizer needs.

Which kernel serves which input: bf16 with D <= 128
(every SD fold site) runs `flash_mma_kernel`, the Hopper design (score,
p and output fragments in registers, one exponential per score without
sm_q); f32 (the stream engine) and D > 128 run `flash_kernel`, the first
design.

`flash_supported` is the TPU cost model (`_pick_tile_q`, TPU :39-58 and
:288-298) without its backend test: ops/attention.py uses it to pick B2
or B3 for a shape exactly as the TPU package does, so each shape gets the
same function, rounding included.

On a CPU tensor the wrapper runs `flash_attention_plain`, the same
arithmetic in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qdiffusion_torch.quant.affine import AffineQuantizerSpec, fake_quant

__all__ = ["flash_attention", "flash_attention_plain", "flash_supported"]

QPair = Optional[Tuple[dict, AffineQuantizerSpec]]

_VMEM_BUDGET = 15 * 1024 * 1024  # the TPU kernel's scoped-VMEM budget
_PLAIN_ROWS = 1024  # query rows per chunk of the plain version


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_tile_q(S: int, Dp: int, itemsize: int) -> Optional[int]:
    """The TPU q-tile choice (flash_attention.py:39-58); None when no tile
    fits, where the TPU package streams (B3) instead."""
    kv = 2 * S * Dp * itemsize
    prefs = (512, 256, 128, 64, 32) if S >= 2048 else (256, 128, 64, 32)
    for tq in prefs:
        if tq * S * 4 + 2 * kv <= _VMEM_BUDGET:
            return tq
    return None


def flash_supported(q_shape, k_shape, itemsize: int = 2) -> bool:
    """True where the TPU package runs B2 for this shape and dtype size,
    False where it streams through B3."""
    S = _round_up(k_shape[1], 128)
    Dp = _round_up(q_shape[-1], 128)
    return _pick_tile_q(S, Dp, itemsize) is not None


def _fq(x: torch.Tensor, delta, inv_delta, zp, *, n_levels: int,
        symmetric: bool, always_zero: bool = False,
        nonneg: bool = False) -> torch.Tensor:
    """The kernels' fake-quant of probabilities (TPU flash_attention.py:
    61-84): multiplies by 1/delta (not a division), rounds half to even,
    and drops the lower clip for nonneg always_zero inputs."""
    xi = torch.round(x * inv_delta)
    if not always_zero:
        xi = xi + zp
    if symmetric:
        xq = torch.clamp(xi, -n_levels - 1, n_levels)
    elif nonneg and always_zero:
        xq = torch.clamp(xi, max=n_levels - 1)
    else:
        xq = torch.clamp(xi, 0, n_levels - 1)
    if always_zero:
        return xq * delta
    return (xq - zp) * delta


def sm_scalars(sm_q: QPair):
    """(delta, 1/delta, zero_point) as f32 tensors, and the static config."""
    st, spec = sm_q
    delta = torch.as_tensor(st["delta"]).float().reshape(())
    zp = torch.as_tensor(st["zero_point"]).float().reshape(())
    return delta, 1.0 / delta, zp, spec


def hoist_v_quant(v: torch.Tensor, v_q: QPair) -> torch.Tensor:
    if v_q is None:
        return v
    st, spec = v_q
    return fake_quant(v, st["delta"], st["zero_point"], spec)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, sm_q: QPair = None,
                          v_q: QPair = None) -> torch.Tensor:
    """B2's function in plain PyTorch, query rows in chunks (each row's
    softmax is over all S keys, as in the TPU kernel)."""
    v = hoist_v_quant(v, v_q)
    bf16 = q.dtype == torch.bfloat16
    cd = torch.bfloat16 if bf16 else torch.float32
    # bf16 products are exact in f32: f32 matmuls of the upcast operands
    # are bf16 MMAs with f32 accumulation
    kf = k.float()
    vf = v.to(cd).float()
    sm = sm_scalars(sm_q) if sm_q is not None else None
    outs = []
    for t0 in range(0, q.shape[1], _PLAIN_ROWS):
        qf = q[:, t0:t0 + _PLAIN_ROWS].float()
        s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        linv = 1.0 / e.sum(dim=-1, keepdim=True)
        if sm is None:
            o = torch.einsum("bhts,bshd->bhtd", e.to(cd).float(), vf) * linv
        else:
            delta, inv, zp, spec = sm
            p = e * linv
            if bf16:
                p = p.to(torch.bfloat16).float()
            p = _fq(p, delta.to(p.device), inv.to(p.device), zp.to(p.device),
                    n_levels=spec.n_levels, symmetric=spec.symmetric,
                    always_zero=spec.always_zero, nonneg=True)
            o = torch.einsum("bhts,bshd->bhtd", p.to(cd).float(), vf)
        outs.append(o.to(q.dtype).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1)


def check_inputs(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Device, dtype, shape and layout checks of the CUDA wrappers."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: unsupported dtype {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, T, H, D) x (B, S, H, D)")
    for name, a in (("k", k), ("v", v)):
        if a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{fn}: {name} is {a.dtype} on {a.device}, q is "
                             f"{q.dtype} on {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{fn}: q, k and v must be contiguous (B, L, H, D)")


def launch(fn: str, q, k, v, *, scale: float, sm_q: QPair,
           norm_before: bool) -> torch.Tensor:
    """One launch of csrc/flash_attention.cu on q's current stream."""
    from qdiffusion_torch.ops import _cuda

    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty_like(q)
    sm_ptr, n_levels, symmetric, always_zero = None, 0, 0, 0
    if sm_q is not None:
        st, spec = sm_q
        # [delta, zero_point] stays on the device: no host sync per launch
        sm_t = torch.stack([torch.as_tensor(st["delta"]).reshape(()),
                            torch.as_tensor(st["zero_point"]).reshape(())]
                           ).to(device=q.device, dtype=torch.float32)
        sm_ptr = sm_t.data_ptr()
        n_levels, symmetric, always_zero = (spec.n_levels,
                                            int(spec.symmetric),
                                            int(spec.always_zero))
    lib = _cuda.library("flash_attention.cu")
    err = lib.qdt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), sm_ptr,
        B, T, S, H, D, float(scale), int(q.dtype == torch.bfloat16),
        int(sm_q is not None), n_levels, symmetric, always_zero,
        int(norm_before), _cuda.stream_ptr(q.device))
    _cuda.check(err, f"{fn} (B={B}, T={T}, S={S}, H={H}, D={D}, "
                     f"{q.dtype}, sm_q={sm_q is not None})")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, sm_q: QPair = None,
                    v_q: QPair = None) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, H, D) -> (B, T, H, D).

    sm_q / v_q: optional (state, spec) pairs of the softmax and V
    quantizers. CPU tensor: the plain version. CUDA tensor: the kernel,
    or a ValueError for what it does not take. Each kernel launch adds
    one to `flash_attention.launches` (and to `.launches_sm_q` when the
    softmax quantizer is on)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, sm_q=sm_q,
                                     v_q=v_q)
    check_inputs("flash_attention", q, k, v)
    v = hoist_v_quant(v, v_q)
    o = launch("flash_attention", q, k, v, scale=scale, sm_q=sm_q,
               norm_before=False)
    flash_attention.launches += 1
    flash_attention.launches_sm_q += sm_q is not None
    return o


flash_attention.launches = 0
flash_attention.launches_sm_q = 0
