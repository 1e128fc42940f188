"""Integer matmuls with fused dequantizing epilogues: kernels B4 and B5
(port of qdiffusion_tpu/ops/pallas/int8_matmul.py).

B4 replaces `int8_matmul_dequant` (pallas_call :88; wrapper
`int8_dense_pallas` :124), the int8 engine's product. Per output column n,
with S the row sum of the recentred activations x_c:

    y = A[n] * (x_c . w_c) + Bc[n] * S(x_c) + C[n]       x_c, w_c int8

The int32 accumulation is exact, so the port's result equals the JAX
package's except for the f32 epilogue.

B5 replaces `int8_stream_matmul` (pallas_call :216; wrapper
`int8_dense_stream` :249), the stream engine's product with int8 weights
resident in device memory:

    y = scale[n] * (bf16(x) . w_c) + shift[n] * S(bf16(x)) + const[n]

with the bias fused into const. int8 values are exact in bf16, so the
products are those of the fold engine's bf16 matmul.

Both are CUDA C++ in csrc/int_matmul.cu (see its note for what bounds them
on an H100 and the design). B4's kernel is the int8 engine's implicit-GEMM
convolution (ops/int8_conv.py); `int8_matmul_dequant` runs it on an
(M, K) int8 x as M pixels of K channels. B5 (and B6, which shares its
launch) runs on
`stream_plan`: a tile height chosen by M and a K split, added up in a
fixed order, wherever the output tiles alone leave SMs idle. The TPU
wrappers pad (M, K, N) to Mosaic's tiles; the CUDA kernels mask their
ragged edges, so nothing is padded.

`int8_dense_pallas` and `int8_dense_stream` take any device: a CPU tensor
runs the plain version (the same arithmetic in PyTorch), a CUDA tensor
launches the kernel through `int8_matmul_dequant` / `int8_stream_matmul`,
which count their launches and raise on what the kernel does not take.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from qdiffusion_torch.device import sm_count

__all__ = ["int8_matmul_dequant", "int8_matmul_plain", "int8_dense_pallas",
           "int8_stream_matmul", "int8_stream_plain", "int8_dense_stream",
           "per_column", "StreamPlan", "stream_plan", "SD_STREAM_W4",
           "SD_STREAM_W8"]


def per_column(a, n: int, device) -> torch.Tensor:
    """A per-output-column constant (a Python number, or a tensor of one
    or N values in any float dtype) as a contiguous f32 (N,) tensor on
    `device`. A number is filled on the device: no host-to-device copy."""
    if isinstance(a, (int, float)):
        return torch.full((n,), float(a), dtype=torch.float32, device=device)
    return torch.as_tensor(a, dtype=torch.float32, device=device).reshape(
        -1).expand(n).contiguous()


# -- B4 ----------------------------------------------------------------------

def int8_matmul_plain(x_c: torch.Tensor, w_c: torch.Tensor,
                      scale_a: torch.Tensor, scale_s: torch.Tensor,
                      const: torch.Tensor) -> torch.Tensor:
    """B4's function in PyTorch: (M, K) int8 . (K, N) int8 -> (M, N) f32.

    The products of int8 values and their sums stay below 2^53 for any K
    below 2^39, so a float64 matmul gives the int32 accumulator exactly on
    every device (torch has no int8 matmul on the CPU and the card alike).
    S(x_c) is an f32 sum of integers below 2^24: exact."""
    acc = torch.matmul(x_c.double(), w_c.double()).to(torch.int32)
    s = x_c.float().sum(dim=-1, keepdim=True)
    return acc.float() * scale_a + s * scale_s + const


def _check_operands(fn: str, x, w, consts, w_dtype, k_rows):
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != k_rows:
        raise ValueError(f"{fn}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not multiply")
    if w.dtype != w_dtype or w.device != x.device:
        raise ValueError(f"{fn}: w is {w.dtype} on {w.device}, the kernel "
                         f"takes {w_dtype} on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{fn}: x and w must be contiguous row-major")
    n = w.shape[1]
    for name, a in consts.items():
        if a.dtype != torch.float32 or a.device != x.device \
                or a.shape != (n,) or not a.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous f32 ({n},) "
                             f"tensor on {x.device}")
    if max(x.shape[0], n, x.shape[1]) >= 2**31:
        raise ValueError(f"{fn}: a dimension of {tuple(x.shape)} x "
                         f"{tuple(w.shape)} exceeds the kernel's int range")


def int8_matmul_dequant(x_c: torch.Tensor, w_c: torch.Tensor,
                        scale_a: torch.Tensor, const: torch.Tensor,
                        scale_s: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One launch of B4 on CUDA tensors: (M, K) int8 . (K, N) int8 ->
    (M, N) f32, epilogue fused. scale_a / scale_s / const: contiguous f32
    (N,) (scale_s None: zeros, for symmetric weights). The kernel is the
    int8 engine's convolution (ops/int8_conv.py) at M pixels of K
    channels, 1 x 1 filter; it reads w in (N, K) order, so w_c is
    transposed into a copy first. Raises ValueError for what the kernel
    does not take. Adds one to `int8_matmul_dequant.launches`."""
    from qdiffusion_torch.ops.int8_conv import dense_geometry, int8_conv

    if scale_s is None:
        scale_s = torch.zeros_like(scale_a)
    if x_c.dtype != torch.int8:
        raise ValueError(f"int8_matmul_dequant: unsupported dtype {x_c.dtype}")
    _check_operands("int8_matmul_dequant", x_c, w_c,
                           {"scale_a": scale_a, "scale_s": scale_s,
                            "const": const}, torch.int8, x_c.shape[1])
    M, K = x_c.shape
    seg = {"c0": 0, "C": K, "w_t": w_c.t().contiguous(), "A": scale_a,
           "Bc": scale_s, "Cc": const, "lo": -128, "hi": 127, "center": 0,
           "a_pad": 0}
    y = int8_conv(x_c, (K, 0, 0), dense_geometry(M), [seg], None,
                  torch.float32)
    int8_matmul_dequant.launches += 1
    return y


int8_matmul_dequant.launches = 0


def int8_dense_pallas(x_c: torch.Tensor, w_c: torch.Tensor, scale_a,
                      scale_s, const) -> torch.Tensor:
    """(M, K) int8 . (K, N) int8 -> (M, N) f32 with the int8 engine's
    epilogue (the JAX wrapper of the same name, int8_matmul.py:124).
    scale_a / scale_s / const: per-column (N,) or scalars. CPU tensor: the
    plain version; CUDA tensor: kernel B4."""
    n, dev = w_c.shape[1], x_c.device
    scale_a, scale_s, const = (per_column(a, n, dev)
                               for a in (scale_a, scale_s, const))
    if dev.type == "cpu":
        return int8_matmul_plain(x_c, w_c, scale_a, scale_s, const)
    return int8_matmul_dequant(x_c, w_c, scale_a, const, scale_s)


# -- B5 (and the launch B6 shares) -------------------------------------------

def int8_stream_plain(x: torch.Tensor, w_c: torch.Tensor,
                      scale: torch.Tensor, shift: torch.Tensor,
                      const: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """B5's function in PyTorch: (M, K) x . (K, N) int8 -> (M, N). x is
    rounded to bf16; bf16 x int8 products are exact in f32, so an f32
    matmul (TF32 off) computes the kernel's products and sums them in
    another order."""
    xb = x.to(torch.bfloat16).float()
    acc = torch.matmul(xb, w_c.float())
    s = xb.sum(dim=-1, keepdim=True)
    return (acc * scale + s * shift + const).to(out_dtype or x.dtype)


#: The stream kernels' launch geometry (csrc/int_matmul.cu): block tiles
#: of 16 or 32 rows by STREAM_BN columns, and 64 x columns per ring stage
#: (64 int8 weight rows for B5, 32 packed rows for B6).
STREAM_TILE_ROWS = (16, 32)
STREAM_BN = 128
STREAM_X_STAGE = 64
STREAM_WAVE = 2  # blocks per SM that a grid should reach before K is split
STREAM_SPLIT_CAP = 16  # most K splits of one launch
STREAM_MIN_STAGES = 4  # fewest ring stages a split walks


class StreamPlan(NamedTuple):
    """How one B5 / B6 launch covers (M, N, K): `bm` x `bn` tiles on a
    grid of (n_tiles, m_tiles, splits) blocks; split s walks weight rows
    [s * kps, min((s + 1) * kps, kw)) in stages of `stage_rows`."""

    bm: int
    bn: int
    splits: int
    kps: int
    kw: int
    stage_rows: int
    grid: tuple


def stream_plan(M: int, N: int, K: int, int4: bool, sms: int = 132,
                splits: Optional[int] = None) -> StreamPlan:
    """The launch plan of B5 (int4 False) or B6 at (M, K) x (K, N) on a
    card of `sms` SMs: a 16 x 128 tile (one mma.sync row block) for
    M <= 16, which is pure weight streaming, and 32 x 128 above (the
    fastest tile on an H100 over the SD stream shapes, from 128 to 8,192
    rows: PERF.md section 6). Where the output tiles give fewer than
    STREAM_WAVE blocks per SM, K is split (on stage boundaries, at most
    STREAM_SPLIT_CAP ways, each split at least STREAM_MIN_STAGES stages)
    until the grid does. `splits` asks for that many splits instead (as
    many as whole stages allow, for a sweep)."""
    bm = 16 if M <= 16 else 32
    bn = STREAM_BN
    kw = K // 2 if int4 else K
    stage_rows = STREAM_X_STAGE // (2 if int4 else 1)
    stages = -(-kw // stage_rows)
    tiles = -(-M // bm) * -(-N // bn)
    wave = STREAM_WAVE * sms
    if splits is None:
        splits = 1
        if tiles < wave:
            splits = max(1, min(STREAM_SPLIT_CAP, -(-wave // tiles),
                                stages // STREAM_MIN_STAGES))
    per = -(-stages // splits)  # stages per split
    splits = -(-stages // per)  # no empty split
    return StreamPlan(bm, bn, splits, per * stage_rows, kw, stage_rows,
                      (-(-N // bn), -(-M // bm), splits))


# The product shapes of B5 / B6 in one SD v1 stream UNet call at batch 2
# (CFG of batch 1, 64x64 latents), which the plan tests and the card
# bench cover: (M, K, N) -> launches per call, from the UNet's config (model
# channels 320, channel_mult (1, 2, 4, 4), 2 res blocks per level, spatial
# transformers at 64x64, 32x32, 16x16 and the 8x8 middle, context 77 x
# 768) and the stream engine's byte cost model (ops/qlayers.py::
# _stream_conv_profitable): M = 2 * H * W for convs (K = 9 C_in for 3x3)
# and token linears, M = 2 for the time-embedding and emb_layers linears,
# M = 2 * 77 for the context k/v projections.
# B6 (W4): all 184 linears and the 36 convs the cost model streams.
SD_STREAM_W4 = {
    (2, 320, 1280): 1,       # time_embed.0
    (2, 1280, 320): 5,       # emb_layers at 320 channels
    (2, 1280, 640): 5,
    (2, 1280, 1280): 13,     # time_embed.2 and emb_layers at 1280
    (128, 1280, 1280): 8,    # 8x8 middle transformer q/k/v/out, proj 1x1
    (128, 1280, 10240): 1,   # its GEGLU projection
    (128, 2560, 1280): 3,    # 8x8 decoder 1x1 skips
    (128, 5120, 1280): 1,    # its GEGLU output
    (128, 11520, 1280): 12,  # 8x8 3x3 convs, 1280 in
    (128, 23040, 1280): 3,   # 8x8 decoder 3x3 convs, 2560 in
    (154, 768, 320): 10,     # context k/v projections
    (154, 768, 640): 10,
    (154, 768, 1280): 12,
    (512, 640, 1280): 1,
    (512, 1280, 1280): 40,
    (512, 1280, 10240): 5,
    (512, 1920, 1280): 1,
    (512, 2560, 1280): 2,
    (512, 5120, 1280): 5,
    (2048, 640, 640): 30,
    (2048, 640, 5120): 5,
    (2048, 1280, 640): 1,
    (2048, 1920, 640): 1,
    (2048, 2560, 640): 5,
    (8192, 320, 320): 30,
    (8192, 320, 2560): 5,
    (8192, 1280, 320): 5,
}
# B5 (W8): the 34 convs the cost model streams (8-bit linears dequantize
# and take a plain matmul)
SD_STREAM_W8 = {
    (128, 1280, 1280): 2,
    (128, 2560, 1280): 3,
    (128, 11520, 1280): 12,
    (128, 23040, 1280): 3,
    (512, 1280, 1280): 10,
    (512, 1920, 1280): 1,
    (512, 2560, 1280): 2,
    (2048, 1920, 640): 1,
}


def launch_stream(fn: str, x: torch.Tensor, w: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor,
                  const: torch.Tensor, out_dtype, int4: bool
                  ) -> torch.Tensor:
    """One launch of csrc/int_matmul.cu's streaming kernel: B5 (int4
    False; w (K, N) int8) or B6 (int4 True; w (K/2, N) uint8 nibbles),
    on `stream_plan`'s tile and K splits (a split launch adds its
    partials in a second kernel, over a workspace allocated here)."""
    from qdiffusion_torch.ops import _cuda

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: unsupported dtype {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: unsupported out_dtype {out_dtype}")
    if int4 and x.shape[-1] % 2:
        raise ValueError(f"{fn}: K={x.shape[-1]} must be even (the pack "
                         "folds K in half)")
    _check_operands(fn, x, w, {"scale": scale, "shift": shift,
                                      "const": const},
                           torch.uint8 if int4 else torch.int8,
                           x.shape[1] // 2 if int4 else x.shape[1])
    M, K = x.shape
    N = w.shape[1]
    plan = stream_plan(M, N, K, int4, sm_count(x.device))
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = torch.empty(plan.splits * M * (N + 1), dtype=torch.float32,
                     device=x.device) if plan.splits > 1 else None
    err = _cuda.library("int_matmul.cu").qdt_stream_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        const.data_ptr(), y.data_ptr(), None if ws is None else
        ws.data_ptr(), M, N, K, int(x.dtype == torch.bfloat16), int(int4),
        int(out_dtype == torch.bfloat16), plan.bm, plan.splits, plan.kps,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, f"{fn} (M={M}, K={K}, N={N}, x {x.dtype}, {plan})")
    return y


def int8_stream_matmul(x: torch.Tensor, w_c: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor,
                       const: torch.Tensor, *,
                       out_dtype=torch.float32) -> torch.Tensor:
    """One launch of B5 on CUDA tensors: (M, K) f32/bf16 x . (K, N) int8
    -> (M, N) out_dtype. scale / shift / const: contiguous f32 (N,). Adds
    one to `int8_stream_matmul.launches`."""
    y = launch_stream("int8_stream_matmul", x, w_c, scale, shift, const,
                      out_dtype, int4=False)
    int8_stream_matmul.launches += 1
    return y


int8_stream_matmul.launches = 0


def int8_dense_stream(x: torch.Tensor, w_c: torch.Tensor, scale, shift,
                      bias: Optional[torch.Tensor] = None, *,
                      out_dtype=None) -> torch.Tensor:
    """x (..., K) . w_c (K, N) int8 -> (..., N) in out_dtype (default x's),
    the weight dequantized as w_c * scale + shift per column inside the
    product; the bias rides in the epilogue (JAX int8_matmul.py:249).
    CPU tensor: the plain version; CUDA tensor: kernel B5."""
    lead, K = x.shape[:-1], x.shape[-1]
    n, dev = w_c.shape[1], x.device
    xm = x.reshape(-1, K)
    scale, shift = per_column(scale, n, dev), per_column(shift, n, dev)
    const = per_column(0.0 if bias is None else bias, n, dev)
    out_dtype = out_dtype or x.dtype
    if dev.type == "cpu":
        y = int8_stream_plain(xm, w_c, scale, shift, const, out_dtype)
    else:
        y = int8_stream_matmul(xm.contiguous(), w_c, scale, shift, const,
                               out_dtype=out_dtype)
    return y.reshape(*lead, n)
