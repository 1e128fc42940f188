"""Fused GroupNorm (+ optional swish) over a channel-last slab: kernel B1.

Replaces qdiffusion_tpu/ops/pallas/groupnorm.py::fused_group_norm (the
pallas_call at :116, kernel body `_kernel` at :54-93) with a Triton kernel
for Hopper. Same function: f32 group sum and sum of squares, biased
variance as E[x^2] - mean^2 (:80-81), rsqrt(var + eps), the f32 affine,
output in the input dtype, swish optional (off in use: nn.group_norm_swish
applies it outside, as the JAX package does).

What bounds it: device-memory bytes. It does ~10 flops per element and
no matmul, so the least time is one read and one write of the (B, S, C)
slab at 3.35 TB/s (64x1024x128 bf16: 2 x 16.8 MB -> 10 us).

Design: a program owns whole rows of a chunk of whole groups (every
group of a row, or as many as fit 128 channels), so its loads are
contiguous row segments of up to 256 bytes (bf16), not C/G channels. It
sums its tile over rows, then over each group's channels (a (group,
channel) mask), in f32. `group_norm_plan` picks one of two paths by (B,
S, C, dtype):
- "rows" (the CIFAR slabs, up to 1024 rows a batch row): one program
  per (batch row, channel chunk) walks its S rows twice, once for the
  sums and once to normalise and write; the second read comes from L2
  (a program's slab is at most ONE_PASS_BYTES). The chunk narrows, down
  to MIN_ROW_BYTES a row, until B x chunks fills the card.
- "split" (slabs larger than L2, and batches too small to fill the card:
  the SD UNet at 64x64, the VAE decode at 256^2 and 512^2): the rows of a
  batch row are cut into `splits` pieces. group_norm_stats_kernel writes
  each piece's per-group sum and sum of squares to an f32 workspace;
  group_norm_apply_kernel adds a group's partials in a fixed order (so
  two runs give the same bits), then normalises its piece. The slab is
  read twice and written once (the one-read-one-write bound is kept as
  the bound).
The TPU design's one-hot (C,G)/(G,C) matmuls and its whole-slab-in-VMEM
plan are dropped. `group_norm_split_model` is the split path's reduction
in PyTorch, for the CPU tests. `fused_group_norm.launches` counts calls
(one or two kernels each); the profiler's kernel names show the path.

On a CPU tensor the wrapper runs `group_norm_plain`, the same arithmetic
in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from qdiffusion_torch.device import sm_count
from qdiffusion_torch.ops import refuse_grad

__all__ = ["fused_group_norm", "group_norm_plain", "group_norm_plan",
           "group_norm_split_model", "GroupNormPlan"]

# `triton.language`, bound on the first launch (triton is imported only
# when a kernel is built, so this module imports on machines without it).
tl = None

ROW_TARGET_C = 128  # channels a program's rows span at most
MIN_ROW_BYTES = 128  # narrowest row segment a "rows" program loads
ONE_PASS_BYTES = 512 << 10  # largest slab a "rows" program walks twice
TILE_ELEMS = 4096  # rows x channels of one loaded tile
SPLIT_WAVE = 4  # programs per SM a "split" launch aims at
SPLIT_CAP = 256  # most pieces of a batch row (partials each apply reads)
BLOCK_P = 16  # partials a split program's apply phase adds per step


class GroupNormPlan(NamedTuple):
    """How B1 covers a (B, S, C) slab: programs of `groups` whole groups
    (`chunks` of them per row, a `block_c`-wide tile, `block_g` a power
    of two >= groups) over `rows` rows (`splits` pieces per batch row),
    tiles of `block_s` rows; `grid` is (chunks, splits, B)."""

    path: str
    groups: int
    chunks: int
    block_c: int
    block_g: int
    block_s: int
    rows: int
    splits: int
    grid: tuple


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _chunked(num_groups: int, groups: int):
    """(groups per chunk, chunks), balanced: at most `groups` a chunk."""
    chunks = -(-num_groups // max(1, groups))
    return -(-num_groups // chunks), chunks


def group_norm_plan(B: int, S: int, C: int, num_groups: int = 32,
                    elem: int = 2, sms: int = 132) -> GroupNormPlan:
    """B1's path and chunking for a (B, S, C) slab of `elem`-byte values
    on a card of `sms` SMs (see the module note)."""
    cg = C // num_groups
    wide, _ = _chunked(num_groups, max(1, ROW_TARGET_C // cg))
    gb = wide
    while B * -(-num_groups // gb) < sms and gb > 1 \
            and (gb // 2) * cg * elem >= MIN_ROW_BYTES:
        gb = _chunked(num_groups, gb // 2)[0]
    gb, chunks = _chunked(num_groups, gb)
    bc = _pow2(gb * cg)
    if B * chunks >= sms // 2 and S * bc * elem <= ONE_PASS_BYTES:
        bs = min(_pow2(S), max(1, TILE_ELEMS // bc))
        return GroupNormPlan("rows", gb, chunks, bc, max(2, _pow2(gb)), bs,
                             S, 1, (chunks, 1, B))
    gb, chunks = _chunked(num_groups, wide)
    bc = _pow2(gb * cg)
    bs = max(1, TILE_ELEMS // bc)
    splits = min(SPLIT_CAP, -(-SPLIT_WAVE * sms // (B * chunks)),
                 -(-S // bs))
    if splits <= 1:
        return GroupNormPlan("rows", gb, chunks, bc, max(2, _pow2(gb)),
                             min(_pow2(S), bs), S, 1, (chunks, 1, B))
    rows = -(-S // splits)
    rows = -(-rows // bs) * bs
    splits = -(-S // rows)
    return GroupNormPlan("split", gb, chunks, bc, max(2, _pow2(gb)),
                         min(bs, _pow2(rows)), rows, splits,
                         (chunks, splits, B))


def group_norm_split_model(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, plan: GroupNormPlan, *,
                           num_groups: int = 32, eps: float = 1e-6,
                           swish: bool = False) -> torch.Tensor:
    """The "split" path's arithmetic in PyTorch, over channel-last x: per
    (batch row, piece, group) f32 partial sums, added in piece order,
    then the normalisation. A model of the two kernels, for tests."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    s = xg.shape[1]
    parts = [(xg[:, r0:r0 + plan.rows].sum(dim=(1, 3)),
              (xg[:, r0:r0 + plan.rows] ** 2).sum(dim=(1, 3)))
             for r0 in range(0, s, plan.rows)]
    assert len(parts) == plan.splits
    tot, tot2 = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][0])
    for p, p2 in parts:  # the apply kernel's fixed order
        tot, tot2 = tot + p, tot2 + p2
    n = s * (c // num_groups)
    mean = (tot / n)[:, None, :, None]
    var = (tot2 / n)[:, None, :, None] - mean * mean
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, -1, c)
    y = y * scale.float() + bias.float()
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(shape)


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, num_groups: int = 32, eps: float = 1e-6,
                     swish: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch, over channel-last x."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    n = xg.shape[1] * xg.shape[3]
    mean = xg.sum(dim=(1, 3), keepdim=True) / n
    var = (xg * xg).sum(dim=(1, 3), keepdim=True) / n - mean * mean
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, -1, c)
    y = y * scale.float() + bias.float()
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(shape)


@functools.cache
def _kernels() -> dict:
    """The three Triton kernels, built at the first launch: "rows" (one
    pass), "stats" and "apply" (the split path's two phases)."""
    global tl, _gn_sums, _gn_stats, _gn_normalise
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def _gn_sums(x_ptr, base, r0, r1, C, offs_c, cmask,
                 BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        """Column sums and sums of squares of rows [r0, r1), f32."""
        acc = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
        acc_sq = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
        for s0 in range(r0, r1, BLOCK_S):
            offs_s = s0 + tl.arange(0, BLOCK_S)
            mask = (offs_s < r1)[:, None] & cmask[None, :]
            xa = tl.load(x_ptr + base + offs_s[:, None] * C
                         + offs_c[None, :], mask=mask,
                         other=0.0).to(tl.float32)
            acc += xa
            acc_sq += xa * xa
        return tl.sum(acc, axis=0), tl.sum(acc_sq, axis=0)

    @triton.jit
    def _gn_stats(col, col_sq, onehot):
        """Per-group sums of per-channel sums ([BLOCK_G])."""
        return (tl.sum(tl.where(onehot, col[None, :], 0.0), axis=1),
                tl.sum(tl.where(onehot, col_sq[None, :], 0.0), axis=1))

    @triton.jit
    def _gn_normalise(x_ptr, y_ptr, scale_ptr, bias_ptr, base, c0, r0, r1,
                      C, offs_c, cmask, onehot, tot, tot_sq, n_per_group,
                      eps, BLOCK_S: tl.constexpr, SWISH: tl.constexpr):
        mean = tot / n_per_group
        # Biased variance as E[x^2] - mean^2, the TPU kernel's formula
        # (groupnorm.py:80-81). For a near-constant group with a large
        # mean the f32 cancellation can leave var slightly negative; eps
        # absorbs it while |var| < eps, past that rsqrt gives NaN, as the
        # reference does.
        inv = tl.rsqrt(tot_sq / n_per_group - mean * mean + eps)
        mean_c = tl.sum(tl.where(onehot, mean[:, None], 0.0), axis=0)
        inv_c = tl.sum(tl.where(onehot, inv[:, None], 0.0), axis=0)
        sc = tl.load(scale_ptr + c0 + offs_c, mask=cmask,
                     other=0.0).to(tl.float32)
        bi = tl.load(bias_ptr + c0 + offs_c, mask=cmask,
                     other=0.0).to(tl.float32)
        for s0 in range(r0, r1, BLOCK_S):
            offs_s = s0 + tl.arange(0, BLOCK_S)
            mask = (offs_s < r1)[:, None] & cmask[None, :]
            off = base + offs_s[:, None] * C + offs_c[None, :]
            xa = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
            y = (xa - mean_c[None, :]) * inv_c[None, :] * sc[None, :] \
                + bi[None, :]
            if SWISH:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def group_norm_rows_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, S, C, CG,
                               GB, n_per_group, eps, BLOCK_S: tl.constexpr,
                               BLOCK_C: tl.constexpr, BLOCK_G: tl.constexpr,
                               SWISH: tl.constexpr):
        cc = tl.program_id(0)
        b = tl.program_id(2)
        c0 = cc * GB * CG
        offs_c = tl.arange(0, BLOCK_C)
        cmask = (offs_c < GB * CG) & (c0 + offs_c < C)
        onehot = ((offs_c // CG)[None, :]
                  == tl.arange(0, BLOCK_G)[:, None]) & cmask[None, :]
        base = b.to(tl.int64) * S * C + c0
        col, col_sq = _gn_sums(x_ptr, base, 0, S, C, offs_c, cmask,
                               BLOCK_S, BLOCK_C)
        tot, tot_sq = _gn_stats(col, col_sq, onehot)
        _gn_normalise(x_ptr, y_ptr, scale_ptr, bias_ptr, base, c0, 0, S, C,
                      offs_c, cmask, onehot, tot, tot_sq, n_per_group, eps,
                      BLOCK_S, SWISH)

    @triton.jit
    def group_norm_stats_kernel(x_ptr, ws_ptr, S, C, CG, G, GB, R,
                                BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                                BLOCK_G: tl.constexpr):
        cc = tl.program_id(0)
        sp = tl.program_id(1)
        b = tl.program_id(2)
        c0 = cc * GB * CG
        offs_c = tl.arange(0, BLOCK_C)
        cmask = (offs_c < GB * CG) & (c0 + offs_c < C)
        gl = tl.arange(0, BLOCK_G)
        onehot = ((offs_c // CG)[None, :] == gl[:, None]) & cmask[None, :]
        r0 = sp * R
        r1 = tl.minimum(r0 + R, S)
        col, col_sq = _gn_sums(x_ptr, b.to(tl.int64) * S * C + c0, r0, r1,
                               C, offs_c, cmask, BLOCK_S, BLOCK_C)
        tot, tot_sq = _gn_stats(col, col_sq, onehot)
        g = cc * GB + gl
        gmask = (gl < GB) & (g < G)
        at = ((b * tl.num_programs(1) + sp) * G + g) * 2
        tl.store(ws_ptr + at, tot, mask=gmask)
        tl.store(ws_ptr + at + 1, tot_sq, mask=gmask)

    @triton.jit
    def group_norm_apply_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, ws_ptr,
                                S, C, CG, G, GB, R, n_per_group, eps,
                                BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                                BLOCK_G: tl.constexpr, BLOCK_P: tl.constexpr,
                                SWISH: tl.constexpr):
        cc = tl.program_id(0)
        sp = tl.program_id(1)
        b = tl.program_id(2)
        splits = tl.num_programs(1)
        c0 = cc * GB * CG
        offs_c = tl.arange(0, BLOCK_C)
        cmask = (offs_c < GB * CG) & (c0 + offs_c < C)
        gl = tl.arange(0, BLOCK_G)
        onehot = ((offs_c // CG)[None, :] == gl[:, None]) & cmask[None, :]
        g = cc * GB + gl
        gmask = (gl < GB) & (g < G)
        tot = tl.zeros([BLOCK_G], dtype=tl.float32)
        tot_sq = tl.zeros([BLOCK_G], dtype=tl.float32)
        for p0 in range(0, splits, BLOCK_P):  # pieces in a fixed order
            offs_p = p0 + tl.arange(0, BLOCK_P)
            pm = (offs_p < splits)[:, None] & gmask[None, :]
            at = ((b * splits + offs_p)[:, None] * G + g[None, :]) * 2
            tot += tl.sum(tl.load(ws_ptr + at, mask=pm, other=0.0), axis=0)
            tot_sq += tl.sum(tl.load(ws_ptr + at + 1, mask=pm, other=0.0),
                             axis=0)
        r0 = sp * R
        r1 = tl.minimum(r0 + R, S)
        _gn_normalise(x_ptr, y_ptr, scale_ptr, bias_ptr,
                      b.to(tl.int64) * S * C + c0, c0, r0, r1, C, offs_c,
                      cmask, onehot, tot, tot_sq, n_per_group, eps, BLOCK_S,
                      SWISH)

    return {"rows": group_norm_rows_kernel, "stats": group_norm_stats_kernel,
            "apply": group_norm_apply_kernel}


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           num_groups: int):
    refuse_grad("fused_group_norm", x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_group_norm: unsupported dtype {x.dtype}")
    if x.ndim < 2 or x.shape[-1] % num_groups:
        raise ValueError(f"fused_group_norm: C={x.shape[-1]} of shape "
                         f"{tuple(x.shape)} is not a multiple of "
                         f"{num_groups} groups")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm: x must be channel-last "
                         "contiguous (an NCHW tensor in channels_last)")
    c = x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if p.device != x.device or p.numel() != c or not p.is_contiguous():
            raise ValueError(f"fused_group_norm: {name} must be a "
                             f"contiguous ({c},) tensor on {x.device}")


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, num_groups: int = 32, eps: float = 1e-6,
                     swish: bool = False) -> torch.Tensor:
    """GroupNorm(+swish) over channel-last x of any rank >= 2.

    CPU tensor: the plain version. CUDA tensor: the Triton kernels on
    `group_norm_plan`'s path, or a ValueError for a layout or dtype they
    do not take, or a RuntimeError in grad mode when an input requires
    grad (the kernels have no backward). Each call on the card adds one
    to `fused_group_norm.launches`."""
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups=num_groups,
                                eps=eps, swish=swish)
    _check(x, scale, bias, num_groups)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    cg = c // num_groups
    plan = group_norm_plan(b, s, c, num_groups, x.element_size(),
                           sm_count(x.device))
    y = torch.empty_like(x)
    k = _kernels()
    n = float(s * cg)
    if plan.path == "rows":
        k["rows"][plan.grid](
            x, scale, bias, y, s, c, cg, plan.groups, n, eps,
            BLOCK_S=plan.block_s, BLOCK_C=plan.block_c,
            BLOCK_G=plan.block_g, SWISH=swish, num_warps=4)
    else:
        ws = torch.empty(b * plan.splits * num_groups * 2,
                         dtype=torch.float32, device=x.device)
        k["stats"][plan.grid](
            x, ws, s, c, cg, num_groups, plan.groups, plan.rows,
            BLOCK_S=plan.block_s, BLOCK_C=plan.block_c,
            BLOCK_G=plan.block_g, num_warps=4)
        k["apply"][plan.grid](
            x, scale, bias, y, ws, s, c, cg, num_groups, plan.groups,
            plan.rows, n, eps, BLOCK_S=plan.block_s, BLOCK_C=plan.block_c,
            BLOCK_G=plan.block_g, BLOCK_P=BLOCK_P, SWISH=swish, num_warps=4)
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
