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

Design: one program per (group, batch), 32 x 64 = 2048 programs at the
CIFAR batch, enough to fill 132 SMs. A program walks its S x C/G block
(row stride C) twice: once to accumulate the f32 sum and sum of squares,
once to normalise and write. The second read hits L2 (the largest CIFAR
group block is 1024 x 12 x 2 B = 24 KB), so device memory sees one read
and one write. The group index is the fast grid axis, so the 32 programs
of one batch row run together and share the 32-byte sectors their
narrow rows fall in. The TPU design's one-hot (C,G)/(G,C) matmuls and its
whole-slab-in-VMEM plan are dropped: a program reduces its own group.
C/G is padded to a power of two (12 -> 16 at C=384) and masked.

On a CPU tensor the wrapper runs `group_norm_plain`, the same arithmetic
in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["fused_group_norm", "group_norm_plain"]

# `triton.language`, bound on the first launch (triton is imported only
# when a kernel is built, so this module imports on machines without it).
tl = None


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
def _kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def group_norm_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, S, C, CG,
                          n_per_group, eps, BLOCK_S: tl.constexpr,
                          BLOCK_CG: tl.constexpr, SWISH: tl.constexpr):
        g = tl.program_id(0)
        b = tl.program_id(1)
        base = b.to(tl.int64) * S * C + g * CG
        offs_c = tl.arange(0, BLOCK_CG)
        cmask = offs_c < CG
        acc = tl.zeros([BLOCK_S, BLOCK_CG], dtype=tl.float32)
        acc_sq = tl.zeros([BLOCK_S, BLOCK_CG], dtype=tl.float32)
        for s0 in range(0, S, BLOCK_S):
            offs_s = s0 + tl.arange(0, BLOCK_S)
            mask = (offs_s < S)[:, None] & cmask[None, :]
            ptrs = x_ptr + base + offs_s[:, None] * C + offs_c[None, :]
            xa = tl.load(ptrs, mask=mask, other=0.0).to(tl.float32)
            acc += xa
            acc_sq += xa * xa
        mean = tl.sum(tl.sum(acc, axis=1), axis=0) / n_per_group
        # Biased variance as E[x^2] - mean^2, the TPU kernel's formula
        # (groupnorm.py:80-81). For a near-constant group with a large
        # mean the f32 cancellation can leave var slightly negative; eps
        # absorbs it while |var| < eps, past that rsqrt gives NaN, as the
        # reference does.
        var = tl.sum(tl.sum(acc_sq, axis=1), axis=0) / n_per_group \
            - mean * mean
        inv = tl.rsqrt(var + eps)
        sc = tl.load(scale_ptr + g * CG + offs_c, mask=cmask,
                     other=0.0).to(tl.float32)
        bi = tl.load(bias_ptr + g * CG + offs_c, mask=cmask,
                     other=0.0).to(tl.float32)
        for s0 in range(0, S, BLOCK_S):
            offs_s = s0 + tl.arange(0, BLOCK_S)
            mask = (offs_s < S)[:, None] & cmask[None, :]
            off = base + offs_s[:, None] * C + offs_c[None, :]
            xa = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
            y = (xa - mean) * inv * sc[None, :] + bi[None, :]
            if SWISH:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)

    return group_norm_kernel


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           num_groups: int):
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

    CPU tensor: the plain version. CUDA tensor: the Triton kernel, or a
    ValueError for a layout or dtype it does not take. Each kernel launch
    adds one to `fused_group_norm.launches`."""
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups=num_groups,
                                eps=eps, swish=swish)
    _check(x, scale, bias, num_groups)
    import triton

    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    cg = c // num_groups
    block_cg = triton.next_power_of_2(cg)
    block_s = min(triton.next_power_of_2(s), max(16, 4096 // block_cg))
    y = torch.empty_like(x)
    _kernel()[(num_groups, b)](
        x, scale, bias, y, s, c, cg, float(s * cg), eps,
        BLOCK_S=block_s, BLOCK_CG=block_cg, SWISH=swish, num_warps=4)
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
