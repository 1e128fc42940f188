"""Neural-net primitives (port of qdiffusion_tpu/nn.py).

Activations are NCHW tensors in `torch.channels_last` memory format (the
same bytes as the JAX package's NHWC); conv weights OIHW, dense weights
(out, in). Carrier rules follow the JAX module: convs and dense layers
compute in the activation dtype, GroupNorm statistics in f32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from qdiffusion_torch.ops.groupnorm import fused_group_norm


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2D convolution, NCHW x OIHW -> NCHW, in x's dtype."""
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if b is not None and b.dtype != x.dtype:
        b = b.to(x.dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine map over the last axis; w is (out, in)."""
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if b is not None and b.dtype != x.dtype:
        b = b.to(x.dtype)
    return F.linear(x, w, b)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-6,
               fused_ok: bool = True) -> torch.Tensor:
    """GroupNorm over NCHW (channels_last) with f32 statistics; the result
    in x's dtype.

    fused_ok=True: ops.groupnorm.fused_group_norm, the B1 kernel on the
    card (no backward) and its plain version on the CPU. fused_ok=False:
    the differentiable PyTorch form of JAX nn.py:106-115 (mean, then the
    variance as jnp.var takes it, mean((x - mean)^2)). Models pass
    `fused_ok=not ctx.differentiable`, as the JAX models do."""
    if fused_ok:
        y = fused_group_norm(x.permute(0, 2, 3, 1), scale, bias,
                             num_groups=num_groups, eps=eps)
        return y.permute(0, 3, 1, 2)
    b, c = x.shape[:2]
    xg = x.float().reshape(b, num_groups, c // num_groups, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return y.to(x.dtype)


def group_norm_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, num_groups: int = 32, eps: float = 1e-6,
                     fused_ok: bool = True) -> torch.Tensor:
    """swish(group_norm(x)); the swish stays outside the kernel, as in the
    JAX package (nn.py:126-138)."""
    return swish(group_norm(x, scale, bias, num_groups=num_groups, eps=eps,
                            fused_ok=fused_ok))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance), the result
    in x's dtype (JAX nn.py:117-123)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def timestep_embedding(t: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0,
                       fairseq: bool = True) -> torch.Tensor:
    """Sinusoidal embedding, f32 of shape (B, dim). fairseq=True: the DDIM
    lineage (freqs over half_dim-1, sin|cos; reference
    ddim/models/diffusion.py:6-24); fairseq=False: the LDM lineage (freqs
    over half, cos|sin; reference ldm util.py:151-171)."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    if fairseq:
        freqs = torch.exp(ar * -(math.log(max_period) / (half - 1)))
    else:
        freqs = torch.exp(-math.log(max_period) * ar / half)
    args = t.float()[:, None] * freqs[None, :]
    pair = (torch.sin(args), torch.cos(args)) if fairseq else \
        (torch.cos(args), torch.sin(args))
    emb = torch.cat(pair, dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, channels_last out. A 1x1 input is
    both layouts at once and F.interpolate then returns NCHW-contiguous,
    which the card's kernels (B1, B4) refuse."""
    return F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2."""
    return F.avg_pool2d(x, 2)


def pad_asymmetric_downsample(x: torch.Tensor) -> torch.Tensor:
    """(0,1,0,1) spatial zero-pad before the stride-2 3x3 downsample conv
    (reference ddim/models/diffusion.py:67-71)."""
    return F.pad(x, (0, 1, 0, 1))


def pad_amounts(padding: Union[str, int], k: Tuple[int, int],
                stride: Tuple[int, int], shape) -> List[Tuple[int, int]]:
    """(before, after) per spatial dim of an int, 'SAME', 'VALID' or
    explicit padding, as lax.conv reads its padding argument (the JAX
    package's ops/int8.py::_pad_amounts)."""
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    if padding == "SAME":
        out = []
        for dim, kk, s in zip(shape, k, stride):
            o = -(-dim // s)
            total = max(0, (o - 1) * s + kk - dim)
            out.append((total // 2, total - total // 2))
        return out
    return [tuple(p) for p in padding]


def patches(x: torch.Tensor, kshape: Tuple[int, int],
            stride: Tuple[int, int], pads, value=0) -> torch.Tensor:
    """(B, C, H, W) -> (B, Ho, Wo, C*kh*kw) patches, features in (c, kh,
    kw) order (lax.conv_general_dilated_patches' order, which the packed
    weights follow). The input is padded with `value`."""
    kh, kw = kshape
    (pt, pb), (pl, pr) = pads
    if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) \
            and not (pt or pb or pl or pr):
        return x.permute(0, 2, 3, 1)  # 1x1 stride 1: the input itself
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=value)
    b, c = x.shape[:2]
    u = x.unfold(2, kh, stride[0]).unfold(3, kw, stride[1])
    ho, wo = u.shape[2], u.shape[3]
    return u.permute(0, 2, 3, 1, 4, 5).reshape(b, ho, wo, c * kh * kw)
