"""Neural-net primitives (port of qdiffusion_tpu/nn.py).

Activations are NCHW tensors in `torch.channels_last` memory format (the
same bytes as the JAX package's NHWC); conv weights OIHW, dense weights
(out, in). Carrier rules follow the JAX module: convs and dense layers
compute in the activation dtype, GroupNorm statistics in f32.
"""

from __future__ import annotations

import math
from typing import Optional

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
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW (channels_last) with f32 statistics; the result
    in x's dtype. Every call goes through ops.groupnorm.fused_group_norm:
    the B1 kernel on the card, its plain version on the CPU."""
    y = fused_group_norm(x.permute(0, 2, 3, 1), scale, bias,
                         num_groups=num_groups, eps=eps)
    return y.permute(0, 3, 1, 2)


def group_norm_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, num_groups: int = 32, eps: float = 1e-6
                     ) -> torch.Tensor:
    """swish(group_norm(x)); the swish stays outside the kernel, as in the
    JAX package (nn.py:126-138)."""
    return swish(group_norm(x, scale, bias, num_groups=num_groups, eps=eps))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def timestep_embedding(t: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, fairseq variant of the DDIM lineage (freqs
    over half_dim-1, sin|cos; reference ddim/models/diffusion.py:6-24).
    f32 result of shape (B, dim)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(max_period) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2."""
    return F.avg_pool2d(x, 2)


def pad_asymmetric_downsample(x: torch.Tensor) -> torch.Tensor:
    """(0,1,0,1) spatial zero-pad before the stride-2 3x3 downsample conv
    (reference ddim/models/diffusion.py:67-71)."""
    return F.pad(x, (0, 1, 0, 1))
