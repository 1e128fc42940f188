"""Attention: materializing and blockwise variants (port of
qdiffusion_tpu/ops/attention.py).

All inputs are (B, T, H, D) / (B, S, H, D); softmax statistics in f32.
`blockwise_attention` dispatches as the TPU package does on its chip
(attention.py:58-73): the resident kernel B2 where the TPU cost model
says its tile fits (ops/flash_attention.py::flash_supported), else the
streaming kernel B3. On a CUDA tensor those are the CUDA kernels; on a
CPU tensor their plain versions. `allow_kernels=False` runs the TPU
package's two-pass lax.scan fallback, written here as a plain loop.
"""

from __future__ import annotations

import torch

from qdiffusion_torch.ops.flash_attention import (
    QPair,
    flash_attention,
    flash_supported,
)
from qdiffusion_torch.ops.flash_streaming import streaming_flash_attention
from qdiffusion_torch.quant.affine import fake_quant

__all__ = ["materializing_attention", "blockwise_attention"]


def _maybe_fq(x: torch.Tensor, pair: QPair) -> torch.Tensor:
    if pair is None:
        return x
    st, spec = pair
    return fake_quant(x, st["delta"], st["zero_point"], spec)


def materializing_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float,
                            sm_q: QPair = None,
                            v_q: QPair = None) -> torch.Tensor:
    """Reference-shaped attention over the whole (T, S) matrix."""
    w = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    w = torch.softmax(w, dim=-1).to(q.dtype)
    w = _maybe_fq(w, sm_q)
    v = _maybe_fq(v, v_q)
    return torch.einsum("bhij,bjhd->bihd", w.float(), v.float()).to(q.dtype)


def _blockwise_loop(q, k, v, *, scale, sm_q, v_q, block_size):
    """The TPU package's lax.scan blockwise path (attention.py:74-136)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    bs = min(block_size, S)
    qf = q.float()

    def scores(j0):
        return torch.einsum("bihd,bjhd->bhij", qf,
                            k[:, j0:j0 + bs].float()) * scale

    m = torch.full((B, H, T, 1), -torch.inf, device=q.device)
    l = torch.zeros((B, H, T, 1), device=q.device)
    for j0 in range(0, S, bs):
        s = scores(j0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
            dim=-1, keepdim=True)
        m = m_new
    acc = torch.zeros((B, T, H, D), device=q.device)
    for j0 in range(0, S, bs):
        p = torch.exp(scores(j0) - m) / l
        p = _maybe_fq(p.to(q.dtype), sm_q).float()
        vv = _maybe_fq(v[:, j0:j0 + bs], v_q).float()
        acc = acc + torch.einsum("bhij,bjhd->bihd", p, vv)
    return acc.to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, sm_q: QPair = None,
                        v_q: QPair = None, block_size: int = 512,
                        allow_kernels: bool = True) -> torch.Tensor:
    """Flash-style attention with exact static-delta quantization of the
    normalized probabilities; never materializes (T, S) on the kernel
    paths. q: (B, T, H, D); k, v: (B, S, H, D)."""
    if not allow_kernels:
        return _blockwise_loop(q, k, v, scale=scale, sm_q=sm_q, v_q=v_q,
                               block_size=block_size)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if flash_supported(q.shape, k.shape, q.element_size()):
        return flash_attention(q, k, v, scale=scale, sm_q=sm_q, v_q=v_q)
    return streaming_flash_attention(q, k, v, scale=scale, sm_q=sm_q,
                                     v_q=v_q)
