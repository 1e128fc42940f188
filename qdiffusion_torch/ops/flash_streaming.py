"""Streaming (two-pass) flash attention: kernel B3.

Replaces qdiffusion_tpu/ops/pallas/flash_streaming.py::
streaming_flash_attention (pallas_calls at :153 and :165: `_p1_kernel`
running (max, sum-exp) with -1e30 masking, `_p2_kernel`
sum fq(bf16(exp(s - m) / l)) . v in f32) with the CUDA C++ kernel of
csrc/flash_attention.cu under B3's switch: the normaliser is applied
BEFORE PV even without sm_q (TPU :91-104), unlike B2.

The TPU package sends a shape here when its resident-K/V kernel (B2)
does not fit VMEM, which at the SD v1 shapes is the VAE decoder's
single-head D = 512 attention over 4096 tokens. There the CUDA kernel is
`flash_wide_kernel`: 8 warps share a block of query rows (64 in bf16, 32
in f32), each warp scores its rows over a part of every key block and
keeps a part of D of their output in registers, so that the output of a
whole block fits; p meets PV through shared memory. It keeps two passes
(the row's final max and sum before bf16(e * (1/l))); shared-memory
fragment reads and the L2 traffic of K twice and V once bound it. f32 at
D <= 128 runs `flash_tf32_kernel` in one pass, bf16 at D <= 128
`flash_mma_kernel`, as for B2.

On a CPU tensor the wrapper runs `streaming_flash_attention_plain`, the
TPU kernels' block arithmetic in PyTorch; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from qdiffusion_torch.ops.flash_attention import (
    QPair,
    _fq,
    _round_up,
    check_inputs,
    hoist_v_quant,
    launch,
    sm_scalars,
)

__all__ = ["streaming_flash_attention", "streaming_flash_attention_plain"]

_NEG_INF = -1e30  # TPU flash_streaming.py:39


def streaming_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, *, scale: float,
                                    sm_q: QPair = None, v_q: QPair = None,
                                    block_k: int = 1024) -> torch.Tensor:
    """B3's function in plain PyTorch, over key blocks of `block_k` (the
    TPU default, capped at S rounded up to 128)."""
    v = hoist_v_quant(v, v_q)
    bf16 = q.dtype == torch.bfloat16
    cd = torch.bfloat16 if bf16 else torch.float32
    B, T, H, D = q.shape
    S = k.shape[1]
    bk = min(block_k, _round_up(S, 128))
    qf = q.float()
    sm = sm_scalars(sm_q) if sm_q is not None else None

    def scores(j0):
        return torch.einsum("bthd,bshd->bhts", qf,
                            k[:, j0:j0 + bk].float()) * scale

    m = torch.full((B, H, T, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, H, T, 1), device=q.device)
    for j0 in range(0, S, bk):  # pass 1 (TPU _p1_kernel)
        s = scores(j0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
            dim=-1, keepdim=True)
        m = m_new
    linv = 1.0 / l
    acc = torch.zeros((B, H, T, D), device=q.device)
    for j0 in range(0, S, bk):  # pass 2 (TPU _p2_kernel)
        p = torch.exp(scores(j0) - m) * linv
        if bf16:
            p = p.to(torch.bfloat16).float()
        if sm is not None:
            delta, inv, zp, spec = sm
            p = _fq(p, delta.to(p.device), inv.to(p.device), zp.to(p.device),
                    n_levels=spec.n_levels, symmetric=spec.symmetric,
                    always_zero=spec.always_zero, nonneg=True)
        vb = v[:, j0:j0 + bk].to(cd).float()
        acc = acc + torch.einsum("bhts,bshd->bhtd", p.to(cd).float(), vb)
    return acc.to(q.dtype).permute(0, 2, 1, 3)


def streaming_flash_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              sm_q: QPair = None,
                              v_q: QPair = None) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, H, D) -> (B, T, H, D); any S.

    CPU tensor: the plain version. CUDA tensor: the kernel, or a
    ValueError for what it does not take (a RuntimeError for an input
    that requires grad in grad mode). Each kernel launch adds one to
    `streaming_flash_attention.launches`."""
    if q.device.type == "cpu":
        return streaming_flash_attention_plain(q, k, v, scale=scale,
                                               sm_q=sm_q, v_q=v_q)
    check_inputs("streaming_flash_attention", q, k, v)
    v = hoist_v_quant(v, v_q)
    o = launch("streaming_flash_attention", q, k, v, scale=scale, sm_q=sm_q,
               norm_before=True)
    streaming_flash_attention.launches += 1
    return o


streaming_flash_attention.launches = 0
