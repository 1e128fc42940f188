"""B2's softmax . V with one of nine epilogues: kernel P.

Replaces scripts/bench_flash_epilogue.py::flash (the pallas_call at :77,
kernel body `_kernel` at :23-60), a timing probe of the TPU flash kernel,
with the CUDA C++ kernel `flash_mma_kernel` of csrc/flash_attention.cu
(entry point qdt_flash_epilogue): the kernel that serves B2 in bf16, with
the epilogue switched at compile time.

The function, per (batch, head) and query row over all S keys (P :23-60):
s = (q . k) * scale in f32, m = max s, e = exp(s - m), linv = 1 / sum e,
delta = 1/255 in f32 (P's `scalars`, :75) and inv_d = 1 / delta in f32.
The p fed to PV, by mode (P's order, :118-119):

  fp_postnorm  (bf16(e) . v) * linv               (B2 without sm_q)
  fp_prenorm   p = e * linv
  cast_rt      bf16(p)                            (B3 without sm_q)
  mul_only     p * inv_d
  floor_half   floor(p * inv_d + 0.5)
  round_only   round(p * inv_d), half to even
  round_clip   min(round(p * inv_d), 255)
  full         min(round(p * inv_d), 255) * delta
  full_floor   min(floor(p * inv_d + 0.5), 255) * delta

Every mode but fp_postnorm gives bf16(p) . v with f32 sums, cast to bf16.
Unlike B2's sm_q path, `full` has no bf16 round trip of p before it
quantizes, and the floor modes really use floor(x + 0.5): P's choices,
kept. P needs T to be a multiple of its 128-row tile; the kernel masks
ragged T and S and the plain version takes any T. The kernel exists for
D <= 48 only (P's shape has D = 40); the wrapper refuses larger D.

What bounds it on an H100 and the kernel's design: the source note of
csrc/flash_attention.cu. fp_postnorm pays one exponential per score, the
other modes two (online row statistics, then p); the differences between
the modes' times are what P measures.

On a CPU tensor the wrapper runs `flash_epilogue_plain`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from qdiffusion_torch.ops.flash_attention import _PLAIN_ROWS, check_inputs

__all__ = ["MODES", "DELTA", "flash_epilogue", "flash_epilogue_plain"]

MODES = ("fp_postnorm", "fp_prenorm", "cast_rt", "mul_only", "floor_half",
         "round_only", "round_clip", "full", "full_floor")
DELTA = float(np.float32(1 / 255.0))  # P's scalars (:75), an f32 value
# its f32 reciprocal, as the TPU kernel forms it (`inv_d = 1.0 / d`, :33);
# 254.99998, not 255
INV_DELTA = float(np.float32(1) / np.float32(DELTA))
MAX_D = 48  # the D class of P's modes in flash_mma_kernel (P has D = 40)


def _mode_index(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"flash_epilogue: mode {mode!r} is not one of "
                         f"{MODES}")
    return MODES.index(mode)


def flash_epilogue_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, mode: str) -> torch.Tensor:
    """P's function in plain PyTorch, query rows in chunks (each row's
    softmax over all S keys). q: (B, T, H, D); k, v: (B, S, H, D)."""
    _mode_index(mode)
    d, inv_d = DELTA, INV_DELTA  # f32 values: exact as f32 tensor scalars
    # bf16 products are exact in f32: f32 matmuls of the upcast operands
    # are bf16 MMAs with f32 accumulation
    kf, vf = k.float(), v.float()
    outs = []
    for t0 in range(0, q.shape[1], _PLAIN_ROWS):
        s = torch.einsum("bthd,bshd->bhts", q[:, t0:t0 + _PLAIN_ROWS].float(),
                         kf) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        linv = 1.0 / e.sum(dim=-1, keepdim=True)
        if mode == "fp_postnorm":
            o = torch.einsum("bhts,bshd->bhtd",
                             e.to(torch.bfloat16).float(), vf) * linv
        else:
            p = e * linv
            if mode == "cast_rt":
                p = p.to(torch.bfloat16).float()
            elif mode == "mul_only":
                p = p * inv_d
            elif mode == "floor_half":
                p = torch.floor(p * inv_d + 0.5)
            elif mode == "round_only":
                p = torch.round(p * inv_d)
            elif mode == "round_clip":
                p = torch.clamp(torch.round(p * inv_d), max=255.0)
            elif mode == "full":
                p = torch.clamp(torch.round(p * inv_d), max=255.0) * d
            elif mode == "full_floor":
                p = torch.clamp(torch.floor(p * inv_d + 0.5), max=255.0) * d
            o = torch.einsum("bhts,bshd->bhtd", p.to(torch.bfloat16).float(),
                             vf)
        outs.append(o.to(q.dtype).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """B2's wrapper checks, then what P's instances of flash_mma_kernel
    take: bf16 and D <= 48."""
    check_inputs("flash_epilogue", q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_epilogue: unsupported dtype {q.dtype} "
                         "(bf16 only, as P)")
    if q.shape[-1] > MAX_D:
        raise ValueError(f"flash_epilogue: head dim {q.shape[-1]} > {MAX_D}")


def flash_epilogue(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, mode: str) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, H, D), bf16 -> (B, T, H, D) bf16.

    CPU tensor: the plain version. CUDA tensor: the kernel, or a
    ValueError for what it does not take. Each kernel launch adds one to
    `flash_epilogue.launches`."""
    idx = _mode_index(mode)
    if q.device.type == "cpu":
        return flash_epilogue_plain(q, k, v, scale=scale, mode=mode)
    _check(q, k, v)
    from qdiffusion_torch.ops import _cuda

    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty_like(q)
    err = _cuda.library("flash_attention.cu").qdt_flash_epilogue(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, S, H,
        D, float(scale), idx, _cuda.stream_ptr(q.device))
    _cuda.check(err, f"flash_epilogue (B={B}, T={T}, S={S}, H={H}, D={D}, "
                     f"mode={mode})")
    flash_epilogue.launches += 1
    return o


flash_epilogue.launches = 0
