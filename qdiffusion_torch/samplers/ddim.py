"""Pixel-space DDIM sampling (port of qdiffusion_tpu/samplers/ddim.py,
ddim_sample; reference ddim/functions/denoising.py:10-33).

A Python loop over the steps replaces the JAX lax.scan. Alpha lookups use
the zero-padded beta cumprod at index t+1 (compute_alpha,
denoising.py:4-7). The step tables are f32, as in the JAX scan, and the
sampler carry stays f32 when the model runs in another dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _alpha_tables(betas: np.ndarray, seq: Sequence[int]):
    """Per-step (t, a_t, a_next) in execution (reversed) order, f32."""
    padded = np.cumprod(1.0 - np.concatenate([np.zeros(1), betas]))
    seq = list(seq)
    seq_next = [-1] + seq[:-1]
    ts = np.array(list(reversed(seq)), dtype=np.float32)
    at = padded[np.array(list(reversed(seq))) + 1].astype(np.float32)
    at_next = padded[np.array(list(reversed(seq_next))) + 1].astype(
        np.float32)
    return ts, at, at_next


def ddim_sample(model_fn: ModelFn, x: torch.Tensor, seq: Sequence[int],
                betas: np.ndarray, *, eta: float = 0.0,
                generator: Optional[torch.Generator] = None,
                eval_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Generalized DDIM sampling (reference generalized_steps).

    x: NHWC noise; seq: increasing timestep subsequence. eval_dtype: the
    model's carrier dtype (bf16 deployment): the update math and carry
    stay f32, only the model input is cast down and eps cast back. None
    keeps x's dtype throughout (reference parity). With eta > 0 the noise
    comes from `generator` (on x's device); with eta == 0 the noise term
    is zero and no noise is drawn."""
    ts, at, at_next = _alpha_tables(np.asarray(betas, np.float64), seq)
    one = np.float32(1.0)
    if eval_dtype is not None:
        x = x.float()
    n = x.shape[0]
    for t, a, a_next in zip(ts, at, at_next):
        tb = torch.full((n,), float(t), dtype=torch.float32, device=x.device)
        et = (model_fn(x, tb) if eval_dtype is None else
              model_fn(x.to(eval_dtype), tb).to(x.dtype))
        # f32 scalar tables, computed as the JAX scan computes them
        c1 = np.float32(eta) * np.sqrt((one - a / a_next) * (one - a_next)
                                       / (one - a))
        c2 = np.sqrt((one - a_next) - c1 * c1)
        x0_t = (x - et * float(np.sqrt(one - a))) / float(np.sqrt(a))
        x_next = float(np.sqrt(a_next)) * x0_t
        if eta:
            noise = torch.randn(x.shape, generator=generator,
                                dtype=x.dtype, device=x.device)
            x_next = x_next + float(c1) * noise
        x = x_next + float(c2) * et
    return x


def inverse_data_transform(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] model space -> [0,1] image space with clamp (reference
    ddim/datasets/__init__.py:204-230, rescaled path)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
