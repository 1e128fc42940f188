"""Pixel-space DDIM and ancestral DDPM sampling (port of
qdiffusion_tpu/samplers/ddim.py: ddim_sample and ddpm_sample; reference
ddim/functions/denoising.py:10-67, generalized_steps and ddpm_steps).

A Python loop over the steps replaces the JAX lax.scan. Alpha lookups use
the zero-padded beta cumprod at index t+1 (compute_alpha,
denoising.py:4-7). The step tables are f32, as in the JAX scan, and the
sampler carry stays f32 when the model runs in another dtype.

`return_trajectory=True` also returns the exact (x_t, t) the model saw at
every step, the data timestep-aware calibration draws from
(calib/samples.py::get_train_samples; reference qdiff/utils.py:325-348).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

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
                eval_dtype: Optional[torch.dtype] = None,
                return_trajectory: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, dict]]:
    """Generalized DDIM sampling (reference generalized_steps).

    x: NHWC noise; seq: increasing timestep subsequence. eval_dtype: the
    model's carrier dtype (bf16 deployment): the update math and carry
    stay f32, only the model input is cast down and eps cast back. None
    keeps x's dtype throughout (reference parity). With eta > 0 the noise
    comes from `generator` (on x's device); with eta == 0 the noise term
    is zero and no noise is drawn. return_trajectory=True returns (x,
    {"xs": [S,B,H,W,C], "ts": [S,B]}): the carry and the timesteps of
    every step in execution order (JAX ddim.py:39-89)."""
    ts, at, at_next = _alpha_tables(np.asarray(betas, np.float64), seq)
    one = np.float32(1.0)
    if eval_dtype is not None:
        x = x.float()
    n = x.shape[0]
    traj_x, traj_t = [], []
    for t, a, a_next in zip(ts, at, at_next):
        tb = torch.full((n,), float(t), dtype=torch.float32, device=x.device)
        if return_trajectory:
            traj_x.append(x)
            traj_t.append(tb)
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
    if return_trajectory:
        return x, {"xs": torch.stack(traj_x), "ts": torch.stack(traj_t)}
    return x


def ddpm_sample(model_fn: ModelFn, x: torch.Tensor, seq: Sequence[int],
                betas: np.ndarray, *,
                generator: Optional[torch.Generator] = None,
                eval_dtype: Optional[torch.dtype] = None,
                return_trajectory: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, dict]]:
    """Ancestral DDPM sampling (reference ddpm_steps, denoising.py:35-67;
    JAX ddim.py:92-133): x0 clipped to [-1, 1], the posterior mean, then
    noise at log-variance log(beta_t), none at t = 0. Each step's noise
    is drawn from `generator` on x's device (at t = 0 too, multiplied by
    the zero mask, as the JAX scan draws it). eval_dtype and
    return_trajectory as in ddim_sample."""
    ts, at, atm1 = _alpha_tables(np.asarray(betas, np.float64), seq)
    one = np.float32(1.0)
    if eval_dtype is not None:
        x = x.float()
    n = x.shape[0]
    traj_x, traj_t = [], []
    for t, a, am1 in zip(ts, at, atm1):
        tb = torch.full((n,), float(t), dtype=torch.float32, device=x.device)
        if return_trajectory:
            traj_x.append(x)
            traj_t.append(tb)
        e = (model_fn(x, tb) if eval_dtype is None else
             model_fn(x.to(eval_dtype), tb).to(x.dtype))
        # f32 scalar tables, computed as the JAX scan computes them
        beta_t = one - a / am1
        x0 = torch.clamp(float(np.sqrt(one / a)) * x
                         - float(np.sqrt(one / a - one)) * e, -1.0, 1.0)
        mean = (float(np.sqrt(am1) * beta_t) * x0
                + float(np.sqrt(one - beta_t) * (one - am1)) * x) \
            / float(one - a)
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device)
        mask = np.float32(t != 0)
        # a timestep the quad sequence repeats has beta_t = 0: log -inf,
        # no noise (as in the JAX scan)
        with np.errstate(divide="ignore"):
            sd = mask * np.exp(np.float32(0.5) * np.log(beta_t))
        x = mean + float(sd) * noise
    if return_trajectory:
        return x, {"xs": torch.stack(traj_x), "ts": torch.stack(traj_t)}
    return x


def inverse_data_transform(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] model space -> [0,1] image space with clamp (reference
    ddim/datasets/__init__.py:204-230, rescaled path)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
