"""Latent-diffusion samplers: DDIM and PLMS with classifier-free guidance
(port of qdiffusion_tpu/samplers/ldm.py).

Python loops replace the JAX lax.scan programs; the per-step tables are
numpy, read as f32 scalars as the scan reads its f32 device tables.

  * DDIM update: reference ldm/models/diffusion/ddim.py:170-220.
  * PLMS Adams-Bashforth orders 1-4 with the pseudo-improved-Euler first
    step, which evaluates the model a second time at t_next
    (plms.py:175-240): S steps make S + 1 model calls.
  * CFG: one model call on cat([uncond; cond]), in that order, then
    split (plms.py:181-196).

eval_dtype: the model's carrier (bf16 deployment); the sampler carry, the
eps history and the update math stay f32. return_trajectory=True also
returns {"xs": [S, B, ...], "ts": [S, B]}: the carry and the timesteps at
the input of each step, the calibration data of the latent models (JAX
ldm.py:125-130, :207-215; reference plms.py:134, 166-171). PLMS's first
step calls the model twice and is one entry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from qdiffusion_torch.schedules import (
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)

# model_fn(x, t, context) -> eps; context may be None
CondModelFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                       torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-step sampler tables, index 0 = lowest timestep."""

    timesteps: np.ndarray  # [S] the +1-shifted ddim timesteps
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @classmethod
    def build(cls, alphas_cumprod: np.ndarray, num_steps: int, eta: float,
              discr_method: str = "uniform") -> "DDIMTables":
        ts = make_ddim_timesteps(discr_method, num_steps, len(alphas_cumprod))
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            alphas_cumprod, ts, eta)
        return cls(ts, alphas, alphas_prev, np.sqrt(1.0 - alphas), sigmas)

    def step(self, index: int):
        """(a_t, a_prev, sqrt(1 - a_t), sigma) of step `index`, f32."""
        f = np.float32
        return (f(self.alphas[index]), f(self.alphas_prev[index]),
                f(self.sqrt_one_minus_alphas[index]), f(self.sigmas[index]))


class _Trajectory:
    """The (x_t, t) at the input of each step, when asked for."""

    def __init__(self, on: bool):
        self.on, self.xs, self.ts = on, [], []

    def record(self, x: torch.Tensor, tb: torch.Tensor):
        if self.on:
            self.xs.append(x)
            self.ts.append(tb)

    def result(self, x: torch.Tensor):
        if not self.on:
            return x
        return x, {"xs": torch.stack(self.xs), "ts": torch.stack(self.ts)}


def _cfg_eps(model_fn: CondModelFn, x, t, cond, uncond,
             scale: float) -> torch.Tensor:
    if cond is None or uncond is None or scale == 1.0:
        return model_fn(x, t, cond)
    e = model_fn(torch.cat([x, x]), torch.cat([t, t]),
                 torch.cat([uncond, cond]))
    e_uncond, e_cond = e.chunk(2)
    return e_uncond + scale * (e_cond - e_uncond)


def _x_prev(x, e_t, a_t, a_prev, sqrt_1m_a, sigma, noise=None):
    """DDIM update with f32 scalars (ddim.py:200-216)."""
    one = np.float32(1.0)
    pred_x0 = (x - float(sqrt_1m_a) * e_t) / float(np.sqrt(a_t))
    dir_xt = float(np.sqrt(one - a_prev - sigma * sigma)) * e_t
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + float(sigma) * noise
    return x_prev


def _eps_fn(model_fn, cond, uncond, guidance_scale, eval_dtype):
    def get_eps(x, tb):
        if eval_dtype is None:
            return _cfg_eps(model_fn, x, tb, cond, uncond, guidance_scale)
        return _cfg_eps(model_fn, x.to(eval_dtype), tb, cond, uncond,
                        guidance_scale).to(x.dtype)

    return get_eps


def ddim_sample_ldm(model_fn: CondModelFn, x: torch.Tensor,
                    tables: DDIMTables, *,
                    cond: Optional[torch.Tensor] = None,
                    uncond: Optional[torch.Tensor] = None,
                    guidance_scale: float = 1.0, eta_noise: bool = True,
                    generator: Optional[torch.Generator] = None,
                    eval_dtype: Optional[torch.dtype] = None,
                    return_trajectory: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, dict]]:
    """LDM DDIM sampling loop (reference ddim_sampling, ddim.py:116-167).
    With eta_noise the step noise comes from `generator` on x's device."""
    if eval_dtype is not None:
        x = x.float()
    get_eps = _eps_fn(model_fn, cond, uncond, guidance_scale, eval_dtype)
    n = x.shape[0]
    traj = _Trajectory(return_trajectory)
    for index in reversed(range(len(tables.timesteps))):
        tb = torch.full((n,), float(tables.timesteps[index]),
                        dtype=torch.float32, device=x.device)
        traj.record(x, tb)
        e_t = get_eps(x, tb)
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device) if eta_noise else None
        x = _x_prev(x, e_t, *tables.step(index), noise)
    return traj.result(x)


def plms_sample(model_fn: CondModelFn, x: torch.Tensor, tables: DDIMTables,
                *, cond: Optional[torch.Tensor] = None,
                uncond: Optional[torch.Tensor] = None,
                guidance_scale: float = 1.0,
                eval_dtype: Optional[torch.dtype] = None,
                return_trajectory: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, dict]]:
    """PLMS sampling (reference plms_sampling / p_sample_plms): S steps,
    S + 1 model calls (the first step evaluates again at t_next)."""
    if eval_dtype is not None:
        x = x.float()
    get_eps = _eps_fn(model_fn, cond, uncond, guidance_scale, eval_dtype)
    time_range = np.flip(tables.timesteps).copy()
    t_next_range = np.append(time_range[1:], time_range[-1])
    n = x.shape[0]
    old: list = []  # most recent eps first
    traj = _Trajectory(return_trajectory)
    for count, index in enumerate(reversed(range(len(time_range)))):
        tb = torch.full((n,), float(time_range[count]), dtype=torch.float32,
                        device=x.device)
        traj.record(x, tb)
        step = tables.step(index)
        e_t = get_eps(x, tb)
        if count == 0:
            tnb = torch.full((n,), float(t_next_range[count]),
                             dtype=torch.float32, device=x.device)
            e_next = get_eps(_x_prev(x, e_t, *step), tnb)
            e_prime = (e_t + e_next) / 2
        elif count == 1:
            e_prime = (3 * e_t - old[0]) / 2
        elif count == 2:
            e_prime = (23 * e_t - 16 * old[0] + 5 * old[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * old[0] + 37 * old[1]
                       - 9 * old[2]) / 24
        x = _x_prev(x, e_prime, *step)
        old = [e_t] + old[:2]
    return traj.result(x)
