"""Noise schedules and DDIM timestep subsequences (port of
qdiffusion_tpu/schedules.py; numpy tables built once on the host).

Parity targets: reference scripts/sample_diffusion_ddim.py:37-67 (beta
schedules) and :290-301 (skip sequences); the LDM lineage's
make_beta_schedule and DDIM tables (ldm util.py:21-60).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["get_beta_schedule", "make_beta_schedule", "make_skip_sequence",
           "make_ddim_timesteps", "make_ddim_sampling_parameters",
           "NoiseSchedule"]


def get_beta_schedule(beta_schedule: str, *, beta_start: float,
                      beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """DDPM-lineage beta schedules (float64, shape [T])."""
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, T,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) \
            + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    return betas


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """LDM-lineage beta schedules (float64, [T]). "linear" is the
    sqrt-space schedule of that lineage; "sqrt_linear" a plain linspace."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        ts = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep \
            + cosine_s
        alphas = np.cos(ts / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """LDM-lineage DDIM subsequence, +1 shifted (reference util.py:46-60)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                             num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(ddim_discr_method)
    return steps + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """Per-step (sigma, alpha, alpha_prev) tables of the LDM DDIM sampler."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]]
                             + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def make_skip_sequence(num_timesteps: int, timesteps: int,
                       skip_type: str = "uniform"):
    """Increasing timestep subsequence: 'uniform' strides by
    floor(T/steps) from 0; 'quad' squares a linspace to sqrt(0.8 T)."""
    if skip_type == "uniform":
        seq = list(range(0, num_timesteps, num_timesteps // timesteps))
    elif skip_type == "quad":
        seq = np.linspace(0, np.sqrt(num_timesteps * 0.8), timesteps) ** 2
        seq = [int(s) for s in seq]
    else:
        raise NotImplementedError(skip_type)
    return seq


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """betas: [T] float64."""

    betas: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas, axis=0)

    @classmethod
    def ddpm(cls, beta_schedule: str, beta_start: float, beta_end: float,
             T: int):
        return cls(get_beta_schedule(beta_schedule, beta_start=beta_start,
                                     beta_end=beta_end,
                                     num_diffusion_timesteps=T))

    @classmethod
    def ldm(cls, schedule: str, T: int, linear_start: float,
            linear_end: float, cosine_s: float = 8e-3):
        return cls(make_beta_schedule(schedule, T, linear_start, linear_end,
                                      cosine_s))
