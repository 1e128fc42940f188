"""Noise schedules and DDIM timestep subsequences (the pixel-space part of
qdiffusion_tpu/schedules.py; numpy tables built once on the host).

Parity targets: reference scripts/sample_diffusion_ddim.py:37-67 (beta
schedules) and :290-301 (skip sequences).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["get_beta_schedule", "make_skip_sequence", "NoiseSchedule"]


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

    @classmethod
    def ddpm(cls, beta_schedule: str, beta_start: float, beta_end: float,
             T: int):
        return cls(get_beta_schedule(beta_schedule, beta_start=beta_start,
                                     beta_end=beta_end,
                                     num_diffusion_timesteps=T))
