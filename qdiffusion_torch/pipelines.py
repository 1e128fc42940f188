"""Pixel-space generation pipeline (port of
qdiffusion_tpu/pipelines.py::PixelDiffusionPipeline; reference
scripts/sample_diffusion_ddim.py Diffusion runner). Only the
'generalized' (DDIM) sample type is ported so far."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.samplers.ddim import ddim_sample
from qdiffusion_torch.schedules import NoiseSchedule, make_skip_sequence


@dataclasses.dataclass
class PixelDiffusionPipeline:
    """CIFAR/LSUN pixel-space DDIM pipeline over a DDIMUNet."""

    model: torch.nn.Module
    schedule: NoiseSchedule

    @torch.no_grad()
    def sample(self, n: int, *, timesteps: int = 100,
               skip_type: str = "uniform", eta: float = 0.0,
               sample_type: str = "generalized", image_size: int = 32,
               channels: int = 3,
               generator: Optional[torch.Generator] = None,
               qstate: Optional[dict] = None,
               mode: Optional[QuantMode] = None,
               x_init: Optional[torch.Tensor] = None,
               eval_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """n samples, NHWC in [-1, 1] model space. The initial noise is
        x_init, or drawn from `generator` on the model's device. With a
        qstate, every step runs the sim engine under `mode`."""
        if sample_type != "generalized":
            raise NotImplementedError(sample_type)
        device = next(self.model.parameters()).device
        x = x_init if x_init is not None else torch.randn(
            (n, image_size, image_size, channels), generator=generator,
            device=device)

        def fn(x, t):
            ctx = QuantCtx(qstate, mode=mode) if qstate is not None else None
            return self.model(x, t, ctx)

        seq = make_skip_sequence(self.schedule.num_timesteps, timesteps,
                                 skip_type)
        return ddim_sample(fn, x, seq, self.schedule.betas, eta=eta,
                           generator=generator, eval_dtype=eval_dtype)
