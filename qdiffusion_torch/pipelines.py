"""Generation pipelines (port of qdiffusion_tpu/pipelines.py): the
pixel-space PixelDiffusionPipeline (reference
scripts/sample_diffusion_ddim.py Diffusion runner; sample types
'generalized' (DDIM), 'ddpm_noisy' (ancestral DDPM) and 'dpm_solver'
(singlestep order 3)) and the latent LatentDiffusionPipeline (reference
ldm/models/diffusion/ddpm.py LatentDiffusion; samplers 'ddim', 'plms' and
'dpm_solver' (multistep order 2, txt2img's --dpm_solver))."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.samplers.ddim import ddim_sample, ddpm_sample
from qdiffusion_torch.samplers.dpm_solver import NoiseScheduleVP, \
    dpm_solver_sample
from qdiffusion_torch.samplers.ldm import (
    DDIMTables,
    ddim_sample_ldm,
    plms_sample,
)
from qdiffusion_torch.schedules import NoiseSchedule, make_skip_sequence


@dataclasses.dataclass
class PixelDiffusionPipeline:
    """CIFAR/LSUN pixel-space pipeline over a DDIMUNet."""

    model: torch.nn.Module
    schedule: NoiseSchedule

    def model_fn(self, qstate: Optional[dict] = None,
                 mode: Optional[QuantMode] = None) -> Callable:
        """(x, t) -> eps; with a qstate every call runs the sim engine
        under `mode`."""

        def fn(x, t):
            ctx = QuantCtx(qstate, mode=mode) if qstate is not None else None
            return self.model(x, t, ctx)

        return fn

    @torch.no_grad()
    def sample(self, n: int, *, timesteps: int = 100,
               skip_type: str = "uniform", eta: float = 0.0,
               sample_type: str = "generalized", image_size: int = 32,
               channels: int = 3,
               generator: Optional[torch.Generator] = None,
               qstate: Optional[dict] = None,
               mode: Optional[QuantMode] = None,
               x_init: Optional[torch.Tensor] = None,
               eval_dtype: Optional[torch.dtype] = None,
               model_fn: Optional[Callable] = None,
               return_trajectory: bool = False):
        """n samples, NHWC in [-1, 1] model space. The initial noise is
        x_init, or drawn from `generator` on the model's device; so is the
        step noise of DDIM at eta > 0 and of 'ddpm_noisy'. Each model call
        is model_fn (x, t) -> eps when given (a deployed engine,
        deploy.make_quantized_step), else the model: with a qstate under
        the sim engine and `mode`. 'dpm_solver' runs `timesteps` model
        calls on the time_uniform grid (JAX pipelines.py:71-82).
        return_trajectory=True: (samples, trajectory), as
        samplers.ddim.ddim_sample returns them; 'dpm_solver' records none
        and gives (samples, None)."""
        device = next(self.model.parameters()).device
        x = x_init if x_init is not None else torch.randn(
            (n, image_size, image_size, channels), generator=generator,
            device=device)
        fn = model_fn or self.model_fn(qstate, mode)
        if sample_type == "dpm_solver":
            out = dpm_solver_sample(
                fn, x, NoiseScheduleVP("discrete", betas=self.schedule.betas),
                steps=timesteps, order=3, skip_type="time_uniform",
                method="singlestep", eval_dtype=eval_dtype)
            return (out, None) if return_trajectory else out
        seq = make_skip_sequence(self.schedule.num_timesteps, timesteps,
                                 skip_type)
        kw = dict(generator=generator, eval_dtype=eval_dtype,
                  return_trajectory=return_trajectory)
        if sample_type == "generalized":
            return ddim_sample(fn, x, seq, self.schedule.betas, eta=eta, **kw)
        if sample_type == "ddpm_noisy":
            return ddpm_sample(fn, x, seq, self.schedule.betas, **kw)
        raise NotImplementedError(sample_type)


@dataclasses.dataclass
class LatentDiffusionPipeline:
    """LDM / Stable Diffusion pipeline: the UNet in latent space, the
    first-stage decode and, for SD, CLIP text conditioning (port of the
    JAX LatentDiffusionPipeline; conditioning keys None and 'crossattn',
    DiffusionWrapper.forward, ddpm.py:1419-1445). 'concat', 'hybrid' and
    'adm' are not ported."""

    unet: torch.nn.Module
    vae: torch.nn.Module
    schedule: NoiseSchedule
    scale_factor: float = 1.0
    conditioning_key: Optional[str] = None
    text_encoder: Optional[torch.nn.Module] = None

    def model_fn(self, qstate: Optional[dict] = None,
                 mode: Optional[QuantMode] = None) -> Callable:
        """(x, t, context) -> eps; with a qstate every call runs the sim
        engine under `mode`."""
        if self.conditioning_key not in (None, "crossattn"):
            raise NotImplementedError(self.conditioning_key)

        def fn(x, t, context=None):
            ctx = QuantCtx(qstate, mode=mode) if qstate is not None else None
            return self.unet(x, t, ctx, context=context)

        return fn

    @torch.no_grad()
    def get_learned_conditioning(self, input_ids: torch.Tensor
                                 ) -> torch.Tensor:
        return self.text_encoder(input_ids)

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    @torch.no_grad()
    def sample(self, n: int, *, sampler: str = "ddim", steps: int = 50,
               eta: float = 0.0, latent_size: int = 64,
               latent_channels: int = 4,
               cond: Optional[torch.Tensor] = None,
               uncond: Optional[torch.Tensor] = None,
               guidance_scale: float = 1.0,
               generator: Optional[torch.Generator] = None,
               qstate: Optional[dict] = None,
               mode: Optional[QuantMode] = None,
               model_fn: Optional[Callable] = None, decode: bool = True,
               x_init: Optional[torch.Tensor] = None,
               eval_dtype: Optional[torch.dtype] = None,
               return_trajectory: bool = False):
        """n samples: images NHWC in [0, 1] (f32), or the latents when
        decode is False. The initial noise is x_init, or drawn from
        `generator` on the UNet's device. 'dpm_solver' is multistep order
        2 with `steps` UNet calls (JAX pipelines.py:172-179).
        return_trajectory=True: (samples, trajectory), the sampler's
        {"xs", "ts"} plus, with `cond`, "cs" and "ucs": cond and uncond
        broadcast over the steps (JAX pipelines.py:182-187), the
        calibration data of the conditional models; 'dpm_solver' records
        none and gives (samples, None)."""
        device = next(self.unet.parameters()).device
        x = x_init if x_init is not None else torch.randn(
            (n, latent_size, latent_size, latent_channels),
            generator=generator, device=device)
        fn = model_fn or self.model_fn(qstate, mode)
        ac = self.schedule.alphas_cumprod
        kw = dict(cond=cond, uncond=uncond, guidance_scale=guidance_scale,
                  eval_dtype=eval_dtype, return_trajectory=return_trajectory)
        if sampler == "ddim":
            z = ddim_sample_ldm(fn, x, DDIMTables.build(ac, steps, eta),
                                eta_noise=eta > 0, generator=generator, **kw)
        elif sampler == "plms":
            z = plms_sample(fn, x, DDIMTables.build(ac, steps, 0.0), **kw)
        elif sampler == "dpm_solver":
            z = dpm_solver_sample(
                fn, x, NoiseScheduleVP("discrete", betas=self.schedule.betas),
                steps=steps, order=2, method="multistep", with_context=True,
                cond=cond, uncond=uncond, guidance_scale=guidance_scale,
                eval_dtype=eval_dtype)
            z = (z, None) if return_trajectory else z
        else:
            raise NotImplementedError(sampler)
        if not return_trajectory:
            return self.decode(z, eval_dtype) if decode else z
        z, traj = z
        if traj is not None and cond is not None:
            s = traj["xs"].shape[0]
            traj["cs"] = cond[None].expand(s, *cond.shape)
            traj["ucs"] = uncond[None].expand(s, *uncond.shape)
        return (self.decode(z, eval_dtype) if decode else z), traj

    @torch.no_grad()
    def decode(self, z: torch.Tensor,
               eval_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Latents -> images NHWC in [0, 1], f32. A bf16 deployment
        decodes in the carrier and clips in f32 (JAX pipelines.py:188-196)."""
        img = self.decode_first_stage(
            z if eval_dtype is None else z.to(eval_dtype))
        return torch.clamp((img.float() + 1.0) / 2.0, 0.0, 1.0)
