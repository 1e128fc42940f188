"""Task presets and quantization flags (the pixel-family part of
qdiffusion_tpu/config.py). `cifar10` reproduces the reference's
configs/cifar10.yml with the sample_diffusion_ddim.py defaults."""

from __future__ import annotations

import dataclasses
from typing import Optional

from qdiffusion_torch.models.unet_ddim import DDIMUNetConfig, QuantPolicy
from qdiffusion_torch.quant.affine import AffineQuantizerSpec


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "ddpm"
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    num_timesteps: int = 1000


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    sample_type: str = "generalized"
    timesteps: int = 100
    skip_type: str = "quad"
    eta: float = 0.0


@dataclasses.dataclass(frozen=True)
class QuantFlags:
    """CLI-level quantization knobs (reference --weight_bit etc.)."""

    weight_bit: int = 8
    quant_act: bool = False
    act_bit: int = 8
    a_sym: bool = False
    sm_abit: int = 8
    split: bool = False

    def policy_ddim(self) -> QuantPolicy:
        """CIFAR policy: 'max' scale methods
        (sample_diffusion_ddim.py:129-139); weights per output channel."""
        return QuantPolicy(
            wq=AffineQuantizerSpec(n_bits=self.weight_bit, channel_wise=True,
                                   channel_axis=0, scale_method="max"),
            aq=AffineQuantizerSpec(n_bits=self.act_bit, symmetric=self.a_sym,
                                   scale_method="max",
                                   leaf_param=self.quant_act),
            sm_abit=self.sm_abit)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str
    family: str  # 'pixel' only in the port so far
    schedule: ScheduleConfig
    sampler: SamplerConfig
    image_size: int = 32
    channels: int = 3
    unet_ddim: Optional[DDIMUNetConfig] = None


CIFAR10 = TaskConfig(
    name="cifar10", family="pixel",
    schedule=ScheduleConfig("ddpm", "linear", 1e-4, 2e-2, 1000),
    sampler=SamplerConfig("generalized", 100, "quad", 0.0),
    image_size=32, channels=3,
    unet_ddim=DDIMUNetConfig(in_channels=3, out_ch=3, ch=128,
                             ch_mult=(1, 2, 2, 2), num_res_blocks=2,
                             attn_resolutions=(16,), resolution=32))

PRESETS = {c.name: c for c in (CIFAR10,)}
