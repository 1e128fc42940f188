"""Task presets and quantization flags (port of part of
qdiffusion_tpu/config.py). `cifar10` reproduces the reference's
configs/cifar10.yml with the sample_diffusion_ddim.py defaults; `sd_v1`
its configs/stable-diffusion/v1-inference.yaml with the txt2img.py
sampler (PLMS-50, guidance 7.5); `lsun_beds256` (LDM-4, VQ-f4, DDIM-200,
eta 1) and `lsun_churches256` (LDM-8, KL-f8, DDIM-400, eta 0) the
reference's LSUN latent-diffusion models with its sample_diffusion_ldm.py
settings. The JAX TaskConfig's scale_by_std and cond_stage fields serve
only its torch .ckpt and YAML readers, which the port has not; the
churches preset carries the scale_by_std checkpoints' scale factor.
QuantFlags carries the calibration flags of both passes and maps them
into a CalibConfig as the JAX package's does (config.py:96-107)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from qdiffusion_torch.calib.engine import CalibConfig
from qdiffusion_torch.calib.recon import ReconConfig
from qdiffusion_torch.models.clip_text import CLIPTextConfig
from qdiffusion_torch.models.unet_ddim import DDIMUNetConfig, QuantPolicy
from qdiffusion_torch.models.unet_ldm import LDMQuantPolicy, LDMUNetConfig
from qdiffusion_torch.models.vae import VAEConfig
from qdiffusion_torch.quant.affine import AffineQuantizerSpec


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "ddpm"  # 'ddpm' (get_beta_schedule) | 'ldm' (make_beta_schedule)
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
    guidance_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class QuantFlags:
    """CLI-level quantization knobs (reference --weight_bit etc.)."""

    weight_bit: int = 8
    quant_act: bool = False
    act_bit: int = 8
    a_sym: bool = False
    sm_abit: int = 8
    split: bool = False
    running_stat: bool = False  # EMA sweep after the act scale init
    rs_sm_only: bool = False  # running stats for post-softmax only
    a_min_max: bool = False  # LDM: act scale init 'max' instead of 'mse'
    cali_st: int = 20  # trajectory steps the calibration set samples
    cali_n: int = 256  # samples per step
    cali_batch_size: int = 32  # reconstruction minibatch
    cali_iters: int = 20000  # weight-pass iterations per unit
    cali_iters_a: int = 5000  # act-pass iterations per unit
    cali_lr: float = 4e-4  # act-delta learning rate
    cali_p: float = 2.4  # act-pass Lp norm
    alpha_dtype: str = "float32"  # AdaRound alpha storage dtype
    capture_group_bytes: int = 3 << 30  # grouped-capture residency cap
    act_init_batch: int = 64  # act scale-init rows and EMA sweep batch

    def calib_config(self) -> CalibConfig:
        return CalibConfig(
            weight=ReconConfig(iters=self.cali_iters,
                               batch_size=self.cali_batch_size, p=2.0),
            act=ReconConfig(iters=self.cali_iters_a,
                            batch_size=self.cali_batch_size,
                            lr=self.cali_lr, p=self.cali_p),
            quant_act=self.quant_act, running_stat=self.running_stat,
            rs_sm_only=self.rs_sm_only, sm_abit=self.sm_abit,
            alpha_dtype=self.alpha_dtype,
            capture_group_bytes=self.capture_group_bytes,
            act_init_batch=self.act_init_batch)

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

    def policy_ldm(self) -> LDMQuantPolicy:
        """LDM/SD policy: 'mse' weights, 'mse' or 'max' activations
        (sample_diffusion_ldm.py:456-462, txt2img.py:373-383)."""
        return LDMQuantPolicy(
            wq=AffineQuantizerSpec(n_bits=self.weight_bit, channel_wise=True,
                                   channel_axis=0, scale_method="mse"),
            aq=AffineQuantizerSpec(
                n_bits=self.act_bit, symmetric=self.a_sym,
                scale_method="max" if self.a_min_max else "mse",
                leaf_param=self.quant_act),
            sm_abit=self.sm_abit)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str
    family: str  # 'pixel' | 'ldm' | 'sd'
    schedule: ScheduleConfig
    sampler: SamplerConfig
    image_size: int = 32
    channels: int = 3
    latent_size: int = 0
    latent_channels: int = 0
    scale_factor: float = 1.0
    unet_ddim: Optional[DDIMUNetConfig] = None
    unet_ldm: Optional[LDMUNetConfig] = None
    vae: Optional[VAEConfig] = None
    conditioning_key: Optional[str] = None
    clip: Optional[CLIPTextConfig] = None  # text tower ('sd' family)


CIFAR10 = TaskConfig(
    name="cifar10", family="pixel",
    schedule=ScheduleConfig("ddpm", "linear", 1e-4, 2e-2, 1000),
    sampler=SamplerConfig("generalized", 100, "quad", 0.0),
    image_size=32, channels=3,
    unet_ddim=DDIMUNetConfig(in_channels=3, out_ch=3, ch=128,
                             ch_mult=(1, 2, 2, 2), num_res_blocks=2,
                             attn_resolutions=(16,), resolution=32))

LSUN_BEDS256 = TaskConfig(
    name="lsun_beds256", family="ldm",
    schedule=ScheduleConfig("ldm", "linear", 0.0015, 0.0195, 1000),
    sampler=SamplerConfig("ddim", 200, "uniform", 1.0),
    image_size=256, channels=3, latent_size=64, latent_channels=3,
    unet_ldm=LDMUNetConfig(image_size=64, in_channels=3, out_channels=3,
                           model_channels=224,
                           attention_resolutions=(8, 4, 2),
                           num_res_blocks=2, channel_mult=(1, 2, 3, 4),
                           num_head_channels=32),
    vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4), num_res_blocks=2,
                  attn_resolutions=(), in_channels=3, resolution=256,
                  z_channels=3, double_z=False, embed_dim=3, n_embed=8192))

LSUN_CHURCHES256 = TaskConfig(
    name="lsun_churches256", family="ldm",
    schedule=ScheduleConfig("ldm", "linear", 0.0015, 0.0155, 1000),
    sampler=SamplerConfig("ddim", 400, "uniform", 0.0),
    image_size=256, channels=3, latent_size=32, latent_channels=4,
    scale_factor=0.18215,  # scale_by_std checkpoint value
    unet_ldm=LDMUNetConfig(image_size=32, in_channels=4, out_channels=4,
                           model_channels=192,
                           attention_resolutions=(1, 2, 4, 8),
                           num_res_blocks=2, channel_mult=(1, 2, 2, 4, 4),
                           num_heads=8, use_scale_shift_norm=True,
                           resblock_updown=True),
    vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                  attn_resolutions=(), in_channels=3, resolution=256,
                  z_channels=4, double_z=True, embed_dim=4))

SD_V1 = TaskConfig(
    name="sd_v1", family="sd",
    schedule=ScheduleConfig("ldm", "linear", 0.00085, 0.012, 1000),
    sampler=SamplerConfig("plms", 50, "uniform", 0.0, guidance_scale=7.5),
    image_size=512, channels=3, latent_size=64, latent_channels=4,
    scale_factor=0.18215, conditioning_key="crossattn",
    unet_ldm=LDMUNetConfig(image_size=32, in_channels=4, out_channels=4,
                           model_channels=320,
                           attention_resolutions=(4, 2, 1),
                           num_res_blocks=2, channel_mult=(1, 2, 4, 4),
                           num_heads=8, use_spatial_transformer=True,
                           transformer_depth=1, context_dim=768,
                           legacy=False),
    vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                  attn_resolutions=(), in_channels=3, resolution=256,
                  z_channels=4, double_z=True, embed_dim=4),
    clip=CLIPTextConfig())

PRESETS = {c.name: c for c in (CIFAR10, LSUN_BEDS256, LSUN_CHURCHES256,
                                 SD_V1)}
