"""Pixel-space DDPM UNet, CIFAR-10 / LSUN lineage (port of
qdiffusion_tpu/models/unet_ddim.py; reference ddim/models/diffusion.py:
199-360).

`DDIMUNet` is an nn.Module whose submodule names are the reference
state_dict names (`down.0.block.0.conv1`, `temb.dense.0`, ...), so a site
name is also a module path. Convs and linears are parameter holders: the
forward runs them through `ops.qlayers` with a QuantCtx, so one module
serves the FP, sim and folded forwards.

The forward takes and returns NHWC like the JAX model; inside,
activations are NCHW in channels_last memory format.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from qdiffusion_torch import nn
from qdiffusion_torch.device import resolve_device
from qdiffusion_torch.models.base import QuantModelBase, ReconUnit
from qdiffusion_torch.ops.qlayers import qconv2d, qdense
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx

Module, ModuleList = torch.nn.Module, torch.nn.ModuleList


@dataclasses.dataclass(frozen=True)
class DDIMUNetConfig:
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resolution: int = 32
    resamp_with_conv: bool = True
    split_shortcut: bool = False

    @property
    def temb_ch(self) -> int:
        return self.ch * 4


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Model-wide quantizer specs (reference wq_params/aq_params + sm_abit,
    scripts/sample_diffusion_ddim.py:129-139). Weights are per output
    channel, which is axis 0 of OIHW and (out, in)."""

    wq: AffineQuantizerSpec = AffineQuantizerSpec(
        n_bits=8, channel_wise=True, channel_axis=0, scale_method="max")
    aq: AffineQuantizerSpec = AffineQuantizerSpec(
        n_bits=8, symmetric=False, channel_wise=False, scale_method="max",
        leaf_param=True)
    sm_abit: int = 8

    @property
    def sm_aq(self) -> AffineQuantizerSpec:
        # post-softmax attention weights at sm_abit (quant_block.py:349-351)
        return self.aq.replace(n_bits=self.sm_abit)


class GroupNorm(Module):
    """GroupNorm parameters (state_dict `weight`/`bias`), 32 groups, eps
    1e-6, optionally followed by swish."""

    def __init__(self, channels: int, swish: bool):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(channels))
        self.bias = torch.nn.Parameter(torch.zeros(channels))
        self.swish = swish

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = nn.group_norm_swish if self.swish else nn.group_norm
        return fn(x, self.weight, self.bias)


class ResnetBlock(Module):
    """Reference diffusion.py:77-141; dropout is identity at inference."""

    def __init__(self, model: "DDIMUNet", name: str, in_ch: int, out_ch: int,
                 split: int):
        super().__init__()
        self.name, self.in_ch, self.out_ch = name, in_ch, out_ch
        temb_ch = model.cfg.temb_ch
        self.norm1 = GroupNorm(in_ch, swish=True)
        self.conv1 = torch.nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.temb_proj = torch.nn.Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(out_ch, swish=True)
        self.conv2 = torch.nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.q_conv1 = model._lcfg(f"{name}.conv1")
        self.q_temb_proj = model._lcfg(f"{name}.temb_proj")
        self.q_conv2 = model._lcfg(f"{name}.conv2")
        layers = [f"{name}.conv1", f"{name}.temb_proj", f"{name}.conv2"]
        if in_ch != out_ch:
            self.nin_shortcut = torch.nn.Conv2d(in_ch, out_ch, 1)
            self.q_nin_shortcut = model._lcfg(f"{name}.nin_shortcut",
                                              split=split)
            layers.append(f"{name}.nin_shortcut")
        model._units.append(ReconUnit(name, "resnet", layers,
                                      takes_temb=True))

    def forward(self, x, temb, ctx: QuantCtx):
        n = self.name
        h = qconv2d(ctx, f"{n}.conv1", self.conv1, self.norm1(x),
                    self.q_conv1, padding=1)
        t = qdense(ctx, f"{n}.temb_proj", self.temb_proj, nn.swish(temb),
                   self.q_temb_proj)
        h = self.norm2(h + t[:, :, None, None])
        h = qconv2d(ctx, f"{n}.conv2", self.conv2, h, self.q_conv2,
                    padding=1)
        if self.in_ch != self.out_ch:
            x = qconv2d(ctx, f"{n}.nin_shortcut", self.nin_shortcut, x,
                        self.q_nin_shortcut)
        return x + h


class AttnBlock(Module):
    """Single-head spatial self-attention (reference diffusion.py:144-196)
    with the QuantAttnBlock quantizer placement (quant_block.py:333-386):
    q/k quantized before QK^T, softmax in f32, the softmax rounded to the
    carrier dtype and quantized at sm_abit, v at act bits before AV."""

    def __init__(self, model: "DDIMUNet", name: str, ch: int):
        super().__init__()
        self.name = name
        self.policy = model.policy
        self.norm = GroupNorm(ch, swish=False)
        for leaf in ("q", "k", "v", "proj_out"):
            setattr(self, leaf, torch.nn.Conv2d(ch, ch, 1))
            setattr(self, f"q_{leaf}", model._lcfg(f"{name}.{leaf}"))
        model._units.append(ReconUnit(
            name, "attn",
            [f"{name}.{leaf}" for leaf in ("q", "k", "v", "proj_out")]))

    def forward(self, x, ctx: QuantCtx):
        n, pol = self.name, self.policy
        h = self.norm(x)
        q = qconv2d(ctx, f"{n}.q", self.q, h, self.q_q)
        k = qconv2d(ctx, f"{n}.k", self.k, h, self.q_k)
        v = qconv2d(ctx, f"{n}.v", self.v, h, self.q_v)
        b, c, hh, ww = q.shape
        q, k, v = (a.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
                   for a in (q, k, v))
        w = ctx.act_matmul(n, "q", "k", "bic,bjc->bij", q, k, pol.aq, pol.aq)
        w = torch.softmax(w * (int(c) ** -0.5), dim=2)
        hout = ctx.act_matmul(n, "sm", "v", "bij,bjc->bic", w.to(x.dtype), v,
                              pol.sm_aq, pol.aq).to(x.dtype)
        hout = hout.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + qconv2d(ctx, f"{n}.proj_out", self.proj_out, hout,
                           self.q_proj_out)


class Downsample(Module):
    def __init__(self, model: "DDIMUNet", name: str, ch: int):
        super().__init__()
        self.name = name
        if model.cfg.resamp_with_conv:
            self.conv = torch.nn.Conv2d(ch, ch, 3, stride=2)
            self.q_conv = model._lcfg(f"{name}.conv")
            model._units.append(ReconUnit(f"{name}.conv", "layer",
                                          [f"{name}.conv"]))

    def forward(self, x, ctx: QuantCtx):
        if not hasattr(self, "conv"):
            return nn.avg_pool_2x(x)
        return qconv2d(ctx, f"{self.name}.conv", self.conv,
                       nn.pad_asymmetric_downsample(x), self.q_conv,
                       stride=2)


class Upsample(Module):
    def __init__(self, model: "DDIMUNet", name: str, ch: int):
        super().__init__()
        self.name = name
        if model.cfg.resamp_with_conv:
            self.conv = torch.nn.Conv2d(ch, ch, 3, padding=1)
            self.q_conv = model._lcfg(f"{name}.conv")
            model._units.append(ReconUnit(f"{name}.conv", "layer",
                                          [f"{name}.conv"]))

    def forward(self, x, ctx: QuantCtx):
        x = nn.upsample_nearest_2x(x)
        if not hasattr(self, "conv"):
            return x
        return qconv2d(ctx, f"{self.name}.conv", self.conv, x, self.q_conv,
                       padding=1)


def _level() -> Module:
    m = Module()
    m.block, m.attn = ModuleList(), ModuleList()
    return m


class DDIMUNet(QuantModelBase):
    """CIFAR/LSUN pixel-space epsilon-prediction UNet.

    Built on `device` (default the card; raises if CUDA is absent unless
    device='cpu'). Weights start from torch's default init: load
    `init_params(seed)` or converted weights before use."""

    def __init__(self, config: DDIMUNetConfig,
                 policy: Optional[QuantPolicy] = None, *, device="cuda"):
        super().__init__()
        self.cfg = config
        self.policy = policy or QuantPolicy()
        with resolve_device(device):
            self._build()
        # conv weights in channels_last, like the activations
        self.to(memory_format=torch.channels_last)

    def _build(self):
        cfg = self.cfg
        nres = len(cfg.ch_mult)
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        Conv2d, Linear = torch.nn.Conv2d, torch.nn.Linear

        self.temb = Module()
        self.temb.dense = ModuleList([Linear(cfg.ch, cfg.temb_ch),
                                      Linear(cfg.temb_ch, cfg.temb_ch)])
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        for nm in ("temb.dense.0", "temb.dense.1", "conv_in"):
            self._lcfg(nm)
            self._units.append(ReconUnit(nm, "layer", [nm]))

        # static channel plan: reference constructor diffusion.py:238-298
        self.down = ModuleList()
        curr_res = cfg.resolution
        block_in = 0
        for i in range(nres):
            level = _level()
            block_in = cfg.ch * in_ch_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            has_attn = curr_res in cfg.attn_resolutions
            for j in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(
                    self, f"down.{i}.block.{j}", block_in, block_out, 0))
                block_in = block_out
                if has_attn:
                    level.attn.append(AttnBlock(self, f"down.{i}.attn.{j}",
                                                block_in))
            if i != nres - 1:
                level.downsample = Downsample(self, f"down.{i}.downsample",
                                              block_in)
                curr_res //= 2
            self.down.append(level)

        self.mid = Module()
        self.mid.block_1 = ResnetBlock(self, "mid.block_1", block_in,
                                       block_in, 0)
        self.mid.attn_1 = AttnBlock(self, "mid.attn_1", block_in)
        self.mid.block_2 = ResnetBlock(self, "mid.block_2", block_in,
                                       block_in, 0)

        up = [None] * nres
        for i in reversed(range(nres)):
            level = _level()
            block_out = cfg.ch * cfg.ch_mult[i]
            skip_in = cfg.ch * cfg.ch_mult[i]
            has_attn = curr_res in cfg.attn_resolutions
            for j in range(cfg.num_res_blocks + 1):
                if j == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_ch_mult[i]
                # split point == channels flowing up (reference
                # diffusion.py:340-346: split_ = h.size(1))
                split = block_in if (cfg.split_shortcut and i < 4) else 0
                level.block.append(ResnetBlock(
                    self, f"up.{i}.block.{j}", block_in + skip_in,
                    block_out, split))
                block_in = block_out
                if has_attn:
                    level.attn.append(AttnBlock(self, f"up.{i}.attn.{j}",
                                                block_in))
            if i != 0:
                level.upsample = Upsample(self, f"up.{i}.upsample", block_in)
                curr_res *= 2
            up[i] = level
        self.up = ModuleList(up)

        self.norm_out = GroupNorm(block_in, swish=True)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1)
        self._lcfg("conv_out")
        self._units.append(ReconUnit("conv_out", "layer", ["conv_out"]))
        self._order_units()

    def _order_units(self):
        """Reference named_children DFS order: temb, conv_in, then per
        down/up level all blocks, then all attns, then the resample conv
        (definition order, not execution order), mid, conv_out last."""
        by_name = {u.name: u for u in self._units}
        kind_rank = {"block": 0, "attn": 1, "downsample": 2, "upsample": 2}

        def level_key(n: str):
            parts = n.split(".")
            return (int(parts[1]), kind_rank[parts[2]],
                    int(parts[3]) if parts[3].isdigit() else 0)

        down = sorted((n for n in by_name if n.startswith("down.")),
                      key=level_key)
        up = sorted((n for n in by_name if n.startswith("up.")),
                    key=level_key)
        order = (["temb.dense.0", "temb.dense.1", "conv_in"] + down
                 + ["mid.block_1", "mid.attn_1", "mid.block_2"] + up
                 + ["conv_out"])
        self._units = [by_name[n] for n in order]

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                ctx: Optional[QuantCtx] = None) -> torch.Tensor:
        """Epsilon prediction. x: NHWC in the model's dtype; t: (B,)
        timesteps. Returns NHWC."""
        ctx = ctx or QuantCtx()
        cfg = self.cfg
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        temb = nn.timestep_embedding(t, cfg.ch).to(x.dtype)
        temb = qdense(ctx, "temb.dense.0", self.temb.dense[0], temb,
                      self._layer_cfgs["temb.dense.0"])
        temb = qdense(ctx, "temb.dense.1", self.temb.dense[1],
                      nn.swish(temb), self._layer_cfgs["temb.dense.1"])

        hs = [qconv2d(ctx, "conv_in", self.conv_in, x,
                      self._layer_cfgs["conv_in"], padding=1)]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb, ctx)
                if len(level.attn):
                    h = level.attn[j](h, ctx)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1], ctx))

        h = self.mid.block_1(hs[-1], temb, ctx)
        h = self.mid.attn_1(h, ctx)
        h = self.mid.block_2(h, temb, ctx)

        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb, ctx)
                if len(level.attn):
                    h = level.attn[j](h, ctx)
            if hasattr(level, "upsample"):
                h = level.upsample(h, ctx)

        h = qconv2d(ctx, "conv_out", self.conv_out, self.norm_out(h),
                    self._layer_cfgs["conv_out"], padding=1)
        return h.permute(0, 2, 3, 1)

    def init_params(self, seed: int = 0) -> dict:
        """A seeded random state_dict (CPU, f32), the counterpart of the
        JAX init_params: weights N(0, 1/fan_in), biases 0, norms (1, 0).
        Drawn with numpy in state_dict order."""
        rng = np.random.default_rng(seed)
        norm_scales = {f"{n}.weight" for n, m in self.named_modules()
                       if isinstance(m, GroupNorm)}
        out = {}
        for name, p in self.state_dict().items():
            if p.ndim >= 2:
                fan = math.prod(p.shape[1:])
                a = (rng.standard_normal(p.shape, dtype=np.float32)
                     / math.sqrt(fan)).astype(np.float32)
            elif name in norm_scales:
                a = np.ones(p.shape, np.float32)
            else:
                a = np.zeros(p.shape, np.float32)
            out[name] = torch.from_numpy(a)
        return out
