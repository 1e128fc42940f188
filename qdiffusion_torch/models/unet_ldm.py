"""LDM / Stable-Diffusion UNet, OpenAI lineage (port of
qdiffusion_tpu/models/unet_ldm.py; reference
ldm/modules/diffusionmodules/openaimodel.py:447-782 and
ldm/modules/attention.py).

`LDMUNet` is an nn.Module whose parameters sit at the reference
state_dict paths (time_embed.0, input_blocks.{i}.{j}..., middle_block.{k},
output_blocks.{i}.{j}, out.{k}), so a quant site name is a module path.
The modules are parameter holders (models/base.py::Params); the forward
runs them through ops.qlayers with a QuantCtx, so one module serves the
FP, sim, folded, int8 and stream forwards. The forward takes and returns NHWC; inside,
activations are NCHW in channels_last memory format, and attention runs
on (B, T, C) tokens, the same bytes.

Variants: the legacy AttentionBlock (LSUN beds/churches: multi-head QKV
conv1d, scale 1/sqrt(sqrt(ch)) on q and k, which are quantized after the
scaling, then scale 1.0 into the kernel); SpatialTransformer (SD:
cross-attention, GEGLU; q/k quantized before scaling, scale d**-0.5 into
the kernel); scale-shift norm and resblock up/down; split shortcuts.

Self-attention whose key length is at least `flash_threshold` goes
through ops/attention.py::blockwise_attention (kernels B2/B3 on the card)
instead of materializing (T, S); cross-attention over 77 context tokens
stays on the materializing path.

Calibration: every reconstruction unit (ReconUnit, models/base.py) has a
bound-method `apply(ctx, *inputs)`, and the forward calls each through
`_unit_call` with the JAX package's boundaries, in its registration
order: the time-embedding denses, each conv layer (the output blocks'
upsampling conv takes the input before the upsampling), each ResBlock
(x, emb), each AttentionBlock (or, with act_quant_partition, its four
units), each SpatialTransformer's proj_in, its transformer blocks
(tokens, context) and its proj_out, then out.2.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from qdiffusion_torch import nn
from qdiffusion_torch.device import resolve_device
from qdiffusion_torch.models.base import (
    Params,
    QuantModelBase,
    ReconUnit,
    put,
    seeded_params,
)
from qdiffusion_torch.ops.attention import blockwise_attention
from qdiffusion_torch.ops.groupnorm import fused_group_norm
from qdiffusion_torch.ops.qlayers import qconv1d, qconv2d, qdense
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx

# Key length at which self-attention goes to the flash kernels (the JAX
# package's FLASH_SEQ_DEFAULT, unet_ldm.py:50).
FLASH_SEQ_DEFAULT = 1024


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    image_size: int = 32
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)  # downsample rates
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    conv_resample: bool = True
    num_heads: int = -1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    legacy: bool = True
    split_shortcut: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


@dataclasses.dataclass(frozen=True)
class LDMQuantPolicy:
    """LDM/SD quantizer specs: 'mse' weights per output channel (axis 0
    of every torch weight layout), 'mse' or 'max' activations."""

    wq: AffineQuantizerSpec = AffineQuantizerSpec(
        n_bits=8, channel_wise=True, channel_axis=0, scale_method="mse")
    aq: AffineQuantizerSpec = AffineQuantizerSpec(
        n_bits=8, symmetric=False, channel_wise=False, scale_method="mse",
        leaf_param=True)
    sm_abit: int = 8

    @property
    def sm_aq_transformer(self) -> AffineQuantizerSpec:
        # quant_block.py:248-252
        return self.aq.replace(n_bits=self.sm_abit, always_zero=True)

    @property
    def sm_aq_smv(self) -> AffineQuantizerSpec:
        # quant_block.py:146-150
        return self.aq.replace(n_bits=self.sm_abit, symmetric=False,
                               always_zero=True)


def _heads_for(cfg: LDMUNetConfig, ch: int, upsample: bool = False):
    """Effective (heads, dim_head) at an attention site, the legacy
    head-count logic (openaimodel.py:575-586)."""
    if cfg.num_head_channels == -1:
        heads = cfg.num_heads
        dim_head = ch // cfg.num_heads
    else:
        heads = ch // cfg.num_head_channels
        dim_head = cfg.num_head_channels
    if cfg.legacy:
        dim_head = ch // heads if cfg.use_spatial_transformer \
            else cfg.num_head_channels
    if upsample and cfg.num_heads_upsample != -1 \
            and not cfg.use_spatial_transformer:
        heads = cfg.num_heads_upsample
    if not cfg.use_spatial_transformer and dim_head != -1:
        heads = ch // dim_head
    return heads, dim_head


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW channels_last -> (B, H*W, C), a view of the same bytes."""
    b, c, hh, ww = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)


def _from_tokens(x: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class LDMUNet(QuantModelBase):
    """OpenAI-style UNet with optional spatial transformers.

    Built on `device` (default the card; raises if CUDA is absent unless
    device='cpu'), with uninitialised weights: load `init_params(seed)` or
    converted weights before use.

    act_quant_partition: every AttentionBlock becomes four reconstruction
    units, its qkv and proj_out layers and the act-only units
    `{name}.attention.qkv_matmul` (q, k) and `.smv_matmul` (sm, v), which
    also hold its attention quantizers (JAX unet_ldm.py:317-339, the
    reference's get_specials with leaf_param, quant_block.py:389-401);
    attention then always materializes. The JAX CLI sets it with
    --quant-act."""

    def __init__(self, config: LDMUNetConfig,
                 policy: Optional[LDMQuantPolicy] = None, *,
                 act_quant_partition: bool = False,
                 flash_threshold: Optional[int] = None, device="cuda"):
        super().__init__()
        self.cfg = config
        self.policy = policy or LDMQuantPolicy()
        self.act_quant_partition = act_quant_partition
        self.flash_threshold = (FLASH_SEQ_DEFAULT if flash_threshold is None
                                else flash_threshold)
        self._mods: dict = {}
        with resolve_device(device):
            self._build()
        self._unit_map = {u.name: u for u in self._units}
        self.to(memory_format=torch.channels_last)

    # -- construction (openaimodel.py:545-745) ---------------------------

    def _hold(self, name: str, *shape: int, bias: bool = True) -> Params:
        m = put(self, name, Params(*shape, bias=bias))
        self._mods[name] = m
        return m

    def _layer(self, name: str, *shape: int, bias: bool = True,
               split: int = 0, unit: bool = False, **conv):
        """A quantizable conv/linear site; unit=True also registers it as
        its own reconstruction unit: a dense (2-D weight) or a conv with
        `conv`'s stride, padding and upsample_first."""
        self._hold(name, *shape, bias=bias)
        self._lcfg(name, split=split)
        if not unit:
            return
        if len(shape) == 2:
            apply, axis = functools.partial(self._dense_unit, name), -1
        else:
            apply = functools.partial(self._conv_unit, name,
                                      conv.get("stride", 1),
                                      conv.get("padding", 1),
                                      conv.get("upsample_first", False))
            axis = 1  # NCHW channels (JAX: -1 of NHWC)
        self._units.append(ReconUnit(name, "layer", [name], apply=apply,
                                     loss_axis=axis))

    def _build(self):
        cfg = self.cfg
        mc, ted = cfg.model_channels, cfg.time_embed_dim
        self._layer("time_embed.0", ted, mc, unit=True)
        self._layer("time_embed.2", ted, ted, unit=True)

        self.input_plan = [[dict(kind="layer", name="input_blocks.0.0")]]
        self._layer("input_blocks.0.0", mc, cfg.in_channels, 3, 3,
                    unit=True)
        input_block_chans = [mc]
        ch, ds, idx = mc, 1, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                entry = [self._resblock_plan(f"input_blocks.{idx}.0", ch,
                                             mult * mc, split=0)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    entry.append(self._attention_plan(
                        f"input_blocks.{idx}.1", ch))
                self.input_plan.append(entry)
                input_block_chans.append(ch)
                idx += 1
            if level != len(cfg.channel_mult) - 1:
                if cfg.resblock_updown:
                    self.input_plan.append([self._resblock_plan(
                        f"input_blocks.{idx}.0", ch, ch, split=0,
                        updown="down")])
                else:
                    nm = f"input_blocks.{idx}.0.op"
                    self._layer(nm, ch, ch, 3, 3, unit=True, stride=2)
                    self.input_plan.append([dict(kind="layer", name=nm)])
                input_block_chans.append(ch)
                ds *= 2
                idx += 1

        self.middle_plan = [
            self._resblock_plan("middle_block.0", ch, ch, split=0),
            self._attention_plan("middle_block.1", ch),
            self._resblock_plan("middle_block.2", ch, ch, split=0),
        ]

        self.output_plan = []
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                oi = len(self.output_plan)
                ich = input_block_chans.pop()
                split = ch if cfg.split_shortcut else 0
                entry = [self._resblock_plan(f"output_blocks.{oi}.0",
                                             ch + ich, mc * mult,
                                             split=split)]
                ch = mc * mult
                j = 1
                if ds in cfg.attention_resolutions:
                    entry.append(self._attention_plan(
                        f"output_blocks.{oi}.{j}", ch, upsample=True))
                    j += 1
                if level and i == cfg.num_res_blocks:
                    if cfg.resblock_updown:
                        entry.append(self._resblock_plan(
                            f"output_blocks.{oi}.{j}", ch, ch, split=0,
                            updown="up"))
                    else:
                        # the unit takes the input before the upsampling
                        # (JAX unet_ldm.py:256-261)
                        nm = f"output_blocks.{oi}.{j}.conv"
                        self._layer(nm, ch, ch, 3, 3, unit=True,
                                    upsample_first=True)
                        entry.append(dict(kind="layer", name=nm))
                    ds //= 2
                self.output_plan.append(entry)

        self._hold("out.0", ch)
        self._layer("out.2", cfg.out_channels, mc, 3, 3, unit=True)

    def _resblock_plan(self, name: str, in_ch: int, out_ch: int, split: int,
                       updown: Optional[str] = None) -> dict:
        cfg = self.cfg
        plan = dict(kind="resblock", name=name, in_ch=in_ch, out_ch=out_ch,
                    updown=updown, scale_shift=cfg.use_scale_shift_norm,
                    skip="identity" if in_ch == out_ch else "conv1")
        emb_out = 2 * out_ch if cfg.use_scale_shift_norm else out_ch
        self._hold(f"{name}.in_layers.0", in_ch)
        self._layer(f"{name}.in_layers.2", out_ch, in_ch, 3, 3)
        self._layer(f"{name}.emb_layers.1", emb_out, cfg.time_embed_dim)
        self._hold(f"{name}.out_layers.0", out_ch)
        self._layer(f"{name}.out_layers.3", out_ch, out_ch, 3, 3)
        layers = [f"{name}.in_layers.2", f"{name}.emb_layers.1",
                  f"{name}.out_layers.3"]
        if plan["skip"] != "identity":
            self._layer(f"{name}.skip_connection", out_ch, in_ch, 1, 1,
                        split=split)
            layers.append(f"{name}.skip_connection")
        self._units.append(ReconUnit(
            name, "resblock", layers, takes_temb=True, loss_axis=1,
            apply=functools.partial(self._resblock, plan=plan)))
        return plan

    def _attention_plan(self, name: str, ch: int,
                        upsample: bool = False) -> dict:
        heads, dim_head = _heads_for(self.cfg, ch, upsample)
        if self.cfg.use_spatial_transformer:
            return self._transformer_plan(name, ch, heads, dim_head)
        plan = dict(kind="attnblock", name=name, ch=ch, heads=heads)
        self._hold(f"{name}.norm", ch)
        self._layer(f"{name}.qkv", 3 * ch, ch, 1)
        self._layer(f"{name}.proj_out", ch, ch, 1)
        if not self.act_quant_partition:
            self._units.append(ReconUnit(
                name, "attnblock", [f"{name}.qkv", f"{name}.proj_out"],
                loss_axis=1,
                apply=functools.partial(self._attnblock, plan=plan)))
            return plan
        # the partition's order and loss axes (JAX unet_ldm.py:317-339):
        # the layers on (B, T, C) tokens, q.k^T's (B, H, T, S) over the
        # queries, (w.v)'s (B, T, H c) over the channels
        for unit, kind, layers, apply, axis in (
                (f"{name}.qkv", "layer", [f"{name}.qkv"],
                 functools.partial(self._tokens_unit, f"{name}.qkv"), -1),
                (f"{name}.attention.qkv_matmul", "qkmatmul", [],
                 functools.partial(self._qk_matmul, plan), 2),
                (f"{name}.attention.smv_matmul", "smvmatmul", [],
                 functools.partial(self._smv_matmul, plan), -1),
                (f"{name}.proj_out", "layer", [f"{name}.proj_out"],
                 functools.partial(self._tokens_unit, f"{name}.proj_out"),
                 -1)):
            self._units.append(ReconUnit(unit, kind, layers, apply=apply,
                                         loss_axis=axis))
        return plan

    def _transformer_plan(self, name: str, ch: int, heads: int,
                          dim_head: int) -> dict:
        cfg = self.cfg
        inner = heads * dim_head
        ctx_dim = cfg.context_dim or inner
        self._hold(f"{name}.norm", ch)
        self._layer(f"{name}.proj_in", inner, ch, 1, 1, unit=True,
                    padding=0)
        for d in range(cfg.transformer_depth):
            tb = f"{name}.transformer_blocks.{d}"
            for attn, kv_dim in (("attn1", inner), ("attn2", ctx_dim)):
                self._layer(f"{tb}.{attn}.to_q", inner, inner, bias=False)
                self._layer(f"{tb}.{attn}.to_k", inner, kv_dim, bias=False)
                self._layer(f"{tb}.{attn}.to_v", inner, kv_dim, bias=False)
                self._layer(f"{tb}.{attn}.to_out.0", inner, inner)
            self._layer(f"{tb}.ff.net.0.proj", inner * 8, inner)
            self._layer(f"{tb}.ff.net.2", inner, inner * 4)
            for n in ("norm1", "norm2", "norm3"):
                self._hold(f"{tb}.{n}", inner)
            # inputs (tokens, context); the loss sums axis 1 of (B, T, C),
            # the tokens, literally as the JAX unit does (unet_ldm.py:375);
            # the attention quantizers sit at attn1 / attn2
            self._units.append(ReconUnit(
                tb, "transformer",
                [f"{tb}.{a}.{leaf}" for a in ("attn1", "attn2")
                 for leaf in ("to_q", "to_k", "to_v", "to_out.0")]
                + [f"{tb}.ff.net.0.proj", f"{tb}.ff.net.2"],
                takes_temb=True, loss_axis=1,
                apply=functools.partial(self._transformer_block, tb=tb,
                                        heads=heads),
                extra_sites=[f"{tb}.attn1", f"{tb}.attn2"]))
        self._layer(f"{name}.proj_out", ch, inner, 1, 1, unit=True,
                    padding=0)
        return dict(kind="transformer", name=name, heads=heads,
                    depth=cfg.transformer_depth)

    # -- forward pieces ----------------------------------------------------

    def _use_blockwise(self, ctx: QuantCtx, key_len: int) -> bool:
        # calibration passes (collect, capture, substitute, differentiable
        # forwards: the kernels have no backward) always materialize, and
        # the int8 engine keeps its integer attention products, as in the
        # JAX package (unet_ldm.py:159-163)
        return (self.flash_threshold > 0 and key_len >= self.flash_threshold
                and ctx.collect is None and ctx.capture is None
                and not ctx.substitute and not ctx.differentiable
                and ctx.engine != "int8")

    def _conv(self, ctx, name, x, *, stride=1, padding=1):
        return qconv2d(ctx, name, self._mods[name], x,
                       self._layer_cfgs[name], stride=stride,
                       padding=padding)

    def _dense(self, ctx, name, x):
        return qdense(ctx, name, self._mods[name], x, self._layer_cfgs[name])

    def _dense_unit(self, name: str, ctx: QuantCtx, x):
        return self._dense(ctx, name, x)

    def _conv_unit(self, name: str, stride: int, padding: int,
                   upsample_first: bool, ctx: QuantCtx, x):
        if upsample_first:
            x = nn.upsample_nearest_2x(x)
        return self._conv(ctx, name, x, stride=stride, padding=padding)

    def _tokens_unit(self, name: str, ctx: QuantCtx, x):
        """The AttentionBlock's kernel-size-1 conv1d over (B, T, C)."""
        return qconv1d(ctx, name, self._mods[name], x,
                       self._layer_cfgs[name])

    def _norm(self, name):
        m = self._mods[name]
        return m.weight, m.bias

    def _resblock(self, ctx: QuantCtx, x, emb, *, plan: dict):
        n = plan["name"]
        fused = not ctx.differentiable
        h = nn.group_norm_swish(x, *self._norm(f"{n}.in_layers.0"), eps=1e-5,
                                fused_ok=fused)
        if plan["updown"] == "up":
            h, x = nn.upsample_nearest_2x(h), nn.upsample_nearest_2x(x)
        elif plan["updown"] == "down":
            h, x = nn.avg_pool_2x(h), nn.avg_pool_2x(x)
        h = self._conv(ctx, f"{n}.in_layers.2", h)
        emb_out = self._dense(ctx, f"{n}.emb_layers.1", nn.swish(emb))
        if plan["scale_shift"]:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = nn.group_norm(h, *self._norm(f"{n}.out_layers.0"), eps=1e-5,
                              fused_ok=fused)
            h = nn.swish(h * (1 + scale[:, :, None, None])
                         + shift[:, :, None, None])
        else:
            h = nn.group_norm_swish(h + emb_out[:, :, None, None],
                                    *self._norm(f"{n}.out_layers.0"),
                                    eps=1e-5, fused_ok=fused)
        h = self._conv(ctx, f"{n}.out_layers.3", h)
        if plan["skip"] == "identity":
            return x + h
        return self._conv(ctx, f"{n}.skip_connection", x, padding=0) + h

    def _qk_matmul(self, plan: dict, ctx: QuantCtx, q, k):
        """The partition's q.k^T unit: q, k (B, T, H, c) before the
        1/sqrt(sqrt(c)) scaling, which the unit applies (the reference's
        QuantQKMatMul, quant_block.py:123-134). The JAX unit's apply leaves
        the scaling to its forward only (ROADMAP §C)."""
        s = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
        pol = self.policy
        return ctx.act_matmul(f"{plan['name']}.attention.qkv_matmul", "q",
                              "k", "bthc,bshc->bhts", q * s, k * s, pol.aq,
                              pol.aq)

    def _smv_matmul(self, plan: dict, ctx: QuantCtx, w, v):
        """The partition's w.v unit: w (B, H, T, S), v (B, S, H, c) ->
        (B, T, H c)."""
        pol = self.policy
        a = ctx.act_matmul(f"{plan['name']}.attention.smv_matmul", "sm", "v",
                           "bhts,bshc->bthc", w, v, pol.sm_aq_smv, pol.aq)
        return a.reshape(*a.shape[:2], -1)

    def _attnblock(self, ctx: QuantCtx, x, *, plan: dict):
        """Multi-head QKV self-attention (QKVAttentionLegacy semantics);
        with the partition its four units run through _unit_call."""
        n, pol = plan["name"], self.policy
        part = self.act_quant_partition

        def call(name, fn, *inps):
            if not part:
                return fn(ctx, *inps)
            return self._unit_call(ctx, name, functools.partial(fn, ctx),
                                   *inps)

        b, c, hh, ww = x.shape
        heads = plan["heads"]
        ch = c // heads
        xt = _to_tokens(x)
        h = _to_tokens(nn.group_norm(x, *self._norm(f"{n}.norm"), eps=1e-5,
                                     fused_ok=False)) \
            if ctx.differentiable else \
            fused_group_norm(xt, *self._norm(f"{n}.norm"), eps=1e-5)
        qkv = call(f"{n}.qkv", functools.partial(self._tokens_unit,
                                                 f"{n}.qkv"), h)
        t = qkv.shape[1]
        qkv = qkv.reshape(b, t, heads, 3 * ch)
        q, k, v = qkv[..., :ch], qkv[..., ch:2 * ch], qkv[..., 2 * ch:]
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        if part:
            w = call(f"{n}.attention.qkv_matmul",
                     functools.partial(self._qk_matmul, plan), q, k)
        elif self._use_blockwise(ctx, t):
            qs = ctx.act_quant(n, "q", q * scale, pol.aq)
            ks = ctx.act_quant(n, "k", k * scale, pol.aq)
            sm_st, v_st = ctx.get_state(n, "sm"), ctx.get_state(n, "v")
            on = ctx.mode.a
            w = None
            a = blockwise_attention(
                qs, ks, v, scale=1.0,
                sm_q=(sm_st, pol.sm_aq_smv) if on and sm_st else None,
                v_q=(v_st, pol.aq) if on and v_st else None)
        else:
            w = ctx.act_matmul(n, "q", "k", "bthc,bshc->bhts", q * scale,
                               k * scale, pol.aq, pol.aq)
        if w is not None:
            w = torch.softmax(w.float(), dim=-1).to(x.dtype)
            if part:
                a = call(f"{n}.attention.smv_matmul",
                         functools.partial(self._smv_matmul, plan), w, v)
            else:
                a = ctx.act_matmul(n, "sm", "v", "bhts,bshc->bthc", w, v,
                                   pol.sm_aq_smv, pol.aq)
        a = a.reshape(b, t, heads * ch).to(x.dtype)
        h_out = call(f"{n}.proj_out", functools.partial(
            self._tokens_unit, f"{n}.proj_out"), a)
        return _from_tokens(xt + h_out, hh, ww)

    def _cross_attention(self, ctx: QuantCtx, x, context, site: str,
                         heads: int):
        """CrossAttention with the monkey-patched quantizer placement
        (quant_block.py:190-221): q/k quantized after the head split and
        before the d**-0.5 scaling."""
        pol = self.policy
        q = self._dense(ctx, f"{site}.to_q", x)
        kv_in = x if context is None else context
        k = self._dense(ctx, f"{site}.to_k", kv_in)
        v = self._dense(ctx, f"{site}.to_v", kv_in)
        b, tq, inner = q.shape
        tk = k.shape[1]
        d = inner // heads
        q = q.reshape(b, tq, heads, d)
        k = k.reshape(b, tk, heads, d)
        v = v.reshape(b, tk, heads, d)
        scale = d ** -0.5
        if self._use_blockwise(ctx, tk):
            qq = ctx.act_quant(site, "q", q, pol.aq)
            kq = ctx.act_quant(site, "k", k, pol.aq)
            sm_st, v_st = ctx.get_state(site, "sm"), ctx.get_state(site, "v")
            on = ctx.mode.a
            out = blockwise_attention(
                qq, kq, v, scale=scale,
                sm_q=(sm_st, pol.sm_aq_transformer) if on and sm_st else None,
                v_q=(v_st, pol.aq) if on and v_st else None)
        else:
            sim = ctx.act_matmul(site, "q", "k", "bihd,bjhd->bhij", q, k,
                                 pol.aq, pol.aq) * scale
            attn = torch.softmax(sim, dim=-1).to(x.dtype)
            out = ctx.act_matmul(site, "sm", "v", "bhij,bjhd->bihd", attn, v,
                                 pol.sm_aq_transformer, pol.aq).to(x.dtype)
        return self._dense(ctx, f"{site}.to_out.0",
                           out.reshape(b, tq, inner))

    def _transformer_block(self, ctx: QuantCtx, x, context, *, tb: str,
                           heads: int):
        h = nn.layer_norm(x, *self._norm(f"{tb}.norm1"))
        x = self._cross_attention(ctx, h, None, f"{tb}.attn1", heads) + x
        h = nn.layer_norm(x, *self._norm(f"{tb}.norm2"))
        x = self._cross_attention(ctx, h, context, f"{tb}.attn2", heads) + x
        h = nn.layer_norm(x, *self._norm(f"{tb}.norm3"))
        ff = self._dense(ctx, f"{tb}.ff.net.0.proj", h)
        a, gate = ff.chunk(2, dim=-1)  # GEGLU: (a, gate), unet_ldm.py:557
        ff = self._dense(ctx, f"{tb}.ff.net.2", a * nn.gelu(gate))
        return ff + x

    def _spatial_transformer(self, ctx: QuantCtx, x, context, plan: dict,
                             call):
        n = plan["name"]
        _, _, hh, ww = x.shape
        h = nn.group_norm(x, *self._norm(f"{n}.norm"),  # eps 1e-6
                          fused_ok=not ctx.differentiable)
        h = _to_tokens(call(f"{n}.proj_in", h))
        for d in range(plan["depth"]):
            h = call(f"{n}.transformer_blocks.{d}", h, context)
        return call(f"{n}.proj_out", _from_tokens(h, hh, ww)) + x

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                ctx: Optional[QuantCtx] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Epsilon prediction. x: NHWC latents in the model's dtype;
        t: (B,); context: (B, L, D) cross-attention tokens. Returns NHWC.
        Every reconstruction unit runs through _unit_call with the JAX
        unit boundaries (unet_ldm.py:596-661)."""
        ctx = ctx or QuantCtx()
        units = self._unit_map

        def call(name, *inps):
            """Unit `name` on inps, captured or substituted when ctx asks."""
            return self._unit_call(
                ctx, name, functools.partial(units[name].apply, ctx), *inps)

        def run(entry, h):
            for item in entry:
                kind = item["kind"]
                if kind == "layer":
                    h = call(item["name"], h)
                elif kind == "resblock":
                    h = call(item["name"], h, emb)
                elif kind == "transformer":
                    h = self._spatial_transformer(ctx, h, context, item,
                                                  call)
                elif self.act_quant_partition:  # its units capture inside
                    h = self._attnblock(ctx, h, plan=item)
                else:
                    h = call(item["name"], h)
            return h

        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        temb = nn.timestep_embedding(t, self.cfg.model_channels,
                                     fairseq=False).to(x.dtype)
        emb = call("time_embed.2", nn.swish(call("time_embed.0", temb)))
        hs = []
        h = x
        for entry in self.input_plan:
            h = run(entry, h)
            hs.append(h)
        h = run(self.middle_plan, h)
        for entry in self.output_plan:
            h = run(entry, torch.cat([h, hs.pop()], dim=1))
        h = nn.group_norm_swish(h, *self._norm("out.0"), eps=1e-5,
                                fused_ok=not ctx.differentiable)
        return call("out.2", h).permute(0, 2, 3, 1)

    def init_params(self, seed: int = 0) -> dict:
        """A seeded random state_dict on the model's device
        (models/base.py::seeded_params). Unlike the reference init, no
        output conv or proj_out is zeroed, so attention and every residual
        branch reach eps."""
        return seeded_params(self, seed)
