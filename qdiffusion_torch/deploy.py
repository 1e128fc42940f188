"""Deployment: (model, calibrated qstate) -> a denoise step (port of
qdiffusion_tpu/deploy.py).

  * 'sim'    - fake-quant simulation through QuantCtx, what the reference
               ships (deploy.py:407-426).
  * 'fold'   - weight-only: the dequantized (AdaRound-rounded) weights are
               baked into a copy of the model once, which then runs plain
               convs (deploy.py:181-219, :372-379).
  * 'int8'   - integer kernels (ops/int8.py, kernel B4) for every conv /
               dense with a calibrated activation quantizer, integer
               attention products, bf16 carriers between layers
               (deploy.py:407-429).
  * 'stream' - weight-only like 'fold', but the quantized weights of the
               packed sites stay integer in device memory (int8, or two
               nibbles per byte at 4 bits or fewer) and dequantize inside
               the streaming kernels B5 / B6 (deploy.py:381-405).

`export_quantized_checkpoint` / `load_quantized_checkpoint` are not
ported: no command of the port's CLI reads or writes them.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from qdiffusion_torch.ops.int4_matmul import pack_int4_weight
from qdiffusion_torch.ops.int8 import pack_layer, to2d, weight_int_values
from qdiffusion_torch.ops.qlayers import IN_AXIS, split_weight
from qdiffusion_torch.quant.context import ENGINES, QuantCtx, QuantMode

__all__ = ["fold_weights", "pack_model", "stream_pack_model",
           "make_quantized_step", "weight_int_values"]


@torch.no_grad()
def fold_weights(model, qstate: dict,
                 dtype: Optional[torch.dtype] = None) -> dict:
    """state_dict of `model` with every quantized weight replaced by its
    dequantized value (computed in the weight's dtype, then cast to
    `dtype` if given). Sites without a 'w' state keep their weight."""
    sd = dict(model.state_dict())
    for name, cfg in model.layer_cfgs.items():
        lstate = qstate.get(name)
        if not lstate or "w" not in lstate:
            continue
        w = sd[f"{name}.weight"]
        if cfg.split:
            parts = []
            for slot, ww in zip(("w", "w0"),
                                split_weight(w, cfg.split)):
                st = lstate[slot]
                wq = weight_int_values(ww, st, cfg.wq)
                parts.append((wq - st["zero_point"]) * st["delta"])
            w_new = torch.cat(parts, dim=IN_AXIS)
        else:
            st = lstate["w"]
            w_new = (weight_int_values(w, st, cfg.wq) - st["zero_point"]) \
                * st["delta"]
        sd[f"{name}.weight"] = w_new if dtype is None else w_new.to(dtype)
    return sd


def pack_model(model, qstate: dict) -> dict:
    """PackedWeight per layer that has both weight and activation
    quantizer states on grids that fit int8 (deploy.py:65-77)."""
    packed = {}
    for name, cfg in model.layer_cfgs.items():
        lstate = qstate.get(name)
        if not lstate or "w" not in lstate or "a" not in lstate:
            continue
        if cfg.split and ("w0" not in lstate or "a0" not in lstate):
            continue
        if cfg.aq.n_bits > 8 or cfg.wq.n_bits > 8:
            continue  # int8 carrier
        packed[name] = pack_layer(model.get_submodule(name), lstate, cfg)
    return packed


@torch.no_grad()
def stream_pack_model(model, qstate: dict, dense_only: bool = True) -> dict:
    """Weight-streaming pack (deploy.py:80-178): integer weights stay in
    device memory and dequantize inside the streaming kernels. Weights of
    4 bits or fewer are nibble-packed (two per byte, kernel B6), wider
    ones int8 (B5 for convs; dense layers dequantize to x's dtype).

    dense_only (default): only 2-D (dense) weights stream. dense_only=False
    also packs conv2d / conv1d weights as 2-D (ci*kh*kw, co) matrices in
    the (c, kh, kw) row order of the patches (ops/int8.py::patches).

    Per layer: {"segs": [...], "bias"[, "kshape", "in_chs"]}. int8 seg:
    {"w_c", "scale", "shift"} with the weight w_c * scale + shift per
    column (scale and shift bf16, w_c recentred to signed int8). int4 seg:
    {"wp", "scale4", "off4"} with the weight nib * scale4 + off4 and wp
    the K-halved nibble pack (ops/int4_matmul.py). Conv packs carry kshape
    (the filter dims) and in_chs (input channels per segment) as tuples.
    Every tensor is contiguous, in the JAX package's (K, N) layout, so
    the packs compare with the JAX package's directly."""
    packed = {}
    for name, cfg in model.layer_cfgs.items():
        lstate = qstate.get(name)
        if not lstate or "w" not in lstate:
            continue
        if cfg.split and "w0" not in lstate:
            continue
        if cfg.wq.n_bits > 8:
            continue
        layer = model.get_submodule(name)
        w = layer.weight.detach()
        if dense_only and w.ndim != 2:
            continue
        int4 = cfg.wq.n_bits <= 4
        center = 0.0 if cfg.wq.symmetric else float(2 ** (cfg.wq.n_bits - 1))
        n_out = w.shape[0]

        def per_out(a):
            a = torch.as_tensor(a, dtype=torch.float32,
                                device=w.device).reshape(-1)
            return a.expand(n_out).contiguous()

        def seg(ww, st):
            wq = to2d(weight_int_values(ww, st, cfg.wq))
            delta = per_out(st["delta"])
            if int4:
                # nib = wq + c in [0, 2^bits); w = nib * delta + off
                c = float(cfg.wq.n_levels + 1) if cfg.wq.symmetric else 0.0
                nib = (wq + c).to(torch.uint8)
                if nib.shape[0] % 2:  # the consumer pads x to match
                    nib = torch.nn.functional.pad(nib, (0, 0, 0, 1))
                off = -(c + per_out(st["zero_point"])) * delta
                return {"wp": pack_int4_weight(nib), "scale4": delta,
                        "off4": off}
            shift = (center - per_out(st["zero_point"])) * delta
            return {"w_c": (wq - center).to(torch.int8),
                    "scale": delta.to(torch.bfloat16),
                    "shift": shift.to(torch.bfloat16)}

        if cfg.split:
            halves = split_weight(w, cfg.split)
            segs = [seg(halves[0], lstate["w"]), seg(halves[1], lstate["w0"])]
        else:
            halves = (w,)
            segs = [seg(w, lstate["w"])]
        entry = {"segs": segs, "bias": None if layer.bias is None
                 else layer.bias.detach()}
        if w.ndim != 2:
            entry["kshape"] = tuple(int(s) for s in w.shape[2:])
            entry["in_chs"] = tuple(int(h.shape[1]) for h in halves)
        packed[name] = entry
    return packed


def make_quantized_step(model, qstate: dict, engine: str = "fold",
                        dtype: Optional[torch.dtype] = None,
                        carrier_dtype: torch.dtype = torch.bfloat16,
                        stream_convs=False) -> Callable:
    """Quantized denoise step (x, t[, context]) -> eps, x NHWC; context
    is the cross-attention input of a model that takes one (LDMUNet).

    fold: a copy of the model holding the folded weights, cast to `dtype`
    (default: the model's); the caller feeds x in that dtype. sim: every
    weight and activation fake-quantized on each call (hard AdaRound);
    eps comes back in x's dtype. int8: the packed sites on integer
    kernels, x cast to `carrier_dtype` between layers (bf16 default; f32
    for a comparison with sim) and eps cast back to x's dtype. stream: a
    folded copy of the model with the packed sites streaming their
    integer weights; stream_convs False packs dense layers only, True
    also packs convs and streams each where the byte cost model says so,
    "all" streams every packed conv. int8 and stream ignore `dtype`: the
    model's parameters stay as they are, as in the JAX package."""
    if engine not in ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} is not ported (have: {ENGINES})")

    def call(net, x, t, ctx, context):
        return net(x, t, ctx) if context is None else net(x, t, ctx,
                                                          context)

    if engine == "fold":
        folded = copy.deepcopy(model)
        folded.load_state_dict(fold_weights(model, qstate))
        if dtype is not None:
            folded.to(dtype)

        @torch.no_grad()
        def fold_step(x, t, context=None):
            if context is None:
                return folded(x, t)
            return folded(x, t, None, context)

        return fold_step

    if engine == "stream":
        spacked = stream_pack_model(model, qstate,
                                    dense_only=not stream_convs)
        sfolded = copy.deepcopy(model)
        sfolded.load_state_dict(fold_weights(model, qstate))
        smode = QuantMode(w=False, a=False)
        conv_mode = "all" if stream_convs == "all" else "auto"

        @torch.no_grad()
        def stream_step(x, t, context=None):
            ctx = QuantCtx(None, mode=smode, engine="stream", packed=spacked,
                           conv_stream=conv_mode)
            return call(sfolded, x, t, ctx, context)

        return stream_step

    mode = QuantMode(w=True, a=True)
    if engine == "int8":
        packed = pack_model(model, qstate)
        step_engine = "int8" if packed else "sim"

        @torch.no_grad()
        def int8_step(x, t, context=None):
            ctx = QuantCtx(qstate, mode=mode, engine=step_engine,
                           packed=packed)
            out = call(model, x.to(carrier_dtype), t, ctx, context)
            return out.to(x.dtype)

        return int8_step

    @torch.no_grad()
    def sim_step(x, t, context=None):
        ctx = QuantCtx(qstate, mode=mode)
        return call(model, x, t, ctx, context).to(x.dtype)

    return sim_step
