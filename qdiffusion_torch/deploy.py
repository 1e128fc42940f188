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

`export_quantized_checkpoint` / `load_quantized_checkpoint` write and
read the JAX package's quantized-checkpoint npz (deploy.py:222-356):
integer weights plus scales, in the JAX names and layout, so either
package reads the other's file.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from qdiffusion_torch.convert import assign_dotted, from_jax_params, \
    permute_layout, to_jax_params
from qdiffusion_torch.ops.int4_matmul import pack_int4_weight
from qdiffusion_torch.ops.int8 import pack_layer, to2d, weight_int_values
from qdiffusion_torch.ops.qlayers import IN_AXIS, split_weight
from qdiffusion_torch.quant.context import ENGINES, QuantCtx, QuantMode
from qdiffusion_torch.utils.checkpoints import flatten_sorted

__all__ = ["fold_weights", "pack_model", "stream_pack_model",
           "make_quantized_step", "weight_int_values",
           "export_quantized_checkpoint", "load_quantized_checkpoint"]


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


def _jax_layout(a: torch.Tensor) -> np.ndarray:
    """A torch-layout weight-shaped tensor in the JAX layout (HWIO, LIO,
    (in, out)), as numpy."""
    return permute_layout(a.detach().cpu(), to_torch=False).numpy()


@torch.no_grad()
def export_quantized_checkpoint(model, qstate: dict, path) -> dict:
    """Write `model` as integer weights plus scales (JAX deploy.py:222-299,
    the same file). Every weight with a 'w' state is stored as its grid
    values (AdaRound's hard rounding where the state has alpha), shifted
    by n_levels + 1 when symmetric, nibble-packed (`/int4`, two per byte,
    low nibble first) at 4 bits or fewer, else `/int8`, beside its
    `/delta` and `/zero_point` (f32, JAX layout); a split layer stores its
    two halves as `.w` and `.w0`. Every other leaf, the quantized layers'
    biases included, is `/fp16`. Keys are the JAX param paths. Returns the
    manifest {layer: {"bits", "shape", "split"[, "axis"], "sym"}}, also
    stored as JSON under `__manifest__`."""
    sd = model.state_dict()
    flat, manifest, done = {}, {}, set()

    def put(key, w, st, spec):
        wq = _jax_layout(weight_int_values(w, st, spec))
        shift = spec.n_levels + 1 if spec.symmetric else 0
        ints = (wq + shift).astype(np.uint8)
        if spec.n_bits <= 4:
            v = np.concatenate([ints.reshape(-1),
                                np.zeros(ints.size % 2, np.uint8)])
            flat[f"{key}/int4"] = (v[0::2] | (v[1::2] << 4)).astype(np.uint8)
        else:
            flat[f"{key}/int8"] = ints
        flat[f"{key}/delta"] = _jax_layout(st["delta"]).astype(np.float32)
        flat[f"{key}/zero_point"] = _jax_layout(
            st["zero_point"]).astype(np.float32)
        return list(ints.shape)

    for name, cfg in model.layer_cfgs.items():
        lstate = qstate.get(name)
        if not lstate or "w" not in lstate:
            continue
        w = sd[f"{name}.weight"]
        info = {"bits": cfg.wq.n_bits}
        if cfg.split:
            wa, wb = split_weight(w, cfg.split)
            # the JAX layout keeps input channels on axis ndim - 2
            info.update(shape=[put(f"{name}.w", wa, lstate["w"], cfg.wq),
                               put(f"{name}.w0", wb, lstate["w0"], cfg.wq)],
                        split=cfg.split, axis=w.ndim - 2)
        else:
            info.update(shape=put(f"{name}.w", w, lstate["w"], cfg.wq),
                        split=0)
        manifest[name] = {**info, "sym": cfg.wq.symmetric}
        done.add(f"{name}.weight")
        if sd.get(f"{name}.bias") is not None:
            flat[f"{name}.b/fp16"] = sd[f"{name}.bias"].float().cpu() \
                .numpy().astype(np.float16)
            done.add(f"{name}.bias")
    rest = to_jax_params({k: v for k, v in sd.items() if k not in done})
    for keys, a in flatten_sorted(rest):
        flat[".".join(keys) + "/fp16"] = a.astype(np.float16)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(p, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), np.uint8), **flat)
    return manifest


def load_quantized_checkpoint(path) -> Tuple[dict, dict]:
    """Read an `export_quantized_checkpoint` file (this package's or the
    JAX package's) into (state_dict, manifest): CPU f32 tensors in the
    torch layout, the quantized weights dequantized as (ints - zero_point)
    * delta in f32, which is `fold_weights`' value bit for bit; the fp16
    leaves widened to f32 (JAX deploy.py:302-356)."""
    with np.load(Path(path), allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())

        def dequant(key, bits, shape, sym):
            if bits <= 4:
                packed = data[f"{key}/int4"]
                ints = np.stack([packed & 0xF, packed >> 4], axis=1)
                ints = ints.reshape(-1)[: int(np.prod(shape))].reshape(shape)
            else:
                ints = data[f"{key}/int8"]
            ints = ints.astype(np.float32)
            if sym:  # the shift by n_levels + 1
                ints = ints - 2 ** (bits - 1)
            return (ints - data[f"{key}/zero_point"]) * data[f"{key}/delta"]

        tree: dict = {}
        for name, info in manifest.items():
            sym = info.get("sym", False)
            if info["split"]:
                w = np.concatenate(
                    [dequant(f"{name}.{slot}", info["bits"], shape, sym)
                     for slot, shape in zip(("w", "w0"), info["shape"])],
                    axis=info["axis"])
            else:
                w = dequant(f"{name}.w", info["bits"], info["shape"], sym)
            assign_dotted(tree, f"{name}.w", w)
        for key in data.files:
            if key.endswith("/fp16"):
                assign_dotted(tree, key[: -len("/fp16")],
                        data[key].astype(np.float32))
    return from_jax_params(tree), manifest


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
