"""Deployment: (model, calibrated qstate) -> a denoise step (port of the
fold and sim engines of qdiffusion_tpu/deploy.py).

  * 'sim'  - fake-quant simulation through QuantCtx, what the reference
             ships (deploy.py:407-426).
  * 'fold' - weight-only: the dequantized (AdaRound-rounded) weights are
             baked into a copy of the model once, which then runs plain
             convs (deploy.py:181-219, :372-379).

The int8 and stream engines are not ported yet.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from qdiffusion_torch.ops.qlayers import IN_AXIS, split_weight
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import ENGINES, QuantCtx, QuantMode


def weight_int_values(w: torch.Tensor, st: dict,
                      spec: AffineQuantizerSpec) -> torch.Tensor:
    """Integer grid values of a calibrated weight quantizer: AdaRound hard
    rounding when alpha is present, nearest otherwise (the JAX
    ops/int8.py:83-93)."""
    delta, zp = st["delta"], st["zero_point"]
    if "alpha" in st:
        w_int = torch.floor(w / delta) + (st["alpha"] >= 0).to(w.dtype)
    else:
        w_int = torch.round(w / delta)
    if spec.symmetric:
        return torch.clamp(w_int + zp, -spec.n_levels - 1, spec.n_levels)
    return torch.clamp(w_int + zp, 0, spec.n_levels - 1)


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


def make_quantized_step(model, qstate: dict, engine: str = "fold",
                        dtype: Optional[torch.dtype] = None) -> Callable:
    """Quantized denoise step (x, t[, context]) -> eps, x NHWC; context
    is the cross-attention input of a model that takes one (LDMUNet).

    fold: a copy of the model holding the folded weights, cast to `dtype`
    (default: the model's); the caller feeds x in that dtype. sim: every
    weight and activation fake-quantized on each call (hard AdaRound);
    eps comes back in x's dtype."""
    if engine not in ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} is not ported (have: {ENGINES})")
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

    mode = QuantMode(w=True, a=True)

    @torch.no_grad()
    def sim_step(x, t, context=None):
        ctx = QuantCtx(qstate, mode=mode)
        out = model(x, t, ctx) if context is None else model(x, t, ctx,
                                                            context)
        return out.to(x.dtype)

    return sim_step
