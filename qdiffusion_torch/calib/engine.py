"""Quantizer initialisation (the non-reconstruction part of
qdiffusion_tpu/calib/engine.py). AdaRound reconstruction is not ported
yet. The weights are the model's own parameters."""

from __future__ import annotations

import torch

from qdiffusion_torch.ops.qlayers import split_weight
from qdiffusion_torch.quant.affine import init_state
from qdiffusion_torch.quant.context import INIT, QuantCtx, QuantMode


@torch.no_grad()
def init_weight_qstate(model) -> dict:
    """Scale-init every weight quantizer from the weights, split-aware
    (reference first-forward init, quant_layer.py:68-75 + set_split,
    :285-288), with the policy's scale method ('max' for the pixel
    UNet, 'mse' for LDM/SD)."""
    qstate: dict = {}
    for name, cfg in model.layer_cfgs.items():
        w = model.get_submodule(name).weight.float()
        if cfg.split:
            w_a, w_b = split_weight(w, cfg.split)
            qstate[name] = {"w": init_state(w_a, cfg.wq),
                            "w0": init_state(w_b, cfg.wq)}
        else:
            qstate[name] = {"w": init_state(w, cfg.wq)}
    return qstate


@torch.no_grad()
def init_act_qstate(model, qstate: dict, xs: torch.Tensor,
                    ts: torch.Tensor, cs: torch.Tensor = None) -> dict:
    """First-batch activation scale init with weights quantized (reference
    qnn.set_quant_state(True, True) + one forward,
    sample_diffusion_ddim.py:203-208). xs: NHWC; cs: the cross-attention
    context of a model that takes one. Returns a new qstate."""
    ctx = QuantCtx(qstate, mode=QuantMode(w=True, a=True), collect=INIT)
    if cs is None:
        model(xs, ts, ctx)
    else:
        model(xs, ts, ctx, cs)
    new = {k: dict(v) for k, v in qstate.items()}
    for name, slots in ctx.collected.items():
        new.setdefault(name, {}).update(slots)
    return new
