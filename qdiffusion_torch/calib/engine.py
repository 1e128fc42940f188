"""PTQ calibration, the weight pass (port of
qdiffusion_tpu/calib/engine.py; reference flow
scripts/sample_diffusion_ddim.py:127-236).

  1. weight-quantizer scale init (per-channel min-max / MSE, from the
     weights; the reference does it through a dummy forward);
  2. the AdaRound alphas of every unit initialised up front;
  3. per capture group (calib/capture.py::GroupedCapture): one FP sweep
     for the group's outputs, then per unit in model order the
     asymmetric input capture (the weight-quantized prefix, units already
     reconstructed hard-rounded) and `reconstruct_unit`. Each unit's
     capture buffers are dropped before the next capture.

The result is one qstate in the torch layout (utils/checkpoints.py
writes it in the JAX layout). The activation pass (act scale init,
running-stat EMA, act-delta reconstruction) and the resumable
checkpointer are ROADMAP A4b; `init_act_qstate` below is the first-batch
act scale init the sim engine uses. The JAX config's `precompile` and
`pipeline` fields schedule XLA compiles and have no eager counterpart.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Tuple

import torch

from qdiffusion_torch.calib.capture import GroupedCapture
from qdiffusion_torch.calib.recon import (
    ReconConfig,
    init_adaround_unit,
    reconstruct_unit,
)
from qdiffusion_torch.ops.qlayers import split_weight
from qdiffusion_torch.quant.affine import init_state
from qdiffusion_torch.quant.context import INIT, QuantCtx, QuantMode

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    weight: ReconConfig = ReconConfig(iters=20000, p=2.0)
    asym: bool = True  # unit inputs from the weight-quantized prefix
    quant_act: bool = False  # the activation pass: ROADMAP A4b
    capture_batch: int = 8
    alpha_dtype: str = "float32"  # AdaRound alpha storage dtype
    skip_units: Tuple[str, ...] = ()  # names excluded from reconstruction
    capture_group_bytes: int = 3 << 30  # full-set FP capture bytes a group


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


def _sync(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def calibrate(model, cali_data: Sequence[torch.Tensor],
              cfg: CalibConfig = CalibConfig(),
              generator: Optional[torch.Generator] = None,
              qstate: Optional[dict] = None) -> dict:
    """The AdaRound weight pass over every unit of `model`; returns the
    calibrated qstate. cali_data: (xs NHWC, ts) on the model's device
    (calib/samples.py::get_train_samples). generator draws every unit's
    minibatches in turn (default: seed 0 on the data's device). qstate:
    weight scales to start from (default: init_weight_qstate)."""
    if cfg.quant_act:
        raise NotImplementedError(
            "the activation pass (quant_act) is ROADMAP A4b; this port "
            "calibrates weights only")
    if len(cali_data) > 2:
        raise NotImplementedError(
            "conditional calibration data is ROADMAP A4b")
    xs, ts = cali_data
    if generator is None:
        generator = torch.Generator(device=xs.device).manual_seed(0)
    if qstate is None:
        qstate = init_weight_qstate(model)
        logger.info("weight quantizer scales initialized (%d layers)",
                    len(qstate))
    units = model.units
    names = [u.name for u in units
             if u.name not in cfg.skip_units and u.layer_names]
    by_name = {u.name: (k, u) for k, u in enumerate(units)}
    # every alpha up front (JAX engine.py:289-310): the quantized prefix of
    # each asym capture then reads the same qstate structure throughout
    for n in names:
        qstate = init_adaround_unit(model, qstate, by_name[n][1],
                                    skip_existing=True,
                                    alpha_dtype=cfg.alpha_dtype)
    gc = GroupedCapture(model, batch_size=cfg.capture_batch,
                        group_bytes=cfg.capture_group_bytes)
    for group in gc.plan(names, xs, ts) if names else []:
        fp = gc.fp_capture(group, xs, ts)
        if cfg.asym:
            # asym reconstruction reads only the FP output; the inputs come
            # from the quantized-prefix sweep, so drop the FP inputs now
            fp = {n: (None, out) for n, (inp, out) in fp.items()}
        for name in group:
            k, unit = by_name[name]
            t0 = time.perf_counter()
            inps, out = fp.pop(name)
            if cfg.asym:
                inps = gc.quant_capture(qstate, name, xs, ts)
            _sync(out)
            t_cap = time.perf_counter() - t0
            qstate = reconstruct_unit(model, qstate, unit, inps, out,
                                      cfg.weight, generator=generator,
                                      alpha_dtype=cfg.alpha_dtype)
            del inps, out  # free this unit's buffers before the next capture
            _sync(xs)
            logger.info("[%d/%d] weight recon %-28s %.1fs (capture %.1fs)",
                        k + 1, len(units), name, time.perf_counter() - t0,
                        t_cap)
    return qstate
