"""PTQ calibration (port of qdiffusion_tpu/calib/engine.py; reference flow
scripts/sample_diffusion_ddim.py:127-236).

  1. weight-quantizer scale init (per-channel min-max / MSE, from the
     weights; the reference does it through a dummy forward);
  2. the AdaRound weight pass: every unit's alphas initialised up front,
     then per capture group (calib/capture.py::GroupedCapture) one FP
     sweep for the group's outputs and, per unit in model order, the
     asymmetric input capture (the weight-quantized prefix, units
     already reconstructed hard-rounded) and `reconstruct_unit`;
  3. with quant_act, the activation pass: act scale init from
     act_init_batch calibration rows drawn without replacement, an
     optional running-stat EMA sweep, then per group one FP sweep for
     the units' inputs and outputs and, per unit, the Fisher grads (when
     the act opt_mode asks for them) and `reconstruct_unit(act_quant=
     True)`.

Each unit's capture buffers are dropped before the next capture. With a
checkpointer (utils/checkpoints.py::CalibCheckpointer) each phase writes
a full base snapshot before its unit loop, an increment every
ckpt_every units, and the final qstate.npz; a run whose directory holds
a marker resumes after the unit it names. The result is one qstate in
the torch layout. The JAX config's `precompile` and `pipeline` fields
schedule XLA compiles and have no eager counterpart.

Conditional models (SD) calibrate on (xs, ts, cs): every forward of the
act init, the EMA sweep, the captures and the Fisher grads takes the
rows' contexts cs beside them (JAX engine.py:125-166).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Tuple

import torch

from qdiffusion_torch.calib.capture import GroupedCapture, _model_call
from qdiffusion_torch.calib.fisher import save_grad_data
from qdiffusion_torch.calib.recon import (
    ReconConfig,
    _sites,
    init_adaround_unit,
    reconstruct_unit,
)
from qdiffusion_torch.ops.qlayers import split_weight
from qdiffusion_torch.quant.affine import init_state
from qdiffusion_torch.quant.context import (
    EMA,
    EMA_SM_ONLY,
    INIT,
    QuantCtx,
    QuantMode,
)

logger = logging.getLogger(__name__)

WA = QuantMode(w=True, a=True)  # the act init's and EMA sweep's forward


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    weight: ReconConfig = ReconConfig(iters=20000, p=2.0)
    act: ReconConfig = ReconConfig(iters=5000, lr=4e-4, p=2.4)
    asym: bool = True  # weight pass: unit inputs from the quantized prefix
    quant_act: bool = False  # run the activation pass
    running_stat: bool = False  # EMA sweep after the act scale init
    rs_sm_only: bool = False  # the EMA updates post-softmax quantizers only
    capture_batch: int = 8
    act_init_batch: int = 64  # act init rows; also the EMA sweep's batch
    sm_abit: int = 8  # post-softmax bits (16: its delta is not trained)
    alpha_dtype: str = "float32"  # AdaRound alpha storage dtype
    skip_units: Tuple[str, ...] = ()  # names excluded from reconstruction
    ckpt_every: int = 8  # units between checkpoint increments
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


def _merge_collected(qstate: dict, collected: dict) -> dict:
    new = {k: dict(v) for k, v in qstate.items()}
    for name, slots in collected.items():
        new.setdefault(name, {}).update(slots)
    return new


@torch.no_grad()
def init_act_qstate(model, qstate: dict, xs: torch.Tensor,
                    ts: torch.Tensor, cs: torch.Tensor = None) -> dict:
    """First-batch activation scale init with weights quantized (reference
    qnn.set_quant_state(True, True) + one forward,
    sample_diffusion_ddim.py:203-208). xs: NHWC; cs: the cross-attention
    context of a model that takes one. Returns a new qstate."""
    ctx = QuantCtx(qstate, mode=WA, collect=INIT)
    _model_call(model, xs, ts, ctx, cs)
    return _merge_collected(qstate, ctx.collected)


@torch.no_grad()
def run_running_stat(model, qstate: dict, xs: torch.Tensor,
                     ts: torch.Tensor, cs: torch.Tensor = None, *,
                     batch: int = 64, sm_only: bool = False) -> dict:
    """EMA sweep over the calibration set in whole batches, each batch's
    forward reading the stats the batch before left (reference
    set_running_stat, quant_model.py:71-87; JAX engine.py:149-170); cs:
    the contexts, sliced with the batch."""
    collect = EMA_SM_ONLY if sm_only else EMA
    for i in range(0, xs.shape[0] - batch + 1, batch):
        j = i + batch
        ctx = QuantCtx(qstate, mode=WA, collect=collect)
        _model_call(model, xs[i:j], ts[i:j], ctx,
                    None if cs is None else cs[i:j])
        qstate = _merge_collected(qstate, ctx.collected)
    return qstate


def _act_init_indices(n: int, k: int,
                      generator: torch.Generator) -> torch.Tensor:
    """k of the n calibration rows, drawn without replacement on the
    generator's device (JAX: jax.random.choice(..., replace=False))."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:k]


def _sync(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class _Snapshots:
    """The checkpointer's in-loop increments (JAX engine.py:395-420,
    518-536): every ckpt_every units, the sites reconstructed since the
    save before; a save that the checkpointer defers is retried at the
    end of the group, with the last unit done."""

    def __init__(self, checkpointer, every: int):
        self.ckpt, self.every = checkpointer, every
        self.pending: set = set()
        self.due = False

    def base(self, qstate: dict, phase: str, unit_idx: int):
        if self.ckpt is not None:
            t0 = time.perf_counter()
            self.ckpt.save(qstate, phase, unit_idx, sites=None)
            self.pending.clear()
            logger.info("%s-phase base qstate snapshot written (%.1fs)",
                        phase, time.perf_counter() - t0)

    def unit_done(self, qstate: dict, phase: str, k: int, unit):
        # every site the unit trains: its layers, its own and its extra
        # act sites (a transformer block's attn1 / attn2 deltas; the JAX
        # engine leaves those out of its increments)
        self.pending.update(_sites(unit))
        self.last = (phase, k)
        if self.ckpt is not None and (k + 1) % self.every == 0:
            self._save(qstate)

    def group_done(self, qstate: dict):
        if self.due:
            self._save(qstate)

    def _save(self, qstate: dict):
        phase, k = self.last
        self.due = not self.ckpt.save(qstate, phase, k,
                                      sites=sorted(self.pending))
        if not self.due:
            self.pending.clear()


def calibrate(model, cali_data: Sequence[torch.Tensor],
              cfg: CalibConfig = CalibConfig(),
              generator: Optional[torch.Generator] = None,
              qstate: Optional[dict] = None, checkpointer=None,
              skip_weight_pass: bool = False) -> dict:
    """The weight pass over every unit of `model`, then with
    cfg.quant_act the activation pass; returns the calibrated qstate.
    cali_data: (xs NHWC, ts), or (xs, ts, cs) for a conditional model, on
    the model's device (calib/samples.py::get_train_samples). generator draws the act init
    rows and every unit's minibatches in turn (default: seed 0 on the
    data's device). qstate: the state to start from (default:
    init_weight_qstate). checkpointer: snapshots, and a resume from the
    marker it finds. skip_weight_pass: only the activation pass, on
    `qstate`'s reconstructed weights (reference --resume_w)."""
    xs, ts = cali_data[:2]
    cs = cali_data[2] if len(cali_data) > 2 else None
    if generator is None:
        generator = torch.Generator(device=xs.device).manual_seed(0)
    start_phase, start_idx = "weight", 0
    if skip_weight_pass:
        if qstate is None:
            raise ValueError("skip_weight_pass needs the weight pass's "
                             "qstate")
        start_phase = "act_init"
    if checkpointer is not None:
        saved, progress = checkpointer.load(xs.device)
        if saved is not None:
            qstate = saved
            start_phase = progress["phase"]
            start_idx = progress["unit_idx"] + 1
    if qstate is None:
        qstate = init_weight_qstate(model)
        logger.info("weight quantizer scales initialized (%d layers)",
                    len(qstate))
    units = model.units
    by_name = {u.name: (k, u) for k, u in enumerate(units)}
    gc = GroupedCapture(model, batch_size=cfg.capture_batch,
                        group_bytes=cfg.capture_group_bytes)
    snaps = _Snapshots(checkpointer, cfg.ckpt_every)

    def todo(group, first):
        return any(by_name[n][0] >= first for n in group)

    if start_phase == "weight":
        names = [u.name for u in units
                 if u.name not in cfg.skip_units and u.layer_names]
        # every alpha up front (JAX engine.py:289-310): the quantized
        # prefix of each asym capture then reads the same qstate structure
        # throughout
        for n in names:
            qstate = init_adaround_unit(model, qstate, by_name[n][1],
                                        skip_existing=True,
                                        alpha_dtype=cfg.alpha_dtype)
        if checkpointer is not None and not checkpointer.has_base:
            snaps.base(qstate, "weight", start_idx - 1)
        for group in gc.plan(names, xs, ts, cs) if names else []:
            if not todo(group, start_idx):
                continue
            fp = gc.fp_capture(group, xs, ts, cs)
            if cfg.asym:
                # asym reconstruction reads only the FP output; the inputs
                # come from the quantized-prefix sweep, so drop the FP
                # inputs now
                fp = {n: (None, out) for n, (inp, out) in fp.items()}
            for name in group:
                k, unit = by_name[name]
                inps, out = fp.pop(name)
                if k < start_idx:
                    continue
                t0 = time.perf_counter()
                if cfg.asym:
                    inps = gc.quant_capture(qstate, name, xs, ts, cs)
                _sync(out)
                t_cap = time.perf_counter() - t0
                grads = None if cfg.weight.opt_mode == "mse" else \
                    save_grad_data(model, qstate, name, xs, ts, cs,
                                   batch_size=cfg.capture_batch)
                qstate = reconstruct_unit(model, qstate, unit, inps, out,
                                          cfg.weight, sm_abit=cfg.sm_abit,
                                          cached_grads=grads,
                                          generator=generator,
                                          alpha_dtype=cfg.alpha_dtype)
                # free this unit's buffers before the next capture
                del inps, out, grads
                _sync(xs)
                logger.info("[%d/%d] weight recon %-28s %.1fs (capture "
                            "%.1fs)", k + 1, len(units), name,
                            time.perf_counter() - t0, t_cap)
                snaps.unit_done(qstate, "weight", k, unit)
            del fp
            snaps.group_done(qstate)
        start_idx = 0

    if not cfg.quant_act:
        if checkpointer is not None:
            checkpointer.finalize(qstate)
        return qstate

    if start_phase in ("weight", "act_init"):
        t0 = time.perf_counter()
        n_init = min(cfg.act_init_batch, xs.shape[0])
        idx = _act_init_indices(xs.shape[0], n_init, generator)
        qstate = init_act_qstate(model, qstate, xs[idx], ts[idx],
                                 None if cs is None else cs[idx])
        logger.info("activation quantizer scales initialized (%d rows)",
                    n_init)
        if cfg.running_stat:
            qstate = run_running_stat(model, qstate, xs, ts, cs,
                                      batch=cfg.act_init_batch,
                                      sm_only=cfg.rs_sm_only)
            logger.info("running-stat EMA sweep done")
        _sync(xs)
        logger.info("act init%s %.1fs", " + EMA" * cfg.running_stat,
                    time.perf_counter() - t0)
        start_idx = 0
        # the init and the sweep touch every site: a fresh full base,
        # before the unit loop allocates capture buffers
        snaps.base(qstate, "act", -1)

    names = [u.name for u in units if u.name not in cfg.skip_units]
    for group in gc.plan(names, xs, ts, cs) if names else []:
        if not todo(group, start_idx):
            continue
        fp = gc.fp_capture(group, xs, ts, cs)
        for name in group:
            k, unit = by_name[name]
            inps, out = fp.pop(name)
            if k < start_idx:
                continue
            t0 = time.perf_counter()
            grads = None if cfg.act.opt_mode == "mse" else \
                save_grad_data(model, qstate, name, xs, ts, cs,
                               act_quant=True, batch_size=cfg.capture_batch)
            qstate = reconstruct_unit(model, qstate, unit, inps, out,
                                      cfg.act, act_quant=True,
                                      sm_abit=cfg.sm_abit,
                                      cached_grads=grads,
                                      generator=generator)
            del inps, out, grads
            _sync(xs)
            logger.info("[%d/%d] act recon    %-28s %.1fs", k + 1,
                        len(units), name, time.perf_counter() - t0)
            snaps.unit_done(qstate, "act", k, unit)
        del fp
        snaps.group_done(qstate)

    if checkpointer is not None:
        checkpointer.finalize(qstate)
    return qstate
