"""Block / layer reconstruction, the calibration optimiser (port of
qdiffusion_tpu/calib/recon.py; reference qdiff/block_recon.py +
layer_recon.py).

Weight pass (mode "weight"): per reconstruction unit, Adam at alpha_lr
minimises

    L = mean(sum(|unit_q(inp) - out_fp|^p, loss_axis))
        + weight * sum(1 - |2 h(alpha) - 1|^b)

over the unit's AdaRound alphas, with soft rounding (the rounding term
is zero during the first `warmup` share of the iterations; b decays
linearly from b_start to b_end after it).

Activation pass (mode "act"): Adam minimises the reconstruction term
alone over the deltas of the unit's activation quantizers (ACT_SLOTS;
`sm` left out at sm_abit 16), with the weights hard-rounded by their
learned alphas and the learning rate cosine-annealed from `lr` to 0
(optax.cosine_decay_schedule: update k uses cosine_lr(lr, iters, k)).

opt_mode 'fisher_diag' / 'fisher_full' weights the reconstruction term
by cached Fisher grads (calib/fisher.py), gathered with the minibatch.

The cached inputs and outputs stay on the device; each iteration draws
`batch_size` samples with replacement (`_batch_indices`), runs the
unit's forward differentiably (QuantCtx(differentiable=True): the plain
GroupNorm, never kernel B1) and steps torch.optim.Adam, whose update is
optax.adam's. The JAX module's compile machinery (the canonical
relabelling, `_RUN_CACHE`, `lower_unit_runner`) exists to share XLA
programs and has no eager counterpart.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from qdiffusion_torch.calib.fisher import fisher_rec_loss
from qdiffusion_torch.ops.qlayers import split_weight
from qdiffusion_torch.quant.adaround import (
    adaround_init_alpha,
    adaround_soft_targets,
)
from qdiffusion_torch.quant.context import QuantCtx, QuantMode

logger = logging.getLogger(__name__)

SOFT = QuantMode(w=True, a=False, soft=True)  # the weight pass's forward
HARD_ACT = QuantMode(w=True, a=True, soft=False)  # the act pass's forward

ACT_SLOTS = ("a", "a0", "q", "k", "v", "sm")


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    iters: int = 20000
    batch_size: int = 32
    weight: float = 0.01  # rounding-regularizer weight
    b_start: float = 20.0
    b_end: float = 2.0
    warmup: float = 0.2
    p: float = 2.0  # Lp reconstruction norm (the act pass uses 2.4)
    lr: float = 4e-4  # act-delta learning rate, cosine-annealed
    alpha_lr: float = 1e-3  # Adam learning rate of the alphas
    opt_mode: str = "mse"  # 'mse' | 'fisher_diag' | 'fisher_full'


def _dtype(name) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name) \
        if isinstance(name, str) else name


@torch.no_grad()
def init_adaround_unit(model, qstate: dict, unit, *,
                       skip_existing: bool = False,
                       alpha_dtype=None) -> dict:
    """A new qstate in which every weight quantizer of `unit` has an
    AdaRound alpha, split-aware (reference block_recon.py:47-61).
    skip_existing keeps alphas already there (the engine's upfront
    pre-init). alpha_dtype: storage dtype of new alphas ('float32',
    'bfloat16' or a torch dtype; default the weight's)."""
    dtype = _dtype(alpha_dtype)
    new = dict(qstate)
    for lname in unit.layer_names:
        cfg = model.layer_cfg(lname)
        w = model.get_submodule(lname).weight
        lstate = dict(new.get(lname, {}))
        pairs = zip(("w", "w0"), split_weight(w, cfg.split)) if cfg.split \
            else (("w", w),)
        for slot, ww in pairs:
            if skip_existing and "alpha" in lstate[slot]:
                continue
            st = dict(lstate[slot])
            st["alpha"] = adaround_init_alpha(ww.float(), st["delta"],
                                              dtype=dtype)
            lstate[slot] = st
        new[lname] = lstate
    return new


def _sites(unit) -> list:
    return list(dict.fromkeys(list(unit.layer_names) + [unit.name]
                              + list(unit.extra_sites)))


def extract_trainable(qstate: dict, unit, mode: str = "weight",
                      sm_abit: int = 8
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{site: {slot: leaf}}: mode 'weight', the alphas of the unit's
    weight quantizers; mode 'act', the deltas of its activation
    quantizers, without the post-softmax one at 16 bits (reference
    block_recon.py:87-98)."""
    train: Dict[str, Dict[str, torch.Tensor]] = {}
    for site in _sites(unit):
        for slot, st in (qstate.get(site) or {}).items():
            if mode == "weight" and slot in ("w", "w0") and "alpha" in st:
                train.setdefault(site, {})[slot] = st["alpha"]
            elif mode == "act" and slot in ACT_SLOTS \
                    and not (slot == "sm" and sm_abit == 16):
                train.setdefault(site, {})[slot] = st["delta"]
    return train


def merge_trainable(qstate: dict, train: dict, mode: str = "weight") -> dict:
    """A new qstate with `train`'s leaves in place of the alphas (mode
    'weight') or of the deltas (mode 'act')."""
    key = "alpha" if mode == "weight" else "delta"
    new = {k: dict(v) for k, v in qstate.items()}
    for site, slots in train.items():
        for slot, val in slots.items():
            st = dict(new[site][slot])
            st[key] = val
            new[site][slot] = st
    return new


def temp_decay(t: torch.Tensor, t_max: float, warmup: float,
               start_b: float, end_b: float) -> torch.Tensor:
    """Rounding-term exponent b at iteration t, an f32 tensor (reference
    LinearTempDecay, block_recon.py:235-252): start_b through the warmup,
    then linear to end_b."""
    start_decay = warmup * t_max
    rel_t = (t - start_decay) / (t_max - start_decay)
    decayed = end_b + (start_b - end_b) * torch.clamp(1.0 - rel_t, min=0.0)
    return torch.where(t < start_decay, torch.full_like(decayed, start_b),
                       decayed)


def deltas_below_lr(qstate: dict, unit, lr: float,
                    sm_abit: int = 8) -> List[Tuple[str, str]]:
    """(site, slot) of the unit's trained act deltas smaller than `lr`.
    Adam's first update is lr times the gradient's sign, so it moves such
    a delta by more than its own size, and it can turn negative: the
    reference's act pass (lr 4e-4) does that to a post-softmax delta of a
    flat softmax (about 1e-4 at 64-256 tokens)."""
    return [(site, slot) for site, slots in extract_trainable(
                qstate, unit, "act", sm_abit).items()
            for slot, d in slots.items() if float(d.abs().min()) < lr]


def cosine_lr(lr: float, iters: int, k: int) -> float:
    """The act pass's learning rate for update k (0-based): optax.
    cosine_decay_schedule(lr, iters, alpha=0) at count k, so the first
    update takes the whole lr. Set before each step, never by a
    scheduler stepped after it, which would shift the schedule by one."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(k, iters) / iters))


def _batch_indices(i: int, n: int, batch_size: int,
                   gen: torch.Generator) -> torch.Tensor:
    """Iteration i's minibatch: batch_size indices into the n cached
    samples, drawn with replacement on the generator's device."""
    return torch.randint(0, n, (batch_size,), generator=gen,
                         device=gen.device)


def recon_loss(pred: torch.Tensor, out: torch.Tensor,
               train: Dict[str, Dict[str, torch.Tensor]], b: float,
               count: float, cfg: ReconConfig, loss_axis: int, *,
               act_quant: bool = False,
               grad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss at iteration `count` (1-based) with exponent b (JAX
    recon.py:329-354): the Lp reconstruction error summed over loss_axis
    and averaged over the rest (or cfg.opt_mode's Fisher loss with the
    minibatch's `grad`), plus, in the weight pass, the rounding term
    after the warmup."""
    if cfg.opt_mode != "mse":
        rec = fisher_rec_loss(pred, out, grad, cfg.opt_mode, axis=loss_axis)
    else:
        rec = torch.mean(torch.sum(torch.abs(pred - out) ** cfg.p,
                                   dim=loss_axis))
    if act_quant or count < cfg.warmup * cfg.iters:
        return rec  # no rounding penalty during warmup (block_recon.py:217)
    for slots in train.values():
        for alpha in slots.values():
            h = adaround_soft_targets(alpha)
            rec = rec + cfg.weight * torch.sum(
                1.0 - torch.abs(2.0 * h - 1.0) ** b)
    return rec


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    g = a.index_select(0, idx)
    return g.contiguous(memory_format=torch.channels_last) \
        if g.ndim == 4 else g


def reconstruct_unit(model, qstate: dict, unit,
                     cached_inps: Sequence[torch.Tensor],
                     cached_out: torch.Tensor, cfg: ReconConfig, *,
                     act_quant: bool = False, sm_abit: int = 8,
                     cached_grads: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     alpha_dtype=None) -> dict:
    """Optimise the unit's rounding (act_quant False) or its activation
    deltas (act_quant True); returns the updated qstate, the trained
    leaves in their storage dtype (`alpha_dtype` for new alphas).

    The model's parameters are frozen (requires_grad False); the leaves
    train in f32 and are cast back once at the end. cached_grads: the
    Fisher grads aligned with cached_out, needed when cfg.opt_mode is not
    'mse'. `generator` draws the minibatches, on the cached tensors'
    device (default: seed 0 there)."""
    if cfg.opt_mode != "mse" and cached_grads is None:
        raise ValueError(f"opt_mode {cfg.opt_mode!r} needs cached_grads "
                         "(calib/fisher.py::save_grad_data)")
    mode = "act" if act_quant else "weight"
    model.requires_grad_(False)
    if not act_quant:
        qstate = init_adaround_unit(model, qstate, unit,
                                    alpha_dtype=alpha_dtype)
    train0 = extract_trainable(qstate, unit, mode, sm_abit)
    if not train0:
        return qstate
    if act_quant:
        # every act-pass unit logs its record (a warning when a delta is
        # below the lr); `extra` carries the list for a handler to read
        small = deltas_below_lr(qstate, unit, cfg.lr, sm_abit)
        extra = {"unit": unit.name, "deltas_below_lr": small}
        if small:
            logger.warning("%s: act deltas %s are below the learning rate "
                           "%g; the first Adam steps move them by more "
                           "than their size", unit.name, small, cfg.lr,
                           extra=extra)
        else:
            logger.debug("%s: no act delta below the learning rate %g",
                         unit.name, cfg.lr, extra=extra)
    dev = cached_out.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    train = {site: {slot: a.detach().float().clone().requires_grad_(True)
                    for slot, a in slots.items()}
             for site, slots in train0.items()}
    opt = torch.optim.Adam([a for slots in train.values()
                            for a in slots.values()],
                           lr=cfg.lr if act_quant else cfg.alpha_lr)
    sites = {s: qstate[s] for s in _sites(unit) if s in qstate}
    n = cached_out.shape[0]
    # b in f32 on the host, as the JAX loop computes it: no device sync
    bs = temp_decay(torch.arange(1, cfg.iters + 1, dtype=torch.float32),
                    cfg.iters, cfg.warmup, cfg.b_start, cfg.b_end).tolist()
    with torch.enable_grad():
        for i in range(cfg.iters):
            idx = _batch_indices(i, n, cfg.batch_size, generator).to(dev)
            if act_quant:
                opt.param_groups[0]["lr"] = cosine_lr(cfg.lr, cfg.iters, i)
            ctx = QuantCtx(merge_trainable(sites, train, mode),
                           mode=HARD_ACT if act_quant else SOFT,
                           differentiable=True)
            pred = unit.apply(ctx, *(_gather(a, idx) for a in cached_inps))
            loss = recon_loss(
                pred, _gather(cached_out, idx), train, bs[i], i + 1.0, cfg,
                unit.loss_axis, act_quant=act_quant,
                grad=None if cached_grads is None
                else _gather(cached_grads, idx))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    final = {site: {slot: a.detach().to(train0[site][slot].dtype)
                    for slot, a in slots.items()}
             for site, slots in train.items()}
    return merge_trainable(qstate, final, mode)
