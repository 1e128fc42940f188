"""Unit input/output capture over the calibration set (port of
qdiffusion_tpu/calib/capture.py; reference forward hooks and
StopForwardException, qdiff/utils.py:18-149, 186-255).

A forward under a capturing QuantCtx records each target unit's (input,
output) (models/base.py::_unit_call). Every capture here runs under
torch.no_grad() and stops the forward once its last target unit has been
recorded: the ctx raises an exception that the sweep catches, as the
reference's hook raises StopForwardException. So the units after the
last target never run (the JAX package gets the same truncation from
XLA's dead-code elimination). The forwards are not differentiable, so on
the card their GroupNorms run kernel B1.

asym capture (AdaRound asymmetric reconstruction, utils.py:235-243): the
input is captured again with the whole network weight-quantized (the
units already reconstructed hard-rounded), the output stays full
precision.

The sweep loops over whole batches on the host; a tail batch that does
not fill `batch_size` is dropped with a warning, as in the JAX package.
A conditional model's forward takes its batch of the contexts `cs`
(B, L, D) too, and a transformer unit's captured inputs hold them.
Its jit-only parts have no eager counterpart and are not ported: the AOT
lowering of the sweeps (`lower_sweeps`) and the shape-shared programs
that exist to cut XLA compiles.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from qdiffusion_torch.quant.context import QuantCtx, QuantMode

logger = logging.getLogger(__name__)

FP = QuantMode()
WQ = QuantMode(w=True)  # the asym prefix: weights hard-rounded, acts FP


def _batch_starts(n: int, batch_size: int) -> range:
    if n % batch_size:
        # the reference iterates whole batches (qdiff/utils.py), but never
        # silently: the tail samples do not enter the calibration cache
        logger.warning(
            "capture: dropping tail batch of %d sample(s) "
            "(n=%d not divisible by batch_size=%d)",
            n % batch_size, n, batch_size)
    return range(0, n - batch_size + 1, batch_size)


class _StopForward(Exception):
    """Raised once every target unit of a capture has been recorded."""


class _TruncatingCtx(QuantCtx):
    def capture_io(self, name: str, inp, out):
        super().capture_io(name, inp, out)
        if self.is_capture_target(name) \
                and len(self.captured) == len(self.capture):
            raise _StopForward


def _model_call(model, x, t, ctx, c=None):
    """The model's forward, with the context c of a conditional model."""
    return model(x, t, ctx) if c is None else model(x, t, ctx, c)


def _forward(model, qstate, mode: QuantMode, names: Tuple[str, ...], x,
             t, c=None) -> Dict[str, tuple]:
    """One truncated forward: {name: (inputs tuple, output)}."""
    ctx = _TruncatingCtx(qstate, mode=mode, capture=frozenset(names))
    try:
        _model_call(model, x, t, ctx, c)
    except _StopForward:
        pass
    out = {}
    for n in names:
        cap = ctx.captured[n]
        inp = cap["inp"] if isinstance(cap["inp"], tuple) else (cap["inp"],)
        out[n] = (inp, cap["out"])
    return out


def _alloc(a: torch.Tensor, n: int) -> torch.Tensor:
    """An (n, ...) buffer for a full-set capture of `a`'s batches, in the
    model's channels_last layout for 4-D activations."""
    fmt = torch.channels_last if a.ndim == 4 else torch.contiguous_format
    return torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                       device=a.device, memory_format=fmt)


@torch.no_grad()
def _sweep(model, qstate, mode: QuantMode, names: Tuple[str, ...], xs, ts,
           cs, batch_size: int, want_out: bool) -> Dict[str, tuple]:
    """Capture `names` over the calibration set, whole batches only:
    {name: (inputs tuple, output or None)}, each stacked over samples
    into one preallocated buffer."""
    res: Dict[str, tuple] = {}
    for i in _batch_starts(xs.shape[0], batch_size):
        j = i + batch_size
        got = _forward(model, qstate, mode, names, xs[i:j], ts[i:j],
                       None if cs is None else cs[i:j])
        if not res:
            n = len(_batch_starts(xs.shape[0], batch_size)) * batch_size
            res = {nm: (tuple(_alloc(a, n) for a in inp),
                        _alloc(out, n) if want_out else None)
                   for nm, (inp, out) in got.items()}
        for nm, (inp, out) in got.items():
            bufs, obuf = res[nm]
            for buf, a in zip(bufs, inp):
                buf[i:j] = a
            if want_out:
                obuf[i:j] = out
    return res


def capture_unit_io(model, qstate: dict, unit_name: str,
                    cali_xs: torch.Tensor, cali_ts: torch.Tensor,
                    cali_cs: Optional[torch.Tensor] = None, *,
                    asym: bool = False, batch_size: int = 8):
    """(inputs, output) of `unit_name` over the calibration set: inputs a
    tuple of stacked tensors (e.g. (x, temb), or a transformer block's
    (tokens, context)), the output stacked. cali_cs: the contexts of a
    conditional model, row for row. With asym the inputs come from the
    weight-quantized prefix (hard rounding). The JAX function's act_quant
    prefix serves only its ungrouped engine path, which the port does not
    have."""
    names = (unit_name,)
    inps, out = _sweep(model, qstate, FP, names, cali_xs, cali_ts, cali_cs,
                       batch_size, want_out=True)[unit_name]
    if asym:
        inps = _sweep(model, qstate, WQ, names, cali_xs, cali_ts, cali_cs,
                      batch_size, want_out=False)[unit_name][0]
    return inps, out


class GroupedCapture:
    """FP captures of groups of consecutive units, one sweep per group
    (JAX capture.py:99-302).

    The FP (input, output) of every unit in a group comes from ONE sweep
    of the calibration set. asym inputs still take one sweep per unit
    (`quant_capture`), because unit j's input depends on the
    reconstruction of the units before it. Groups are packed by the
    estimated bytes of their full-set captures, which stay on the device
    while the group's units reconstruct, under `group_bytes`."""

    def __init__(self, model, batch_size: int = 8,
                 group_bytes: int = 3 << 30):
        self.model = model
        self.batch_size = batch_size
        self.group_bytes = group_bytes

    def unit_bytes(self, unit_names: Sequence[str], xs, ts,
                   cs=None) -> Dict[str, int]:
        """Bytes of each unit's full-set FP capture (inputs and output),
        from one FP forward of one sample."""
        n = len(_batch_starts(xs.shape[0], self.batch_size)) \
            * self.batch_size
        with torch.no_grad():
            got = _forward(self.model, {}, FP, tuple(unit_names), xs[:1],
                           ts[:1], None if cs is None else cs[:1])
        return {nm: n * sum(a.numel() * a.element_size()
                            for a in (*inp, out))
                for nm, (inp, out) in got.items()}

    def plan(self, unit_names: Sequence[str], xs, ts,
             cs=None) -> List[Tuple[str, ...]]:
        """Greedy consecutive grouping by estimated full-set bytes."""
        sizes = self.unit_bytes(unit_names, xs, ts, cs)
        groups: List[Tuple[str, ...]] = []
        cur: List[str] = []
        cur_bytes = 0
        for n in unit_names:
            if cur and cur_bytes + sizes[n] > self.group_bytes:
                groups.append(tuple(cur))
                cur, cur_bytes = [], 0
            cur.append(n)
            cur_bytes += sizes[n]
        if cur:
            groups.append(tuple(cur))
        logger.info("capture plan: %d unit(s) in %d group(s)",
                    len(unit_names), len(groups))
        return groups

    def fp_capture(self, group: Tuple[str, ...], xs, ts,
                   cs=None) -> Dict[str, tuple]:
        """One sweep capturing FP (inputs, output) for every unit of
        `group` over the whole calibration set."""
        return _sweep(self.model, {}, FP, tuple(group), xs, ts, cs,
                      self.batch_size, want_out=True)

    def quant_capture(self, qstate: dict, name: str, xs, ts,
                      cs=None) -> Tuple[torch.Tensor, ...]:
        """`name`'s inputs with the weight-quantized prefix of `qstate`
        (hard rounding), truncated at the unit."""
        return _sweep(self.model, qstate, WQ, (name,), xs, ts, cs,
                      self.batch_size, want_out=False)[name][0]
