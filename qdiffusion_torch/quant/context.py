"""QuantCtx: quantizer state and modes threaded through a forward
(port of qdiffusion_tpu/quant/context.py).

Every quantizable layer has a dotted site name (the torch state_dict path)
and each quantizer there a slot: 'w' / 'w0' (weights; '0' = second split
half), 'a' / 'a0' (input activations), 'q' 'k' 'v' 'sm' (attention
operands). The qstate is {site: {slot: {leaf: tensor}}} in torch layout
(see qdiffusion_torch/convert.py for the JAX layout).

Engines: 'sim' (fake-quant simulation), 'fold' (weight-only; the folded
weights live in the module, so the ctx is only needed for the FP
forward), 'int8' (integer kernels for every packed layer, ops/int8.py;
`packed` maps a site to its PackedWeight, and sites without one fall back
to simulation) and 'stream' (the folded model with integer weights
resident in device memory for the packed sites, ops/qlayers.py; `packed`
maps a site to its stream pack, deploy.py::stream_pack_model).

Calibration (calib/): `capture` names the reconstruction units whose
(input, output) a forward records into `captured`, and
`differentiable=True` marks a forward that autograd differentiates, so
the models keep to ops with a backward (the plain GroupNorm, not kernel
B1). `substitute` maps a unit name to a tensor that the forward uses in
place of that unit's output (models/base.py::_unit_call): the Fisher
block gradients (calib/fisher.py) differentiate the model output with
respect to it. `collect` is INIT (first-batch act scale init), EMA
(running-stat update of every act quantizer) or EMA_SM_ONLY (only the
post-softmax `sm` quantizers).
"""

from __future__ import annotations

import dataclasses
from typing import Collection, Dict, Optional, Union

import torch

from qdiffusion_torch.quant.adaround import adaround_quant
from qdiffusion_torch.quant.affine import (
    AffineQuantizerSpec,
    ema_update,
    fake_quant,
    init_state,
)


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """Static on/off switches (reference set_quant_state semantics)."""

    w: bool = False  # weight fake-quant active
    a: bool = False  # activation fake-quant active
    soft: bool = False  # AdaRound soft (calibration) vs hard rounding


# collect modes
INIT = "init"  # first-batch scale init for act quantizers
EMA = "ema"  # running-stat momentum update
EMA_SM_ONLY = "ema_sm_only"  # update only post-softmax quantizers

ENGINES = ("sim", "fold", "int8", "stream")


class QuantCtx:
    """Handles every quantizer site of one forward."""

    def __init__(self, qstate: Optional[dict] = None,
                 mode: QuantMode = QuantMode(),
                 collect: Optional[str] = None,
                 capture: Union[str, Collection[str], None] = None,
                 engine: str = "sim", packed: Optional[dict] = None,
                 substitute: Optional[dict] = None,
                 differentiable: bool = False, conv_stream: str = "auto"):
        if engine not in ENGINES:
            raise NotImplementedError(
                f"engine {engine!r} is not ported (have: {ENGINES})")
        self.qstate: dict = qstate or {}
        self.mode = mode
        self.collect = collect
        self.capture = capture  # unit name(s) whose (input, output) to record
        self.captured: dict = {}
        # {unit name: tensor}: the unit's output replaced by the tensor
        # (JAX context.py:68-73, the reference's backward hook GetLayerGrad,
        # qdiff/utils.py:271-308)
        self.substitute: dict = substitute or {}
        self.engine = engine
        self.packed: dict = packed or {}
        # conv_stream (stream engine): 'auto' streams a packed conv only
        # where the byte cost model says so
        # (ops/qlayers.py::_stream_conv_profitable); 'all' streams every
        # packed conv
        self.conv_stream = conv_stream
        # differentiable=True: this forward runs under autograd (block
        # reconstruction); models then take the plain GroupNorm, since the
        # kernels define no backward (their wrappers refuse a grad input)
        self.differentiable = differentiable
        self.collected: Dict[str, dict] = {}

    def _get(self, name: str, slot: str) -> Optional[dict]:
        layer = self.qstate.get(name)
        return None if layer is None else layer.get(slot)

    def _put(self, name: str, slot: str, st: dict):
        self.collected.setdefault(name, {})[slot] = st

    def weight_quant(self, name: str, slot: str, w: torch.Tensor,
                     spec: AffineQuantizerSpec) -> torch.Tensor:
        """AdaRound when the state has 'alpha' (soft rounding under
        mode.soft, hard otherwise); round-to-nearest without it. A site
        without state is initialised from the weight."""
        if not self.mode.w:
            return w
        st = self._get(name, slot)
        if st is None:
            st = init_state(w, spec)
            self._put(name, slot, st)
        if "alpha" in st:
            return adaround_quant(w, st, spec, soft=self.mode.soft)
        return fake_quant(w, st["delta"], st["zero_point"], spec)

    def act_quant(self, name: str, slot: str, x: torch.Tensor,
                  spec: AffineQuantizerSpec) -> torch.Tensor:
        """collect=INIT: init delta/zp from this batch and record it;
        collect=EMA / EMA_SM_ONLY: momentum-update the recorded stats (of
        every slot / of `sm` slots only)."""
        if self.collect == INIT:
            st = self._get(name, slot) or init_state(x, spec)
            self._put(name, slot, st)
        elif self.collect in (EMA, EMA_SM_ONLY):
            st = self._get(name, slot)
            if st is not None and (self.collect == EMA or slot == "sm"):
                st = ema_update(st, x, spec)
                self._put(name, slot, st)
        else:
            st = self._get(name, slot)
        if not self.mode.a or st is None:
            return x
        return fake_quant(x, st["delta"], st["zero_point"], spec)

    def get_state(self, name: str, slot: str) -> Optional[dict]:
        """A quantizer's state, for kernels that take the calibrated delta
        directly (the flash-attention softmax and V quantizers)."""
        return self._get(name, slot)

    def act_matmul(self, name: str, slot_a: str, slot_b: str, eq: str,
                   a: torch.Tensor, b: torch.Tensor,
                   spec_a: AffineQuantizerSpec,
                   spec_b: AffineQuantizerSpec) -> torch.Tensor:
        """Quantized activation x activation einsum (attention QK^T and
        weights x V) with an f32 result. On the int8 engine with both
        states calibrated and grids of at most 8 bits: the integer einsum
        (ops/int8.py::int8_einsum). Otherwise both operands are
        fake-quantized and multiplied, as the JAX site's
        preferred_element_type=f32 einsum (a bf16 operand is exact in
        f32): the same semantics."""
        st_a, st_b = self._get(name, slot_a), self._get(name, slot_b)
        if (self.engine == "int8" and self.mode.a and self.collect is None
                and st_a is not None and st_b is not None
                and spec_a.n_bits <= 8 and spec_b.n_bits <= 8):
            from qdiffusion_torch.ops.int8 import int8_einsum

            return int8_einsum(eq, a, b, st_a, st_b, spec_a, spec_b,
                               out_dtype=torch.float32)
        aq = self.act_quant(name, slot_a, a, spec_a)
        bq = self.act_quant(name, slot_b, b, spec_b)
        return torch.einsum(eq, aq.float(), bq.float())

    def capture_io(self, name: str, inp, out):
        """Record a unit's (input, output) when it is a capture target
        (JAX context.py:175-184)."""
        if self.is_capture_target(name):
            self.captured[name] = {"inp": inp, "out": out}

    def is_capture_target(self, name: str) -> bool:
        """`capture` is one unit name or a collection of names (one sweep
        records several units, calib/capture.py::GroupedCapture)."""
        cap = self.capture
        if cap is None:
            return False
        return name == cap if isinstance(cap, str) else name in cap
