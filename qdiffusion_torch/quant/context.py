"""QuantCtx: quantizer state and modes threaded through a forward
(port of qdiffusion_tpu/quant/context.py).

Every quantizable layer has a dotted site name (the torch state_dict path)
and each quantizer there a slot: 'w' / 'w0' (weights; '0' = second split
half), 'a' / 'a0' (input activations), 'q' 'k' 'v' 'sm' (attention
operands). The qstate is {site: {slot: {leaf: tensor}}} in torch layout
(see qdiffusion_torch/convert.py for the JAX layout).

Engines: 'sim' (fake-quant simulation) and 'fold' (weight-only; the
folded weights live in the module, so the ctx is only needed for the FP
forward). The int8/stream engines are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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


# collect modes
INIT = "init"  # first-batch scale init for act quantizers
EMA = "ema"  # running-stat momentum update

ENGINES = ("sim", "fold")


class QuantCtx:
    """Handles every quantizer site of one forward."""

    def __init__(self, qstate: Optional[dict] = None,
                 mode: QuantMode = QuantMode(),
                 collect: Optional[str] = None, engine: str = "sim"):
        if engine not in ENGINES:
            raise NotImplementedError(
                f"engine {engine!r} is not ported (have: {ENGINES})")
        self.qstate: dict = qstate or {}
        self.mode = mode
        self.collect = collect
        self.engine = engine
        self.collected: Dict[str, dict] = {}

    def _get(self, name: str, slot: str) -> Optional[dict]:
        layer = self.qstate.get(name)
        return None if layer is None else layer.get(slot)

    def _put(self, name: str, slot: str, st: dict):
        self.collected.setdefault(name, {})[slot] = st

    def weight_quant(self, name: str, slot: str, w: torch.Tensor,
                     spec: AffineQuantizerSpec) -> torch.Tensor:
        """Hard AdaRound when the state has 'alpha'; round-to-nearest
        otherwise. A site without state is initialised from the weight."""
        if not self.mode.w:
            return w
        st = self._get(name, slot)
        if st is None:
            st = init_state(w, spec)
            self._put(name, slot, st)
        if "alpha" in st:
            return adaround_quant(w, st, spec)
        return fake_quant(w, st["delta"], st["zero_point"], spec)

    def act_quant(self, name: str, slot: str, x: torch.Tensor,
                  spec: AffineQuantizerSpec) -> torch.Tensor:
        """collect=INIT: init delta/zp from this batch and record it;
        collect=EMA: momentum-update recorded stats."""
        if self.collect == INIT:
            st = self._get(name, slot) or init_state(x, spec)
            self._put(name, slot, st)
        elif self.collect == EMA:
            st = self._get(name, slot)
            if st is not None:
                st = ema_update(st, x, spec)
                self._put(name, slot, st)
        else:
            st = self._get(name, slot)
        if not self.mode.a or st is None:
            return x
        return fake_quant(x, st["delta"], st["zero_point"], spec)

    def act_matmul(self, name: str, slot_a: str, slot_b: str, eq: str,
                   a: torch.Tensor, b: torch.Tensor,
                   spec_a: AffineQuantizerSpec,
                   spec_b: AffineQuantizerSpec) -> torch.Tensor:
        """Quantized activation x activation einsum (attention QK^T and
        weights x V): both operands fake-quantized, then multiplied with
        an f32 result, as the JAX site's preferred_element_type=f32 einsum
        (a bf16 operand is exact in f32)."""
        aq = self.act_quant(name, slot_a, a, spec_a)
        bq = self.act_quant(name, slot_b, b, spec_b)
        return torch.einsum(eq, aq.float(), bq.float())
