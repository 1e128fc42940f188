"""Quant-site registry shared by the port's models (port of
qdiffusion_tpu/models/base.py).

A model registers, while it builds its submodules:
  * one LayerQuantConfig per quantizable conv/linear, keyed by the
    layer's state_dict path (which is also the quant site name), and
  * the ordered ReconUnit list: the reconstruction targets of the
    reference's named_children DFS. Calibration is not ported yet; the
    units are kept as bookkeeping so its order is fixed and tested now.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from qdiffusion_torch.ops.qlayers import LayerQuantConfig


@dataclasses.dataclass
class ReconUnit:
    """One reconstruction target: a leaf layer or a structural block."""

    name: str
    kind: str  # 'layer' | 'resnet' | 'attn'
    layer_names: List[str]  # quantizable conv/linear sites inside
    takes_temb: bool = False


class QuantModelBase(torch.nn.Module):
    """nn.Module base holding the quant-site and unit registries."""

    def __init__(self):
        super().__init__()
        self._layer_cfgs: Dict[str, LayerQuantConfig] = {}
        self._units: List[ReconUnit] = []

    def _lcfg(self, name: str, split: int = 0) -> LayerQuantConfig:
        cfg = LayerQuantConfig(wq=self.policy.wq, aq=self.policy.aq,
                               split=split)
        self._layer_cfgs[name] = cfg
        return cfg

    @property
    def units(self) -> List[ReconUnit]:
        return list(self._units)

    def layer_cfg(self, name: str) -> LayerQuantConfig:
        return self._layer_cfgs[name]

    @property
    def layer_cfgs(self) -> Dict[str, LayerQuantConfig]:
        return dict(self._layer_cfgs)
