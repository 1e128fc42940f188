"""Quant-site registry shared by the port's models (port of
qdiffusion_tpu/models/base.py).

A model registers, while it builds its submodules:
  * one LayerQuantConfig per quantizable conv/linear, keyed by the
    layer's state_dict path (which is also the quant site name), and
  * the ordered ReconUnit list: the reconstruction targets of the
    reference's named_children DFS, each with a standalone `apply` that
    calibration (calib/) replays on captured inputs. The forward calls
    every unit through `_unit_call`, which records the unit's (input,
    output) when the ctx captures it. A unit without `layer_names` (the
    LDM AttentionBlock's matmul units) holds activation quantizers only:
    the weight pass skips it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from qdiffusion_torch.ops.qlayers import LayerQuantConfig
from qdiffusion_torch.quant.context import QuantCtx


@dataclasses.dataclass
class ReconUnit:
    """One reconstruction target: a leaf layer or a structural block."""

    name: str
    # 'layer' | 'resnet' | 'attn' (DDIMUNet); 'layer' | 'resblock' |
    # 'attnblock' | 'transformer' | 'qkmatmul' | 'smvmatmul' (LDMUNet)
    kind: str
    layer_names: List[str]  # quantizable conv/linear sites inside
    takes_temb: bool = False
    # standalone forward (ctx, *inputs) -> out; the weights are the
    # model's own modules, so no params argument (JAX base.py:27)
    apply: Optional[Callable] = None
    # dim the reconstruction Lp loss sums: 1 for the channels of the
    # port's NCHW activations (JAX sums axis -1 of NHWC); otherwise the
    # JAX unit's own axis: -1 for (B, C) and (B, T, C) layers, 1 (the
    # tokens) for a transformer block, 2 for a (B, H, T, S) q.k^T unit
    loss_axis: int = -1
    # block-level act-quant sites beyond `name` (JAX base.py:33-35)
    extra_sites: List[str] = dataclasses.field(default_factory=list)


class Params(torch.nn.Module):
    """A parameter holder: `weight` of the given shape and optionally a
    `bias` of shape (shape[0],), allocated uninitialised on the current
    default device (the models load their weights after construction).
    Serves as conv, conv1d, linear, norm and embedding alike; the model's
    forward decides what it computes."""

    def __init__(self, *shape: int, bias: bool = True):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(shape))
        self.register_parameter(
            "bias", torch.nn.Parameter(torch.empty(shape[0])) if bias
            else None)


def put(root: torch.nn.Module, path: str, module: torch.nn.Module):
    """Register `module` at the dotted state_dict path under `root`,
    creating empty intermediate modules ('input_blocks.1.0.in_layers.2')."""
    node = root
    *parents, leaf = path.split(".")
    for part in parents:
        child = node._modules.get(part)
        if child is None:
            child = torch.nn.Module()
            node.add_module(part, child)
        node = child
    node.add_module(leaf, module)
    return module


@torch.no_grad()
def seeded_params(module: torch.nn.Module, seed: int) -> dict:
    """A seeded random state_dict on the module's device, drawn in
    state_dict order with a torch.Generator: every weight of rank >= 2
    N(0, 1/fan_in), norm scales (1-D `weight`) 1, biases 0. No branch is
    zero-initialised, so every path of a random model reaches its output."""
    sd = module.state_dict()
    dev = next(iter(sd.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, p in sd.items():
        if p.ndim >= 2:
            out[name] = torch.randn(p.shape, generator=gen, device=dev) \
                / math.sqrt(math.prod(p.shape[1:]))
        elif name.endswith("weight"):
            out[name] = torch.ones(p.shape, device=dev)
        else:
            out[name] = torch.zeros(p.shape, device=dev)
    return out


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

    def _unit_call(self, ctx: QuantCtx, name: str, fn: Callable, *inps):
        """fn(*inps), recorded into ctx when `name` is a capture target;
        ctx.substitute[name] in its place when the ctx has one, and then
        the unit does not run (JAX base.py:56-63)."""
        if name in ctx.substitute:
            return ctx.substitute[name]
        out = fn(*inps)
        ctx.capture_io(name, inps if len(inps) > 1 else inps[0], out)
        return out

    @property
    def units(self) -> List[ReconUnit]:
        return list(self._units)

    def layer_cfg(self, name: str) -> LayerQuantConfig:
        return self._layer_cfgs[name]

    @property
    def layer_cfgs(self) -> Dict[str, LayerQuantConfig]:
        return dict(self._layer_cfgs)
