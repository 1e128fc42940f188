"""Quantized conv / dense layers, sim path (port of
qdiffusion_tpu/ops/qlayers.py).

Fake-quant the input activation and/or the weight, then run the op
(reference QuantModule, qdiff/quant_layer.py:203-294). Split shortcut:
the two concatenated halves of the input channels, and the matching
weight column blocks, get independent quantizers (slots 'w'/'a' for the
first half, 'w0'/'a0' for the second) before one fused conv.

Layouts: activations NCHW (split on axis 1), conv weights OIHW and dense
weights (out, in), both with input channels on axis 1 (IN_AXIS; the JAX
package's HWIO and (in, out) weights keep them on 2 and 0).
"""

from __future__ import annotations

import dataclasses

import torch

from qdiffusion_torch import nn
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx

IN_AXIS = 1


@dataclasses.dataclass(frozen=True)
class LayerQuantConfig:
    """Static per-layer quantization config."""

    wq: AffineQuantizerSpec
    aq: AffineQuantizerSpec
    split: int = 0  # input-channel split point; 0 = no split


def _quant_input(ctx: QuantCtx, name: str, x: torch.Tensor,
                 cfg: LayerQuantConfig) -> torch.Tensor:
    if cfg.split:
        x0 = ctx.act_quant(name, "a", x[:, : cfg.split], cfg.aq)
        x1 = ctx.act_quant(name, "a0", x[:, cfg.split:], cfg.aq)
        return torch.cat([x0, x1], dim=1)
    return ctx.act_quant(name, "a", x, cfg.aq)


def split_weight(w: torch.Tensor, split: int):
    """Split a weight into its two input-channel column blocks."""
    return w.narrow(IN_AXIS, 0, split), w.narrow(IN_AXIS, split,
                                                 w.shape[IN_AXIS] - split)


def _quant_weight(ctx: QuantCtx, name: str, w: torch.Tensor,
                  cfg: LayerQuantConfig) -> torch.Tensor:
    if cfg.split:
        w_a, w_b = split_weight(w, cfg.split)
        return torch.cat([ctx.weight_quant(name, "w", w_a, cfg.wq),
                          ctx.weight_quant(name, "w0", w_b, cfg.wq)],
                         dim=IN_AXIS)
    return ctx.weight_quant(name, "w", w, cfg.wq)


def qconv2d(ctx: QuantCtx, name: str, layer: torch.nn.Conv2d,
            x: torch.Tensor, cfg: LayerQuantConfig, *, stride: int = 1,
            padding: int = 0) -> torch.Tensor:
    x = _quant_input(ctx, name, x, cfg)
    w = _quant_weight(ctx, name, layer.weight, cfg)
    return nn.conv2d(x, w, layer.bias, stride=stride, padding=padding)


def qdense(ctx: QuantCtx, name: str, layer: torch.nn.Linear, x: torch.Tensor,
           cfg: LayerQuantConfig) -> torch.Tensor:
    x = _quant_input(ctx, name, x, cfg)
    w = _quant_weight(ctx, name, layer.weight, cfg)
    return nn.dense(x, w, layer.bias)
