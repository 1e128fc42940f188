"""Uniform affine fake quantization (port of qdiffusion_tpu/quant/affine.py).

Same semantics and the same reference quirks as the JAX module
(reference qdiff/quant_layer.py:36-200): asymmetric n_levels = 2**n_bits,
symmetric 2**(n_bits-1)-1 with the [-n_levels-1, n_levels] clamp, 'max'
init clamps the range through 0 for the zero point but takes delta from
the raw span, EMA momentum 0.95.

Weights in the port are OIHW / (out, in), so a per-output-channel weight
spec uses `channel_axis=0` where the JAX package (HWIO) uses -1. The
'mse' scale search is not ported yet (the CIFAR policy uses 'max').
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "AffineQuantizerSpec",
    "round_ste",
    "fake_quant",
    "init_scale",
    "init_state",
    "ema_update",
]


@dataclasses.dataclass(frozen=True)
class AffineQuantizerSpec:
    """Static configuration of one uniform affine quantizer."""

    n_bits: int = 8
    symmetric: bool = False
    channel_wise: bool = False
    scale_method: str = "max"  # 'max' family ('max', 'scale_max', ...)
    leaf_param: bool = False  # activation quantizer: EMA stats kept
    always_zero: bool = False  # post-softmax: zero_point pinned to 0
    channel_axis: int = 0  # axis holding channels when channel_wise

    @property
    def n_levels(self) -> int:
        return 2 ** (self.n_bits - 1) - 1 if self.symmetric else 2**self.n_bits

    def replace(self, **kw) -> "AffineQuantizerSpec":
        return dataclasses.replace(self, **kw)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient; the same
    x + (round(x) - x) arithmetic as the JAX form."""
    return x + (torch.round(x) - x).detach()


def fake_quant(x: torch.Tensor, delta, zero_point,
               spec: AffineQuantizerSpec) -> torch.Tensor:
    """Quantize-dequantize. Grid math in f32; result in x's dtype."""
    n_levels = spec.n_levels
    x_int = round_ste(x.float() / delta) + zero_point
    if spec.symmetric:
        x_quant = torch.clamp(x_int, -n_levels - 1, n_levels)
    else:
        x_quant = torch.clamp(x_int, 0, n_levels - 1)
    return ((x_quant - zero_point) * delta).to(x.dtype)


def _minmax_scale(x_min, x_max, spec: AffineQuantizerSpec):
    """'max'-method (delta, zero_point) from min/max tensors."""
    n_levels = spec.n_levels
    lo = torch.clamp(x_min, max=0.0)
    hi = torch.clamp(x_max, min=0.0)
    if "scale" in spec.scale_method:
        lo = lo * (spec.n_bits + 2) / 8
        hi = hi * (spec.n_bits + 2) / 8
    if spec.symmetric:
        delta = torch.maximum(torch.abs(lo), hi) / n_levels
    else:
        delta = (x_max - x_min) / (n_levels - 1)
    delta = torch.clamp(delta, min=1e-8)
    if spec.symmetric or spec.always_zero:
        zero_point = torch.zeros_like(delta)
    else:
        zero_point = torch.round(-lo / delta)
    return delta, zero_point


def init_scale(x: torch.Tensor, spec: AffineQuantizerSpec):
    """(delta, zero_point) from a representative tensor. Per-channel when
    spec.channel_wise: the result broadcasts against x (1s everywhere but
    the channel axis)."""
    if "max" not in spec.scale_method:
        raise NotImplementedError(spec.scale_method)
    if spec.channel_wise:
        axis = spec.channel_axis % x.ndim
        xc = torch.movedim(x, axis, 0).reshape(x.shape[axis], -1)
        delta, zp = _minmax_scale(xc.amin(dim=1), xc.amax(dim=1),
                                  spec.replace(channel_wise=False))
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        return delta.reshape(shape), zp.reshape(shape)
    return _minmax_scale(x.amin(), x.amax(), spec)


def init_state(x: torch.Tensor, spec: AffineQuantizerSpec) -> dict:
    """Full initial quantizer state from a representative tensor."""
    delta, zero_point = init_scale(x, spec)
    state = {"delta": delta, "zero_point": zero_point}
    if spec.leaf_param:
        state["x_min"] = x.amin()
        state["x_max"] = x.amax()
    return state


def ema_update(state: dict, x: torch.Tensor, spec: AffineQuantizerSpec,
               momentum: float = 0.95) -> dict:
    """Running-stat update of an activation quantizer (reference
    act_momentum_update, quant_layer.py:91-110)."""
    n_levels = spec.n_levels
    x_min = momentum * state["x_min"] + (1 - momentum) * x.amin()
    x_max = momentum * state["x_max"] + (1 - momentum) * x.amax()
    if spec.symmetric:
        delta = torch.maximum(torch.abs(x_min), torch.abs(x_max)) / n_levels
    elif spec.always_zero:
        delta = x_max / (n_levels - 1)
    else:
        delta = (x_max - x_min) / (n_levels - 1)
    delta = torch.clamp(delta, min=1e-8)
    zero_point = state["zero_point"]
    if not spec.symmetric:
        # the reference rewrites zp only in the asymmetric branch;
        # always_zero quantizers keep zp == 0 (quant_layer.py:108-109)
        if not spec.always_zero:
            zero_point = torch.round(-x_min / delta)
        else:
            zero_point = torch.zeros_like(delta)
    return {**state, "delta": delta, "zero_point": zero_point,
            "x_min": x_min, "x_max": x_max}
