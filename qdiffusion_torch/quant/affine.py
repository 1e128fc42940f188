"""Uniform affine fake quantization (port of qdiffusion_tpu/quant/affine.py).

Same semantics and the same reference quirks as the JAX module
(reference qdiff/quant_layer.py:36-200): asymmetric n_levels = 2**n_bits,
symmetric 2**(n_bits-1)-1 with the [-n_levels-1, n_levels] clamp, 'max'
init clamps the range through 0 for the zero point but takes delta from
the raw span, EMA momentum 0.95.

Weights in the port are OIHW / (out, in), so a per-output-channel weight
spec uses `channel_axis=0` where the JAX package (HWIO) uses -1. The
'mse' scale search (LDM/SD policy) loops over its 80 shrink candidates
instead of building the JAX package's (C, 80, N) tensor, so a
1280x2560x3x3 weight costs one weight-sized temporary, not 80.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "AffineQuantizerSpec",
    "round_ste",
    "lp_loss",
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


def lp_loss(pred: torch.Tensor, tgt: torch.Tensor, p: float = 2.0,
            reduction: str = "none", axis: int = 1) -> torch.Tensor:
    """L_p reconstruction loss: reduction='none' sums |pred-tgt|^p over
    `axis`, then means the rest (reference quant_layer.py:26-33)."""
    err = torch.abs(pred - tgt) ** p
    if reduction == "none":
        return torch.mean(torch.sum(err, dim=axis))
    return torch.mean(err)


def fake_quant(x: torch.Tensor, delta, zero_point,
               spec: AffineQuantizerSpec) -> torch.Tensor:
    """Quantize-dequantize. Grid math in f32; result in x's dtype.

    The clip is jnp.clip's minimum(maximum(x, lo), hi), not torch.clamp:
    the values are the same, but an element exactly on a bound gets half
    the gradient (the tie is split between x and the bound), as in JAX,
    where torch.clamp passes it whole. The act pass differentiates with
    respect to delta, and every activation that rounds to the first or
    last level sits exactly on a bound."""
    n_levels = spec.n_levels
    x_int = round_ste(x.float() / delta) + zero_point
    lo, hi = (torch.full((), float(v), dtype=x_int.dtype,
                         device=x_int.device)
              for v in ((-n_levels - 1, n_levels) if spec.symmetric
                        else (0, n_levels - 1)))
    x_quant = torch.minimum(torch.maximum(x_int, lo), hi)
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


def _mse_scale(x2d: torch.Tensor, spec: AffineQuantizerSpec):
    """'mse' scale search (JAX affine.py:120-153, reference
    quant_layer.py:162-190) over the rows of x2d (C, N): shrink factors
    1 - 0.01 i for i in [0, 80), score mean |x - q(x)|^2.4, the first
    minimum kept (argmin). The candidate clamps to [0, n_levels - 1] and
    its delta divides by 2**n_bits - 1, as in the reference."""
    n_bits, n_levels = spec.n_bits, spec.n_levels
    x2d = x2d.float()
    x_max = x2d.amax(dim=1)
    x_min = x2d.amin(dim=1)
    shrink = 1.0 - 0.01 * torch.arange(80, dtype=torch.float32,
                                       device=x2d.device)
    best_score = best_delta = best_zp = None
    for i in range(80):
        new_max = x_max * shrink[i]
        new_min = x_min * shrink[i]
        if spec.always_zero:
            delta = new_max / (2**n_bits - 1)
            zp = torch.zeros_like(delta)
        else:
            delta = (new_max - new_min) / (2**n_bits - 1)
            zp = torch.round(-new_min / torch.clamp(delta, min=1e-12))
        delta = torch.clamp(delta, min=1e-8)
        xq = torch.round(x2d / delta[:, None])
        xq = torch.clamp(xq + zp[:, None], 0, n_levels - 1)
        xq = (xq - zp[:, None]) * delta[:, None]
        score = torch.mean(torch.abs(x2d - xq) ** 2.4, dim=1)
        if best_score is None:
            best_score, best_delta, best_zp = score, delta, zp
        else:
            better = score < best_score
            best_score = torch.where(better, score, best_score)
            best_delta = torch.where(better, delta, best_delta)
            best_zp = torch.where(better, zp, best_zp)
    return best_delta, best_zp


def _scale(xc: torch.Tensor, spec: AffineQuantizerSpec):
    """(delta, zero_point) per row of xc (C, N)."""
    if "max" in spec.scale_method:
        return _minmax_scale(xc.amin(dim=1), xc.amax(dim=1), spec)
    if spec.scale_method == "mse":
        return _mse_scale(xc, spec)
    raise NotImplementedError(spec.scale_method)


def init_scale(x: torch.Tensor, spec: AffineQuantizerSpec):
    """(delta, zero_point) from a representative tensor. Per-channel when
    spec.channel_wise: the result broadcasts against x (1s everywhere but
    the channel axis)."""
    if spec.channel_wise:
        axis = spec.channel_axis % x.ndim
        xc = torch.movedim(x, axis, 0).reshape(x.shape[axis], -1)
        delta, zp = _scale(xc, spec.replace(channel_wise=False))
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        return delta.reshape(shape), zp.reshape(shape)
    delta, zp = _scale(x.reshape(1, -1), spec)
    return delta[0], zp[0]


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
