"""AdaRound adaptive rounding (port of qdiffusion_tpu/quant/adaround.py;
reference qdiff/adaptive_rounding.py:9-78).

Rectified-sigmoid soft rounding h(alpha) = clip(sigmoid(alpha) * (zeta -
gamma) + gamma, 0, 1) with gamma = -0.1, zeta = 1.1, for calibration;
alpha starts where h(alpha) is the weight's fractional remainder; the
learned hard rounding (alpha >= 0: round up) at inference. The clamp uses
the affine spec's asymmetric level count (adaptive_rounding.py:58).

A calibrated weight qstate carries `alpha` in the weight's layout (OIHW /
(out, in) here); utils/checkpoints.py moves it to the JAX layout on disk.
"""

from __future__ import annotations

from typing import Optional

import torch

from qdiffusion_torch.quant.affine import AffineQuantizerSpec

GAMMA, ZETA = -0.1, 1.1

__all__ = ["GAMMA", "ZETA", "adaround_init_alpha", "adaround_soft_targets",
           "adaround_quant"]


def adaround_init_alpha(w: torch.Tensor, delta: torch.Tensor,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """alpha such that h(alpha) == frac(w / delta)
    (adaptive_rounding.py:66-74), stored in `dtype` (default w's).
    bfloat16 storage halves the alpha tree; calibration still optimises
    in f32 (calib/recon.py)."""
    rest = w / delta - torch.floor(w / delta)  # [0, 1)
    alpha = -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1)
    return alpha if dtype is None else alpha.to(dtype)


def adaround_soft_targets(alpha: torch.Tensor) -> torch.Tensor:
    """Rectified sigmoid h(alpha) in [0, 1]."""
    return torch.clamp(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA,
                       0.0, 1.0)


def adaround_quant(w: torch.Tensor, qstate: dict, spec: AffineQuantizerSpec,
                   soft: bool = False) -> torch.Tensor:
    """Fake-quantize weights with learned rounding. qstate: {"delta",
    "zero_point", "alpha"}. soft=True rounds by h(alpha) (calibration);
    soft=False by the hard threshold alpha >= 0 (inference)."""
    delta, zp, alpha = qstate["delta"], qstate["zero_point"], qstate["alpha"]
    w_floor = torch.floor(w / delta)
    if soft:
        w_int = w_floor + adaround_soft_targets(alpha)
    else:
        w_int = w_floor + (alpha >= 0).to(w.dtype)
    w_quant = torch.clamp(w_int + zp, 0, spec.n_levels - 1)
    return (w_quant - zp) * delta
