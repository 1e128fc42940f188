"""AdaRound rounding at inference (port of the hard-rounding path of
qdiffusion_tpu/quant/adaround.py; reference
qdiff/adaptive_rounding.py:9-78).

A calibrated weight qstate carries `alpha`, weight-shaped (OIHW / (out,
in) here): the weight rounds up where alpha >= 0 and down elsewhere. The
clamp uses the affine spec's asymmetric level count
(adaptive_rounding.py:58). Soft rounding is for calibration, which is
not ported yet.
"""

from __future__ import annotations

import torch

from qdiffusion_torch.quant.affine import AffineQuantizerSpec

__all__ = ["adaround_quant"]


def adaround_quant(w: torch.Tensor, qstate: dict,
                   spec: AffineQuantizerSpec) -> torch.Tensor:
    """Fake-quantize weights with the learned hard rounding.
    qstate: {"delta", "zero_point", "alpha"}."""
    delta, zp, alpha = qstate["delta"], qstate["zero_point"], qstate["alpha"]
    w_int = torch.floor(w / delta) + (alpha >= 0).to(w.dtype)
    w_quant = torch.clamp(w_int + zp, 0, spec.n_levels - 1)
    return (w_quant - zp) * delta
