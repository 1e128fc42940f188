"""Fisher-weighted reconstruction, opt_mode 'fisher_diag' / 'fisher_full'
(port of qdiffusion_tpu/calib/fisher.py; reference gradient capture
qdiff/utils.py:152-183 save_grad_data and :271-308 GetLayerGrad).

A unit's reconstruction loss is weighted by the gradient of
KL(FP output || quantized output) of the whole model with respect to the
unit's output. The reference registers a backward hook; here, as in the
JAX package, the unit's output is an input of the forward
(QuantCtx.substitute) and autograd differentiates the model-output KL
with respect to it. The grads are post-processed as the reference does:
|g| + 1 (utils.py:177).

Per batch, the FP forward and the quantized capture of the unit's output
run under torch.no_grad() (on the card their GroupNorms launch kernel
B1, and the FP forward of an LDM its flash attention B2); the KL forward
is differentiable (plain GroupNorm, materialized attention).
"""

from __future__ import annotations

from typing import Optional

import torch

from qdiffusion_torch.calib.capture import _batch_starts, _forward, \
    _model_call
from qdiffusion_torch.quant.context import QuantCtx, QuantMode

FP = QuantMode()


def _kl_batchmean(out_q: torch.Tensor, out_fp: torch.Tensor) -> torch.Tensor:
    """F.kl_div(log_softmax(out_q), softmax(out_fp), 'batchmean') over the
    channel axis, the last of the model's NHWC output."""
    logq = torch.log_softmax(out_q, dim=-1)
    p = torch.softmax(out_fp, dim=-1)
    logp = torch.log_softmax(out_fp, dim=-1)
    return torch.sum(p * (logp - logq)) / out_q.shape[0]


def save_grad_data(model, qstate: dict, unit_name: str,
                   cali_xs: torch.Tensor, cali_ts: torch.Tensor,
                   cali_cs: Optional[torch.Tensor] = None, *,
                   act_quant: bool = False,
                   batch_size: int = 8) -> torch.Tensor:
    """Fisher grads |dKL/d out| + 1 of `unit_name`'s output over the
    calibration set (whole batches), in the layout of the unit's output
    (JAX fisher.py:42-90). cali_cs: a conditional model's contexts. The
    output is captured with the weights hard-rounded (and the activations
    quantized when act_quant)."""
    model.requires_grad_(False)
    q_mode = QuantMode(w=True, a=act_quant, soft=False)
    grads = []
    for i in _batch_starts(cali_xs.shape[0], batch_size):
        j = i + batch_size
        x, t = cali_xs[i:j], cali_ts[i:j]
        c = None if cali_cs is None else cali_cs[i:j]
        with torch.no_grad():
            out_fp = _model_call(model, x, t, QuantCtx(qstate, mode=FP), c)
            blk_out = _forward(model, qstate, q_mode, (unit_name,), x, t,
                               c)[unit_name][1]
        grads.append(_kl_grad(model, qstate, unit_name, x, t, out_fp,
                              blk_out, c))
    return torch.cat(grads, dim=0)


def _kl_grad(model, qstate: dict, unit_name: str, x: torch.Tensor,
             t: torch.Tensor, out_fp: torch.Tensor, blk_out: torch.Tensor,
             c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|d KL(out_fp || model output) / d blk_out| + 1 for one batch, the
    FP model (with context c) with `unit_name`'s output replaced by
    blk_out."""
    sub = blk_out.detach().requires_grad_(True)
    with torch.enable_grad():
        ctx = QuantCtx(qstate, mode=FP, substitute={unit_name: sub},
                       differentiable=True)
        kl = _kl_batchmean(_model_call(model, x, t, ctx, c), out_fp)
        (g,) = torch.autograd.grad(kl, sub)
    return torch.abs(g) + 1.0


def fisher_rec_loss(pred: torch.Tensor, tgt: torch.Tensor,
                    grad: torch.Tensor, mode: str,
                    axis: int = -1) -> torch.Tensor:
    """The reference LossFunction's Fisher branches
    (block_recon.py:206-212)."""
    if mode == "fisher_diag":
        return torch.mean(torch.sum((pred - tgt) ** 2 * grad ** 2,
                                    dim=axis))
    if mode == "fisher_full":
        a = torch.abs(pred - tgt)
        g = torch.abs(grad)
        dot = torch.sum(a * g, dim=tuple(range(1, pred.ndim))).reshape(
            (-1,) + (1,) * (pred.ndim - 1))
        return torch.mean(dot * a * g) / 100.0
    raise ValueError(mode)
