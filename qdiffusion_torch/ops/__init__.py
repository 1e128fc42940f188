"""Kernels of the port and the layers over them."""

from __future__ import annotations

import torch


def refuse_grad(fn: str, *tensors) -> None:
    """Raise where a kernel without a backward is asked for an output that
    autograd would differentiate: grad mode on and an input (None skipped)
    that requires grad. Its output would have no grad_fn, so every
    gradient upstream of the call would be lost without a word. Callers
    run the kernel under torch.no_grad() or take a differentiable op
    (nn.group_norm(..., fused_ok=False))."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn}: an input requires grad, and the kernel has no backward "
            "(its output would drop the gradient); run it under "
            "torch.no_grad() or use the differentiable PyTorch op")
