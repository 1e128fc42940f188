"""Device selection for the port's entry points.

Entry points (CLI, pipeline, model construction) run on the card unless
the caller asks for the CPU; they never fall back to it silently.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for and
    absent.

    Also pins `torch.backends.cudnn.allow_tf32` and
    `torch.backends.cuda.matmul.allow_tf32` to False: float32 convolutions
    and matmuls then run in full float32, as the JAX reference computes
    them. Under TF32 (cuDNN's default for convolutions) the f32 fp/sim
    paths drift by ~1e-3 relative and fake-quant buckets flip.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]
