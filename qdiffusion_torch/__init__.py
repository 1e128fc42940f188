"""PyTorch/CUDA port of qdiffusion_tpu for one NVIDIA H100 (Hopper).

The JAX package `qdiffusion_tpu` is the reference; every module here keeps
its counterpart's name and is held against it by the `tests/test_torch_*`
parity tests. This package imports neither jax nor qdiffusion_tpu.

Layouts: the public functions (model forward, samplers, pipeline, CLI)
take NHWC like the JAX package. Inside, weights use torch layouts (OIHW
conv, (out, in) linear) and activations run as NCHW tensors in
`torch.channels_last` memory format, so a GroupNorm input is physically a
(B, S, C) slab.
"""

from qdiffusion_torch.device import resolve_device

__all__ = ["resolve_device"]
