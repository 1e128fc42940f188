"""GroupNorm (kernel B1's module): the plain version against the JAX
package's XLA GroupNorm (nn.group_norm) and against the Pallas kernel in
interpret mode, at C in {64, 96, 384} (2, 3 and 12 channels per group).
Tolerances as tests/test_pallas_groupnorm.py: 2e-5 in f32, 2e-2 in bf16
(the output's resolution). The kernel itself runs only on the card:
tests/test_torch_card.py and chip_smoke.py compare it with the plain
version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdiffusion_tpu import nn as jax_nn
from qdiffusion_tpu.ops.pallas.groupnorm import fused_group_norm as pallas_gn

from qdiffusion_torch import nn
from qdiffusion_torch.ops.groupnorm import fused_group_norm, group_norm_plain

torch.set_num_threads(1)

SHAPES = [(2, 8, 8, 64), (2, 4, 4, 96), (2, 4, 4, 384), (3, 64, 384)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("swish", [False, True])
def test_plain_matches_jax_f32(shape, swish):
    x, scale, bias = _inputs(shape)
    jx = jnp.asarray(x)
    ref_xla = jax_nn.group_norm(jx, jnp.asarray(scale), jnp.asarray(bias))
    if swish:
        ref_xla = jax_nn.swish(ref_xla)
    ref_pallas = pallas_gn(jx, jnp.asarray(scale), jnp.asarray(bias),
                           swish=swish, interpret=True)
    got = fused_group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), swish=swish)
    assert got.dtype == torch.float32 and got.shape == shape
    for ref in (ref_xla, ref_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_matches_jax_bf16(shape):
    x, scale, bias = _inputs(shape, seed=1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = pallas_gn(jx, jnp.asarray(scale), jnp.asarray(bias),
                    interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = fused_group_norm(tx, torch.from_numpy(scale).to(torch.bfloat16),
                           torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_nchw_channels_last_wrapper_and_counter():
    """nn.group_norm takes NCHW channels_last and keeps that layout; the
    CPU path is the plain version and counts no kernel launch."""
    x, scale, bias = _inputs((2, 8, 8, 96), seed=2)
    x_cl = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert x_cl.is_contiguous(memory_format=torch.channels_last)
    before = fused_group_norm.launches
    y = nn.group_norm(x_cl, torch.from_numpy(scale), torch.from_numpy(bias))
    assert fused_group_norm.launches == before
    assert y.shape == (2, 96, 8, 8)
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref = group_norm_plain(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), ref.numpy())


def test_non_cuda_device_other_than_cpu_raises():
    """Only CPU tensors take the plain version; any other device must
    launch the kernel or raise (here: a meta tensor)."""
    x = torch.empty((2, 4, 4, 64), device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_group_norm(x, w, w)

