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


@pytest.mark.parametrize("wrapper", ["B1", "B2", "B3"])
def test_kernel_wrappers_refuse_a_grad_input(wrapper):
    """The kernels have no backward: off the CPU, a wrapper called in grad
    mode on an input that requires grad raises (here on meta tensors, which
    take the kernel branch without a card) instead of returning an output
    with no grad_fn; under torch.no_grad() it goes on to its device check."""
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    x = torch.empty((2, 16, 2, 64), device="meta")
    w = torch.ones(64, device="meta", requires_grad=True)
    q = x.clone().requires_grad_(True)
    call = {"B1": lambda: fused_group_norm(x, w, w),
            "B2": lambda: flash_attention(q, x, x, scale=0.125),
            "B3": lambda: streaming_flash_attention(q, x, x, scale=0.125)
            }[wrapper]
    with pytest.raises(RuntimeError, match="requires grad.*no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="unsupported device"):
        call()


@pytest.mark.parametrize("swish", [False, True])
def test_unfused_group_norm_is_differentiable_and_matches_jax(swish):
    """fused_ok=False (the differentiable forwards of calibration): the
    values of the JAX XLA GroupNorm (variance as jnp.var), and input,
    scale and bias gradients equal to autograd through the plain
    version."""
    x, scale, bias = _inputs((2, 8, 8, 96), seed=3)
    fn = nn.group_norm_swish if swish else nn.group_norm
    jfn = jax_nn.group_norm_swish if swish else jax_nn.group_norm
    grads = []
    for fused_ok in (False, True):
        args = [torch.from_numpy(a).requires_grad_(True)
                for a in (x, scale, bias)]
        y = fn(args[0].permute(0, 3, 1, 2), args[1], args[2],
               fused_ok=fused_ok)
        if not fused_ok:
            ref = jfn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
            np.testing.assert_allclose(
                y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                rtol=2e-5, atol=2e-5)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum() \
            .backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)



# -- B1's launch plan and its split path's reduction -------------------------

# every GroupNorm (B, S, C) of the CIFAR step at batch 64, the SD UNet
# call at batch 8 and the VAE decode at batch 4 (its 256^2 and 512^2
# slabs), and the stream decode at batch 1
PLAN_SHAPES = [(64, 1024, 128), (64, 1024, 256), (64, 256, 256),
               (64, 1024, 384), (64, 256, 384), (64, 64, 512),
               (64, 16, 256), (64, 16, 512), (8, 4096, 320), (8, 4096, 640),
               (8, 1024, 640), (8, 1024, 1280), (8, 256, 1280),
               (8, 64, 2560), (4, 4096, 512), (4, 16384, 512),
               (4, 65536, 256), (4, 65536, 512), (4, 262144, 128),
               (1, 262144, 128)]


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_group_norm_plan_covers_the_slab(shape, elem):
    from qdiffusion_torch.ops.groupnorm import MIN_ROW_BYTES, \
        ONE_PASS_BYTES, group_norm_plan

    b, s, c = shape
    cg = c // 32
    plan = group_norm_plan(b, s, c, 32, elem, sms=132)
    assert plan.grid == (plan.chunks, plan.splits, b)
    # whole groups, every group once, in a power-of-two tile
    assert plan.groups * (plan.chunks - 1) < 32 <= plan.groups * plan.chunks
    assert plan.block_c >= plan.groups * cg
    assert plan.block_c & (plan.block_c - 1) == 0
    assert plan.block_g >= plan.groups and plan.block_s >= 1
    # rows of a program are at least a cache line wide, or the whole row
    assert plan.groups * cg * elem >= min(MIN_ROW_BYTES, c * elem)
    # every row once
    assert plan.rows * (plan.splits - 1) < s <= plan.rows * plan.splits
    if plan.path == "rows":
        assert plan.splits == 1 and s * plan.block_c * elem <= ONE_PASS_BYTES
    else:
        assert plan.splits > 1 and plan.rows % plan.block_s == 0


def test_group_norm_plan_paths():
    from qdiffusion_torch.ops.groupnorm import group_norm_plan

    for b, s, c in PLAN_SHAPES[:8]:  # the CIFAR step: one pass
        assert group_norm_plan(b, s, c, elem=2).path == "rows"
    for b, s, c in [(8, 4096, 320), (4, 262144, 128), (4, 65536, 256),
                    (1, 262144, 128)]:  # larger than L2, or a small batch
        assert group_norm_plan(b, s, c, elem=2).path == "split"
    # whole rows at C = 128 on the decode: one chunk of all 32 groups
    assert group_norm_plan(4, 262144, 128, elem=2).chunks == 1


@pytest.mark.parametrize("shape", [(1, 4096, 96), (2, 2000, 64),
                                   (2, 33, 384)])
def test_split_path_reduction_matches_plain_and_pallas(shape):
    """The split path's arithmetic (per-piece partial sums added in piece
    order), at plans with many pieces, against the plain version and the
    Pallas kernel in interpret mode, f32 to 2e-5."""
    from qdiffusion_torch.ops.groupnorm import group_norm_plan, \
        group_norm_split_model

    b, s, c = shape
    plan = group_norm_plan(b, s, c, elem=4, sms=132)
    if plan.path != "split":  # a small slab: force pieces of 16 rows
        plan = plan._replace(path="split", rows=16, splits=-(-s // 16))
    assert plan.splits > 1
    x, scale, bias = _inputs(shape, seed=3)
    got = group_norm_split_model(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), plan)
    plain = group_norm_plain(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    ref = pallas_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                    interpret=True)
    assert got.dtype == torch.float32 and got.shape == shape
    for want in (plain.numpy(), np.asarray(ref)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
