"""Port quant core vs the JAX package: fake_quant, 'max' init_scale,
hard AdaRound, EMA update and weight folding. Same numpy inputs through
both; every comparison is bit-exact (the same f32 operations in the same
order) except the EMA update, whose 0.95/0.05 momentum products may
round differently (rtol 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.engine import (
    init_weight_qstate as jax_init_weight_qstate)
from qdiffusion_tpu.deploy import fold_weights as jax_fold_weights
from qdiffusion_tpu.ops.int8 import weight_int_values as jax_weight_int
from qdiffusion_tpu.quant import adaround as jax_adaround
from qdiffusion_tpu.quant import affine as jax_affine

from qdiffusion_torch.convert import from_jax_params, qstate_from_jax
from qdiffusion_torch.deploy import fold_weights, weight_int_values
from qdiffusion_torch.quant import adaround, affine

from test_torch_unet import build_pair

torch.set_num_threads(1)

SPECS = [
    dict(n_bits=8),
    dict(n_bits=4),
    dict(n_bits=8, symmetric=True),
    dict(n_bits=4, scale_method="scale_max"),
    dict(n_bits=8, always_zero=True),
]


def _specs(kw, channel_wise=False):
    return (jax_affine.AffineQuantizerSpec(channel_wise=channel_wise,
                                           channel_axis=-1, **kw),
            affine.AffineQuantizerSpec(channel_wise=channel_wise,
                                       channel_axis=0, **kw))


def _hwio(seed=0, shape=(3, 3, 16, 24)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3 + 0.05).astype(np.float32)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("kw", SPECS)
def test_fake_quant_and_init_scale_bit_exact(kw):
    js, ts = _specs(kw)
    x = np.random.default_rng(1).standard_normal((4, 8, 8, 32)).astype(
        np.float32) * 2.0 + 0.3
    jd, jz = jax_affine.init_scale(jnp.asarray(x), js)
    td, tz = affine.init_scale(torch.from_numpy(x), ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jy = jax_affine.fake_quant(jnp.asarray(x), jd, jz, js)
    ty = affine.fake_quant(torch.from_numpy(x), td, tz, ts)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("kw", SPECS[:3])
def test_channelwise_weight_init_bit_exact(kw):
    """Per-output-channel weight quantizer: HWIO axis -1 in JAX, OIHW
    axis 0 in the port; the states match after the layout transpose."""
    js, ts = _specs(kw, channel_wise=True)
    w = _hwio()
    jst = jax_affine.init_state(jnp.asarray(w), js)
    tst = affine.init_state(_oihw(w), ts)
    conv = qstate_from_jax({"s": {"w": {k: np.asarray(v)
                                        for k, v in jst.items()}}})["s"]["w"]
    for k in jst:
        assert tst[k].shape == conv[k].shape == (24, 1, 1, 1)
        np.testing.assert_array_equal(tst[k].numpy(), conv[k].numpy())
    jy = jax_affine.fake_quant(jnp.asarray(w), jst["delta"],
                               jst["zero_point"], js)
    ty = affine.fake_quant(_oihw(w), tst["delta"], tst["zero_point"], ts)
    np.testing.assert_array_equal(ty.numpy(),
                                  np.asarray(jy).transpose(3, 2, 0, 1))


def test_ema_update_matches():
    js, ts = _specs(dict(n_bits=8, leaf_param=True))
    rng = np.random.default_rng(2)
    x0, x1 = (rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
              for _ in range(2))
    jst = jax_affine.ema_update(jax_affine.init_state(jnp.asarray(x0), js),
                                jnp.asarray(x1), js)
    tst = affine.ema_update(affine.init_state(torch.from_numpy(x0), ts),
                            torch.from_numpy(x1), ts)
    for k in jst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("alpha_dtype", [np.float32, "bfloat16"])
def test_hard_adaround_and_weight_ints_bit_exact(alpha_dtype):
    js, ts = _specs(dict(n_bits=4), channel_wise=True)
    w = _hwio(3)
    jst = dict(jax_affine.init_state(jnp.asarray(w), js))
    alpha = jax_adaround.adaround_init_alpha(
        jnp.asarray(w), jst["delta"],
        dtype=jnp.bfloat16 if alpha_dtype == "bfloat16" else None)
    # flip a third of the rounding decisions
    flip = np.random.default_rng(4).random(w.shape) < 0.33
    jst["alpha"] = jnp.where(jnp.asarray(flip), -alpha, alpha)
    tst = qstate_from_jax({"s": {"w": {k: np.asarray(v)
                                       for k, v in jst.items()}}})["s"]["w"]
    if alpha_dtype == "bfloat16":
        assert tst["alpha"].dtype == torch.bfloat16
    jy = jax_adaround.adaround_quant(jnp.asarray(w), jst, js, soft=False)
    ty = adaround.adaround_quant(_oihw(w), tst, ts)
    np.testing.assert_array_equal(ty.numpy(),
                                  np.asarray(jy).transpose(3, 2, 0, 1))
    ji = jax_weight_int(jnp.asarray(w), jst, js)
    ti = weight_int_values(_oihw(w), tst, ts)
    np.testing.assert_array_equal(ti.numpy(),
                                  np.asarray(ji).transpose(3, 2, 0, 1))


def test_fold_weights_bit_exact_with_split():
    """fold_weights over the tiny UNet with split shortcut and W4: every
    folded weight equals the JAX one after the layout transpose."""
    jm, tm, params = build_pair(split=True, weight_bit=4)
    jq = jax_init_weight_qstate(jm, params)
    jq_np = jax.tree_util.tree_map(np.asarray, jq)
    assert "w0" in jq_np["up.1.block.0.nin_shortcut"]
    folded = fold_weights(tm, qstate_from_jax(jq_np))
    expect = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_fold_weights(jm, params, jq)))
    assert folded.keys() == expect.keys()
    for k in expect:
        np.testing.assert_array_equal(folded[k].numpy(), expect[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("collect", ["init", "ema"])
def test_ctx_collect_modes_match(collect):
    """QuantCtx act_quant under collect=INIT (bit-exact) and collect=EMA
    (momentum products: states to rtol 1e-6, outputs within one delta)."""
    from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
    from qdiffusion_tpu.quant.context import QuantMode as JaxMode

    from qdiffusion_torch.quant.context import QuantCtx, QuantMode

    js, ts = _specs(dict(n_bits=8, leaf_param=True))
    rng = np.random.default_rng(6)
    x0, x1 = (rng.standard_normal((2, 4, 4, 8)).astype(np.float32) * 2
              for _ in range(2))
    jq = {"s": {"a": jax_affine.init_state(jnp.asarray(x0), js)}}
    tq = {"s": {"a": affine.init_state(torch.from_numpy(x0), ts)}}
    if collect == "init":
        jq, tq = {}, {}
    jctx = JaxCtx(jq, mode=JaxMode(w=False, a=True), collect=collect)
    tctx = QuantCtx(tq, mode=QuantMode(w=False, a=True), collect=collect)
    jy = np.asarray(jctx.act_quant("s", "a", jnp.asarray(x1), js))
    ty = tctx.act_quant("s", "a", torch.from_numpy(x1), ts).numpy()
    jst, tst = jctx.collected["s"]["a"], tctx.collected["s"]["a"]
    assert jst.keys() == tst.keys()
    if collect == "init":
        for k in jst:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
        np.testing.assert_array_equal(ty, jy)
    else:
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-6)
        assert np.abs(ty - jy).max() <= float(jst["delta"]) * 1.01
