"""Tiny LDM UNets of the port against the JAX package, on the CPU.

SD_TINY (spatial transformer, cross-attention context), BEDS_TINY
(legacy multi-head AttentionBlock, num_head_channels) and CHURCH_TINY
(AttentionBlock with num_heads, scale-shift norm, resblock up/down), the
configs of tests/test_unet_ldm.py.
Every leaf of the param tree is drawn from a numpy seed (so nothing is
zero-initialised and every branch reaches eps) and handed to both
packages. Both sides run with flash_threshold=16, so the 64-token
self-attentions take the blockwise path: the JAX two-pass loop on its
CPU, the port's B2 plain version (the function its kernel computes).
The 7-token cross-attention stays materializing on both.

Tolerances (f32):
  * FP forward and fold W4: rtol = atol = 1e-4 (sum order only).
  * sim W8A8: f32 noise flips fake-quant buckets (256 levels) and each
    flip moves the next layer's input; eps may differ by 0.15 absolute at
    |eps| ~ 3 and by 5e-2 in relative L2 (observed 0.1 and 3e-2).
    tests/test_torch_unet_quant.py holds each quantizer site of the
    pixel UNet to one bucket beyond its input's drift. SD runs the 'mse'
    activation init of its policy, beds and church the 'max' one
    (--a-min-max, the LSUN calibration's init),
    which keeps the JAX compile of the init short.
  * the port's own 'mse' weight qstate equals the JAX one on at least
    99 % of the channels (the 80-candidate search can pick another
    candidate where two scores tie to f32 noise).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.engine import init_act_qstate as jax_init_act
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.models.unet_ldm import LDMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ldm import LDMUNetConfig as JaxConfig
from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
from qdiffusion_tpu.quant.context import QuantMode as JaxMode

from qdiffusion_torch.calib.engine import init_weight_qstate
from qdiffusion_torch.config import QuantFlags
from qdiffusion_torch.convert import from_jax_params, qstate_from_jax
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.models.unet_ldm import LDMUNet, LDMUNetConfig
from qdiffusion_torch.ops import flash_attention

torch.set_num_threads(1)

SD_TINY = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=32,
    num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
    num_heads=4, use_spatial_transformer=True, transformer_depth=1,
    context_dim=24)
BEDS_TINY = dict(
    image_size=16, in_channels=3, out_channels=3, model_channels=32,
    num_res_blocks=1, attention_resolutions=(4, 2), channel_mult=(1, 2),
    num_head_channels=16, use_spatial_transformer=False)
CHURCH_TINY = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=32,
    num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
    num_heads=4, use_scale_shift_norm=True, resblock_updown=True)
CONFIGS = {"sd": SD_TINY, "beds": BEDS_TINY, "church": CHURCH_TINY}


def random_tree(like, seed):
    """numpy leaves for a JAX param tree of shapes: weights N(0, 1/fan_in)
    (JAX layouts keep the output axis last), norm scales 1 + 0.1 N, every
    other 1-D leaf 0.1 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            fan = math.prod(s.shape[:-1])
            return (rng.standard_normal(s.shape) / math.sqrt(fan)).astype(
                np.float32)
        base = 1.0 if key.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, like)


def build_pair(name, seed=0, **flags):
    cfg = CONFIGS[name]
    jf, tf = (JaxFlags(**flags), QuantFlags(**flags)) if flags else (None,
                                                                    None)
    jm = JaxUNet(JaxConfig(**cfg), jf.policy_ldm() if jf else None,
                 flash_threshold=16)
    tm = LDMUNet(LDMUNetConfig(**cfg), tf.policy_ldm() if tf else None,
                 flash_threshold=16, device="cpu")
    params = random_tree(jax.eval_shape(jm.init_params,
                                        jax.random.PRNGKey(0)), seed)
    tm.load_state_dict(from_jax_params(params))
    return jm, tm, params


def inputs(name, seed=1, n=2):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16, 16, cfg["in_channels"])).astype(
        np.float32)
    t = np.array([5.0, 700.0][:n], np.float32)
    c = rng.standard_normal((n, 7, 24)).astype(np.float32) \
        if name == "sd" else None
    return x, t, c


def _jax_args(x, t, c):
    return (jnp.asarray(x), jnp.asarray(t)), (
        {"context": jnp.asarray(c)} if c is not None else {})


def _jax_apply(jm, params, x, t, c, qstate=None):
    """The JAX forward, jitted (eager dispatch of the tiny UNet is slower
    than its compile); with a qstate, the sim engine (w and a on)."""
    def run(p, q, x, t, c):
        ctx = JaxCtx(q, mode=JaxMode(w=True, a=True)) if q is not None \
            else None
        return jm.apply(p, x, t, ctx, context=c)

    (xj, tj), kw = _jax_args(x, t, c)
    return np.asarray(jax.jit(run)(params, qstate, xj, tj,
                                   kw.get("context")))


def _torch(fn, x, t, c):
    with torch.no_grad():
        args = [torch.from_numpy(x), torch.from_numpy(t)]
        if c is not None:
            args.append(torch.from_numpy(c))
        return fn(*args).numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_registry_and_state_dict_match_jax(name):
    jm, tm, params = build_pair(name)
    assert [u.name for u in tm.units] == [u.name for u in jm.units]
    assert [u.kind for u in tm.units] == [u.kind for u in jm.units]
    assert list(tm.layer_cfgs) == list(jm.layer_cfgs)
    assert set(tm.state_dict()) == set(from_jax_params(params))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fp_forward_matches_jax(name):
    jm, tm, params = build_pair(name)
    x, t, c = inputs(name)
    want = _jax_apply(jm, params, x, t, c)
    n = flash_attention.flash_attention.launches
    got = _torch(lambda *a: tm(a[0], a[1], None, *a[2:]), x, t, c)
    assert flash_attention.flash_attention.launches == n  # CPU: plain
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_blockwise_gate_reaches_the_flash_path(monkeypatch):
    """SD_TINY at threshold 16: the four 64-token self-attentions (one at
    input level 1, the middle block's, two at output level 1) take the
    flash path; no 7-token cross-attention does."""
    _, tm, _ = build_pair("sd")
    seen = []
    real = flash_attention.flash_attention_plain

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(flash_attention, "flash_attention_plain", spy)
    _torch(lambda *a: tm(a[0], a[1], None, *a[2:]), *inputs("sd"))
    assert seen == [(64, 64)] * 4


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fold_w4_matches_jax(name):
    jm, tm, params = build_pair(name, weight_bit=4)
    jq = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jax_init_w(jm, p))(params))
    tq_own = init_weight_qstate(tm)
    tq = qstate_from_jax(jq)
    same = total = 0
    for site, slots in tq.items():
        for slot, st in slots.items():
            eq = torch.isclose(tq_own[site][slot]["delta"], st["delta"],
                               rtol=1e-5, atol=0)
            same += int(eq.sum())
            total += eq.numel()
    assert same >= 0.99 * total, (same, total)

    x, t, c = inputs(name)
    folded = jax.jit(lambda p, q: jax_fold(jm, p, q))(params, jq)
    want = _jax_apply(jm, folded, x, t, c)
    step = make_quantized_step(tm, tq, engine="fold")
    got = _torch(step, x, t, c)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _sim_pair(name):
    jm, tm, params = build_pair(name, weight_bit=8, quant_act=True,
                                a_min_max=name != "sd")
    x, t, c = inputs(name)
    a, kw = _jax_args(x, t, c)
    jq = jax.jit(lambda p: jax_init_w(jm, p))(params)
    jq = jax.tree_util.tree_map(np.asarray, jax_init_act(
        jm, params, jq, *a, kw.get("context")))
    return jm, tm, params, jq, (x, t, c)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sim_w8a8_matches_jax(name):
    jm, tm, params, jq, (x, t, c) = _sim_pair(name)
    tq = qstate_from_jax(jq)
    attn = [s for s in tq if "sm" in tq[s]]
    assert len(attn) == {"sd": 8, "beds": 4, "church": 4}[name]
    assert all({"q", "k", "v", "sm"} <= set(tq[s]) for s in attn)
    want = _jax_apply(jm, params, x, t, c, jq)
    n = flash_attention.flash_attention.launches
    got = _torch(make_quantized_step(tm, tq, engine="sim"), x, t, c)
    assert flash_attention.flash_attention.launches == n
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"sim W8A8 {name}: max abs {np.abs(got - want).max():.3g}, "
          f"rel L2 {rel:.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=0.15)
    assert rel <= 5e-2


def test_bf16_fold_runs_close_to_f32():
    """bf16 carrier with the f32 context of the deployed CLI: finite and
    within 5e-2 relative L2 of the f32 fold step."""
    _, tm, _ = build_pair("sd", weight_bit=4)
    q = init_weight_qstate(tm)
    x, t, c = inputs("sd")
    ref = _torch(make_quantized_step(tm, q, engine="fold"), x, t, c)
    step = make_quantized_step(tm, q, engine="fold", dtype=torch.bfloat16)
    with torch.no_grad():
        got = step(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(t), torch.from_numpy(c)).float().numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 5e-2
