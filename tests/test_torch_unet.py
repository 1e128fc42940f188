"""Tiny CIFAR UNet, port vs JAX on the same params, qstate and inputs.

The config is the JAX tests' tiny UNet with attention at 8x8, so the
q/k/sm/v quantizers run and the 96-channel concat sites give 3 channels
per group. Every leaf of the param tree (biases and norms included) is
drawn from a numpy seed and handed to both packages. f32 on the CPU.

FP forward: rtol = atol = 1e-4 (only the sum order of convs and
GroupNorm differs; observed ~2e-6). The quantized engines are in
test_torch_unet_quant.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig

from qdiffusion_torch.calib.engine import init_weight_qstate
from qdiffusion_torch.config import QuantFlags
from qdiffusion_torch.convert import from_jax_params
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig
from qdiffusion_torch.ops import groupnorm

torch.set_num_threads(1)

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)


def build_pair(split=False, weight_bit=8, quant_act=False, seed=0):
    """(jax_model, torch_model, numpy params) sharing random params."""
    kw = dict(TINY, split_shortcut=split)
    flags = dict(weight_bit=weight_bit, quant_act=quant_act)
    jm = JaxUNet(JaxConfig(**kw), JaxFlags(**flags).policy_ddim())
    tm = DDIMUNet(DDIMUNetConfig(**kw), QuantFlags(**flags).policy_ddim(),
                  device="cpu")
    rng = np.random.default_rng(seed)
    like = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        like)
    tm.load_state_dict(from_jax_params(params))
    return jm, tm, params


def inputs(seed=1, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.float32)
    return x, t


def run_torch(fn, x, t):
    with torch.no_grad():
        return fn(torch.from_numpy(x), torch.from_numpy(t)).numpy()


def test_state_dict_names_and_registry_match_jax():
    jm, tm, params = build_pair(split=True)
    assert [u.name for u in tm.units] == [u.name for u in jm.units]
    assert [u.kind for u in tm.units] == [u.kind for u in jm.units]
    assert tm.layer_cfgs.keys() == jm.layer_cfgs.keys()
    for name, cfg in jm.layer_cfgs.items():
        assert tm.layer_cfg(name).split == cfg.split, name
    assert set(tm.state_dict()) == set(from_jax_params(params))


def test_fp_forward_matches_jax():
    jm, tm, params = build_pair()
    x, t = inputs()
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                        jnp.asarray(t)))
    got = run_torch(tm, x, t)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_groupnorm_inputs_are_channels_last_slabs(monkeypatch):
    """Every GroupNorm of the forward gets a (B, S, C)-contiguous slab,
    which the card's kernel requires (it raises on any other layout);
    the tiny model has 2 per ResnetBlock, 1 per attention, 1 at the end."""
    _, tm, _ = build_pair(split=True)
    seen = []
    plain = groupnorm.group_norm_plain

    def spy(x, *a, **kw):
        seen.append((tuple(x.shape), x.is_contiguous()))
        return plain(x, *a, **kw)

    monkeypatch.setattr(groupnorm, "group_norm_plain", spy)
    run_torch(tm, *inputs())
    n_resnet = sum(u.kind == "resnet" for u in tm.units)
    n_attn = sum(u.kind == "attn" for u in tm.units)
    assert len(seen) == 2 * n_resnet + n_attn + 1
    assert all(ok for _, ok in seen), seen


def test_bf16_fold_runs_close_to_f32():
    """bf16 carrier (the deployed fold path): finite and within the bf16
    tolerance of the f32 fold (relative L2 error <= 5e-2)."""
    _, tm, _ = build_pair(weight_bit=4)
    q = init_weight_qstate(tm)
    x, t = inputs()
    ref = run_torch(make_quantized_step(tm, q, engine="fold"), x, t)
    step = make_quantized_step(tm, q, engine="fold", dtype=torch.bfloat16)
    with torch.no_grad():
        got = step(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(t)).float().numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 5e-2, rel


def test_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DDIMUNet(DDIMUNetConfig(**TINY))


def test_init_params_seeded():
    tm = DDIMUNet(DDIMUNetConfig(**TINY), device="cpu")
    a, b = tm.init_params(3), tm.init_params(3)
    assert a.keys() == tm.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["norm_out.weight"], torch.ones(32))
    assert not torch.equal(a["conv_in.weight"], tm.init_params(4)[
        "conv_in.weight"])
    assert dataclasses.is_dataclass(tm.cfg)
