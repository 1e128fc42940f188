"""Quantized-checkpoint export / load of the port against the JAX
package's (`qdiffusion_tpu/deploy.py::export_quantized_checkpoint`,
`load_quantized_checkpoint`).

The same numpy params and JAX-layout qstate go to both packages (the
tiny pixel UNet with attention at 8x8, split shortcuts): W4 asymmetric
with AdaRound alphas (the nibble route), W8 symmetric (the int8 route
with its shift by n_levels + 1) and W4 symmetric without alphas.

Tolerances: the two files hold the same keys, the same integers, scales
and fp16 leaves exactly and the same manifest; each package loads the
other's file to the same values exactly. The port's reloaded quantized
weights equal its `fold_weights` bit for bit, and a forward of the
reloaded model is within rtol = atol = 2e-3 of the fold engine's (the
JAX test's tolerance: the biases and norms come back from fp16). A W4
file is under a quarter of the f32 params' bytes (the JAX bound).
"""

import json

import numpy as np
import pytest
import torch

import jax

from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_wq
from qdiffusion_tpu.deploy import (
    export_quantized_checkpoint as jax_export,
    load_quantized_checkpoint as jax_load,
)
from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig
from qdiffusion_tpu.models.unet_ddim import QuantPolicy as JaxPolicy
from qdiffusion_tpu.quant.affine import AffineQuantizerSpec as JaxSpec

from qdiffusion_torch.convert import from_jax_params, qstate_from_jax
from qdiffusion_torch.deploy import (
    export_quantized_checkpoint,
    fold_weights,
    load_quantized_checkpoint,
    make_quantized_step,
)
from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig
from qdiffusion_torch.models.unet_ddim import QuantPolicy
from qdiffusion_torch.quant.affine import AffineQuantizerSpec

torch.set_num_threads(1)

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16, split_shortcut=True)
CASES = {"w4_alpha": (4, False, True), "w8_sym": (8, True, False),
         "w4_sym": (4, True, False)}


def _pair(bits, sym, alpha, seed=0):
    """(jax model, port model, numpy params, JAX-layout numpy qstate)."""
    jm = JaxUNet(JaxConfig(**TINY), JaxPolicy(wq=JaxSpec(
        n_bits=bits, symmetric=sym, channel_wise=True, channel_axis=-1,
        scale_method="max")))
    tm = DDIMUNet(DDIMUNetConfig(**TINY), QuantPolicy(wq=AffineQuantizerSpec(
        n_bits=bits, symmetric=sym, channel_wise=True, channel_axis=0,
        scale_method="max")), device="cpu")
    rng = np.random.default_rng(seed)
    like = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        like)
    tm.load_state_dict(from_jax_params(params))
    qstate = jax.tree_util.tree_map(np.asarray, jax_init_wq(jm, params))
    if alpha:  # AdaRound states: hard rounding up where alpha >= 0
        for name, lstate in qstate.items():
            w = _jax_weight(params, name)
            slots = [("w", w)]
            if "w0" in lstate:
                cfg = jm.layer_cfg(name)
                idx = [slice(None)] * w.ndim
                idx[cfg.in_axis] = slice(None, cfg.split)
                wa = w[tuple(idx)]
                idx[cfg.in_axis] = slice(cfg.split, None)
                slots = [("w", wa), ("w0", w[tuple(idx)])]
            for slot, ww in slots:
                lstate[slot]["alpha"] = rng.standard_normal(
                    ww.shape).astype(np.float32)
    return jm, tm, params, qstate


def _jax_weight(params, name):
    node = params
    for part in name.split("."):
        node = node[part]
    return node["w"]


_FILES: dict = {}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """case -> (port model, JAX-layout qstate, (JAX file, its manifest),
    (the port's file, its manifest)), each case exported once."""
    def get(case):
        if case not in _FILES:
            jm, tm, params, q = _pair(*CASES[case])
            d = tmp_path_factory.mktemp(case)
            jpath, tpath = d / "jax.npz", d / "torch.npz"
            jman = jax_export(jm, params, q, jpath)
            tman = export_quantized_checkpoint(tm, qstate_from_jax(q), tpath)
            _FILES[case] = tm, q, (jpath, jman), (tpath, tman)
        return _FILES[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_matches_jax_file(files, case):
    *_, (jpath, jman), (tpath, tman) = files(case)
    assert json.loads(json.dumps(tman)) == jman
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(t.files) == sorted(j.files)
        assert json.loads(bytes(t["__manifest__"]).decode()) == jman
        for key in set(j.files) - {"__manifest__"}:  # JSON key order aside
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    bits = CASES[case][0]
    suffix = "/int4" if bits <= 4 else "/int8"
    assert any(k.endswith(suffix) for k in np.load(tpath).files)
    assert any(v["split"] for v in tman.values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_loads_the_others_file(files, case):
    *_, (jpath, _), (tpath, _) = files(case)
    j_own, j_man = jax_load(jpath)
    sd_from_jax, t_man = load_quantized_checkpoint(jpath)
    assert t_man == j_man
    j_from_torch, _ = jax_load(tpath)
    want = from_jax_params(j_own)
    assert set(sd_from_jax) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(sd_from_jax[k], v, rtol=0, atol=0,
                                   msg=k)
    back = from_jax_params(j_from_torch)
    sd_own, _ = load_quantized_checkpoint(tpath)
    for k, v in back.items():
        torch.testing.assert_close(sd_own[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reload_equals_fold_and_forward(files, case):
    tm, q, _, (tpath, man) = files(case)
    qt = qstate_from_jax(q)
    sd, _ = load_quantized_checkpoint(tpath)
    folded = fold_weights(tm, qt)
    for name in man:
        key = f"{name}.weight"
        assert sd[key].dtype == torch.float32
        assert torch.equal(sd[key], folded[key]), key
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    t = torch.tensor([100.0, 700.0])
    want = make_quantized_step(tm, qt, "fold")(x, t)
    reloaded = DDIMUNet(tm.cfg, tm.policy, device="cpu")
    reloaded.load_state_dict(sd)
    with torch.no_grad():
        got = reloaded(x, t)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_w4_checkpoint_is_small(files):
    tm, _, _, (tpath, _) = files("w4_alpha")
    fp32_bytes = 4 * sum(p.numel() for p in tm.state_dict().values())
    assert tpath.stat().st_size < fp32_bytes / 4
