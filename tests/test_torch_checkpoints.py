"""The JAX package's npz artifacts read and written by the port: qstate
(including '#bf16' AdaRound alphas), nested npz, and the CLI's
`save_pytree` params. Files on disk hold the JAX layout; both directions
must round-trip bit-exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.quant.adaround import adaround_init_alpha
from qdiffusion_tpu.utils import checkpoints as jax_ckpt

from qdiffusion_torch.calib.engine import init_weight_qstate
from qdiffusion_torch.cli import load_fp_params
from qdiffusion_torch.convert import (
    from_jax_params, qstate_from_jax, qstate_to_jax, to_jax_params)
from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig
from qdiffusion_torch.utils import checkpoints

from test_torch_unet import build_pair

torch.set_num_threads(1)

# weight sites given a bf16 AdaRound alpha: a 3x3 conv, a split 1x1 conv
# (slots w and w0) and a dense layer
ALPHA_SITES = ("down.0.block.0.conv1", "up.1.block.0.nin_shortcut",
               "temb.dense.1")


def _jax_qstate():
    """JAX-layout W4 split qstate with bf16 alphas and an activation
    state, as numpy leaves (bf16 as ml_dtypes arrays)."""
    jm, tm, params = build_pair(split=True, weight_bit=4)
    jq = jax.tree_util.tree_map(np.asarray, jax_init_w(jm, params))
    for site in ALPHA_SITES:
        for slot, st in jq[site].items():
            w = params
            for k in site.split("."):
                w = w[k]
            w = w["w"]
            if slot in ("w", "w0"):
                cfg = jm.layer_cfgs[site]
                if cfg.split:
                    w = w[..., : cfg.split, :] if slot == "w" \
                        else w[..., cfg.split:, :]
                st["alpha"] = np.asarray(adaround_init_alpha(
                    jnp.asarray(w), jnp.asarray(st["delta"]),
                    dtype=jnp.bfloat16))
    jq["conv_in"]["a"] = {k: np.float32(v) for k, v in dict(
        delta=0.03, zero_point=120.0, x_min=-3.5, x_max=4.1).items()}
    return jm, tm, params, jq


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=what)


def test_qstate_jax_file_to_port(tmp_path):
    _, tm, _, jq = _jax_qstate()
    path = tmp_path / "q.npz"
    jax_ckpt.save_qstate(path, jq)
    with np.load(path) as f:
        assert any(k.endswith("#bf16") for k in f.files)
    got = checkpoints.load_qstate(path)
    want = qstate_from_jax(jq)
    assert got.keys() == want.keys()
    for site in want:
        for slot, st in want[site].items():
            for leaf, t in st.items():
                g = got[site][slot][leaf]
                assert g.dtype == t.dtype and g.shape == t.shape
                assert torch.equal(g, t), f"{site}/{slot}/{leaf}"
    alpha = got["up.1.block.0.nin_shortcut"]["w0"]["alpha"]
    assert alpha.dtype == torch.bfloat16 and alpha.ndim == 4
    # the port's own init_weight_qstate agrees with the file
    for site, slots in init_weight_qstate(tm).items():
        for slot, st in slots.items():
            for leaf in ("delta", "zero_point"):
                assert torch.equal(st[leaf], got[site][slot][leaf])


def test_qstate_port_file_to_jax(tmp_path):
    _, _, _, jq = _jax_qstate()
    port_q = qstate_from_jax(jq)
    path = tmp_path / "q.npz"
    checkpoints.save_qstate(path, port_q)
    back = jax_ckpt.load_qstate(path)
    assert back.keys() == jq.keys()
    for site in jq:
        assert back[site].keys() == jq[site].keys()
        for slot, st in jq[site].items():
            assert back[site][slot].keys() == st.keys()
            for leaf, a in st.items():
                _assert_same(back[site][slot][leaf], a,
                             f"{site}/{slot}/{leaf}")
    # and the port reads its own file back unchanged
    again = checkpoints.load_qstate(path)
    for site, slots in port_q.items():
        for slot, st in slots.items():
            for leaf, t in st.items():
                assert torch.equal(again[site][slot][leaf], t)
    # layout functions are inverse to each other
    for site, slots in qstate_to_jax(port_q).items():
        for slot, st in slots.items():
            for leaf, t in st.items():
                _assert_same(_np(t), jq[site][slot][leaf], leaf)


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def test_nested_npz_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                  "c": {"d": np.arange(5, dtype=np.int32)}},
            "e": np.float32(2.5)}
    jax_ckpt.save_nested(tmp_path / "j.npz", tree)
    checkpoints.save_nested(tmp_path / "t.npz", tree)
    for got in (checkpoints.load_nested(tmp_path / "j.npz"),
                jax_ckpt.load_nested(tmp_path / "t.npz")):
        assert got.keys() == tree.keys()
        _assert_same(got["a"]["b"], tree["a"]["b"], "a/b")
        _assert_same(got["a"]["c"]["d"], tree["a"]["c"]["d"], "a/c/d")
        _assert_same(got["e"], tree["e"], "e")


def test_params_from_jax_save_pytree(tmp_path):
    """The JAX CLI's params npz (leaves in jax.tree_util order) read
    through the port's template gives the same state_dict as converting
    the in-memory tree."""
    jm, tm, params = build_pair(seed=3)
    path = tmp_path / "params.npz"
    jax_ckpt.save_pytree(path, params)
    sd = load_fp_params(path, tm)
    want = from_jax_params(params)
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    tm.load_state_dict(sd)
    # and back: the port's state_dict in the JAX layout is the JAX tree
    back = to_jax_params(tm.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for kp, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(flat_back[kp], leaf)


def test_params_shape_mismatch_raises(tmp_path):
    _, _, params = build_pair()
    path = tmp_path / "params.npz"
    jax_ckpt.save_pytree(path, params)
    wider = DDIMUNet(DDIMUNetConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1,
                                    attn_resolutions=(8,), resolution=16),
                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_fp_params(path, wider)
