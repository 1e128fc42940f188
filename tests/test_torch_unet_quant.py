"""Tiny CIFAR UNet under the quantized engines, port vs JAX on the same
params, qstate and inputs (helpers and config in test_torch_unet.py).

  * fold-W4 with split shortcut: rtol = atol = 1e-4 (observed ~2e-6).
  * sim W8A8: f32 noise flips fake-quant buckets, and each flip moves the
    next layer's input. The test holds every activation quantizer to
    |q_port - q_jax| <= |x_port - x_jax| + delta (at most one bucket
    beyond the input drift), prints how many flips it saw, and bounds
    the eps error at 0.15 absolute for |eps| ~ 1.8 (observed 0.05).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.engine import init_act_qstate as jax_init_act
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.deploy import make_quantized_step as jax_step
from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
from qdiffusion_tpu.quant.context import QuantMode as JaxMode

from qdiffusion_torch.calib.engine import init_act_qstate, init_weight_qstate
from qdiffusion_torch.convert import qstate_from_jax
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.quant.context import QuantCtx, QuantMode

from test_torch_unet import build_pair, inputs, run_torch

torch.set_num_threads(1)


def test_fold_w4_split_matches_jax():
    jm, tm, params = build_pair(split=True, weight_bit=4)
    jq = jax_init_w(jm, params)
    tq = init_weight_qstate(tm)
    # the port's own weight qstate equals the JAX one after the layout move
    jq_t = qstate_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    for site, slots in jq_t.items():
        for slot, st in slots.items():
            for leaf, a in st.items():
                np.testing.assert_array_equal(tq[site][slot][leaf].numpy(),
                                              a.numpy())
    x, t = inputs()
    want = np.asarray(jax_step(jm, params, jq, engine="fold")(
        jnp.asarray(x), jnp.asarray(t)))
    got = run_torch(make_quantized_step(tm, tq, engine="fold"), x, t)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class _JaxRecorder(JaxCtx):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rec = []

    def act_quant(self, name, slot, x, spec):
        y = super().act_quant(name, slot, x, spec)
        self.rec.append((name, slot, np.asarray(x), np.asarray(y)))
        return y


class _TorchRecorder(QuantCtx):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rec = []

    def act_quant(self, name, slot, x, spec):
        y = super().act_quant(name, slot, x, spec)
        to_np = (lambda a: a.permute(0, 2, 3, 1).numpy()) if x.ndim == 4 \
            else (lambda a: a.numpy())
        self.rec.append((name, slot, to_np(x), to_np(y)))
        return y


def test_sim_w8a8_bucket_flips_bounded():
    jm, tm, params = build_pair(split=True, weight_bit=8, quant_act=True)
    x, t = inputs()
    jq = jax_init_act(jm, params, jax_init_w(jm, params), jnp.asarray(x),
                      jnp.asarray(t))
    jq = jax.tree_util.tree_map(np.asarray, jq)
    tq = qstate_from_jax(jq)

    jctx = _JaxRecorder(jq, mode=JaxMode(w=True, a=True))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jctx))
    tctx = _TorchRecorder(tq, mode=QuantMode(w=True, a=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), tctx).numpy()

    assert len(tctx.rec) == len(jctx.rec) > 0
    flips = total = 0
    for (n, s, xj, qj), (n2, s2, xt, qt) in zip(jctx.rec, tctx.rec):
        assert (n, s) == (n2, s2)
        delta = float(jq[n][s]["delta"])
        bound = np.abs(xt - xj) + delta * (1 + 1e-5)
        assert np.all(np.abs(qt - qj) <= bound), f"{n}/{s}"
        flips += int((np.abs(qt - qj) > delta / 2).sum())
        total += qj.size
    print(f"sim W8A8: {flips} fake-quant bucket flips in {total} quantized "
          f"activations over {len(jctx.rec)} sites")
    # temb.dense.1's input agrees exactly, so its quantized values do
    assert np.array_equal(tctx.rec[1][3], jctx.rec[1][3])
    np.testing.assert_allclose(got, want, rtol=0, atol=0.15)


def test_init_act_qstate_matches_jax_before_first_flip():
    """init_act_qstate: sites upstream of any bucket flip get the JAX
    states to f32 noise; downstream they differ by the flip cascade."""
    jm, tm, params = build_pair(weight_bit=8, quant_act=True)
    x, t = inputs()
    jq = jax.tree_util.tree_map(np.asarray, jax_init_act(
        jm, params, jax_init_w(jm, params), jnp.asarray(x), jnp.asarray(t)))
    tq = init_act_qstate(tm, init_weight_qstate(tm), torch.from_numpy(x),
                         torch.from_numpy(t))
    for site in ("temb.dense.0", "temb.dense.1", "conv_in",
                 "down.0.block.0.conv1", "down.0.block.0.temb_proj"):
        for leaf, a in jq[site]["a"].items():
            np.testing.assert_allclose(tq[site]["a"][leaf].numpy(), a,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{site}/{leaf}")
    assert tq.keys() == jq.keys()
    for site in jq:
        assert tq[site].keys() == jq[site].keys(), site
