"""The AdaRound weight pass of the port against the JAX package, on the
tiny CIFAR UNet of the JAX calibration tests (ch=32, ch_mult=(1, 2), one
ResnetBlock a level, attention at 8x8, 16x16 inputs) with the split
shortcut, W4, f32 on the CPU. The params are numpy draws handed to both
packages (test_torch_unet.build_pair).

Tolerances:
  * soft and hard rounding, alpha init, temp_decay: elementwise, 1e-6;
  * DDIM trajectory and calibration samples (with per-step contexts
    also the conditional rows): 1e-5 (the FP forwards differ in sum order
    only, ~2e-6);
  * captured unit inputs and outputs (FP, asym, grouped): 1e-4 of the
    largest magnitude, after the NHWC -> NCHW move;
  * reconstruct_unit, with JAX's minibatch indices in place of the
    port's: after 32 iterations the alphas within 1e-4 of the largest
    |alpha|, and the hard roundings (alpha >= 0) equal on at least 99.9 %
    of the weights;
  * whole calibration: the port's qstate loads in JAX, and the JAX fold
    engine samples with it within 5e-2 relative L2 of the port's fold
    samples; each unit's hard-rounded block error after reconstruction is
    at most 1.02x its nearest-rounding error on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.capture import GroupedCapture as JaxGrouped
from qdiffusion_tpu.calib.capture import capture_unit_io as jax_capture
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.calib.recon import ReconConfig as JaxReconConfig
from qdiffusion_tpu.calib.recon import reconstruct_unit as jax_reconstruct
from qdiffusion_tpu.calib.recon import temp_decay as jax_temp_decay
from qdiffusion_tpu.calib.samples import get_train_samples as jax_samples
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.quant import adaround as jax_ada
from qdiffusion_tpu.quant.affine import AffineQuantizerSpec as JaxSpec
from qdiffusion_tpu.samplers.ddim import ddim_sample as jax_ddim
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate

from qdiffusion_torch.calib import engine, recon
from qdiffusion_torch.calib.capture import GroupedCapture, capture_unit_io
from qdiffusion_torch.calib.engine import CalibConfig, calibrate, \
    init_weight_qstate
from qdiffusion_torch.calib.recon import ReconConfig, reconstruct_unit, \
    temp_decay
from qdiffusion_torch.calib.samples import get_train_samples
from qdiffusion_torch.convert import qstate_from_jax
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.ops.qlayers import split_weight
from qdiffusion_torch.quant import adaround
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.samplers.ddim import ddim_sample
from qdiffusion_torch.schedules import get_beta_schedule, make_skip_sequence
from qdiffusion_torch.utils.checkpoints import save_qstate

from test_torch_unet import build_pair

torch.set_num_threads(1)

ITERS = 32
BS = 8  # reconstruction minibatch and capture batch


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _nchw(a):
    """A JAX capture (NHWC or (B, C)) in the port's layout."""
    a = np.asarray(a)
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).contiguous(
        memory_format=torch.channels_last) if a.ndim == 4 \
        else torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, rel=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if want.ndim == 4:
        want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    """(jax model, torch model, params, both qstates, the calibration
    set in both layouts: 16 seeded samples at spread timesteps)."""
    jm, tm, params = build_pair(split=True, weight_bit=4)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    ts = np.linspace(0, 999, 16).astype(np.float32)
    return dict(jm=jm, tm=tm, params=params, jq=jax_init_w(jm, params),
                tq=init_weight_qstate(tm), xs=xs, ts=ts)


# -- soft rounding ------------------------------------------------------------

def test_adaround_soft_hard_and_temp_decay_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    delta = (np.abs(w).max(axis=(1, 2, 3), keepdims=True) / 7.5).astype(
        np.float32)
    zp = np.round(-w.min(axis=(1, 2, 3), keepdims=True) / delta).astype(
        np.float32)
    alpha = adaround.adaround_init_alpha(_t(w), _t(delta))
    want = jax_ada.adaround_init_alpha(jnp.asarray(w), jnp.asarray(delta))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert adaround.adaround_init_alpha(
        _t(w), _t(delta), dtype=torch.bfloat16).dtype == torch.bfloat16
    trained = alpha + _t(rng.standard_normal(w.shape).astype(np.float32))
    spec = AffineQuantizerSpec(n_bits=4, channel_wise=True)
    jspec = JaxSpec(n_bits=4, channel_wise=True, channel_axis=0)
    st = {"delta": _t(delta), "zero_point": _t(zp), "alpha": trained}
    jst = {"delta": jnp.asarray(delta), "zero_point": jnp.asarray(zp),
           "alpha": jnp.asarray(trained.numpy())}
    for soft in (True, False):
        np.testing.assert_allclose(
            adaround.adaround_quant(_t(w), st, spec, soft=soft).numpy(),
            np.asarray(jax_ada.adaround_quant(jnp.asarray(w), jst, jspec,
                                              soft)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        adaround.adaround_soft_targets(trained).numpy(),
        np.asarray(jax_ada.adaround_soft_targets(jst["alpha"])), atol=1e-6)
    t = np.arange(1, 101, dtype=np.float32)
    np.testing.assert_allclose(
        temp_decay(_t(t), 100, 0.2, 20.0, 2.0).numpy(),
        np.asarray(jax_temp_decay(jnp.asarray(t), 100, 0.2, 20.0, 2.0)),
        rtol=1e-6)


# -- calibration data --------------------------------------------------------

def test_trajectory_and_train_samples_match_jax(tiny):
    jm, tm, params = tiny["jm"], tiny["tm"], tiny["params"]
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = make_skip_sequence(100, 8, "uniform")
    x0 = np.random.default_rng(3).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        x, traj = ddim_sample(lambda x, t: tm(x, t), _t(x0), seq, betas,
                              return_trajectory=True)
    jx, jtraj = jax_ddim(jax.jit(lambda x, t: jm.apply(params, x, t)),
                         jnp.asarray(x0), seq,
                         np.asarray(betas), return_trajectory=True)
    assert traj["xs"].shape == (len(seq), 4, 16, 16, 3)
    for got, want in ((x, jx), (traj["xs"], jtraj["xs"]),
                      (traj["ts"], jtraj["ts"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for st in (1, 4):
        got = get_train_samples(traj, cali_n=3, cali_st=st)
        want = jax_samples(jtraj, cali_n=3, cali_st=st)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
    # the conditional branch on per-step contexts: the cond rows, then
    # the same samples with the uncond rows (JAX samples.py:38-44)
    rng = np.random.default_rng(9)
    ctx = {k: rng.standard_normal((len(seq), 4, 5, 6)).astype(np.float32)
           for k in ("cs", "ucs")}
    got = get_train_samples({**traj, **{k: _t(v) for k, v in ctx.items()}},
                            cali_n=3, cali_st=4, cond=True)
    want = jax_samples({**jtraj, **{k: jnp.asarray(v)
                                     for k, v in ctx.items()}},
                       cali_n=3, cali_st=4, cond=True)
    assert len(got) == len(want) == 3 and got[2].shape == (30, 5, 6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# -- captures ----------------------------------------------------------------

CAPTURED = ("mid.block_1", "down.0.downsample.conv", "up.0.block.0")


@pytest.mark.parametrize("name", CAPTURED)
def test_capture_unit_io_matches_jax(tiny, name):
    """FP and asym (weight-quantized prefix) captures of a resnet, the
    pre-padded stride-2 conv and a split up block (input (h, skip))."""
    for asym in (False, True):
        inps, out = capture_unit_io(tiny["tm"], tiny["tq"], name,
                                    _t(tiny["xs"]), _t(tiny["ts"]),
                                    asym=asym, batch_size=BS)
        jinps, jout = jax_capture(tiny["jm"], tiny["params"], tiny["jq"],
                                  name, jnp.asarray(tiny["xs"]),
                                  jnp.asarray(tiny["ts"]), asym=asym,
                                  batch_size=BS)
        assert len(inps) == len(jinps)
        for a, b in zip(inps, jinps):
            _close(a, b)
        _close(out, jout)
    if name == "down.0.downsample.conv":
        assert inps[0].shape[2:] == (17, 17)  # the padded input


def test_grouped_fp_capture_matches_jax(tiny):
    gc = GroupedCapture(tiny["tm"], batch_size=BS)
    got = gc.fp_capture(CAPTURED, _t(tiny["xs"]), _t(tiny["ts"]))
    jgc = JaxGrouped(tiny["jm"], batch_size=BS)
    want = jgc.fp_capture(tiny["params"], CAPTURED, jnp.asarray(tiny["xs"]),
                          jnp.asarray(tiny["ts"]))
    for name in CAPTURED:
        for a, b in zip(got[name][0], want[name][0]):
            _close(a, b)
        _close(got[name][1], want[name][1])
    # a cap that fits one unit a group puts each unit alone
    assert gc.plan(CAPTURED, _t(tiny["xs"]), _t(tiny["ts"])) == [CAPTURED]
    gc.group_bytes = 1
    assert gc.plan(CAPTURED, _t(tiny["xs"]), _t(tiny["ts"])) == [
        (n,) for n in CAPTURED]


# -- reconstruction -----------------------------------------------------------

# The resnet and split up block are level-1 blocks (64 channels): at level 0
# each of the 32 GroupNorm groups holds one channel, so norm2 removes the
# temb_proj output entirely, its alphas' gradient is rounding noise, and
# Adam scales that noise to full steps (both packages, differently).
RECON_UNITS = ("temb.dense.1", "conv_in", "mid.block_1", "down.1.attn.0",
               "up.1.block.0")


@pytest.mark.parametrize("name", RECON_UNITS)
def test_reconstruct_unit_matches_jax_with_its_indices(tiny, name,
                                                       monkeypatch):
    """One unit of each kind (dense, conv, resnet, attention, split up
    block) on the same asym captures, with the minibatches JAX draws
    (jax.random.randint(fold_in(key, i), (bs,), 0, n), recon.py:382-383)
    put in place of the port's."""
    jm, tm = tiny["jm"], tiny["tm"]
    unit = next(u for u in tm.units if u.name == name)
    junit = next(u for u in jm.units if u.name == name)
    jinps, jout = jax_capture(jm, tiny["params"], tiny["jq"], name,
                              jnp.asarray(tiny["xs"]),
                              jnp.asarray(tiny["ts"]), asym=True,
                              batch_size=BS)
    key = jax.random.PRNGKey(7)
    n = jout.shape[0]
    idx = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (BS,), 0, n)) for i in range(ITERS)])
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n_, bs, gen: _t(idx[i]))
    cfg = ReconConfig(iters=ITERS, batch_size=BS)
    q = reconstruct_unit(tm, tiny["tq"], unit,
                         tuple(_nchw(a) for a in jinps), _nchw(jout), cfg)
    jq = jax_reconstruct(jm, tiny["params"], tiny["jq"], junit, jinps, jout,
                         JaxReconConfig(iters=ITERS, batch_size=BS),
                         rng=key)
    jq = qstate_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    n_w = n_flip = 0
    worst = 0.0
    for site in unit.layer_names:
        for slot, st in jq[site].items():
            got, want = q[site][slot]["alpha"], st["alpha"]
            assert got.shape == want.shape and got.dtype == torch.float32
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-4, (site, slot, err)
            worst = max(worst, err)
            n_w += want.numel()
            n_flip += int(((got >= 0) != (want >= 0)).sum())
    print(f"{name}: alphas within {worst:.2e} of the largest, {n_flip} "
          f"of {n_w} hard roundings differ")
    assert n_flip <= 1e-3 * n_w, (n_flip, n_w)
    assert all("alpha" not in st for st in tiny["tq"][site].values())


# -- the whole weight pass ----------------------------------------------------

def _block_mse(unit, qstate, inps, out):
    """Mean squared error of the unit with hard rounding (alphas where
    qstate has them, nearest rounding elsewhere) on captured inputs."""
    with torch.no_grad():
        pred = unit.apply(QuantCtx(qstate, mode=QuantMode(w=True)), *inps)
    return float(torch.mean((pred - out) ** 2))


def _nearest(qstate, unit):
    return {s: ({k: {n: v for n, v in st.items() if n != "alpha"}
                 for k, st in sl.items()} if s in unit.layer_names else sl)
            for s, sl in qstate.items()}


def test_calibrate_loads_in_jax_and_samples_close(tiny, tmp_path,
                                                  monkeypatch):
    """The port's weight pass (W4, split) over every unit: each unit's
    block error falls or holds (at most 1.02x nearest rounding), the
    qstate file loads in JAX with weight-shaped alphas, and the JAX fold
    engine's DDIM samples with it match the port's."""
    jm, tm, params = tiny["jm"], tiny["tm"], tiny["params"]
    errs = {}
    real = engine.reconstruct_unit

    def spy(model, qstate, unit, inps, out, cfg, **kw):
        new = real(model, qstate, unit, inps, out, cfg, **kw)
        errs[unit.name] = (_block_mse(unit, _nearest(new, unit), inps, out),
                           _block_mse(unit, new, inps, out))
        return new

    monkeypatch.setattr(engine, "reconstruct_unit", spy)
    cfg = CalibConfig(weight=ReconConfig(iters=ITERS, batch_size=BS),
                      capture_batch=BS)
    q = calibrate(tm, (_t(tiny["xs"]), _t(tiny["ts"])), cfg,
                  torch.Generator().manual_seed(0))
    assert list(errs) == [u.name for u in tm.units]
    print("block error ratios after/before: worst "
          f"{max(a / b for b, a in errs.values()):.4f}, sums "
          f"{sum(b for b, _ in errs.values()):.5g} -> "
          f"{sum(a for _, a in errs.values()):.5g}")
    for name, (before, after) in errs.items():
        assert after <= 1.02 * before, (name, before, after)
    assert sum(a for _, a in errs.values()) < sum(
        b for b, _ in errs.values())
    for name, cfg_l in tm.layer_cfgs.items():
        w = tm.get_submodule(name).weight
        halves = split_weight(w, cfg_l.split) if cfg_l.split else (w,)
        for slot, ww in zip(("w", "w0"), halves):
            assert q[name][slot]["alpha"].shape == ww.shape

    path = tmp_path / "qstate.npz"
    save_qstate(path, q)
    jq = jax_load_qstate(path)
    assert jq["conv_in"]["w"]["alpha"].shape == params["conv_in"]["w"].shape
    assert jq["temb.dense.0"]["w"]["alpha"].shape == \
        params["temb"]["dense"]["0"]["w"].shape
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = make_skip_sequence(100, 4, "uniform")
    x0 = np.random.default_rng(4).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    folded = jax_fold(jm, params, jq)
    want, _ = jax_ddim(jax.jit(lambda x, t: jm.apply(folded, x, t)),
                       jnp.asarray(x0), seq, np.asarray(betas))
    step = make_quantized_step(tm, q, engine="fold")
    with torch.no_grad():
        got = ddim_sample(step, _t(x0), seq, betas)
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    print(f"fold DDIM-4 with the port's qstate, port vs JAX: relative L2 "
          f"{rel:.2e}")
    assert rel <= 5e-2, rel
