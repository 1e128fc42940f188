"""The quality-evidence harness and the FID metrics of the port against
the JAX package's (`scripts/quality_evidence.py`, imported by path as
tests/test_quality_evidence.py does, and `qdiffusion_tpu/metrics/fid.py`).

Tolerances:
- FID math (compute_statistics, frechet_distance, fid_from_features,
  inception_score_from_logits): 1e-9 relative to JAX's on the same
  float64 numpy inputs (the same scipy calls; only round-off differs);
  the closed forms of tests/test_fid.py at that file's own tolerances.
- The two-blob renderer fed JAX's (pos, col, sig) draws: 1e-6 absolute on
  values in [-1, 1] (f32 exp and einsum sum order).
- The feature CNN with JAX's weights (HWIO -> OIHW): 1e-5 relative to the
  largest feature (f32 conv sum order); the SAME padding at stride 2 is
  (0, 1), and a (1, 1) pad shifts every feature, far beyond that.
- Three Adam steps (lr 2e-3, optax's defaults) from the same params on
  injected x0, t and eps: each loss to 1e-5 relative; each step's
  gradient per tensor to 1e-4 relative in norm (the FP forward's
  tolerance; observed 2.9e-5, summed over many paths); every param
  after the three steps to 2e-5 relative in norm (observed 1.05e-5:
  Adam divides each gradient entry by its own running size, so round-off
  in a small entry moves its step more than 1e-5 of the tensor). A
  tensor whose gradient is zero up to round-off (below 1e-6 in both
  packages: the attention's key bias, and per-channel shifts in front of
  a one-channel GroupNorm group, TINY's 32 channels in 32 groups) takes
  steps of round-off divided by Adam's eps 1e-8, which no package
  agrees on: it is held to have moved at most 3 lr.
- The harness at a CPU smoke size: JAX's output keys, finite values, two
  runs equal exactly. Its calibration set is 8 samples x 4 trajectory
  steps: the engines capture whole batches of 32.
- The calibrated W4A8 arm's shortcut: JAX's W4A8 calibrate yields its W4
  run's weight qstate exactly (so the port may start the W4A8 act pass
  from the W4 arm's qstate and generator), and the port's shortcut
  equals its own whole W4A8 calibrate exactly.
- The full protocol (`slow`) is held to the JAX test's five bounds; on
  the card it runs in chip_smoke.py's `quality` phase.
- Both harnesses at a reduced size (`slow`, seeds 0-2, training at batch
  16): the port's mean loss of every 250 steps within 15 % of JAX's at
  the same seed (the two draw different numbers, so only the statistics
  can agree), every FID finite; the FIDs are printed, not held.
"""

import ast
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from qdiffusion_tpu.calib.engine import CalibConfig as JaxCalibConfig
from qdiffusion_tpu.calib.engine import calibrate as jax_calibrate
from qdiffusion_tpu.calib.recon import ReconConfig as JaxReconConfig
from qdiffusion_tpu.metrics import fid as jfid
from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig

from qdiffusion_torch.calib.engine import CalibConfig, calibrate
from qdiffusion_torch.calib.recon import ReconConfig
from qdiffusion_torch.convert import from_jax_params
from qdiffusion_torch.metrics import fid as tfid
from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig
from qdiffusion_torch.scripts import quality_evidence as tqe

from test_torch_unet import build_pair

torch.set_num_threads(1)

_QE = Path(__file__).resolve().parent.parent / "scripts" / \
    "quality_evidence.py"
if "quality_evidence" in sys.modules:
    jqe = sys.modules["quality_evidence"]
else:
    _SPEC = importlib.util.spec_from_file_location("quality_evidence", _QE)
    jqe = importlib.util.module_from_spec(_SPEC)
    sys.modules["quality_evidence"] = jqe
    _SPEC.loader.exec_module(jqe)


# ---------------------------------------------------------------- FID


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def test_fid_functions_match_jax():
    rng = np.random.default_rng(0)
    f1 = rng.normal(size=(300, 12))
    f2 = 0.8 * rng.normal(size=(250, 12)) + 0.3
    mu_t, s_t = tfid.compute_statistics(f1)
    mu_j, s_j = jfid.compute_statistics(f1)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-9)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-9)
    mu2, s2 = jfid.compute_statistics(f2)
    assert _rel(tfid.frechet_distance(mu_t, s_t, mu2, s2),
                jfid.frechet_distance(mu_j, s_j, mu2, s2)) < 1e-9
    assert _rel(tfid.fid_from_features(f1, f2),
                jfid.fid_from_features(f1, f2)) < 1e-9
    # a singular product: the eps-offset retry
    low = np.zeros((40, 12))
    low[:, :3] = rng.normal(size=(40, 3))
    assert _rel(tfid.fid_from_features(low, f2),
                jfid.fid_from_features(low, f2)) < 1e-9
    logits = rng.normal(size=(200, 10)) * 3.0
    for a, b in zip(tfid.inception_score_from_logits(logits, splits=4),
                    jfid.inception_score_from_logits(logits, splits=4)):
        assert _rel(a, b) < 1e-9


def test_fid_without_sqrtm_disp(monkeypatch):
    """SciPy releases whose sqrtm takes no `disp` (the card's machine)
    give the same FID."""
    from scipy import linalg

    real = linalg.sqrtm

    def sqrtm(a, **kw):
        if kw:
            raise TypeError(f"sqrtm() got an unexpected keyword argument "
                            f"{next(iter(kw))!r}")
        return real(a)

    rng = np.random.default_rng(2)
    f1, f2 = rng.normal(size=(200, 6)), rng.normal(size=(150, 6)) + 0.2
    want = jfid.fid_from_features(f1, f2)
    monkeypatch.setattr(linalg, "sqrtm", sqrtm)
    assert _rel(tfid.fid_from_features(f1, f2), want) < 1e-9


def _fid_identical(m):
    f = np.random.default_rng(0).normal(size=(512, 16))
    got = m.fid_from_features(f, f)
    assert abs(got) < 1e-6
    return got


def _fid_mean_shift(m):
    f1 = np.random.default_rng(1).normal(size=(200_00, 8))
    shift = np.arange(8) * 0.1
    got = m.fid_from_features(f1, f1 + shift)
    np.testing.assert_allclose(got, np.sum(shift**2), rtol=1e-3, atol=1e-4)
    return got


def _frechet_diagonal(m):
    mu1, mu2 = np.zeros(4), np.ones(4)
    s1 = np.diag([1.0, 2.0, 3.0, 4.0])
    s2 = np.diag([2.0, 2.0, 1.0, 1.0])
    want = np.sum((np.sqrt(np.diag(s1)) - np.sqrt(np.diag(s2))) ** 2) + 4.0
    got = m.frechet_distance(mu1, s1, mu2, s2)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    return got


def _is_uniform(m):
    mean, _ = m.inception_score_from_logits(np.zeros((100, 10)), splits=5)
    np.testing.assert_allclose(mean, 1.0, atol=1e-6)
    return mean


def _is_confident(m):
    n, c = 1000, 10
    logits = np.full((n, c), -20.0)
    logits[np.arange(n), np.arange(n) % c] = 20.0
    mean, _ = m.inception_score_from_logits(logits, splits=2)
    assert mean > 9.0
    return mean


@pytest.mark.parametrize("case", [_fid_identical, _fid_mean_shift,
                                  _frechet_diagonal, _is_uniform,
                                  _is_confident],
                         ids=lambda f: f.__name__.strip("_"))
def test_fid_cases_of_jax_tests(case):
    """tests/test_fid.py's five cases on the port, each value also within
    1e-9 relative (or 1e-12 absolute near 0) of JAX's."""
    got, want = case(tfid), case(jfid)
    assert abs(got - want) <= 1e-9 * abs(want) + 1e-12


# ---------------------------------------------------------------- data


def test_render_blobs_matches_jax_draws():
    key = jax.random.PRNGKey(7)
    n = 16
    want = np.asarray(jqe.synth_batch(key, n))
    kpos, kcol, ksig = jax.random.split(key, 3)  # jqe.synth_batch's draws
    pos = jax.random.uniform(kpos, (n, 2, 2), minval=4.0,
                             maxval=jqe.RES - 4.0)
    col = jax.random.uniform(kcol, (n, 2, 3), minval=-1.0, maxval=1.0)
    sig = jax.random.uniform(ksig, (n, 2), minval=1.2, maxval=2.5)
    got = tqe.render_blobs(*(torch.from_numpy(np.asarray(a))
                             for a in (pos, col, sig)))
    assert got.shape == (n, tqe.RES, tqe.RES, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the port's draws cover the same ranges
    p, c, s = tqe.synth_draws(torch.Generator().manual_seed(0), 4096)
    assert 4.0 <= float(p.min()) and float(p.max()) < tqe.RES - 4.0
    assert -1.0 <= float(c.min()) and float(c.max()) < 1.0
    assert 1.2 <= float(s.min()) and float(s.max()) < 2.5


def test_extract_features_matches_jax_same_padding():
    fps = jqe.feature_params(jax.random.PRNGKey(4))
    imgs = jqe.synth_batch(jax.random.PRNGKey(5), 24)
    want = np.asarray(jqe.extract_features(fps, imgs))
    tfps = [torch.from_numpy(np.asarray(w)).permute(3, 2, 0, 1).contiguous()
            for w in fps]
    got = tqe.extract_features(tfps, torch.from_numpy(np.asarray(imgs)))
    assert got.shape == want.shape == (24, 128)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert tqe._same_pads(16) == (0, 1) and tqe._same_pads(5) == (1, 1)
    assert [tuple(w.shape) for w in tqe.feature_params(
        torch.Generator().manual_seed(0))] == [tuple(w.shape) for w in tfps]


# ---------------------------------------------------------------- training

# gradient entries below this are round-off of a zero gradient: a key
# bias (softmax ignores it) or a per-channel shift in front of a
# one-channel GroupNorm group (TINY's 32 channels in 32 groups)
_ROUND_OFF = 1e-6


def test_three_adam_steps_match_optax():
    jm, tm, params = build_pair()
    lr, n = 2e-3, 4
    rng = np.random.default_rng(3)
    abar = jnp.asarray(jqe.ABAR)

    def loss_fn(p, x0, t, eps):
        a = abar[t][:, None, None, None]
        xt = jnp.sqrt(a) * x0 + jnp.sqrt(1.0 - a) * eps
        pred = jm.apply(p, xt, t.astype(jnp.float32))
        return jnp.mean((pred - eps) ** 2)

    grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(lr)
    p, s = params, opt.init(params)
    tm.requires_grad_(True)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)
    tabar = torch.from_numpy(tqe.ABAR)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    flat = dict(tm.named_parameters())
    degenerate = set(flat)
    worst = {"grad": 0.0, "param": 0.0}
    for k in range(3):
        x0 = np.asarray(jqe.synth_batch(jax.random.PRNGKey(10 + k), n))
        t = rng.integers(0, jqe.T, n)
        eps = rng.standard_normal(x0.shape).astype(np.float32)
        loss, g = grad(p, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
        updates, s = opt.update(g, s)
        p = optax.apply_updates(p, updates)
        got = tqe.train_step(tm, topt, tabar, torch.from_numpy(x0),
                             torch.from_numpy(t), torch.from_numpy(eps))
        assert _rel(float(got), float(loss)) < 1e-5
        want_g = from_jax_params(jax.tree_util.tree_map(np.asarray, g))
        for name, prm in flat.items():
            gj, gt = want_g[name], prm.grad
            if float(gj.abs().max()) < _ROUND_OFF:
                assert float(gt.abs().max()) < _ROUND_OFF, name
                continue
            degenerate.discard(name)
            worst["grad"] = max(worst["grad"],
                                float((gt - gj).norm() / gj.norm()))
    want_sd = from_jax_params(jax.tree_util.tree_map(np.asarray, p))
    for name, v in tm.state_dict().items():
        if name in degenerate:
            # Adam turns a round-off gradient into a step of up to lr
            assert float((v - start[name]).abs().max()) <= 3 * lr, name
        else:
            worst["param"] = max(worst["param"], float(
                (v - want_sd[name]).norm() / want_sd[name].norm()))
    assert worst["grad"] < 1e-4 and worst["param"] < 2e-5, worst
    assert 0 < len(degenerate) < len(flat) // 2


# ---------------------------------------------------------------- protocol


def _jax_output_keys() -> set:
    """The string keys of the dicts the JAX run_protocol returns (`out =
    {...}` and `out.update({...})`), read from its source."""
    fn = next(n for n in ast.walk(ast.parse(_QE.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "run_protocol")
    dicts = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "out" for t in node.targets):
            dicts.append(node.value)
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "update" \
                and getattr(node.func.value, "id", None) == "out":
            dicts += [a for a in node.args if isinstance(a, ast.Dict)]
    assert len(dicts) == 2
    return {k.value for d in dicts for k in d.keys}


SMOKE = dict(train_steps=4, n_samples=8, recon_iters=2, bits=4,
             sample_steps=4, cali_n=8, cali_st=4, seed=0, act_quant=True)


def test_run_protocol_smoke_size():
    stats = {}
    out = tqe.run_protocol(**SMOKE, log=lambda *a: None, device="cpu",
                           stats=stats)
    assert set(out) == _jax_output_keys()
    assert all(math.isfinite(v) for v in out.values()
               if isinstance(v, (int, float)))
    assert out["recon_iters_a"] == 1 and out["n_samples"] == 8
    assert set(stats["seconds"]) == {
        "train", "sample_fp", "naive_w4", "calib_w4", "sample_naive",
        "sample_calib", "naive_a8", "calib_a8", "sample_naive_a8",
        "sample_calib_a8", "fid"}
    assert len(stats["train_loss"]) == 1
    # every unit with act deltas logged its record
    assert stats["deltas_below_lr"] and all(
        isinstance(v, list) for v in stats["deltas_below_lr"].values())
    again = tqe.run_protocol(**SMOKE, log=lambda *a: None, device="cpu")
    assert again == out


SMALL = dict(ch=32, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(),
             resolution=8)
# SMALL's units that the JAX W4A8 premise test leaves out, to halve its
# compiles: it keeps a dense layer, a conv layer, a ResnetBlock and the
# attention block (temb.dense.0, conv_in, down.0.block.0, mid.attn_1)
SMALL_SKIP = ("temb.dense.1", "mid.block_1", "mid.block_2", "up.0.block.0",
              "up.0.block.1", "conv_out")


def test_jax_w4a8_weight_pass_equals_w4_run():
    """The premise of the harness's W4A8 shortcut, in the JAX engine: a
    W4A8 calibrate draws its weight pass as the W4 run does, so its weight
    quantizers (delta, zero point, alpha) come out equal."""
    policy = jqe.QuantPolicy(
        wq=jqe.AffineQuantizerSpec(n_bits=4, channel_wise=True,
                                   channel_axis=-1, scale_method="max"),
        aq=jqe.AffineQuantizerSpec(n_bits=8, scale_method="max",
                                   leaf_param=True))
    jm = JaxUNet(JaxConfig(**SMALL), policy)
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.standard_normal((32, 8, 8, 3)).astype(np.float32))
    ts = jnp.asarray(rng.integers(0, 1000, 32).astype(np.float32))
    w = JaxReconConfig(iters=2, p=2.0)
    q4 = jax_calibrate(jm, params, (xs, ts), JaxCalibConfig(
        weight=w, quant_act=False, capture_batch=32, skip_units=SMALL_SKIP),
        rng=jax.random.PRNGKey(3))
    q48 = jax_calibrate(jm, params, (xs, ts), JaxCalibConfig(
        weight=w, act=JaxReconConfig(iters=1, p=2.0), quant_act=True,
        running_stat=True, capture_batch=32, skip_units=SMALL_SKIP),
        rng=jax.random.PRNGKey(3))
    n = 0
    for site, slots in q4.items():
        for slot, st in slots.items():
            assert slot in ("w", "w0")
            for leaf, v in st.items():
                np.testing.assert_array_equal(
                    np.asarray(q48[site][slot][leaf]), np.asarray(v),
                    err_msg=f"{site}/{slot}/{leaf}")
                n += 1
    reconstructed = {site for site, sl in q4.items()
                     if any("alpha" in st for st in sl.values())}
    assert n > 0 and len(reconstructed) >= 4, reconstructed


def test_w4a8_shortcut_equals_whole_calibrate():
    """The port: the act pass on the W4 run's qstate and generator equals
    a whole W4A8 calibrate from a fresh generator with the same seed."""
    tm = DDIMUNet(DDIMUNetConfig(**SMALL), tqe.QuantPolicy(
        wq=tqe.AffineQuantizerSpec(n_bits=4, channel_wise=True,
                                   channel_axis=0, scale_method="max"),
        aq=tqe.AffineQuantizerSpec(n_bits=8, scale_method="max",
                                   leaf_param=True)), device="cpu")
    tm.load_state_dict(tm.init_params(0))
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((64, 8, 8, 3))
                          .astype(np.float32))
    ts = torch.from_numpy(rng.integers(0, 1000, 64).astype(np.float32))
    w = ReconConfig(iters=3, p=2.0)
    cfg_a = CalibConfig(weight=w, act=ReconConfig(iters=2, p=2.0),
                        quant_act=True, running_stat=True, capture_batch=32,
                        act_init_batch=32)
    whole = calibrate(tm, (xs, ts), cfg_a,
                      generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    q4 = calibrate(tm, (xs, ts), CalibConfig(weight=w, capture_batch=32),
                   generator=gen)
    short = calibrate(tm, (xs, ts), cfg_a, generator=gen, qstate=q4,
                      skip_weight_pass=True)
    assert whole.keys() == short.keys()
    for site, slots in whole.items():
        assert slots.keys() == short[site].keys(), site
        for slot, st in slots.items():
            for leaf, v in st.items():
                assert torch.equal(short[site][slot][leaf], v), \
                    f"{site}/{slot}/{leaf}"


@pytest.mark.slow
def test_calibrated_w4_beats_naive_w4_on_fid():
    """The JAX test's settings and bounds (tests/test_quality_evidence.py:
    46-62) through the port: tens of minutes on the CPU; on the card it
    is chip_smoke.py's `quality` phase."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    out = tqe.run_protocol(train_steps=2500, n_samples=384,
                           recon_iters=1000, bits=4, sample_steps=50,
                           cali_n=48, cali_st=5, seed=0,
                           log=lambda *a: None, act_quant=True, device=dev)
    assert out["fid_naive"] > 3 * out["fid_fp"], out
    assert out["fid_calib"] < out["fid_naive"] * 0.5, out
    assert out["recovered_frac"] > 0.4, out
    assert out["fid_calib_a8"] < out["fid_naive_a8"], out
    assert out["fid_calib_a8"] < out["fid_naive"] * 0.6, out


# The reduced setting at which both harnesses finish on the CPU: XLA's
# CPU convolutions make 250 training steps at the JAX script's batch 128
# take about an hour, so both train at batch SPREAD_BATCH here.
SPREAD = dict(train_steps=500, n_samples=128, recon_iters=200, bits=4,
              sample_steps=20, cali_n=16, cali_st=4)
SPREAD_BATCH = 16


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_harness_against_jax_across_seeds(seed, monkeypatch, capsys):
    """Both harnesses at SPREAD, training at batch SPREAD_BATCH, one seed
    each: the port's mean loss of every 250 steps within 15 % of JAX's at
    the same seed (the draws differ, so only the statistics can agree),
    every FID finite. Prints one JSON line of both results, so the spread
    of the FIDs and recovered fractions over seeds can be read for each
    package."""
    import functools
    import json
    import re

    monkeypatch.setattr(jqe, "train",
                        functools.partial(jqe.train, batch=SPREAD_BATCH))
    monkeypatch.setattr(tqe, "train",
                        functools.partial(tqe.train, batch=SPREAD_BATCH))
    lines = []
    jax_out = jqe.run_protocol(**SPREAD, seed=seed, log=lines.append)
    jax_loss = [float(m.group(1)) for m in map(
        re.compile(r"train step \d+/\d+: loss ([0-9.]+)").search, lines)
        if m]
    stats = {}
    port_out = tqe.run_protocol(**SPREAD, seed=seed, log=lambda *a: None,
                                device="cpu", stats=stats)
    with capsys.disabled():
        print("HARNESS_SPREAD " + json.dumps({
            "seed": seed, "train_batch": SPREAD_BATCH, **SPREAD,
            "jax": {**jax_out, "train_loss": jax_loss},
            "port": {**port_out, "train_loss": stats["train_loss"],
                     "seconds": stats["seconds"]}}), flush=True)
    assert len(jax_loss) == len(stats["train_loss"]) == 2
    for j, t in zip(jax_loss, stats["train_loss"]):
        assert abs(t - j) <= 0.15 * j, (jax_loss, stats["train_loss"])
    for out in (jax_out, port_out):
        assert all(math.isfinite(out[k]) for k in (
            "fid_fp", "fid_naive", "fid_calib", "recovered_frac")), out


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_250_steps_against_jax_at_batch_128(seed, capsys):
    """The JAX script's own training batch, 128, for one chunk of 250
    steps in each package from its own init of `seed` (about an hour of
    XLA's CPU convolutions): the port's mean loss within 15 % of JAX's.
    Prints both."""
    import json

    jlines = []
    jm = jqe.DDIMUNet(jqe.CFG, None)
    jqe.train(jm, jax.jit(jm.init_params)(jax.random.PRNGKey(seed)),
              steps=250, seed=seed, log=jlines.append)
    jax_loss = float(jlines[-1].split("loss ")[1].split()[0])
    tm = DDIMUNet(tqe.CFG, None, device="cpu")
    tm.load_state_dict(tm.init_params(seed))
    port_loss = tqe.train(tm, steps=250, seed=seed, log=lambda *a: None)
    with capsys.disabled():
        print("FIRST_CHUNK_128 " + json.dumps({
            "seed": seed, "jax": jax_loss, "port": port_loss}), flush=True)
    assert len(port_loss) == 1
    assert abs(port_loss[0] - jax_loss) <= 0.15 * jax_loss, (jax_loss,
                                                             port_loss)
