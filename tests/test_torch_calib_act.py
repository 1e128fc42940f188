"""The activation pass of calibration, the Fisher losses and the pieces
under them, the port against the JAX package, on the TINY split W4A8
CIFAR UNet of test_torch_calib.py (ch=32, ch_mult=(1, 2), attention at
8x8, 16x16 inputs), f32 on the CPU, with the same 16 seeded samples.
Params and inputs are numpy draws handed to both packages; both start
from one qstate (JAX's weight init, AdaRound alphas on every unit, act
init from 8 rows), moved to the port's layout.

Tolerances:
  * fake_quant's gradients with respect to x and delta, with elements
    exactly on both clip bounds, against jax.grad: elementwise 1e-6;
  * EMA and EMA_SM_ONLY collection through run_running_stat's sweep,
    with the same input at every site in both packages: delta,
    zero_point, x_min and x_max within 1e-5 relative; the sweep over the
    UNet, where bucket flips cascade: 3e-3 relative and the zero point
    within one level (test_running_stat_on_the_unet_matches_jax);
  * a forward with a unit's output substituted: 1e-5;
  * _kl_batchmean and both fisher_rec_loss forms, in float64: 1e-6
    relative;
  * save_grad_data (dense, conv, ResnetBlock, attention; and the weight
    pass's W4 capture): within 1e-4 of the largest |g|; the weight pass's
    fisher_diag reconstruction of a ResnetBlock with JAX's grads and
    indices: alphas within 1e-4 of the largest |alpha| after 32
    iterations;
  * the cosine schedule against optax.cosine_decay_schedule at k = 0, 1,
    iters/2 and iters-1: within 1e-7 of lr (about 1e-10 absolute);
  * reconstruct_unit(act_quant=True) with JAX's minibatch indices, after
    32 iterations (mse, one unit of each kind; fisher_diag on one
    ResnetBlock with JAX's Fisher grads): every delta within 1e-4
    relative of JAX's, or within four times JAX's own spread when its
    inputs carry 2e-6 relative noise, where that is larger (the
    ResnetBlocks: see the test);
  * whole calibrate(quant_act=True, running_stat=True) with JAX's
    act-init rows: the port's qstate loads in JAX, and the JAX sim
    engine's W4A8 DDIM-4 samples with it are within 5e-2 relative L2 of
    the port's sim samples; each unit's act block error after its
    reconstruction at most 1.02x the error with its init/EMA deltas, on
    its captured FP inputs, for every unit whose trained deltas are all
    at least the learning rate (the attention units' post-softmax deltas
    are not: see the test). The sum of the block errors is printed, not
    held: three units (errors 151, 149 and 83 under random weights) make
    nearly all of it, and 16 iterations at lr 4e-4 move them by at most
    0.1 %.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.capture import capture_unit_io as jax_capture
from qdiffusion_tpu.calib.engine import init_act_qstate as jax_init_act
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.calib.engine import run_running_stat as jax_running
from qdiffusion_tpu.calib.fisher import _kl_batchmean as jax_kl
from qdiffusion_tpu.calib.fisher import fisher_rec_loss as jax_fisher_loss
from qdiffusion_tpu.calib.fisher import save_grad_data as jax_grad_data
from qdiffusion_tpu.calib.recon import ReconConfig as JaxReconConfig
from qdiffusion_tpu.calib.recon import init_adaround_unit as jax_init_alpha
from qdiffusion_tpu.calib.recon import reconstruct_unit as jax_reconstruct
from qdiffusion_tpu.quant.affine import AffineQuantizerSpec as JaxSpec
from qdiffusion_tpu.quant.affine import fake_quant as jax_fake_quant
from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
from qdiffusion_tpu.quant.context import QuantMode as JaxMode
from qdiffusion_tpu.samplers.ddim import ddim_sample as jax_ddim
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate

from qdiffusion_torch.calib import engine, recon
from qdiffusion_torch.calib.engine import CalibConfig, calibrate, \
    run_running_stat
from qdiffusion_torch.calib.fisher import _kl_batchmean, fisher_rec_loss, \
    save_grad_data
from qdiffusion_torch.calib.recon import ReconConfig, cosine_lr, \
    reconstruct_unit
from qdiffusion_torch.convert import qstate_from_jax
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.quant.affine import AffineQuantizerSpec, fake_quant
from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.samplers.ddim import ddim_sample
from qdiffusion_torch.schedules import get_beta_schedule, make_skip_sequence
from qdiffusion_torch.utils.checkpoints import save_qstate

from test_torch_calib import _close, _nchw, _t
from test_torch_unet import build_pair

torch.set_num_threads(1)

ITERS = 32
BS = 8  # reconstruction minibatch, capture batch and act-init rows
WA = QuantMode(w=True, a=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(jq) -> dict:
    return qstate_from_jax(_np(jq))


@pytest.fixture(scope="module")
def tiny():
    """Both models, the params, the 16 samples and the shared starting
    qstate, in JAX's tree (jq) and the port's (tq)."""
    jm, tm, params = build_pair(split=True, weight_bit=4, quant_act=True)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    ts = np.linspace(0, 999, 16).astype(np.float32)
    jq = jax_init_w(jm, params)
    for unit in jm.units:
        if unit.layer_names:
            jq = jax_init_alpha(jm, params, jq, unit)
    jq = jax_init_act(jm, params, jq, jnp.asarray(xs[:BS]),
                      jnp.asarray(ts[:BS]))
    return dict(jm=jm, tm=tm, params=params, xs=xs, ts=ts, jq=jq,
                tq=_to_port(jq), grads={})


def _unit(model, name):
    return next(u for u in model.units if u.name == name)


# -- fake_quant at the clip bounds --------------------------------------------

@pytest.mark.parametrize("n_bits,symmetric", [(8, False), (4, False),
                                              (8, True)])
def test_fake_quant_gradient_at_the_bounds_matches_jax(n_bits, symmetric):
    """Elements exactly on the lower and upper bound get half the
    gradient (jnp.clip's), beside interior and clipped elements. x sits
    on a grid of delta / 8 (rounding ties included) and the weights are
    small integers, so every term of delta's gradient and every partial
    sum is exact in f32 and the sums agree in any order."""
    spec = AffineQuantizerSpec(n_bits=n_bits, symmetric=symmetric)
    jspec = JaxSpec(n_bits=n_bits, symmetric=symmetric)
    delta, zp = np.float32(0.25), np.float32(0.0 if symmetric else 3.0)
    lo, hi = (-spec.n_levels - 1, spec.n_levels) if symmetric \
        else (0, spec.n_levels - 1)
    rng = np.random.default_rng(2)
    x = np.concatenate([
        (np.array([lo, hi, lo, hi], np.float32) - zp) * delta,
        rng.integers(8 * (lo - 4), 8 * (hi + 4), 60).astype(np.float32)
        / 8 * delta])
    w = rng.integers(-3, 4, x.shape).astype(np.float32)
    w[:4] = (1, -2, 3, 1)

    def jloss(x_, d_):
        return jnp.sum(jax_fake_quant(x_, d_, zp, jspec) * w)

    want_x, want_d = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(delta))
    xt = torch.from_numpy(x).requires_grad_(True)
    dt = torch.tensor(delta).requires_grad_(True)
    (fake_quant(xt, dt, torch.tensor(zp), spec) * torch.from_numpy(w)
     ).sum().backward()
    assert float(xt.grad[0]) == pytest.approx(0.5 * w[0])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(want_d),
                               rtol=1e-6, atol=1e-6)


# -- the running-stat EMA ----------------------------------------------------

# activation specs of each kind the models use, with the EMA's stats kept
EMA_SPECS = {"asym": dict(n_bits=8, leaf_param=True),
             "sym": dict(n_bits=8, symmetric=True, leaf_param=True),
             "sm": dict(n_bits=8, always_zero=True, leaf_param=True)}
# (site, slot, spec, the site's input as a function of the batch (x, t))
EMA_SITES = (("s0", "a", "asym", lambda x, t, m: x),
             ("s0", "a0", "asym", lambda x, t, m: 2.0 * x - 1.0),
             ("s1", "q", "sym", lambda x, t, m: x * t[:, None, None, None]
              / 1000.0),
             ("s1", "sm", "sm", lambda x, t, m: m.softmax(x, -1)))


class _JaxSites:
    """A stand-in model for JAX's run_running_stat: its forward only
    passes functions of the batch through the EMA_SITES quantizers."""

    def apply(self, params, x, t, ctx):
        for site, slot, spec, fn in EMA_SITES:
            ctx.act_quant(site, slot, fn(x, t, jax.nn), JaxSpec(
                **EMA_SPECS[spec]))
        return x


def _torch_sites(x, t, ctx):
    """The port's counterpart of _JaxSites."""
    for site, slot, spec, fn in EMA_SITES:
        ctx.act_quant(site, slot, fn(x, t, torch), AffineQuantizerSpec(
            **EMA_SPECS[spec]))
    return x


def _ema_data(n=29):
    rng = np.random.default_rng(6)
    xs = (rng.standard_normal((n, 4, 4, 8)) * np.linspace(
        0.5, 3.0, n)[:, None, None, None]).astype(np.float32)
    return xs, np.linspace(1, 999, n).astype(np.float32)


@pytest.mark.parametrize("sm_only", [False, True])
def test_running_stat_sweep_matches_jax(sm_only):
    """run_running_stat's sweep (whole batches in order, each reading the
    stats the batch before left; a tail of 5 rows dropped) and the EMA /
    EMA_SM_ONLY collection on every slot kind, with the same inputs at
    every site in both packages."""
    xs, ts = _ema_data()
    jq0 = jax_init_act(_JaxSites(), None, {}, jnp.asarray(xs[:BS]),
                       jnp.asarray(ts[:BS]))
    want = _to_port(jax_running(_JaxSites(), None, jq0, jnp.asarray(xs),
                                jnp.asarray(ts), batch=BS, sm_only=sm_only))
    got = run_running_stat(_torch_sites, _to_port(jq0), _t(xs), _t(ts),
                           batch=BS, sm_only=sm_only)
    start = _to_port(jq0)
    for site, slot, _, _ in EMA_SITES:
        moved = not torch.equal(want[site][slot]["x_max"],
                                start[site][slot]["x_max"])
        assert moved != (sm_only and slot != "sm"), (site, slot)
        for leaf in ("delta", "zero_point", "x_min", "x_max"):
            torch.testing.assert_close(got[site][slot][leaf],
                                       want[site][slot][leaf], rtol=1e-5,
                                       atol=0)


@pytest.mark.parametrize("sm_only", [False, True])
def test_running_stat_on_the_unet_matches_jax(tiny, sm_only):
    """The sweep over the TINY W4A8 UNet (16 samples, batches of 8): the
    same quantizers move. The values drift with depth: an f32 rounding
    difference flips an activation's quantization bucket and the flip
    cascades downstream (the port's own sweep in f32 and in f64 differs
    by 4.4e-4 relative at the deepest sites), so each site is held to
    3e-3 relative (the largest seen against JAX is 1.0e-3) and the zero
    point to one level; the 1e-5 check is
    test_running_stat_sweep_matches_jax."""
    got = run_running_stat(tiny["tm"], tiny["tq"], _t(tiny["xs"]),
                           _t(tiny["ts"]), batch=BS, sm_only=sm_only)
    want = _to_port(jax_running(tiny["jm"], tiny["params"], tiny["jq"],
                                jnp.asarray(tiny["xs"]),
                                jnp.asarray(tiny["ts"]), batch=BS,
                                sm_only=sm_only))
    n_act = 0
    for site, slots in want.items():
        for slot, st in slots.items():
            if "x_min" not in st:
                continue
            n_act += 1
            moved = not torch.equal(st["x_max"],
                                    tiny["tq"][site][slot]["x_max"])
            assert moved != (sm_only and slot != "sm"), (site, slot)
            for leaf in ("delta", "x_min", "x_max"):
                torch.testing.assert_close(got[site][slot][leaf], st[leaf],
                                           rtol=3e-3, atol=0)
            assert float((got[site][slot]["zero_point"]
                          - st["zero_point"]).abs()) <= 1.0
    assert n_act > 20


# -- the Fisher substitute, KL and losses ---------------------------------------

@pytest.mark.parametrize("name", ["temb.dense.1", "mid.block_1"])
def test_substitute_forward_matches_jax(tiny, name):
    jm, tm = tiny["jm"], tiny["tm"]
    _, jout = jax_capture(jm, tiny["params"], tiny["jq"], name,
                          jnp.asarray(tiny["xs"][:2]),
                          jnp.asarray(tiny["ts"][:2]), batch_size=2)
    sub = np.random.default_rng(3).standard_normal(jout.shape).astype(
        np.float32)
    want = jm.apply(tiny["params"], jnp.asarray(tiny["xs"][:2]),
                    jnp.asarray(tiny["ts"][:2]),
                    JaxCtx(tiny["jq"], substitute={name: jnp.asarray(sub)}))
    with torch.no_grad():
        got = tm(_t(tiny["xs"][:2]), _t(tiny["ts"][:2]),
                 QuantCtx(tiny["tq"], substitute={name: _nchw(sub)}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("what", ["kl", "fisher_diag", "fisher_full"])
def test_kl_and_fisher_losses_match_jax(what):
    """In float64 on both sides (JAX under enable_x64): each function
    sums 800 terms, and in f32 the two sum orders alone differ by about
    1e-6 of the result."""
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((4, 5, 5, 8)) for _ in range(2))
    g = np.abs(rng.standard_normal(a.shape)) + 1.0
    with jax.enable_x64(True):
        if what == "kl":
            got = _kl_batchmean(_t(a), _t(b))
            want = jax_kl(jnp.asarray(a), jnp.asarray(b))
        else:  # the port's conv units are NCHW, summed over channel dim 1
            got = fisher_rec_loss(*(_nchw(v) for v in (a, b, g)), what,
                                  axis=1)
            want = jax_fisher_loss(*(jnp.asarray(v) for v in (a, b, g)),
                                   what, axis=-1)
        assert got.dtype == torch.float64 and want.dtype == jnp.float64
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_grads(tiny, name):
    if name not in tiny["grads"]:
        tiny["grads"][name] = np.asarray(jax_grad_data(
            tiny["jm"], tiny["params"], tiny["jq"], name,
            jnp.asarray(tiny["xs"]), jnp.asarray(tiny["ts"]),
            act_quant=True, batch_size=BS))
    return tiny["grads"][name]


@pytest.mark.parametrize("name", ["temb.dense.1", "conv_in", "mid.block_1",
                                  "down.1.attn.0"])
def test_save_grad_data_matches_jax(tiny, name):
    """The act pass's Fisher grads (W4A8 capture of the unit's output,
    KL of the FP model's output) over the 16 samples in batches of 8."""
    got = save_grad_data(tiny["tm"], tiny["tq"], name, _t(tiny["xs"]),
                         _t(tiny["ts"]), act_quant=True, batch_size=BS)
    want = _jax_grads(tiny, name)
    assert float(got.min()) >= 1.0 and float(got.max()) > 1.0
    _close(got, want, rel=1e-4)


def test_weight_pass_fisher_matches_jax(tiny, monkeypatch):
    """The weight pass with opt_mode fisher_diag on a ResnetBlock: the
    port's Fisher grads of its W4 output (act_quant False) against JAX's,
    then reconstruct_unit on the asym captures with JAX's grads and
    minibatch indices: after 32 iterations the alphas within 1e-4 of the
    largest |alpha| (test_torch_calib.py's bound)."""
    jm, tm, name = tiny["jm"], tiny["tm"], "mid.block_1"
    want = np.asarray(jax_grad_data(
        jm, tiny["params"], tiny["jq"], name, jnp.asarray(tiny["xs"]),
        jnp.asarray(tiny["ts"]), act_quant=False, batch_size=BS))
    _close(save_grad_data(tm, tiny["tq"], name, _t(tiny["xs"]),
                          _t(tiny["ts"]), batch_size=BS), want, rel=1e-4)
    jinps, jout = jax_capture(jm, tiny["params"], tiny["jq"], name,
                              jnp.asarray(tiny["xs"]),
                              jnp.asarray(tiny["ts"]), asym=True,
                              batch_size=BS)
    key = jax.random.PRNGKey(7)
    idx = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (BS,), 0, jout.shape[0]))
        for i in range(ITERS)])
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n_, bs, gen: _t(idx[i]))
    q = reconstruct_unit(tm, tiny["tq"], _unit(tm, name),
                         tuple(_nchw(a) for a in jinps), _nchw(jout),
                         ReconConfig(iters=ITERS, batch_size=BS,
                                     opt_mode="fisher_diag"),
                         cached_grads=_nchw(want))
    jq = _to_port(jax_reconstruct(
        jm, tiny["params"], tiny["jq"], _unit(jm, name), jinps, jout,
        JaxReconConfig(iters=ITERS, batch_size=BS, opt_mode="fisher_diag"),
        rng=key, cached_grads=jnp.asarray(want)))
    for site in _unit(tm, name).layer_names:
        got, ref = q[site]["w"]["alpha"], jq[site]["w"]["alpha"]
        assert not torch.equal(ref, tiny["tq"][site]["w"]["alpha"])
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, (site, err)


# -- the act-delta reconstruction ------------------------------------------

def test_cosine_schedule_matches_optax_inside_the_loop(tiny, monkeypatch):
    """cosine_lr against optax.cosine_decay_schedule(lr, iters, 0), and the
    learning rate each Adam step of an act reconstruction really took
    (read at opt.step): update k uses the schedule at k."""
    lr, iters = 4e-4, 16
    sched = optax.cosine_decay_schedule(lr, iters, alpha=0.0)
    for k in (0, 1, iters // 2, iters - 1):
        assert abs(cosine_lr(lr, iters, k) - float(sched(k))) <= 1e-7 * lr
    assert cosine_lr(lr, iters, 0) == lr
    taken = []
    real = torch.optim.Adam.step

    def step(self, *a, **kw):
        taken.append(self.param_groups[0]["lr"])
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    jinps, jout = jax_capture(tiny["jm"], tiny["params"], tiny["jq"],
                              "conv_in", jnp.asarray(tiny["xs"]),
                              jnp.asarray(tiny["ts"]), batch_size=BS)
    reconstruct_unit(tiny["tm"], tiny["tq"], _unit(tiny["tm"], "conv_in"),
                     tuple(_nchw(a) for a in jinps), _nchw(jout),
                     ReconConfig(iters=iters, batch_size=BS, lr=lr, p=2.4),
                     act_quant=True)
    np.testing.assert_allclose(taken, [float(sched(k)) for k in
                                       range(iters)], rtol=0, atol=1e-7 * lr)


SPREAD_RUNS = 4  # JAX runs on inputs with 2e-6 relative noise


def _noise(a, seed):
    """1 for seed 0; else 1 + 2e-6 N(0, 1) elementwise, the size of the two
    packages' disagreement in an FP forward."""
    if seed == 0:
        return 1.0
    return jnp.asarray(1.0 + 2e-6 * np.random.default_rng(seed)
                       .standard_normal(a.shape).astype(np.float32))


# one unit of each kind: dense, conv, the stride-2 conv, a ResnetBlock,
# attention (its q/k/v/sm deltas beside its layers'), a split up block
ACT_UNITS = ("temb.dense.1", "conv_in", "down.0.downsample.conv",
             "mid.block_1", "down.1.attn.0", "up.1.block.0")


@pytest.mark.parametrize("name,opt_mode",
                         [(n, "mse") for n in ACT_UNITS]
                         + [("mid.block_1", "fisher_diag")])
def test_act_reconstruct_unit_matches_jax_with_its_indices(
        tiny, name, opt_mode, monkeypatch):
    """reconstruct_unit(act_quant=True) on the unit's FP captures, with the
    minibatches JAX draws (randint(fold_in(key, i), (bs,), 0, n),
    recon.py:382-383) in place of the port's; fisher_diag with JAX's
    Fisher grads for both.

    A delta's gradient is a sum of rounding residuals that cancel, so an
    activation that lands in another bucket moves it, and Adam's steps
    (lr x the gradient's sign at first) carry that on. JAX run again on
    its own inputs with 2e-6 relative noise (the size of the two
    packages' FP disagreement; SPREAD_RUNS seeds) moves the ResnetBlocks'
    deltas by up to 4.8e-2 after 32 iterations. So each delta is held to
    1e-4 relative or to four times JAX's own spread there, whichever is
    larger (the port's largest gap to it is 2.9 times, fisher_diag's
    temb_proj/a); the layer and attention units stay within 1e-4."""
    jm, tm = tiny["jm"], tiny["tm"]
    jinps, jout = jax_capture(jm, tiny["params"], tiny["jq"], name,
                              jnp.asarray(tiny["xs"]),
                              jnp.asarray(tiny["ts"]), batch_size=BS)
    key = jax.random.PRNGKey(7)
    n = jout.shape[0]
    idx = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (BS,), 0, n)) for i in range(ITERS)])
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n_, bs, gen: _t(idx[i]))
    grads = None if opt_mode == "mse" else _jax_grads(tiny, name)
    q = reconstruct_unit(
        tm, tiny["tq"], _unit(tm, name), tuple(_nchw(a) for a in jinps),
        _nchw(jout), ReconConfig(iters=ITERS, batch_size=BS, p=2.4,
                                 opt_mode=opt_mode),
        act_quant=True, cached_grads=None if grads is None else _nchw(grads))
    runs = [_to_port(jax_reconstruct(
        jm, tiny["params"], tiny["jq"], _unit(jm, name),
        tuple(a * _noise(a, seed) for a in jinps), jout,
        JaxReconConfig(iters=ITERS, batch_size=BS, p=2.4, opt_mode=opt_mode),
        act_quant=True, rng=key,
        cached_grads=None if grads is None else jnp.asarray(grads)))
        for seed in range(SPREAD_RUNS + 1)]
    jq = runs[0]
    trained = [(s, k) for s, sl in recon.extract_trainable(
        tiny["tq"], _unit(tm, name), "act").items() for k in sl]
    assert trained
    worst = 0.0
    for site, slot in trained:
        got, want = q[site][slot]["delta"], jq[site][slot]["delta"]
        start = tiny["tq"][site][slot]["delta"]
        assert got.dtype == torch.float32 and not torch.equal(want, start)
        err = float(((got - want).abs() / want.abs()).max())
        spread = max(float(((r[site][slot]["delta"] - want).abs()
                            / want.abs()).max()) for r in runs[1:])
        assert err <= max(1e-4, 4.0 * spread), (site, slot, err, spread)
        worst = max(worst, err)
        print(f"  {site}/{slot}: {err:.2e}, JAX's spread {spread:.2e}")
        assert torch.equal(q[site][slot]["zero_point"],
                           jq[site][slot]["zero_point"])
    print(f"{name} {opt_mode}: {len(trained)} deltas within {worst:.2e} "
          "relative of JAX's")


# -- the whole activation pass --------------------------------------------

def _act_block_mse(unit, qstate, inps, out):
    with torch.no_grad():
        pred = unit.apply(QuantCtx(qstate, mode=WA), *inps)
    return float(torch.mean((pred - out) ** 2))


def test_calibrate_act_pass_loads_in_jax_and_samples_close(tiny, tmp_path,
                                                           monkeypatch):
    """Both passes over every unit with the running-stat sweep; the act
    init takes the rows JAX's calibrate draws (its key split once per
    weight unit, then jax.random.choice without replacement)."""
    jm, tm, params = tiny["jm"], tiny["tm"], tiny["params"]
    n_w = sum(1 for u in tm.units if u.layer_names)
    rng = jax.random.PRNGKey(0)
    for _ in range(n_w):
        rng, _ = jax.random.split(rng)
    _, sub = jax.random.split(rng)
    rows = np.asarray(jax.random.choice(sub, 16, (BS,), replace=False))
    monkeypatch.setattr(engine, "_act_init_indices",
                        lambda n, k, gen: _t(rows))
    errs, untrainable = {}, {}
    real = engine.reconstruct_unit

    def spy(model, qstate, unit, inps, out, cfg, **kw):
        new = real(model, qstate, unit, inps, out, cfg, **kw)
        if kw.get("act_quant"):
            small = recon.deltas_below_lr(qstate, unit, cfg.lr)
            (untrainable if small else errs)[unit.name] = (
                _act_block_mse(unit, qstate, inps, out),
                _act_block_mse(unit, new, inps, out), small)
        return new

    monkeypatch.setattr(engine, "reconstruct_unit", spy)
    cfg = CalibConfig(weight=ReconConfig(iters=8, batch_size=BS),
                      act=ReconConfig(iters=16, batch_size=BS, p=2.4),
                      quant_act=True, running_stat=True, capture_batch=BS,
                      act_init_batch=BS)
    q = calibrate(tm, (_t(tiny["xs"]), _t(tiny["ts"])), cfg,
                  torch.Generator().manual_seed(0))
    assert sorted([*errs, *untrainable]) == sorted(u.name for u in tm.units)
    # the attention units' post-softmax deltas (about 1e-4: a flat softmax
    # over 64 tokens) are below the lr; Adam's first step overshoots them,
    # JAX's as much as the port's (test_act_reconstruct_unit_matches_jax_
    # with_its_indices[down.1.attn.0-mse]), so the bound holds elsewhere
    assert sorted(untrainable) == sorted(
        u.name for u in tm.units if u.kind == "attn")
    assert all(slots == [(n, "sm")] for n, (_, _, slots)
               in untrainable.items())
    print("act block error ratios after/before: worst "
          f"{max(a / b for b, a, _ in errs.values()):.4f}, sums "
          f"{sum(b for b, _, _ in errs.values()):.5g} -> "
          f"{sum(a for _, a, _ in errs.values()):.5g}; attention "
          + ", ".join(f"{a / b:.1f}" for b, a, _ in untrainable.values()))
    for name, (before, after, _) in errs.items():
        assert after <= 1.02 * before, (name, before, after)

    path = tmp_path / "qstate.npz"
    save_qstate(path, q)
    jq = jax_load_qstate(path)
    assert float(jq["mid.attn_1"]["sm"]["delta"]) == float(
        q["mid.attn_1"]["sm"]["delta"])
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = make_skip_sequence(100, 4, "uniform")
    x0 = np.random.default_rng(4).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    mode = JaxMode(w=True, a=True)
    want, _ = jax_ddim(jax.jit(lambda x, t: jm.apply(
        params, x, t, JaxCtx(jq, mode=mode))), jnp.asarray(x0), seq,
        np.asarray(betas))
    step = make_quantized_step(tm, q, engine="sim")
    with torch.no_grad():
        got = ddim_sample(step, _t(x0), seq, betas)
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    print(f"sim W4A8 DDIM-4 with the port's qstate, port vs JAX: relative "
          f"L2 {rel:.2e}")
    assert np.isfinite(got.numpy()).all() and rel <= 5e-2, rel
