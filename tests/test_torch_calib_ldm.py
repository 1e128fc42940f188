"""Calibration of the latent models, the port against the JAX package, on
the tiny UNets of test_torch_unet_ldm.py: SD_TINY (spatial transformers,
a 7 x 24 context) and BEDS_TINY (legacy AttentionBlocks; the registry
also CHURCH_TINY's, with its resblock up/down units) with and
without act_quant_partition, f32 on the CPU, flash_threshold 16 so the
64-token self-attentions could take the blockwise path. Params are numpy
draws handed to both packages; both start from one qstate (JAX's weight
init, AdaRound alphas on every unit, act init from 8 rows), moved to the
port's layout.

Tolerances (those of test_torch_calib.py and test_torch_calib_act.py):
  * the LDM trajectory (DDIM with CFG, PLMS with CFG) and
    get_train_samples(cond=True): 1e-5 of each array's largest magnitude
    (CFG 7.5 scales the UNets' f32 sum-order differences by 7.5);
  * FP, asym and grouped captures with the context: 1e-4 of the largest
    magnitude;
  * unit list, kinds, layer sites, extra sites, loss axes and the qstate
    keys of the weight and act inits: equal to JAX's (a loss axis -1 of
    an NHWC output is 1 of the port's NCHW one);
  * Fisher grads of a transformer block with the contexts: 1e-4 of the
    largest |g| on JAX's own W4A8 capture of the unit's output (from the
    port's own capture 2.8e-4: bucket flips, test_torch_calib_act.py);
  * reconstruct_unit with JAX's minibatch indices, 32 iterations: weight
    pass alphas within 3.7e-6 of the largest |alpha|, or within four
    times JAX's own spread under 2e-6 relative input noise where that is
    larger, and no hard rounding flipped; act pass deltas within 1e-4
    relative or four times that spread, where larger.

Whole calibrations and resume are in test_torch_calib_ldm_run.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.capture import GroupedCapture as JaxGrouped
from qdiffusion_tpu.calib.capture import capture_unit_io as jax_capture
from qdiffusion_tpu.calib.engine import init_act_qstate as jax_init_act
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.calib.fisher import save_grad_data as jax_grad_data
from qdiffusion_tpu.calib.recon import ReconConfig as JaxReconConfig
from qdiffusion_tpu.calib.recon import init_adaround_unit as jax_init_alpha
from qdiffusion_tpu.calib.recon import reconstruct_unit as jax_reconstruct
from qdiffusion_tpu.calib.samples import get_train_samples as jax_samples
from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.models.unet_ldm import LDMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ldm import LDMUNetConfig as JaxConfig
from qdiffusion_tpu.pipelines import LatentDiffusionPipeline as JaxPipeline
from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
from qdiffusion_tpu.quant.context import QuantMode as JaxMode
from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule

from qdiffusion_torch.calib import fisher, recon
from qdiffusion_torch.calib.capture import GroupedCapture, capture_unit_io
from qdiffusion_torch.calib.engine import init_act_qstate, \
    init_weight_qstate
from qdiffusion_torch.calib.fisher import save_grad_data
from qdiffusion_torch.calib.recon import ReconConfig, reconstruct_unit
from qdiffusion_torch.calib.samples import get_train_samples
from qdiffusion_torch.config import QuantFlags
from qdiffusion_torch.convert import from_jax_params, qstate_from_jax
from qdiffusion_torch.models.unet_ldm import LDMUNet, LDMUNetConfig
from qdiffusion_torch.ops import flash_attention
from qdiffusion_torch.pipelines import LatentDiffusionPipeline
from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.schedules import NoiseSchedule

from test_torch_calib import _close, _nchw, _t
from test_torch_calib_act import SPREAD_RUNS, _noise
from test_torch_unet_ldm import CONFIGS, random_tree

torch.set_num_threads(1)

ITERS = 32
BS = 8  # reconstruction minibatch, capture batch and act-init rows
N = 16  # calibration rows
WA = QuantMode(w=True, a=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, partition=False, **flags):
    """(jax model, port model, numpy params) of a tiny config, W4A8 policy
    with the 'max' act init (--a-min-max), which keeps JAX's compiles
    short; test_torch_unet_ldm.py holds the 'mse' one."""
    flags = {"weight_bit": 4, "quant_act": True, "a_min_max": True,
             **flags}
    cfg = CONFIGS[name]
    jm = JaxUNet(JaxConfig(**cfg), JaxFlags(**flags).policy_ldm(),
                 act_quant_partition=partition, flash_threshold=16)
    tm = LDMUNet(LDMUNetConfig(**cfg), QuantFlags(**flags).policy_ldm(),
                 act_quant_partition=partition, flash_threshold=16,
                 device="cpu")
    params = random_tree(jax.eval_shape(jm.init_params,
                                        jax.random.PRNGKey(0)), 0)
    tm.load_state_dict(from_jax_params(params))
    return jm, tm, params


def _data(name, n=N, seed=5):
    """n seeded rows (x, t and, for sd, a (7, 24) context)."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, 16, 16, CONFIGS[name]["in_channels"])
                             ).astype(np.float32)
    ts = np.linspace(0, 999, n).astype(np.float32)
    cs = rng.standard_normal((n, 7, 24)).astype(np.float32) \
        if name == "sd" else None
    return xs, ts, cs


def _jx(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _tx(*arrays):
    return tuple(None if a is None else _t(a) for a in arrays)


def _jax_init_w(jm, params):
    return jax.jit(lambda p: jax_init_w(jm, p))(params)


def _setup(name, partition=False):
    jm, tm, params = _pair(name, partition)
    xs, ts, cs = _data(name)

    def alphas(p, q):
        for unit in jm.units:
            if unit.layer_names:
                q = jax_init_alpha(jm, p, q, unit)
        return q

    jq = jax.jit(alphas)(params, _jax_init_w(jm, params))
    jq = _np(jax_init_act(jm, params, jq, *_jx(xs[:BS], ts[:BS],
                                                None if cs is None
                                                else cs[:BS])))
    return dict(jm=jm, tm=tm, params=params, xs=xs, ts=ts, cs=cs, jq=jq,
                tq=qstate_from_jax(jq), grads={})


@pytest.fixture(scope="module")
def sd():
    return _setup("sd")


@pytest.fixture(scope="module")
def beds():
    """BEDS_TINY with the act-quant partition."""
    return _setup("beds", partition=True)


def _unit(model, name):
    return next(u for u in model.units if u.name == name)


MATMUL = ("qkmatmul", "smvmatmul")  # same (B, T, H, c) / (B, H, T, S) layout


def _port(a, kind="layer"):
    """A JAX capture in the port's layout: NHWC images move to NCHW; the
    attention operands of the matmul units keep theirs."""
    if kind in MATMUL:
        return torch.from_numpy(np.asarray(a).copy())
    return _nchw(a)


def _within(got: torch.Tensor, want, rel: float, kind="layer"):
    """max |got - want| <= rel x max |want|, in the port's layout."""
    if kind in MATMUL or np.ndim(want) != 4:
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())
    else:
        _close(got, want, rel=rel)


# -- the registry ---------------------------------------------------------

@pytest.mark.parametrize("name,partition", [("sd", False), ("sd", True),
                                            ("beds", False),
                                            ("beds", True),
                                            ("church", False),
                                            ("church", True)])
def test_units_sites_and_qstate_keys_match_jax(name, partition):
    """The reconstruction units in JAX's order with its kinds, layer
    sites, takes_temb, extra sites and loss axes; the layer sites; and
    the qstate keys of the weight init and of the act init (site and
    slot, set for set). The partition changes only the AttentionBlocks:
    four units, with the attention quantizers at the qkv_matmul and
    smv_matmul sites."""
    jm, tm, params = _pair(name, partition)
    assert [(u.name, u.kind, u.layer_names, u.takes_temb, u.extra_sites)
            for u in tm.units] == [
        (u.name, u.kind, u.layer_names, u.takes_temb, u.extra_sites)
        for u in jm.units]
    assert list(tm.layer_cfgs) == list(jm.layer_cfgs)
    xs, ts, cs = _data(name, n=2)
    names = tuple(u.name for u in tm.units)
    ctx = QuantCtx(capture=frozenset(names))
    with torch.no_grad():
        tm(*_tx(xs, ts), ctx, *([] if cs is None else [_t(cs)]))
    assert set(ctx.captured) == set(names)
    for tu, ju in zip(tm.units, jm.units):
        nchw = ctx.captured[tu.name]["out"].ndim == 4 and ju.loss_axis == -1
        assert tu.loss_axis == (1 if nchw else ju.loss_axis), tu.name
        assert tu.apply is not None
    # the JAX inits traced only (eval_shape): their keys, no compile
    jq = jax.eval_shape(lambda p: jax_init_w(jm, p), params)
    tq = init_weight_qstate(tm)
    assert {s: set(v) for s, v in tq.items()} == {s: set(v)
                                                   for s, v in jq.items()}
    ja = jax.eval_shape(lambda p, q, x, t, c: jax_init_act(jm, p, q, x, t, c),
                        params, jq, *_jx(xs, ts, cs))
    ta = init_act_qstate(tm, tq, *_tx(xs, ts, cs))
    assert {s: set(v) for s, v in ta.items()} == {s: set(v)
                                                   for s, v in ja.items()}
    attn = {s for s, v in ta.items() if "sm" in v}
    if name != "sd" and partition:
        assert attn == {u.name for u in tm.units if u.kind == "smvmatmul"}
        assert all(set(ta[s.replace("smv", "qkv")]) == {"q", "k"}
                   for s in attn)
    assert len(attn) == {"sd": 8, "beds": 4, "church": 4}[name]


# -- the two repairs ----------------------------------------------------------

def test_captures_and_substitutes_never_take_the_flash_path(sd,
                                                            monkeypatch):
    """JAX's rule (unet_ldm.py:159-163): a capture sweep and a forward
    with a substituted unit materialize attention. At flash_threshold 16
    an FP forward of SD_TINY reaches B2's plain version four times (the
    64-token self-attentions); a grouped capture of every unit, an asym
    capture and a substitute forward reach it never, and the captures
    equal JAX's."""
    seen = []
    real = flash_attention.flash_attention_plain

    def spy(*a, **kw):
        seen.append(a[1].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(flash_attention, "flash_attention_plain", spy)
    tm, xs, ts, cs = sd["tm"], *_tx(sd["xs"], sd["ts"], sd["cs"])
    with torch.no_grad():
        tm(xs[:2], ts[:2], None, cs[:2])
    assert seen == [64] * 4
    seen.clear()
    names = tuple(u.name for u in tm.units)
    got = GroupedCapture(tm, batch_size=BS).fp_capture(names, xs, ts, cs)
    unit = "input_blocks.3.1.transformer_blocks.0"
    inps = capture_unit_io(tm, sd["tq"], unit, xs, ts, cs, asym=True,
                           batch_size=BS)[0]
    with torch.no_grad():
        tm(xs[:2], ts[:2], QuantCtx(substitute={unit: got[unit][1][:2]}),
           cs[:2])
    assert seen == []
    want = JaxGrouped(sd["jm"], batch_size=BS).fp_capture(
        sd["params"], names, *_jx(sd["xs"], sd["ts"], sd["cs"]))
    for name in names:
        for a, b in zip(got[name][0], want[name][0]):
            _close(a, b)
        _close(got[name][1], want[name][1])
    jinps, _ = jax_capture(sd["jm"], sd["params"], sd["jq"], unit,
                           *_jx(sd["xs"], sd["ts"], sd["cs"]), asym=True,
                           batch_size=BS)
    for a, b in zip(inps, jinps):
        _close(a, b)


class _Reads(QuantCtx):
    """Records every quantizer state the forward reads."""

    def _get(self, name, slot):
        st = super()._get(name, slot)
        if st is not None:
            self.reads.add((name, slot))
        return st


class _JaxReads(JaxCtx):
    def _get(self, name, slot):
        st = super()._get(name, slot)
        if st is not None:
            self.reads.add((name, slot))
        return st


def test_partitioned_sim_forward_reads_jax_sites(beds):
    """A W4A8 qstate that JAX initialised on the partitioned BEDS_TINY:
    the port's sim forward reads every quantizer state JAX's reads (the
    attention's at {name}.attention.qkv_matmul and .smv_matmul) and
    matches its eps within the LDM sim tolerance of
    test_torch_unet_ldm.py (0.15 absolute, 5e-2 relative L2)."""
    xs, ts, _ = _data("beds", n=2, seed=1)
    reads = set()

    def run(p, q, x, t):  # the reads are recorded while jit traces
        ctx = _JaxReads(q, mode=JaxMode(w=True, a=True))
        ctx.reads = reads
        return beds["jm"].apply(p, x, t, ctx)

    want = np.asarray(jax.jit(run)(beds["params"], beds["jq"],
                                   *_jx(xs, ts)))
    tctx = _Reads(beds["tq"], mode=WA)
    tctx.reads = set()
    with torch.no_grad():
        got = beds["tm"](*_tx(xs, ts), tctx).numpy()
    assert tctx.reads == reads
    assert {s for s, k in reads if k == "sm"} == {
        u.name for u in beds["tm"].units if u.kind == "smvmatmul"}
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"partitioned beds sim W4A8: rel L2 {rel:.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=0.15)
    assert rel <= 5e-2


# -- calibration data -------------------------------------------------------

@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_trajectory_and_cond_samples_match_jax(sd, sampler):
    """The pipeline's trajectory with CFG 7.5 (S entries of the carry and
    t at each step's input; PLMS's double first call is one), the
    contexts broadcast over the steps, and get_train_samples(cond=True):
    the cond rows, then the same samples with the uncond rows."""
    jm, tm, params = sd["jm"], sd["tm"], sd["params"]
    rng = np.random.default_rng(8)
    x0 = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    cond = rng.standard_normal((2, 7, 24)).astype(np.float32)
    uncond = np.repeat(rng.standard_normal((1, 7, 24)).astype(np.float32),
                       2, axis=0)
    steps = 8
    kw = dict(sampler=sampler, steps=steps, guidance_scale=7.5,
              decode=False, return_trajectory=True)
    z, traj = LatentDiffusionPipeline(
        tm, None, NoiseSchedule.ldm("linear", 1000, 0.00085, 0.012)).sample(
        2, cond=_t(cond), uncond=_t(uncond), x_init=_t(x0), **kw)
    jz, jtraj = JaxPipeline(
        jm, None, JaxSchedule.ldm("linear", 1000, 0.00085, 0.012)).sample(
        params, None, 2, cond=jnp.asarray(cond), uncond=jnp.asarray(uncond),
        x_init=jnp.asarray(x0), **kw)
    assert sorted(traj) == sorted(jtraj) == ["cs", "ts", "ucs", "xs"]
    assert traj["xs"].shape == (steps, 2, 16, 16, 4)
    for got, want in ((z, jz), *((traj[k], jtraj[k]) for k in jtraj)):
        _within(got, want, 1e-5, kind=MATMUL[0])  # both NHWC
    got = get_train_samples(traj, cali_n=2, cali_st=4, cond=True)
    want = jax_samples(jtraj, cali_n=2, cali_st=4, cond=True)
    assert len(got) == len(want) == 3 and got[0].shape[0] == 16
    for g, w in zip(got, want):
        _within(g, w, 1e-5, kind=MATMUL[0])
    torch.testing.assert_close(got[2][8:], _t(uncond[:1]).expand(8, -1, -1))


# -- captures with the context ----------------------------------------------

CAPTURED = ("input_blocks.3.1.transformer_blocks.0",
            "output_blocks.1.1.proj_out", "output_blocks.1.0")


@pytest.mark.parametrize("name", CAPTURED)
def test_capture_with_context_matches_jax(sd, name):
    """FP and asym captures of a transformer block (inputs: tokens and the
    (B, 7, 24) context), a proj_out conv and a split-free output
    ResBlock (x, emb)."""
    for asym in (False, True):
        inps, out = capture_unit_io(sd["tm"], sd["tq"], name,
                                    *_tx(sd["xs"], sd["ts"], sd["cs"]),
                                    asym=asym, batch_size=BS)
        jinps, jout = jax_capture(sd["jm"], sd["params"], sd["jq"], name,
                                  *_jx(sd["xs"], sd["ts"], sd["cs"]),
                                  asym=asym, batch_size=BS)
        assert len(inps) == len(jinps)
        for a, b in zip(inps, jinps):
            _close(a, b)
        _close(out, jout)
    if name == CAPTURED[0]:
        assert inps[1].shape == (N, 7, 24)
        torch.testing.assert_close(inps[1], _t(sd["cs"]), rtol=0, atol=0)


def test_fisher_grads_with_context_match_jax(sd):
    """Fisher grads of a transformer block on conditional rows (the W4A8
    capture of its output and the FP model's KL, both with the
    contexts). As in test_torch_calib_act.py, |g| - 1 is about 1e-3 and
    follows the W4A8 capture's rounding buckets, so the KL gradient is
    held on JAX's own capture of the unit's output: the port's _kl_grad
    fed JAX's W4A8 output within 1e-4 of the largest |g| of JAX's
    save_grad_data; the port's whole save_grad_data is printed beside."""
    name = "output_blocks.0.1.transformer_blocks.0"
    x, t, c = (a[:BS] for a in (sd["xs"], sd["ts"], sd["cs"]))
    want = jax_grad_data(sd["jm"], sd["params"], sd["jq"], name,
                         *_jx(x, t, c), act_quant=True, batch_size=BS)

    def capture(p, q, x, t, c):
        ctx = JaxCtx(q, mode=JaxMode(w=True, a=True), capture=name)
        sd["jm"].apply(p, x, t, ctx, context=c)
        return ctx.captured[name]["out"]

    blk = jax.jit(capture)(sd["params"], sd["jq"], *_jx(x, t, c))
    tm, tq = sd["tm"], sd["tq"]
    with torch.no_grad():
        out_fp = tm(*_tx(x, t), QuantCtx(tq), _t(c))
    got = fisher._kl_grad(tm, tq, name, *_tx(x, t), out_fp,
                          _t(np.asarray(blk)), _t(c))
    whole = save_grad_data(tm, tq, name, *_tx(x, t, c), act_quant=True,
                           batch_size=BS)
    assert got.shape == whole.shape == (BS, 64, 64)
    assert float(got.min()) >= 1.0
    own = float(np.abs(whole.numpy() - np.asarray(want)).max())
    print(f"Fisher grads, JAX's capture: within "
          f"{float(np.abs(got.numpy() - np.asarray(want)).max()):.2e}; "
          f"the port's own capture: {own:.2e} (largest |g| "
          f"{float(np.abs(want).max()):.4f})")
    _within(got, want, 1e-4)


# -- reconstruction -----------------------------------------------------------

def _jax_indices(n, iters=ITERS):
    key = jax.random.PRNGKey(7)
    return key, np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (BS,), 0, n)) for i in range(iters)])


def _scaled_qk(jm, unit):
    """JAX's qkv_matmul unit with the 1/sqrt(sqrt(c)) scaling its forward
    applies (unet_ldm.py:462-464) inside the unit, as the port's unit and
    the reference's QuantQKMatMul have it."""
    plan = jm._plans[unit.name[:-len(".attention.qkv_matmul")]]

    def apply(p, ctx, q, k):
        s = 1.0 / np.sqrt(np.sqrt(q.shape[-1]))
        return jm._qk_matmul(ctx, q * s, k * s, plan)

    return dataclasses.replace(unit, apply=apply)


WEIGHT_UNITS = [("sd", "input_blocks.3.1.transformer_blocks.0"),
                ("sd", "output_blocks.1.0"), ("beds", "middle_block.1")]


@pytest.mark.parametrize("model,name", WEIGHT_UNITS)
def test_weight_reconstruct_unit_matches_jax(sd, model, name, monkeypatch):
    """The weight pass on asym captures with JAX's minibatch indices: a
    transformer block (inputs tokens and context, loss over the tokens),
    a ResBlock and an unpartitioned AttentionBlock. The alphas within
    3.7e-6 of the largest |alpha| or four times JAX's own spread under
    2e-6 input noise (its f32 noise through the attention's softmax moves
    Adam's sign-sized steps), no hard rounding flipped."""
    tiny = sd if model == "sd" else _setup("beds")
    jm, tm = tiny["jm"], tiny["tm"]
    data = _jx(tiny["xs"], tiny["ts"], tiny["cs"])
    jinps, jout = jax_capture(jm, tiny["params"], tiny["jq"], name, *data,
                              asym=True, batch_size=BS)
    key, idx = _jax_indices(jout.shape[0])
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n_, bs, gen: _t(idx[i]))
    unit = _unit(tm, name)
    q = reconstruct_unit(tm, tiny["tq"], unit,
                         tuple(_nchw(a) for a in jinps), _nchw(jout),
                         ReconConfig(iters=ITERS, batch_size=BS))
    runs = [qstate_from_jax(_np(jax_reconstruct(
        jm, tiny["params"], tiny["jq"], _unit(jm, name),
        tuple(a * _noise(a, seed) for a in jinps), jout,
        JaxReconConfig(iters=ITERS, batch_size=BS), rng=key)))
        for seed in range(SPREAD_RUNS + 1)]
    worst = spread = 0.0
    n_w = n_flip = 0
    for site in unit.layer_names:
        for slot in ("w", "w0") if tm.layer_cfg(site).split else ("w",):
            got, want = q[site][slot]["alpha"], runs[0][site][slot]["alpha"]
            assert not torch.equal(want, tiny["tq"][site][slot]["alpha"])
            top = want.abs().max()
            worst = max(worst, float((got - want).abs().max() / top))
            spread = max([spread] + [float((r[site][slot]["alpha"] - want)
                                           .abs().max() / top)
                                     for r in runs[1:]])
            n_w += want.numel()
            n_flip += int(((got >= 0) != (want >= 0)).sum())
    print(f"{name}: alphas within {worst:.2e} of the largest (JAX's spread "
          f"{spread:.2e}), {n_flip} of {n_w} hard roundings differ")
    assert worst <= max(3.7e-6, 4.0 * spread) and n_flip == 0, (
        worst, spread, n_flip)


ACT_UNITS = [("sd", "input_blocks.3.1.transformer_blocks.0"),
             ("sd", "output_blocks.1.0"),
             ("beds", "middle_block.1.attention.qkv_matmul"),
             ("beds", "middle_block.1.attention.smv_matmul")]


@pytest.mark.parametrize("model,name", ACT_UNITS)
def test_act_reconstruct_unit_matches_jax(sd, beds, model, name,
                                          monkeypatch):
    """The act pass on FP captures with JAX's indices: a transformer block
    (its layers' input deltas and attn1 / attn2's q, k, v, sm), a
    ResBlock, and the partition's act-only matmul units (q, k over
    (B, H, T, S) summed over the queries; sm, v). Each delta within 1e-4
    relative of JAX's or four times JAX's own spread under 2e-6 input
    noise (test_torch_calib_act.py), whichever is larger."""
    tiny = sd if model == "sd" else beds
    jm, tm = tiny["jm"], tiny["tm"]
    junit = _unit(jm, name)
    if junit.kind == "qkmatmul":
        junit = _scaled_qk(jm, junit)
    jinps, jout = jax_capture(jm, tiny["params"], tiny["jq"], name,
                              *_jx(tiny["xs"], tiny["ts"], tiny["cs"]),
                              batch_size=BS)
    key, idx = _jax_indices(jout.shape[0])
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n_, bs, gen: _t(idx[i]))
    unit = _unit(tm, name)
    inps = tuple(_port(a, unit.kind) for a in jinps)
    with torch.no_grad():  # the unit replays its own capture
        _within(unit.apply(QuantCtx(), *inps), jout, 1e-5, unit.kind)
    cfg = dict(iters=ITERS, batch_size=BS, p=2.4)
    q = reconstruct_unit(tm, tiny["tq"], unit, inps,
                         _port(jout, unit.kind), ReconConfig(**cfg),
                         act_quant=True)
    runs = [qstate_from_jax(_np(jax_reconstruct(
        jm, tiny["params"], tiny["jq"], junit,
        tuple(a * _noise(a, seed) for a in jinps), jout,
        JaxReconConfig(**cfg), act_quant=True, rng=key)))
        for seed in range(SPREAD_RUNS + 1)]
    trained = [(s, k) for s, sl in recon.extract_trainable(
        tiny["tq"], unit, "act").items() for k in sl]
    assert trained
    if unit.kind == "transformer":
        assert {s for s, _ in trained} >= set(unit.extra_sites)
    worst = 0.0
    for site, slot in trained:
        got, want = q[site][slot]["delta"], runs[0][site][slot]["delta"]
        assert not torch.equal(want, tiny["tq"][site][slot]["delta"])
        err = float(((got - want).abs() / want.abs()).max())
        spread = max(float(((r[site][slot]["delta"] - want).abs()
                            / want.abs()).max()) for r in runs[1:])
        assert err <= max(1e-4, 4.0 * spread), (site, slot, err, spread)
        worst = max(worst, err)
    print(f"{name}: {len(trained)} deltas within {worst:.2e} relative of "
          "JAX's")


def test_jax_qk_unit_replays_its_capture_only_with_the_scale(beds):
    """The fault that _scaled_qk works around: JAX's qkv_matmul unit, fed
    its own FP capture, does not give its captured output (it omits the
    scaling its forward applies); with the scaling it does, as the
    port's unit does."""
    jm, name = beds["jm"], "middle_block.1.attention.qkv_matmul"
    jinps, jout = jax_capture(jm, beds["params"], {}, name,
                              *_jx(beds["xs"][:BS], beds["ts"][:BS]),
                              batch_size=BS)
    plain = np.asarray(_unit(jm, name).apply(beds["params"], JaxCtx(),
                                             *jinps))
    fixed = np.asarray(_scaled_qk(jm, _unit(jm, name)).apply(
        beds["params"], JaxCtx(), *jinps))
    jout = np.asarray(jout)
    assert np.abs(plain - jout).max() > 0.1 * np.abs(jout).max()
    np.testing.assert_allclose(fixed, jout, rtol=1e-5, atol=1e-5)
