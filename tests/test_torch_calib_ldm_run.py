"""Whole calibrations of the latent models in the port, held against the
JAX package: SD_TINY (test_torch_unet_ldm.py) calibrated W4A8 on
conditional data by the port, its qstates in JAX, and crash-and-resume
across the two packages' run directories. Models, data and helpers are
test_torch_calib_ldm.py's; f32 on the CPU.

Tolerances:
  * each unit's block error after its reconstruction at most 1.02x its
    starting error on its captured inputs (weight pass: nearest
    rounding; act pass: its init/EMA deltas, for units with no trained
    delta below the lr), the sums lower;
  * the port's calibrated W4 qstate in JAX: fold forward within 1e-6
    relative L2 of the port's, or within 1.25x the FP forwards' own gap
    on the same inputs where that is larger (1.19e-6 on SD_TINY: f32 sum
    order, blockwise or materialized attention alike; ROADMAP §C);
  * its W4A8 qstate round-trips through the JAX files bit for bit, and
    the JAX sim forward with it holds every activation quantizer within
    one bucket beyond its input's drift (test_torch_unet_quant.py's
    bound);
  * sites restored from a snapshot bit-equal to the files.
"""

import json

import numpy as np
import pytest
import torch

import jax

from qdiffusion_tpu.calib import engine as jax_engine
from qdiffusion_tpu.calib.engine import CalibConfig as JaxCalibConfig
from qdiffusion_tpu.calib.recon import ReconConfig as JaxReconConfig
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
from qdiffusion_tpu.quant.context import QuantMode as JaxMode
from qdiffusion_tpu.utils.checkpoints import \
    CalibCheckpointer as JaxCheckpointer
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate
from qdiffusion_tpu.utils.checkpoints import save_qstate as jax_save_qstate

from qdiffusion_torch.calib import engine, recon
from qdiffusion_torch.calib.engine import CalibConfig, calibrate
from qdiffusion_torch.calib.recon import ReconConfig
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.utils.checkpoints import CalibCheckpointer, \
    load_qstate, save_qstate

from test_torch_calib import _t
from test_torch_calib_ldm import BS, WA, _data, _jx, _pair, _tx

torch.set_num_threads(1)


# -- whole calibrations --------------------------------------------------------

def _mse(unit, qstate, inps, out, mode):
    with torch.no_grad():
        pred = unit.apply(QuantCtx(qstate, mode=mode), *inps)
    return float(torch.mean((pred - out) ** 2))


def _nearest(qstate, unit):
    return {s: ({k: {n: v for n, v in st.items() if n != "alpha"}
                 for k, st in sl.items()} if s in unit.layer_names else sl)
            for s, sl in qstate.items()}


@pytest.fixture(scope="module")
def sd_calibrated():
    """The port's W4A8 calibration of SD_TINY (16 rows, cond contexts;
    8 weight and 8 act iterations a unit, running-stat EMA), with every
    unit's block errors before and after, and the weight pass's qstate."""
    jm, tm, params = _pair("sd")
    xs, ts, cs = _tx(*_data("sd"))
    errs = {"weight": {}, "act": {}}
    real = engine.reconstruct_unit
    kept = {}

    def spy(model, qstate, unit, inps, out, cfg, **kw):
        new = real(model, qstate, unit, inps, out, cfg, **kw)
        if kw.get("act_quant"):
            small = recon.deltas_below_lr(qstate, unit, cfg.lr)
            errs["act"][unit.name] = (_mse(unit, qstate, inps, out, WA),
                                      _mse(unit, new, inps, out, WA), small)
        else:
            mode = QuantMode(w=True)
            errs["weight"][unit.name] = (
                _mse(unit, _nearest(new, unit), inps, out, mode),
                _mse(unit, new, inps, out, mode), [])
            kept["weight"] = new
        return new

    engine.reconstruct_unit = spy
    try:
        q = calibrate(tm, (xs, ts, cs), CalibConfig(
            weight=ReconConfig(iters=8, batch_size=BS),
            act=ReconConfig(iters=8, batch_size=BS, p=2.4), quant_act=True,
            running_stat=True, capture_batch=BS, act_init_batch=BS),
            torch.Generator().manual_seed(0))
    finally:
        engine.reconstruct_unit = real
    return dict(jm=jm, tm=tm, params=params, q=q, errs=errs,
                weight_q=kept["weight"])


def test_sd_calibration_lowers_every_block_error(sd_calibrated):
    errs, tm = sd_calibrated["errs"], sd_calibrated["tm"]
    assert list(errs["weight"]) == [u.name for u in tm.units
                                    if u.layer_names]
    assert list(errs["act"]) == [u.name for u in tm.units]
    for what, table in errs.items():
        held = {n: e for n, e in table.items() if not e[2]}
        for name, (before, after, _) in held.items():
            assert after <= 1.02 * before, (what, name, before, after)
        before = sum(e[0] for e in held.values())
        after = sum(e[1] for e in held.values())
        print(f"{what} pass: sum of block errors {before:.5g} -> "
              f"{after:.5g}; below the lr: "
              f"{ {n: e[2] for n, e in table.items() if e[2]} }")
        assert after < before


def test_calibrated_qstates_in_jax(sd_calibrated, tmp_path):
    """The weight pass's W4 qstate: JAX's fold forward with it against the
    port's fold forward, 1e-6 relative L2. The W4A8 qstate: port file ->
    JAX load -> JAX file -> port load bit for bit, and the sim forwards
    held per activation quantizer to one bucket beyond the input's
    drift."""
    jm, tm, params = (sd_calibrated[k] for k in ("jm", "tm", "params"))
    xs, ts, cs = _data("sd", n=2, seed=1)
    save_qstate(tmp_path / "w4.npz", sd_calibrated["weight_q"])
    apply = jax.jit(lambda p, x, t, c: jm.apply(p, x, t, context=c))
    rel = {}
    for what, p, step in (
            ("fp", params, lambda *a: tm(a[0], a[1], None, a[2])),
            ("fold", jax_fold(jm, params, jax_load_qstate(
                tmp_path / "w4.npz")), make_quantized_step(
                tm, sd_calibrated["weight_q"], engine="fold"))):
        want = np.asarray(apply(p, *_jx(xs, ts, cs)))
        with torch.no_grad():
            got = step(*_tx(xs, ts, cs)).numpy()
        rel[what] = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"fold W4 with the port's calibrated qstate: rel L2 "
          f"{rel['fold']:.3g} (FP forwards: {rel['fp']:.3g})")
    assert rel["fold"] <= max(1e-6, 1.25 * rel["fp"]), rel

    q = sd_calibrated["q"]
    save_qstate(tmp_path / "w4a8.npz", q)
    jq = jax_load_qstate(tmp_path / "w4a8.npz")
    jax_save_qstate(tmp_path / "back.npz", jq)
    back = load_qstate(tmp_path / "back.npz")
    assert sorted(back) == sorted(q)
    for site, slots in q.items():
        for slot, st in slots.items():
            for leaf, a in st.items():
                assert torch.equal(back[site][slot][leaf], a), (site, slot)
    sites = []

    class _JaxRec(JaxCtx):  # the sites while jit traces, the values out
        def act_quant(self, name, slot, x, spec):
            y = super().act_quant(name, slot, x, spec)
            sites.append((name, slot))
            self.rec.append((x, y))
            return y

    def run(p, q, x, t, c):
        ctx = _JaxRec(q, mode=JaxMode(w=True, a=True))
        ctx.rec = []
        jm.apply(p, x, t, ctx, context=c)
        return ctx.rec

    jrec = [(n, s, np.asarray(x), np.asarray(y)) for (n, s), (x, y) in zip(
        sites, jax.jit(run)(params, jq, *_jx(xs, ts, cs)))]

    class _Rec(QuantCtx):
        def act_quant(self, name, slot, x, spec):
            y = super().act_quant(name, slot, x, spec)
            self.rec.append((name, slot, x, y))
            return y

    tctx = _Rec(back, mode=WA)
    tctx.rec = []
    with torch.no_grad():
        tm(*_tx(xs, ts), tctx, _t(cs))
    assert [r[:2] for r in tctx.rec] == [r[:2] for r in jrec]
    flips = 0
    for (n, s, xj, qj), (_, _, xt, qt) in zip(jrec, tctx.rec):
        if xt.ndim == 4 and xt.shape != xj.shape:  # NCHW image inputs
            xt, qt = xt.permute(0, 2, 3, 1), qt.permute(0, 2, 3, 1)
        xt, qt = xt.numpy(), qt.numpy()
        delta = float(np.max(jq[n][s]["delta"]))
        bound = np.abs(xt - xj) + delta * (1 + 1e-5)
        assert np.all(np.abs(qt - qj) <= bound), f"{n}/{s}"
        flips += int((np.abs(qt - qj) > delta / 2).sum())
    print(f"sim W4A8 with the port's calibrated qstate: {flips} bucket "
          f"flips over {len(jrec)} quantizers")


# -- resume --------------------------------------------------------------------

class Crash(RuntimeError):
    pass


def _crash_after(monkeypatch, mod, n):
    real, calls = mod.reconstruct_unit, []

    def crashing(*a, **kw):
        if len(calls) == n:
            raise Crash("simulated crash")
        calls.append(a[2 if mod is engine else 3].name)
        return real(*a, **kw)

    monkeypatch.setattr(mod, "reconstruct_unit", crashing)
    return calls


RESUME_CFG = dict(capture_batch=4, act_init_batch=4, ckpt_every=2)


def _resume_cfg(**kw):
    return CalibConfig(weight=ReconConfig(iters=2, batch_size=4),
                       act=ReconConfig(iters=4, batch_size=4, p=2.4),
                       **RESUME_CFG, **kw)


def test_sd_crash_and_resume_restores_the_transformer_sites(tmp_path,
                                                            monkeypatch):
    """A crash in the act pass just after the first transformer block's
    snapshot: the resumed run restores that unit's attn1 / attn2 deltas
    as the crashed run trained them (the increments carry every site a
    unit trains), runs only the units after the marker, and JAX's
    checkpointer loads the same directory leaf for leaf."""
    _, tm, _ = _pair("sd")
    data = _tx(*_data("sd", n=8))
    names = [u.name for u in tm.units]
    k = names.index("input_blocks.3.1.transformer_blocks.0")
    assert (k + 1) % RESUME_CFG["ckpt_every"] == 0
    n_w = sum(1 for u in tm.units if u.layer_names)
    real = engine.reconstruct_unit
    trained = {}

    def keep(model, qstate, unit, *a, **kw):
        new = real(model, qstate, unit, *a, **kw)
        if kw.get("act_quant"):
            trained.update({s: new[s] for s in unit.extra_sites})
        return new

    monkeypatch.setattr(engine, "reconstruct_unit", keep)
    _crash_after(monkeypatch, engine, n_w + k + 1)
    with pytest.raises(Crash):
        calibrate(tm, data, _resume_cfg(quant_act=True, running_stat=True),
                  checkpointer=CalibCheckpointer(tmp_path))
    progress = json.loads((tmp_path / "calib_progress.json").read_text())
    assert progress["phase"] == "act" and progress["unit_idx"] == k
    got, jprogress = JaxCheckpointer(tmp_path).load()
    assert jprogress == progress
    snap, _ = CalibCheckpointer(tmp_path).load()
    assert sorted(got) == sorted(snap)
    for site in trained:
        for slot, st in trained[site].items():
            for leaf, a in st.items():
                assert torch.equal(snap[site][slot][leaf], a), (site, slot)
                np.testing.assert_array_equal(
                    np.asarray(got[site][slot][leaf]), a.numpy())

    calls = []
    monkeypatch.setattr(engine, "reconstruct_unit",
                        lambda *a, **kw: calls.append(a[2].name)
                        or real(*a, **kw))
    q = calibrate(tm, data, _resume_cfg(quant_act=True, running_stat=True),
                  checkpointer=CalibCheckpointer(tmp_path))
    assert calls == names[k + 1:]
    for site in trained:
        for slot, st in trained[site].items():
            assert torch.equal(q[site][slot]["delta"], st["delta"])
    assert not (tmp_path / "calib_progress.json").exists()


def test_port_resumes_a_jax_sd_run(tmp_path, monkeypatch):
    """The JAX engine's weight pass on SD_TINY (cond data) crashes after 2
    units; the port resumes its directory from the marker with the
    contexts, reconstructs only the rest, and keeps the restored sites
    bit-equal to JAX's snapshot."""
    jm, tm, params = _pair("sd")
    xs, ts, cs = _data("sd", n=8)
    _crash_after(monkeypatch, jax_engine, 2)
    with pytest.raises(Crash):
        jax_engine.calibrate(
            jm, params, _jx(xs, ts, cs), JaxCalibConfig(
                weight=JaxReconConfig(iters=2, batch_size=4), precompile=0,
                **RESUME_CFG), rng=jax.random.PRNGKey(1),
            checkpointer=JaxCheckpointer(tmp_path))
    progress = json.loads((tmp_path / "calib_progress.json").read_text())
    assert progress["phase"] == "weight" and progress["unit_idx"] == 1
    snap, _ = CalibCheckpointer(tmp_path).load()
    calls = []
    real = engine.reconstruct_unit
    monkeypatch.setattr(engine, "reconstruct_unit",
                        lambda *a, **kw: calls.append(a[2].name)
                        or real(*a, **kw))
    q = calibrate(tm, _tx(xs, ts, cs), _resume_cfg(),
                  checkpointer=CalibCheckpointer(tmp_path))
    assert calls == [u.name for u in tm.units[2:] if u.layer_names]
    for site in ("time_embed.0", "time_embed.2"):
        for leaf, a in snap[site]["w"].items():
            assert torch.equal(q[site]["w"][leaf], a), (site, leaf)
    assert all("alpha" in q[n]["w"] for n in tm.layer_cfgs)
