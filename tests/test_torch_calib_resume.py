"""Resumable calibration in the port (utils/checkpoints.py::
CalibCheckpointer and the engine's ckpt_every cadence), and run
directories shared with the JAX package: a crash mid-pass, then a rerun
on the same directory. The port's counterpart of test_calib_resume.py,
on its tiny W8A8 UNet (no attention but the mid block's), f32 on the
CPU. Sites restored from a snapshot must be bit-equal to the files.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib import engine as jax_engine
from qdiffusion_tpu.calib.engine import CalibConfig as JaxCalibConfig
from qdiffusion_tpu.calib.recon import ReconConfig as JaxReconConfig
from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig
from qdiffusion_tpu.utils.checkpoints import \
    CalibCheckpointer as JaxCheckpointer

from qdiffusion_torch.calib import engine
from qdiffusion_torch.calib.engine import CalibConfig, calibrate
from qdiffusion_torch.calib.recon import ReconConfig
from qdiffusion_torch.config import QuantFlags
from qdiffusion_torch.convert import qstate_to_jax, to_jax_params
from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig
from qdiffusion_torch.utils.checkpoints import CalibCheckpointer, \
    load_qstate

torch.set_num_threads(1)

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
            resolution=16)
FLAGS = dict(weight_bit=8, quant_act=True)
CFG = dict(capture_batch=4, act_init_batch=8, ckpt_every=2)


class Crash(RuntimeError):
    pass


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
            np.linspace(0, 99, 8).astype(np.float32))


def _model():
    m = DDIMUNet(DDIMUNetConfig(**TINY), QuantFlags(**FLAGS).policy_ddim(),
                 device="cpu")
    m.load_state_dict(m.init_params(0))
    return m


def _cfg(**kw):
    return CalibConfig(weight=ReconConfig(iters=4, batch_size=4),
                       act=ReconConfig(iters=2, batch_size=4), **CFG, **kw)


def _crash_after(monkeypatch, mod, n):
    """mod.reconstruct_unit raises on its (n + 1)th call; returns the
    list of calls made."""
    real, calls = mod.reconstruct_unit, []

    def crashing(*a, **kw):
        if len(calls) == n:
            raise Crash("simulated crash")
        calls.append(a[2 if mod is engine else 3].name)
        return real(*a, **kw)

    monkeypatch.setattr(mod, "reconstruct_unit", crashing)
    return calls


def _counting(monkeypatch, real):
    calls = []

    def counting(*a, **kw):
        calls.append(a[2].name)
        return real(*a, **kw)

    monkeypatch.setattr(engine, "reconstruct_unit", counting)
    return calls


def _restored_sites(model, progress) -> list:
    """The sites of the units a resume skips in the marker's phase."""
    return [s for u in model.units[:progress["unit_idx"] + 1]
            for s in [*u.layer_names, u.name]]


def _assert_bit_equal(got: dict, want: dict, sites):
    n = 0
    for site in sites:
        for slot, st in want.get(site, {}).items():
            for leaf, t in st.items():
                assert got[site][slot][leaf].dtype == t.dtype, (site, slot)
                assert torch.equal(got[site][slot][leaf], t), (site, slot,
                                                               leaf)
                n += 1
    assert n > 0


def test_crash_and_resume(tmp_path, monkeypatch):
    """Crash after 5 reconstructions, rerun on the same run dir: fewer
    reconstructions than a whole two-pass run, finalized (no marker, no
    increments), every unit with alphas and act deltas, and the sites
    the rerun skipped bit-equal to the snapshot it resumed from."""
    model, (xs, ts) = _model(), _data()
    real = engine.reconstruct_unit
    _crash_after(monkeypatch, engine, 5)
    with pytest.raises(Crash):
        calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)),
                  _cfg(quant_act=True), checkpointer=CalibCheckpointer(
                      tmp_path))
    progress = json.loads((tmp_path / "calib_progress.json").read_text())
    assert progress == {"phase": "weight", "unit_idx": 3, "n_inc": 2}
    snap, _ = CalibCheckpointer(tmp_path).load()

    calls = _counting(monkeypatch, real)
    q = calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)),
                  _cfg(quant_act=True),
                  checkpointer=CalibCheckpointer(tmp_path))
    n_units = len(model.units)
    assert calls[0] == model.units[4].name
    assert len(calls) == 2 * n_units - 4 < 2 * n_units
    assert not (tmp_path / "calib_progress.json").exists()
    assert not list(tmp_path.glob("qstate_inc_*.npz"))
    for unit in model.units:
        for ln in unit.layer_names:
            assert "alpha" in q[ln]["w"] and "a" in q[ln], ln
    final = load_qstate(tmp_path / "qstate.npz")
    sites = _restored_sites(model, progress)
    _assert_bit_equal(final, {s: {"w": snap[s]["w"]} for s in sites
                              if s in snap}, sites)


def test_port_resumes_a_run_dir_the_jax_engine_crashed_in(tmp_path,
                                                          monkeypatch):
    """The JAX engine (weight pass, same params) crashes after 5
    reconstructions; the port resumes its directory from the marker, and
    the sites it restored are bit-equal to JAX's snapshot."""
    xs, ts = _data()
    jm = JaxUNet(JaxConfig(**TINY), JaxFlags(**FLAGS).policy_ddim())
    model = _model()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    to_jax_params(model.state_dict()))
    jcfg = JaxCalibConfig(weight=JaxReconConfig(iters=4, batch_size=4),
                          precompile=0, **CFG)
    _crash_after(monkeypatch, jax_engine, 5)
    with pytest.raises(Crash):
        jax_engine.calibrate(jm, params, (jnp.asarray(xs), jnp.asarray(ts)),
                             jcfg, rng=jax.random.PRNGKey(1),
                             checkpointer=JaxCheckpointer(tmp_path))
    progress = json.loads((tmp_path / "calib_progress.json").read_text())
    assert progress["phase"] == "weight" and progress["unit_idx"] == 3
    snap, _ = CalibCheckpointer(tmp_path).load()

    calls = _counting(monkeypatch, engine.reconstruct_unit)
    q = calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)),
                  _cfg(), checkpointer=CalibCheckpointer(tmp_path))
    assert calls == [u.name for u in model.units[4:] if u.layer_names]
    for name, cfg in model.layer_cfgs.items():
        assert "alpha" in q[name]["w"], name
    sites = _restored_sites(model, progress)
    _assert_bit_equal(q, {s: snap[s] for s in sites if s in snap}, sites)


def test_jax_loads_a_run_dir_the_port_crashed_in(tmp_path, monkeypatch):
    """The port crashes in its activation pass; the JAX checkpointer
    loads the directory: the same progress, and every leaf bit-equal to
    the port's own load, in the JAX layout."""
    model, (xs, ts) = _model(), _data()
    n_units = len(model.units)
    _crash_after(monkeypatch, engine, n_units + 5)
    with pytest.raises(Crash):
        calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)),
                  _cfg(quant_act=True),
                  checkpointer=CalibCheckpointer(tmp_path))
    want, progress = CalibCheckpointer(tmp_path).load()
    assert progress["phase"] == "act" and progress["unit_idx"] == 3
    got, jprogress = JaxCheckpointer(tmp_path).load()
    assert jprogress == progress
    want = qstate_to_jax(want)
    assert sorted(got) == sorted(want)
    for site, slots in want.items():
        assert sorted(got[site]) == sorted(slots), site
        for slot, st in slots.items():
            for leaf, t in st.items():
                np.testing.assert_array_equal(np.asarray(got[site][slot][
                    leaf]), t.numpy(), err_msg=f"{site}/{slot}/{leaf}")
    assert "a" in got["conv_in"] and "x_max" in got["conv_in"]["a"]


def test_bf16_alpha_storage_survives_resume(tmp_path, monkeypatch):
    """alpha_dtype 'bfloat16': a crash and a resume keep the alphas bf16
    in the engine's result and in qstate.npz ('#bf16' keys), and the
    restored alphas are bit-equal to the snapshot's."""
    model, (xs, ts) = _model(), _data()
    cfg = _cfg(quant_act=True, alpha_dtype="bfloat16")
    real = engine.reconstruct_unit
    _crash_after(monkeypatch, engine, 5)
    with pytest.raises(Crash):
        calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)), cfg,
                  checkpointer=CalibCheckpointer(tmp_path))
    snap, progress = CalibCheckpointer(tmp_path).load()
    monkeypatch.setattr(engine, "reconstruct_unit", real)
    q = calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)), cfg,
                  checkpointer=CalibCheckpointer(tmp_path))
    with np.load(tmp_path / "qstate.npz") as f:
        assert any(k.endswith("/alpha#bf16") for k in f.files)
        assert not any(k.endswith("/alpha") for k in f.files)
    for name in model.layer_cfgs:
        assert q[name]["w"]["alpha"].dtype == torch.bfloat16, name
    sites = _restored_sites(model, progress)
    _assert_bit_equal(load_qstate(tmp_path / "qstate.npz"),
                      {s: {"w": snap[s]["w"]} for s in sites if s in snap},
                      sites)


def test_a_snapshot_that_runs_out_of_memory_is_deferred(tmp_path,
                                                        monkeypatch):
    """A save whose pull off the card runs out of memory returns False and
    writes no file; the engine keeps the pending sites and saves them with
    the next snapshot."""
    from qdiffusion_torch.utils import checkpoints

    real, saved, fail = checkpoints.save_qstate, [], [True]

    def flaky(path, qstate):
        if fail[0] and "qstate_inc_" in str(path):
            fail[0] = False
            raise torch.OutOfMemoryError("simulated")
        saved.append((path.name, sorted(qstate)))
        return real(path, qstate)

    monkeypatch.setattr(checkpoints, "save_qstate", flaky)
    model, (xs, ts) = _model(), _data()
    calibrate(model, (torch.from_numpy(xs), torch.from_numpy(ts)), _cfg(),
              checkpointer=CalibCheckpointer(tmp_path))
    # the base, then the increment after unit 3, which also carries the
    # sites of units 0-1 whose save failed
    assert [name for name, _ in saved[:2]] == ["qstate_wip.npz",
                                               "qstate_inc_0000.npz"]
    assert saved[1][1] == sorted(s for u in model.units[:4]
                                 for s in u.layer_names)
    ck = CalibCheckpointer(tmp_path / "direct")
    fail[0] = True
    q = load_qstate(tmp_path / "qstate.npz")
    assert ck.save(q, "weight", -1) and ck.save(q, "weight", 0,
                                                sites=["conv_in"]) is False
    assert sorted(p.name for p in (tmp_path / "direct").iterdir()) == [
        "calib_progress.json", "qstate_wip.npz"]
