"""The port's CLI on a tiny pixel task (and one tiny unconditional latent
task's calibration chain), on the CPU.

The fold-W4 run is held against the JAX package: the same params (seed
0 through the port's init_params), the same qstate file and the same
initial noise go through the JAX fold engine and DDIM loop, and the
uint8 images may differ by one level where f32 rounding lands on a
boundary (observed: none or a handful of pixels).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig
from qdiffusion_tpu.pipelines import PixelDiffusionPipeline as JaxPipeline
from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate

from qdiffusion_torch import cli, config
from qdiffusion_torch.calib.engine import init_act_qstate, init_weight_qstate
from qdiffusion_torch.config import (
    QuantFlags, SamplerConfig, ScheduleConfig, TaskConfig)
from qdiffusion_torch.convert import to_jax_params
from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig
from qdiffusion_torch.models.unet_ldm import LDMUNetConfig
from qdiffusion_torch.models.vae import VAEConfig
from qdiffusion_torch.utils.checkpoints import load_qstate, save_qstate

torch.set_num_threads(1)

UNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
            resolution=8)
TINY_TASK = TaskConfig(
    name="tiny", family="pixel",
    schedule=ScheduleConfig("ddpm", "linear", 1e-4, 2e-2, 100),
    sampler=SamplerConfig("generalized", 4, "uniform", 0.0),
    image_size=8, channels=3, unet_ddim=DDIMUNetConfig(**UNET))


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    monkeypatch.setitem(config.PRESETS, "tiny", TINY_TASK)


def _model(**flags):
    m = DDIMUNet(DDIMUNetConfig(**UNET, split_shortcut=flags.pop(
        "split", False)), QuantFlags(**flags).policy_ddim(), device="cpu")
    m.load_state_dict(m.init_params(0))
    return m


def _load(path):
    with np.load(path) as f:
        return f["arr_0"]


def test_fp_sample_writes_bulk_npz(tmp_path):
    out = cli.main(["sample", "--task", "tiny", "--n", "3", "--batch", "2",
                    "--npz-out", str(tmp_path / "np"), "--device", "cpu"])
    files = list((tmp_path / "np").glob("*-samples.npz"))
    assert len(files) == 1 and files[0].name == "3x8x8x3-samples.npz"
    arr = _load(files[0])
    assert arr.shape == (3, 8, 8, 3) and arr.dtype == np.uint8
    assert out["nonfinite"] == 0 and len(out["batch_seconds"]) == 2
    assert out["steps"] == 4


def test_fold_w4_split_matches_jax(tmp_path):
    m = _model(weight_bit=4, split=True)
    q = init_weight_qstate(m)
    qpath = tmp_path / "q.npz"
    save_qstate(qpath, q)
    out = cli.main(["sample", "--task", "tiny", "--qstate", str(qpath),
                    "--weight-bit", "4", "--split", "--engine", "fold",
                    "--n", "2", "--batch", "2", "--seed", "7",
                    "--npz-out", str(tmp_path / "fold.npz"),
                    "--device", "cpu"])
    got = _load(out["path"])

    jm = JaxUNet(JaxConfig(**UNET, split_shortcut=True),
                 JaxFlags(weight_bit=4).policy_ddim())
    params = jax_fold(jm, to_jax_params(m.state_dict()),
                      jax_load_qstate(qpath))
    seeds = np.arange(2, dtype=np.int64) + np.int64(7) * 1000003
    x0 = cli._item_noise(seeds, (8, 8, 3)).numpy()
    x, _ = JaxPipeline(jm, JaxSchedule.ddpm("linear", 1e-4, 2e-2, 100)).sample(
        params, 2, timesteps=4, skip_type="uniform", eta=0.0, image_size=8,
        x_init=jnp.asarray(x0))
    want = (np.asarray(jnp.clip((x + 1.0) / 2.0, 0.0, 1.0)) * 255.0).astype(
        np.uint8)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"fold W4 CLI vs JAX: {int((diff > 0).sum())} of {diff.size} "
          "uint8 values differ")
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sim_w8a8_sample(tmp_path, dtype):
    m = _model(weight_bit=8, quant_act=True)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((4, 8, 8, 3)).astype(
        np.float32))
    ts = torch.from_numpy(rng.integers(0, 100, 4).astype(np.float32))
    q = init_act_qstate(m, init_weight_qstate(m), xs, ts)
    assert "a" in q["conv_in"] and "sm" in q["mid.attn_1"]
    save_qstate(tmp_path / "q.npz", q)
    out = cli.main(["sample", "--task", "tiny", "--qstate",
                    str(tmp_path / "q.npz"), "--weight-bit", "8",
                    "--quant-act", "--act-bit", "8", "--engine", "sim",
                    "--dtype", dtype, "--n", "2", "--batch", "2",
                    "--timesteps", "2", "--npz-out", str(tmp_path / "s"),
                    "--device", "cpu"])
    assert out["nonfinite"] == 0 and out["steps"] == 2
    assert _load(out["path"]).shape == (2, 8, 8, 3)


def test_fold_with_quant_act_is_refused(tmp_path):
    m = _model(weight_bit=8)
    save_qstate(tmp_path / "q.npz", init_weight_qstate(m))
    with pytest.raises(SystemExit, match="weight-only"):
        cli.main(["sample", "--task", "tiny", "--qstate",
                  str(tmp_path / "q.npz"), "--quant-act", "--engine", "fold",
                  "--device", "cpu"])



def test_make_cali_data_calibrate_then_sample(tmp_path):
    """The weight pass end to end through the CLI: the trajectory npz in
    the JAX keys and NHWC layout, calibrate's qstate with an alpha on
    every weight quantizer (read back by the JAX package's loader), then
    `sample --engine fold` on that file as it is."""
    traj = tmp_path / "traj.npz"
    cli.main(["make-cali-data", "--task", "tiny", "--n", "8",
              "--timesteps", "8", "--out", str(traj), "--device", "cpu"])
    with np.load(traj) as f:
        assert sorted(f.files) == ["ts", "xs"]
        assert f["xs"].shape == (9, 8, 8, 8, 3) and f["ts"].shape == (9, 8)
        assert f["xs"].dtype == np.float32
    res = cli.main(["calibrate", "--task", "tiny", "--cali-data", str(traj),
                    "--weight-bit", "4", "--split", "--cali-st", "4",
                    "--cali-n", "4", "--cali-batch-size", "4",
                    "--cali-iters", "8", "--alpha-dtype", "bfloat16",
                    "--run-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert res["path"] == str(tmp_path / "run" / "qstate.npz")
    assert res["samples"] == 5 * 4  # 9 steps sliced every 2: 5 steps
    assert (tmp_path / "run" / "run.log").exists()
    with np.load(res["path"]) as f:
        assert any(k.endswith("/alpha#bf16") for k in f.files)
    jq = jax_load_qstate(res["path"])
    m = _model(weight_bit=4, split=True)
    for name, cfg in m.layer_cfgs.items():
        for slot in ("w", "w0") if cfg.split else ("w",):
            assert jq[name][slot]["alpha"].dtype.name == "bfloat16"
    out = cli.main(["sample", "--task", "tiny", "--qstate", res["path"],
                    "--weight-bit", "4", "--split", "--engine", "fold",
                    "--n", "2", "--batch", "2", "--npz-out",
                    str(tmp_path / "s.npz"), "--device", "cpu"])
    assert out["nonfinite"] == 0 and _load(out["path"]).shape == (2, 8, 8, 3)


@pytest.mark.parametrize("argv", [
    ["calibrate", "--task", "sd_v1"],
    ["make-cali-data", "--task", "sd_v1"],
])
def test_sd_calibration_without_contexts_is_refused(argv, tmp_path):
    """SD calibration reads the cond and uncond contexts of every step:
    make-cali-data without --token-ids (the port has no tokenizer), and
    calibrate on a trajectory without "cs" / "ucs", exit with a message
    naming what is missing, before any work."""
    if argv[0] == "calibrate":
        np.savez(tmp_path / "traj.npz", xs=np.zeros((2, 1, 8, 8, 4),
                                                     np.float32),
                 ts=np.zeros((2, 1), np.float32))
        argv = argv + ["--cali-data", str(tmp_path / "traj.npz"),
                       "--run-dir", str(tmp_path / "run")]
    else:
        argv = argv + ["--out", str(tmp_path / "t.npz")]
    with pytest.raises(SystemExit, match="token-ids"):
        cli.main(argv + ["--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == (
        ["run", "traj.npz"] if argv[0] == "calibrate" else [])
    if argv[0] == "calibrate":
        assert not list((tmp_path / "run").glob("*.npz"))


LDM_TASK = TaskConfig(
    name="ldm-tiny", family="ldm",
    schedule=ScheduleConfig("ldm", "linear", 0.0015, 0.0195, 1000),
    sampler=SamplerConfig("ddim", 4, "uniform", 0.0),
    image_size=16, channels=3, latent_size=8, latent_channels=3,
    unet_ldm=LDMUNetConfig(
        image_size=8, in_channels=3, out_channels=3, model_channels=32,
        num_res_blocks=1, attention_resolutions=(4, 2), channel_mult=(1, 2),
        num_head_channels=16),
    vae=VAEConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(), in_channels=3, resolution=16,
                  z_channels=3, double_z=True, embed_dim=3))


def test_ldm_make_cali_data_calibrate_then_sample(tmp_path, monkeypatch):
    """An unconditional latent task (LSUN-beds-shaped UNet, legacy
    AttentionBlocks) through the CLI: make-cali-data (DDIM latents, no
    contexts; the JAX package's get_train_samples reads the file alike),
    calibrate --quant-act (W4A8, both passes) on the partitioned model,
    whose qstate holds the attention quantizers at the partition's sites
    and loads in JAX, then sample --quant-act --engine sim on it."""
    from qdiffusion_tpu.calib.samples import get_train_samples as jax_samples

    from qdiffusion_torch.calib.samples import get_train_samples
    from qdiffusion_torch.models.vae import VAE
    from qdiffusion_torch.utils.checkpoints import save_nested

    monkeypatch.setitem(config.PRESETS, "ldm-tiny", LDM_TASK)
    traj = tmp_path / "traj.npz"
    made = cli.main(["make-cali-data", "--task", "ldm-tiny", "--n", "4",
                     "--out", str(traj), "--device", "cpu"])
    assert made["shapes"] == {"xs": (4, 4, 8, 8, 3), "ts": (4, 4)}
    with np.load(traj) as f:
        assert sorted(f.files) == ["ts", "xs"]
        got = get_train_samples({k: torch.from_numpy(f[k]) for k in f.files},
                                4, 2)
        want = jax_samples({k: jnp.asarray(f[k]) for k in f.files}, 4, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    res = cli.main(["calibrate", "--task", "ldm-tiny", "--cali-data",
                    str(traj), "--weight-bit", "4", "--quant-act",
                    "--running-stat", "--cali-st", "2", "--cali-n", "4",
                    "--cali-batch-size", "4", "--cali-iters", "2",
                    "--cali-iters-a", "2", "--act-init-batch", "4",
                    "--run-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert res["samples"] == 8
    q = load_qstate(res["path"])
    parts = [s for s in q if ".attention." in s]
    assert parts and all(set(q[s]) == ({"q", "k"} if s.endswith("qkv_matmul")
                                       else {"sm", "v"}) for s in parts)
    assert not any("sm" in sl for s, sl in q.items() if s not in parts)
    jq = jax_load_qstate(res["path"])
    assert sorted(jq) == sorted(q)
    vae = VAE(LDM_TASK.vae, device="cpu")
    vae.load_state_dict(vae.init_params(1))
    save_nested(tmp_path / "vae.npz", to_jax_params(vae.state_dict()))
    out = cli.main(["sample", "--task", "ldm-tiny", "--vae-ckpt",
                    str(tmp_path / "vae.npz"), "--qstate", res["path"],
                    "--weight-bit", "4", "--quant-act", "--engine", "sim",
                    "--n", "2", "--batch", "2", "--timesteps", "2",
                    "--npz-out", str(tmp_path / "s.npz"), "--device", "cpu"])
    assert out["nonfinite"] == 0 and out["model_calls"] == [2]
    assert _load(out["path"]).shape == (2, 16, 16, 3)


CALIB = ["--task", "tiny", "--weight-bit", "4", "--split", "--cali-st", "4",
         "--cali-n", "4", "--cali-batch-size", "4", "--cali-iters", "4",
         "--cali-iters-a", "4", "--act-init-batch", "8", "--device", "cpu"]
ACT = ["--quant-act", "--running-stat"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """A tiny trajectory, then two runs of `calibrate` on it: the weight
    pass alone (w/) and both passes with the running-stat sweep (wa/)."""
    d = tmp_path_factory.mktemp("calib")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(config.PRESETS, "tiny", TINY_TASK)
        cli.main(["make-cali-data", "--task", "tiny", "--n", "8",
                  "--timesteps", "8", "--out", str(d / "traj.npz"),
                  "--device", "cpu"])
        for run, extra in (("w", []), ("wa", ACT)):
            cli.main(["calibrate", "--cali-data", str(d / "traj.npz"),
                      "--run-dir", str(d / run), *CALIB, *extra])
    return d


def _act_sites(q) -> dict:
    return {(s, k): st for s, sl in q.items() for k, st in sl.items()
            if k not in ("w", "w0")}


def test_calibrate_quant_act_writes_act_deltas(cli_runs):
    """`calibrate --quant-act --running-stat`: every layer's input
    quantizer (and each split layer's second) calibrated with its EMA
    stats, alphas on every weight quantizer, the run directory finalized;
    the JAX package reads the file."""
    path = cli_runs / "wa" / "qstate.npz"
    assert not (cli_runs / "wa" / "calib_progress.json").exists()
    q = load_qstate(path)
    m = _model(weight_bit=4, quant_act=True, split=True)
    for name, cfg in m.layer_cfgs.items():
        for slot in ("a", "a0") if cfg.split else ("a",):
            assert {"delta", "zero_point", "x_min", "x_max"} <= set(
                q[name][slot]), (name, slot)
        assert "alpha" in q[name]["w"], name
    assert {"q", "k", "v", "sm"} <= set(q["mid.attn_1"])
    jq = jax_load_qstate(path)
    assert float(jq["mid.attn_1"]["sm"]["delta"]) == float(
        q["mid.attn_1"]["sm"]["delta"])


def test_resume_w_runs_only_the_act_pass(cli_runs, tmp_path, monkeypatch):
    """`--resume-w` on the weight pass's qstate: only act reconstructions
    run, and every weight quantizer leaves as it came."""
    from qdiffusion_torch.calib import engine

    real, modes = engine.reconstruct_unit, []

    def spy(*a, **kw):
        modes.append(kw.get("act_quant", False))
        return real(*a, **kw)

    monkeypatch.setattr(engine, "reconstruct_unit", spy)
    wq = cli_runs / "w" / "qstate.npz"
    res = cli.main(["calibrate", "--cali-data", str(cli_runs / "traj.npz"),
                    "--resume-w", str(wq), "--run-dir", str(tmp_path / "a"),
                    *CALIB, *ACT])
    assert modes and all(modes)
    want, got = load_qstate(wq), load_qstate(res["path"])
    for site, slots in want.items():
        for slot, st in slots.items():
            for leaf, t in st.items():
                assert torch.equal(got[site][slot][leaf], t), (site, slot)
    assert _act_sites(got) and not _act_sites(want)


def test_run_dir_resumes(cli_runs, tmp_path, monkeypatch):
    """A run that stops in its activation pass resumes through the same
    `--run-dir`: the rerun starts after the marker's unit and finishes."""
    from qdiffusion_torch.calib import engine

    real, calls = engine.reconstruct_unit, []

    n_units = len(_model(weight_bit=4, split=True).units)

    def spy(*a, **kw):
        if crash and len(calls) == n_units + 10:
            raise RuntimeError("simulated crash")
        calls.append(a[2].name)
        return real(*a, **kw)

    argv = ["calibrate", "--cali-data", str(cli_runs / "traj.npz"),
            "--run-dir", str(tmp_path / "run"), *CALIB, *ACT]
    monkeypatch.setattr(engine, "reconstruct_unit", spy)
    crash = True  # in the 11th act reconstruction; one increment (8) made
    with pytest.raises(RuntimeError, match="simulated crash"):
        cli.main(argv)
    progress = json.loads((tmp_path / "run" / "calib_progress.json")
                          .read_text())
    assert progress == {"phase": "act", "unit_idx": 7, "n_inc": 1}
    calls.clear()
    crash = False
    res = cli.main(argv)
    assert calls == [u.name for u in _model(weight_bit=4,
                                             split=True).units[8:]]
    assert not (tmp_path / "run" / "calib_progress.json").exists()
    assert _act_sites(load_qstate(res["path"]))


def test_sim_sample_on_the_calibrated_act_qstate(cli_runs, tmp_path):
    out = cli.main(["sample", "--task", "tiny", "--qstate",
                    str(cli_runs / "wa" / "qstate.npz"), "--weight-bit", "4",
                    "--quant-act", "--split", "--engine", "sim", "--n", "2",
                    "--batch", "2", "--npz-out", str(tmp_path / "s.npz"),
                    "--device", "cpu"])
    assert out["nonfinite"] == 0 and _load(out["path"]).shape == (2, 8, 8, 3)
