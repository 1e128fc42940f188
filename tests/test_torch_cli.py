"""The port's `sample` CLI on a tiny pixel task, on the CPU.

The fold-W4 run is held against the JAX package: the same params (seed
0 through the port's init_params), the same qstate file and the same
initial noise go through the JAX fold engine and DDIM loop, and the
uint8 images may differ by one level where f32 rounding lands on a
boundary (observed: none or a handful of pixels).
"""

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
from qdiffusion_torch.utils.checkpoints import save_qstate

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

