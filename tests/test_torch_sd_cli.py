"""The port's `sample` CLI on a tiny SD preset, on the CPU: CLIP token
ids -> text tower -> PLMS with CFG 7.5 over the LDM UNet -> KL-VAE decode.

The fold-W4 run is held against the JAX package: the same UNet, VAE and
CLIP npz files, the same qstate and the same initial noise go through
the JAX text tower, fold engine, PLMS loop and decode. The uint8 images
may differ by one level where f32 rounding lands on a boundary, on at
most 1 % of the values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.models.clip_text import CLIPTextConfig as JaxClipConfig
from qdiffusion_tpu.models.clip_text import CLIPTextEncoder as JaxClip
from qdiffusion_tpu.models.unet_ldm import LDMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ldm import LDMUNetConfig as JaxUNetConfig
from qdiffusion_tpu.models.vae import VAE as JaxVAE
from qdiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from qdiffusion_tpu.pipelines import LatentDiffusionPipeline as JaxPipeline
from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule
from qdiffusion_tpu.utils.checkpoints import load_nested as jax_load_nested
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate

from qdiffusion_torch import cli, config
from qdiffusion_torch.calib.engine import init_act_qstate, init_weight_qstate
from qdiffusion_torch.config import (
    QuantFlags, SamplerConfig, ScheduleConfig, TaskConfig)
from qdiffusion_torch.convert import to_jax_params
from qdiffusion_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from qdiffusion_torch.models.unet_ldm import LDMUNet, LDMUNetConfig
from qdiffusion_torch.models.vae import VAE, VAEConfig
from qdiffusion_torch.utils.checkpoints import save_nested, save_pytree, \
    save_qstate

torch.set_num_threads(1)

UNET = dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=4, use_spatial_transformer=True, transformer_depth=1,
            context_dim=32)
VAE_CFG = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
               attn_resolutions=(), in_channels=3, resolution=16,
               z_channels=4, double_z=True, embed_dim=4)
CLIP = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_positions=77)
TASK = TaskConfig(
    name="sd-tiny", family="sd",
    schedule=ScheduleConfig("ldm", "linear", 0.00085, 0.012, 1000),
    sampler=SamplerConfig("plms", 4, "uniform", 0.0, guidance_scale=7.5),
    image_size=16, channels=3, latent_size=8, latent_channels=4,
    scale_factor=0.18215, conditioning_key="crossattn",
    unet_ldm=LDMUNetConfig(**UNET), vae=VAEConfig(**VAE_CFG),
    clip=CLIPTextConfig(**CLIP))


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    monkeypatch.setitem(config.PRESETS, "sd-tiny", TASK)


def _unet(**flags):
    m = LDMUNet(TASK.unet_ldm, QuantFlags(**flags).policy_ldm(),
                device="cpu")
    m.load_state_dict(m.init_params(0))
    return m


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd_tiny")
    unet = LDMUNet(TASK.unet_ldm, device="cpu")
    unet.load_state_dict(unet.init_params(0))
    save_pytree(d / "unet.npz", to_jax_params(unet.state_dict()))
    vae = VAE(TASK.vae, device="cpu")
    vae.load_state_dict(vae.init_params(1))
    save_nested(d / "vae.npz", to_jax_params(vae.state_dict()))
    clip = CLIPTextEncoder(TASK.clip, device="cpu")
    clip.load_state_dict(clip.init_params(2))
    save_nested(d / "clip.npz", to_jax_params(clip.state_dict()))
    rng = np.random.default_rng(3)
    np.savez(d / "ids.npz", cond=rng.integers(0, 64, (1, 77)),
             uncond=rng.integers(0, 64, (1, 77)))
    return d


def _args(d, *extra):
    return ["sample", "--task", "sd-tiny", "--ckpt", str(d / "unet.npz"),
            "--vae-ckpt", str(d / "vae.npz"), "--clip-ckpt",
            str(d / "clip.npz"), "--token-ids", str(d / "ids.npz"),
            "--device", "cpu", *extra]


def _load(path):
    with np.load(path) as f:
        return f["arr_0"]


def test_fold_w4_matches_jax(files, tmp_path):
    q = init_weight_qstate(_unet(weight_bit=4))
    save_qstate(tmp_path / "q.npz", q)
    out = cli.main(_args(files, "--qstate", str(tmp_path / "q.npz"),
                         "--weight-bit", "4", "--engine", "fold", "--n", "2",
                         "--batch", "2", "--seed", "7",
                         "--npz-out", str(tmp_path / "fold.npz")))
    got = _load(out["path"])
    assert got.shape == (2, 16, 16, 3) and got.dtype == np.uint8
    assert out["model_calls"] == [5] and out["sampler"] == "plms"
    assert out["guidance_scale"] == 7.5 and out["nonfinite"] == 0

    jm = JaxUNet(JaxUNetConfig(**UNET), JaxFlags(weight_bit=4).policy_ldm())
    from qdiffusion_tpu.utils.checkpoints import load_pytree
    import jax

    like = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = jax_fold(jm, load_pytree(files / "unet.npz", like),
                      jax_load_qstate(tmp_path / "q.npz"))
    text = JaxClip(JaxClipConfig(**CLIP))
    clip_params = jax_load_nested(files / "clip.npz")
    with np.load(files / "ids.npz") as ids:
        cond = text.apply(clip_params, jnp.asarray(ids["cond"]))
        uncond = text.apply(clip_params, jnp.asarray(ids["uncond"]))
    pipe = JaxPipeline(unet=jm, vae=JaxVAE(JaxVAEConfig(**VAE_CFG)),
                       schedule=JaxSchedule.ldm("linear", 1000, 0.00085,
                                                0.012),
                       scale_factor=0.18215, conditioning_key="crossattn",
                       text_encoder=text)
    seeds = np.arange(2, dtype=np.int64) + np.int64(7) * 1000003
    x0 = cli._item_noise(seeds, (8, 8, 4)).numpy()
    imgs, _ = pipe.sample(params, jax_load_nested(files / "vae.npz"), 2,
                          sampler="plms", steps=4, latent_size=8,
                          latent_channels=4, cond=jnp.tile(cond, (2, 1, 1)),
                          uncond=jnp.tile(uncond, (2, 1, 1)),
                          guidance_scale=7.5, x_init=jnp.asarray(x0))
    want = (np.asarray(imgs) * 255.0).astype(np.uint8)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"sd fold W4 CLI vs JAX: {int((diff > 0).sum())} of {diff.size} "
          "uint8 values differ")
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert want.std() > 5  # the images are not flat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sim_w8a8_sample(files, tmp_path, dtype):
    m = _unet(weight_bit=8, quant_act=True)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(
        np.float32))
    ts = torch.tensor([10.0, 600.0])
    cs = torch.from_numpy(rng.standard_normal((2, 77, 32)).astype(
        np.float32))
    q = init_act_qstate(m, init_weight_qstate(m), xs, ts, cs)
    site = "input_blocks.3.1.transformer_blocks.0.attn1"
    assert {"q", "k", "v", "sm"} <= set(q[site])
    save_qstate(tmp_path / "q.npz", q)
    out = cli.main(_args(files, "--qstate", str(tmp_path / "q.npz"),
                         "--weight-bit", "8", "--quant-act", "--act-bit",
                         "8", "--engine", "sim", "--dtype", dtype, "--n",
                         "2", "--batch", "2", "--timesteps", "2",
                         "--npz-out", str(tmp_path / "s")))
    assert out["nonfinite"] == 0 and out["model_calls"] == [3]
    assert _load(out["path"]).shape == (2, 16, 16, 3)


def test_ddim_without_guidance(files, tmp_path):
    out = cli.main(_args(files, "--sampler", "ddim", "--scale", "1.0",
                         "--timesteps", "2", "--n", "3", "--batch", "2",
                         "--npz-out", str(tmp_path / "d")))
    assert out["model_calls"] == [2, 2] and out["sampler"] == "ddim"
    assert _load(out["path"]).shape == (3, 16, 16, 3)


def test_token_ids_need_the_clip_weights(files, tmp_path):
    args = _args(files, "--npz-out", str(tmp_path / "x"))
    i = args.index("--clip-ckpt")
    del args[i:i + 2]
    with pytest.raises(SystemExit, match="clip-ckpt"):
        cli.main(args)


def test_make_cali_data_calibrate_then_sample(files, tmp_path):
    """SD calibration through the CLI: make-cali-data --token-ids writes
    the JAX keys (xs, ts, cs, ucs) and matches the JAX pipeline's PLMS
    trajectory with CFG 7.5 on the same noise and contexts (1e-5 of each
    array's largest magnitude); the JAX package's get_train_samples
    (cond=True) reads the file as the port's does; calibrate W4A8
    (--split --sm-abit 16 --running-stat, bf16 alphas) on the cond and
    uncond rows; then sample --quant-act --engine sim on its qstate."""
    import jax

    from qdiffusion_tpu.calib.samples import get_train_samples as \
        jax_samples
    from qdiffusion_tpu.utils.checkpoints import load_pytree

    from qdiffusion_torch.calib.samples import get_train_samples
    from qdiffusion_torch.utils.checkpoints import load_qstate

    traj = tmp_path / "traj.npz"
    made = cli.main(["make-cali-data", "--task", "sd-tiny", "--ckpt",
                     str(files / "unet.npz"), "--clip-ckpt",
                     str(files / "clip.npz"), "--token-ids",
                     str(files / "ids.npz"), "--n", "2", "--seed", "3",
                     "--out", str(traj), "--device", "cpu"])
    assert made["shapes"] == {"xs": (4, 2, 8, 8, 4), "ts": (4, 2),
                              "cs": (4, 2, 77, 32), "ucs": (4, 2, 77, 32)}
    with np.load(traj) as f:
        got = {k: f[k] for k in f.files}

    jm = JaxUNet(JaxUNetConfig(**UNET))
    params = load_pytree(files / "unet.npz", jax.eval_shape(
        jm.init_params, jax.random.PRNGKey(0)))
    text = JaxClip(JaxClipConfig(**CLIP))
    clip_params = jax_load_nested(files / "clip.npz")
    with np.load(files / "ids.npz") as ids:
        cond = text.apply(clip_params, jnp.asarray(ids["cond"]))
        uncond = text.apply(clip_params, jnp.asarray(ids["uncond"]))
    pipe = JaxPipeline(unet=jm, vae=None, schedule=JaxSchedule.ldm(
        "linear", 1000, 0.00085, 0.012), conditioning_key="crossattn")
    x0 = cli._item_noise(np.arange(2) + np.int64(3) * 1000003, (8, 8, 4))
    _, want = pipe.sample(params, None, 2, sampler="plms", steps=4,
                          cond=jnp.tile(cond, (2, 1, 1)),
                          uncond=jnp.tile(uncond, (2, 1, 1)),
                          guidance_scale=7.5, x_init=jnp.asarray(x0.numpy()),
                          decode=False, return_trajectory=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape
        assert np.abs(got[k] - w).max() <= 1e-5 * np.abs(w).max(), k
    port = get_train_samples({k: torch.from_numpy(v) for k, v in
                              got.items()}, 2, 2, cond=True)
    jax_rows = jax_samples({k: jnp.asarray(v) for k, v in got.items()}, 2,
                           2, cond=True)
    for a, b in zip(port, jax_rows):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    res = cli.main(["calibrate", "--task", "sd-tiny", "--ckpt",
                    str(files / "unet.npz"), "--cali-data", str(traj),
                    "--weight-bit", "4", "--split", "--quant-act",
                    "--sm-abit", "16", "--running-stat", "--alpha-dtype",
                    "bfloat16", "--cali-st", "2", "--cali-n", "2",
                    "--cali-batch-size", "4", "--cali-iters", "2",
                    "--cali-iters-a", "2", "--act-init-batch", "4",
                    "--run-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert res["samples"] == 8  # 2 steps x 2 samples, cond then uncond
    q = load_qstate(res["path"])
    site = "input_blocks.3.1.transformer_blocks.0.attn1"
    assert {"q", "k", "v", "sm"} <= set(q[site])
    assert q["out.2"]["w"]["alpha"].dtype == torch.bfloat16
    out = cli.main(_args(files, "--qstate", res["path"], "--weight-bit",
                         "4", "--split", "--quant-act", "--sm-abit", "16",
                         "--engine", "sim", "--n", "2", "--batch", "2",
                         "--timesteps", "2",
                         "--npz-out", str(tmp_path / "s.npz")))
    assert out["nonfinite"] == 0 and out["model_calls"] == [3]
    assert _load(out["path"]).shape == (2, 16, 16, 3)
