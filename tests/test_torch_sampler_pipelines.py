"""The samplers of the pipelines and of `sample --sampler` beyond DDIM and
PLMS, port against the JAX package, on the CPU, f32, at tiny sizes:

  * ancestral DDPM (`ddpm_noisy`) with JAX's step noise injected as the
    port's torch.randn results, and DPM-Solver++ (`dpm_solver`: pixel
    singlestep order 3, latent multistep order 2), through the tiny
    CIFAR UNet of test_torch_unet.py (FP and fold W4 --split) and the
    tiny SD (CFG 7.5) and LSUN-beds (no context) LDM UNets of
    test_torch_unet_ldm.py: rtol = atol = 1e-4 (the DDIM tests' bound;
    the UNet's eps agrees to ~2e-6 and each update is a fixed linear map
    of the model outputs). DPM-Solver++ divides by alpha (6.4e-3 at the
    CIFAR schedule's t = 1, 6.8e-2 at SD's), so its largest gap is
    above DDPM's: observed 1.8e-4 (pixel) and 2.3e-4 (SD) absolute on
    values whose rtol share is larger, against 2.1e-5 for DDPM and 2.9e-5
    for beds;
  * ddpm_sample's trajectory and its t = 0 step, on a toy model;
  * the CLI: `sample --sampler dpm_solver` and `--sampler ddpm_noisy` on
    the tiny pixel task of test_torch_cli.py and `--sampler dpm_solver` on
    the tiny SD task of test_torch_sd_cli.py, fold W4 against the JAX
    pipeline on the same npz files and initial noise (uint8 within one
    level on under 1 % of the values), every engine with as many model
    calls as the solver's NFE, the LSUN-shaped tiny tasks of
    test_torch_lsun.py through int8 and stream.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.deploy import make_quantized_step as jax_step
from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig
from qdiffusion_tpu.pipelines import LatentDiffusionPipeline as JaxLatent
from qdiffusion_tpu.pipelines import PixelDiffusionPipeline as JaxPixel
from qdiffusion_tpu.samplers import ddim as jax_ddim
from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate

from qdiffusion_torch import cli, config
from qdiffusion_torch.calib.engine import init_act_qstate, init_weight_qstate
from qdiffusion_torch.convert import to_jax_params
from qdiffusion_torch.deploy import make_quantized_step
from qdiffusion_torch.pipelines import LatentDiffusionPipeline, \
    PixelDiffusionPipeline
from qdiffusion_torch.samplers import ddim
from qdiffusion_torch.schedules import NoiseSchedule
from qdiffusion_torch.utils.checkpoints import save_qstate

import test_torch_unet as pixel_tiny
import test_torch_unet_ldm as ldm_tiny
from test_torch_cli import TINY_TASK, UNET
from test_torch_cli import _model as _pixel_model
from test_torch_lsun import _images, _sample, lsun_files  # noqa: F401
from test_torch_sd_cli import CLIP as SD_CLIP
from test_torch_sd_cli import TASK as SD_TASK
from test_torch_sd_cli import UNET as SD_UNET
from test_torch_sd_cli import VAE_CFG as SD_VAE
from test_torch_sd_cli import _args as _sd_args
from test_torch_sd_cli import _unet as _sd_unet
from test_torch_sd_cli import files as sd_files  # noqa: F401

torch.set_num_threads(1)

SCHED = ("linear", 1e-4, 2e-2, 1000)


def _jax_step_noise(shape, steps, key=None, split_first=True):
    """The noise JAX's samplers draw per step from `key` (default: the
    pipelines' PRNGKey(0), which they split once for the initial noise
    and keep the first half of); the sampler splits it once per step."""
    key = jax.random.PRNGKey(0) if key is None else key
    if split_first:
        key = jax.random.split(key)[0]
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return out


def _inject(monkeypatch, noise, shape):
    """torch.randn of `shape` returns the next of `noise`; other shapes
    (the CLI's per-item initial noise) draw as before."""
    real = torch.randn

    def randn(size, *a, **kw):
        if tuple(size) == tuple(shape):
            return noise.pop(0)
        return real(size, *a, **kw)

    monkeypatch.setattr(torch, "randn", randn)


@pytest.fixture(scope="module")
def pixel_pair(tmp_path_factory):
    """The tiny CIFAR UNet (split shortcut, W4 policy) in both packages,
    the port's W4 weight qstate (JAX reads the same file), and the (JAX,
    port) model functions: FP and the fold engine."""
    jm, tm, params = pixel_tiny.build_pair(split=True, weight_bit=4)
    tq = init_weight_qstate(tm)
    qpath = tmp_path_factory.mktemp("pixel") / "w4.npz"
    save_qstate(qpath, tq)
    jq = jax_load_qstate(qpath)
    fp = jax.jit(lambda x, t: jm.apply(params, x, t, None))
    fns = {"fp": (fp, lambda x, t: tm(x, t)),
           "fold": (jax_step(jm, params, jq, engine="fold"),
                    make_quantized_step(tm, tq, engine="fold"))}
    return jm, tm, fns


@pytest.mark.parametrize("engine", ["fp", "fold"])
@pytest.mark.parametrize("sample_type,steps", [("dpm_solver", 6),
                                               ("ddpm_noisy", 4)])
def test_pixel_pipeline_matches_jax(monkeypatch, pixel_pair, sample_type,
                                    steps, engine):
    jm, tm, fns = pixel_pair
    jfn, tfn = fns[engine]
    shape = (2, 16, 16, 3)
    x0 = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    kw = dict(timesteps=steps, sample_type=sample_type, image_size=16)
    want, traj = JaxPixel(jm, JaxSchedule.ddpm(*SCHED)).sample(
        None, 2, x_init=jnp.asarray(x0), model_fn=jfn, **kw)
    assert traj is None
    want = np.asarray(want)
    calls = []

    def counted(x, t):
        calls.append(t)
        return tfn(x, t)

    noise = _jax_step_noise(shape, steps)
    _inject(monkeypatch, noise, shape)
    got = PixelDiffusionPipeline(tm, NoiseSchedule.ddpm(*SCHED)).sample(
        2, x_init=torch.from_numpy(x0), model_fn=counted, **kw).numpy()
    assert noise == [] if sample_type == "ddpm_noisy" else \
        len(noise) == steps
    assert len(calls) == steps
    assert 0.05 < want.std() and np.isfinite(want).all()
    print(f"{sample_type} {engine}: max |port - JAX| "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pixel_dpm_solver_records_no_trajectory(pixel_pair):
    _, tm, _ = pixel_pair
    pipe = PixelDiffusionPipeline(tm, NoiseSchedule.ddpm(*SCHED))
    x, traj = pipe.sample(2, timesteps=3, sample_type="dpm_solver",
                          image_size=16, return_trajectory=True,
                          generator=torch.Generator().manual_seed(0))
    assert traj is None and x.shape == (2, 16, 16, 3)
    with pytest.raises(NotImplementedError):
        pipe.sample(1, sample_type="dpm_adaptive", image_size=16)


def _toy(xp, x, t):
    return 0.2 * x + 1e-4 * t[:, None, None, None]


def test_ddpm_sample_trajectory_matches_jax(monkeypatch):
    """10 steps of the quad sequence down to t = 0 on a toy model, JAX's
    noise injected: the samples and the recorded (x_t, t) within 1e-5;
    the last step (t = 0) adds no noise."""
    shape = (2, 4, 4, 3)
    x0 = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    seq = [0, 3, 11, 30, 70, 120, 200, 380, 600, 799]
    betas = NoiseSchedule.ddpm(*SCHED).betas
    key = jax.random.PRNGKey(4)
    want, jtraj = jax_ddim.ddpm_sample(lambda x, t: _toy(jnp, x, t),
                                       jnp.asarray(x0), seq, betas, rng=key,
                                       return_trajectory=True)
    noise = _jax_step_noise(shape, len(seq), key, split_first=False)
    last = noise[-1]
    _inject(monkeypatch, noise, shape)
    got, traj = ddim.ddpm_sample(lambda x, t: _toy(torch, x, t),
                                 torch.from_numpy(x0), seq, betas,
                                 return_trajectory=True)
    assert noise == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("xs", "ts"):
        assert traj[k].shape == jtraj[k].shape
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]),
                                   rtol=1e-5, atol=1e-5)
    # t = 0: the posterior mean alone, whatever the noise
    x1 = traj["xs"][-1]
    monkeypatch.setattr(torch, "randn", lambda *a, **kw: last * 1e3)
    again = ddim.ddpm_sample(lambda x, t: _toy(torch, x, t), x1, [0], betas)
    want0, _ = jax_ddim.ddpm_sample(lambda x, t: _toy(jnp, x, t),
                                    jnp.asarray(x1.numpy()), [0], betas)
    np.testing.assert_allclose(again.numpy(), np.asarray(want0), rtol=1e-5,
                               atol=1e-5)


def test_ddpm_bf16_carrier_keeps_f32_carry():
    seen = []

    def fn(x, t):
        seen.append(x.dtype)
        return 0.1 * x

    out = ddim.ddpm_sample(fn, torch.ones((1, 4, 4, 3)), [0, 500],
                           NoiseSchedule.ddpm(*SCHED).betas,
                           generator=torch.Generator().manual_seed(0),
                           eval_dtype=torch.bfloat16)
    assert seen == [torch.bfloat16] * 2 and out.dtype == torch.float32


def _jit3(fn):
    """A jitted (x, t, context) model function that JAX's DPM-Solver
    still sees as taking a context (it reads co_argcount)."""
    jf = jax.jit(fn)

    def call(x, t, context=None):
        return jf(x, t, context)

    return call


@pytest.mark.parametrize("name", ["sd", "beds"])
def test_latent_dpm_solver_matches_jax(name):
    """4 steps of multistep order 2 (the order-2 update at steps 2 and 3,
    order 1 at the last, as lower_order_final gives under 10 steps), no
    decode: SD with CFG 7.5 over [uncond; cond], beds without context."""
    jm, tm, params = ldm_tiny.build_pair(name)
    x, _, c = ldm_tiny.inputs(name)
    kw = dict(sampler="dpm_solver", steps=4, decode=False)
    if name == "sd":
        u = np.random.default_rng(9).standard_normal(c.shape).astype(
            np.float32)
        jkw = dict(cond=jnp.asarray(c), uncond=jnp.asarray(u),
                   guidance_scale=7.5)
        tkw = dict(cond=torch.from_numpy(c), uncond=torch.from_numpy(u),
                   guidance_scale=7.5)
    else:
        jkw = tkw = {}
    jpipe = JaxLatent(unet=jm, vae=None, schedule=JaxSchedule.ldm(
        "linear", 1000, 0.00085, 0.012))
    want, traj = jpipe.sample(
        params, None, 2, x_init=jnp.asarray(x), **kw, **jkw,
        model_fn=_jit3(lambda x, t, c: jm.apply(params, x, t, None,
                                                context=c)))
    assert traj is None
    rows = []
    pipe = LatentDiffusionPipeline(unet=tm, vae=None, schedule=NoiseSchedule.ldm(
        "linear", 1000, 0.00085, 0.012))
    base = pipe.model_fn()

    def fn(x, t, context=None):
        rows.append((x.shape[0], context is None))
        return base(x, t, context)

    got = pipe.sample(2, x_init=torch.from_numpy(x), model_fn=fn, **kw,
                      **tkw).numpy()
    assert rows == [(4, False) if name == "sd" else (2, True)] * 4
    want = np.asarray(want)
    assert 0.05 < want.std() and np.isfinite(want).all()
    print(f"{name} dpm_solver: max |port - JAX| "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def tiny_pixel(monkeypatch):
    monkeypatch.setitem(config.PRESETS, "tiny", TINY_TASK)


def _pixel_jax_reference(qpath, seed, sample_type, steps, noise=None):
    """JAX's fold W4 --split sample of the tiny pixel task on the CLI's
    params and per-item initial noise, as uint8."""
    jm = JaxUNet(JaxConfig(**UNET, split_shortcut=True),
                 JaxFlags(weight_bit=4).policy_ddim())
    m = _pixel_model(weight_bit=4, split=True)
    params = jax_fold(jm, to_jax_params(m.state_dict()),
                      jax_load_qstate(qpath))
    seeds = np.arange(2, dtype=np.int64) + np.int64(seed) * 1000003
    x0 = cli._item_noise(seeds, (8, 8, 3)).numpy()
    x, _ = JaxPixel(jm, JaxSchedule.ddpm("linear", 1e-4, 2e-2, 100)).sample(
        params, 2, timesteps=steps, skip_type="uniform", eta=0.0,
        sample_type=sample_type, image_size=8, x_init=jnp.asarray(x0),
        model_fn=jax.jit(lambda x, t: jm.apply(params, x, t, None)))
    return (np.asarray(jnp.clip((x + 1.0) / 2.0, 0.0, 1.0))
            * 255.0).astype(np.uint8)


def _within_one_level(got, want, what):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{what}: {int((diff > 0).sum())} of {diff.size} uint8 values "
          "differ")
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("sampler,steps", [("dpm_solver", 6),
                                           ("ddpm_noisy", 4)])
def test_pixel_cli_fold_matches_jax(tiny_pixel, monkeypatch, tmp_path,
                                    sampler, steps):
    q = init_weight_qstate(_pixel_model(weight_bit=4, split=True))
    qpath = tmp_path / "q.npz"
    save_qstate(qpath, q)
    shape = (2, 8, 8, 3)
    # JAX's CLI samples with the key of --seed; its pipeline splits it
    # once for the initial noise (here the port's per-item noise instead)
    noise = _jax_step_noise(shape, steps)
    want = _pixel_jax_reference(qpath, 7, sampler, steps)
    _inject(monkeypatch, noise, shape)
    out = cli.main(["sample", "--task", "tiny", "--qstate", str(qpath),
                    "--weight-bit", "4", "--split", "--engine", "fold",
                    "--sampler", sampler, "--timesteps", str(steps),
                    "--n", "2", "--batch", "2", "--seed", "7",
                    "--npz-out", str(tmp_path / "s.npz"), "--device", "cpu"])
    assert out["sampler"] == sampler and out["model_calls"] == [steps]
    assert out["steps"] == steps and out["nonfinite"] == 0
    with np.load(out["path"]) as f:
        got = f["arr_0"]
    assert noise == [] if sampler == "ddpm_noisy" else len(noise) == steps
    _within_one_level(got, want, f"{sampler} fold W4 CLI vs JAX")


@pytest.mark.parametrize("sampler", ["dpm_solver", "ddpm_noisy"])
@pytest.mark.parametrize("engine", ["sim", "int8", "stream"])
def test_pixel_cli_engines(tiny_pixel, tmp_path, engine, sampler):
    """Each engine under the new samplers: W4A8 --split for sim and int8
    (the int8 engine's integer kernels), W4 for stream; as many model
    calls as the solver's NFE (singlestep order 3 at 5 steps plans
    [3, 2]), finite uint8 images."""
    if engine == "stream":
        flags = ["--weight-bit", "4"]
        q = init_weight_qstate(_pixel_model(weight_bit=4))
    else:
        flags = ["--weight-bit", "4", "--quant-act", "--split"]
        m = _pixel_model(weight_bit=4, quant_act=True, split=True)
        rng = np.random.default_rng(0)
        xs = torch.from_numpy(rng.standard_normal((4, 8, 8, 3)).astype(
            np.float32))
        q = init_act_qstate(m, init_weight_qstate(m), xs,
                            torch.tensor([5.0, 30.0, 60.0, 95.0]))
    save_qstate(tmp_path / "q.npz", q)
    out = cli.main(["sample", "--task", "tiny", "--qstate",
                    str(tmp_path / "q.npz"), *flags, "--engine", engine,
                    "--sampler", sampler, "--timesteps", "5", "--n", "2",
                    "--batch", "2", "--npz-out", str(tmp_path / "s.npz"),
                    "--device", "cpu"])
    with np.load(out["path"]) as f:
        imgs = f["arr_0"]
    assert imgs.shape == (2, 8, 8, 3) and imgs.dtype == np.uint8
    assert out["nonfinite"] == 0 and out["engine"] == engine
    assert out["sampler"] == sampler and out["model_calls"] == [5]


def _sd_jax_reference(d, qpath, seed, steps):
    """JAX's fold W4 DPM-Solver sample of the tiny SD task on the same
    npz files and per-item initial noise, CFG 7.5, as uint8 (the pattern
    of test_torch_sd_cli.py::test_fold_w4_matches_jax)."""
    from qdiffusion_tpu.models.clip_text import CLIPTextConfig as JClipCfg
    from qdiffusion_tpu.models.clip_text import CLIPTextEncoder as JClip
    from qdiffusion_tpu.models.unet_ldm import LDMUNet as JLdm
    from qdiffusion_tpu.models.unet_ldm import LDMUNetConfig as JLdmCfg
    from qdiffusion_tpu.models.vae import VAE as JVae
    from qdiffusion_tpu.models.vae import VAEConfig as JVaeCfg
    from qdiffusion_tpu.utils.checkpoints import load_nested, load_pytree

    jm = JLdm(JLdmCfg(**SD_UNET), JaxFlags(weight_bit=4).policy_ldm())
    like = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = jax_fold(jm, load_pytree(d / "unet.npz", like),
                      jax_load_qstate(qpath))
    text = JClip(JClipCfg(**SD_CLIP))
    clip_params = load_nested(d / "clip.npz")
    encode = jax.jit(text.apply)
    with np.load(d / "ids.npz") as ids:
        cond = encode(clip_params, jnp.asarray(ids["cond"]))
        uncond = encode(clip_params, jnp.asarray(ids["uncond"]))
    pipe = JaxLatent(unet=jm, vae=JVae(JVaeCfg(**SD_VAE)),
                     schedule=JaxSchedule.ldm("linear", 1000, 0.00085,
                                              0.012),
                     scale_factor=0.18215, conditioning_key="crossattn",
                     text_encoder=text)
    seeds = np.arange(2, dtype=np.int64) + np.int64(seed) * 1000003
    x0 = cli._item_noise(seeds, (8, 8, 4)).numpy()
    z, _ = pipe.sample(
        params, None, 2, sampler="dpm_solver", steps=steps, latent_size=8,
        latent_channels=4, cond=jnp.tile(cond, (2, 1, 1)),
        uncond=jnp.tile(uncond, (2, 1, 1)), guidance_scale=7.5,
        x_init=jnp.asarray(x0), decode=False,
        model_fn=_jit3(lambda x, t, c: jm.apply(params, x, t, None,
                                                context=c)))
    img = jax.jit(pipe.decode_first_stage)(load_nested(d / "vae.npz"), z)
    return (np.asarray(jnp.clip((img + 1.0) / 2.0, 0.0, 1.0))
            * 255.0).astype(np.uint8)


def test_sd_cli_dpm_solver_fold_matches_jax(sd_files, monkeypatch,  # noqa: F811
                                            tmp_path):
    monkeypatch.setitem(config.PRESETS, "sd-tiny", SD_TASK)
    save_qstate(tmp_path / "q.npz", init_weight_qstate(_sd_unet(
        weight_bit=4)))
    out = cli.main(_sd_args(sd_files, "--qstate", str(tmp_path / "q.npz"),
                            "--weight-bit", "4", "--engine", "fold",
                            "--sampler", "dpm_solver", "--timesteps", "4",
                            "--n", "2", "--batch", "2", "--seed", "7",
                            "--npz-out", str(tmp_path / "fold.npz")))
    assert out["sampler"] == "dpm_solver" and out["model_calls"] == [4]
    assert out["guidance_scale"] == 7.5 and out["nonfinite"] == 0
    with np.load(out["path"]) as f:
        got = f["arr_0"]
    want = _sd_jax_reference(sd_files, tmp_path / "q.npz", 7, steps=4)
    assert want.std() > 5  # the images are not flat
    _within_one_level(got, want, "sd dpm_solver fold W4 CLI vs JAX")


@pytest.mark.parametrize("name,engine", [("beds", "int8"),
                                         ("church", "stream")])
def test_lsun_cli_dpm_solver(lsun_files, monkeypatch, tmp_path, name,  # noqa: F811
                             engine):
    task = lsun_files[name]["task"]
    monkeypatch.setitem(config.PRESETS, task.name, task)
    flags = {"int8": ("--engine", "int8", "--quant-act", "--a-min-max",
                      "--split"),
             "stream": ("--engine", "stream", "--stream-convs")}[engine]
    res = _sample(lsun_files, name, tmp_path,
                  "w4a8.npz" if engine == "int8" else "w4.npz", *flags,
                  "--sampler", "dpm_solver", "--timesteps", "3")
    imgs = _images(res)
    assert imgs.shape == (2, task.image_size, task.image_size, 3)
    assert imgs.dtype == np.uint8 and res["nonfinite"] == 0
    assert res["sampler"] == "dpm_solver" and res["model_calls"] == [3]
