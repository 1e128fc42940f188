"""The LSUN latent-diffusion family (lsun_beds256: LDM-4, VQ-f4, DDIM-200
at eta 1; lsun_churches256: LDM-8, KL-f8, DDIM-400 at eta 0) of the port
against the JAX package, on the CPU, f32, at tiny sizes.

  * the four presets equal JAX's field for field (the port leaves out
    scale_by_std and cond_stage, which serve JAX's .ckpt / YAML readers);
  * the DDIM tables of both LSUN presets equal JAX's: the churches table
    has 500 entries (1000 // 400 = 2 strides), the reference's quirk;
  * decode of a tiny VQ-f4-shaped and a tiny KL-f8-shaped first stage:
    rtol = atol = 1e-4 (sum order, test_torch_vae_clip.py's bound); the
    VQ codes equal JAX's on seeded latents, at the full 8192 x 3 codebook
    too;
  * a tiny pipeline sample (BEDS_TINY / CHURCH_TINY UNet, then the
    decode): beds at eta 1 with JAX's step noise injected into the port,
    churches at eta 0 with its scale factor: rtol = atol = 1e-4;
  * the partitioned CHURCH_TINY under JAX's W4A8 init: the quantizer
    states the sim forward reads equal JAX's, eps within the LDM sim
    bound of test_torch_unet_ldm.py (0.15 absolute, 5e-2 relative L2);
  * the CLI on tiny LSUN-shaped tasks: `sample` through fold (churches
    against the JAX fold pipeline, uint8 within one level), int8 W4A8
    --split and stream W4, each with as many UNet calls as the sampler
    table has entries; `make-cali-data` (an eta 1 trajectory, sliced as
    JAX slices it) then `calibrate --quant-act --a-min-max`, whose qstate
    JAX reads and the int8 engine samples.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu import config as jax_config
from qdiffusion_tpu.calib.engine import init_act_qstate as jax_init_act
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.calib.samples import get_train_samples as jax_samples
from qdiffusion_tpu.config import QuantFlags as JaxFlags
from qdiffusion_tpu.deploy import fold_weights as jax_fold
from qdiffusion_tpu.models.unet_ldm import LDMUNet as JaxUNet
from qdiffusion_tpu.models.unet_ldm import LDMUNetConfig as JaxConfig
from qdiffusion_tpu.models.vae import VAE as JaxVAE
from qdiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from qdiffusion_tpu.pipelines import LatentDiffusionPipeline as JaxPipeline
from qdiffusion_tpu.quant.context import QuantMode as JaxMode
from qdiffusion_tpu.samplers.ldm import DDIMTables as JaxTables
from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule
from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_qstate

from qdiffusion_torch import cli, config
from qdiffusion_torch.calib.engine import init_act_qstate, \
    init_weight_qstate
from qdiffusion_torch.calib.samples import get_train_samples
from qdiffusion_torch.config import QuantFlags
from qdiffusion_torch.convert import from_jax_params, qstate_from_jax, \
    to_jax_params
from qdiffusion_torch.models import vae as vae_mod
from qdiffusion_torch.models.unet_ldm import LDMUNet, LDMUNetConfig
from qdiffusion_torch.models.vae import VAE, VAEConfig
from qdiffusion_torch.pipelines import LatentDiffusionPipeline
from qdiffusion_torch.quant.context import QuantMode
from qdiffusion_torch.samplers.ldm import DDIMTables
from qdiffusion_torch.utils.checkpoints import load_qstate, save_nested, \
    save_qstate

from test_torch_calib_ldm import _JaxReads, _Reads, _pair
from test_torch_unet_ldm import BEDS_TINY, CHURCH_TINY, random_tree

torch.set_num_threads(1)

# tiny first stages of the two LSUN shapes: VQ-f4 (three levels, a
# codebook) and KL-f8 (four levels), 128-channel mid attention
VQ_F4 = dict(ch=32, out_ch=3, ch_mult=(1, 2, 4), num_res_blocks=1,
             attn_resolutions=(), in_channels=3, resolution=32, z_channels=3,
             double_z=False, embed_dim=3, n_embed=64)
KL_F8 = dict(ch=32, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
             attn_resolutions=(), in_channels=3, resolution=32, z_channels=4,
             double_z=True, embed_dim=4)
LATENT = 8  # tiny latents: 32x32 VQ-f4 images, 64x64 KL-f8 ones
FAMILY = {
    "beds": dict(unet=BEDS_TINY, vae=VQ_F4, task="lsun_beds256", eta=1.0),
    "church": dict(unet=CHURCH_TINY, vae=KL_F8, task="lsun_churches256",
                   eta=0.0)}


def _fields_equal(ours, theirs, path):
    """Every field of the port's dataclass equals JAX's, recursively."""
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b, f"{path}.{f.name}")
        else:
            assert a == b, (f"{path}.{f.name}", a, b)


@pytest.mark.parametrize("name", ["cifar10", "lsun_beds256",
                                  "lsun_churches256", "sd_v1"])
def test_presets_match_jax(name):
    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    ours, theirs = config.PRESETS[name], jax_config.PRESETS[name]
    _fields_equal(ours, theirs, name)
    left_out = {f.name for f in dataclasses.fields(theirs)} \
        - {f.name for f in dataclasses.fields(ours)}
    assert left_out == {"scale_by_std", "cond_stage"}
    assert not theirs.scale_by_std and theirs.cond_stage is None


@pytest.mark.parametrize("name,length", [("lsun_beds256", 200),
                                         ("lsun_churches256", 500)])
def test_lsun_ddim_tables_match_jax(name, length):
    """The CLI's schedule and sampler tables for the preset: churches asks
    for 400 steps and, as in JAX (schedules.py:119-121), gets 500."""
    task = config.PRESETS[name]
    s = task.schedule
    ours = cli._schedule(task)
    theirs = JaxSchedule.ldm(s.beta_schedule, s.num_timesteps, s.beta_start,
                             s.beta_end)
    np.testing.assert_array_equal(ours.alphas_cumprod, theirs.alphas_cumprod)
    a = DDIMTables.build(ours.alphas_cumprod, task.sampler.timesteps,
                         task.sampler.eta)
    b = JaxTables.build(theirs.alphas_cumprod, task.sampler.timesteps,
                        task.sampler.eta)
    assert len(a.timesteps) == len(b.timesteps) == length
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas",
              "sigmas"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.sigmas > 0).all() == (task.sampler.eta > 0)


def _vae_pair(cfg, seed=3):
    """(JAX VAE, its numpy params with random biases and norms, the port's
    VAE holding them)."""
    jvae = JaxVAE(JaxVAEConfig(**cfg))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        np.asarray, jvae.init_params(jax.random.PRNGKey(seed)))
    params = jax.tree_util.tree_map(
        lambda a: a if a.ndim >= 2 else (a + 0.1 * rng.standard_normal(
            a.shape)).astype(np.float32), tree)
    vae = VAE(VAEConfig(**cfg), device="cpu")
    vae.load_state_dict(from_jax_params(params))  # strict: whole tree
    return jvae, params, vae


def _jax_codes(jvae, params, z):
    """JAX's VQ codes: the codebook row nearest to its vq_lookup output
    (z + (e - z) is e to f32 rounding; codebook rows are far apart)."""
    emb = params["quantize"]["embedding"]["weight"]
    snapped = np.asarray(jvae.vq_lookup(params, jnp.asarray(z)))
    flat = snapped.reshape(-1, emb.shape[1])
    return ((flat[:, None, :] - emb[None]) ** 2).sum(-1).argmin(1)


@pytest.mark.parametrize("kind", ["vq_f4", "kl_f8"])
def test_lsun_first_stage_decode_matches_jax(monkeypatch, kind):
    """Both decoders' mid attention (64 and 16 tokens, one head of 128
    channels) on the blockwise path with FLASH_TOKENS at 16, as in
    test_torch_vae_clip.py; the VQ codes of the decode's input equal
    JAX's."""
    cfg = VQ_F4 if kind == "vq_f4" else KL_F8
    jvae, params, vae = _vae_pair(cfg)
    monkeypatch.setattr(vae_mod, "FLASH_TOKENS", 16)
    z = 1.5 * np.random.default_rng(4).standard_normal(
        (2, LATENT, LATENT, cfg["embed_dim"] if cfg.get("n_embed")
         else cfg["z_channels"])).astype(np.float32)
    want = np.asarray(jax.jit(jvae.decode)(params, jnp.asarray(z)))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    f = 2 ** (len(cfg["ch_mult"]) - 1)
    assert got.shape == want.shape == (2, LATENT * f, LATENT * f, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if kind == "vq_f4":
        codes = vae.vq_codes(torch.from_numpy(z).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(codes.numpy(),
                                      _jax_codes(jvae, params, z))


def test_vq_codes_at_the_full_codebook_match_jax():
    """The beds preset's 8192 x 3 codebook (seeded N(0, 1) rows) on
    32x32 seeded latents: every code equals JAX's."""
    cfg = dict(VQ_F4, n_embed=config.PRESETS["lsun_beds256"].vae.n_embed)
    jvae = JaxVAE(JaxVAEConfig(**cfg))
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((cfg["n_embed"], 3)).astype(np.float32)
    params = {"quantize": {"embedding": {"weight": emb}}}
    vae = VAE(VAEConfig(**cfg), device="cpu")
    with torch.no_grad():
        vae.quantize.embedding.weight.copy_(torch.from_numpy(emb))
    z = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    codes = vae.vq_codes(torch.from_numpy(z).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(codes, _jax_codes(jvae, params, z))
    assert len(np.unique(codes)) > 500  # the lookup spreads over the book


def _family_pair(name):
    """(JAX pipeline, JAX params, JAX VAE params, port pipeline) of a tiny
    LSUN-shaped family, the preset's schedule and scale factor."""
    fam = FAMILY[name]
    task = config.PRESETS[fam["task"]]
    s = task.schedule
    jm = JaxUNet(JaxConfig(**fam["unet"]))
    tm = LDMUNet(LDMUNetConfig(**fam["unet"]), device="cpu")
    params = random_tree(jax.eval_shape(jm.init_params,
                                        jax.random.PRNGKey(0)), 0)
    tm.load_state_dict(from_jax_params(params))
    jvae, vparams, vae = _vae_pair(fam["vae"])
    jpipe = JaxPipeline(unet=jm, vae=jvae, schedule=JaxSchedule.ldm(
        s.beta_schedule, s.num_timesteps, s.beta_start, s.beta_end),
        scale_factor=task.scale_factor)
    pipe = LatentDiffusionPipeline(unet=tm, vae=vae,
                                   schedule=cli._schedule(task),
                                   scale_factor=task.scale_factor)
    return jpipe, params, vparams, pipe


@pytest.mark.parametrize("name", ["beds", "church"])
def test_tiny_lsun_pipeline_sample_matches_jax(monkeypatch, name):
    """4 DDIM steps then the decode. Beds runs at eta 1: JAX draws each
    step's noise from its key (pipelines.py splits the key once for the
    initial noise, then ddim_sample_ldm once per step); those draws are
    injected as the port's torch.randn results."""
    fam = FAMILY[name]
    jpipe, params, vparams, pipe = _family_pair(name)
    steps, n = 4, 2
    shape = (n, LATENT, LATENT, fam["unet"]["in_channels"])
    x0 = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    img, _ = jpipe.sample(params, vparams, n, sampler="ddim", steps=steps,
                          eta=fam["eta"], x_init=jnp.asarray(x0),
                          rng=jax.random.PRNGKey(0))
    want = np.asarray(img)
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    real = torch.randn

    def injected(size, *a, **kw):
        assert tuple(size) == shape
        return noise.pop(0)

    if fam["eta"] > 0:
        monkeypatch.setattr(torch, "randn", injected)
    got = pipe.sample(n, sampler="ddim", steps=steps, eta=fam["eta"],
                      x_init=torch.from_numpy(x0)).numpy()
    monkeypatch.setattr(torch, "randn", real)
    assert noise == [] if fam["eta"] > 0 else len(noise) == steps
    f = 2 ** (len(fam["vae"]["ch_mult"]) - 1)
    assert got.shape == want.shape == (n, LATENT * f, LATENT * f, 3)
    assert 0.05 < want.std()  # not clipped flat
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_partitioned_church_sim_forward_reads_jax_sites():
    """CHURCH_TINY (scale-shift norm, resblock up/down, num_heads) with
    the act-quant partition under JAX's W4A8 init ('max' acts): the port's
    sim forward reads every quantizer state JAX's does and its eps is
    within the LDM sim bound."""
    jm, tm, params = _pair("church", partition=True)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((8, 16, 16, 4)).astype(np.float32)
    ts = np.linspace(0, 999, 8).astype(np.float32)
    jq = jax.jit(lambda p: jax_init_w(jm, p))(params)
    jq = jax.tree_util.tree_map(np.asarray, jax_init_act(
        jm, params, jq, jnp.asarray(xs), jnp.asarray(ts), None))
    reads = set()

    def run(p, q, x, t):  # the reads are recorded while jit traces
        ctx = _JaxReads(q, mode=JaxMode(w=True, a=True))
        ctx.reads = reads
        return jm.apply(p, x, t, ctx)

    want = np.asarray(jax.jit(run)(params, jq, jnp.asarray(xs[:2]),
                                   jnp.asarray(ts[:2])))
    tctx = _Reads(qstate_from_jax(jq), mode=QuantMode(w=True, a=True))
    tctx.reads = set()
    with torch.no_grad():
        got = tm(torch.from_numpy(xs[:2]), torch.from_numpy(ts[:2]),
                 tctx).numpy()
    assert tctx.reads == reads
    assert {s for s, k in reads if k == "sm"} == {
        u.name for u in tm.units if u.kind == "smvmatmul"}
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"partitioned church sim W4A8: rel L2 {rel:.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=0.15)
    assert rel <= 5e-2


def test_every_conv_and_norm_input_stays_channels_last(monkeypatch):
    """A churches-shaped UNet (resblock up/down, scale-shift) on latents
    whose lowest level is 1x1: a 1x1 activation is NCHW-contiguous and
    channels_last at once, and upsampling it used to give an NCHW tensor,
    which B4 and B1 refuse on the card. Every conv input and every B1
    input must be channels_last (the CPU path accepts either, so the
    layout is checked here)."""
    from qdiffusion_torch import nn as qnn
    from qdiffusion_torch.ops import qlayers

    cfg = LDMUNetConfig(**dict(CHURCH_TINY, channel_mult=(1, 2, 2)))
    model = LDMUNet(cfg, device="cpu")
    model.load_state_dict(model.init_params(0))
    seen = []
    real_conv, real_gn = qlayers.nn.conv2d, qnn.fused_group_norm

    def conv(x, *a, **kw):
        seen.append(("conv", tuple(x.shape), x.is_contiguous(
            memory_format=torch.channels_last)))
        return real_conv(x, *a, **kw)

    def gn(x, *a, **kw):
        seen.append(("norm", tuple(x.shape), x.is_contiguous()))
        return real_gn(x, *a, **kw)

    monkeypatch.setattr(qlayers.nn, "conv2d", conv)
    monkeypatch.setattr(qnn, "fused_group_norm", gn)
    with torch.no_grad():
        model(torch.randn(1, 4, 4, 4), torch.tensor([10.0]))
    assert any(s[1][2:] == (1, 1) for s in seen if s[0] == "conv")
    assert all(ok for _, _, ok in seen), [s for s in seen if not s[2]]


# -- the CLI on tiny LSUN-shaped tasks ----------------------------------------

def _tiny_task(name, steps):
    fam = FAMILY[name]
    preset = config.PRESETS[fam["task"]]
    return dataclasses.replace(
        preset, name=f"{name}-tiny",
        sampler=dataclasses.replace(preset.sampler, timesteps=steps),
        image_size=LATENT * 2 ** (len(fam["vae"]["ch_mult"]) - 1),
        latent_size=LATENT, latent_channels=fam["unet"]["in_channels"],
        unet_ldm=LDMUNetConfig(**fam["unet"]), vae=VAEConfig(**fam["vae"]))


# churches: 6 steps ask for a stride of 166, which gives 7 table entries,
# as 400 give 500 at full size
TINY_STEPS = {"beds": 4, "church": 6}
TINY_CALLS = {"beds": 4, "church": 7}


@pytest.fixture(scope="module")
def lsun_files(tmp_path_factory):
    """Per family: the tiny preset, the VAE npz, a W4 weight qstate and a
    W4A8 --split qstate of the partitioned UNet (the --quant-act model),
    both from the CLI's seed-0 params."""
    root = tmp_path_factory.mktemp("lsun")
    out = {}
    rng = np.random.default_rng(8)
    for name in FAMILY:
        task = _tiny_task(name, TINY_STEPS[name])
        d = root / name
        d.mkdir()
        vae = VAE(task.vae, device="cpu")
        vae.load_state_dict(vae.init_params(1))
        save_nested(d / "vae.npz", to_jax_params(vae.state_dict()))
        w4 = LDMUNet(task.unet_ldm, QuantFlags(weight_bit=4).policy_ldm(),
                     device="cpu")
        w4.load_state_dict(w4.init_params(0))
        save_qstate(d / "w4.npz", init_weight_qstate(w4))
        flags = QuantFlags(weight_bit=4, quant_act=True, a_min_max=True,
                           split=True)
        m, _ = cli.build_model_and_pipeline(task, flags, "cpu",
                                            act_quant=True)
        m.load_state_dict(m.init_params(0))
        xs = torch.from_numpy(rng.standard_normal(
            (4, LATENT, LATENT, task.latent_channels)).astype(np.float32))
        ts = torch.tensor([10.0, 300.0, 600.0, 900.0])
        save_qstate(d / "w4a8.npz",
                    init_act_qstate(m, init_weight_qstate(m), xs, ts))
        out[name] = dict(task=task, dir=d, w4=w4)
    return out


def _sample(files, name, tmp_path, qstate, *flags):
    f = files[name]
    return cli.main(["sample", "--task", f["task"].name, "--vae-ckpt",
                     str(f["dir"] / "vae.npz"), "--qstate",
                     str(f["dir"] / qstate), "--weight-bit", "4", *flags,
                     "--n", "2", "--batch", "2", "--seed", "3",
                     "--npz-out", str(tmp_path / f"{name}.npz"),
                     "--device", "cpu"])


def _images(res):
    with np.load(res["path"]) as f:
        return f["arr_0"]


@pytest.mark.parametrize("name", ["beds", "church"])
@pytest.mark.parametrize("engine", ["fold", "int8", "stream"])
def test_lsun_cli_sample_engines(lsun_files, monkeypatch, tmp_path, name,
                                 engine):
    task = lsun_files[name]["task"]
    monkeypatch.setitem(config.PRESETS, task.name, task)
    flags = {"fold": ("--engine", "fold"),
             "int8": ("--engine", "int8", "--quant-act", "--a-min-max",
                      "--split"),
             "stream": ("--engine", "stream", "--stream-convs")}[engine]
    res = _sample(lsun_files, name, tmp_path,
                  "w4a8.npz" if engine == "int8" else "w4.npz", *flags)
    imgs = _images(res)
    assert imgs.shape == (2, task.image_size, task.image_size, 3)
    assert imgs.dtype == np.uint8 and res["nonfinite"] == 0
    assert res["sampler"] == "ddim" and res["steps"] == TINY_STEPS[name]
    assert res["model_calls"] == [TINY_CALLS[name]]
    assert imgs.std() > 1  # not clipped flat


def test_church_cli_fold_matches_jax(lsun_files, monkeypatch, tmp_path):
    """The churches-shaped fold W4 sample (eta 0, scale factor 0.18215,
    KL-f8 decode) against the JAX fold engine and pipeline on the same
    params, qstate file and per-item initial noise: uint8 within one
    level, on under 1 % of the values."""
    f = lsun_files["church"]
    task = f["task"]
    monkeypatch.setitem(config.PRESETS, task.name, task)
    got = _images(_sample(lsun_files, "church", tmp_path, "w4.npz",
                          "--engine", "fold"))
    s = task.schedule
    jm = JaxUNet(JaxConfig(**CHURCH_TINY),
                 JaxFlags(weight_bit=4).policy_ldm())
    jvae = JaxVAE(JaxVAEConfig(**KL_F8))
    vae = VAE(task.vae, device="cpu")
    vae.load_state_dict(vae.init_params(1))
    params = jax_fold(jm, to_jax_params(f["w4"].state_dict()),
                      jax_load_qstate(f["dir"] / "w4.npz"))
    seeds = np.arange(2, dtype=np.int64) + np.int64(3) * 1000003
    x0 = cli._item_noise(seeds, (LATENT, LATENT, 4)).numpy()
    img, _ = JaxPipeline(unet=jm, vae=jvae, schedule=JaxSchedule.ldm(
        s.beta_schedule, s.num_timesteps, s.beta_start, s.beta_end),
        scale_factor=task.scale_factor).sample(
        params, to_jax_params(vae.state_dict()), 2, sampler="ddim",
        steps=TINY_STEPS["church"], eta=0.0, x_init=jnp.asarray(x0))
    want = (np.asarray(img) * 255.0).astype(np.uint8)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"church fold W4 CLI vs JAX: {int((diff > 0).sum())} of "
          f"{diff.size} uint8 values differ")
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_beds_make_cali_data_calibrate_then_int8(lsun_files, monkeypatch,
                                                 tmp_path):
    """beds-shaped W4A8 in the LSUN form: make-cali-data (DDIM at eta 1,
    its noise from --seed: the same command twice writes the same file),
    get_train_samples as JAX's, calibrate --weight-bit 4 --split
    --quant-act --a-min-max --running-stat on the partitioned model (its
    qstate loads in JAX with the attention quantizers at the partition's
    sites), then sample --engine int8 on it."""
    f = lsun_files["beds"]
    task = f["task"]
    monkeypatch.setitem(config.PRESETS, task.name, task)
    trajs = []
    for i in range(2):
        path = tmp_path / f"traj{i}.npz"
        made = cli.main(["make-cali-data", "--task", task.name, "--n", "4",
                         "--out", str(path), "--device", "cpu"])
        assert made["shapes"] == {"xs": (4, 4, LATENT, LATENT, 3),
                                  "ts": (4, 4)}
        with np.load(path) as d:
            trajs.append({k: d[k] for k in d.files})
    for k in ("xs", "ts"):
        np.testing.assert_array_equal(trajs[0][k], trajs[1][k])
    got = get_train_samples({k: torch.from_numpy(v)
                             for k, v in trajs[0].items()}, 4, 2)
    want = jax_samples({k: jnp.asarray(v) for k, v in trajs[0].items()}, 4,
                       2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    res = cli.main(["calibrate", "--task", task.name, "--cali-data",
                    str(tmp_path / "traj0.npz"), "--weight-bit", "4",
                    "--split", "--quant-act", "--a-min-max",
                    "--running-stat", "--cali-st", "2", "--cali-n", "4",
                    "--cali-batch-size", "4", "--cali-iters", "2",
                    "--cali-iters-a", "2", "--act-init-batch", "4",
                    "--run-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert res["samples"] == 8
    q = load_qstate(res["path"])
    parts = [s for s in q if ".attention." in s]
    assert parts and all(set(q[s]) == ({"q", "k"} if s.endswith("qkv_matmul")
                                       else {"sm", "v"}) for s in parts)
    assert sorted(jax_load_qstate(res["path"])) == sorted(q)
    out = cli.main(["sample", "--task", task.name, "--vae-ckpt",
                    str(f["dir"] / "vae.npz"), "--qstate", res["path"],
                    "--weight-bit", "4", "--quant-act", "--a-min-max",
                    "--split", "--engine", "int8", "--n", "2", "--batch",
                    "2", "--timesteps", "2",
                    "--npz-out", str(tmp_path / "s.npz"), "--device", "cpu"])
    assert out["nonfinite"] == 0 and out["model_calls"] == [2]
    assert _images(out).shape == (2, task.image_size, task.image_size, 3)
