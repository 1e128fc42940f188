"""The port's stream engine against the JAX package, on the CPU.

Kernels B5 and B6 run their plain versions here; the JAX side runs its
Pallas kernels in interpret mode. Tolerances:

  * B5 / B6 and the streamed conv / conv1d layers: both round x to bf16
    and multiply it by the same integer weights with f32 sums in another
    order: 1e-5 of the largest output (observed ~1e-7).
  * Packs: integer weights and nibble bytes bit for bit; the bf16 scale
    and shift of int8 packs bit for bit; the f32 scale / offset of int4
    packs bit for bit (the same f32 expression).
  * The cost model's stream-or-fold decision: equal on every shape.
  * Whole UNets: where no streamed layer takes an input that carries f32
    noise (the pixel UNet's dense-only packs, stream_convs False, and the
    cost model, True, which folds every conv at these tiny sizes: only
    the timestep MLP streams), the engines agree to 1e-4 relative L2
    (observed ~1e-6). Where they do (every conv streamed, "all"; the SD
    UNet's transformer linears), each streamed layer rounds its input to
    bf16, so f32 noise upstream (GroupNorm, the f32 convs) flips bf16
    roundings, each worth 2^-9 of a value, and the flips compound
    through the layers: 1e-2 (observed 2.0e-3 to 3.4e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.deploy import StaticMeta
from qdiffusion_tpu.deploy import make_quantized_step as jax_step
from qdiffusion_tpu.deploy import stream_pack_model as jax_stream_pack
from qdiffusion_tpu.ops import qlayers as jax_ql
from qdiffusion_tpu.ops.pallas import int4_matmul as jax_int4
from qdiffusion_tpu.ops.pallas.int8_matmul import \
    int8_dense_stream as jax_b5
from qdiffusion_tpu.ops.qlayers import LayerQuantConfig as JaxLCfg
from qdiffusion_tpu.quant.affine import AffineQuantizerSpec as JaxSpec
from qdiffusion_tpu.quant.affine import init_state as jax_init_state
from qdiffusion_tpu.quant.context import QuantCtx as JaxCtx
from qdiffusion_tpu.quant.context import QuantMode as JaxMode

from qdiffusion_torch import cli, config
from qdiffusion_torch.calib.engine import init_weight_qstate
from qdiffusion_torch.convert import qstate_from_jax, to_jax_params
from qdiffusion_torch.deploy import make_quantized_step, stream_pack_model
from qdiffusion_torch.ops import qlayers
from qdiffusion_torch.ops.int4_matmul import int4_dense_stream, \
    pack_int4_weight, unpack_int4_weight
from qdiffusion_torch.ops.int8_matmul import int8_dense_stream
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.utils.checkpoints import save_qstate

import test_torch_unet
import test_torch_unet_ldm

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- B5 / B6 -----------------------------------------------------------------

@pytest.mark.parametrize("lead,K,N", [((5,), 27, 3), ((2, 19), 46, 29),
                                      ((70,), 131, 140)])
def test_b5_plain_matches_pallas_kernel(lead, K, N):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    shift = rng.standard_normal(N).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(jax_b5(*map(jnp.asarray, (x, w, scale, shift, bias)),
                             interpret=True))
    got = int8_dense_stream(*map(torch.from_numpy, (x, w, scale, shift,
                                                    bias)))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("lead,K,N", [((5,), 28, 3), ((2, 19), 46, 29),
                                      ((70,), 300, 140)])
def test_b6_plain_matches_pallas_kernel(lead, K, N):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    nib = rng.integers(0, 16, (K, N)).astype(np.uint8)
    wp = np.asarray(jax_int4.pack_int4_weight(jnp.asarray(nib)))
    np.testing.assert_array_equal(
        pack_int4_weight(torch.from_numpy(nib)).numpy(), wp)
    np.testing.assert_array_equal(
        unpack_int4_weight(torch.from_numpy(wp)).numpy(), nib)
    delta = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    off = rng.standard_normal(N).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(jax_int4.int4_dense_stream(
        *map(jnp.asarray, (x, wp, delta, off, bias)), interpret=True))
    got = int4_dense_stream(*map(torch.from_numpy, (x, wp, delta, off,
                                                    bias)))
    assert got.shape == want.shape
    _close(got.numpy(), want)


# -- packs ---------------------------------------------------------------------

def _np(a):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


@pytest.mark.parametrize("split,wbits", [(False, 8), (True, 4)])
def test_stream_pack_matches_jax(split, wbits):
    jm, tm, params = test_torch_unet.build_pair(split=split,
                                                weight_bit=wbits)
    jq = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jax_init_w(jm, p))(params))
    jp = jax_stream_pack(jm, params, jq, dense_only=False)
    tp = stream_pack_model(tm, qstate_from_jax(jq), dense_only=False)
    assert list(tp) == list(jp) == list(tm.layer_cfgs)
    for name, je in jp.items():
        te = tp[name]
        assert set(te) == set(je), name
        if "kshape" in je:
            assert te["kshape"] == je["kshape"].value
            assert te["in_chs"] == je["in_chs"].value
        _close(_np(te["bias"]), _np(je["bias"]), rel=0)
        assert len(te["segs"]) == len(je["segs"]) == (
            2 if split and name.endswith("nin_shortcut")
            and name.startswith("up.") else 1)
        for ts, js in zip(te["segs"], je["segs"]):
            assert set(ts) == set(js)
            for k in js:
                assert ts[k].is_contiguous()
                np.testing.assert_array_equal(_np(ts[k]), _np(js[k]),
                                              err_msg=f"{name} {k}")
    # the deployed default streams the linears only
    dense = stream_pack_model(tm, qstate_from_jax(jq))
    assert set(dense) == set(jax_stream_pack(jm, params, jq)) == {
        n for n in tp if "kshape" not in tp[n]}


# -- the cost model ------------------------------------------------------------

def test_cost_model_decisions_match_jax():
    """_stream_conv_profitable on a grid of SD and CIFAR shapes: the same
    decision in both packages, and the JAX test's landmarks."""
    decisions = {}
    for kh in (1, 3):
        for ci, co in ((128, 128), (320, 320), (640, 1280), (1280, 1280),
                       (2560, 1280)):
            for bits in (4, 8):
                K = ci * kh * kh
                jseg, tseg = ({"wp": np.broadcast_to(np.uint8(0),
                                                     (K // 2, co))},
                              {"wp": torch.empty((K // 2, co),
                                                 dtype=torch.uint8,
                                                 device="meta")}) \
                    if bits == 4 else (
                        {"w_c": np.broadcast_to(np.int8(0), (K, co))},
                        {"w_c": torch.empty((K, co), dtype=torch.int8,
                                            device="meta")})
                jpk = {"kshape": StaticMeta((kh, kh)), "segs": [jseg]}
                tpk = {"kshape": (kh, kh), "segs": [tseg]}
                for b in (1, 2, 8):
                    for hw in (8, 16, 32, 64):
                        for stride in (1, 2):
                            xj = np.broadcast_to(np.float32(0),
                                                 (b, hw, hw, ci))
                            xt = torch.empty((b, ci, hw, hw), device="meta")
                            d = qlayers._stream_conv_profitable(
                                tpk, xt, stride=stride)
                            assert d == bool(jax_ql._stream_conv_profitable(
                                jpk, xj, stride=stride)), (kh, ci, co, bits,
                                                           b, hw, stride)
                            decisions[(kh, ci, co, bits, b, hw, stride)] = d
    assert not decisions[(3, 128, 128, 8, 8, 32, 1)]  # CIFAR conv: fold
    assert decisions[(3, 1280, 1280, 8, 2, 8, 1)]  # SD deep conv: stream
    assert decisions[(1, 2560, 1280, 4, 2, 16, 1)]  # large 1x1: stream
    assert not decisions[(1, 320, 320, 8, 2, 64, 1)]  # small 1x1: fold
    assert 0 < sum(decisions.values()) < len(decisions)


# -- streamed layers -----------------------------------------------------------

def _one_layer(kshape, ci, co, split, wbits, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((*kshape, ci, co)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    jspec = JaxSpec(n_bits=wbits, channel_wise=True, channel_axis=-1,
                    scale_method="max")
    in_axis = len(kshape)
    jcfg = JaxLCfg(wq=jspec, aq=jspec, split=split, in_axis=in_axis)

    class J:
        layer_cfgs = {"c": jcfg}

    if split:
        wa = w[(slice(None),) * in_axis + (slice(None, split),)]
        wb = w[(slice(None),) * in_axis + (slice(split, None),)]
        jq = {"c": {"w": jax_init_state(jnp.asarray(wa), jspec),
                    "w0": jax_init_state(jnp.asarray(wb), jspec)}}
    else:
        jq = {"c": {"w": jax_init_state(jnp.asarray(w), jspec)}}
    jq = jax.tree_util.tree_map(np.asarray, jq)
    p = {"c": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    jpack = jax_stream_pack(J, p, jq, dense_only=False)["c"]

    tspec = AffineQuantizerSpec(n_bits=wbits, channel_wise=True,
                                channel_axis=0, scale_method="max")
    layer = torch.nn.Module()
    layer.weight = torch.nn.Parameter(torch.from_numpy(w).permute(
        *range(w.ndim - 1, in_axis - 1, -1), *range(in_axis)).contiguous())
    layer.bias = torch.nn.Parameter(torch.from_numpy(b))

    class T:
        layer_cfgs = {"c": qlayers.LayerQuantConfig(wq=tspec, aq=tspec,
                                                    split=split)}

        @staticmethod
        def get_submodule(name):
            return layer

    tpack = stream_pack_model(T, qstate_from_jax(jq), dense_only=False)["c"]
    return jpack, tpack, (J, p, jcfg), (layer, T.layer_cfgs["c"])


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("khw,stride,split", [
    ((3, 3), 1, 0), ((3, 3), 2, 0), ((1, 1), 1, 0), ((3, 3), 1, 5)])
def test_stream_conv2d_matches_jax(wbits, khw, stride, split):
    jpack, tpack, _, _ = _one_layer(khw, 13, 24, split, wbits,
                                    seed=wbits + stride + split)
    x = np.random.default_rng(1).standard_normal((2, 9, 9, 13)).astype(
        np.float32)
    pad = 1 if khw == (3, 3) else 0
    want = np.asarray(jax_ql._stream_conv2d(jpack, jnp.asarray(x),
                                            stride=stride, padding=pad))
    got = qlayers._stream_conv2d(tpack, torch.from_numpy(x).permute(
        0, 3, 1, 2), stride=stride, padding=pad).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("wbits,split", [(8, 0), (4, 0), (4, 11)])
def test_stream_conv1d_k1_matches_jax(wbits, split):
    """k=1 conv1d (the legacy AttentionBlock's qkv / proj_out) streams as a
    dense over channels; an odd segment width pads x for the int4 pack."""
    jpack, tpack, (_, p, jcfg), (layer, tcfg) = _one_layer(
        (1,), 32, 48, split, wbits, seed=3)
    x = np.random.default_rng(2).standard_normal((2, 10, 32)).astype(
        np.float32)
    want = np.asarray(jax_ql.qconv1d(
        JaxCtx(None, mode=JaxMode(), engine="stream",
               packed={"c": jpack}), "c", p["c"], jnp.asarray(x), jcfg))
    got = qlayers.qconv1d(QuantCtx(None, mode=QuantMode(), engine="stream",
                                   packed={"c": tpack}), "c", layer,
                          torch.from_numpy(x), tcfg)
    _close(got.detach().numpy(), want)


# -- whole UNets ---------------------------------------------------------------

@pytest.mark.parametrize("split,wbits,cost_model", [(False, 8, False),
                                                   (True, 4, True)])
def test_tiny_ddim_stream_matches_jax(split, wbits, cost_model):
    jm, tm, params = test_torch_unet.build_pair(split=split,
                                                weight_bit=wbits)
    x, t = test_torch_unet.inputs()
    jq = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jax_init_w(jm, p))(params))
    tq = qstate_from_jax(jq)
    for convs, bound in ((cost_model, 1e-4), ("all", 1e-2)):
        want = np.asarray(jax_step(jm, params, jq, engine="stream",
                                   stream_convs=convs)(jnp.asarray(x),
                                                       jnp.asarray(t)))
        got = test_torch_unet.run_torch(make_quantized_step(
            tm, tq, engine="stream", stream_convs=convs), x, t)
        rel = _rel_l2(got, want)
        print(f"stream W{wbits} convs={convs}: rel L2 {rel:.3g}")
        assert rel <= bound


@pytest.mark.parametrize("name", ["sd", "beds"])
def test_tiny_ldm_stream_matches_jax(name):
    """SD_TINY (W4: linears through B6) and BEDS_TINY (W8: the k=1
    conv1d of the legacy AttentionBlock streamed with every conv)."""
    wbits, convs = (4, False) if name == "sd" else (8, "all")
    jm, tm, params = test_torch_unet_ldm.build_pair(name, weight_bit=wbits)
    x, t, c = test_torch_unet_ldm.inputs(name)
    jq = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jax_init_w(jm, p))(params))
    tq = qstate_from_jax(jq)
    step = jax_step(jm, params, jq, engine="stream", stream_convs=convs)
    args = [jnp.asarray(x), jnp.asarray(t)] + (
        [jnp.asarray(c)] if c is not None else [])
    want = np.asarray(step(*args))
    got = test_torch_unet_ldm._torch(make_quantized_step(
        tm, tq, engine="stream", stream_convs=convs), x, t, c)
    rel = _rel_l2(got, want)
    print(f"{name} stream W{wbits} convs={convs}: rel L2 {rel:.3g}")
    assert rel <= 1e-2


# -- the CLI -------------------------------------------------------------------

def test_cli_stream_matches_jax(tmp_path, monkeypatch):
    """`sample --engine stream --stream-convs` on the tiny pixel task
    against the JAX stream engine through the JAX DDIM loop (same params,
    qstate file and noise): uint8 images within one level on at most 1 %
    of the values. --dtype bfloat16 changes nothing (the engine keeps its
    own carrier)."""
    from qdiffusion_tpu.models.unet_ddim import DDIMUNet as JaxUNet
    from qdiffusion_tpu.models.unet_ddim import DDIMUNetConfig as JaxConfig
    from qdiffusion_tpu.config import QuantFlags as JaxFlags
    from qdiffusion_tpu.pipelines import PixelDiffusionPipeline as JaxPipe
    from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule
    from qdiffusion_tpu.utils.checkpoints import load_qstate as jax_load_q
    from test_torch_cli import TINY_TASK, UNET, _load, _model

    monkeypatch.setitem(config.PRESETS, "tiny", TINY_TASK)
    m = _model(weight_bit=4, split=True)
    save_qstate(tmp_path / "q.npz", init_weight_qstate(m))
    base = ["sample", "--task", "tiny", "--qstate", str(tmp_path / "q.npz"),
            "--weight-bit", "4", "--split", "--engine", "stream",
            "--stream-convs", "--n", "2", "--batch", "2", "--seed", "3",
            "--device", "cpu"]
    res = cli.main(base + ["--npz-out", str(tmp_path / "a.npz")])
    res16 = cli.main(base + ["--dtype", "bfloat16", "--npz-out",
                             str(tmp_path / "b.npz")])
    got = _load(res["path"])
    assert res["engine"] == "stream" and res["nonfinite"] == 0
    np.testing.assert_array_equal(got, _load(res16["path"]))

    jm = JaxUNet(JaxConfig(**UNET, split_shortcut=True),
                 JaxFlags(weight_bit=4).policy_ddim())
    step = jax_step(jm, to_jax_params(m.state_dict()),
                    jax_load_q(tmp_path / "q.npz"), engine="stream",
                    stream_convs=True)
    seeds = np.arange(2, dtype=np.int64) + np.int64(3) * 1000003
    x0 = cli._item_noise(seeds, (8, 8, 3)).numpy()
    x, _ = JaxPipe(jm, JaxSchedule.ddpm("linear", 1e-4, 2e-2, 100)).sample(
        None, 2, timesteps=4, skip_type="uniform", eta=0.0, image_size=8,
        x_init=jnp.asarray(x0), model_fn=step)
    want = (np.asarray(jnp.clip((x + 1.0) / 2.0, 0.0, 1.0)) * 255.0).astype(
        np.uint8)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_cli_sd_stream_runs(tmp_path, monkeypatch):
    """The tiny SD preset through `--engine stream --stream-convs` (W4:
    linears and the cost model's convs on B6's plain version): finite
    uint8 images, 5 UNet calls for PLMS-4."""
    from test_torch_sd_cli import TASK

    monkeypatch.setitem(config.PRESETS, "sd-tiny", TASK)
    d = tmp_path
    from qdiffusion_torch.models.clip_text import CLIPTextEncoder
    from qdiffusion_torch.models.unet_ldm import LDMUNet
    from qdiffusion_torch.models.vae import VAE
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.utils.checkpoints import save_nested, save_pytree

    unet = LDMUNet(TASK.unet_ldm, QuantFlags(weight_bit=4).policy_ldm(),
                   device="cpu")
    unet.load_state_dict(unet.init_params(0))
    save_pytree(d / "unet.npz", to_jax_params(unet.state_dict()))
    save_qstate(d / "q.npz", init_weight_qstate(unet))
    vae = VAE(TASK.vae, device="cpu")
    vae.load_state_dict(vae.init_params(1))
    save_nested(d / "vae.npz", to_jax_params(vae.state_dict()))
    clip = CLIPTextEncoder(TASK.clip, device="cpu")
    clip.load_state_dict(clip.init_params(2))
    save_nested(d / "clip.npz", to_jax_params(clip.state_dict()))
    ids = np.full((1, 77), 63, np.int64)
    ids[0, :3] = (1, 7, 9)
    np.savez(d / "ids.npz", cond=ids, uncond=np.full((1, 77), 63, np.int64))
    res = cli.main(["sample", "--task", "sd-tiny", "--ckpt",
                    str(d / "unet.npz"), "--vae-ckpt", str(d / "vae.npz"),
                    "--clip-ckpt", str(d / "clip.npz"), "--token-ids",
                    str(d / "ids.npz"), "--qstate", str(d / "q.npz"),
                    "--weight-bit", "4", "--engine", "stream",
                    "--stream-convs", "--n", "1", "--batch", "1",
                    "--npz-out", str(d / "o.npz"), "--device", "cpu"])
    imgs = np.load(res["path"])["arr_0"]
    assert imgs.shape == (1, 16, 16, 3) and imgs.dtype == np.uint8
    assert res["nonfinite"] == 0 and res["model_calls"] == [5]
