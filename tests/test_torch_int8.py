"""The port's int8 engine against the JAX package, on the CPU.

Kernel B4 (ops/int8_matmul.py) runs its plain version here; the JAX side
runs its Pallas kernel in interpret mode. Tolerances:

  * B4: the int32 product is exact on both sides (compared bit for bit
    through an identity epilogue); the f32 epilogue may be contracted
    into FMAs by XLA, so y agrees to 1e-6 of its largest value.
  * pack_layer: the int8 weights bit for bit, the f32 epilogue constants
    to 1e-6 relative (the same f32 expression).
  * int8_conv2d / int8_dense / int8_einsum on the same inputs: the same
    integer products and the same f32 epilogue, 1e-6 of the largest
    output (observed ~1e-7).
  * Whole UNets: f32 noise outside the integer products (GroupNorm,
    softmax, the sum order of the float ops) moves values across
    quantization-bucket boundaries, and every flip moves the next layer's
    input. Each activation quantizer site is held to one bucket beyond its
    input's drift, and eps to 5e-2 relative L2 with an f32 carrier
    (observed ~1.7e-2, the size of the sim engine's own port-vs-JAX
    divergence, test_torch_unet_ldm.py) and 6e-2 with the bf16 carrier
    (observed ~3e-2; the JAX package's own bound for the bf16 carrier
    against sim, test_int8.py:139-144).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qdiffusion_tpu.ops.int8 as jax_int8
from qdiffusion_tpu.calib.engine import init_act_qstate as jax_init_act
from qdiffusion_tpu.calib.engine import init_weight_qstate as jax_init_w
from qdiffusion_tpu.deploy import make_quantized_step as jax_step
from qdiffusion_tpu.deploy import pack_model as jax_pack_model
from qdiffusion_tpu.ops.pallas.int8_matmul import \
    int8_dense_pallas as jax_b4
from qdiffusion_tpu.ops.qlayers import LayerQuantConfig as JaxLCfg
from qdiffusion_tpu.quant.affine import AffineQuantizerSpec as JaxSpec
from qdiffusion_tpu.quant.affine import init_state as jax_init_state

import qdiffusion_torch.ops.int8 as int8
from qdiffusion_torch import cli, config
from qdiffusion_torch.calib.engine import init_act_qstate, init_weight_qstate
from qdiffusion_torch.convert import qstate_from_jax
from qdiffusion_torch.deploy import make_quantized_step, pack_model
from qdiffusion_torch.ops.int8_matmul import int8_dense_pallas
from qdiffusion_torch.ops.qlayers import LayerQuantConfig
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.utils.checkpoints import save_qstate

import test_torch_unet
import test_torch_unet_ldm

torch.set_num_threads(1)


def _close(got, want, rel=1e-6):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


# -- B4 ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 27, 3), (37, 46, 29), (70, 131, 140)])
def test_b4_plain_matches_pallas_kernel(shape):
    M, K, N = shape
    rng = np.random.default_rng(M)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    a, bc, c = (rng.uniform(1e-3, 1e-2, N).astype(np.float32),
                rng.standard_normal(N).astype(np.float32),
                rng.standard_normal(N).astype(np.float32))
    want = np.asarray(jax_b4(*map(jnp.asarray, (x, w, a, bc, c)),
                             interpret=True))
    got = int8_dense_pallas(*map(torch.from_numpy, (x, w, a, bc, c)))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close(got.numpy(), want)
    # the int32 product itself, through an identity epilogue
    one, zero = np.ones(N, np.float32), np.zeros(N, np.float32)
    acc_j = np.asarray(jax_b4(*map(jnp.asarray, (x, w, one, zero, zero)),
                              interpret=True))
    acc_t = int8_dense_pallas(*map(torch.from_numpy,
                                   (x, w, one, zero, zero))).numpy()
    assert np.abs(acc_j).max() < 2**24
    np.testing.assert_array_equal(acc_t, acc_j)


# -- packing and the layer functions ---------------------------------------------

WQ = dict(n_bits=8, channel_wise=True, scale_method="max")
AQ = dict(n_bits=8, symmetric=False, scale_method="max", leaf_param=True)


def _layer(kshape, ci, co, split=0, wbits=8, a_sym=False, bias=True, seed=0):
    """A random conv (kshape (kh, kw)) or dense (kshape ()) layer with
    weight and activation states, in both packages' layouts."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((*kshape, ci, co)) * 0.3).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32) if bias else None
    x = rng.standard_normal((2, 7, 7, ci) if kshape else (3, 5, ci)
                            ).astype(np.float32)
    jw = JaxSpec(**{**WQ, "n_bits": wbits}, channel_axis=-1)
    ja = JaxSpec(**{**AQ, "symmetric": a_sym})
    in_axis = w.ndim - 2
    jcfg = JaxLCfg(wq=jw, aq=ja, split=split, in_axis=in_axis)
    if split:
        idx = [slice(None)] * w.ndim
        wa = w[tuple(idx[:in_axis] + [slice(None, split)])]
        wb = w[tuple(idx[:in_axis] + [slice(split, None)])]
        jst = {"w": jax_init_state(jnp.asarray(wa), jw),
               "w0": jax_init_state(jnp.asarray(wb), jw),
               "a": jax_init_state(jnp.asarray(x[..., :split]), ja),
               "a0": jax_init_state(jnp.asarray(x[..., split:]), ja)}
    else:
        jst = {"w": jax_init_state(jnp.asarray(w), jw),
               "a": jax_init_state(jnp.asarray(x), ja)}
    jst = jax.tree_util.tree_map(np.asarray, jst)
    p = {"w": jnp.asarray(w), "b": None if b is None else jnp.asarray(b)}
    tcfg = LayerQuantConfig(
        wq=AffineQuantizerSpec(**{**WQ, "n_bits": wbits}, channel_axis=0),
        aq=AffineQuantizerSpec(**{**AQ, "symmetric": a_sym}), split=split)
    mod = torch.nn.Module()
    perm = (3, 2, 0, 1) if kshape else (1, 0)
    mod.weight = torch.nn.Parameter(torch.from_numpy(w).permute(*perm)
                                    .contiguous())
    mod.bias = None if b is None else torch.nn.Parameter(torch.from_numpy(b))
    tst = qstate_from_jax({"L": jst})["L"]
    return (p, jst, jcfg), (mod, tst, tcfg), x


@pytest.mark.parametrize("kshape,split", [((3, 3), 0), ((1, 1), 5), ((), 0),
                                          ((), 6)])
def test_pack_layer_matches_jax(kshape, split):
    (p, jst, jcfg), (mod, tst, tcfg), _ = _layer(kshape, 13, 24, split)
    jp = jax_int8.pack_layer(p, jst, jcfg)
    tp = int8.pack_layer(mod, tst, tcfg)
    assert len(jp.segments) == len(tp.segments) == (2 if split else 1)
    for js, ts in zip(jp.segments, tp.segments):
        w2d = np.asarray(js.w_c)
        if w2d.ndim == 4:  # HWIO -> the (c, kh, kw) x out order
            w2d = w2d.transpose(2, 0, 1, 3).reshape(-1, w2d.shape[-1])
        np.testing.assert_array_equal(ts.w_c.numpy(), w2d)
        assert ts.kshape == tuple(kshape) and ts.in_ch * int(
            np.prod(kshape, dtype=int)) == w2d.shape[0]
        for leaf in ("scale_a", "scale_s", "const", "a_delta", "a_zp"):
            np.testing.assert_allclose(getattr(ts, leaf).numpy(),
                                       np.asarray(getattr(js, leaf)),
                                       rtol=1e-6, err_msg=leaf)
        assert ts.a_pad == int(np.asarray(jax_int8._pad_value_i8(js)))
    np.testing.assert_array_equal(tp.bias.detach().numpy(), np.asarray(jp.bias))


@pytest.mark.parametrize("padding,stride,split,a_sym,wbits", [
    ("SAME", 1, 0, False, 8), (1, 1, 0, False, 8), ("VALID", 1, 0, False, 8),
    ("VALID", 2, 0, False, 8), ("SAME", 2, 0, False, 8),
    (1, 1, 0, True, 8), (1, 1, 8, False, 8), (1, 2, 0, False, 4)])
def test_int8_conv2d_matches_jax(padding, stride, split, a_sym, wbits):
    (p, jst, jcfg), (mod, tst, tcfg), x = _layer(
        (3, 3), 12, 10, split, wbits=wbits, a_sym=a_sym, seed=stride)
    want = np.asarray(jax_int8.int8_conv2d(
        jnp.asarray(x), jax_int8.pack_layer(p, jst, jcfg), stride=stride,
        padding=padding))
    got = int8.int8_conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), int8.pack_layer(mod, tst,
                                                                 tcfg),
        stride=stride, padding=padding).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got.numpy(), want)


def test_int8_conv2d_1x1_split_matches_jax():
    (p, jst, jcfg), (mod, tst, tcfg), x = _layer((1, 1), 12, 10, split=8,
                                                 seed=2)
    want = np.asarray(jax_int8.int8_conv2d(
        jnp.asarray(x), jax_int8.pack_layer(p, jst, jcfg), padding="VALID"))
    got = int8.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                           int8.pack_layer(mod, tst, tcfg))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("split", [0, 6])
def test_int8_dense_matches_jax(split):
    (p, jst, jcfg), (mod, tst, tcfg), x = _layer((), 16, 24, split, seed=3)
    want = np.asarray(jax_int8.int8_dense(
        jnp.asarray(x), jax_int8.pack_layer(p, jst, jcfg)))
    got = int8.int8_dense(torch.from_numpy(x),
                          int8.pack_layer(mod, tst, tcfg))
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("eq,sa,sb", [
    ("bic,bjc->bij", (2, 10, 16), (2, 12, 16)),
    ("bij,bjc->bic", (2, 10, 12), (2, 12, 16)),
    ("bthc,bshc->bhts", (2, 10, 4, 8), (2, 12, 4, 8)),
    ("bhts,bshc->bthc", (2, 4, 10, 12), (2, 12, 4, 8)),
    ("bihd,bjhd->bhij", (2, 10, 4, 8), (2, 12, 4, 8)),
    ("bhij,bjhd->bihd", (2, 4, 10, 12), (2, 12, 4, 8)),
    # a contraction longer than 1024: exact f32 chunks added in f64
    ("bic,bjc->bij", (1, 3, 1500), (1, 4, 1500)),
])
def test_int8_einsum_matches_jax(eq, sa, sb):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    post_softmax = eq.startswith(("bij", "bhts", "bhij"))
    if post_softmax:
        a = np.asarray(jax.nn.softmax(jnp.asarray(a), axis=-1))
    spec = dict(n_bits=8, scale_method="max", leaf_param=True)
    a_kw = dict(spec, always_zero=True) if post_softmax else spec
    ja, jb = JaxSpec(**a_kw), JaxSpec(**spec)
    a_st = jax.tree_util.tree_map(np.asarray,
                                  jax_init_state(jnp.asarray(a), ja))
    b_st = jax.tree_util.tree_map(np.asarray,
                                  jax_init_state(jnp.asarray(b), jb))
    want = np.asarray(jax_int8.int8_einsum(
        eq, jnp.asarray(a), jnp.asarray(b), a_st, b_st, ja, jb,
        out_dtype=jnp.float32))
    t = lambda st: {k: torch.from_numpy(np.asarray(v)) for k, v in
                    st.items()}
    got = int8.int8_einsum(eq, torch.from_numpy(a), torch.from_numpy(b),
                           t(a_st), t(b_st), AffineQuantizerSpec(**a_kw),
                           AffineQuantizerSpec(**spec),
                           out_dtype=torch.float32)
    assert got.shape == want.shape
    _close(got.numpy(), want)


# -- whole UNets -------------------------------------------------------------------

class _JaxQ:
    """Records the JAX int8 engine's quantize_act inputs and outputs, in
    program order, from inside its jitted step."""

    def __init__(self, monkeypatch):
        self.rec = []
        real = jax_int8.quantize_act

        def record(x, q, delta):
            self.rec.append((np.asarray(x, np.float32), np.asarray(q),
                             float(delta)))

        def spy(x, seg):
            q = real(x, seg)
            jax.debug.callback(record, x, q, seg.a_delta, ordered=True)
            return q

        monkeypatch.setattr(jax_int8, "quantize_act", spy)


class _TorchQ:
    def __init__(self, monkeypatch):
        self.rec = []
        real = int8.quantize_act

        def spy(x, seg):
            q = real(x, seg)
            nhwc = (lambda a: a.permute(0, 2, 3, 1)) if x.ndim == 4 else \
                (lambda a: a)
            self.rec.append((nhwc(x.float()).numpy(), nhwc(q).numpy()))
            return q

        monkeypatch.setattr(int8, "quantize_act", spy)


def _held_to_one_bucket(jrec, trec):
    """Every int8 activation within one bucket beyond its input's drift;
    returns (flipped values, total)."""
    assert len(jrec) == len(trec) > 0
    flips = total = 0
    for i, ((xj, qj, delta), (xt, qt)) in enumerate(zip(jrec, trec)):
        assert xj.shape == xt.shape, i
        dq = np.abs(qj.astype(np.int32) - qt.astype(np.int32))
        assert np.all(dq <= np.abs(xj - xt) / delta + 1 + 1e-5), i
        flips += int((dq > 0).sum())
        total += dq.size
    np.testing.assert_array_equal(jrec[0][1], trec[0][1])  # first site
    return flips, total


def test_tiny_ddim_int8_matches_jax(monkeypatch):
    """W8A8 with split shortcut, f32 carrier, per-site bucket bound; then
    the bf16 carrier."""
    jm, tm, params = test_torch_unet.build_pair(split=True, weight_bit=8,
                                                quant_act=True)
    x, t = test_torch_unet.inputs()
    jq = jax.jit(lambda p: jax_init_w(jm, p))(params)
    jq = jax.tree_util.tree_map(np.asarray, jax_init_act(
        jm, params, jq, jnp.asarray(x), jnp.asarray(t)))
    tq = qstate_from_jax(jq)
    packed = pack_model(tm, tq)
    # every conv and linear of the tiny UNet
    assert list(packed) == list(jax_pack_model(jm, params, jq)) == list(
        tm.layer_cfgs)

    jrec, trec = _JaxQ(monkeypatch), _TorchQ(monkeypatch)
    want = np.asarray(jax_step(jm, params, jq, engine="int8",
                               carrier_dtype=jnp.float32)(
        jnp.asarray(x), jnp.asarray(t)))
    jax.effects_barrier()
    got = test_torch_unet.run_torch(make_quantized_step(
        tm, tq, engine="int8", carrier_dtype=torch.float32), x, t)
    flips, total = _held_to_one_bucket(jrec.rec, trec.rec)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"int8 f32 carrier: rel L2 {rel:.3g}, {flips} of {total} int8 "
          "activations one or more buckets apart")
    assert got.dtype == np.float32 and rel <= 5e-2

    monkeypatch.undo()
    want16 = np.asarray(jax_step(jm, params, jq, engine="int8")(
        jnp.asarray(x), jnp.asarray(t)), np.float32)
    got16 = test_torch_unet.run_torch(make_quantized_step(
        tm, tq, engine="int8"), x, t)
    assert got16.dtype == np.float32  # cast back to x's dtype
    assert np.linalg.norm(got16 - want16) / np.linalg.norm(want16) <= 6e-2


def test_tiny_sd_int8_matches_jax():
    """SD_TINY (spatial transformer, context), f32 carrier: the int8
    engine keeps its integer attention products at the 64-token sites (no
    flash path) and its context projections take the f32 context."""
    from qdiffusion_torch.ops import flash_attention

    # 'max' activation init (--a-min-max) keeps the JAX init's compile
    # short; the weights keep the SD policy's 'mse' search
    jm, tm, params = test_torch_unet_ldm.build_pair(
        "sd", weight_bit=8, quant_act=True, a_min_max=True)
    x, t, c = test_torch_unet_ldm.inputs("sd")
    jq = jax.jit(lambda p: jax_init_w(jm, p))(params)
    jq = jax.tree_util.tree_map(np.asarray, jax_init_act(
        jm, params, jq, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c)))
    tq = qstate_from_jax(jq)
    want = np.asarray(jax_step(jm, params, jq, engine="int8",
                               carrier_dtype=jnp.float32)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(c)))
    seen = []
    real = flash_attention.flash_attention_plain
    flash_attention.flash_attention_plain = \
        lambda *a, **kw: seen.append(1) or real(*a, **kw)
    try:
        got = test_torch_unet_ldm._torch(make_quantized_step(
            tm, tq, engine="int8", carrier_dtype=torch.float32), x, t, c)
    finally:
        flash_attention.flash_attention_plain = real
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"SD int8 f32 carrier: rel L2 {rel:.3g}")
    assert not seen and np.isfinite(got).all() and rel <= 5e-2


# -- the CLI -------------------------------------------------------------------

def test_cli_int8_engine(tmp_path, monkeypatch):
    """`sample --engine int8 --quant-act` runs the int8 step (B4's plain
    version here); --dtype does not change it; without --quant-act the
    int8 engine is the weight-only sim, as the JAX CLI makes it."""
    from test_torch_cli import TINY_TASK, _load, _model

    monkeypatch.setitem(config.PRESETS, "tiny", TINY_TASK)
    m = _model(weight_bit=4, quant_act=True, split=True)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((4, 8, 8, 3)).astype(
        np.float32))
    ts = torch.from_numpy(rng.integers(0, 100, 4).astype(np.float32))
    q = init_act_qstate(m, init_weight_qstate(m), xs, ts)
    save_qstate(tmp_path / "q.npz", q)
    base = ["sample", "--task", "tiny", "--qstate", str(tmp_path / "q.npz"),
            "--weight-bit", "4", "--split", "--n", "2", "--batch", "2",
            "--timesteps", "2", "--device", "cpu"]
    calls = []
    real = int8.int8_dense_pallas
    monkeypatch.setattr(int8, "int8_dense_pallas",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    outs = {}
    for dtype in ("float32", "bfloat16"):
        res = cli.main(base + ["--quant-act", "--engine", "int8", "--dtype",
                               dtype, "--npz-out", str(tmp_path / dtype)])
        assert res["nonfinite"] == 0 and res["engine"] == "int8"
        outs[dtype] = _load(res["path"])
    assert outs["float32"].shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(outs["float32"], outs["bfloat16"])
    per_step = sum(len(p.segments) for p in pack_model(m, q).values())
    assert len(calls) == 2 * 2 * per_step  # two runs of two steps

    calls.clear()
    wo = cli.main(base + ["--engine", "int8", "--npz-out",
                          str(tmp_path / "wo.npz")])
    sim = cli.main(base + ["--engine", "sim", "--npz-out",
                           str(tmp_path / "sim.npz")])
    assert not calls
    np.testing.assert_array_equal(_load(wo["path"]), _load(sim["path"]))
