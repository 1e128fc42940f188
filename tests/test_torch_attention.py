"""Attention of the port against the JAX package, on the CPU.

  * B2/B3 plain versions (the port's kernels' functions on a CPU tensor)
    against the Pallas kernels in interpret mode, as
    tests/test_pallas_flash*.py run them: f32 and bf16, without and with
    sm_q/v_q, a symmetric and an always_zero softmax spec, S = 200 (not a
    multiple of 128, several key blocks) and D = 40.
  * materializing_attention and the blockwise loop against JAX.
  * the dispatch: blockwise_attention picks B2 or B3 where the JAX cost
    model (`_pick_tile_q`) does.

Tolerances: f32 1e-5 (sum order only). A fake-quant bucket can flip
where f32 sum-order noise moves p across a rounding boundary; a flipped
element moves the output by at most delta * max|v|, and at most 1e-3 of
the elements may do so. bf16 2e-2 absolute and relative (one bf16
rounding of p and of the output, the JAX bf16 tests' tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.ops.attention import blockwise_attention as jax_blockwise
from qdiffusion_tpu.ops.attention import materializing_attention as jax_mat
from qdiffusion_tpu.ops.pallas.flash_attention import _pick_tile_q, \
    flash_attention as jax_flash
from qdiffusion_tpu.ops.pallas.flash_streaming import \
    streaming_flash_attention as jax_stream
from qdiffusion_tpu.quant.affine import AffineQuantizerSpec as JaxSpec

from qdiffusion_torch.ops import attention, flash_attention, flash_streaming
from qdiffusion_torch.quant.affine import AffineQuantizerSpec

torch.set_num_threads(1)

B, T, S, H, D = 2, 24, 200, 2, 40
SPECS = {
    "always_zero": dict(n_bits=8, always_zero=True, leaf_param=True),
    "symmetric": dict(n_bits=8, symmetric=True),
}
V_SPEC = dict(n_bits=8, leaf_param=True)


def _qkv(dtype, seed=0, shape=(B, T, S, H, D)):
    b, t, s, h, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, t, h, d), (b, s, h, d), (b, s, h, d))]


def _states(kind):
    """(sm state, v state) as numpy scalars; the sm delta is picked so the
    grid is not aligned with any power of two."""
    sm = {"delta": np.float32(1 / 251.3), "zero_point": np.float32(0.0)}
    v = {"delta": np.float32(6.1 / 255), "zero_point": np.float32(127.0)}
    return sm, v


def _pairs(kind, torch_side):
    if kind is None:
        return None, None
    sm, v = _states(kind)
    if torch_side:
        to = lambda st: {k: torch.tensor(a) for k, a in st.items()}
        return ((to(sm), AffineQuantizerSpec(**SPECS[kind])),
                (to(v), AffineQuantizerSpec(**V_SPEC)))
    to = lambda st: {k: jnp.asarray(a) for k, a in st.items()}
    return ((to(sm), JaxSpec(**SPECS[kind])), (to(v), JaxSpec(**V_SPEC)))


def _assert_close(got, want, dtype, kind, v):
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        return
    diff = np.abs(got - want)
    if kind is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    flip = _states(kind)[0]["delta"] * np.abs(v).max()
    assert diff.max() <= 1e-5 + flip, diff.max()
    assert (diff > 1e-5).mean() <= 1e-3


def _run_pair(kernel, dtype, kind, seed):
    q, k, v = _qkv(dtype, seed)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tsm, tvq = _pairs(kind, True)
    jsm, jvq = _pairs(kind, False)
    if kernel == "B2":
        got = flash_attention.flash_attention(tq, tk, tv, scale=0.3,
                                              sm_q=tsm, v_q=tvq)
        want = jax_flash(jq, jk, jv, scale=0.3, sm_q=jsm, v_q=jvq,
                         interpret=True)
    else:
        got = flash_streaming.streaming_flash_attention_plain(
            tq, tk, tv, scale=0.3, sm_q=tsm, v_q=tvq, block_k=128)
        want = jax_stream(jq, jk, jv, scale=0.3, sm_q=jsm, v_q=jvq,
                          tile_q=8, block_k=128, interpret=True)
    assert got.dtype == tdt and got.shape == (B, T, H, D)
    return got.float().numpy(), np.asarray(want, np.float32), v


@pytest.mark.parametrize("kind", [None, "always_zero", "symmetric"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["B2", "B3"])
def test_plain_matches_pallas_interpret(kernel, dtype, kind):
    got, want, v = _run_pair(kernel, dtype, kind, seed=1)
    _assert_close(got, want, dtype, kind, v)


def test_b2_and_b3_differ_where_their_kernels_do():
    """bf16 without sm_q: B2 normalises after PV, B3 before; each plain
    version is held to its own kernel above, and here the two differ."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv("bfloat16", 2))
    b2 = flash_attention.flash_attention_plain(q, k, v, scale=0.3)
    b3 = flash_streaming.streaming_flash_attention_plain(q, k, v, scale=0.3)
    assert not torch.equal(b2, b3)
    torch.testing.assert_close(b2.float(), b3.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", [None, "always_zero"])
def test_materializing_and_blockwise_loop_match_jax(kind):
    q, k, v = _qkv("float32", 3)
    tsm, tvq = _pairs(kind, True)
    jsm, jvq = _pairs(kind, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = attention.materializing_attention(tq, tk, tv, scale=0.3, sm_q=tsm,
                                            v_q=tvq).numpy()
    want = np.asarray(jax_mat(jq, jk, jv, scale=0.3, sm_q=jsm, v_q=jvq))
    _assert_close(got, want, "float32", kind, v)
    got = attention.blockwise_attention(tq, tk, tv, scale=0.3, sm_q=tsm,
                                        v_q=tvq, block_size=64,
                                        allow_kernels=False).numpy()
    want = np.asarray(jax_blockwise(jq, jk, jv, scale=0.3, sm_q=jsm,
                                    v_q=jvq, block_size=64,
                                    allow_pallas=False))
    _assert_close(got, want, "float32", kind, v)


def _jax_picks_b2(q_shape, k_shape, itemsize):
    rnd = lambda x: -(-x // 128) * 128
    return _pick_tile_q(rnd(k_shape[1]), rnd(q_shape[-1]), itemsize) \
        is not None


@pytest.mark.parametrize("shape,dtype,want", [
    ((8, 4096, 8, 40), torch.bfloat16, "B2"),  # SD 64x64 self-attention
    ((8, 1024, 8, 80), torch.bfloat16, "B2"),  # SD 32x32 self-attention
    ((8, 4096, 8, 40), torch.float32, "B2"),
    ((4, 4096, 1, 512), torch.bfloat16, "B3"),  # VAE mid attention
    ((4, 4096, 1, 512), torch.float32, "B3"),
    ((1, 16384, 1, 64), torch.bfloat16, "B3"),
])
def test_dispatch_follows_the_tpu_cost_model(monkeypatch, shape, dtype,
                                             want):
    """The choice is made from shapes alone; the spies stop before any
    arithmetic, so full-size shapes cost nothing here."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert flash_attention.flash_supported(shape, shape, itemsize) == \
        _jax_picks_b2(shape, shape, itemsize) == (want == "B2")
    seen = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: seen.append("B2"))
    monkeypatch.setattr(attention, "streaming_flash_attention",
                        lambda *a, **kw: seen.append("B3"))
    x = torch.empty(shape, dtype=dtype)
    attention.blockwise_attention(x, x, x, scale=1.0)
    assert seen == [want]


def test_cpu_wrappers_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv("float32", 4))
    n2 = flash_attention.flash_attention.launches
    n3 = flash_streaming.streaming_flash_attention.launches
    flash_attention.flash_attention(q, k, v, scale=0.3)
    flash_streaming.streaming_flash_attention(q, k, v, scale=0.3)
    assert flash_attention.flash_attention.launches == n2
    assert flash_streaming.streaming_flash_attention.launches == n3


# the shapes of the wide and tf32 designs: D = 512 with a ragged S (B3's
# VAE head dim), D = 80 (an SD stream site's head dim) in f32
@pytest.mark.parametrize("kind", [None, "always_zero"])
@pytest.mark.parametrize("kernel,dtype,shape", [
    ("B3", "float32", (1, 16, 200, 1, 512)),
    ("B3", "bfloat16", (1, 16, 200, 1, 512)),
    ("B2", "float32", (2, 24, 200, 2, 80)),
])
def test_plain_matches_pallas_interpret_wide_and_f32(kernel, dtype, shape,
                                                     kind):
    """The plain versions that the card's wide and tf32 kernels are held
    to, against the Pallas kernels in interpret mode, at their D."""
    q, k, v = _qkv(dtype, 6, shape)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tsm, tvq = _pairs(kind, True)
    jsm, jvq = _pairs(kind, False)
    scale = shape[-1] ** -0.5
    if kernel == "B2":
        got = flash_attention.flash_attention_plain(tq, tk, tv, scale=scale,
                                                    sm_q=tsm, v_q=tvq)
        want = jax_flash(jq, jk, jv, scale=scale, sm_q=jsm, v_q=jvq,
                         interpret=True)
    else:
        got = flash_streaming.streaming_flash_attention_plain(
            tq, tk, tv, scale=scale, sm_q=tsm, v_q=tvq, block_k=128)
        want = jax_stream(jq, jk, jv, scale=scale, sm_q=jsm, v_q=jvq,
                          tile_q=8, block_k=128, interpret=True)
    assert got.dtype == tdt and got.shape == q.shape
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype,
                  kind, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_flip_share_reads_p_through_v(dtype):
    """The flip count's readout: with V one-hot over a chunk of keys, the
    plain version's output is its quantized softmax probabilities, so it
    counts no flip against itself and counts every p that another
    function moves by a bucket."""
    tdt = getattr(torch, dtype)
    q, k, _ = (torch.from_numpy(a).to(tdt)
               for a in _qkv(dtype, 7, (2, 20, 37, 2, 8)))
    q = (3 * q.float()).to(tdt)
    sm_q, _ = _pairs("always_zero", True)
    plain = flash_attention.flash_attention_plain
    delta = float(sm_q[0]["delta"])
    share = flash_attention.bucket_flip_share
    assert share(plain, plain, q, k, scale=0.3, sm_q=sm_q) == 0.0

    def shifted(q, k, v, *, scale, sm_q):  # p one bucket up at key 5
        p = plain(q, k, v, scale=scale, sm_q=sm_q).float()
        hit = (v[:, 5:6] == 1).float()  # (B, 1, H, D): the column of key 5
        return (p + delta * hit).to(q.dtype)

    assert share(shifted, plain, q, k, scale=0.3, sm_q=sm_q) == 1 / 37
