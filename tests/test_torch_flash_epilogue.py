"""P (scripts/bench_flash_epilogue.py::flash) against its port, on the CPU.

P's imports and definitions are read from its script with `ast` and
executed without its module-level timing loop; its pallas_call runs in
interpret mode, as tests/test_pallas_int8.py runs the package's kernels.
The port's plain version (ops/flash_epilogue.py, what the wrapper runs
on a CPU tensor) is held to P's Pallas kernel for each of the nine modes
at (1, 256, 2, 40) bf16 from a numpy seed.

Tolerances, as chip_smoke.py's `flash_epilogue` phase states them:
  * fp_postnorm, fp_prenorm, cast_rt: 2e-2 absolute + 2e-2 relative (one
    bf16 rounding of p and of the output: B2's bf16 tolerance);
  * the scaled modes: every element within 2e-2 of max|plain| plus one
    bucket, and at most 1e-3 of the elements beyond 2e-2 of max|plain|.
    A bucket is what one p moving across a rounding boundary moves an
    output by: delta * max|v| for `full` and `full_floor`, max|v| for the
    modes that stay in units of delta (mul_only, floor_half, round_only,
    round_clip). exp differs between XLA and PyTorch by an ulp, which can
    move p across a boundary.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from qdiffusion_torch.ops import flash_epilogue as fe
from qdiffusion_torch.ops.flash_attention import flash_attention_plain
from qdiffusion_torch.ops.flash_streaming import \
    streaming_flash_attention_plain

torch.set_num_threads(1)

P_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "bench_flash_epilogue.py"
SHAPE = (1, 256, 2, 40)  # (B, T = S, H, D); P needs T % 128 == 0
SCALED = {"mul_only": 1.0, "floor_half": 1.0, "round_only": 1.0,
          "round_clip": 1.0, "full": fe.DELTA, "full_floor": fe.DELTA}


def _p_namespace() -> dict:
    """P's imports and defs, without its timing loop (:112-121)."""
    tree = ast.parse(P_SCRIPT.read_text(), filename=str(P_SCRIPT))
    tree.body = [n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns: dict = {"__name__": "bench_flash_epilogue_p"}
    exec(compile(tree, str(P_SCRIPT), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def p_flash():
    ns = _p_namespace()
    assert ns["pl"] is pl
    return ns["flash"]


def _interp(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _qkv(seed=0):
    """q scaled up so that the softmax is peaked and the rounding modes
    see a spread of buckets."""
    b, t, h, d = SHAPE
    rng = np.random.default_rng(seed)
    q = 2.5 * rng.standard_normal((b, t, h, d))
    k, v = (rng.standard_normal((b, t, h, d)) for _ in range(2))
    return [a.astype(np.float32) for a in (q, k, v)]


def _torch_bf16(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def assert_epilogue_close(got, want, v, mode):
    """The tolerances of the module docstring; got, want, v as f32 numpy."""
    if mode not in SCALED:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        return
    near = 2e-2 * float(np.abs(want).max())
    bucket = SCALED[mode] * float(np.abs(v).max())
    diff = np.abs(got - want)
    assert diff.max() <= near + bucket, (mode, diff.max(), near, bucket)
    assert (diff > near).mean() <= 1e-3, (mode, (diff > near).mean())


@pytest.mark.parametrize("mode", fe.MODES)
def test_plain_matches_p_in_interpret_mode(monkeypatch, p_flash, mode):
    _interp(monkeypatch)
    q, k, v = _qkv()
    scale = SHAPE[-1] ** -0.5
    tq, tk, tv = _torch_bf16((q, k, v))
    got = fe.flash_epilogue(tq, tk, tv, scale=scale, mode=mode)
    assert got.dtype == torch.bfloat16 and got.shape == SHAPE
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(p_flash(jq, jk, jv, scale, mode), np.float32)
    assert_epilogue_close(got.float().numpy(), want, tv.float().numpy(),
                          mode)


def test_modes_relate_as_p_defines_them():
    """fp_prenorm and cast_rt differ only in where the bf16 rounding is
    written; `full` is round_clip scaled back by delta and mul_only is
    fp_prenorm scaled up, each to one bf16 rounding of the output."""
    tq, tk, tv = _torch_bf16(_qkv(1))
    outs = {m: fe.flash_epilogue_plain(tq, tk, tv, scale=0.3, mode=m).float()
            for m in fe.MODES}
    assert torch.equal(outs["fp_prenorm"], outs["cast_rt"])
    torch.testing.assert_close(outs["full"], outs["round_clip"] * fe.DELTA,
                               rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(outs["mul_only"] * fe.DELTA,
                               outs["fp_prenorm"], rtol=2e-2, atol=2e-2)
    assert not torch.equal(outs["full"], outs["fp_prenorm"])


def test_fp_modes_are_b2_and_b3():
    """fp_postnorm is B2's function without sm_q and cast_rt B3's, on the
    same inputs, to the bit."""
    tq, tk, tv = _torch_bf16(_qkv(2))
    assert torch.equal(
        fe.flash_epilogue_plain(tq, tk, tv, scale=0.3, mode="fp_postnorm"),
        flash_attention_plain(tq, tk, tv, scale=0.3))
    assert torch.equal(
        fe.flash_epilogue_plain(tq, tk, tv, scale=0.3, mode="cast_rt"),
        streaming_flash_attention_plain(tq, tk, tv, scale=0.3))


def test_plain_takes_ragged_t_and_chunks():
    """T not a multiple of P's 128-row tile, and more rows than one chunk
    of the plain version: each row equals the row computed alone."""
    rng = np.random.default_rng(3)
    q, k, v = _torch_bf16([rng.standard_normal(s).astype(np.float32)
                           for s in ((1, 1030, 1, 8), (1, 70, 1, 8),
                                     (1, 70, 1, 8))])
    full = fe.flash_epilogue_plain(q, k, v, scale=0.5, mode="full")
    assert full.shape == (1, 1030, 1, 8)
    for t in (0, 1023, 1024, 1029):
        one = fe.flash_epilogue_plain(q[:, t:t + 1], k, v, scale=0.5,
                                      mode="full")
        assert torch.equal(full[:, t:t + 1], one)


def test_cpu_wrapper_counts_no_launch_and_checks_the_mode():
    tq, tk, tv = _torch_bf16(_qkv(4))
    n = fe.flash_epilogue.launches
    fe.flash_epilogue(tq, tk, tv, scale=0.3, mode="full")
    assert fe.flash_epilogue.launches == n
    with pytest.raises(ValueError, match="mode"):
        fe.flash_epilogue(tq, tk, tv, scale=0.3, mode="round_half_up")


def test_delta_is_p_scalar():
    """delta is P's f32 1/255 and inv_d its f32 reciprocal (not 255), as
    P's kernel forms it from its f32 scalar."""
    assert fe.DELTA == float(np.float32(1 / 255.0))
    d = jnp.full((1, 4), 1 / 255.0, jnp.float32)[0, 0]
    assert fe.INV_DELTA == float(1.0 / d) != 255.0


def test_bench_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                              capsys):
    from qdiffusion_torch.scripts import bench_flash_epilogue as bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--shape", "1,16,1,8"])
    n = fe.flash_epilogue.launches
    rows = bench.main(["--device", "cpu", "--shape", "1,16,1,8"])
    assert [r["mode"] for r in rows] == list(fe.MODES)
    assert all(r["finite"] and "ms" not in r for r in rows)
    assert fe.flash_epilogue.launches == n
    assert len(capsys.readouterr().out.splitlines()) == len(fe.MODES)


@pytest.mark.parametrize("shape, lo, hi", [((2, 4096, 8, 40), 0.06, 0.07),
                                           ((8, 4096, 8, 40), 0.25, 0.26)])
def test_bench_bound_at_p_shape(shape, lo, hi):
    """P's (2, 4096, 8, 40) and the SD (8, 4096, 8, 40) in bf16: one
    exponential per score bounds them, 0.064 and 0.257 ms."""
    from qdiffusion_torch.utils.timing import attention_bound

    b, t, h, _ = shape
    got = attention_bound(shape, 2)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == got["ops_ms"] == got["exp_ms"]
    assert got["exp_ms"] == pytest.approx(b * h * t ** 2 / (
        16 * 132 * 1.98e9) * 1e3)
    assert lo < got["bound_ms"] < hi
