"""Tests of the port that need the card (marker `cuda`); they skip
without CUDA. They import torch and the port only, no jax, so they run
on a machine that has the card and no JAX:

    python -m pytest tests/test_torch_card.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from qdiffusion_torch.ops.groupnorm import fused_group_norm, group_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA kernels run "
                    "only on the card")
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 0.5).astype(np.float32)
    c = shape[-1]
    return (x, rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 128), (2, 256, 384),
                                   (3, 16, 512), (2, 8, 8, 96)])
@pytest.mark.parametrize("swish", [False, True])
def test_kernel_matches_plain(card, shape, dtype, swish):
    """The Triton kernel against its plain version on the same CUDA
    inputs: f32 to 1e-4 (sum order), bf16 to 2e-2 + 1e-2 relative (one
    bf16 rounding of outputs up to ~10)."""
    x, scale, bias = (torch.from_numpy(a).to(card)
                      for a in _inputs(shape, seed=4))
    x = x.to(dtype)
    before = fused_group_norm.launches
    got = fused_group_norm(x, scale, bias, swish=swish)
    assert fused_group_norm.launches == before + 1
    want = group_norm_plain(x, scale, bias, swish=swish)
    assert got.dtype == dtype and got.shape == x.shape
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.randn((2, 4, 4, 64), device=card)
    w = torch.ones(64, device=card)
    with pytest.raises(ValueError, match="channel-last"):
        fused_group_norm(x.transpose(1, 2), w, w)
    with pytest.raises(ValueError, match="dtype"):
        fused_group_norm(x.half(), w, w)
    with pytest.raises(ValueError, match="groups"):
        fused_group_norm(x[..., :48], w[:48], w[:48])
    with pytest.raises(ValueError, match="scale"):
        fused_group_norm(x, w.cpu(), w)


def _tiny_pair(card, **flags):
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig

    cfg = DDIMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=16,
                         split_shortcut=True)
    models = []
    for dev in ("cpu", card):
        m = DDIMUNet(cfg, QuantFlags(**flags).policy_ddim(), device=dev)
        m.load_state_dict(m.init_params(0))
        models.append(m)
    return models


def _inputs_nhwc(n=2):
    rng = np.random.default_rng(1)
    return (torch.from_numpy(rng.standard_normal((n, 16, 16, 3)).astype(
        np.float32)), torch.tensor([10.0, 500.0][:n]))


def test_tiny_fold_w4_split_card_matches_cpu(card):
    """f32 fold step with split shortcut on the card (kernel, TF32 off)
    against the CPU (plain GroupNorm): sum order only, 1e-4."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step

    resolve_device(card)
    cpu_m, card_m = _tiny_pair(card, weight_bit=4, split=True)
    q = init_weight_qstate(cpu_m)
    x, t = _inputs_nhwc()
    want = make_quantized_step(cpu_m, q, engine="fold")(x, t)
    before = fused_group_norm.launches
    got = make_quantized_step(card_m, {s: {k: {n: v.to(card)
                                                for n, v in st.items()}
                                            for k, st in sl.items()}
                                        for s, sl in q.items()},
                              engine="fold")(x.to(card), t.to(card))
    # 2 per ResnetBlock (8), 1 per attention (4), 1 before conv_out
    assert fused_group_norm.launches - before == 21
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_tiny_sim_w8a8_split_runs_on_card(card):
    """sim W8A8 with split shortcut: activation qstate initialised on the
    card, a finite step, and the GroupNorms through the kernel."""
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step

    _, m = _tiny_pair(card, weight_bit=8, quant_act=True, split=True)
    x, t = _inputs_nhwc()
    x, t = x.to(card), t.to(card)
    q = init_act_qstate(m, init_weight_qstate(m), x, t)
    assert "a0" in q["up.1.block.0.nin_shortcut"]
    before = fused_group_norm.launches
    eps = make_quantized_step(m, q, engine="sim")(x, t)
    assert fused_group_norm.launches - before == 21
    assert eps.shape == (2, 16, 16, 3) and bool(torch.isfinite(eps).all())


# -- B2 / B3: the CUDA flash-attention kernels -----------------------------

def _attn_inputs(card, shape, dtype, seed=0):
    b, t, s, h, d = shape
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device=card).to(dtype)
    k = torch.randn((b, s, h, d), generator=g, device=card).to(dtype)
    v = torch.randn((b, s, h, d), generator=g, device=card).to(dtype)
    return q, k, v


def _sm_pairs(card, kind):
    from qdiffusion_torch.quant.affine import AffineQuantizerSpec

    if kind is None:
        return None, None
    spec = AffineQuantizerSpec(n_bits=8, always_zero=kind == "always_zero",
                               symmetric=kind == "symmetric")
    sm = {"delta": torch.tensor(1 / 251.3, device=card),
          "zero_point": torch.tensor(0.0, device=card)}
    v = {"delta": torch.tensor(6.1 / 255, device=card),
         "zero_point": torch.tensor(127.0, device=card)}
    return (sm, spec), (v, AffineQuantizerSpec(n_bits=8))


@pytest.mark.parametrize("kind", [None, "always_zero", "symmetric"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["B2", "B3"])
@pytest.mark.parametrize("shape", [(2, 24, 200, 2, 40), (1, 70, 131, 3, 80),
                                   (1, 40, 300, 1, 512), (1, 130, 77, 2, 64),
                                   (2, 65, 129, 1, 17)])
def test_flash_kernels_match_plain(card, kernel, shape, dtype, kind):
    """Each CUDA kernel against its own plain version on the same CUDA
    inputs (ragged T and S, D padded 40 -> 48; bf16 with D <= 128 runs
    flash_mma_kernel, D = 17 through its element copies). f32: 5e-5 plus
    at most 1e-3 of the elements one softmax bucket apart (delta * max|v|; sum
    order moves p across a rounding boundary; scores summed over up to 512
    products give 5e-5 absolute / 1e-4 relative, observed 2.2e-5 at D =
    512); bf16: 2e-2 (one bf16 rounding of p and of the output)."""
    from qdiffusion_torch.ops.flash_attention import flash_attention, \
        flash_attention_plain
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention, streaming_flash_attention_plain

    fn, plain = (flash_attention, flash_attention_plain) if kernel == "B2" \
        else (streaming_flash_attention, streaming_flash_attention_plain)
    q, k, v = _attn_inputs(card, shape, dtype)
    sm_q, v_q = _sm_pairs(card, kind)
    before = fn.launches
    got = fn(q, k, v, scale=0.3, sm_q=sm_q, v_q=v_q)
    assert fn.launches == before + 1
    want = plain(q, k, v, scale=0.3, sm_q=sm_q, v_q=v_q)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    elif kind is None:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=5e-5)
    else:
        flip = (1 / 251.3) * float(v.abs().max())
        assert float(diff.max()) <= 5e-5 + flip
        assert float((diff > 5e-5).float().mean()) <= 1e-3


def test_flash_wrappers_refuse_what_the_kernel_does_not_take(card):
    from qdiffusion_torch.ops.flash_attention import flash_attention

    q, k, v = _attn_inputs(card, (1, 8, 8, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=1.0)
    with pytest.raises(ValueError, match="k is"):
        flash_attention(q, k.cpu(), v, scale=1.0)


@pytest.mark.parametrize("mode", ["fp_postnorm", "fp_prenorm", "cast_rt",
                                  "mul_only", "floor_half", "round_only",
                                  "round_clip", "full", "full_floor"])
@pytest.mark.parametrize("shape", [(2, 128, 128, 2, 40), (1, 100, 150, 3, 40),
                                   (1, 70, 131, 2, 32), (1, 33, 65, 1, 20)])
def test_flash_epilogue_matches_plain(card, shape, mode):
    """P's kernel against its plain version, every mode, round and ragged
    T and S: fp modes and cast_rt 2e-2 absolute + 2e-2 relative; the
    scaled modes within 2e-2 of max|plain| plus one bucket (delta * max|v|
    for full and full_floor, max|v| for the others), with at most 1e-3 of
    the elements beyond 2e-2 of max|plain| (an exp that differs by an ulp
    can move p across a rounding boundary)."""
    from qdiffusion_torch.ops.flash_epilogue import DELTA, flash_epilogue, \
        flash_epilogue_plain

    q, k, v = _attn_inputs(card, shape, torch.bfloat16, seed=7)
    q = (2.5 * q.float()).to(torch.bfloat16)  # a peaked softmax
    before = flash_epilogue.launches
    got = flash_epilogue(q, k, v, scale=shape[-1] ** -0.5, mode=mode)
    assert flash_epilogue.launches == before + 1
    want = flash_epilogue_plain(q, k, v, scale=shape[-1] ** -0.5, mode=mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got, want = got.float(), want.float()
    if mode in ("fp_postnorm", "fp_prenorm", "cast_rt"):
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        return
    near = 2e-2 * float(want.abs().max())
    bucket = (DELTA if mode.startswith("full") else 1.0) * float(
        v.float().abs().max())
    diff = (got - want).abs()
    assert float(diff.max()) <= near + bucket
    assert float((diff > near).float().mean()) <= 1e-3


def test_flash_epilogue_refuses_what_the_kernel_does_not_take(card):
    from qdiffusion_torch.ops import flash_epilogue as fe

    q, k, v = _attn_inputs(card, (1, 8, 8, 2, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="device"):
        fe._check(q.cpu(), k.cpu(), v.cpu())  # a CPU tensor at the C entry
    with pytest.raises(ValueError, match="k is"):
        fe.flash_epilogue(q, k.cpu(), v, scale=1.0, mode="full")
    with pytest.raises(ValueError, match="dtype"):
        fe.flash_epilogue(q.float(), k.float(), v.float(), scale=1.0,
                          mode="full")
    with pytest.raises(ValueError, match="contiguous"):
        fe.flash_epilogue(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), scale=1.0, mode="full")
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 8, 1, 136), device=card, dtype=torch.bfloat16)
        fe.flash_epilogue(big, big, big, scale=1.0, mode="full")
    with pytest.raises(ValueError, match="mode"):
        fe.flash_epilogue(q, k, v, scale=1.0, mode="exact")


@pytest.mark.parametrize("d", [64, 80])
def test_flash_epilogue_refuses_head_dims_past_its_class(card, d):
    """P's modes are built for D <= 48 only (P's shape has D = 40): the
    wrapper refuses larger D and so does the C entry."""
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops import flash_epilogue as fe

    q, k, v = _attn_inputs(card, (1, 70, 131, 2, d), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fe.flash_epilogue(q, k, v, scale=d ** -0.5, mode="full")
    o = torch.empty_like(q)
    err = _cuda.library("flash_attention.cu").qdt_flash_epilogue(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 70, 131,
        2, d, d ** -0.5, fe.MODES.index("full"), _cuda.stream_ptr(q.device))
    assert err != 0


# -- B4 / B5 / B6: the CUDA integer matmul kernels -------------------------

def _int_operands(card, M, K, N, seed, w_dtype=torch.int8, k_rows=None):
    g = torch.Generator(device=card).manual_seed(seed)
    k_rows = K if k_rows is None else k_rows
    if w_dtype == torch.uint8:
        w = torch.randint(0, 256, (k_rows, N), generator=g, device=card,
                          dtype=torch.uint8)
    else:
        w = torch.randint(-128, 128, (k_rows, N), generator=g, device=card,
                          dtype=torch.int8)
    consts = [(0.01 + 0.1 * torch.rand(N, generator=g, device=card)),
              torch.randn(N, generator=g, device=card),
              torch.randn(N, generator=g, device=card)]
    return g, w, consts


@pytest.mark.parametrize("shape", [(1, 27, 3), (70, 46, 29),
                                   (129, 200, 260), (300, 1152, 128)])
def test_b4_matches_plain_bit_for_bit(card, shape):
    """B4 against its plain version on the same CUDA inputs: the int32
    product exactly (identity epilogue, |acc| < 2^24 so its f32 value is
    exact) and the output bit for bit (the same unfused f32 epilogue)."""
    from qdiffusion_torch.ops.int8_matmul import int8_dense_pallas, \
        int8_matmul_dequant, int8_matmul_plain

    M, K, N = shape
    g, w, (a, bc, c) = _int_operands(card, M, K, N, seed=M)
    x = torch.randint(-128, 128, (M, K), generator=g, device=card,
                      dtype=torch.int8)
    before = int8_matmul_dequant.launches
    got = int8_dense_pallas(x, w, a, bc, c)
    assert int8_matmul_dequant.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, int8_matmul_plain(x, w, a, bc, c))
    one, zero = torch.ones(N, device=card), torch.zeros(N, device=card)
    acc = int8_matmul_dequant(x, w, one, zero, zero)
    want = torch.matmul(x.double(), w.double())
    assert float(want.abs().max()) < 2**24
    assert torch.equal(acc.double(), want)


@pytest.mark.parametrize("kernel", ["B5", "B6"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 46, 3), (33, 45, 17), (70, 118, 29),
                                   (154, 768, 320), (200, 2880, 130)])
def test_stream_kernels_match_plain(card, kernel, x_dtype, out_dtype, shape):
    """B5 / B6 against their plain versions: the same bf16 x and weight
    products summed in another order, so 1e-3 relative to the largest
    output (f32 out); a bf16 output adds one bf16 rounding (1e-2). B6's
    K is even (its pack folds K in half): an odd K is taken one up."""
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream, \
        int4_stream_matmul, int4_stream_plain
    from qdiffusion_torch.ops.int8_matmul import int8_dense_stream, \
        int8_stream_matmul, int8_stream_plain

    M, K, N = shape
    int4 = kernel == "B6"
    K += K % 2 if int4 else 0
    g, w, (scale, shift, c) = _int_operands(
        card, M, K, N, seed=K, w_dtype=torch.uint8 if int4 else torch.int8,
        k_rows=K // 2 if int4 else K)
    x = torch.randn((M, K), generator=g, device=card).to(x_dtype)
    fn, count, plain = (int4_dense_stream, int4_stream_matmul,
                        int4_stream_plain) if int4 else (
        int8_dense_stream, int8_stream_matmul, int8_stream_plain)
    before = count.launches
    got = fn(x, w, scale, shift, bias=c, out_dtype=out_dtype)
    assert count.launches == before + 1
    want = plain(x, w, scale, shift, c, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    err = float((got.float() - want.float()).abs().max())
    ref = float(want.float().abs().max())
    assert err <= (1e-3 if out_dtype == torch.float32 else 1e-2) * ref, \
        (err, ref)


def test_int_wrappers_refuse_what_the_kernels_do_not_take(card):
    from qdiffusion_torch.ops.int4_matmul import int4_stream_matmul
    from qdiffusion_torch.ops.int8_matmul import int8_matmul_dequant, \
        int8_stream_matmul

    g, w, (a, b, c) = _int_operands(card, 32, 64, 48, seed=0)
    x8 = torch.randint(-128, 128, (32, 64), generator=g, device=card,
                       dtype=torch.int8)
    xf = torch.randn((32, 64), generator=g, device=card)
    with pytest.raises(ValueError, match="dtype"):
        int8_matmul_dequant(x8.short(), w, a, c, b)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_dequant(x8.t().contiguous().t(), w, a, c, b)
    with pytest.raises(ValueError, match="w is"):
        int8_matmul_dequant(x8, w.cpu(), a, c, b)
    with pytest.raises(ValueError, match="dtype"):
        int8_stream_matmul(xf.half(), w, a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        int8_stream_matmul(xf[:, ::2], w[:32], a, b, c)
    with pytest.raises(ValueError, match="w is"):
        int4_stream_matmul(xf, w[:32], a, b, c)  # int8, not a uint8 pack
    with pytest.raises(ValueError, match="even"):
        int4_stream_matmul(xf[:, :63].contiguous(), w[:31].view(torch.uint8),
                           a, b, c)
    with pytest.raises(ValueError, match="scale"):
        int8_stream_matmul(xf, w, a.double(), b, c)


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got.float().cpu() - want)
                 / torch.linalg.vector_norm(want))


def test_tiny_int8_step_card_matches_cpu(card):
    """int8 engine, W8A8 with split shortcut, f32 carrier: the card (B4,
    B1) against the CPU (plain versions). Integer products are exact on
    both; f32 noise elsewhere flips quantization buckets that then
    cascade, as between the port and the JAX package (relative L2 2e-2
    there): 5e-2. Every packed segment launches B4 once."""
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step, pack_model
    from qdiffusion_torch.ops.int8_matmul import int8_matmul_dequant

    cpu_m, card_m = _tiny_pair(card, weight_bit=8, quant_act=True,
                               split=True)
    x, t = _inputs_nhwc()
    q = init_act_qstate(cpu_m, init_weight_qstate(cpu_m), x, t)
    want = make_quantized_step(cpu_m, q, engine="int8",
                               carrier_dtype=torch.float32)(x, t)
    qc = {s: {k: {n: v.to(card) for n, v in st.items()}
              for k, st in sl.items()} for s, sl in q.items()}
    per_step = sum(len(p.segments) for p in pack_model(card_m, qc).values())
    before = int8_matmul_dequant.launches
    got = make_quantized_step(card_m, qc, engine="int8",
                              carrier_dtype=torch.float32)(x.to(card),
                                                           t.to(card))
    assert int8_matmul_dequant.launches - before == per_step
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) <= 5e-2


@pytest.mark.parametrize("weight_bit", [8, 4])
def test_tiny_stream_step_card_matches_cpu(card, weight_bit):
    """stream engine with every conv streamed ("all"): B5 (W8 convs) or
    B6 (W4 convs and linears) on the card against the plain versions on
    the CPU. Each conv rounds its input to bf16, so f32 noise upstream
    flips bf16 roundings that compound: 1e-2 (port vs JAX on the CPU:
    3.4e-3)."""
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step, \
        stream_pack_model
    from qdiffusion_torch.ops.int4_matmul import int4_stream_matmul
    from qdiffusion_torch.ops.int8_matmul import int8_stream_matmul

    cpu_m, card_m = _tiny_pair(card, weight_bit=weight_bit, split=True)
    x, t = _inputs_nhwc()
    q = init_weight_qstate(cpu_m)
    want = make_quantized_step(cpu_m, q, engine="stream",
                               stream_convs="all")(x, t)
    qc = {s: {k: {n: v.to(card) for n, v in st.items()}
              for k, st in sl.items()} for s, sl in q.items()}
    packs = stream_pack_model(card_m, qc, dense_only=False)
    count = int4_stream_matmul if weight_bit == 4 else int8_stream_matmul
    # W8 linears dequantize to x's dtype and run a plain matmul
    per_step = sum(len(p["segs"]) for p in packs.values()
                   if weight_bit == 4 or "kshape" in p)
    before = count.launches
    got = make_quantized_step(card_m, qc, engine="stream",
                              stream_convs="all")(x.to(card), t.to(card))
    assert count.launches - before == per_step
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) <= 1e-2
