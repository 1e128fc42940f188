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


@pytest.mark.parametrize("wrapper", ["B1", "B2", "B3"])
def test_kernel_wrappers_refuse_a_grad_input_on_card(card, wrapper):
    """No kernel has a backward: a CUDA input that requires grad, in grad
    mode, raises rather than give an output that drops the gradient;
    under torch.no_grad() the same call launches."""
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    if wrapper == "B1":
        x = torch.randn((2, 4, 4, 64), device=card)
        w = torch.ones(64, device=card, requires_grad=True)
        call = lambda: fused_group_norm(x, w, w)  # noqa: E731
    else:
        q, k, v = _attn_inputs(card, (1, 64, 64, 2, 32), torch.bfloat16)
        q.requires_grad_(True)
        fn = flash_attention if wrapper == "B2" else \
            streaming_flash_attention
        call = lambda: fn(q, k, v, scale=0.125)  # noqa: E731
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call().float()).all()


def test_tiny_recon_gradient_reaches_every_alpha_on_card(card):
    """One reconstruction step of a ResnetBlock unit (mid.block_1, 2
    channels per GroupNorm group) on asym inputs captured on the card:
    the captures launch B1, the differentiable forward does not (plain
    GroupNorm), and every alpha, conv1's (behind norm2) included, gets the
    gradient the CPU gets: 1e-3 of its largest element."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib.capture import capture_unit_io
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.calib.recon import SOFT, ReconConfig, \
        extract_trainable, init_adaround_unit, merge_trainable, recon_loss
    from qdiffusion_torch.quant.context import QuantCtx

    resolve_device(card)
    x, t = _inputs_nhwc()
    q = None
    grads = {}
    for m in _tiny_pair(card, weight_bit=4, split=True):
        dev = next(m.parameters()).device
        unit = next(u for u in m.units if u.name == "mid.block_1")
        if q is None:
            q = init_weight_qstate(m)
        qd = {s: {k: {n: v.to(dev) for n, v in st.items()}
                  for k, st in sl.items()} for s, sl in q.items()}
        before = fused_group_norm.launches
        inps, out = capture_unit_io(m, qd, unit.name, x.to(dev), t.to(dev),
                                    asym=True, batch_size=2)
        captured = fused_group_norm.launches - before
        qd = init_adaround_unit(m, qd, unit)
        train = {s: {k: a.clone().requires_grad_(True)
                     for k, a in sl.items()}
                 for s, sl in extract_trainable(qd, unit).items()}
        m.requires_grad_(False)
        before = fused_group_norm.launches
        ctx = QuantCtx(merge_trainable(qd, train), mode=SOFT,
                       differentiable=True)
        loss = recon_loss(unit.apply(ctx, *inps), out, train, 20.0, 100.0,
                          ReconConfig(iters=100), unit.loss_axis)
        loss.backward()
        if dev.type == "cuda":
            assert captured > 0
            assert fused_group_norm.launches == before
        grads[dev.type] = {(s, k): a.grad for s, sl in train.items()
                           for k, a in sl.items()}
    assert ("mid.block_1.conv1", "w") in grads["cuda"]
    for key, want in grads["cpu"].items():
        got = grads["cuda"][key]
        assert got is not None and bool(got.abs().max() > 0), key
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()))


def test_tiny_act_recon_card_matches_cpu(card, monkeypatch):
    """An act reconstruction (32 iterations) of a ResnetBlock unit
    (mid.block_1) of the tiny split W4A8 UNet on the card and on the CPU,
    from the same FP captures, qstate and minibatch indices: B1 is not
    launched inside, and every delta agrees within 1e-4 relative, or
    within four times the CPU's own spread when its inputs carry 2e-6
    relative noise (four seeds), where that is larger: a delta's gradient
    is a sum of rounding residuals that cancel, so the two devices' f32
    noise moves a bucket and Adam carries it on, as between the port and
    JAX (tests/test_torch_calib_act.py)."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib import recon
    from qdiffusion_torch.calib.capture import capture_unit_io
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate

    resolve_device(card)
    cpu_m, card_m = _tiny_pair(card, weight_bit=4, quant_act=True,
                               split=True)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.standard_normal((16, 16, 16, 3)).astype(
        np.float32))
    ts = torch.linspace(0.0, 999.0, 16)
    q = init_act_qstate(cpu_m, init_weight_qstate(cpu_m), xs[:8], ts[:8])
    inps, out = capture_unit_io(cpu_m, q, "mid.block_1", xs, ts,
                                batch_size=8)
    idx = torch.randint(0, 16, (32, 8),
                        generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n, bs, gen: idx[i])
    cfg = recon.ReconConfig(iters=32, batch_size=8, p=2.4)

    def run(m, dev, seed=0):
        noise = [1.0 if seed == 0 else 1.0 + 2e-6 * torch.randn(
            a.shape, generator=torch.Generator().manual_seed(seed))
            for a in inps]
        unit = next(u for u in m.units if u.name == "mid.block_1")
        qd = {s: {k: {n: v.to(dev) for n, v in st.items()}
                  for k, st in sl.items()} for s, sl in q.items()}
        new = recon.reconstruct_unit(
            m, qd, unit, tuple((a * z).to(dev).contiguous(
                memory_format=torch.channels_last) if a.ndim == 4
                else (a * z).to(dev) for a, z in zip(inps, noise)),
            out.to(dev).contiguous(memory_format=torch.channels_last), cfg,
            act_quant=True)
        return {site: {k: d.cpu() for k, d in sl.items()} for site, sl
                in recon.extract_trainable(new, unit, "act").items()}

    before = fused_group_norm.launches
    got = run(card_m, card)
    assert fused_group_norm.launches == before
    want = run(cpu_m, "cpu")
    spread = [run(cpu_m, "cpu", seed) for seed in (1, 2, 3, 4)]
    assert sorted(want) == [f"mid.block_1.{n}" for n in
                            ("conv1", "conv2", "temb_proj")]
    for site, slots in want.items():
        for slot, d in slots.items():
            rel = lambda a: float((a - d).abs() / d.abs())  # noqa: E731
            bound = max(1e-4, 4.0 * max(rel(r[site][slot]) for r in spread))
            assert rel(got[site][slot]) <= bound, (site, slot)


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
                                   (2, 65, 129, 1, 17), (2, 33, 97, 1, 256),
                                   (1, 100, 70, 2, 512), (1, 37, 150, 1, 200),
                                   (1, 66, 200, 1, 128),
                                   (1, 100, 1024, 14, 32),
                                   (1, 64, 1024, 8, 24),
                                   (1, 64, 1024, 1, 512)])
def test_flash_kernels_match_plain(card, kernel, shape, dtype, kind):
    """Each CUDA kernel against its own plain version on the same CUDA
    inputs (ragged T and S; bf16 with D <= 128 runs flash_mma_kernel, D
    padded 40 -> 48; f32 with D <= 128 flash_tf32_kernel, Q in registers
    up to D = 80 and read from shared memory at 128; D > 128
    flash_wide_kernel at its 256 and 512 classes, D = 200 padded; D = 17
    through element copies; the LSUN UNets' 14 heads of 32 and 8 heads of
    24, padded to the 32 class, and the KL-f8 decode's 1024 keys of 512
    channels). f32: 5e-5 plus
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


# (B, T, S, H, D) of the three designs: tf32 with Q in registers and read
# from shared memory, wide at both classes and both dtypes, mma
_DESIGN_SHAPES = [(2, 100, 300, 2, 40), (1, 70, 131, 1, 128),
                  (1, 90, 200, 1, 512), (2, 33, 97, 1, 256)]


@pytest.mark.parametrize("sm", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["B2", "B3"])
@pytest.mark.parametrize("shape", _DESIGN_SHAPES)
def test_flash_kernels_bit_equal_across_launches_and_replay(card, kernel,
                                                           shape, dtype, sm):
    """No atomics and a fixed order of sums: two launches on the same
    inputs, and a launch captured in a CUDA graph and replayed, give the
    same bits."""
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    fn = flash_attention if kernel == "B2" else streaming_flash_attention
    q, k, v = _attn_inputs(card, shape, dtype, seed=3)
    sm_q, v_q = _sm_pairs(card, "always_zero" if sm else None)
    kw = dict(scale=0.3, sm_q=sm_q, v_q=v_q)
    a = fn(q, k, v, **kw)
    b = fn(q, k, v, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(q, k, v, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(out, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["B2", "B3"])
@pytest.mark.parametrize("shape", [(2, 128, 300, 2, 40), (1, 64, 300, 1, 512)])
def test_flash_kernels_bucket_flips(card, kernel, shape, dtype):
    """The quantized softmax probabilities that feed PV, read out through
    a one-hot V (`bucket_flip_share`), differ from the plain version's in
    at most 1e-3 of the elements: the approximate exponential (ex2.approx)
    and the kernels' sum orders move few p across a rounding boundary."""
    from qdiffusion_torch.ops.flash_attention import bucket_flip_share, \
        flash_attention, flash_attention_plain
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention, streaming_flash_attention_plain

    fn, plain = (flash_attention, flash_attention_plain) if kernel == "B2" \
        else (streaming_flash_attention, streaming_flash_attention_plain)
    q, k, _ = _attn_inputs(card, shape, dtype, seed=5)
    q = (2.5 * q.float()).to(dtype)  # a peaked softmax: many buckets
    sm_q, _ = _sm_pairs(card, "always_zero")
    assert bucket_flip_share(fn, plain, q, k, scale=shape[-1] ** -0.5,
                             sm_q=sm_q) <= 1e-3


def test_flash_wrappers_refuse_what_the_kernel_does_not_take(card):
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops.flash_attention import flash_attention

    big = torch.zeros((1, 8, 1, 520), device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big, scale=1.0)
    err = _cuda.library("flash_attention.cu").qdt_flash_attention(
        big.data_ptr(), big.data_ptr(), big.data_ptr(), big.data_ptr(), None,
        1, 8, 8, 1, 520, 1.0, 0, 0, 0, 0, 0, 0, _cuda.stream_ptr(big.device))
    assert err != 0
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


def _int8_site(card, kshape, ci, co, split=0, seed=0, hw=9, batch=2):
    """A random conv (kshape (kh, kw)) or dense (kshape ()) layer packed
    for the int8 engine on the card: W4 weights, an asymmetric 8-bit
    activation grid (non-zero pad value) calibrated on its own input, and
    that input (NCHW channels_last, or rows)."""
    from qdiffusion_torch.ops.int8 import pack_layer
    from qdiffusion_torch.ops.qlayers import LayerQuantConfig, split_weight
    from qdiffusion_torch.quant.affine import AffineQuantizerSpec, \
        init_state

    g = torch.Generator().manual_seed(seed)
    w = torch.randn((co, ci, *kshape), generator=g) * 0.3
    x = torch.randn((batch, ci, hw, hw) if kshape else (batch, ci),
                    generator=g) * 1.5 + 0.3
    wq = AffineQuantizerSpec(n_bits=4, channel_wise=True,
                             scale_method="max", channel_axis=0)
    aq = AffineQuantizerSpec(n_bits=8, symmetric=False, scale_method="max",
                             leaf_param=True)
    if split:
        wa, wb = split_weight(w, split)
        xa, xb = x.narrow(1, 0, split), x.narrow(1, split, ci - split)
        st = {"w": init_state(wa, wq), "w0": init_state(wb, wq),
              "a": init_state(xa, aq), "a0": init_state(xb, aq)}
    else:
        st = {"w": init_state(w, wq), "a": init_state(x, aq)}
    st = {k: {n: v.to(card) for n, v in d.items()} for k, d in st.items()}
    mod = torch.nn.Module()
    mod.weight = torch.nn.Parameter(w.to(card))
    mod.bias = torch.nn.Parameter(torch.randn(co, generator=g).to(card))
    packed = pack_layer(mod, st, LayerQuantConfig(wq=wq, aq=aq, split=split))
    assert all(s.a_pad != 0 for s in packed.segments)
    x = x.to(card)
    if kshape:
        x = x.contiguous(memory_format=torch.channels_last)
    return packed, x


def _identity(packed):
    """The same site with the epilogue y = float(acc): A = 1, Bc = C = 0,
    no bias."""
    import dataclasses

    segs = [dataclasses.replace(s, scale_a=torch.ones_like(s.scale_a),
                                scale_s=torch.zeros_like(s.scale_s),
                                const=torch.zeros_like(s.const))
            for s in packed.segments]
    return dataclasses.replace(packed, segments=segs, bias=None)


# (kshape, C in, N, split, H = W, batch, stride, padding, pre-pad): one
# of each geometry kind of the CIFAR int8 step, a ragged multi-tile M, and
# small-M sites whose plan splits K
B4_SITES = {
    "3x3": ((3, 3), 32, 48, 0, 9, 2, 1, 1, False),
    "input_conv_c3": ((3, 3), 3, 40, 0, 9, 2, 1, 1, False),
    "output_conv_n3": ((3, 3), 32, 3, 0, 9, 2, 1, 1, False),
    "prepadded_stride2": ((3, 3), 32, 32, 0, 9, 2, 2, 0, True),
    "split_1x1": ((1, 1), 48, 40, 16, 9, 2, 1, 0, False),
    "ragged_m": ((3, 3), 16, 20, 0, 13, 2, 1, 1, False),
    "split_k": ((3, 3), 64, 256, 0, 4, 1, 1, 1, False),
    "split_k_split_1x1": ((1, 1), 512, 256, 256, 4, 1, 1, 0, False),
    "dense": ((), 64, 72, 0, 1, 5, 1, 0, False),
    "dense_split": ((), 48, 24, 16, 1, 5, 1, 0, False),
}


def _b4_run(packed, x, kshape, stride, padding, plain=False):
    from qdiffusion_torch.ops import int8

    if kshape:
        fn = int8.int8_conv2d_plain if plain else int8.int8_conv2d
        return fn(x, packed, stride=stride, padding=padding)
    return (int8.int8_dense_plain if plain else int8.int8_dense)(x, packed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", list(B4_SITES))
def test_int8_conv_kernel_matches_plain_bit_for_bit(card, site, dtype):
    """B4 (one launch per site) against the plain composition on the same
    card inputs (quantize, pad, gather, B4's plain product, the same f32
    epilogue): the int32 products exactly (identity epilogue, sums below
    2^24 so their f32 values are exact) and the output bit for bit, in
    the f32 and bf16 carriers; a second launch gives the same bits."""
    from qdiffusion_torch.ops.int8_conv import conv_plan, int8_conv, stages

    kshape, ci, co, split, hw, batch, stride, padding, prepad = B4_SITES[site]
    packed, x = _int8_site(card, kshape, ci, co, split, seed=ci + co, hw=hw,
                           batch=batch)
    if prepad:
        x = torch.nn.functional.pad(x, (0, 1, 0, 1))
        assert x.is_contiguous(memory_format=torch.channels_last)
    x = x.to(dtype)
    if site.startswith("split_k"):
        assert conv_plan(batch * hw * hw, co, [
            stages(s.w_t[0].numel()) for s in packed.segments]).splits > 1
    before = int8_conv.launches
    got = _b4_run(packed, x, kshape, stride, padding)
    assert int8_conv.launches == before + 1
    want = _b4_run(packed, x, kshape, stride, padding, plain=True)
    assert got.dtype == dtype and got.shape == want.shape
    if kshape:
        assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    ident = _identity(packed)
    acc = _b4_run(ident, x.float(), kshape, stride, padding)
    acc_plain = _b4_run(ident, x.float(), kshape, stride, padding,
                        plain=True)
    assert float(acc_plain.abs().max()) < 2**24
    assert torch.equal(acc_plain, acc_plain.round())
    assert torch.equal(acc, acc_plain)
    assert torch.equal(got, _b4_run(packed, x, kshape, stride, padding))


def test_int8_conv_refuses_what_the_kernel_does_not_take(card):
    import dataclasses

    from qdiffusion_torch.ops import int8

    packed, x = _int8_site(card, (3, 3), 16, 8, seed=3)
    with pytest.raises(ValueError, match="channels_last"):
        int8.int8_conv2d(x.contiguous(), packed, padding=1)
    with pytest.raises(ValueError, match="dtype"):
        int8.int8_conv2d(x.half(), packed, padding=1)
    seg = packed.segments[0]
    on_cpu = dataclasses.replace(packed, segments=[dataclasses.replace(
        seg, a_delta=seg.a_delta.cpu())])
    with pytest.raises(ValueError, match="delta"):
        int8.int8_conv2d(x, on_cpu, padding=1)
    f64 = dataclasses.replace(packed, bias=packed.bias.double())
    with pytest.raises(ValueError, match="bias"):
        int8.int8_conv2d(x, f64, padding=1)
    dense, xd = _int8_site(card, (), 16, 8, seed=4, batch=6)
    with pytest.raises(ValueError, match="channel stride"):
        int8.int8_dense(xd.t().contiguous().t(), dense)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,path", [((64, 1024, 128), "rows"),
                                        ((64, 256, 384), "rows"),
                                        ((2, 16384, 320), "split"),
                                        ((1, 262144, 128), "split")])
def test_group_norm_paths_match_plain(card, shape, path, dtype):
    """B1 on each path of its plan: narrow-group CIFAR slabs (4 and 12
    channels a group, one pass over whole rows) and split-S slabs (an SD
    UNet slab at 64x64, a 512x512 VAE decode row): within the plain
    version's tolerance (f32 1e-4, bf16 one rounding), and two calls
    bit-equal (the partials add in a fixed order)."""
    from qdiffusion_torch.ops.groupnorm import group_norm_plan
    from qdiffusion_torch.device import sm_count

    plan = group_norm_plan(shape[0], shape[1], shape[2],
                           elem=torch.tensor([], dtype=dtype).element_size(),
                           sms=sm_count(card))
    assert plan.path == path
    x, scale, bias = (torch.from_numpy(a).to(card)
                      for a in _inputs(shape, seed=6))
    x = x.to(dtype)
    before = fused_group_norm.launches
    got = fused_group_norm(x, scale, bias)
    assert fused_group_norm.launches == before + 1
    want = group_norm_plain(x, scale, bias)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, fused_group_norm(x, scale, bias))


@pytest.mark.parametrize("kernel", ["B5", "B6"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 46, 3), (33, 45, 17), (70, 118, 29),
                                   (154, 768, 320), (200, 2880, 130),
                                   (2, 1280, 1280), (128, 23040, 1280),
                                   (128, 11520, 1280), (2048, 5760, 640),
                                   (8192, 320, 2560)])
def test_stream_kernels_match_plain(card, kernel, x_dtype, out_dtype, shape):
    """B5 / B6 against their plain versions: the same bf16 x and weight
    products summed in another order, so 1e-3 relative to the largest
    output (f32 out); a bf16 output adds one bf16 rounding (1e-2). B6's
    K is even (its pack folds K in half): an odd K is taken one up. The
    shapes reach both tiles of `stream_plan` (16 and 32 rows), with and
    without a K split, and ragged M, K and N edges."""
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


def _stream_inputs(card, kernel, shape, seed=5):
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream
    from qdiffusion_torch.ops.int8_matmul import int8_dense_stream

    M, K, N = shape
    int4 = kernel == "B6"
    g, w, consts = _int_operands(
        card, M, K, N, seed=seed, w_dtype=torch.uint8 if int4 else torch.int8,
        k_rows=K // 2 if int4 else K)
    x = torch.randn((M, K), generator=g, device=card)
    return (int4_dense_stream if int4 else int8_dense_stream), x, w, consts


# (M, K, N): the 16-row tile split 5 ways, the 32-row tile split 7 ways
# and unsplit (twice), ragged edges on a 4-way split
_PLAN_SHAPES = [(2, 1280, 1280), (128, 11520, 1280), (2048, 640, 640),
                (8192, 320, 2560), (70, 1182, 29)]


@pytest.mark.parametrize("kernel", ["B5", "B6"])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_stream_kernels_bit_equal_across_launches(card, kernel, shape):
    """The K splits are added in a fixed order, with no atomics: two
    launches on the same inputs give the same bits."""
    fn, x, w, (scale, shift, c) = _stream_inputs(card, kernel, shape)
    a = fn(x, w, scale, shift, bias=c)
    b = fn(x, w, scale, shift, bias=c)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["B5", "B6"])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_stream_kernels_graph_replay_matches_eager(card, kernel, shape):
    """A launch captured in a CUDA graph (its split workspace allocated
    from the graph's pool) replays to the eager launch's bits."""
    fn, x, w, (scale, shift, c) = _stream_inputs(card, kernel, shape)
    eager = fn(x, w, scale, shift, bias=c)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, w, scale, shift, bias=c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, w, scale, shift, bias=c)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


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
    there): 5e-2. Every packed site launches B4 once (both segments of
    a split site in one launch)."""
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step, pack_model
    from qdiffusion_torch.ops.int8_conv import int8_conv

    cpu_m, card_m = _tiny_pair(card, weight_bit=8, quant_act=True,
                               split=True)
    x, t = _inputs_nhwc()
    q = init_act_qstate(cpu_m, init_weight_qstate(cpu_m), x, t)
    want = make_quantized_step(cpu_m, q, engine="int8",
                               carrier_dtype=torch.float32)(x, t)
    qc = {s: {k: {n: v.to(card) for n, v in st.items()}
              for k, st in sl.items()} for s, sl in q.items()}
    per_step = len(pack_model(card_m, qc))
    before = int8_conv.launches
    got = make_quantized_step(card_m, qc, engine="int8",
                              carrier_dtype=torch.float32)(x.to(card),
                                                           t.to(card))
    assert int8_conv.launches - before == per_step
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


@pytest.mark.parametrize("weight_bit", [8, 4])
def test_tiny_stream_step_sites_match_cpu(card, weight_bit):
    """Per site: every B5 / B6 call of a tiny stream step on the card
    against the plain version on the CPU, fed the card's own inputs of
    that site, so the error is the kernel's alone (1e-3 of the site's
    largest output, the kernels' tolerance)."""
    import qdiffusion_torch.ops.qlayers as ql
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream
    from qdiffusion_torch.ops.int8_matmul import int8_dense_stream

    cpu_m, card_m = _tiny_pair(card, weight_bit=weight_bit, split=True)
    x, t = _inputs_nhwc()
    q = init_weight_qstate(cpu_m)
    qc = {s: {k: {n: v.to(card) for n, v in st.items()}
              for k, st in sl.items()} for s, sl in q.items()}
    errs = []

    def spy(real):
        def run(xs, w, scale, shift, bias=None, *, out_dtype=None):
            got = real(xs, w, scale, shift, bias, out_dtype=out_dtype)
            cpu = lambda a: a if a is None or isinstance(a, (int, float)) \
                else a.cpu()
            want = real(xs.cpu(), w.cpu(), cpu(scale), cpu(shift), cpu(bias),
                        out_dtype=out_dtype)
            errs.append(float((got.cpu() - want).abs().max())
                        / float(want.abs().max()))
            return got
        return run

    saved = ql.int4_dense_stream, ql.int8_dense_stream
    ql.int4_dense_stream = spy(int4_dense_stream)
    ql.int8_dense_stream = spy(int8_dense_stream)
    try:
        make_quantized_step(card_m, qc, engine="stream",
                            stream_convs="all")(x.to(card), t.to(card))
    finally:
        ql.int4_dense_stream, ql.int8_dense_stream = saved
    assert errs and max(errs) <= 1e-3, (len(errs), max(errs))


# -- the latent models' calibration ------------------------------------------

SD_TINY = dict(image_size=16, in_channels=4, out_channels=4,
               model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_heads=4, use_spatial_transformer=True,
               transformer_depth=1, context_dim=24)


def _tiny_sd(card, **flags):
    """SD_TINY (tests/test_torch_unet_ldm.py) on the CPU and on the card
    with the same seeded weights, flash_threshold 16: its four 64-token
    self-attentions take B2 in a forward that may."""
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.models.unet_ldm import LDMUNet, LDMUNetConfig

    models = []
    for dev in ("cpu", card):
        m = LDMUNet(LDMUNetConfig(**SD_TINY), QuantFlags(**flags).policy_ldm(),
                    flash_threshold=16, device=dev)
        m.load_state_dict(m.init_params(0) if dev == "cpu"
                          else models[0].state_dict())
        models.append(m)
    return models


def _sd_data(n=16):
    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.standard_normal((n, 16, 16, 4)).astype(
        np.float32)), torch.linspace(0.0, 999.0, n),
        torch.from_numpy(rng.standard_normal((n, 7, 24)).astype(np.float32)))


def test_tiny_sd_captures_launch_no_flash_kernel(card):
    """An FP forward of SD_TINY on the card launches B2 at its four
    64-token self-attentions; a grouped FP capture of every unit and an
    asym capture launch neither B2 nor B3 (captures materialize attention,
    as in the JAX package), and the card's captures match the CPU's
    within 1e-4 of the largest magnitude."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib.capture import GroupedCapture
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    resolve_device(card)
    cpu_m, card_m = _tiny_sd(card, weight_bit=4)
    xs, ts, cs = _sd_data(8)
    b2 = flash_attention.launches
    with torch.no_grad():
        card_m(xs[:2].to(card), ts[:2].to(card), None, cs[:2].to(card))
    assert flash_attention.launches == b2 + 4
    names = tuple(u.name for u in card_m.units)
    b2, b3 = flash_attention.launches, streaming_flash_attention.launches
    got = GroupedCapture(card_m, batch_size=4).fp_capture(
        names, xs.to(card), ts.to(card), cs.to(card))
    q = init_weight_qstate(card_m)
    unit = "output_blocks.0.1.transformer_blocks.0"
    asym = GroupedCapture(card_m, batch_size=4).quant_capture(
        q, unit, xs.to(card), ts.to(card), cs.to(card))
    torch.cuda.synchronize()
    assert (flash_attention.launches, streaming_flash_attention.launches) \
        == (b2, b3)
    want = GroupedCapture(cpu_m, batch_size=4).fp_capture(names, xs, ts, cs)
    want_asym = GroupedCapture(cpu_m, batch_size=4).quant_capture(
        init_weight_qstate(cpu_m), unit, xs, ts, cs)
    pairs = [(g, w) for n in names for g, w in zip(
        (*got[n][0], got[n][1]), (*want[n][0], want[n][1]))]
    for g, w in pairs + list(zip(asym, want_asym)):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


def test_tiny_transformer_recon_card_matches_cpu(card, monkeypatch):
    """The act reconstruction (32 iterations) of a transformer-block unit
    of SD_TINY W4A8 (inputs: tokens and the context) on the card and on
    the CPU from the same FP captures, qstate and minibatch indices: no
    B1, B2 or B3 launch inside, and every delta (the layers' inputs and
    attn1 / attn2's q, k, v, sm) within 1e-4 relative, or four times the
    CPU's own spread under 2e-6 relative input noise where larger, as in
    test_tiny_act_recon_card_matches_cpu."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib import recon
    from qdiffusion_torch.calib.capture import capture_unit_io
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    resolve_device(card)
    name = "input_blocks.3.1.transformer_blocks.0"
    cpu_m, card_m = _tiny_sd(card, weight_bit=4, quant_act=True,
                             a_min_max=True)
    xs, ts, cs = _sd_data()
    q = init_act_qstate(cpu_m, init_weight_qstate(cpu_m), xs[:8], ts[:8],
                        cs[:8])
    inps, out = capture_unit_io(cpu_m, q, name, xs, ts, cs, batch_size=8)
    assert inps[1].shape == (16, 7, 24)
    idx = torch.randint(0, 16, (32, 8),
                        generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(recon, "_batch_indices",
                        lambda i, n, bs, gen: idx[i])
    cfg = recon.ReconConfig(iters=32, batch_size=8, p=2.4)

    def run(m, dev, seed=0):
        noise = [1.0 if seed == 0 else 1.0 + 2e-6 * torch.randn(
            a.shape, generator=torch.Generator().manual_seed(seed))
            for a in inps]
        unit = next(u for u in m.units if u.name == name)
        qd = {s: {k: {n: v.to(dev) for n, v in st.items()}
                  for k, st in sl.items()} for s, sl in q.items()}
        new = recon.reconstruct_unit(
            m, qd, unit, tuple((a * z).to(dev) for a, z in zip(inps, noise)),
            out.to(dev), cfg, act_quant=True)
        return {site: {k: d.cpu() for k, d in sl.items()} for site, sl
                in recon.extract_trainable(new, unit, "act").items()}

    kernels = (fused_group_norm, flash_attention, streaming_flash_attention)
    before = [f.launches for f in kernels]
    got = run(card_m, card)
    assert [f.launches for f in kernels] == before
    want = run(cpu_m, "cpu")
    spread = [run(cpu_m, "cpu", seed) for seed in (1, 2, 3, 4)]
    assert {f"{name}.attn1", f"{name}.attn2"} <= set(want)
    for site, slots in want.items():
        for slot, d in slots.items():
            rel = lambda a: float((a - d).abs() / d.abs())  # noqa: E731
            bound = max(1e-4, 4.0 * max(rel(r[site][slot]) for r in spread))
            assert rel(got[site][slot]) <= bound, (site, slot)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["B2", "B3"])
def test_flash_kernels_with_a_16bit_softmax_quantizer(card, kernel, dtype):
    """The softmax quantizer of a W4A8 calibration at --sm-abit 16 (65,536
    levels, always_zero, delta 1/65535): each kernel against its plain
    version, the output as in test_flash_kernels_match_plain and the
    quantized probabilities that feed PV in at most 1e-3 of the elements
    one bucket apart (bucket_flip_share)."""
    from qdiffusion_torch.ops.flash_attention import bucket_flip_share, \
        flash_attention, flash_attention_plain
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention, streaming_flash_attention_plain
    from qdiffusion_torch.quant.affine import AffineQuantizerSpec

    fn, plain = (flash_attention, flash_attention_plain) if kernel == "B2" \
        else (streaming_flash_attention, streaming_flash_attention_plain)
    shape = (2, 128, 300, 2, 40)
    q, k, v = _attn_inputs(card, shape, dtype, seed=6)
    q = (2.5 * q.float()).to(dtype)
    spec = AffineQuantizerSpec(n_bits=16, always_zero=True)
    delta = 1.0 / 65535
    sm_q = ({"delta": torch.tensor(delta, device=card),
             "zero_point": torch.tensor(0.0, device=card)}, spec)
    kw = dict(scale=shape[-1] ** -0.5, sm_q=sm_q)
    got = fn(q, k, v, **kw)
    want = plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    else:
        diff = (got - want).abs()
        assert float(diff.max()) <= 5e-5 + delta * float(v.abs().max())
        assert float((diff > 5e-5).float().mean()) <= 1e-3
    assert bucket_flip_share(fn, plain, q, k, **kw) <= 1e-3


def test_tiny_church_fold_card_matches_cpu(card):
    """An LSUN-churches-shaped UNet (scale-shift norm, resblock up and
    down, 4 heads of 16) under fold W4 in f32, flash_threshold 16 so its
    four 64-token attentions launch B2 (D class 32, padded): the card
    against the CPU, sum order only, 1e-4."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.models.unet_ldm import LDMUNet, LDMUNetConfig
    from qdiffusion_torch.ops.flash_attention import flash_attention

    resolve_device(card)
    cfg = LDMUNetConfig(image_size=16, in_channels=4, out_channels=4,
                        model_channels=32, num_res_blocks=1,
                        attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=4, use_scale_shift_norm=True,
                        resblock_updown=True)
    # seeded on the CPU and copied (a card generator draws other numbers)
    models = []
    for dev in ("cpu", card):
        m = LDMUNet(cfg, QuantFlags(weight_bit=4).policy_ldm(),
                    flash_threshold=16, device=dev)
        m.load_state_dict(models[0].state_dict() if models
                          else m.init_params(0))
        models.append(m)
    q = init_weight_qstate(models[0])
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(
        np.float32))
    t = torch.tensor([10.0, 600.0])
    want = make_quantized_step(models[0], q, engine="fold")(x, t)
    before = flash_attention.launches
    got = make_quantized_step(models[1], {
        s: {k: {n: v.to(card) for n, v in st.items()} for k, st in sl.items()}
        for s, sl in q.items()}, engine="fold")(x.to(card), t.to(card))
    assert flash_attention.launches - before == 4
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_vq_codes_on_card_match_cpu(card):
    """The LSUN-beds codebook's shape (8192 x 3, seeded) on 2 x 64 x 64
    seeded latents: the card's f32 codes equal the CPU's except at
    near-ties, whose two distances (in f64) lie within 1e-4 of
    |z|^2 + |e|^2 (the size of the terms whose f32 rounding they carry)."""
    from qdiffusion_torch.models.vae import VAE, VAEConfig

    cfg = VAEConfig(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1,
                    resolution=32, z_channels=3, embed_dim=3, n_embed=8192)
    g = torch.Generator().manual_seed(5)
    emb = torch.randn((8192, 3), generator=g)
    z = torch.randn((2, 3, 64, 64), generator=g)
    codes = []
    for dev in ("cpu", card):
        vae = VAE(cfg, device=dev)
        with torch.no_grad():
            vae.quantize.embedding.weight.copy_(emb)
            codes.append(vae.vq_codes(z.to(dev)).cpu())
    at = (codes[0] != codes[1]).nonzero().flatten()
    x = z.permute(0, 2, 3, 1).reshape(-1, 3)[at].double()
    ea, eb = emb[codes[0][at]].double(), emb[codes[1][at]].double()
    gap = (((x - ea) ** 2).sum(1) - ((x - eb) ** 2).sum(1)).abs()
    size = (x ** 2).sum(1) + torch.maximum((ea ** 2).sum(1),
                                           (eb ** 2).sum(1))
    assert bool((gap <= 1e-4 * size).all())
    assert at.numel() <= 1e-3 * codes[0].numel()


# -- the samplers: DPM-Solver(++) and ancestral DDPM --------------------------

class _PerCall:
    """A model function that records, per call, the launches of B1 and B2
    it made and the timesteps it saw."""

    def __init__(self, fn):
        from qdiffusion_torch.ops.flash_attention import flash_attention

        self.fn, self.b2, self.calls = fn, flash_attention, []

    def __call__(self, x, t, *context):
        b1, b2 = fused_group_norm.launches, self.b2.launches
        out = self.fn(x, t, *context)
        self.calls.append((fused_group_norm.launches - b1,
                           self.b2.launches - b2, t.clone()))
        return out


@pytest.mark.parametrize("sampler,steps", [("dpm_solver", 6),
                                           ("ddpm_noisy", 4)])
def test_cifar_fold_new_samplers_on_card(card, sampler, steps):
    """The full-width CIFAR UNet under fold W4 (f32) through the pixel
    pipeline: one UNet call per solver evaluation (singlestep order 3 at
    6 steps plans [3, 3]), each launching B1 at its 51 GroupNorms as a
    DDIM step does, finite samples; DPM-Solver's fractional model times
    reach the card unrounded, and its samples match the CPU's within 1e-3
    relative L2 (f32 both, sum order only)."""
    from qdiffusion_torch import cli, resolve_device
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.config import PRESETS, QuantFlags
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.models.unet_ddim import DDIMUNet
    from qdiffusion_torch.pipelines import PixelDiffusionPipeline

    resolve_device(card)
    task = PRESETS["cifar10"]
    models = []
    for dev in ("cpu", card):
        m = DDIMUNet(task.unet_ddim, QuantFlags(weight_bit=4).policy_ddim(),
                     device=dev)
        m.load_state_dict(m.init_params(0) if dev == "cpu"
                          else models[0].state_dict())
        models.append(m)
    q = init_weight_qstate(models[1])
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    out = {}
    for dev, m in zip(("cpu", card), models):
        step = _PerCall(make_quantized_step(m, {
            s: {k: {n: v.to(dev) for n, v in st.items()}
                for k, st in sl.items()} for s, sl in q.items()},
            engine="fold"))
        out[str(dev)] = PixelDiffusionPipeline(m, cli._schedule(task)).sample(
            2, timesteps=steps, sample_type=sampler, x_init=x0.to(dev),
            generator=torch.Generator(device=dev).manual_seed(0),
            model_fn=step).cpu()
    assert len(step.calls) == steps
    assert {(b1, b2) for b1, b2, _ in step.calls} == {(51, 0)}
    got, want = out[str(card)], out["cpu"]
    assert bool(torch.isfinite(got).all()) and got.shape == (2, 32, 32, 3)
    if sampler == "dpm_solver":
        assert any(float(t[0]) != round(float(t[0]))
                   for _, _, t in step.calls)
        assert float(_rel_l2(got, want)) <= 1e-3


def test_tiny_sd_fold_dpm_solver_on_card(card):
    """SD_TINY under fold W4 (f32) through the latent pipeline's
    DPM-Solver at 2 steps with CFG 7.5: two UNet calls on [uncond; cond],
    each launching B2 at its four 64-token self-attentions and B1 as the
    first did; the latents match the CPU's within 1e-3 relative L2."""
    from qdiffusion_torch import cli, resolve_device
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.config import PRESETS
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.pipelines import LatentDiffusionPipeline

    resolve_device(card)
    models = _tiny_sd(card, weight_bit=4)
    q = init_weight_qstate(models[0])
    x, _, c = _sd_data(4)
    out = {}
    for dev, m in zip(("cpu", card), models):
        step = _PerCall(make_quantized_step(m, {
            s: {k: {n: v.to(dev) for n, v in st.items()}
                for k, st in sl.items()} for s, sl in q.items()},
            engine="fold"))
        pipe = LatentDiffusionPipeline(
            unet=m, vae=None, schedule=cli._schedule(PRESETS["sd_v1"]))
        out[str(dev)] = pipe.sample(
            2, sampler="dpm_solver", steps=2, cond=c[:2].to(dev),
            uncond=c[2:].to(dev), guidance_scale=7.5, decode=False,
            x_init=x[:2].to(dev), model_fn=step).cpu()
    assert len(step.calls) == 2
    assert step.calls[0][1] == 4 and step.calls[0][0] > 0
    assert all(c[:2] == step.calls[0][:2] for c in step.calls)
    got = out[str(card)]
    assert bool(torch.isfinite(got).all())
    assert float(_rel_l2(got, out["cpu"])) <= 1e-3


def test_quality_protocol_smoke_size_on_card(card, monkeypatch):
    """The quality-evidence harness at its CPU test's smoke size on the
    card: JAX's output keys with finite values; kernel B1 launched 0 times
    in training and inside every reconstruction, and in every sampling
    arm; a second run of the same seed gives the same result exactly
    (cuDNN's deterministic algorithms)."""
    import contextlib
    import math

    from qdiffusion_torch.calib import engine
    from qdiffusion_torch.scripts import quality_evidence as qe

    fused_group_norm.launches = 0
    parts, recon = {}, []

    @contextlib.contextmanager
    def part(name):
        b0 = fused_group_norm.launches
        yield
        parts[name] = fused_group_norm.launches - b0

    real = engine.reconstruct_unit

    def recon_spy(*a, **kw):
        b0 = fused_group_norm.launches
        res = real(*a, **kw)
        recon.append(fused_group_norm.launches - b0)
        return res

    monkeypatch.setattr(engine, "reconstruct_unit", recon_spy)
    out = qe.run_protocol(train_steps=4, n_samples=8, recon_iters=2, bits=4,
                          sample_steps=4, cali_n=8, cali_st=4, seed=0,
                          act_quant=True, log=lambda *a: None,
                          device=card, part=part)
    assert all(math.isfinite(v) for v in out.values()
               if isinstance(v, float))
    assert "fid_calib_a8" in out and "recovered_frac" in out
    assert parts["train"] == 0
    assert len(recon) == 2 * 18 and set(recon) == {0}
    for name in ("sample_fp", "sample_naive", "sample_calib",
                 "sample_naive_a8", "sample_calib_a8"):
        assert parts[name] == 4 * 21, name  # DDIM-4, 21 GroupNorms a call
    again = qe.run_protocol(train_steps=4, n_samples=8, recon_iters=2,
                            bits=4, sample_steps=4, cali_n=8, cali_st=4,
                            seed=0, act_quant=True, log=lambda *a: None,
                            device=card)
    assert again == out
    assert not torch.backends.cudnn.deterministic  # restored


def test_tiny_export_round_trip_on_card(card, tmp_path):
    """export_quantized_checkpoint of a tiny split W4 UNet on the card,
    load_quantized_checkpoint of the file: the reloaded quantized weights
    equal fold_weights' bit for bit, a forward of the reloaded model is
    within 2e-3 of the fold engine's (B1 launched in both), and the file
    is under a quarter of the f32 params' bytes."""
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.deploy import export_quantized_checkpoint, \
        fold_weights, load_quantized_checkpoint, make_quantized_step
    from qdiffusion_torch.models.unet_ddim import DDIMUNet, DDIMUNetConfig

    resolve_device(card)
    cfg = DDIMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=16,
                         split_shortcut=True)
    policy = QuantFlags(weight_bit=4).policy_ddim()
    m = DDIMUNet(cfg, policy, device=card)
    m.load_state_dict({k: v + 0.01 * (k.endswith("bias"))
                       for k, v in m.init_params(0).items()})
    q = init_weight_qstate(m)
    man = export_quantized_checkpoint(m, q, tmp_path / "w4.npz")
    sd, _ = load_quantized_checkpoint(tmp_path / "w4.npz")
    sd = {k: v.to(card) for k, v in sd.items()}
    folded = fold_weights(m, q)
    assert all(torch.equal(sd[f"{n}.weight"], folded[f"{n}.weight"])
               for n in man)
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator(
        device=card).manual_seed(0), device=card)
    t = torch.tensor([10.0, 900.0], device=card)
    fused_group_norm.launches = 0
    want = make_quantized_step(m, q, "fold")(x, t)
    n_fold = fused_group_norm.launches
    r = DDIMUNet(cfg, policy, device=card)
    r.load_state_dict(sd)
    with torch.no_grad():
        got = r(x, t)
    assert n_fold > 0 and fused_group_norm.launches == 2 * n_fold
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    f32 = 4 * sum(v.numel() for v in m.state_dict().values())
    assert (tmp_path / "w4.npz").stat().st_size < f32 / 4
