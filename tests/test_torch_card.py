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
        pytest.skip("needs a CUDA device: the Triton kernel runs only on "
                    "the card")
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
