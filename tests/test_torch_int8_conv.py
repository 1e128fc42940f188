"""Kernel B4's implicit-GEMM convolution (ops/int8_conv.py), the parts
that run on the CPU: the launch plan, the tap-major weight copy, the
kernel's A-tile addressing (a PyTorch model of it, against the patches
of the plain version), the C descriptor's field order, and int8_conv2d
(the plain version on the CPU) against the JAX package's int8_conv2d at
the geometries the kernel takes, on an asymmetric activation grid (a
non-zero pad value). The kernel itself runs only on the card
(tests/test_torch_card.py, chip_smoke.py). Integer values compare
exactly; int8_conv2d to 1e-6 of its largest output, as in
test_torch_int8.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qdiffusion_tpu.ops.int8 as jax_int8

import qdiffusion_torch.ops.int8 as int8
from qdiffusion_torch import nn
from qdiffusion_torch.ops import int8_conv as ic

from test_torch_int8 import _close, _layer

torch.set_num_threads(1)

SRC = Path(ic.__file__).resolve().parents[1] / "csrc" / "int_matmul.cu"


def test_descriptor_fields_match_the_source():
    src = SRC.read_text()

    def enum(name):
        body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
        return [f.strip() for f in body.split(",") if f.strip()]

    assert enum("DescField") == [f"D_{f}" for f in ic.DESC_FIELDS] + [
        "D_SEG"]
    assert enum("SegField") == [f"S_{f}" for f in ic.SEG_FIELDS] + [
        "S_FIELDS"]


# (M, N, stages of each segment) at batch 64, from the CIFAR W4A8 sites:
# 3x3 at 32x32 (K = 1152), 16x16, 8x8, 4x4 (K = 2304), the input conv
# (K = 27), the split 1x1 shortcuts at 32x32 / 8x8 / 4x4, a dense layer
PLAN_CASES = [(65536, 128, (18,)), (65536, 128, (1,)), (65536, 3, (18,)),
              (16384, 256, (36,)), (4096, 256, (36,)), (1024, 256, (36,)),
              (1024, 256, (72,)), (65536, 128, (2, 2)), (4096, 256, (4, 4)),
              (1024, 256, (4, 4)), (64, 512, (8,)), (64, 128, (2,)),
              (1, 27, (1,))]


@pytest.mark.parametrize("M,N,seg_stages", PLAN_CASES)
def test_conv_plan_covers_every_stage_once(M, N, seg_stages):
    sms = 132
    plan = ic.conv_plan(M, N, seg_stages, sms)
    tiles = -(-M // ic.CONV_BM) * -(-N // ic.CONV_BN)
    assert plan.grid == (-(-N // ic.CONV_BN), -(-M // ic.CONV_BM),
                         plan.splits)
    if plan.splits == 1:
        # one block per tile does every segment: the card is full, or K
        # is too short to split into pieces of CONV_MIN_STAGES
        assert tiles >= sms or sum(seg_stages) < 2 * ic.CONV_MIN_STAGES
        return
    # pieces never span two segments and cover each one once
    pieces = [-(-s // plan.sps) for s in seg_stages]
    assert plan.pieces0 == pieces[0] and plan.splits == sum(pieces)
    assert plan.splits <= ic.CONV_SPLIT_CAP + len(seg_stages) - 1
    assert tiles < sms
    assert plan.sps >= min(ic.CONV_MIN_STAGES, min(seg_stages))


def test_conv_plan_splits_the_small_sites_and_not_the_large():
    assert ic.conv_plan(65536, 128, (18,)).splits == 1
    assert ic.conv_plan(16384, 256, (36,)).splits == 1
    small = ic.conv_plan(1024, 256, (36,))  # 4x4 at batch 64: 16 tiles
    assert small.splits > 1 and 16 * small.splits >= 132
    mid = ic.conv_plan(4096, 256, (36,))  # 8x8: 64 tiles
    assert mid.splits > 1


@pytest.mark.parametrize("kshape,ci,co", [((3, 3), 3, 16), ((3, 3), 16, 3),
                                          ((1, 1), 24, 7), ((), 13, 5)])
def test_tap_major_copy_holds_w_c(kshape, ci, co):
    rng = np.random.default_rng(ci)
    kh, kw = kshape if kshape else (1, 1)
    w_c = torch.from_numpy(rng.integers(-8, 8, (ci * kh * kw, co)).astype(
        np.int8))
    w_t = ic.tap_major(w_c, kshape)
    assert w_t.shape == (co, kh, kw, ci) and w_t.is_contiguous()
    for n in range(co):
        for i in range(kh):
            for j in range(kw):
                np.testing.assert_array_equal(
                    w_t[n, i, j].numpy(),
                    w_c[np.arange(ci) * kh * kw + i * kw + j, n].numpy())


def test_pack_layer_keeps_the_tap_major_copy():
    _, (mod, tst, tcfg), _ = _layer((3, 3), 12, 10, split=0, seed=1)
    seg = int8.pack_layer(mod, tst, tcfg).segments[0]
    torch.testing.assert_close(seg.w_t, ic.tap_major(seg.w_c, (3, 3)),
                               rtol=0, atol=0)


# (H, W, C total, segment offset c0 and width cs, kshape, stride,
# padding): padded 3x3, the pre-padded stride-2 downsample, "SAME" at
# stride 2, the 3-channel input conv, a split segment at offset 8 of 20
GEOMS = [(7, 7, 12, 0, 12, (3, 3), (1, 1), 1),
         (9, 9, 12, 0, 12, (3, 3), (2, 2), 0),
         (7, 6, 12, 0, 12, (3, 3), (2, 2), "SAME"),
         (8, 8, 3, 0, 3, (3, 3), (1, 1), 1),
         (5, 5, 20, 8, 12, (1, 1), (1, 1), 0),
         (5, 5, 20, 0, 8, (1, 1), (1, 1), 0)]


@pytest.mark.parametrize("geom_case", GEOMS)
def test_a_tile_addressing_matches_patches(geom_case):
    h, w, ctot, c0, cs, kshape, stride, padding = geom_case
    rng = np.random.default_rng(h * w + c0)
    a_pad = -57  # an asymmetric grid's pad value: not zero
    x_c = torch.from_numpy(rng.integers(-128, 128, (2, h, w, ctot)).astype(
        np.int8))
    seg_nchw = x_c.permute(0, 3, 1, 2).narrow(1, c0, cs)
    assert seg_nchw.stride(1) == 1 and seg_nchw.stride(3) == ctot
    pads = nn.pad_amounts(padding, kshape, stride, (h, w))
    geom = ic.conv_geometry(seg_nchw.shape, kshape, stride, pads)
    got = ic.conv_rows_model(x_c, geom, c0, cs, a_pad)
    p = nn.patches(seg_nchw, kshape, stride, pads, value=a_pad)
    kh, kw = kshape
    assert p.shape[1:3] == (geom.Ho, geom.Wo)
    want = p.reshape(geom.M, cs, kh, kw).permute(0, 2, 3, 1).reshape(
        geom.M, -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the products of the tap-major rows and weights are the plain ones
    w_c = torch.from_numpy(rng.integers(-8, 8, (cs * kh * kw, 5)).astype(
        np.int8))
    w_t = ic.tap_major(w_c, kshape).reshape(5, -1)
    np.testing.assert_array_equal(
        (got.long() @ w_t.long().t()).numpy(),
        (p.reshape(geom.M, -1).long() @ w_c.long()).numpy())


def test_dense_geometry_is_a_1x1_conv_over_rows():
    g = ic.dense_geometry(37)
    assert (g.M, g.H, g.W, g.Ho, g.Wo, g.kh, g.kw) == (37, 1, 1, 1, 1, 1, 1)
    x_c = torch.arange(37 * 6, dtype=torch.int8).reshape(37, 1, 1, 6)
    np.testing.assert_array_equal(
        ic.conv_rows_model(x_c, g, 2, 4, 0).numpy(),
        x_c.reshape(37, 6)[:, 2:].numpy())


# (kshape, ci, co, split, stride, padding, pre-pad): the kernel's
# geometry kinds on an asymmetric 8-bit activation grid
CONV_CASES = [((3, 3), 3, 16, 0, 1, 1, False),    # input conv, C = 3
              ((3, 3), 16, 3, 0, 1, 1, False),    # output conv, N = 3
              ((3, 3), 16, 8, 0, 2, 0, True),     # pre-padded stride 2
              ((3, 3), 12, 10, 0, 2, "SAME", False),
              ((1, 1), 20, 12, 8, 1, 0, False),   # split at offset 8
              ((1, 1), 16, 9, 0, 1, 0, False)]


@pytest.mark.parametrize("kshape,ci,co,split,stride,padding,prepad",
                         CONV_CASES)
def test_int8_conv2d_matches_jax_at_kernel_geometries(
        kshape, ci, co, split, stride, padding, prepad):
    (p, jst, jcfg), (mod, tst, tcfg), x = _layer(kshape, ci, co, split,
                                                 seed=ci + co)
    if prepad:  # the model's (0, 1, 0, 1) zero pad before the conv
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    packed = int8.pack_layer(mod, tst, tcfg)
    assert any(s.a_pad != 0 for s in packed.segments)
    want = np.asarray(jax_int8.int8_conv2d(
        jnp.asarray(x), jax_int8.pack_layer(p, jst, jcfg), stride=stride,
        padding=padding))
    before = ic.int8_conv.launches
    got = int8.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), packed,
                           stride=stride, padding=padding)
    assert ic.int8_conv.launches == before  # the CPU runs the plain version
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got.numpy(), want)
