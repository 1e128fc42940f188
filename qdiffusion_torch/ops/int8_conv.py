"""Kernel B4 on the card: the int8 engine's convolution (and dense layer)
as a quantize pass and one implicit-GEMM launch, with the spatial padding
and the patch gather inside the GEMM's load path.

Replaces qdiffusion_tpu/ops/pallas/int8_matmul.py::int8_matmul_dequant
(pallas_call :88), the JAX int8 engine's product, and what surrounds it
in the JAX package's int8_conv2d (qdiffusion_tpu/ops/int8.py:183-216:
quantize_act, lax.pad with the pad value, XLA's int8
conv_general_dilated and the windowed row sum). The function per site is
that of ops/int8.py::int8_conv2d_plain: for each input-channel segment s
(one, or two at the split 1x1 shortcut convs),

    x_c = clamp(round(x / delta_s) + zp_s) - centre_s   (a_pad_s outside)
    y_s = A_s * (x_c * w_c) + Bc_s * S(x_c) + C_s       (int32 product)

then y = (y_0 + y_1) + bias, cast once to the output type. The CUDA
source is csrc/int_matmul.cu (`int8_quantize_kernel`, which writes x_c
once as contiguous int8 NHWC; `int8_conv_kernel`; and
`int8_conv_reduce_kernel` when K is split); its note says what bounds it
on an H100 and how the design meets that.

The quantize pass reads x in place: an NCHW tensor in channels_last
memory (channel stride 1, any batch, row and pixel strides; segment 1's
channels follow segment 0's) or, for a dense layer, rows of channels with
one row stride. A layout it cannot express raises ValueError; nothing is
copied to make it fit. The GEMM's weights are each segment's `w_t`, the
(N, kh, kw, C) tap-major copy of `w_c` made at pack time.

`conv_plan` picks the launch: 128 x 128 output tiles, and where they are
fewer than the SMs, K split on stage boundaries (int32
partials add exactly in any order, and the epilogue runs once, after the
reduction). `conv_rows_model` is the kernel's A-tile addressing written
in PyTorch, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import torch

from qdiffusion_torch.device import sm_count

__all__ = ["ConvGeometry", "ConvPlan", "conv_plan", "conv_geometry",
           "dense_geometry", "conv_rows_model", "tap_major", "int8_conv",
           "DESC_FIELDS", "SEG_FIELDS", "CONV_BM", "CONV_BN", "CONV_BK"]

#: The kernel's block tile (csrc/int_matmul.cu, namespace b4): BM output
#: pixels by BN output channels, K in stages of BK int8 values.
CONV_BM, CONV_BN, CONV_BK = 128, 128, 64
CONV_WAVE = 2  # blocks per SM that a split launch aims at (the kernel
# runs two blocks per SM); K is split only where the tiles are fewer than
# the SMs
CONV_SPLIT_CAP = 16  # most K pieces of one launch
CONV_MIN_STAGES = 4  # fewest stages a piece walks

#: qdt_int8_conv's descriptor: int64 fields in the order of the enums
#: DescField and SegField of csrc/int_matmul.cu (a CPU test holds these
#: lists against the source).
DESC_FIELDS = ("NSEG", "XTYPE", "M", "N", "H", "W", "HO", "WO", "KH", "KW",
               "SH", "SW", "PT", "PL", "SB", "SROW", "SPIX", "Y", "YBF16",
               "BIAS", "WS", "XQ", "SPLITS", "SPS", "PIECES0")
SEG_FIELDS = ("X", "W", "A", "BC", "CC", "DELTA", "ZP", "LO", "HI", "CENTER",
              "PAD", "C")
_XTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One conv site as the kernel sees it: B images of H x W pixels, an
    output of Ho x Wo, a kh x kw filter at stride (sh, sw), and the top /
    left padding (bottom / right follow from Ho, Wo)."""

    B: int
    H: int
    W: int
    Ho: int
    Wo: int
    kh: int
    kw: int
    sh: int
    sw: int
    pt: int
    pl: int

    @property
    def M(self) -> int:
        return self.B * self.Ho * self.Wo


def conv_geometry(x_shape, kshape, stride, pads) -> ConvGeometry:
    """The geometry of a conv of NCHW `x_shape` with pads ((pt, pb),
    (pl, pr)) as nn.pad_amounts gives them."""
    b, _, h, w = x_shape
    (pt, pb), (pl, pr) = pads
    kh, kw = kshape
    sh, sw = stride
    return ConvGeometry(b, h, w, (h + pt + pb - kh) // sh + 1,
                        (w + pl + pr - kw) // sw + 1, kh, kw, sh, sw, pt, pl)


def dense_geometry(m: int) -> ConvGeometry:
    """A dense layer over m rows: m images of one pixel, a 1 x 1 filter."""
    return ConvGeometry(m, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0)


def stages(k: int) -> int:
    return -(-k // CONV_BK)


class ConvPlan(NamedTuple):
    """How one B4 launch covers a site: `splits` == 1 runs every segment
    in one block per output tile; above that, block z of the grid's
    (n_tiles, m_tiles, splits) walks `sps` stages of one segment (segment
    0's `pieces0` pieces first)."""

    splits: int
    sps: int
    pieces0: int
    grid: tuple


def conv_plan(M: int, N: int, seg_stages: Sequence[int], sms: int = 132
              ) -> ConvPlan:
    """The launch plan of B4 for an (M, N) output over segments of
    `seg_stages` stages of CONV_BK each, on a card of `sms` SMs. Where
    the output tiles are fewer than the SMs, K is split into pieces of at
    least CONV_MIN_STAGES stages, at most CONV_SPLIT_CAP of them, until
    the grid reaches CONV_WAVE blocks per SM; a piece never spans two
    segments."""
    tiles = -(-M // CONV_BM) * -(-N // CONV_BN)
    total = sum(seg_stages)
    want = 1
    if tiles < sms:
        want = min(CONV_SPLIT_CAP, -(-CONV_WAVE * sms // tiles),
                   total // CONV_MIN_STAGES)
    grid_xy = (-(-N // CONV_BN), -(-M // CONV_BM))
    if want <= 1:
        return ConvPlan(1, total, 1, grid_xy + (1,))
    sps = max(1, -(-total // want))
    pieces = [-(-s // sps) for s in seg_stages]
    if sum(pieces) <= 1:
        return ConvPlan(1, total, 1, grid_xy + (1,))
    return ConvPlan(sum(pieces), sps, pieces[0], grid_xy + (sum(pieces),))


def tap_major(w_c: torch.Tensor, kshape) -> torch.Tensor:
    """(C*kh*kw, N) int8 rows in (c, kh, kw) order -> the contiguous
    (N, kh, kw, C) copy whose rows are the kernel's K order."""
    kh, kw = (tuple(kshape) + (1, 1))[:2] if len(kshape) < 2 else kshape
    n = w_c.shape[1]
    c = w_c.shape[0] // (kh * kw)
    return w_c.reshape(c, kh, kw, n).permute(3, 1, 2, 0).contiguous()


def conv_rows_model(x_c: torch.Tensor, geom: ConvGeometry, c0: int,
                    cs: int, a_pad: int) -> torch.Tensor:
    """The kernel's A operand in PyTorch: for output pixel m = (b, ho, wo)
    and k = (i*kw + j)*cs + c, the int8 value at (b, ho*sh + i - pt,
    wo*sw + j - pl, c0 + c) of the NHWC tensor `x_c`, or a_pad outside the
    image; (M, kh*kw*cs) int8. It mirrors the kernel's index arithmetic
    (csrc/int_matmul.cu, int8_conv_kernel's `load`), for tests."""
    g = geom
    m = torch.arange(g.M)
    b, rem = m // (g.Ho * g.Wo), m % (g.Ho * g.Wo)
    ho, wo = rem // g.Wo, rem % g.Wo
    k = torch.arange(g.kh * g.kw * cs)
    tap, c = k // cs, k % cs
    i, j = tap // g.kw, tap % g.kw
    h = (ho * g.sh - g.pt)[:, None] + i[None, :]
    w = (wo * g.sw - g.pl)[:, None] + j[None, :]
    inside = (h >= 0) & (h < g.H) & (w >= 0) & (w < g.W)
    vals = x_c[b[:, None].expand_as(h), h.clamp(0, g.H - 1),
               w.clamp(0, g.W - 1), (c0 + c)[None, :].expand_as(h)]
    return torch.where(inside, vals, torch.full_like(vals, a_pad))


def _segment_fields(seg, x: torch.Tensor, xtype: int) -> List[int]:
    """One segment's descriptor fields (SEG_FIELDS order), after checking
    that its tensors are what the kernel takes."""
    fn = "int8_conv"
    dev = x.device
    n = seg["w_t"].shape[0]
    if seg["w_t"].dtype != torch.int8 or seg["w_t"].device != dev \
            or not seg["w_t"].is_contiguous():
        raise ValueError(f"{fn}: w_t must be a contiguous int8 tensor on "
                         f"{dev}")
    for name in ("A", "Bc", "Cc"):
        a = seg[name]
        if a.dtype != torch.float32 or a.device != dev or a.shape != (n,) \
                or not a.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous f32 ({n},) "
                             f"tensor on {dev}")
    if xtype != 2:
        for name in ("delta", "zp"):
            a = seg[name]
            if a.dtype != torch.float32 or a.device != dev or a.numel() != 1:
                raise ValueError(
                    f"{fn}: the activation quantizer's {name} must be one "
                    f"f32 value on {dev} (the kernel reads it there; a "
                    "CPU scalar would also make the plain version "
                    "multiply by 1/delta instead of dividing)")
    if xtype == 2:
        delta = zp = 0
    else:
        delta, zp = seg["delta"].data_ptr(), seg["zp"].data_ptr()
    return [x.data_ptr() + seg["c0"] * x.element_size(),
            seg["w_t"].data_ptr(),
            seg["A"].data_ptr(), seg["Bc"].data_ptr(), seg["Cc"].data_ptr(),
            delta, zp, int(seg["lo"]), int(seg["hi"]), int(seg["center"]),
            int(seg["a_pad"]), int(seg["C"])]


def int8_conv(x: torch.Tensor, strides: Sequence[int], geom: ConvGeometry,
              segs: List[dict], bias: Optional[torch.Tensor],
              out_dtype) -> torch.Tensor:
    """One call of B4 on CUDA tensors: the quantize pass (for f32 / bf16
    x, into an int8 copy allocated here) and the implicit GEMM (with its
    K-split reduction where the plan splits K). x: the activation, or an
    int8 x already quantized (one segment), element (b, h, w, c) at
    b*strides[0] + h*strides[1] + w*strides[2] + c of x.data_ptr().
    segs: per segment a dict of its first channel `c0` (0, then segment
    0's `C`), channels `C`, `w_t` (N, kh*kw*C) int8, epilogue constants
    `A`, `Bc`, `Cc` (N,) f32, quantizer `delta`, `zp` (one f32 value on
    the device), `lo`, `hi`, `center` and `a_pad` (integers). Returns
    (geom.M, N) in out_dtype (f32 or bf16), rows in (b, ho, wo) order.
    Raises ValueError for what the kernels do not take. Adds one to
    `int8_conv.launches`."""
    from qdiffusion_torch.ops import _cuda

    fn = "int8_conv"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype not in _XTYPES:
        raise ValueError(f"{fn}: unsupported dtype {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: unsupported out_dtype {out_dtype}")
    xtype = _XTYPES[x.dtype]
    if not 1 <= len(segs) <= 2 or (xtype == 2 and len(segs) != 1):
        raise ValueError(f"{fn}: {len(segs)} segments of {x.dtype} x")
    n = segs[0]["w_t"].shape[0]
    if [s["c0"] for s in segs] != [0, segs[0]["C"]][:len(segs)]:
        raise ValueError(f"{fn}: segment channels must start at 0 and "
                         "follow each other")
    if any(s["w_t"].shape[0] != n for s in segs):
        raise ValueError(f"{fn}: segments of different output widths")
    if any(s["w_t"].numel() != n * geom.kh * geom.kw * s["C"] for s in segs):
        raise ValueError(f"{fn}: w_t does not hold N x kh x kw x C values")
    if bias is not None and (bias.dtype != torch.float32 or bias.device
                             != x.device or bias.shape != (n,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{fn}: bias must be a contiguous f32 ({n},) "
                         f"tensor on {x.device}")
    # every element the kernel may address lies inside x's storage
    top = max(s["c0"] + s["C"] for s in segs) - 1 + (geom.B - 1) * strides[
        0] + (geom.H - 1) * strides[1] + (geom.W - 1) * strides[2]
    if min(strides) < 0 or x.storage_offset() + top >= \
            x.untyped_storage().nbytes() // x.element_size() \
            or top >= 2**31 or geom.M * n >= 2**31:
        raise ValueError(f"{fn}: x {tuple(x.shape)} with strides "
                         f"{tuple(strides)} does not hold the {geom} site")
    plan = conv_plan(geom.M, n, [stages(geom.kh * geom.kw * s["C"])
                                 for s in segs], sm_count(x.device))
    y = torch.empty((geom.M, n), dtype=out_dtype, device=x.device)
    ws = torch.empty(plan.splits * geom.M * (n + 1), dtype=torch.int32,
                     device=x.device) if plan.splits > 1 else None
    xq = None if xtype == 2 else torch.empty(
        geom.B * geom.H * geom.W * sum(s["C"] for s in segs),
        dtype=torch.int8, device=x.device)
    g = geom
    desc = [len(segs), xtype, g.M, n, g.H, g.W, g.Ho, g.Wo, g.kh, g.kw, g.sh,
            g.sw, g.pt, g.pl, strides[0], strides[1], strides[2],
            y.data_ptr(), int(out_dtype == torch.bfloat16),
            0 if bias is None else bias.data_ptr(),
            0 if ws is None else ws.data_ptr(),
            0 if xq is None else xq.data_ptr(), plan.splits, plan.sps,
            plan.pieces0]
    for s in segs:
        desc += _segment_fields(s, x, xtype)
    desc += [0] * (len(SEG_FIELDS) * (2 - len(segs)))
    arr = (ctypes.c_longlong * len(desc))(*desc)
    err = _cuda.library("int_matmul.cu").qdt_int8_conv(
        ctypes.addressof(arr), _cuda.stream_ptr(x.device))
    _cuda.check(err, f"{fn} ({g}, N={n}, {len(segs)} segments, {plan})")
    int8_conv.launches += 1
    return y


int8_conv.launches = 0
