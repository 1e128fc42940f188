"""Real integer (int8-carrier) inference (port of
qdiffusion_tpu/ops/int8.py).

The reference only simulates quantization in fp32 (qdiff/quant_layer.py:
66-89). The int8 engine runs the products in int8:

    y = dx * dw[o] * (x_q - zpx) . (w_q - zpw) + b

with both operands recentred to the signed int8 range:

    x_c = x_q - 128 (asym 8-bit acts)   cx = 128 - zpx
    w_c = w_q - 2^(b-1)                 cw[o] = 2^(b-1) - zpw[o]

    (x_c + cx) . (w_c + cw) = x_c.w_c + cw*S(x_c) + cx*sum(w_c) + cx*cw*K

Everything but the product and S, the row sum of x_c, folds at pack time
into three per-output-channel constants: y = A*acc + Bc*S + C with
A = dx*dw, Bc = A*cw, C = A*(cx*sum(w_c) + cx*cw*K) (+ bias, added once).
Kernel B4 (ops/int8_matmul.py) computes acc exactly in int32, S, and the
epilogue.

Convolutions: torch has no int8 convolution on the card, and a float
convolution of integer values is not exact (Winograd and FFT algorithms;
W8 sums pass 2^24). On the card, `int8_conv2d` and `int8_dense` are one
call of kernel B4 each (ops/int8_conv.py, csrc/int_matmul.cu): a pass
that quantizes the activation once, then an implicit GEMM that pads it
with the integer value of f32 zero (`_pad_value_i8`, not zero for
asymmetric grids) and gathers the taps in its load path, and fuses both
segments' epilogues and the bias. On the CPU they run the plain version,
`int8_conv2d_plain` / `int8_dense_plain`: quantize, pad, gather int8
patches in the (c, kh, kw) K order of the packed weight and run B4's
plain product over them; a patch row's sum is the JAX package's windowed
sum `s_win` (int8.py:206-209), so the epilogue is the same. A 1x1
stride-1 conv needs no gather.

Activation x activation products (attention) have no int8 kernel in the
JAX package either: `int8_einsum` runs an f32 einsum of the int8 values,
exact while the contraction is at most 1024 long (|a_c b_c| <= 2^14, so
the partial sums stay below 2^24); a longer one is split into chunks of
1024 whose f32 results add in float64.

Layouts: weights arrive in the port's (out, in, ...) layout; a packed
segment holds w_c as the 2-D (K, N) int8 matrix of the JAX package's
stream pack (`to2d`, deploy.py:127-134): rows in (c, kh, kw) order,
output channels last. Beside it, `w_t` holds the same values as the
(N, kh, kw, C) tap-major copy that the kernel reads (ops/int8_conv.py::
tap_major), made once at pack time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch

from qdiffusion_torch import nn
from qdiffusion_torch.ops.int8_conv import conv_geometry, \
    dense_geometry, int8_conv, tap_major
from qdiffusion_torch.ops.int8_matmul import int8_dense_pallas, \
    int8_matmul_plain
from qdiffusion_torch.ops.qlayers import LayerQuantConfig, split_weight
from qdiffusion_torch.quant.affine import AffineQuantizerSpec

__all__ = ["PackedSegment", "PackedWeight", "weight_int_values",
           "pack_layer", "quantize_act", "int8_conv2d", "int8_dense",
           "int8_conv2d_plain", "int8_dense_plain", "int8_einsum", "to2d"]

# contraction length up to which an f32 product of int8 values is exact
_EXACT_F32_K = 1024


@dataclasses.dataclass
class PackedSegment:
    """One input-channel segment of a packed integer weight."""

    w_c: torch.Tensor  # int8 (K, N), K = in_ch * prod(kshape)
    scale_a: torch.Tensor  # A  = dx * dw                  (N,)
    scale_s: torch.Tensor  # Bc = dx * dw * cw             (N,)
    const: torch.Tensor  # C = dx*dw*(cx*wsum + cx*cw*K)  (N,)
    a_delta: torch.Tensor  # act quantizer delta (scalar, f32)
    a_zp: torch.Tensor  # act quantizer zero point (scalar, f32)
    a_spec: AffineQuantizerSpec
    in_ch: int  # input channels of the segment
    kshape: Tuple[int, ...]  # filter dims: (kh, kw), (kl,), () for dense
    a_pad: int  # int8 value of f32 zero (_pad_value_i8)
    w_t: torch.Tensor  # int8 (N, *kshape, in_ch): B4's tap-major w_c


@dataclasses.dataclass
class PackedWeight:
    segments: List[PackedSegment]
    bias: Optional[torch.Tensor]


def weight_int_values(w: torch.Tensor, st: dict,
                      spec: AffineQuantizerSpec) -> torch.Tensor:
    """Integer grid values of a calibrated weight quantizer: AdaRound hard
    rounding when alpha is present, nearest otherwise (int8.py:83-93)."""
    delta, zp = st["delta"], st["zero_point"]
    if "alpha" in st:
        w_int = torch.floor(w / delta) + (st["alpha"] >= 0).to(w.dtype)
    else:
        w_int = torch.round(w / delta)
    if spec.symmetric:
        return torch.clamp(w_int + zp, -spec.n_levels - 1, spec.n_levels)
    return torch.clamp(w_int + zp, 0, spec.n_levels - 1)


def to2d(w: torch.Tensor) -> torch.Tensor:
    """(out, in, *filter) -> contiguous (in * prod(filter), out), rows in
    (c, *filter) order: the JAX stream pack's `to2d` of an HWIO / LIO /
    (in, out) weight."""
    return w.permute(*range(1, w.ndim), 0).reshape(-1, w.shape[0]) \
        .contiguous()


def _pad_value_i8(spec: AffineQuantizerSpec, a_zp: torch.Tensor) -> int:
    """Integer-domain value representing f32 zero (grid-clamped;
    int8.py:158-164). Read once, at pack time."""
    if spec.symmetric:
        return 0
    n_lv = spec.n_levels
    return int(torch.clamp(a_zp, 0, n_lv - 1) - 2 ** (spec.n_bits - 1))


def _pack_segment(w: torch.Tensor, wst: dict, ast: dict,
                  cfg: LayerQuantConfig) -> PackedSegment:
    spec = cfg.wq
    wq = weight_int_values(w, wst, spec)
    w_center = 0.0 if spec.symmetric else float(2 ** (spec.n_bits - 1))
    w_c = (wq - w_center).to(torch.int8)
    red_axes = tuple(range(1, w.ndim))
    wsum = w_c.float().sum(dim=red_axes).reshape(-1)
    k_elems = float(math.prod(w.shape[1:]))
    n_out = w.shape[0]

    def per_channel(a):
        a = torch.as_tensor(a, dtype=torch.float32,
                            device=w.device).reshape(-1)
        return a.expand(n_out) if a.numel() == 1 else a

    dw = per_channel(wst["delta"])
    cw = per_channel(w_center - torch.as_tensor(wst["zero_point"]).float())

    a_spec = cfg.aq
    a_delta = torch.as_tensor(ast["delta"]).float()
    a_zp = torch.as_tensor(ast["zero_point"]).float()
    a_center = 0.0 if a_spec.symmetric else float(2 ** (a_spec.n_bits - 1))
    cx = a_center - a_zp  # scalar (activation quantizers are per-tensor)

    scale_a = a_delta * dw
    scale_s = scale_a * cw
    const = scale_a * (cx * wsum + cx * cw * k_elems)

    w2d = to2d(w_c)
    return PackedSegment(
        w_c=w2d, w_t=tap_major(w2d, tuple(int(s) for s in w.shape[2:])),
        scale_a=scale_a.contiguous(),
        scale_s=scale_s.contiguous(), const=const.contiguous(),
        a_delta=a_delta, a_zp=a_zp, a_spec=a_spec, in_ch=int(w.shape[1]),
        kshape=tuple(int(s) for s in w.shape[2:]),
        a_pad=_pad_value_i8(a_spec, a_zp))


@torch.no_grad()
def pack_layer(layer: torch.nn.Module, lstate: dict,
               cfg: LayerQuantConfig) -> PackedWeight:
    """Pack a calibrated conv / dense layer (its `weight`, `bias`) for
    integer inference (int8.py:129-140)."""
    w = layer.weight.detach()
    if cfg.split:
        w_a, w_b = split_weight(w, cfg.split)
        segments = [_pack_segment(w_a, lstate["w"], lstate["a"], cfg),
                    _pack_segment(w_b, lstate["w0"], lstate["a0"], cfg)]
    else:
        segments = [_pack_segment(w, lstate["w"], lstate["a"], cfg)]
    bias = None if layer.bias is None else layer.bias.detach()
    return PackedWeight(segments=segments, bias=bias)


def quantize_act(x: torch.Tensor, seg: PackedSegment) -> torch.Tensor:
    """Activations -> recentred int8 carrier, with fake_quant's division
    by delta and clamps (int8.py:143-155)."""
    spec = seg.a_spec
    n_levels = spec.n_levels
    x_int = torch.round(x.float() / seg.a_delta) + seg.a_zp
    if spec.symmetric:
        x_q = torch.clamp(x_int, -n_levels - 1, n_levels)
        center = 0.0
    else:
        x_q = torch.clamp(x_int, 0, n_levels - 1)
        center = float(2 ** (spec.n_bits - 1))
    return (x_q - center).to(torch.int8)


def _segments_of(x: torch.Tensor, packed: PackedWeight, axis: int):
    if len(packed.segments) == 1:
        return [x]
    c0, out = 0, []
    for seg in packed.segments:
        out.append(x.narrow(axis, c0, seg.in_ch))
        c0 += seg.in_ch
    return out


def _segment_product(p: torch.Tensor, seg: PackedSegment) -> torch.Tensor:
    """B4's plain product of one segment: int8_dense_pallas on the CPU
    (which is the plain version there), int8_matmul_plain elsewhere."""
    if p.device.type == "cpu":
        return int8_dense_pallas(p, seg.w_c, seg.scale_a, seg.scale_s,
                                 seg.const)
    return int8_matmul_plain(p, seg.w_c, seg.scale_a, seg.scale_s, seg.const)


def int8_conv2d_plain(x: torch.Tensor, packed: PackedWeight, *, stride=1,
                      padding: Union[str, int] = 0,
                      out_dtype=None) -> torch.Tensor:
    """int8_conv2d's function in plain PyTorch, on any device: quantize,
    pad, gather patches and B4's plain product per segment."""
    out_dtype = out_dtype or x.dtype
    if isinstance(stride, int):
        stride = (stride, stride)
    acc = None
    for seg, xseg in zip(packed.segments, _segments_of(x, packed, 1)):
        pads = nn.pad_amounts(padding, seg.kshape, stride, xseg.shape[2:])
        p = nn.patches(quantize_act(xseg, seg), seg.kshape, stride, pads,
                       value=seg.a_pad)
        b, ho, wo, k = p.shape
        y = _segment_product(p.reshape(-1, k), seg).reshape(b, ho, wo, -1)
        acc = y if acc is None else acc + y
    if packed.bias is not None:
        acc = acc + packed.bias
    return acc.to(out_dtype).permute(0, 3, 1, 2)


def int8_dense_plain(x: torch.Tensor, packed: PackedWeight,
                     out_dtype=None) -> torch.Tensor:
    """int8_dense's function in plain PyTorch, on any device."""
    out_dtype = out_dtype or x.dtype
    acc = None
    for seg, xseg in zip(packed.segments, _segments_of(x, packed, -1)):
        x_c = quantize_act(xseg, seg)
        lead = x_c.shape[:-1]
        y = _segment_product(x_c.reshape(-1, x_c.shape[-1]), seg)
        y = y.reshape(*lead, -1)
        acc = y if acc is None else acc + y
    if packed.bias is not None:
        acc = acc + packed.bias
    return acc.to(out_dtype)


def _kernel_segments(packed: PackedWeight) -> list:
    """The packed segments as B4's wrapper takes them."""
    out, c0 = [], 0
    for seg in packed.segments:
        spec = seg.a_spec
        if spec.symmetric:
            lo, hi, center = -spec.n_levels - 1, spec.n_levels, 0
        else:
            lo, hi = 0, spec.n_levels - 1
            center = 2 ** (spec.n_bits - 1)
        out.append({"c0": c0, "C": seg.in_ch, "w_t": seg.w_t,
                    "A": seg.scale_a, "Bc": seg.scale_s, "Cc": seg.const,
                    "delta": seg.a_delta, "zp": seg.a_zp, "lo": lo,
                    "hi": hi, "center": center, "a_pad": seg.a_pad})
        c0 += seg.in_ch
    return out


def int8_conv2d(x: torch.Tensor, packed: PackedWeight, *, stride=1,
                padding: Union[str, int] = 0,
                out_dtype=None) -> torch.Tensor:
    """Integer conv2d matching qconv2d's fake-quant semantics bit-exactly
    in integer space. x: NCHW (channels_last); result NCHW in out_dtype
    (default x's), channels_last. CPU tensor: the plain version; CUDA
    tensor: one call of kernel B4, which reads x in place (a layout with
    a channel stride other than 1 raises ValueError)."""
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, packed, stride=stride, padding=padding,
                                 out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if isinstance(stride, int):
        stride = (stride, stride)
    sb, sc, sh, sw = x.stride()
    if sc != 1:
        raise ValueError(f"int8_conv2d: x {tuple(x.shape)} with strides "
                         f"{x.stride()} is not channels_last (channel "
                         "stride 1)")
    kshape = packed.segments[0].kshape
    pads = nn.pad_amounts(padding, kshape, stride, x.shape[2:])
    geom = conv_geometry(x.shape, kshape, stride, pads)
    y = int8_conv(x, (sb, sh, sw), geom, _kernel_segments(packed),
                  packed.bias, out_dtype)
    return y.view(geom.B, geom.Ho, geom.Wo, -1).permute(0, 3, 1, 2)


def int8_dense(x: torch.Tensor, packed: PackedWeight,
               out_dtype=None) -> torch.Tensor:
    """Integer dense over the last axis, matching qdense's fake-quant
    semantics (int8.py:300-333). CPU tensor: the plain version; CUDA
    tensor: one call of kernel B4 over x's rows in place (rows that
    cannot be viewed with one stride raise ValueError)."""
    if x.device.type == "cpu":
        return int8_dense_plain(x, packed, out_dtype)
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    try:
        x2 = x.view(-1, k)
    except RuntimeError as e:
        raise ValueError(f"int8_dense: x {tuple(x.shape)} with strides "
                         f"{x.stride()} has no (rows, {k}) view") from e
    if x2.stride(1) != 1:
        raise ValueError(f"int8_dense: x {tuple(x.shape)} with strides "
                         f"{x.stride()} has a channel stride other than 1")
    y = int8_conv(x2, (x2.stride(0), 0, 0), dense_geometry(x2.shape[0]),
                  _kernel_segments(packed), packed.bias, out_dtype)
    return y.view(*x.shape[:-1], -1)


def _quantize_dynamic(x: torch.Tensor, st: dict, spec: AffineQuantizerSpec):
    """Activation -> (recentred int8, cx) from a calibrated state dict."""
    n_levels = spec.n_levels
    x_int = torch.round(x.float() / st["delta"]) + st["zero_point"]
    if spec.symmetric:
        x_q = torch.clamp(x_int, -n_levels - 1, n_levels)
        center = 0.0
    else:
        x_q = torch.clamp(x_int, 0, n_levels - 1)
        center = float(2 ** (spec.n_bits - 1))
    cx = center - torch.as_tensor(st["zero_point"]).float()
    return (x_q - center).to(torch.int8), cx


def _int_einsum(eq: str, a_c: torch.Tensor, b_c: torch.Tensor,
                a_lbl: str, b_lbl: str, contracted: list,
                k_elems: int) -> torch.Tensor:
    """einsum of two int8 tensors, exact, as f32 (the int32 result
    rounded to f32 once, as the JAX package's astype(float32))."""
    if k_elems <= _EXACT_F32_K:
        return torch.einsum(eq, a_c.float(), b_c.float())
    if len(contracted) != 1:
        raise ValueError(f"int8_einsum: {eq} contracts {contracted}; a "
                         f"contraction over {k_elems} > {_EXACT_F32_K} "
                         "elements is split along a single label")
    ia, ib = a_lbl.index(contracted[0]), b_lbl.index(contracted[0])
    y = None
    for k0 in range(0, k_elems, _EXACT_F32_K):
        n = min(_EXACT_F32_K, k_elems - k0)
        part = torch.einsum(eq, a_c.narrow(ia, k0, n).float(),
                            b_c.narrow(ib, k0, n).float()).double()
        y = part if y is None else y + part
    return y.float()


def int8_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, a_st: dict,
                b_st: dict, a_spec: AffineQuantizerSpec,
                b_spec: AffineQuantizerSpec, out_dtype=None) -> torch.Tensor:
    """Integer einsum between two dynamically quantized activations,
    consistent with fake_quant(a) . fake_quant(b) (int8.py:234-285): the
    attention products of the int8 engine. Over the contracted labels,

        y = a_c.b_c + ca*S(b_c) + cb*S(a_c) + ca*cb*K

    with S the sum over the contracted axes, broadcast into the output
    (per-tensor quantizers: ca, cb are scalars). Both grids must fit int8
    (n_bits <= 8)."""
    if a_spec.n_bits > 8 or b_spec.n_bits > 8:
        raise ValueError("int8_einsum: both operand grids must fit int8")
    out_dtype = out_dtype or a.dtype
    lhs, out_lbl = eq.split("->")
    a_lbl, b_lbl = lhs.split(",")
    contracted = [c for c in a_lbl if c in b_lbl and c not in out_lbl]
    k_elems = 1
    for c in contracted:
        k_elems *= a.shape[a_lbl.index(c)]

    a_c, ca = _quantize_dynamic(a, a_st, a_spec)
    b_c, cb = _quantize_dynamic(b, b_st, b_spec)
    y = _int_einsum(eq, a_c, b_c, a_lbl, b_lbl, contracted, k_elems)

    def reduced_to_out(x_c, lbl):
        """x_c summed over its contracted axes, expanded to the output
        rank."""
        axes = tuple(i for i, c in enumerate(lbl) if c in contracted)
        s = x_c.float().sum(dim=axes)
        kept = [c for c in lbl if c not in contracted]
        for i, c in enumerate(out_lbl):
            if c not in kept:
                s = s.unsqueeze(i)
                kept.insert(i, c)
        if kept != list(out_lbl):
            s = torch.einsum(f"{''.join(kept)}->{out_lbl}", s)
        return s

    y = (y + ca * reduced_to_out(b_c, b_lbl) + cb * reduced_to_out(a_c, a_lbl)
         + ca * cb * float(k_elems))
    scale = (torch.as_tensor(a_st["delta"]).float()
             * torch.as_tensor(b_st["delta"]).float())
    return (y * scale).to(out_dtype)
