"""Quantized conv / dense layers (port of qdiffusion_tpu/ops/qlayers.py).

Sim path: fake-quant the input activation and/or the weight, then run the
op (reference QuantModule, qdiff/quant_layer.py:203-294). Split shortcut:
the two concatenated halves of the input channels, and the matching
weight column blocks, get independent quantizers (slots 'w'/'a' for the
first half, 'w0'/'a0' for the second) before one fused conv.

Engine dispatch (JAX qlayers.py:211-287): on the int8 engine a packed
site runs ops/int8.py (kernel B4 on the card); on the stream engine a
packed dense layer, k=1 conv1d and, where the byte cost model says so,
conv2d run the streaming kernels (B5 for int8 weights, B6 for nibble-
packed weights of 4 bits or fewer). Every other site runs the plain op
on the module's weights, which on the stream engine are the folded ones.

Layouts: activations NCHW (split on axis 1) or tokens (B, T, C) (split
on the last axis); conv weights OIHW, conv1d weights (out, in, 1) and
dense weights (out, in), all with input channels on axis 1 (IN_AXIS; the
JAX package's HWIO, LIO and (in, out) weights keep them on 2, 1 and 0).
Stream packs hold 2-D (K, N) weights in the JAX layout (deploy.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from qdiffusion_torch import nn
from qdiffusion_torch.ops.int4_matmul import int4_dense_stream
from qdiffusion_torch.ops.int8_matmul import int8_dense_stream
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx

IN_AXIS = 1


@dataclasses.dataclass(frozen=True)
class LayerQuantConfig:
    """Static per-layer quantization config."""

    wq: AffineQuantizerSpec
    aq: AffineQuantizerSpec
    split: int = 0  # input-channel split point; 0 = no split


def _quant_input(ctx: QuantCtx, name: str, x: torch.Tensor,
                 cfg: LayerQuantConfig, axis: int = 1) -> torch.Tensor:
    if cfg.split:
        x0 = ctx.act_quant(name, "a", x.narrow(axis, 0, cfg.split), cfg.aq)
        x1 = ctx.act_quant(name, "a0", x.narrow(
            axis, cfg.split, x.shape[axis] - cfg.split), cfg.aq)
        return torch.cat([x0, x1], dim=axis)
    return ctx.act_quant(name, "a", x, cfg.aq)


def split_weight(w: torch.Tensor, split: int):
    """Split a weight into its two input-channel column blocks."""
    return w.narrow(IN_AXIS, 0, split), w.narrow(IN_AXIS, split,
                                                 w.shape[IN_AXIS] - split)


def _quant_weight(ctx: QuantCtx, name: str, w: torch.Tensor,
                  cfg: LayerQuantConfig) -> torch.Tensor:
    if cfg.split:
        w_a, w_b = split_weight(w, cfg.split)
        return torch.cat([ctx.weight_quant(name, "w", w_a, cfg.wq),
                          ctx.weight_quant(name, "w0", w_b, cfg.wq)],
                         dim=IN_AXIS)
    return ctx.weight_quant(name, "w", w, cfg.wq)


# -- stream engine -----------------------------------------------------------

def _stream_dequant(packed: dict, dtype) -> torch.Tensor:
    """The (K, N) dequantized weight of an int8 stream pack in `dtype`,
    segments stacked along K (JAX qlayers.py:70-87): the dense layers of
    5 to 8 bits. Nibble packs never come here (_stream_dense_int4)."""
    parts = [seg["w_c"].to(dtype) * seg["scale"].to(dtype)
             + seg["shift"].to(dtype) for seg in packed["segs"]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _odd_k_pad(seg: dict, flat: torch.Tensor) -> torch.Tensor:
    """Zero column for a segment whose odd K the int4 pack padded."""
    k_packed = 2 * seg["wp"].shape[0]
    if k_packed != flat.shape[-1]:
        flat = F.pad(flat, (0, k_packed - flat.shape[-1]))
    return flat


def _stream_dense_int4(packed: dict, x: torch.Tensor,
                       split: int) -> torch.Tensor:
    """Dense layer with nibble-packed weights through B6, one launch per
    split segment (independent quantizer grids per half); the bias rides
    in the first launch's epilogue (JAX qlayers.py:90-115)."""
    segs = packed["segs"]
    bounds = [(0, x.shape[-1])] if len(segs) == 1 else \
        [(0, split), (split, x.shape[-1])]
    y = None
    for seg, (lo, hi) in zip(segs, bounds):
        xs = _odd_k_pad(seg, x[..., lo:hi])
        part = int4_dense_stream(
            xs, seg["wp"], seg["scale4"], seg["off4"],
            bias=packed["bias"] if y is None else None, out_dtype=x.dtype)
        y = part if y is None else y + part
    return y


def _stream_seg_matmul(seg: dict, flat: torch.Tensor, bias) -> torch.Tensor:
    """(M, K) rows x one packed weight segment -> (M, N): kernel B6 for a
    nibble pack, B5 for int8 weights (JAX qlayers.py:118-134)."""
    if "wp" in seg:
        return int4_dense_stream(_odd_k_pad(seg, flat), seg["wp"],
                                 seg["scale4"], seg["off4"], bias=bias,
                                 out_dtype=flat.dtype)
    return int8_dense_stream(flat, seg["w_c"], seg["scale"], seg["shift"],
                             bias=bias, out_dtype=flat.dtype)


#: Fixed cost, in device-memory bytes, charged per streamed conv (kernel
#: dispatch and grid overheads). The JAX package's constant, calibrated on
#: a TPU; kept so that the port streams the same sites.
_STREAM_CONV_OVERHEAD_BYTES = 1 << 20


def _stream_conv_profitable(packed: dict, x: torch.Tensor, *,
                            stride) -> bool:
    """The JAX package's byte cost model for conv weight streaming
    (qlayers.py:143-173): stream where the weight bytes saved (bf16 ->
    int8/int4 resident weights) exceed the bf16 patch write and read plus
    a fixed overhead. x: NCHW."""
    kh, kw = packed["kshape"]
    k_total = n_out = 0
    w_int_bytes = 0
    for seg in packed["segs"]:
        if "wp" in seg:  # nibble pack: K/2 bytes per column
            k_seg = 2 * seg["wp"].shape[0]
            n_out = seg["wp"].shape[1]
            w_int_bytes += seg["wp"].numel()
        else:
            k_seg, n_out = seg["w_c"].shape
            w_int_bytes += seg["w_c"].numel()
        k_total += k_seg
    w_bf16_bytes = 2 * k_total * n_out
    if isinstance(stride, int):
        stride = (stride, stride)
    b, h, w_sp = x.shape[0], x.shape[2], x.shape[3]
    m = b * -(-h // stride[0]) * -(-w_sp // stride[1])
    patch_bytes = 0 if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) \
        else 4 * m * k_total  # bf16 patch write + read
    return (w_bf16_bytes - w_int_bytes
            > patch_bytes + _STREAM_CONV_OVERHEAD_BYTES)


def _stream_conv2d(packed: dict, x: torch.Tensor, *, stride=1,
                   padding=0) -> torch.Tensor:
    """Conv2d with int8/int4 weights resident in device memory: patches
    gathered in torch, then the streaming kernel per segment with the
    dequant in its weight staging (JAX qlayers.py:176-208). x: NCHW."""
    if isinstance(stride, int):
        stride = (stride, stride)
    kshape = packed["kshape"]
    c0, y = 0, None
    for seg, ci in zip(packed["segs"], packed["in_chs"]):
        xs = x[:, c0:c0 + ci]
        c0 += ci
        if kshape == (1, 1) and stride == (1, 1):
            p = xs.permute(0, 2, 3, 1)  # 1x1 stride 1: the input itself
        else:
            p = nn.patches(xs, kshape, stride,
                           nn.pad_amounts(padding, kshape, stride,
                                          xs.shape[2:]))
        b, ho, wo, k = p.shape
        part = _stream_seg_matmul(seg, p.reshape(-1, k),
                                  packed["bias"] if y is None else None)
        part = part.reshape(b, ho, wo, -1)
        y = part if y is None else y + part
    return y.permute(0, 3, 1, 2)


def _stream_tokens(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """k=1 conv1d over tokens (B, T, C) as a dense over channels through
    the streaming kernels, one launch per segment (JAX qlayers.py:238-252)."""
    c0, y = 0, None
    for seg, ci in zip(packed["segs"], packed["in_chs"]):
        xs = x[..., c0:c0 + ci]
        c0 += ci
        lead = xs.shape[:-1]
        part = _stream_seg_matmul(seg, xs.reshape(-1, ci),
                                  packed["bias"] if y is None else None)
        part = part.reshape(*lead, -1)
        y = part if y is None else y + part
    return y


# -- layers ------------------------------------------------------------------

def qconv2d(ctx: QuantCtx, name: str, layer: torch.nn.Conv2d,
            x: torch.Tensor, cfg: LayerQuantConfig, *, stride: int = 1,
            padding: int = 0) -> torch.Tensor:
    if ctx.engine == "int8" and name in ctx.packed:
        from qdiffusion_torch.ops.int8 import int8_conv2d

        return int8_conv2d(x, ctx.packed[name], stride=stride,
                           padding=padding)
    if ctx.engine == "stream" and name in ctx.packed:
        pk = ctx.packed[name]
        if "kshape" in pk and (ctx.conv_stream == "all"
                               or _stream_conv_profitable(pk, x,
                                                          stride=stride)):
            return _stream_conv2d(pk, x, stride=stride, padding=padding)
        # the cost model says fold: the module holds the folded weights on
        # the stream engine (deploy.make_quantized_step), so the plain conv
        # below is the folded path
    x = _quant_input(ctx, name, x, cfg)
    w = _quant_weight(ctx, name, layer.weight, cfg)
    return nn.conv2d(x, w, layer.bias, stride=stride, padding=padding)


def qconv1d(ctx: QuantCtx, name: str, layer, x: torch.Tensor,
            cfg: LayerQuantConfig) -> torch.Tensor:
    """Kernel-size-1 conv1d over tokens (B, T, C) with an (out, in, 1)
    weight: the legacy AttentionBlock's qkv / proj_out (the JAX package
    runs it as an NWC conv; k=1 makes it a dense over channels). On the
    stream engine a packed site streams (convs are packed only with
    stream_convs)."""
    if ctx.engine == "stream" and name in ctx.packed:
        return _stream_tokens(ctx.packed[name], x)
    x = _quant_input(ctx, name, x, cfg, axis=-1)
    w = _quant_weight(ctx, name, layer.weight, cfg)
    return nn.dense(x, w[..., 0], layer.bias)


def qdense(ctx: QuantCtx, name: str, layer: torch.nn.Linear, x: torch.Tensor,
           cfg: LayerQuantConfig) -> torch.Tensor:
    if ctx.engine == "int8" and name in ctx.packed:
        from qdiffusion_torch.ops.int8 import int8_dense

        return int8_dense(x, ctx.packed[name])
    if ctx.engine == "stream" and name in ctx.packed:
        pk = ctx.packed[name]
        if any("wp" in seg for seg in pk["segs"]):
            return _stream_dense_int4(pk, x, cfg.split)
        return nn.dense(x, _stream_dequant(pk, x.dtype).t(), pk["bias"])
    x = _quant_input(ctx, name, x, cfg, axis=-1)
    w = _quant_weight(ctx, name, layer.weight, cfg)
    return nn.dense(x, w, layer.bias)
