"""First-stage autoencoders, KL and VQ, decode path (port of
qdiffusion_tpu/models/vae.py; reference
ldm/modules/diffusionmodules/model.py:85-545 Decoder with temb-less
ResnetBlocks and single-head AttnBlocks, taming VectorQuantizer2 lookup).

`VAE` holds the whole parameter tree of the JAX package's `init_params`
(encoder included, so a JAX `save_nested` npz loads strictly), at the
torch state_dict paths (encoder.*, decoder.*, quant_conv,
post_quant_conv, quantize.embedding.weight). Only `decode` is ported;
the encoder's forward waits. The VAE runs in full precision of its dtype
and takes no QuantCtx, as in the reference.

A mid-block attention over at least FLASH_TOKENS tokens (SD 512^2:
4096 tokens, one head of D = 512) goes through
ops/attention.py::blockwise_attention, which at that shape picks the
streaming kernel B3 as the TPU package does; below it the (S, S) matrix
is materialized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from qdiffusion_torch import nn
from qdiffusion_torch.device import resolve_device
from qdiffusion_torch.models.base import Params, put, seeded_params
from qdiffusion_torch.ops.attention import blockwise_attention

# tokens at which the mid attention leaves the materializing path
# (the JAX package's _FLASH_TOKENS, vae.py:68)
FLASH_TOKENS = 1024


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    resolution: int = 256
    z_channels: int = 3
    double_z: bool = False
    embed_dim: int = 3
    n_embed: Optional[int] = None  # set -> VQ model; None -> KL model


class VAE(torch.nn.Module):
    """KL or VQ autoencoder; decode is the hot path of LDM sampling."""

    def __init__(self, config: VAEConfig, *, device="cuda"):
        super().__init__()
        self.cfg = config
        self.num_resolutions = len(config.ch_mult)
        self.attn_at = set(config.attn_resolutions)
        with resolve_device(device):
            self._build()
        self.to(memory_format=torch.channels_last)

    def _build(self):
        cfg = self.cfg
        n_res = self.num_resolutions
        in_mult = (1,) + tuple(cfg.ch_mult)

        def conv(path, ci, co, k=3):
            put(self, path, Params(co, ci, k, k))

        def resnet(path, ci, co):
            put(self, f"{path}.norm1", Params(ci))
            conv(f"{path}.conv1", ci, co)
            put(self, f"{path}.norm2", Params(co))
            conv(f"{path}.conv2", co, co)
            if ci != co:
                conv(f"{path}.nin_shortcut", ci, co, 1)

        def attn(path, c):
            put(self, f"{path}.norm", Params(c))
            for leaf in ("q", "k", "v", "proj_out"):
                conv(f"{path}.{leaf}", c, c, 1)

        conv("encoder.conv_in", cfg.in_channels, cfg.ch)
        curr_res = cfg.resolution
        for i in range(n_res):
            ci, co = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks):
                resnet(f"encoder.down.{i}.block.{j}", ci if j == 0 else co,
                       co)
                if curr_res in self.attn_at:
                    attn(f"encoder.down.{i}.attn.{j}", co)
            if i != n_res - 1:
                conv(f"encoder.down.{i}.downsample.conv", co, co)
                curr_res //= 2
        cm = cfg.ch * cfg.ch_mult[-1]
        for side in ("encoder", "decoder"):
            resnet(f"{side}.mid.block_1", cm, cm)
            attn(f"{side}.mid.attn_1", cm)
            resnet(f"{side}.mid.block_2", cm, cm)
        put(self, "encoder.norm_out", Params(cm))
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        conv("encoder.conv_out", cm, z_out)

        conv("decoder.conv_in", cfg.z_channels, cm)
        ci = cm
        curr_res = cfg.resolution // 2 ** (n_res - 1)
        for i in reversed(range(n_res)):
            co = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                resnet(f"decoder.up.{i}.block.{j}", ci if j == 0 else co, co)
                if curr_res in self.attn_at:
                    attn(f"decoder.up.{i}.attn.{j}", co)
            if i != 0:
                conv(f"decoder.up.{i}.upsample.conv", co, co)
                curr_res *= 2
            ci = co
        put(self, "decoder.norm_out", Params(ci))
        conv("decoder.conv_out", ci, cfg.out_ch)
        conv("quant_conv", z_out,
             2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim, 1)
        conv("post_quant_conv", cfg.embed_dim, cfg.z_channels, 1)
        if cfg.n_embed is not None:
            put(self, "quantize.embedding",
                Params(cfg.n_embed, cfg.embed_dim, bias=False))

    # -- blocks ------------------------------------------------------------

    @staticmethod
    def _conv(m, x, padding=1):
        return nn.conv2d(x, m.weight, m.bias, padding=padding)

    def _resnet(self, m, x):
        h = nn.group_norm_swish(x, m.norm1.weight, m.norm1.bias)
        h = self._conv(m.conv1, h)
        h = nn.group_norm_swish(h, m.norm2.weight, m.norm2.bias)
        h = self._conv(m.conv2, h)
        if hasattr(m, "nin_shortcut"):
            x = self._conv(m.nin_shortcut, x, padding=0)
        return x + h

    def _attn(self, m, x):
        b, c, hh, ww = x.shape
        h = nn.group_norm(x, m.norm.weight, m.norm.bias)
        q, k, v = (self._conv(p, h, padding=0).permute(0, 2, 3, 1).reshape(
            b, hh * ww, c) for p in (m.q, m.k, m.v))
        scale = int(c) ** -0.5
        if hh * ww >= FLASH_TOKENS:
            h = blockwise_attention(q[:, :, None], k[:, :, None],
                                    v[:, :, None], scale=scale)[:, :, 0]
            h = h.to(x.dtype)
        else:
            w = torch.einsum("bic,bjc->bij", q.float(), k.float()) * scale
            w = torch.softmax(w, dim=2)
            h = torch.einsum("bij,bjc->bic", w, v.float()).to(x.dtype)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + self._conv(m.proj_out, h, padding=0)

    # -- decoder -----------------------------------------------------------

    def vq_codes(self, z: torch.Tensor) -> torch.Tensor:
        """(B*H*W,) codebook indices of NCHW z's pixels: the nearest by
        |z|^2 - 2 z.e + |e|^2 in z's dtype, the JAX package's formula
        (vae.py:281-290), so a bf16 carrier computes it in bf16; a tie
        goes to the lowest index, as jnp.argmin's does."""
        emb = self.quantize.embedding.weight  # (n_embed, e_dim)
        flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])
        d = ((flat ** 2).sum(dim=1, keepdim=True) - 2.0 * flat @ emb.T
             + (emb ** 2).sum(dim=1)[None, :])
        return d.argmin(dim=1)

    def vq_lookup(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest-codebook snap of NCHW z (taming VectorQuantizer2)."""
        b, c, h, w = z.shape
        quant = self.quantize.embedding.weight[self.vq_codes(z)].reshape(
            b, h, w, c).permute(0, 3, 1, 2)
        return z + (quant - z)

    def decode(self, z: torch.Tensor,
               force_not_quantize: bool = False) -> torch.Tensor:
        """z: NHWC latents -> NHWC image. A VQ model first snaps the
        latent to its codebook (autoencoder.py:274-283)."""
        cfg = self.cfg
        z = z.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if cfg.n_embed is not None and not force_not_quantize:
            z = self.vq_lookup(z)
        z = self._conv(self.post_quant_conv, z, padding=0)
        d = self.decoder
        h = self._conv(d.conv_in, z)
        h = self._resnet(d.mid.block_1, h)
        h = self._attn(d.mid.attn_1, h)
        h = self._resnet(d.mid.block_2, h)
        curr_res = cfg.resolution // 2 ** (self.num_resolutions - 1)
        for i_level in reversed(range(self.num_resolutions)):
            lvl = d.up.get_submodule(str(i_level))
            for i_block in range(cfg.num_res_blocks + 1):
                h = self._resnet(lvl.block.get_submodule(str(i_block)), h)
                if curr_res in self.attn_at:
                    h = self._attn(lvl.attn.get_submodule(str(i_block)), h)
            if i_level != 0:
                h = self._conv(lvl.upsample.conv, nn.upsample_nearest_2x(h))
                curr_res *= 2
        h = nn.group_norm_swish(h, d.norm_out.weight, d.norm_out.bias)
        return self._conv(d.conv_out, h).permute(0, 2, 3, 1)

    def init_params(self, seed: int = 0) -> dict:
        """A seeded random state_dict (models/base.py::seeded_params)."""
        return seeded_params(self, seed)
