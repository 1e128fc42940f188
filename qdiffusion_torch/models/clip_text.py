"""CLIP text encoder, ViT-L/14 text tower (port of
qdiffusion_tpu/models/clip_text.py::CLIPTextEncoder.apply; the HF
CLIPTextModel used by the reference FrozenCLIPEmbedder,
ldm/modules/encoders/modules.py:137-162).

Token + position embeddings, a pre-LN transformer with a causal mask and
quick-GELU MLPs, a final LayerNorm; returns last_hidden_state (B, L, D),
the cross-attention context of SD. Parameters sit at the JAX tree's paths
(token_embedding.weight (V, D), layers.{i}.self_attn.q_proj, ...), so a
JAX `save_nested` npz loads strictly after utils/checkpoints.py's layout
move. Token ids come from the caller; the BPE tokenizer is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from qdiffusion_torch import nn
from qdiffusion_torch.device import resolve_device
from qdiffusion_torch.models.base import Params, put, seeded_params


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPTextEncoder(torch.nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(), *,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg = config
        D, F = cfg.hidden_size, cfg.intermediate_size
        with resolve_device(device):
            put(self, "token_embedding", Params(cfg.vocab_size, D,
                                                bias=False))
            put(self, "position_embedding", Params(cfg.max_positions, D,
                                                   bias=False))
            self.layers = torch.nn.ModuleList()
            for i in range(cfg.num_layers):
                p = f"layers.{i}"
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    put(self, f"{p}.self_attn.{proj}", Params(D, D))
                put(self, f"{p}.layer_norm1", Params(D))
                put(self, f"{p}.layer_norm2", Params(D))
                put(self, f"{p}.mlp.fc1", Params(F, D))
                put(self, f"{p}.mlp.fc2", Params(D, F))
            put(self, "final_layer_norm", Params(D))

    def _ln(self, m, x):
        return nn.layer_norm(x, m.weight, m.bias, eps=self.cfg.layer_norm_eps)

    def _attention(self, m, h: torch.Tensor, mask: torch.Tensor):
        B, L, D = h.shape
        nh = self.cfg.num_heads
        dh = D // nh
        q, k, v = (nn.dense(h, p.weight, p.bias).reshape(B, L, nh, dh)
                   for p in (m.q_proj, m.k_proj, m.v_proj))
        w = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) \
            * (dh ** -0.5)
        w = torch.softmax(w + mask, dim=-1)
        o = torch.einsum("bhij,bjhd->bihd", w, v.float()).to(h.dtype)
        return nn.dense(o.reshape(B, L, D), m.out_proj.weight,
                        m.out_proj.bias)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, L) integer ids -> last_hidden_state (B, L, D)."""
        B, L = input_ids.shape
        h = self.token_embedding.weight[input_ids] \
            + self.position_embedding.weight[None, :L]
        mask = torch.full((L, L), -torch.inf, device=h.device).triu(1)
        for layer in self.layers:
            h = h + self._attention(layer.self_attn,
                                    self._ln(layer.layer_norm1, h), mask)
            hm = self._ln(layer.layer_norm2, h)
            hm = quick_gelu(nn.dense(hm, layer.mlp.fc1.weight,
                                     layer.mlp.fc1.bias))
            h = h + nn.dense(hm, layer.mlp.fc2.weight, layer.mlp.fc2.bias)
        return self._ln(self.final_layer_norm, h)

    def init_params(self, seed: int = 0) -> dict:
        """A seeded random state_dict (models/base.py::seeded_params)."""
        return seeded_params(self, seed)
