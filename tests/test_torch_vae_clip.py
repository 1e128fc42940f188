"""VAE decode and CLIP text tower of the port against the JAX package,
on the CPU, f32.

  * KL and VQ `decode` of a tiny VAE whose param tree comes from the JAX
    `init_params` (so the port's module tree loads it strictly). The
    port's mid attention runs over 64 tokens with vae.FLASH_TOKENS set to
    16, so it takes the blockwise path (the B2 plain version at this shape); the
    JAX side materializes on its CPU. rtol = atol = 1e-4 (sum order).
  * a 2-layer CLIPTextEncoder: the port's seeded params go to JAX through
    to_jax_params (token and position tables keep their (rows, dim)
    layout). rtol = atol = 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.models.clip_text import CLIPTextConfig as JaxClipConfig
from qdiffusion_tpu.models.clip_text import CLIPTextEncoder as JaxClip
from qdiffusion_tpu.models.vae import VAE as JaxVAE
from qdiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig

from qdiffusion_torch.convert import from_jax_params, to_jax_params
from qdiffusion_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from qdiffusion_torch.models import vae as vae_mod
from qdiffusion_torch.models.vae import VAE, VAEConfig
from qdiffusion_torch.ops import flash_attention

torch.set_num_threads(1)

KL = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
          attn_resolutions=(), in_channels=3, resolution=16, z_channels=4,
          double_z=True, embed_dim=4)
VQ = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
          attn_resolutions=(8,), in_channels=3, resolution=16, z_channels=3,
          double_z=False, embed_dim=3, n_embed=16)
CLIP = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_positions=77)


def _jax_tree(jvae, seed):
    """The JAX init, with biases and norms made random too, as numpy."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jvae.init_params(jax.random.PRNGKey(seed)))

    def jitter(a):
        return a if a.ndim >= 2 else (a + 0.1 * rng.standard_normal(
            a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(jitter, tree)


@pytest.mark.parametrize("kind,cfg", [("kl", KL), ("vq", VQ)])
def test_vae_decode_matches_jax(monkeypatch, kind, cfg):
    jvae = JaxVAE(JaxVAEConfig(**cfg))
    params = _jax_tree(jvae, seed=3)
    monkeypatch.setattr(vae_mod, "FLASH_TOKENS", 16)
    vae = VAE(VAEConfig(**cfg), device="cpu")
    vae.load_state_dict(from_jax_params(params))  # strict: whole tree

    seen = []
    real = flash_attention.flash_attention_plain
    monkeypatch.setattr(flash_attention, "flash_attention_plain",
                        lambda *a, **kw: seen.append(a[0].shape)
                        or real(*a, **kw))
    z = np.random.default_rng(4).standard_normal(
        (2, 8, 8, cfg["z_channels"] if kind == "kl" else cfg["embed_dim"])
    ).astype(np.float32)
    want = np.asarray(jax.jit(jvae.decode)(params, jnp.asarray(z)))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    # the decoder's mid attention (64 tokens, one head of 64 channels);
    # the VQ model has two more at 8x8 in its lowest level
    assert seen == [(2, 64, 1, 64)] * (1 if kind == "kl" else 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vq_lookup_snaps_to_the_codebook():
    vae = VAE(VAEConfig(**VQ), device="cpu")
    vae.load_state_dict(vae.init_params(0))
    code = vae.quantize.embedding.weight
    z = code[torch.tensor([3, 7, 11, 0])].reshape(1, 2, 2, 3)
    snapped = vae.vq_lookup((z + 1e-3).permute(0, 3, 1, 2))
    torch.testing.assert_close(snapped.permute(0, 2, 3, 1), z, rtol=0,
                               atol=1e-6)


def test_clip_text_matches_jax():
    clip = CLIPTextEncoder(CLIPTextConfig(**CLIP), device="cpu")
    clip.load_state_dict(clip.init_params(5))
    params = to_jax_params(clip.state_dict())
    assert params["token_embedding"]["weight"].shape == (64, 32)
    assert set(from_jax_params(params)) == set(clip.state_dict())
    ids = np.random.default_rng(6).integers(0, 64, (2, 77)).astype(np.int32)
    want = np.asarray(jax.jit(JaxClip(JaxClipConfig(**CLIP)).apply)(
        params, jnp.asarray(ids)))
    with torch.no_grad():
        got = clip(torch.from_numpy(ids.astype(np.int64))).numpy()
    assert got.shape == (2, 77, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_clip_mask_is_causal():
    """A later token cannot change an earlier position's output."""
    clip = CLIPTextEncoder(CLIPTextConfig(**CLIP), device="cpu")
    clip.load_state_dict(clip.init_params(5))
    ids = torch.randint(0, 64, (1, 77), generator=torch.Generator()
                        .manual_seed(0))
    ids2 = ids.clone()
    ids2[0, 40:] = (ids2[0, 40:] + 1) % 64
    with torch.no_grad():
        a, b = clip(ids), clip(ids2)
    torch.testing.assert_close(a[0, :40], b[0, :40])
    assert not torch.allclose(a[0, 40:], b[0, 40:])
