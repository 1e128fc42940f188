"""Weight and qstate layout between the JAX package and the port.

JAX layout: nested param tree, conv HWIO, conv1d LIO, dense (in, out),
norms {scale, bias}; qstate weight leaves per output channel (1,1,1,O) /
(1,1,O) / (1,O) and weight-shaped AdaRound `alpha`. Torch layout: flat
state_dict, conv OIHW, conv1d (O, I, 1), linear (out, in), norms
{weight, bias}; qstate weight leaves (O,1,1,1) / (O,1,1) / (O,1) and
alpha in the weight's layout. Lookup tables (the CLIP token and position
embeddings, the VQ codebook) are (rows, dim) in both and keep the JAX
key `weight`. `from_jax_params` is the inverse of
qdiffusion_tpu/models/torch_import.py::state_dict_to_pytree.

Files on disk always hold the JAX layout (utils/checkpoints.py converts
at load and save).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params", "jax_param_shapes",
           "qstate_from_jax", "qstate_to_jax", "as_tensor"]

# JAX weight layout -> torch layout, by ndim; the inverse permutation
# takes it back.
_TO_TORCH = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
_WEIGHT_SLOTS = ("w", "w0")
# torch parameters that are lookup tables: same layout and key in JAX
_TABLES = ("token_embedding.weight", "position_embedding.weight",
           "quantize.embedding.weight")


def as_tensor(a) -> torch.Tensor:
    """numpy array or tensor -> CPU tensor; an ml_dtypes bfloat16 array
    becomes a torch.bfloat16 tensor with the same bits."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def permute_layout(a: torch.Tensor, to_torch: bool) -> torch.Tensor:
    """A weight-shaped tensor from the JAX layout (HWIO, LIO, (in, out))
    to torch's (to_torch) or back; other ranks pass through."""
    perm = _TO_TORCH.get(a.ndim)
    if perm is None:
        return a
    if not to_torch:
        perm = tuple(int(i) for i in np.argsort(perm))
    return a.permute(*perm).contiguous()


def from_jax_params(params: dict) -> dict:
    """JAX param tree (numpy leaves) -> torch state_dict (CPU tensors)."""
    sd = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            t = as_tensor(v)
            if k == "w":
                sd[f"{prefix}.weight"] = permute_layout(t, to_torch=True)
            elif k == "b":
                sd[f"{prefix}.bias"] = t
            elif k == "scale":
                sd[f"{prefix}.weight"] = t
            else:  # norm bias, or a leaf with no layout
                sd[path] = t

    walk(params, "")
    return sd


def _jax_key(k: str, state_dict: dict):
    """(JAX dotted key, whether the value permutes) of a state_dict key."""
    base, _, leaf = k.rpartition(".")
    w = state_dict.get(f"{base}.weight")
    is_norm = w is not None and w.ndim == 1
    if k.endswith(_TABLES):
        return k, False
    if leaf == "weight":
        return (f"{base}.scale", False) if is_norm else (f"{base}.w", True)
    if leaf == "bias":
        return f"{base}.bias" if is_norm else f"{base}.b", False
    return k, False


def assign_dotted(tree: dict, dotted: str, value):
    """tree[a][b][c] = value for dotted 'a.b.c', making the dicts."""
    node = tree
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def jax_param_shapes(state_dict: dict) -> dict:
    """The JAX param tree's structure with zero-copy placeholder leaves of
    the JAX shapes (for utils/checkpoints.py::load_pytree); no weight is
    copied."""
    tree: dict = {}
    for k, v in state_dict.items():
        key, perm = _jax_key(k, state_dict)
        shape = tuple(v.shape)
        if perm and v.ndim in _TO_TORCH:
            inv = np.argsort(_TO_TORCH[v.ndim])
            shape = tuple(shape[i] for i in inv)
        assign_dotted(tree, key, np.broadcast_to(np.float32(0), shape))
    return tree


def to_jax_params(state_dict: dict) -> dict:
    """torch state_dict -> JAX param tree of numpy arrays (f32)."""
    tree: dict = {}
    for k, v in state_dict.items():
        key, perm = _jax_key(k, state_dict)
        a = v.detach().float().cpu()
        assign_dotted(tree, key, (permute_layout(a, to_torch=False)
                                  if perm else a).numpy())
    return tree


def _qstate_layout(qstate: dict, to_torch: bool) -> dict:
    out: dict = {}
    for site, slots in qstate.items():
        out[site] = {}
        for slot, st in slots.items():
            conv = slot in _WEIGHT_SLOTS
            out[site][slot] = {
                leaf: permute_layout(as_tensor(a), to_torch) if conv
                else as_tensor(a) for leaf, a in st.items()}
    return out


def qstate_from_jax(qstate: dict) -> dict:
    """JAX-layout qstate (numpy or tensor leaves) -> torch layout."""
    return _qstate_layout(qstate, to_torch=True)


def qstate_to_jax(qstate: dict) -> dict:
    """torch-layout qstate -> JAX layout (tensor leaves, dtypes kept)."""
    return _qstate_layout(qstate, to_torch=False)
