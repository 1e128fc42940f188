"""Weight and qstate layout between the JAX package and the port.

JAX layout: nested param tree, conv HWIO, dense (in, out), norms
{scale, bias}; qstate weight leaves per output channel (1,1,1,O) /
(1,O) and weight-shaped AdaRound `alpha`. Torch layout: flat
state_dict, conv OIHW, linear (out, in), norms {weight, bias}; qstate
weight leaves (O,1,1,1) / (O,1) and alpha OIHW / (out, in). `from_jax_params` is the inverse of
qdiffusion_tpu/models/torch_import.py::state_dict_to_pytree.

Files on disk always hold the JAX layout (utils/checkpoints.py converts
at load and save).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params", "qstate_from_jax",
           "qstate_to_jax", "as_tensor"]

# JAX weight layout -> torch layout, by ndim; the inverse permutation
# takes it back.
_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}
_WEIGHT_SLOTS = ("w", "w0")


def as_tensor(a) -> torch.Tensor:
    """numpy array or tensor -> CPU tensor; an ml_dtypes bfloat16 array
    becomes a torch.bfloat16 tensor with the same bits."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _permute(a: torch.Tensor, to_torch: bool) -> torch.Tensor:
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
                sd[f"{prefix}.weight"] = _permute(t, to_torch=True)
            elif k == "b":
                sd[f"{prefix}.bias"] = t
            elif k == "scale":
                sd[f"{prefix}.weight"] = t
            else:  # norm bias, or a leaf with no layout
                sd[path] = t

    walk(params, "")
    return sd


def to_jax_params(state_dict: dict) -> dict:
    """torch state_dict -> JAX param tree of numpy arrays (f32)."""
    tree: dict = {}

    def assign(dotted, value):
        node = tree
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for k, v in state_dict.items():
        a = v.detach().float().cpu()
        base, _, leaf = k.rpartition(".")
        w = state_dict.get(f"{base}.weight")
        is_norm = w is not None and w.ndim == 1
        if leaf == "weight":
            assign(f"{base}.scale" if is_norm else f"{base}.w",
                   _permute(a, to_torch=False).numpy())
        elif leaf == "bias":
            assign(f"{base}.bias" if is_norm else f"{base}.b", a.numpy())
        else:
            assign(k, a.numpy())
    return tree


def _qstate_layout(qstate: dict, to_torch: bool) -> dict:
    out: dict = {}
    for site, slots in qstate.items():
        out[site] = {}
        for slot, st in slots.items():
            conv = slot in _WEIGHT_SLOTS
            out[site][slot] = {
                leaf: _permute(as_tensor(a), to_torch) if conv
                else as_tensor(a) for leaf, a in st.items()}
    return out


def qstate_from_jax(qstate: dict) -> dict:
    """JAX-layout qstate (numpy or tensor leaves) -> torch layout."""
    return _qstate_layout(qstate, to_torch=True)


def qstate_to_jax(qstate: dict) -> dict:
    """torch-layout qstate -> JAX layout (tensor leaves, dtypes kept)."""
    return _qstate_layout(qstate, to_torch=False)
