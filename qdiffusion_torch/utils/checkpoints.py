"""Readers and writers for the JAX package's npz artifacts (port of the
npz half of qdiffusion_tpu/utils/checkpoints.py).

Files keep the JAX package's formats and layouts, so both packages read
each other's files: qstate npz ('/'-joined site/slot/leaf keys, bfloat16
leaves as uint16 under a '#bf16' key suffix), nested npz, and the CLI's
`save_pytree` params npz. Layout conversion happens at load and save.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from qdiffusion_torch.convert import qstate_from_jax, qstate_to_jax

_BF16 = "#bf16"


def save_qstate(path, qstate: dict) -> None:
    """torch-layout qstate -> JAX-layout npz."""
    flat = {}
    for site, slots in qstate_to_jax(qstate).items():
        for slot, st in slots.items():
            for leaf, t in st.items():
                key = f"{site}/{slot}/{leaf}"
                t = t.detach().cpu()
                if t.dtype == torch.bfloat16:
                    key, arr = key + _BF16, t.view(torch.int16).numpy().view(
                        np.uint16)
                else:
                    arr = t.numpy()
                flat[key] = arr
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_qstate(path, device="cpu") -> dict:
    """JAX-layout qstate npz -> torch-layout qstate on `device`."""
    qstate: dict = {}
    with np.load(Path(path), allow_pickle=False) as data:
        for key in data.files:
            arr = data[key]
            if key.endswith(_BF16):
                key = key[: -len(_BF16)]
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            site, slot, leaf = key.rsplit("/", 2)
            qstate.setdefault(site, {}).setdefault(slot, {})[leaf] = t
    return {site: {slot: {k: v.to(device) for k, v in st.items()}
                   for slot, st in slots.items()}
            for site, slots in qstate_from_jax(qstate).items()}


def save_nested(path, tree: dict) -> None:
    """Nested dict of arrays -> npz with '/'-joined keys."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_nested(path) -> dict:
    tree: dict = {}
    with np.load(Path(path), allow_pickle=False) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def _flatten_sorted(tree: dict, prefix=()):
    """(path, leaf) pairs in jax.tree_util's dict order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten_sorted(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_pytree(path, like: dict) -> dict:
    """Read a `save_pytree` npz (leaves stored as '0', '1', ... in
    jax.tree_util flatten order) into the structure of `like`, a nested
    dict of arrays in the JAX layout; every leaf's shape must match."""
    out: dict = {}
    with np.load(Path(path), allow_pickle=False) as data:
        leaves = list(_flatten_sorted(like))
        n_file = sum(1 for k in data.files if k.isdigit())
        if n_file != len(leaves):
            raise ValueError(f"{path}: {n_file} leaves, the model has "
                             f"{len(leaves)}")
        for i, (keys, ref) in enumerate(leaves):
            arr = data[str(i)]
            if arr.shape != np.shape(ref):
                raise ValueError(f"{path}: leaf {i} ({'.'.join(keys)}) has "
                                 f"shape {arr.shape}, expected "
                                 f"{np.shape(ref)}")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
    return out


def save_pytree(path, tree: dict) -> None:
    """Nested dict of arrays -> the JAX CLI's `save_pytree` npz (leaves
    '0', '1', ... in jax.tree_util flatten order)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{str(i): np.asarray(leaf) for i, (_, leaf)
                      in enumerate(_flatten_sorted(tree))})
