"""Readers and writers for the JAX package's npz artifacts (port of the
npz half of qdiffusion_tpu/utils/checkpoints.py) and the resumable
calibration's snapshots (`CalibCheckpointer`).

Files keep the JAX package's formats and layouts, so both packages read
each other's files: qstate npz ('/'-joined site/slot/leaf keys, bfloat16
leaves as uint16 under a '#bf16' key suffix), nested npz, the CLI's
`save_pytree` params npz, and a calibration run directory. Layout
conversion happens at load and save.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from qdiffusion_torch.convert import qstate_from_jax, qstate_to_jax

logger = logging.getLogger(__name__)

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


def flatten_sorted(tree: dict, prefix=()):
    """(path, leaf) pairs in jax.tree_util's dict order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten_sorted(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_pytree(path, like: dict) -> dict:
    """Read a `save_pytree` npz (leaves stored as '0', '1', ... in
    jax.tree_util flatten order) into the structure of `like`, a nested
    dict of arrays in the JAX layout; every leaf's shape must match."""
    out: dict = {}
    with np.load(Path(path), allow_pickle=False) as data:
        leaves = list(flatten_sorted(like))
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
                      in enumerate(flatten_sorted(tree))})


class CalibCheckpointer:
    """Snapshots of a calibration's qstate in a run directory, so that a
    crashed run resumes where it stopped (JAX checkpoints.py:204-310;
    reference mid-calibration temp ckpts, txt2img.py:422-428).

    The files are the JAX package's: one full base `qstate_wip.npz`,
    written by the engine before each phase's unit loop; increments
    `qstate_inc_NNNN.npz` holding the sites reconstructed since the save
    before; `calib_progress.json` {phase, unit_idx, n_inc}; and
    `qstate.npz` once the run is done. A directory written by either
    package resumes in the other. `load` replays the base and then the
    increments in order (a site of an increment replaces the site)."""

    def __init__(self, run_dir):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.marker = self.dir / "calib_progress.json"
        self._n_inc: Optional[int] = None  # None: no base written or loaded

    @property
    def has_base(self) -> bool:
        return self._n_inc is not None

    def _inc_path(self, i: int) -> Path:
        return self.dir / f"qstate_inc_{i:04d}.npz"

    def load(self, device="cpu") -> Tuple[Optional[dict], Optional[dict]]:
        """(qstate on `device`, progress), or (None, None) without a
        marker."""
        if not self.marker.exists():
            return None, None
        progress = json.loads(self.marker.read_text())
        qstate = load_qstate(self.dir / "qstate_wip.npz", device)
        n_inc = int(progress.get("n_inc", 0))
        for i in range(n_inc):
            qstate.update(load_qstate(self._inc_path(i), device))
        self._n_inc = n_inc
        logger.info("resuming calibration from %s", progress)
        return qstate, progress

    def save(self, qstate: dict, phase: str, unit_idx: int,
             sites=None) -> bool:
        """Snapshot after unit `unit_idx` of `phase`. `sites`: the sites
        changed since the save before; None (or no base yet) writes a
        full base. The order is crash-safe: the base, then the marker
        (n_inc 0), then the old increments go, so a marker never points
        at a deleted file.

        Returns False, having written no file, when pulling the qstate
        off the card runs out of device memory (save_qstate copies every
        leaf before it writes): a snapshot must not end the run it
        protects, and the engine retries it at the next group boundary,
        when the capture buffers are free."""
        try:
            if self._n_inc is None or sites is None:
                save_qstate(self.dir / "qstate_wip.npz", qstate)
                self._n_inc = 0
                self.marker.write_text(json.dumps(
                    {"phase": phase, "unit_idx": unit_idx, "n_inc": 0}))
                for p in self.dir.glob("qstate_inc_*.npz"):
                    p.unlink()
            else:
                save_qstate(self._inc_path(self._n_inc),
                            {s: qstate[s] for s in sites if s in qstate})
                self._n_inc += 1
                self.marker.write_text(json.dumps(
                    {"phase": phase, "unit_idx": unit_idx,
                     "n_inc": self._n_inc}))
        except torch.cuda.OutOfMemoryError:
            logger.warning("qstate snapshot at %s unit %d deferred: the "
                           "device ran out of memory; retried at the next "
                           "group boundary", phase, unit_idx)
            return False
        return True

    def finalize(self, qstate: dict) -> None:
        """Write qstate.npz, then remove the marker and the increments."""
        save_qstate(self.dir / "qstate.npz", qstate)
        if self.marker.exists():
            self.marker.unlink()
        for p in self.dir.glob("qstate_inc_*.npz"):
            p.unlink()
