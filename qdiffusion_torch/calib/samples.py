"""Timestep-aware calibration sample selection (port of
qdiffusion_tpu/calib/samples.py; reference get_train_samples,
qdiff/utils.py:325-348): a saved sampling trajectory sliced at `cali_st`
evenly spaced steps, `cali_n` samples at each.

The conditional branch (cond and uncond contexts back to back) comes
with the latent models' calibration, ROADMAP A4c.
"""

from __future__ import annotations

import torch


def get_train_samples(trajectory: dict, cali_n: int, cali_st: int,
                      cond: bool = False):
    """trajectory: {"xs": [S,B,...], "ts": [S,B]} ->
    (cali_xs [cali_st * cali_n, ...], cali_ts [cali_st * cali_n])."""
    if cond:
        raise NotImplementedError(
            "conditional calibration samples come with the latent models' "
            "calibration (ROADMAP A4c)")
    xs, ts = trajectory["xs"], trajectory["ts"]
    nsteps = xs.shape[0]
    if cali_st == 1:
        cali_xs = xs.reshape(-1, *xs.shape[2:])[:cali_n]
        return cali_xs, torch.full((cali_n,), 800.0, dtype=xs.dtype,
                                   device=xs.device)
    if nsteps < cali_st:
        raise ValueError(f"trajectory has {nsteps} < {cali_st} steps")
    idx = torch.arange(0, nsteps, nsteps // cali_st, device=xs.device)
    xs_sel = xs[idx, :cali_n]  # (st, n, ...)
    ts_sel = ts[idx, :cali_n]
    return xs_sel.reshape(-1, *xs_sel.shape[2:]), ts_sel.reshape(-1)
