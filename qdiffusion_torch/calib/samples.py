"""Timestep-aware calibration sample selection (port of
qdiffusion_tpu/calib/samples.py; reference get_train_samples,
qdiff/utils.py:325-348): a saved sampling trajectory sliced at `cali_st`
evenly spaced steps, `cali_n` samples at each; for conditional models
the samples twice, the first copy with the cond contexts and the second
with the uncond ones.
"""

from __future__ import annotations

import torch


def get_train_samples(trajectory: dict, cali_n: int, cali_st: int,
                      cond: bool = False):
    """trajectory: {"xs": [S,B,...], "ts": [S,B]} (with cond also "cs"
    and "ucs" [S,B,L,D]) -> (cali_xs [N, ...], cali_ts [N]) with N =
    cali_st * cali_n, or with cond (cali_xs, cali_ts, cali_cs) of 2N rows:
    the cond rows, then the same samples with the uncond rows (JAX
    samples.py:38-44). cali_st == 1 takes the first cali_n rows at
    t = 800 and no contexts, as the JAX function does."""
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
    cali_xs = xs_sel.reshape(-1, *xs_sel.shape[2:])
    cali_ts = ts_sel.reshape(-1)
    if not cond:
        return cali_xs, cali_ts
    cs, ucs = (trajectory[k][idx, :cali_n] for k in ("cs", "ucs"))
    return (torch.cat([cali_xs, cali_xs]), torch.cat([cali_ts, cali_ts]),
            torch.cat([cs.reshape(-1, *cs.shape[2:]),
                       ucs.reshape(-1, *ucs.shape[2:])]))
