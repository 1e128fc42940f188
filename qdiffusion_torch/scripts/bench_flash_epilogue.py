"""Time each of P's nine epilogues of the bf16 flash kernel on the card.

Counterpart of scripts/bench_flash_epilogue.py (P, a TPU timing probe):
the same function, modes and shape, run through the port's
ops/flash_epilogue.py (csrc/flash_attention.cu::flash_mma_kernel, the
kernel that serves B2 in bf16, with the epilogue switched at compile
time).

    python -m qdiffusion_torch.scripts.bench_flash_epilogue \
        [--device cuda|cpu] [--shape 2,4096,8,40]

q, k, v are (B, T, H, D) standard normals in bf16 from numpy seed 0,
keys = queries (S = T), scale D**-0.5, as P makes them. For each mode it
prints one JSON line: `ms`, the device time per call (CUDA events around
a CUDA graph of many launches that cycle input sets larger than the
50 MB L2, median of 5 replays); `ms_minus_fp_postnorm`; the bound (one
exponential per score at the MUFU rate, QK^T and PV at the bf16 tensor
rate, q, k, v read and o written once at the memory rate; the largest);
and the card's `nvidia-smi` name and power limit. The differences between
modes are the cost of each step of the epilogue.

It runs on the card and raises without CUDA unless the caller passes
`--device cpu`; on the CPU it runs the plain version once per mode and
prints no time.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from qdiffusion_torch.device import resolve_device
from qdiffusion_torch.ops.flash_epilogue import MODES, flash_epilogue
from qdiffusion_torch.utils.timing import attention_bound, graph_ms, \
    nvidia_smi, rotations


def inputs(shape, device) -> tuple:
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(device=device, dtype=torch.bfloat16) for _ in range(3))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", default="2,4096,8,40",
                    help="B,T,H,D of q (k and v alike; P's shape by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape = tuple(int(x) for x in args.shape.split(","))
    if len(shape) != 4:
        raise ValueError(f"--shape {args.shape!r}: want B,T,H,D")
    q, k, v = inputs(shape, dev)
    scale = shape[-1] ** -0.5
    rows = []
    if dev.type == "cpu":
        for mode in MODES:
            o = flash_epilogue(q, k, v, scale=scale, mode=mode)
            row = {"mode": mode, "shape": list(shape), "device": "cpu",
                   "finite": bool(torch.isfinite(o).all()),
                   "out_abs_max": float(o.float().abs().max())}
            print(json.dumps(row), flush=True)
            rows.append(row)
        return rows
    smi = nvidia_smi()
    sets = rotations(lambda: tuple(a.clone() for a in (q, k, v)),
                     3 * q.numel() * q.element_size())
    bnd = attention_bound(shape, q.element_size())
    base = None
    for mode in MODES:
        ms = graph_ms([lambda s=s: flash_epilogue(*s, scale=scale, mode=mode)
                       for s in sets], min_calls=30)
        base = ms if base is None else base
        row = {"mode": mode, "shape": list(shape), "device":
               torch.cuda.get_device_name(dev), "nvidia_smi": smi, "ms": ms,
               "ms_minus_fp_postnorm": ms - base, **bnd,
               "x_bound": ms / bnd["bound_ms"], "input_sets": len(sets)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
