"""Time kernel B1 at the GroupNorm shapes of a chip_smoke report, on the
card, beside another checkout's B1 at the same shapes.

    python -m qdiffusion_torch.scripts.bench_groupnorm
        --report runs/chip_smoke/report.json [--baseline DIR]

The shapes are the report's B1 rows (`kernel_shapes`: the CIFAR-10 step
at batch 64; `gn_sd`: one SD v1 UNet call at batch 8 and one VAE decode
at batch 4), each (B, S, C) with its dtype and its count per call. For
each it prints one JSON line: the plan (`group_norm_plan`), the device
time of fused_group_norm in a CUDA graph over seeded inputs that outgrow
the L2, and the bound (one read and one write of the slab). The last line
sums them per CIFAR step and per SD call plus decode, with the card's
name and power limit.

--baseline DIR times fused_group_norm of another checkout of this package
(e.g. a `git archive` of an earlier commit) at the same shapes and
inputs, in a subprocess with DIR first on the path: both versions in one
process tree, on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _shapes(report: str) -> list:
    """[(where, [B, S, C], dtype, per_call)] of the report's B1 rows."""
    with open(report) as f:
        rep = json.load(f)
    return [(r["where"], r["shape"], r["dtype"], r["per_call"])
            for r in rep["kernel_shapes"] + rep["gn_sd"]]


def _ms(shape, dtype: str) -> float:
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.utils.timing import graph_ms, rotations

    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, generator=g, device="cuda") * 2.0 + 0.5).to(
        DTYPES[dtype])
    c = shape[-1]
    scale = (1.0 + 0.5 * torch.randn(c, generator=g, device="cuda")).to(
        DTYPES[dtype])
    bias = (0.5 * torch.randn(c, generator=g, device="cuda")).to(
        DTYPES[dtype])
    xs = rotations(x.clone, x.numel() * x.element_size())
    ms = graph_ms([lambda a=a: fused_group_norm(a, scale, bias)
                   for a in xs])
    del xs, x
    torch.cuda.empty_cache()
    return ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--report", required=True,
                   help="a chip_smoke report.json (its B1 rows' shapes)")
    p.add_argument("--baseline", default=None,
                   help="a checkout of this package whose B1 to time at "
                        "the same shapes")
    p.add_argument("--wrappers", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_groupnorm: needs a CUDA device", file=sys.stderr)
        return 2
    if args.wrappers:  # the baseline's side: this package is DIR's
        todo = json.loads(args.wrappers)
        print(json.dumps([_ms(shape, dtype) for shape, dtype in todo]))
        return 0
    from qdiffusion_torch.ops.groupnorm import group_norm_plan
    from qdiffusion_torch.utils.timing import bound, nvidia_smi

    rows = _shapes(args.report)
    base = None
    if args.baseline:
        todo = json.dumps([[shape, dtype] for _, shape, dtype, _ in rows])
        env = {**os.environ, "PYTHONPATH": os.path.abspath(args.baseline)}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--report", os.path.abspath(args.report),
                              "--wrappers", todo], cwd=args.baseline,
                             env=env, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"baseline run failed:\n{res.stderr[-3000:]}")
        base = json.loads(res.stdout.strip().splitlines()[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    totals = {}
    for i, (where, shape, dtype, per_call) in enumerate(rows):
        b, s, c = shape
        es = torch.tensor([], dtype=DTYPES[dtype]).element_size()
        plan = group_norm_plan(b, s, c, 32, es, sms)
        row = {"where": where, "shape": shape, "dtype": dtype,
               "per_call": per_call, "path": plan.path,
               "plan": {"chunks": plan.chunks, "splits": plan.splits,
                        "block_c": plan.block_c},
               "ms": _ms(shape, dtype),
               **bound(2 * b * s * c * es, 0.0)}
        if base is not None:
            row["baseline_ms"] = base[i]
        print(json.dumps(row), flush=True)
        group = ("cifar10 step" if where.startswith("cifar10")
                 else "sd_v1 call + decode") + f" {dtype}"
        tot = totals.setdefault(group, {})
        for k in ("ms", "baseline_ms", "bound_ms"):
            if k in row:
                tot[k] = tot.get(k, 0.0) + row[k] * per_call
    print(json.dumps({"per_call": totals, "nvidia_smi": nvidia_smi(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
