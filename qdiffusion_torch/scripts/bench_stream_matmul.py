"""Time the stream kernels B5 / B6 at every product shape of one SD v1
stream UNet call at batch 2, on the card.

    python -m qdiffusion_torch.scripts.bench_stream_matmul [--sweep]
        [--variants] [--baseline DIR]

For each (M, K, N) of the call (`SD_STREAM_W4`: B6's 220 launches at W4,
`SD_STREAM_W8`: B5's 34 at W8, ops/int8_matmul.py) it prints one JSON
line: the launch plan (`stream_plan`), the kernel's device time through
its wrapper, bf16 `torch.matmul` on the folded weight (the library
yardstick), and the bound (x in f32, the packed weight and y in f32
moved once; bf16 tensor rate), all in a CUDA graph over input sets that
outgrow the L2. The last line sums them per call, with the card's name
and power limit.

--sweep also times the plan's tile at 1, 2, 3, 4, 6, 8, 12 and 16 K
splits through the C entry, so that the plan can be held against the
best split at each shape.
--variants also times copies of csrc/int_matmul.cu with one part of the
kernel's loop taken out or changed (`VARIANTS`), built side by side, at
the plan: what each part costs. Their outputs are wrong by design.
--baseline DIR times the wrappers of another checkout of this package
(e.g. a `git archive` of an earlier commit) at the same shapes, in a
subprocess with DIR first on the path: both versions in one process
tree, on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
# name -> (text of csrc/int_matmul.cu, its replacement) pairs
VARIANTS = {
    # S(bf16(x)) shared out: warp column c issues its mma at the stage's
    # 16-column step c only, each product once (the epilogue still reads
    # the first column's sums, so they come out short)
    "s_shared_out": [("          mma_bf16(sacc[i], a, kOnes, kOnes);",
                      "          if (h * (C::KW / 16) + kk / 16 == wn) "
                      "mma_bf16(sacc[i], a, kOnes, kOnes);")],
    "no_s": [("          mma_bf16(sacc[i], a, kOnes, kOnes);", ";")],
    "no_dequant": [
        ("b[0][j][0] = widen_i8(r0 ^ f, r1 ^ f, j);", "b[0][j][0] = r0 + j;"),
        ("b[0][j][1] = widen_i8(r8 ^ f, r9 ^ f, j);", "b[0][j][1] = r8 + j;"),
        ("b[h][j][0] = widen_nib(w[h][0], w[h][1], j);",
         "b[h][j][0] = w[h][0] + j;"),
        ("b[h][j][1] = widen_nib(w[h][2], w[h][3], j);",
         "b[h][j][1] = w[h][2] + j;")],
    "no_a_loads": [("""load_a(a, sx + h * BM * C::XLD, C::XLD, wm * WM + i * 16, kk,
                 lane);""", "a[0] = b[h][0][0] + i; a[1] = b[h][1][0] + kk; "
                            "a[2] = b[h][2][1]; a[3] = b[h][3][1];")],
    "no_mma": [("mma_bf16(acc[i][j], a, b[h][j][0], b[h][j][1]);",
                "acc[i][j][0] += __uint_as_float((a[j] ^ b[h][j][0] ^ "
                "b[h][j][1]) & 0x3f000000u);")],
    # other shapes of the plan's 32-row block (correct outputs; the
    # plan's splits stay those of the 32-row tile): <BM, BN, WM, STAGES,
    # blocks per SM>
    **{name: [("launch_stream_cfg<32, 128, 32, 4, 3, XT, NH>",
               f"launch_stream_cfg<{cfg}, XT, NH>")]
       for name, cfg in (("tile_64x128", "64, 128, 64, 4, 2"),
                         ("warps_8_of_16x32", "32, 128, 16, 4, 2"),
                         ("ring_2", "32, 128, 32, 2, 3"),
                         ("ring_6", "32, 128, 32, 6, 2"))},
}


def _operands(kernel: str, M: int, K: int, N: int):
    """x f32 (as the stream engine's activations reach the kernel), the
    packed weight and the per-column scale, shift and bias, from seed 0."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((M, K), generator=g, device="cuda")
    if kernel == "int4_stream_matmul":
        w = torch.randint(0, 256, (K // 2, N), generator=g, device="cuda",
                          dtype=torch.uint8)
    else:
        w = torch.randint(-128, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
    scale = 1e-4 + 1e-3 * torch.rand(N, generator=g, device="cuda")
    shift = 1e-2 * torch.randn(N, generator=g, device="cuda")
    bias = torch.randn(N, generator=g, device="cuda")
    return x, w, scale, shift, bias


def _sets(x, w):
    from qdiffusion_torch.utils.timing import rotations

    return rotations(lambda: (x.clone(), w.clone()), 4 * x.numel()
                     + w.numel(), cap=16)


def _wrapper_ms(todo: list) -> dict:
    """Device ms of this package's wrappers at [kernel, M, K, N] each (run
    in the baseline checkout too)."""
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream
    from qdiffusion_torch.ops.int8_matmul import int8_dense_stream
    from qdiffusion_torch.utils.timing import graph_ms

    out = {}
    for kernel, M, K, N in todo:
        fn = int4_dense_stream if kernel == "int4_stream_matmul" \
            else int8_dense_stream
        x, w, scale, shift, bias = _operands(kernel, M, K, N)
        out[f"{kernel} {M} {K} {N}"] = graph_ms(
            [lambda a=a: fn(*a, scale, shift, bias=bias)
             for a in _sets(x, w)])
        torch.cuda.empty_cache()
    return out


def _entry_us(lib, kernel, shape, plan, sets, consts) -> float:
    """Device time (us) of the C entry of `lib` on `plan`, f32 in and out."""
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.utils.timing import graph_ms

    M, K, N = shape
    ys = [torch.empty((M, N), device="cuda") for _ in sets]
    ws = torch.empty(plan.splits * M * (N + 1), device="cuda") \
        if plan.splits > 1 else None

    def call(xw, y):
        err = lib.qdt_stream_matmul(
            xw[0].data_ptr(), xw[1].data_ptr(),
            *(a.data_ptr() for a in consts), y.data_ptr(),
            None if ws is None else ws.data_ptr(), M, N, K, 0,
            int(kernel == "int4_stream_matmul"), 0, plan.bm, plan.splits,
            plan.kps, _cuda.stream_ptr(xw[0].device))
        _cuda.check(err, f"{kernel} {shape} {plan}")

    return graph_ms([lambda xw=xw, y=y: call(xw, y)
                     for xw, y in zip(sets, ys)]) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", action="store_true",
                   help="also time the plan's tile at 1-16 K splits")
    p.add_argument("--variants", action="store_true",
                   help="also time the kernel's VARIANTS at the plan")
    p.add_argument("--baseline", default=None,
                   help="a checkout of this package whose wrappers to time "
                        "at the same shapes")
    p.add_argument("--wrappers", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stream_matmul: needs a CUDA device", file=sys.stderr)
        return 2
    if args.wrappers:  # the baseline's side: this package is DIR's
        print(json.dumps(_wrapper_ms(json.loads(args.wrappers))))
        return 0
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream, \
        unpack_int4_weight
    from qdiffusion_torch.ops.int8_matmul import SD_STREAM_W4, \
        SD_STREAM_W8, int8_dense_stream, stream_plan
    from qdiffusion_torch.utils.timing import BF16_FLOPS, bound, graph_ms, \
        nvidia_smi

    resolve_device("cuda")
    kernels = (("int4_stream_matmul", SD_STREAM_W4),
               ("int8_stream_matmul", SD_STREAM_W8))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = {}
    if args.baseline:
        todo = [[k, *s] for k, shapes in kernels for s in shapes]
        env = {**os.environ, "PYTHONPATH": os.path.abspath(args.baseline)}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--wrappers", json.dumps(todo)],
                             cwd=args.baseline, env=env,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"baseline run failed:\n{res.stderr[-3000:]}")
        base = json.loads(res.stdout.strip().splitlines()[-1])
    libs = _cuda.build_variants("int_matmul.cu", VARIANTS) \
        if args.variants else {}
    totals = {}
    for kernel, shapes in kernels:
        int4 = kernel == "int4_stream_matmul"
        fn = int4_dense_stream if int4 else int8_dense_stream
        for (M, K, N), per_call in shapes.items():
            x, w, scale, shift, bias = _operands(kernel, M, K, N)
            sets = _sets(x, w)
            wf = unpack_int4_weight(w).float() if int4 else w.float()
            folded = (wf * scale + shift).to(torch.bfloat16)
            lib_sets = [(xx.to(torch.bfloat16), folded) for xx, _ in sets]
            plan = stream_plan(M, N, K, int4, sms)
            row = {"kernel": kernel, "shape": [M, K, N],
                   "per_call": per_call,
                   "plan": {"bm": plan.bm, "bn": plan.bn,
                            "splits": plan.splits},
                   "ms": graph_ms([lambda a=a: fn(*a, scale, shift,
                                                  bias=bias)
                                   for a in sets]),
                   "library_ms": graph_ms([lambda a=a: torch.matmul(*a)
                                           for a in lib_sets]),
                   **bound(4 * M * K + w.numel() + 4 * M * N,
                           2 * M * N * K / BF16_FLOPS * 1e3)}
            key = f"{kernel} {M} {K} {N}"
            if key in base:
                row["baseline_ms"] = base[key]
            consts = (scale, shift, bias)
            if args.sweep:
                row["sweep_us"] = {}
                for s in SPLITS:
                    sp = stream_plan(M, N, K, int4, sms, splits=s)
                    if sp.splits == s:  # else whole stages do not fill s
                        row["sweep_us"][f"{sp.bm}x{sp.bn}:{s}"] = _entry_us(
                            _cuda.library("int_matmul.cu"), kernel,
                            (M, K, N), sp, sets, consts)
                row["best_split_ms"] = min(row["sweep_us"].values()) / 1e3
            for name, lib in libs.items():
                row[f"{name}_ms"] = _entry_us(lib, kernel, (M, K, N), plan,
                                              sets, consts) / 1e3
            print(json.dumps(row), flush=True)
            for k, v in row.items():
                if k.endswith("_ms") or k == "ms":
                    totals[(kernel, k)] = totals.get((kernel, k), 0.0) \
                        + v * per_call
            del sets, lib_sets
            torch.cuda.empty_cache()
    print(json.dumps({
        "per_call": {kernel: {k: v for (kk, k), v in totals.items()
                              if kk == kernel} for kernel, _ in kernels},
        "nvidia_smi": nvidia_smi(),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
