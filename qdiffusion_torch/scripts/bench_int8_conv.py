"""Time kernel B4 at every site of one CIFAR-10 W4A8 int8 step at batch
64, on the card.

    python -m qdiffusion_torch.scripts.bench_int8_conv [--variants]
        [--baseline DIR]

The sites come from the int8 engine itself: the full-width CIFAR UNet
with the split shortcut (--split), weights from init_params(0), W4
weights and an 8-bit activation qstate from 8 seeded inputs, and one int8
step at batch 64 (bf16 carrier) under a spy on ops/int8.py's int8_conv2d
and int8_dense. For each distinct site (its geometry, segments and the
step's own input) it prints one JSON line: the site, its count per step,
the launch plan (`conv_plan`), the device time of int8_conv2d /
int8_dense on it (one B4 launch) in a CUDA graph over copies of the
input that outgrow the L2, and the bound (x read once, the int8 weights,
the output written once; the int8 tensor rate). The last line sums them
per step, with the card's name and power limit.

--variants also times copies of csrc/int_matmul.cu with one part of B4
left out or changed (`VARIANTS`), built side by side: what each part
costs. Their outputs are wrong by design, except those of the other ring
and stage sizes and of `minb1` (one block per SM). A variant with
128-value stages cannot serve a site whose plan splits K (the plan counts
64-value stages): its C entry refuses the site, recorded as null.
--baseline DIR times int8_conv2d / int8_dense of another checkout of this
package (e.g. a `git archive` of an earlier commit, whose int8 engine
quantized, padded and gathered in PyTorch ahead of its own B4) at the
same sites, in a subprocess with DIR first on the path: both versions in
one process tree, on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

BATCH = 64
# name -> (text of csrc/int_matmul.cu, its replacement) pairs
VARIANTS = {
    # the quantize pass without its arithmetic (the value truncated)
    "no_quantize": [("v[e] = quant1(f[e], d, zp, lo, hi, ctr);",
                     "v[e] = (int)f[e];")],
    # the activation copies of the A tile replaced by a store of a value
    # from the walk (the copies' latency and bytes gone)
    "no_x_copies": [("cp16(smem_addr(dst), cx + abase[j] + toff + c, true);",
                     "*reinterpret_cast<uint4*>(dst) = make_uint4(tap, c, "
                     "j, 0);")],
    "no_row_sums": [("rsum += sum16(*reinterpret_cast<const uint4*>(mine + "
                     "16 * q));", ";")],
    "no_mma": [("for (int n = 0; n < NI; ++n) mma_s8(acc[i][n], a[i], "
                "b[n]);", "for (int n = 0; n < NI; ++n) acc[i][n][0] += "
                "(int)(a[i][0] ^ b[n][0]);")],
    # other stage depths and rings, and one block per SM (correct outputs)
    "stages_2": [("BK = 64, THREADS = 256, STAGES = 4;",
                  "BK = 64, THREADS = 256, STAGES = 2;")],
    "bk128_stages_2": [("BK = 64, THREADS = 256, STAGES = 4;",
                        "BK = 128, THREADS = 256, STAGES = 2;")],
    "bk128_stages_3": [("BK = 64, THREADS = 256, STAGES = 4;",
                        "BK = 128, THREADS = 256, STAGES = 3;")],
    "minb1": [("launch_conv<1, 2>(p, st)", "launch_conv<1, 1>(p, st)")],
}


def cifar_int8_sites(device="cuda"):
    """The distinct B4 sites of one CIFAR W4A8 int8 step at batch 64:
    {key: [x, packed, conv kwargs, count per step]}, each key a JSON
    string of the site's geometry."""
    import dataclasses

    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.config import PRESETS, QuantFlags
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.models.unet_ddim import DDIMUNet
    import qdiffusion_torch.ops.int8 as int8

    task = PRESETS["cifar10"]
    cfg = dataclasses.replace(task.unet_ddim, split_shortcut=True)
    model = DDIMUNet(cfg, QuantFlags(weight_bit=4, quant_act=True,
                                     split=True).policy_ddim(),
                     device=device)
    model.load_state_dict(model.init_params(0))
    gen = torch.Generator(device=device).manual_seed(7)
    xs = torch.randn((8, 32, 32, 3), generator=gen, device=device)
    ts = torch.randint(0, 1000, (8,), generator=gen, device=device).float()
    qstate = init_act_qstate(model, init_weight_qstate(model), xs, ts)
    step = make_quantized_step(model, qstate, engine="int8")
    x = torch.randn((BATCH, 32, 32, 3), generator=gen, device=device)
    t = torch.full((BATCH,), 500.0, device=device)
    sites = {}
    real = int8.int8_conv2d, int8.int8_dense

    def seen(kind, x, packed, kw):
        key = json.dumps([kind, list(x.shape), list(x.stride()),
                          str(x.dtype), [[s.in_ch, list(s.kshape)]
                                         for s in packed.segments],
                          int(packed.segments[0].w_c.shape[1]),
                          kw.get("stride", 1), kw.get("padding", 0)])
        if key not in sites:
            sites[key] = [x.clone(memory_format=torch.preserve_format),
                          packed, kw, 0]
        sites[key][3] += 1

    def conv(x, packed, **kw):
        seen("conv", x, packed, kw)
        return real[0](x, packed, **kw)

    def dense(x, packed, **kw):
        seen("dense", x, packed, kw)
        return real[1](x, packed, **kw)

    int8.int8_conv2d, int8.int8_dense = conv, dense
    try:
        with torch.no_grad():
            step(x, t)
    finally:
        int8.int8_conv2d, int8.int8_dense = real
    torch.cuda.synchronize()
    return sites


def _run(key, x, packed, kw):
    import qdiffusion_torch.ops.int8 as int8

    if json.loads(key)[0] == "conv":
        return int8.int8_conv2d(x, packed, **kw)
    return int8.int8_dense(x, packed)


def _ms(key, site) -> float:
    from qdiffusion_torch.utils.timing import graph_ms, rotations

    x, packed, kw, _ = site
    xs = rotations(lambda: x.clone(memory_format=torch.preserve_format),
                   x.numel() * x.element_size(), cap=64)
    return graph_ms([lambda a=a: _run(key, a, packed, kw) for a in xs])


def _wrapper_ms() -> dict:
    """Device ms of this package's int8 sites (run in the baseline
    checkout too)."""
    sites = cifar_int8_sites()
    return {key: _ms(key, site) for key, site in sites.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", action="store_true",
                   help="also time the kernel's VARIANTS at every site")
    p.add_argument("--baseline", default=None,
                   help="a checkout of this package whose int8 sites to "
                        "time at the same inputs")
    p.add_argument("--wrappers", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_int8_conv: needs a CUDA device", file=sys.stderr)
        return 2
    from qdiffusion_torch import resolve_device

    resolve_device("cuda")
    if args.wrappers:  # the baseline's side: this package is DIR's
        print(json.dumps(_wrapper_ms()))
        return 0
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops.int8_conv import conv_plan, stages
    from qdiffusion_torch.utils.timing import INT8_OPS, bound, nvidia_smi

    base = {}
    if args.baseline:
        env = {**os.environ, "PYTHONPATH": os.path.abspath(args.baseline)}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--wrappers"], cwd=args.baseline, env=env,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"baseline run failed:\n{res.stderr[-3000:]}")
        base = json.loads(res.stdout.strip().splitlines()[-1])
    libs = _cuda.build_variants("int_matmul.cu", VARIANTS) \
        if args.variants else {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sites = cifar_int8_sites()
    totals, n_sites = {}, 0
    for key, site in sites.items():
        x, packed, kw, count = site
        kind, shape, _, dtype, segs, n, stride, padding = json.loads(key)
        with torch.no_grad():
            y = _run(key, x, packed, kw)
        m = y.numel() // n
        k_tot = sum(c * (ks[0] * ks[1] if ks else 1) for c, ks in segs)
        plan = conv_plan(m, n, [stages(c * (ks[0] * ks[1] if ks else 1))
                                for c, ks in segs], sms)
        row = {"site": {"kind": kind, "x_shape": shape, "dtype": dtype,
                        "segments": segs, "N": n, "stride": stride,
                        "padding": padding},
               "per_step": count, "M": m, "K": k_tot,
               "plan": {"splits": plan.splits, "sps": plan.sps},
               "ms": _ms(key, site),
               **bound(x.numel() * x.element_size() + n * k_tot
                       + m * n * y.element_size(),
                       2 * m * n * k_tot / INT8_OPS * 1e3)}
        if key in base:
            row["baseline_ms"] = base[key]
        for name, lib in libs.items():
            real = _cuda.library
            _cuda.library = lambda source, lib=lib: lib
            try:
                row[f"{name}_ms"] = _ms(key, site)
            except RuntimeError as e:  # a variant whose stage size the
                # plan's K split does not fit: its C entry refuses the site
                row[f"{name}_ms"] = None
                row[f"{name}_refused"] = str(e)[-120:]
            finally:
                _cuda.library = real
        print(json.dumps(row), flush=True)
        n_sites += count
        for k, v in row.items():
            if k.endswith("_ms") or k == "ms":
                totals[k] = None if v is None or totals.get(k, 0.0) is None \
                    else totals.get(k, 0.0) + v * count
        torch.cuda.empty_cache()
    print(json.dumps({"per_step": totals, "sites_per_step": n_sites,
                      "distinct_sites": len(sites),
                      "nvidia_smi": nvidia_smi(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
