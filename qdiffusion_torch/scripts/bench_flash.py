"""Time the flash-attention kernels B2 and B3 at every (shape, dtype,
softmax quantizer) of the SD v1 main paths, and P's nine modes, on the
card.

    python -m qdiffusion_torch.scripts.bench_flash [--baseline DIR]
        [--variants]

For each case of `CASES` it prints one JSON line: the kernel's device
time through its wrapper (ops/flash_attention.py, ops/flash_streaming.py)
in a CUDA graph over input sets that outgrow the L2, SDPA's time on the
same inputs where it computes the same function (no quantizer), the
bound (`utils/timing.py::attention_bound`: bf16 tensor rate, or 3xTF32
at the TF32 tensor rate for f32, with the f32 FMA-rate time beside it)
and the sites per call. Then one line per P mode at P's shape
(ops/flash_epilogue.py on flash_mma_kernel, the kernel that also serves
B2 in bf16). The last line sums the kernel and SDPA times per SD fold
call, per stream call, per decode and over P's modes, with the card's
name and power limit.

--variants also times copies of csrc/flash_attention.cu with one part of
the f32 or D > 128 kernels changed or left out (`VARIANTS`), built side
by side, at every case: what each part costs. Those marked wrong give
wrong outputs by design.
--baseline DIR also times the same wrappers of another checkout of this
package (e.g. a `git archive` of an earlier commit) in a subprocess with
DIR first on the path: both versions in one call, on one card, each row
with `baseline_ms` beside `ms`. The subprocess runs between two halves of
this checkout's timings (this, baseline, this), and `ms` is the mean of
the two halves, so that a drift of the card within the call shows as the
spread `ms_spread`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# (kernel, (B, T, H, D), dtype, softmax quantizer, path: sites per call)
CASES = [
    ("B2", (8, 4096, 8, 40), "bfloat16", False, {"sd_fold_call": 5}),
    ("B2", (8, 1024, 8, 80), "bfloat16", False, {"sd_fold_call": 5}),
    ("B2", (8, 4096, 8, 40), "bfloat16", True, {"sd_sim_bf16_call": 5}),
    ("B2", (8, 1024, 8, 80), "bfloat16", True, {"sd_sim_bf16_call": 5}),
    ("B2", (2, 4096, 8, 40), "float32", False, {"sd_stream_call": 5}),
    ("B2", (2, 1024, 8, 80), "float32", False, {"sd_stream_call": 5}),
    ("B2", (8, 4096, 8, 40), "float32", True, {"sd_sim_f32_call": 5}),
    ("B2", (8, 1024, 8, 80), "float32", True, {"sd_sim_f32_call": 5}),
    ("B3", (4, 4096, 1, 512), "bfloat16", False, {"sd_fold_decode": 1}),
    ("B3", (1, 4096, 1, 512), "float32", False, {"sd_stream_decode": 1}),
    ("B3", (4, 4096, 1, 512), "float32", False, {"sd_sim_f32_decode": 1}),
]
P_SHAPE = (2, 4096, 8, 40)
# name -> (text of csrc/flash_attention.cu, its replacement) pairs
# keeps a left-out product's operands live
_DUMMY = "__uint_as_float(({} ^ {}) & 0x3f000000u)"
VARIANTS = {
    # the 3xTF32 split through cvt.rna.tf32.f32 (the same values as the
    # kernel's integer rounding, in more instructions)
    "split_cvt": [("""  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));""",
                   """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));""")],
    # wrong: no split (x as hi, lo = 0), three mma still
    "no_split": [("""  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));""", """  hi = __float_as_uint(x);
  lo = 0u;""")],
    # wrong (TF32 accuracy): hi . hi only, one mma a product
    "one_tf32": [("""  mma1688(c, al, b[0], b[1]);
  mma1688(c, ah, b[2], b[3]);
  mma1688(c, ah, b[0], b[1]);""", """  mma1688(c, ah, b[0], b[1]);""")],
    # wrong: flash_wide_kernel's bf16 QK^T or PV mma left out
    "wide_no_qk_mma": [("""            mmad::mma16816(s[j], qa, kf[0], kf[1]);
            mmad::mma16816(s[j + 1], qa, kf[2], kf[3]);""", f"""\
            s[j][0] += {_DUMMY.format("qa[0]", "kf[0]")};
            s[j + 1][0] += {_DUMMY.format("qa[1]", "kf[2]")};""")],
    "wide_no_pv_mma": [("""\
              mmad::mma16816(o[mt][jd], pa[mt], vf[0], vf[1]);
              mmad::mma16816(o[mt][jd + 1], pa[mt], vf[2], vf[3]);""", f"""\
              o[mt][jd][0] += {_DUMMY.format("pa[mt][0]", "vf[0]")};
              o[mt][jd + 1][0] += {_DUMMY.format("pa[mt][1]", "vf[2]")};""")],
}


def _inputs(shape, dtype: str, quant: bool):
    """q, k, v from seed 0 (q scaled up for a peaked softmax) and the LDM
    policy's softmax / V quantizer pairs when `quant`."""
    from qdiffusion_torch.models.unet_ldm import LDMQuantPolicy

    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q = (2.5 * torch.randn(shape, generator=g, device="cuda")).to(dt)
    k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
            for _ in range(2))
    if not quant:
        return (q, k, v), {}
    pol = LDMQuantPolicy()
    f = lambda a: torch.tensor(a, device="cuda")
    return (q, k, v), {
        "sm_q": ({"delta": f(1 / 255), "zero_point": f(0.0)},
                 pol.sm_aq_transformer),
        "v_q": ({"delta": f(8 / 255), "zero_point": f(128.0)}, pol.aq)}


def _sets(q, k, v):
    from qdiffusion_torch.utils.timing import rotations

    return rotations(lambda: (q.clone(), k.clone(), v.clone()),
                     3 * q.numel() * q.element_size(), cap=8)


def _kernel_ms() -> dict:
    """Device ms of this package's wrappers at every case and P mode (run
    in the baseline checkout too): {key: ms}."""
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_epilogue import MODES, flash_epilogue
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention
    from qdiffusion_torch.utils.timing import graph_ms

    out = {}
    for kernel, shape, dtype, quant, _ in CASES:
        fn = flash_attention if kernel == "B2" else streaming_flash_attention
        (q, k, v), kw = _inputs(shape, dtype, quant)
        out[_key(kernel, shape, dtype, quant)] = graph_ms(
            [lambda s=s: fn(*s, scale=shape[-1] ** -0.5, **kw)
             for s in _sets(q, k, v)], min_calls=10)
        torch.cuda.empty_cache()
    (q, k, v), _ = _inputs(P_SHAPE, "bfloat16", False)
    sets = _sets(q, k, v)
    for mode in MODES:
        out[f"P {mode}"] = graph_ms(
            [lambda s=s: flash_epilogue(*s, scale=P_SHAPE[-1] ** -0.5,
                                        mode=mode) for s in sets],
            min_calls=30)
    return out


def _variant_ms(libs: dict) -> dict:
    """{variant: {case key: ms}} of the libraries in `libs` through the C
    entry, V's quantizer hoisted per call as the wrappers do, at every
    case with D > 128 or f32 (the kernels they change)."""
    from qdiffusion_torch.ops.flash_attention import hoist_v_quant, launch
    from qdiffusion_torch.utils.timing import graph_ms

    out = {name: {} for name in libs}
    for kernel, shape, dtype, quant, _ in CASES:
        if dtype == "bfloat16" and shape[-1] <= 128:
            continue
        (q, k, v), kw = _inputs(shape, dtype, quant)
        sets = _sets(q, k, v)
        for name, lib in libs.items():
            out[name][_key(kernel, shape, dtype, quant)] = graph_ms(
                [lambda s=s: launch(
                    "variant", s[0], s[1], hoist_v_quant(s[2], kw.get("v_q")),
                    scale=shape[-1] ** -0.5, sm_q=kw.get("sm_q"),
                    norm_before=kernel == "B3", lib=lib) for s in sets],
                min_calls=10)
        del sets
        torch.cuda.empty_cache()
    return out


def _key(kernel, shape, dtype, quant) -> str:
    return f"{kernel} {','.join(map(str, shape))} {dtype} sm_q={int(quant)}"


def _baseline(path: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(path)}
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--kernels-only"], cwd=path, env=env,
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"baseline run failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", default=None,
                   help="a checkout of this package whose wrappers to time "
                        "at the same cases")
    p.add_argument("--variants", action="store_true",
                   help="also time the VARIANTS of the CUDA source")
    p.add_argument("--kernels-only", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash: needs a CUDA device", file=sys.stderr)
        return 2
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops.flash_epilogue import MODES
    from qdiffusion_torch.utils.timing import attention_bound, graph_ms, \
        nvidia_smi

    resolve_device("cuda")
    if args.kernels_only:  # the baseline's side: this package is DIR's
        print(json.dumps(_kernel_ms()))
        return 0
    halves = [_kernel_ms()]
    base = _baseline(args.baseline) if args.baseline else {}
    if args.baseline:
        halves.append(_kernel_ms())
    variants = _variant_ms(_cuda.build_variants(
        "flash_attention.cu", VARIANTS)) if args.variants else {}
    ms = {k: sum(h[k] for h in halves) / len(halves) for k in halves[0]}
    spread = {k: max(h[k] for h in halves) - min(h[k] for h in halves)
              for k in halves[0]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    totals: dict = {}

    def add(path, key, value):
        if value is not None:
            tot = totals.setdefault(path, {})
            tot[key] = tot.get(key, 0.0) + value

    for kernel, shape, dtype, quant, per in CASES:
        key = _key(kernel, shape, dtype, quant)
        row = {"kernel": kernel, "shape": list(shape), "dtype": dtype,
               "sm_q": quant, "per": per, "ms": ms[key],
               "ms_spread": spread[key], "baseline_ms": base.get(key),
               **attention_bound(shape, 2 if dtype == "bfloat16" else 4),
               **{f"{name}_ms": v[key] for name, v in variants.items()
                  if key in v}}
        if not quant:
            (q, k, v), _ = _inputs(shape, dtype, False)
            row["sdpa_ms"] = graph_ms(
                [lambda s=s: sdpa(*(a.transpose(1, 2) for a in s),
                                  scale=shape[-1] ** -0.5)
                 for s in _sets(q, k, v)], min_calls=10)
            del q, k, v
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        for path, n in per.items():
            for name in ("ms", "baseline_ms", "sdpa_ms", "bound_ms",
                         *(f"{v}_ms" for v in variants)):
                add(path, name, None if row.get(name) is None
                    else row[name] * n)
    for mode in MODES:
        key = f"P {mode}"
        row = {"kernel": "P", "mode": mode, "shape": list(P_SHAPE),
               "ms": ms[key], "ms_spread": spread[key],
               "baseline_ms": base.get(key)}
        print(json.dumps(row), flush=True)
        for name in ("ms", "baseline_ms"):
            add("p_nine_modes", name, row[name])
    print(json.dumps({"per_call": totals, "nvidia_smi": nvidia_smi(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
