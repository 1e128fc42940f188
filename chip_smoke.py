#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (qdiffusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

Drives the port's CIFAR-10 main path at the full DDIMUNetConfig() width
through the entry points a user calls, and holds every kernel of that
path against its plain PyTorch version:

  1. device   - the card's name and power limit (nvidia-smi);
  2. kernels  - GroupNorm kernel B1 at every GroupNorm shape of the UNet
                at batch 64, bf16 and f32: error against the plain version,
                kernel / plain / F.group_norm device time (CUDA graph of
                back-to-back calls on inputs that outgrow the L2, CUDA
                events, median), the kernel's eager launch rate, and the
                device-memory bound;
  3. fold     - `qdiffusion_torch.cli sample --task cifar10 --engine fold
                --weight-bit 4 --dtype bfloat16 --n 128 --batch 64`
                (DDIM-100 quad) with seeded random params and a W4 qstate
                made here; output shape, finiteness and the GroupNorm
                launch count (2 batches x 100 steps x per-step count);
  4. card/CPU - one fold step at batch 2, card bf16 against CPU f32;
  5. sim      - W8A8 fake-quant, activation qstate from 8 inputs, one
                f32 UNet step at batch 64 and a 10-step DDIM through the
                CLI.
  (--profile adds a torch.profiler breakdown of three fold steps.)

Each phase prints one JSON line. Then come the `kernels` line, the raw
nvidia-smi line and, only if every check passed, the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero without it.
A full report goes to DIR/report.json (default runs/chip_smoke).
Needs CUDA: without a card it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
GN_FLOPS_PER_ELEM = 8  # sum, square-add, then subtract, scale, affine
ROTATE_BYTES = 128 << 20  # inputs cycled per timing: over twice the L2
BATCH = 64
STEPS = 100
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),  # sum order only
       torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}  # one bf16 rounding
REL_L2_CARD_VS_CPU = 5e-2  # bf16 carrier against the f32 reference


def _emit(obj: dict):
    print(json.dumps(obj), flush=True)


def _events_ms(run, per: int, rounds: int = 5) -> float:
    """Median over `rounds` of CUDA-event time of `run()` divided by
    `per`, after a warm-up run."""
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per)
    return statistics.median(out)


def _time_ms(fn, reps: int = 20) -> float:
    """Eager time of `fn`: `reps` back-to-back calls, CUDA events. For a
    small kernel this is the host's launch rate, not the device time."""
    def run():
        for _ in range(reps):
            fn()
    return _events_ms(run, reps)


def _graph_ms(fns: list, min_calls: int = 20) -> float:
    """Device time per call of the callables `fns` (each on its own
    input buffer, so the inputs together outgrow the 50 MB L2 and every
    call reads device memory), captured back to back in one CUDA graph so
    that host launch cost drops out."""
    calls = fns * max(1, -(-min_calls // len(fns)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    ms = _events_ms(graph.replay, len(calls))
    del graph
    return ms


def _seeded_model(task, device="cuda", **flags):
    """The full-width CIFAR UNet with the params the CLI builds without
    --ckpt (init_params seed 0) and the policy of `flags`."""
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.models.unet_ddim import DDIMUNet

    model = DDIMUNet(task.unet_ddim, QuantFlags(**flags).policy_ddim(),
                     device=device)
    model.load_state_dict(model.init_params(0))
    return model


class Checks:
    def __init__(self):
        self.failed: list = []

    def __call__(self, ok: bool, what: str):
        if not ok:
            self.failed.append(what)
            print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
        return ok


def gn_shapes(model, task) -> list:
    """(H, W, C) of every GroupNorm input of one forward, in call order,
    recorded on the card at batch 1."""
    import qdiffusion_torch.nn as qnn

    seen = []
    real = qnn.fused_group_norm

    def spy(x, *a, **kw):
        seen.append(tuple(x.shape[1:]))
        return real(x, *a, **kw)

    qnn.fused_group_norm = spy
    try:
        with torch.no_grad():
            s = task.image_size
            model(torch.zeros(1, s, s, task.channels, device="cuda"),
                  torch.zeros(1, device="cuda"))
    finally:
        qnn.fused_group_norm = real
    return seen


def phase_kernels(shapes: list, check: Checks) -> tuple:
    from qdiffusion_torch.ops.groupnorm import fused_group_norm, \
        group_norm_plain

    counts: dict = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for (h, w, c), per_step in counts.items():
            x = (torch.randn((BATCH, h, w, c), generator=gen, device="cuda")
                 * 2.0 + 0.5).to(dtype)
            scale = (1.0 + 0.5 * torch.randn(c, generator=gen,
                                              device="cuda")).to(dtype)
            bias = (0.5 * torch.randn(c, generator=gen,
                                      device="cuda")).to(dtype)
            y = fused_group_norm(x, scale, bias)
            ref = group_norm_plain(x, scale, bias)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            ok = bool(torch.allclose(y.float(), ref.float(), **TOL[dtype]))
            check(ok, f"group_norm {dtype} {(BATCH, h, w, c)}: max abs err "
                      f"{err} over {TOL[dtype]}")
            nbytes = 2 * x.numel() * x.element_size() \
                + 2 * c * scale.element_size()
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = GN_FLOPS_PER_ELEM * x.numel() / F32_FLOPS * 1e3
            xs = [x] + [x.clone() for _ in range(
                -(-ROTATE_BYTES // (x.numel() * x.element_size())) - 1)]
            # F.group_norm takes NCHW: the same channels_last bytes
            lib = torch.nn.functional.group_norm
            row = {
                "phase": "kernel_shape", "kernel": "group_norm",
                "dtype": str(dtype).replace("torch.", ""),
                "shape": [BATCH, h * w, c], "per_step": per_step,
                "max_abs_err": err, "tolerance": TOL[dtype], "ok": ok,
                "ms": _graph_ms([lambda a=a: fused_group_norm(a, scale, bias)
                                 for a in xs]),
                "plain_ms": _graph_ms([lambda a=a: group_norm_plain(
                    a, scale, bias) for a in xs]),
                "library_ms": _graph_ms([lambda a=a: lib(
                    a.permute(0, 3, 1, 2), 32, scale, bias, eps=1e-6)
                    for a in xs]),
                "eager_ms": _time_ms(lambda: fused_group_norm(x, scale,
                                                              bias)),
                "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            }
            del xs
            _emit(row)
            rows.append(row)
    return rows


def phase_fold(task, out: Path, per_step: int, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.utils.checkpoints import save_qstate

    qpath = out / "w4_qstate.npz"
    save_qstate(qpath, init_weight_qstate(_seeded_model(task, weight_bit=4)))

    n = 2 * BATCH
    fused_group_norm.launches = 0
    res = cli.main(["sample", "--task", "cifar10", "--qstate", str(qpath),
                    "--weight-bit", "4", "--engine", "fold",
                    "--dtype", "bfloat16", "--n", str(n),
                    "--batch", str(BATCH), "--npz-out", str(out / "fold.npz"),
                    "--device", "cuda"])
    launches = fused_group_norm.launches
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    want = 2 * STEPS * per_step
    check(imgs.shape == (n, 32, 32, 3) and imgs.dtype == np.uint8,
          f"fold npz {imgs.shape} {imgs.dtype}")
    check(res["nonfinite"] == 0, f"fold: {res['nonfinite']} non-finite")
    check(res["steps"] == STEPS, f"fold ran {res['steps']} steps")
    check(launches == want, f"fold: {launches} GroupNorm launches, "
                            f"expected {want}")
    secs = res["batch_seconds"]
    row = {"phase": "fold_cli", "n": n, "batch": BATCH, "steps": STEPS,
           "batch_seconds": secs, "img_per_s": BATCH / secs[-1],
           "ms_per_step": secs[-1] / STEPS * 1e3,
           "first_batch_img_per_s": BATCH / secs[0],
           "group_norm_launches": launches, "expected_launches": want,
           "image_mean": float(imgs.mean()), "image_std": float(imgs.std())}
    _emit(row)
    return row


def phase_card_vs_cpu(task, out: Path, check: Checks) -> dict:
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.utils.checkpoints import load_qstate

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    t = torch.tensor([10.0, 500.0])
    eps = {}
    for dev, dtype in (("cpu", None), ("cuda", torch.bfloat16)):
        model = _seeded_model(task, dev, weight_bit=4)
        step = make_quantized_step(model, load_qstate(out / "w4_qstate.npz",
                                                      dev),
                                   engine="fold", dtype=dtype)
        xin = x.to(dev) if dtype is None else x.to(dev, dtype)
        with torch.no_grad():
            eps[dev] = step(xin, t.to(dev)).float().cpu()
    ref, got = eps["cpu"], eps["cuda"]
    rel = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    check(bool(torch.isfinite(got).all()), "card fold step not finite")
    check(rel <= REL_L2_CARD_VS_CPU,
          f"card bf16 vs CPU f32 fold step: relative L2 {rel}")
    row = {"phase": "card_vs_cpu", "batch": 2, "rel_l2": rel,
           "tolerance": REL_L2_CARD_VS_CPU,
           "max_abs_err": float((got - ref).abs().max()),
           "ref_abs_max": float(ref.abs().max())}
    _emit(row)
    return row


def phase_sim(task, out: Path, per_step: int, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.utils.checkpoints import save_qstate

    model = _seeded_model(task, weight_bit=8, quant_act=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    xs = torch.randn((8, 32, 32, 3), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (8,), generator=gen, device="cuda").float()
    qstate = init_act_qstate(model, init_weight_qstate(model), xs, ts)
    n_act = sum(1 for slots in qstate.values() for s in slots
                if s not in ("w", "w0"))
    check(n_act > 0, "sim: no activation quantizer initialised")

    step = make_quantized_step(model, qstate, engine="sim")
    x = torch.randn((BATCH, 32, 32, 3), generator=gen, device="cuda")
    t = torch.full((BATCH,), 500.0, device="cuda")
    eps = step(x, t)
    check(tuple(eps.shape) == (BATCH, 32, 32, 3)
          and bool(torch.isfinite(eps).all()), "sim step output")
    step_ms = _time_ms(lambda: step(x, t), reps=3)

    qpath = out / "w8a8_qstate.npz"
    save_qstate(qpath, qstate)
    del model, step
    fused_group_norm.launches = 0
    res = cli.main(["sample", "--task", "cifar10", "--qstate", str(qpath),
                    "--weight-bit", "8", "--quant-act", "--act-bit", "8",
                    "--engine", "sim", "--dtype", "float32",
                    "--n", str(BATCH), "--batch", str(BATCH),
                    "--timesteps", "10", "--npz-out", str(out / "sim.npz"),
                    "--device", "cuda"])
    launches = fused_group_norm.launches
    check(res["nonfinite"] == 0, f"sim DDIM: {res['nonfinite']} non-finite")
    check(launches == 10 * per_step,
          f"sim DDIM: {launches} GroupNorm launches, expected "
          f"{10 * per_step}")
    row = {"phase": "sim", "batch": BATCH, "act_quantizers": n_act,
           "step_ms": step_ms, "ddim10_seconds": res["batch_seconds"][0],
           "ddim10_ms_per_step": res["batch_seconds"][0] / 10 * 1e3,
           "group_norm_launches": launches}
    _emit(row)
    return row


def phase_profile(task, out: Path) -> dict:
    """torch.profiler over three bf16 fold steps at batch 64: device time
    by kernel and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step

    model = _seeded_model(task, weight_bit=4)
    step = make_quantized_step(model, init_weight_qstate(model),
                               engine="fold", dtype=torch.bfloat16)
    x = torch.randn((BATCH, 32, 32, 3), device="cuda").to(torch.bfloat16)
    t = torch.full((BATCH,), 500.0, device="cuda")
    step_ms = _time_ms(lambda: step(x, t), reps=3)  # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(x, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out / "fold_step_trace.json"))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only: an operator's own entry repeats the time of
    # the kernels it launched
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    kinds: dict = {}
    for e in kern:
        name = e.key.lower()
        kind = ("group_norm" if "group_norm" in name else
                "conv" if any(s in name for s in ("conv", "fprop",
                                                   "implicit")) else
                "gemm" if "gemm" in name else "elementwise and other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + dev_us(e) / 3e3, n + e.count / 3)
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    row = {"phase": "profile", "steps": 3, "batch": BATCH,
           "step_ms": step_ms, "profiled_step_ms": wall_ms / 3,
           "device_busy_ms_per_step": busy_ms / 3,
           # against the unprofiled step: the profiler slows the host
           "idle_share": (1.0 - busy_ms / 3 / step_ms) if busy_ms else None,
           "by_kind": {k: {"ms_per_step": ms, "kernels_per_step": n}
                       for k, (ms, n) in kinds.items()},
           "top": [{"name": e.key[:90], "ms_per_step": dev_us(e) / 3e3,
                    "calls_per_step": e.count / 3} for e in top]}
    _emit(row)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(Path(__file__).resolve().parent
                                         / "runs" / "chip_smoke"))
    p.add_argument("--profile", action="store_true",
                   help="add a torch.profiler breakdown of the fold step")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.config import PRESETS

    t_start = time.perf_counter()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    check = Checks()
    resolve_device("cuda")  # pins cudnn / matmul TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import triton  # the kernel's compiler, on the card's machine

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    _emit({"phase": "device", "nvidia_smi": smi, **device,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "triton": triton.__version__,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    task = PRESETS["cifar10"]
    model = _seeded_model(task)
    n_params = sum(p.numel() for p in model.parameters())
    shapes = gn_shapes(model, task)
    del model
    _emit({"phase": "model", "params": n_params,
           "group_norms_per_step": len(shapes),
           "group_norm_shapes": sorted(set(shapes))})
    check(len(shapes) == 51, f"{len(shapes)} GroupNorms per step, "
                             "expected 51")

    per_step = len(shapes)
    rows = phase_kernels(shapes, check)
    fold = phase_fold(task, out, per_step, check)
    launches = fold["group_norm_launches"]
    card_cpu = phase_card_vs_cpu(task, out, check)
    sim = phase_sim(task, out, per_step, check)
    prof = phase_profile(task, out) if args.profile else None

    def step_sum(key, dtype="bfloat16"):
        return sum(r[key] * r["per_step"] for r in rows
                   if r["dtype"] == dtype)

    bytes_ms, ops_ms = step_sum("bytes_ms"), step_sum("ops_ms")
    kernels = [{
        "name": "group_norm", "route": "triton",
        "source": "qdiffusion_torch/ops/groupnorm.py",
        "replaces": "qdiffusion_tpu/ops/pallas/groupnorm.py:116",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": step_sum("ms"), "plain_ms": step_sum("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": step_sum("library_ms"),
        "per": f"the {per_step} GroupNorms of one bf16 UNet step at batch "
               f"{BATCH}, device time in a CUDA graph; per-shape rows above",
        "eager_ms": step_sum("eager_ms"),
        "f32_ms": step_sum("ms", "float32"),
        "f32_bound_ms": max(step_sum("bytes_ms", "float32"),
                            step_sum("ops_ms", "float32")),
    }]
    report = {"device": device, "nvidia_smi": smi, "kernels": kernels,
              "kernel_shapes": rows, "fold": fold, "card_vs_cpu": card_cpu,
              "sim": sim, "profile": prof, "failed": check.failed,
              "seconds": time.perf_counter() - t_start}
    (out / "report.json").write_text(json.dumps(report, indent=1))
    _emit({"kernels": kernels})
    print(smi, flush=True)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: "
              f"{check.failed}", file=sys.stderr)
        return 1
    _emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
