#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (qdiffusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

Builds the port's CUDA kernels (nvcc, one process per source, started
together) into qdiffusion_torch/_build/, then drives the main paths of
every ported slice through the entry points a user calls and holds
every kernel of them against its plain PyTorch version:

  CIFAR-10 (DDIMUNetConfig(), full width):
  1. kernels  - GroupNorm kernel B1 at every GroupNorm shape of the UNet
                at batch 64, bf16 and f32 (error, kernel / plain /
                F.group_norm device time in a CUDA graph over inputs that
                outgrow the L2, CUDA events, median; the device-memory
                bound);
  2. fold     - `cli sample --task cifar10 --engine fold --weight-bit 4
                --dtype bfloat16 --n 64 --batch 64` (DDIM-100), the B1
                launch count against 100 x the per-step count;
  3. card/CPU - one fold step at batch 2, card bf16 against CPU f32;
  4. sim      - W8A8, activation qstate from 8 inputs, one f32 step at
                batch 64 and a 10-step DDIM through the CLI.
  Stable Diffusion v1 (sd_v1 preset, full width, seeded random weights
  with no zero-initialised branch; no checkpoint or vocabulary needed):
  5. attn_kernels - B2 (flash_attention) at (8, 4096, 8, 40) and
                (8, 1024, 8, 80), B3 (streaming_flash_attention) at
                (4, 4096, 1, 512), bf16 and f32, with and without the
                softmax/V quantizers, and B2 at P's (2, 4096, 8, 40) in
                bf16: error against the plain version, kernel / plain /
                F.scaled_dot_product_attention time, the bound (bytes, MMA
                flops, exponentials) and the CUDA design that ran, from
                the profiler's kernel names ("mma": flash_mma_kernel, which
                every bf16 row at D <= 128 must show; "first":
                flash_kernel, for f32 and D = 512);
  6. gn_sd    - B1 at every GroupNorm shape of one SD UNet call (batch 8,
                CFG) and one VAE decode (batch 4), bf16;
  7. sd_fold_cli - writes the UNet / VAE / CLIP npz files, a token-ids
                npz and a W4 'mse' qstate, then `cli sample --task sd_v1
                --engine fold --weight-bit 4 --dtype bfloat16 --n 8
                --batch 4` (PLMS-50, CFG 7.5, 512x512): output, 51 UNet
                calls per batch, and the B1/B2/B3 launch counts against a
                spy's count of one UNet call and one decode;
  8. sd_card_vs_cpu - one fold UNet call with context at 32x32 latents,
                batch 2, card bf16 against CPU f32 (the 1024-token sites
                reach B2);
  9. sd_sim   - W8A8: activation qstate from 2 inputs, one bf16 UNet call
                at batch 8 and a 5-step PLMS through the CLI (f32), with
                B2 launched with its softmax quantizer.
  The int8 and stream deployment engines (kernels B4, B5, B6):
  10. int_kernels - B4 (int8_matmul) at every distinct (M, K, N) of one
                CIFAR W4A8 int8 step at batch 64, B6 (int4_stream_matmul)
                and B5 (int8_stream_matmul) at every distinct shape of one
                SD stream UNet call at batch 2 (W4 and W8), all collected
                by spies: error against the plain version (B4: the int32
                product exactly, the output bit for bit; B5/B6: 1e-3 of the
                largest output), kernel / plain / library time in a CUDA
                graph over inputs that outgrow the L2, and the bound;
  11. int8_cli - `cli sample --task cifar10 --weight-bit 4 --quant-act
                --split --engine int8 --n 128 --batch 64` (DDIM-100): the
                B4 launches against 100 x the spy's per-step count per
                batch; then one int8 step at batch 2: the card's bf16 and
                f32 carriers against the CPU's f32 carrier (every int8
                activation within one bucket beyond its input's drift)
                and the card's f32 carrier against its sim step;
  12. sd_stream_cli - `cli sample --task sd_v1 --weight-bit 4 --engine
                stream --stream-convs --n 2 --batch 1` (PLMS-50, CFG 7.5;
                B6 launches against 51 x the spy's per-call count per
                batch) and the same at --weight-bit 8 --timesteps 5 (B5
                on the streamed convs), with the streamed conv sites.
  P, the flash-epilogue probe (kernel flash_epilogue on B2's bf16 kernel):
  13. flash_epilogue - `python -m qdiffusion_torch.scripts.
                bench_flash_epilogue` at (2, 4096, 8, 40) bf16 (its
                launches counted from 0): each of P's nine modes timed in a
                CUDA graph over inputs that outgrow the L2; then each mode
                against its plain version (fp modes 2e-2 + 2e-2 relative;
                the scaled modes 2e-2 of max|plain| plus one bucket on at
                most 1e-3 of the elements), the plain time, SDPA's time for
                the two fp modes, and the bound (one exponential per score).
  (--profile adds torch.profiler breakdowns of a CIFAR fold step, an SD
  fold UNet call, a CIFAR int8 step and an SD stream W4 UNet call.)

Each phase prints one JSON line (13: one per mode, after the entry
point's own nine). Then come the `kernels` line, the raw
nvidia-smi line and, only if every check passed, the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero without it.
A full report goes to DIR/report.json (default runs/chip_smoke).
Needs CUDA: without a card it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qdiffusion_torch.utils.timing import BF16_FLOPS, F32_FLOPS, INT8_OPS, \
    attention_bound, bound, nvidia_smi, rotations
from qdiffusion_torch.utils.timing import events_ms as _events_ms
from qdiffusion_torch.utils.timing import graph_ms as _graph_ms

GN_FLOPS_PER_ELEM = 8  # sum, square-add, then subtract, scale, affine
BATCH = 64
STEPS = 100
SD_BATCH = 4  # images per batch (the UNet sees 8 under CFG)
SD_STEPS = 50
SD_N = 2 * SD_BATCH
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),  # sum order only
       torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}  # one bf16 rounding
REL_L2_CARD_VS_CPU = 5e-2  # bf16 carrier against the f32 reference
INT8_N = 2 * BATCH  # int8 CLI: two batches, the second one timed
# int8 step at batch 2, full width. f32 noise outside the exact integer
# products flips quantization buckets, and the flips cascade through the
# 113 quantized sites: the same int8 engine with an f32 carrier differs
# by 3.2e-2 relative L2 between the card and the CPU (measured by this
# script on an NVIDIA H100 80GB HBM3 at 700 W). So the card's bf16 carrier against the CPU's f32 carrier, the
# card's f32 carrier against the CPU's, and the card's f32 carrier
# against its sim step are held to 6e-2 (the JAX package's bf16-carrier
# bound, tests/test_int8.py:139-144), and every int8 activation of the
# card's f32 step to one bucket beyond its input's drift from the CPU's.
REL_L2_INT8 = 6e-2
STREAM_N, STREAM_BATCH = 2, 1  # SD stream CLI: batch-1 serving, CFG
B4_REL = 1e-6  # B4 output against its plain version (the same f32 epilogue)
STREAM_REL = 1e-3  # B5/B6: the same bf16 products, summed in another order
P_SHAPE = (2, 4096, 8, 40)  # P's (B, T, H, D), bench_flash_epilogue.py:112


def _emit(obj: dict):
    print(json.dumps(obj), flush=True)


def ptxas_report(build: Path) -> dict:
    """Registers and spill bytes of each kernel, from the `-Xptxas -v`
    reports that ops/_cuda.py writes beside the libraries: {source:
    {kernel: [registers, spill stores, spill loads]}}, kernels by their
    template arguments (flash_mma_kernel<D/16, epilogue>)."""
    import re

    out = {}
    for f in sorted(build.glob("*.ptxas.txt")):
        rows, name = {}, None
        for line in f.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(flash_mma_kernel)ILi(\d+)ELi(\d+)E", m.group(1))
                name = (f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k
                        else m.group(1)[-60:])
                rows[name] = [None, None, None]
            elif name and "spill stores" in line:
                n = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
                rows[name][1:] = n[:2]
            elif name and (m := re.search(r"Used (\d+) registers", line)):
                rows[name][0] = int(m.group(1))
        out[f.name.split(".")[0]] = rows
    return out


def _time_ms(fn, reps: int = 20) -> float:
    """Eager time of `fn`: `reps` back-to-back calls, CUDA events. For a
    small kernel this is the host's launch rate, not the device time."""
    def run():
        for _ in range(reps):
            fn()
    return _events_ms(run, reps)


def _seeded_model(task, device="cuda", **flags):
    """The full-width CIFAR UNet with the params the CLI builds without
    --ckpt (init_params seed 0) and the policy of `flags` (split=True:
    the split-shortcut config of --split)."""
    import dataclasses

    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.models.unet_ddim import DDIMUNet

    cfg = dataclasses.replace(task.unet_ddim, split_shortcut=True) \
        if flags.get("split") else task.unet_ddim
    model = DDIMUNet(cfg, QuantFlags(**flags).policy_ddim(), device=device)
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


class Spy:
    """Replace functions by recording wrappers for the length of a `with`
    block: targets are (module, attribute) pairs; `record(args, kwargs)`
    returns what to log per call. The real function still runs."""

    def __init__(self, targets, record):
        self.targets, self.record, self.seen = targets, record, []

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for m, a in self.targets]
        for m, a, real in self.saved:
            def spy(*args, _real=real, _name=a, **kw):
                self.seen.append((_name, self.record(args, kw)))
                return _real(*args, **kw)
            setattr(m, a, spy)
        return self

    def __exit__(self, *exc):
        for m, a, real in self.saved:
            setattr(m, a, real)


def gn_spy() -> Spy:
    """Every B1 call site of the models: nn.group_norm's and the LDM
    AttentionBlock's token GroupNorm."""
    import qdiffusion_torch.models.unet_ldm as unet_ldm
    import qdiffusion_torch.nn as qnn

    return Spy([(qnn, "fused_group_norm"), (unet_ldm, "fused_group_norm")],
               lambda a, kw: tuple(a[0].shape))


def attn_spy() -> Spy:
    """The blockwise dispatch's two kernel wrappers (B2, B3)."""
    import qdiffusion_torch.ops.attention as att

    return Spy([(att, "flash_attention"),
                (att, "streaming_flash_attention")],
               lambda a, kw: (tuple(a[0].shape), tuple(a[1].shape),
                              str(a[0].dtype).replace("torch.", ""),
                              kw.get("sm_q") is not None))


def gn_shapes(model, task) -> list:
    """(1, H, W, C) of every GroupNorm input of one CIFAR forward at
    batch 1, in call order."""
    with gn_spy() as spy, torch.no_grad():
        s = task.image_size
        model(torch.zeros(1, s, s, task.channels, device="cuda"),
              torch.zeros(1, device="cuda"))
    return [shape for _, shape in spy.seen]


def phase_kernels(shapes: list, check: Checks, *,
                  dtypes=(torch.bfloat16, torch.float32),
                  phase: str = "kernel_shape", where: str = "") -> list:
    """B1 at each distinct full (B, ..., C) shape of `shapes` (a call-order
    list, so a shape's multiplicity is its count per call)."""
    from qdiffusion_torch.ops.groupnorm import fused_group_norm, \
        group_norm_plain

    counts: dict = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in dtypes:
        for shape, per_call in counts.items():
            c = shape[-1]
            x = (torch.randn(shape, generator=gen, device="cuda")
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
            check(ok, f"group_norm {dtype} {shape}: max abs err "
                      f"{err} over {TOL[dtype]}")
            del y, ref
            nbytes = 2 * x.numel() * x.element_size() \
                + 2 * c * scale.element_size()
            xs = rotations(x.clone, x.numel() * x.element_size())
            # F.group_norm takes (N, C, *): the same channel-last bytes
            lib = torch.nn.functional.group_norm
            row = {
                "phase": phase, "kernel": "group_norm", "where": where,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": [shape[0], x.numel() // (shape[0] * c), c],
                "per_call": per_call,
                "max_abs_err": err, "tolerance": TOL[dtype], "ok": ok,
                "ms": _graph_ms([lambda a=a: fused_group_norm(a, scale, bias)
                                 for a in xs]),
                "plain_ms": _graph_ms([lambda a=a: group_norm_plain(
                    a, scale, bias) for a in xs], min_calls=5),
                "library_ms": _graph_ms([lambda a=a: lib(
                    a.movedim(-1, 1), 32, scale, bias, eps=1e-6)
                    for a in xs]),
                "eager_ms": _time_ms(lambda: fused_group_norm(x, scale,
                                                              bias)),
                **bound(nbytes, GN_FLOPS_PER_ELEM * x.numel() / F32_FLOPS
                        * 1e3),
            }
            del xs, x
            _emit(row)
            rows.append(row)
    return rows


def per_call_sum(rows: list, key: str, dtype="bfloat16") -> float:
    return sum(r[key] * r["per_call"] for r in rows if r["dtype"] == dtype)


def phase_fold(task, out: Path, per_step: int, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.utils.checkpoints import save_qstate

    qpath = out / "w4_qstate.npz"
    save_qstate(qpath, init_weight_qstate(_seeded_model(task, weight_bit=4)))

    n = BATCH
    fused_group_norm.launches = 0
    res = cli.main(["sample", "--task", "cifar10", "--qstate", str(qpath),
                    "--weight-bit", "4", "--engine", "fold",
                    "--dtype", "bfloat16", "--n", str(n),
                    "--batch", str(BATCH), "--npz-out", str(out / "fold.npz"),
                    "--device", "cuda"])
    launches = fused_group_norm.launches
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    want = (n // BATCH) * STEPS * per_step
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


def profile_breakdown(run, reps: int, trace: Path, what: str) -> dict:
    """torch.profiler over `reps` calls of `run`: device time by kernel
    kind and the device's idle share against the unprofiled call time."""
    from torch.profiler import ProfilerActivity, profile

    call_ms = _time_ms(run, reps=reps)  # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only: an operator's own entry repeats the time of
    # the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages()
            if e.device_type == cuda and dev_us(e) > 0]
    # busy time as the union of the kernels' intervals: kernels that run
    # concurrently (cuDNN's f32 convolutions do) count once
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda
                   and e.time_range.end > e.time_range.start)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_us += 0.0 if cur_e is None else cur_e - cur_s
    kernel_sum_ms = sum(dev_us(e) for e in kern) / 1e3
    busy_ms = busy_us / 1e3 if spans else kernel_sum_ms
    kinds: dict = {}
    for e in kern:
        name = e.key.lower()
        kind = ("group_norm" if "group_norm" in name else
                "flash_attention" if any(s in name for s in (
                    "flash_kernel", "flash_mma_kernel")) else
                "int matmul (B4-B6)" if any(s in name for s in (
                    "b4_kernel", "stream_kernel")) else
                "conv" if any(s in name for s in ("conv", "fprop",
                                                   "implicit")) else
                # cuBLAS's Hopper GEMMs are named nvjet_*
                "gemm" if any(s in name for s in ("gemm", "matmul",
                                                   "cutlass", "nvjet")) else
                "elementwise and other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + dev_us(e) / (1e3 * reps), n + e.count / reps)
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    return {"what": what, "calls": reps, "call_ms": call_ms,
            "profiled_call_ms": wall_ms / reps,
            "device_busy_ms_per_call": busy_ms / reps,
            "kernel_time_sum_ms_per_call": kernel_sum_ms / reps,
            "idle_share": (1.0 - busy_ms / reps / call_ms) if busy_ms
            else None,
            "by_kind": {k: {"ms_per_call": ms, "kernels_per_call": n}
                        for k, (ms, n) in kinds.items()},
            "top": [{"name": e.key[:90], "ms_per_call": dev_us(e) / (
                1e3 * reps), "calls_per_call": e.count / reps}
                for e in top]}


def phase_profile(task, out: Path) -> dict:
    """Three bf16 CIFAR fold steps at batch 64."""
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step

    model = _seeded_model(task, weight_bit=4)
    step = make_quantized_step(model, init_weight_qstate(model),
                               engine="fold", dtype=torch.bfloat16)
    x = torch.randn((BATCH, 32, 32, 3), device="cuda").to(torch.bfloat16)
    t = torch.full((BATCH,), 500.0, device="cuda")
    row = {"phase": "profile", **profile_breakdown(
        lambda: step(x, t), 3, out / "fold_step_trace.json",
        f"CIFAR-10 fold W4 bf16 step, batch {BATCH}")}
    _emit(row)
    return row


# -- Stable Diffusion v1 ------------------------------------------------------

def _sd_unet(task, dtype=None, **flags):
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.models.unet_ldm import LDMUNet

    model = LDMUNet(task.unet_ldm, QuantFlags(**flags).policy_ldm())
    return model if dtype is None else model.to(dtype)


def _sd_inputs(task, n, size=None, seed=0, dtype=torch.float32):
    """Seeded (x NHWC latents, t, context (n, 77, 768) f32) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = size or task.latent_size
    x = torch.randn((n, s, s, task.latent_channels), generator=g,
                    device="cuda").to(dtype)
    t = torch.randint(1, 1000, (n,), generator=g, device="cuda").float()
    c = torch.randn((n, 77, task.clip.hidden_size), generator=g,
                    device="cuda")
    return x, t, c


def phase_sd_spy(task, check: Checks) -> dict:
    """One bf16 UNet call at the CFG batch and one VAE decode, with every
    B1 call and every blockwise-attention dispatch recorded."""
    from qdiffusion_torch.models.vae import VAE

    model = _sd_unet(task, torch.bfloat16, weight_bit=4)
    model.load_state_dict(model.init_params(0))
    n_params = sum(p.numel() for p in model.parameters())
    x, t, c = _sd_inputs(task, 2 * SD_BATCH, dtype=torch.bfloat16)
    with gn_spy() as gn, attn_spy() as att, torch.no_grad():
        eps = model(x, t, None, c)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(eps).all()), "sd spy: UNet call not finite")
    del model, eps
    vae = VAE(task.vae).to(torch.bfloat16)
    vae.load_state_dict(vae.init_params(1))
    with gn_spy() as gn_dec, attn_spy() as att_dec, torch.no_grad():
        img = vae.decode(x[:SD_BATCH] / task.scale_factor)
    torch.cuda.synchronize()
    check(tuple(img.shape) == (SD_BATCH, 512, 512, 3)
          and bool(torch.isfinite(img).all()), "sd spy: decode output")
    del vae, img

    def count(seen, name):
        return sum(1 for n, _ in seen if n == name)

    b2_sites = [r for n, r in att.seen if n == "flash_attention"]
    row = {"phase": "sd_spy", "unet_params": n_params,
           "unet_call": {"group_norm": len(gn.seen),
                         "flash_attention": len(b2_sites),
                         "flash_streaming": count(
                             att.seen, "streaming_flash_attention")},
           "decode": {"group_norm": len(gn_dec.seen),
                      "flash_attention": count(att_dec.seen,
                                               "flash_attention"),
                      "flash_streaming": count(
                          att_dec.seen, "streaming_flash_attention")},
           "flash_sites": sorted({r[0]: b2_sites.count(r)
                                  for r in b2_sites}.items()),
           "streaming_sites": [r for n, r in att_dec.seen
                               if n == "streaming_flash_attention"],
           "unet_gn_shapes": [s for _, s in gn.seen],
           "decode_gn_shapes": [s for _, s in gn_dec.seen]}
    want_b2 = {(8, 4096, 8, 40): 5, (8, 1024, 8, 80): 5}
    got_b2 = {}
    for r in b2_sites:
        got_b2[r[0]] = got_b2.get(r[0], 0) + 1
    check(got_b2 == want_b2, f"sd spy: B2 sites {got_b2}, expected {want_b2}")
    check(row["decode"]["flash_streaming"] == 1
          and row["unet_call"]["flash_streaming"] == 0,
          f"sd spy: B3 sites {row['unet_call']} {row['decode']}")
    _emit({k: v for k, v in row.items() if not k.endswith("gn_shapes")})
    return row


def _attn_case(shape, dtype, quant, seed):
    """Seeded q, k, v on the card (q scaled up so the softmax is peaked
    and its quantizer sees a spread of buckets) and the quantizer pairs of
    the LDM policy (softmax: 8-bit always_zero; V: 8-bit asymmetric)."""
    from qdiffusion_torch.models.unet_ldm import LDMQuantPolicy

    b, t, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (2.5 * torch.randn((b, t, h, d), generator=g, device="cuda")
         ).to(dtype)
    k = torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
    if not quant:
        return (q, k, v), None, None
    pol = LDMQuantPolicy()
    f = lambda a: torch.tensor(a, device="cuda")
    sm_q = ({"delta": f(1 / 255), "zero_point": f(0.0)},
            pol.sm_aq_transformer)
    v_q = ({"delta": f(8 / 255), "zero_point": f(128.0)}, pol.aq)
    return (q, k, v), sm_q, v_q


def _run_design(run):
    """`run()` under torch.profiler, and the flash design its kernel names
    show: "mma" (flash_mma_kernel), "first" (flash_kernel) or None."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a kernel of PyTorch's own first: once the profiler has run
        # earlier in the process, it (torch 2.11, CUDA 12.8) records no
        # kernel of the window until PyTorch launches one
        torch.zeros(1, device="cuda").add_(1)
        out = run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    design = ("mma" if any("flash_mma_kernel" in n for n in names) else
              "first" if any("flash_kernel" in n for n in names) else None)
    return out, design


def phase_attn_kernels(check: Checks) -> list:
    """B2 and B3 at the SD and VAE shapes against their plain versions,
    timed in CUDA graphs over inputs that outgrow the L2; B2 also at P's
    shape in bf16."""
    from qdiffusion_torch.ops.flash_attention import flash_attention, \
        flash_attention_plain
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention, streaming_flash_attention_plain

    both = (torch.bfloat16, torch.float32)
    # (kernel, shape, sites per SD call, dtypes, quantizers on);
    # (2, 4096, 8, 40) is P's shape, on no SD fold site
    cases = [("flash_attention", (8, 4096, 8, 40), 5, both, (False, True)),
             ("flash_attention", (8, 1024, 8, 80), 5, both, (False, True)),
             ("flash_streaming", (4, 4096, 1, 512), 1, both, (False, True)),
             ("flash_attention", P_SHAPE, 0, (torch.bfloat16,), (False,))]
    fns = {"flash_attention": (flash_attention, flash_attention_plain),
           "flash_streaming": (streaming_flash_attention,
                               streaming_flash_attention_plain)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for seed, (name, shape, per_call, dtypes, quants) in enumerate(
            cases):
        fn, plain = fns[name]
        d = shape[-1]
        scale = d ** -0.5
        for dtype in dtypes:
            for quant in quants:
                (q, k, v), sm_q, v_q = _attn_case(shape, dtype, quant, seed)
                kw = dict(scale=scale, sm_q=sm_q, v_q=v_q)
                got, design = _run_design(lambda: fn(q, k, v, **kw))
                want = plain(q, k, v, **kw)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                if dtype == torch.bfloat16:
                    tol = "2e-2 abs + 2e-2 rel (one bf16 rounding of p, o)"
                    ok = bool(torch.allclose(got.float(), want.float(),
                                             rtol=2e-2, atol=2e-2))
                elif not quant:
                    tol = "5e-5 abs + 1e-4 rel (f32 sum order)"
                    ok = bool(torch.allclose(got, want, rtol=1e-4,
                                             atol=5e-5))
                else:
                    flip = float(sm_q[0]["delta"]) * float(v.abs().max())
                    tol = (f"5e-5 abs, at most 1e-3 of the elements one "
                           f"softmax bucket apart ({flip:.3g})")
                    ok = err <= 5e-5 + flip and float(
                        (diff > 5e-5).float().mean()) <= 1e-3
                check(ok, f"{name} {shape} {dtype} quant={quant}: max abs "
                          f"err {err} over {tol}")
                # the dispatch of qdt_flash_attention, as the profiler saw it
                want_design = ("mma" if dtype == torch.bfloat16 and d <= 128
                               else "first")
                check(design == want_design,
                      f"{name} {shape} {dtype} quant={quant}: ran the "
                      f"{design} design, not {want_design}")
                del got, want, diff
                es = q.element_size()
                sets = rotations(lambda: tuple(a.clone() for a in (q, k, v)),
                                 3 * q.numel() * es)
                row = {
                    "phase": "attn_kernel", "kernel": name,
                    "shape": list(shape),
                    "dtype": str(dtype).replace("torch.", ""),
                    "quant": quant, "per_call": per_call,
                    "design": design,
                    "max_abs_err": err, "tolerance": tol, "ok": ok,
                    "ms": _graph_ms([lambda s=s: fn(*s, **kw)
                                     for s in sets], min_calls=10),
                    "plain_ms": _graph_ms([lambda s=s: plain(*s, **kw)
                                           for s in sets], min_calls=2),
                    # one PyTorch call computes the unquantized function
                    "library_ms": _graph_ms([lambda s=s: sdpa(
                        *(a.transpose(1, 2) for a in s), scale=scale)
                        for s in sets], min_calls=10)
                    if not quant and dtype == torch.bfloat16 else None,
                    **attention_bound(shape, es),
                }
                del sets, q, k, v
                _emit(row)
                rows.append(row)
    return rows


def phase_flash_epilogue(check: Checks) -> list:
    """P's path: its entry point (`python -m
    qdiffusion_torch.scripts.bench_flash_epilogue`, here `main`) at P's
    shape with the launch count set to 0 just before and read just after;
    then each mode against its plain version on the card, the plain
    version's time, and SDPA's for the two fp modes it computes."""
    from qdiffusion_torch.ops.flash_epilogue import DELTA, MODES, \
        flash_epilogue, flash_epilogue_plain
    from qdiffusion_torch.scripts import bench_flash_epilogue as bench

    flash_epilogue.launches = 0
    timed = {r["mode"]: r for r in bench.main(
        ["--shape", ",".join(map(str, P_SHAPE))])}
    launches = flash_epilogue.launches
    check(sorted(timed) == sorted(MODES) and launches >= len(MODES),
          f"flash_epilogue: modes {sorted(timed)}, {launches} launches")
    (q, k, v), _, _ = _attn_case(P_SHAPE, torch.bfloat16, False, 13)
    scale = P_SHAPE[-1] ** -0.5
    sets = rotations(lambda: tuple(a.clone() for a in (q, k, v)),
                     3 * q.numel() * q.element_size())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for mode in MODES:
        got = flash_epilogue(q, k, v, scale=scale, mode=mode).float()
        want = flash_epilogue_plain(q, k, v, scale=scale, mode=mode).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        if mode in ("fp_postnorm", "fp_prenorm", "cast_rt"):
            tol = "2e-2 abs + 2e-2 rel (one bf16 rounding of p, o)"
            ok = bool(torch.allclose(got, want, rtol=2e-2, atol=2e-2))
        else:
            near = 2e-2 * float(want.abs().max())
            bucket = (DELTA if mode.startswith("full") else 1.0) * float(
                v.float().abs().max())
            far = float((diff > near).float().mean())
            tol = (f"{near:.4g} (2e-2 of max|plain|) plus one bucket "
                   f"({bucket:.4g}) on at most 1e-3 of the elements")
            ok = err <= near + bucket and far <= 1e-3
        check(ok, f"flash_epilogue {mode}: max abs err {err} over {tol}")
        del got, want, diff
        t = timed[mode]
        row = {"phase": "flash_epilogue", "mode": mode,
               "shape": list(P_SHAPE), "max_abs_err": err, "tolerance": tol,
               "ok": ok, "ms": t["ms"],
               "ms_minus_fp_postnorm": t["ms_minus_fp_postnorm"],
               "plain_ms": _graph_ms([lambda s=s: flash_epilogue_plain(
                   *s, scale=scale, mode=mode) for s in sets], min_calls=2),
               "library_ms": _graph_ms([lambda s=s: sdpa(
                   *(a.transpose(1, 2) for a in s), scale=scale)
                   for s in sets], min_calls=10)
               if mode in ("fp_postnorm", "fp_prenorm") else None,
               **{key: t[key] for key in ("bytes_ms", "flops_ms", "exp_ms",
                                          "bound_ms", "bound_by")},
               "launches_in_entry_point_run": launches}
        _emit(row)
        rows.append(row)
    del sets, q, k, v
    return rows


def _p_row(rows, launches) -> dict:
    """P's kernels-line row: sums over its nine modes, one call each."""
    tot = lambda key: sum(r[key] for r in rows)
    fp = [r["library_ms"] for r in rows if r["library_ms"] is not None]
    return {
        "name": "flash_epilogue", "route": "cuda",
        "source": "qdiffusion_torch/csrc/flash_attention.cu",
        "replaces": "scripts/bench_flash_epilogue.py:77",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"),
        "bound_ms": tot("bound_ms"), "bound_by": rows[0]["bound_by"],
        # SDPA computes two of the nine functions only
        "library_ms": None, "sdpa_ms_fp_modes": fp,
        "ms_by_mode": {r["mode"]: r["ms"] for r in rows},
        "per": f"the sum over P's nine modes at {P_SHAPE} bf16, one call "
               "each; CUDA graph"}


def phase_sd_files(task, work: Path, check: Checks) -> dict:
    """Seeded UNet / VAE / CLIP npz files in the JAX formats, the CLIP
    token ids and the W4 'mse' weight qstate, as a user would bring them."""
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.convert import to_jax_params
    from qdiffusion_torch.models.clip_text import CLIPTextEncoder
    from qdiffusion_torch.models.vae import VAE
    from qdiffusion_torch.utils.checkpoints import save_nested, \
        save_pytree, save_qstate

    t0 = time.perf_counter()
    unet = _sd_unet(task, weight_bit=4)
    unet.load_state_dict(unet.init_params(0))
    save_pytree(work / "unet.npz", to_jax_params(unet.state_dict()))
    t1 = time.perf_counter()
    q = init_weight_qstate(unet)
    torch.cuda.synchronize()
    mse_s = time.perf_counter() - t1
    save_qstate(work / "w4_qstate.npz", q)
    del unet, q
    vae = VAE(task.vae)
    vae.load_state_dict(vae.init_params(1))
    save_nested(work / "vae.npz", to_jax_params(vae.state_dict()))
    clip = CLIPTextEncoder(task.clip)
    clip.load_state_dict(clip.init_params(2))
    save_nested(work / "clip.npz", to_jax_params(clip.state_dict()))
    del vae, clip
    rng = np.random.default_rng(3)
    bos, eos = 49406, 49407  # CLIP's start and end (pad) token ids
    cond = np.full((1, 77), eos, np.int64)
    cond[0, 0] = bos
    cond[0, 1:12] = rng.integers(0, bos, 11)
    uncond = np.full((1, 77), eos, np.int64)
    uncond[0, 0] = bos
    np.savez(work / "token_ids.npz", cond=cond, uncond=uncond)
    torch.cuda.empty_cache()
    row = {"phase": "sd_files", "seconds": time.perf_counter() - t0,
           "w4_mse_qstate_seconds": mse_s,
           "mib": {f.name: f.stat().st_size / 2**20
                   for f in sorted(work.glob("*.npz"))}}
    _emit(row)
    return row


def phase_sd_fold_cli(task, work: Path, spy: dict, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention
    from qdiffusion_torch.ops.groupnorm import fused_group_norm

    batches = SD_N // SD_BATCH
    calls = SD_STEPS + 1  # PLMS evaluates the first step twice
    unet, dec = spy["unet_call"], spy["decode"]
    want = {k: batches * (calls * unet[k] + dec[k]) for k in unet}
    counters = {"group_norm": fused_group_norm,
                "flash_attention": flash_attention,
                "flash_streaming": streaming_flash_attention}
    for f in counters.values():
        f.launches = 0
    res = cli.main(["sample", "--task", "sd_v1",
                    "--ckpt", str(work / "unet.npz"),
                    "--vae-ckpt", str(work / "vae.npz"),
                    "--clip-ckpt", str(work / "clip.npz"),
                    "--token-ids", str(work / "token_ids.npz"),
                    "--qstate", str(work / "w4_qstate.npz"),
                    "--weight-bit", "4", "--engine", "fold",
                    "--dtype", "bfloat16", "--n", str(SD_N),
                    "--batch", str(SD_BATCH),
                    "--npz-out", str(work / "sd_fold.npz"),
                    "--device", "cuda"])
    launches = {k: f.launches for k, f in counters.items()}
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    check(imgs.shape == (SD_N, 512, 512, 3) and imgs.dtype == np.uint8,
          f"sd fold npz {imgs.shape} {imgs.dtype}")
    check(res["nonfinite"] == 0, f"sd fold: {res['nonfinite']} non-finite")
    check(res["sampler"] == "plms" and res["guidance_scale"] == 7.5
          and res["steps"] == SD_STEPS, f"sd fold ran {res['sampler']} "
          f"{res['steps']} steps at scale {res['guidance_scale']}")
    check(res["model_calls"] == [calls] * batches,
          f"sd fold: UNet calls per batch {res['model_calls']}")
    check(launches == want, f"sd fold launches {launches}, expected {want}")
    secs, dec_s = res["batch_seconds"], res["decode_seconds"]
    row = {"phase": "sd_fold_cli", "n": SD_N, "batch": SD_BATCH,
           "steps": SD_STEPS, "guidance_scale": res["guidance_scale"],
           "batch_seconds": secs, "decode_seconds": dec_s,
           "img_per_s": SD_BATCH / secs[-1],
           "s_per_unet_call": (secs[-1] - dec_s[-1]) / calls,
           "first_batch_img_per_s": SD_BATCH / secs[0],
           "unet_calls": res["model_calls"], "launches": launches,
           "expected_launches": want,
           "image_mean": float(imgs.mean()), "image_std": float(imgs.std())}
    _emit(row)
    return row


def phase_sd_card_vs_cpu(task, work: Path, check: Checks) -> dict:
    """One fold W4 UNet call with context at 32x32 latents, batch 2: card
    bf16 (B1, and B2 at the five 1024-token sites) against CPU f32."""
    from qdiffusion_torch.cli import load_fp_params
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.deploy import fold_weights
    from qdiffusion_torch.models.unet_ldm import LDMUNet
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.utils.checkpoints import load_qstate

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(
        np.float32))
    t = torch.tensor([10.0, 500.0])
    c = torch.from_numpy(rng.standard_normal((2, 77, 768)).astype(
        np.float32))
    eps, b2 = {}, 0
    for dev, dtype in (("cpu", None), ("cuda", torch.bfloat16)):
        model = LDMUNet(task.unet_ldm, QuantFlags(weight_bit=4).policy_ldm(),
                        device=dev)
        model.load_state_dict(load_fp_params(work / "unet.npz", model))
        model.load_state_dict(fold_weights(
            model, load_qstate(work / "w4_qstate.npz", dev)))
        xin = x.to(dev)
        if dtype is not None:
            model.to(dtype)
            xin = xin.to(dtype)
        n = flash_attention.launches
        with torch.no_grad():
            eps[dev] = model(xin, t.to(dev), None, c.to(dev)).float().cpu()
        b2 = flash_attention.launches - n if dev == "cuda" else b2
        del model
    ref, got = eps["cpu"], eps["cuda"]
    rel = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    check(bool(torch.isfinite(got).all()), "sd card UNet call not finite")
    check(b2 == 5, f"sd card vs CPU: {b2} B2 launches, expected 5")
    check(rel <= REL_L2_CARD_VS_CPU,
          f"sd card bf16 vs CPU f32 fold call: relative L2 {rel}")
    row = {"phase": "sd_card_vs_cpu", "batch": 2, "latent": 32,
           "rel_l2": rel, "tolerance": REL_L2_CARD_VS_CPU,
           "flash_attention_launches": b2,
           "max_abs_err": float((got - ref).abs().max()),
           "ref_abs_max": float(ref.abs().max())}
    _emit(row)
    return row


def phase_sd_sim(task, work: Path, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.cli import load_fp_params
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention
    from qdiffusion_torch.utils.checkpoints import save_qstate

    flags = dict(weight_bit=8, quant_act=True, act_bit=8)
    model = _sd_unet(task, **flags)
    model.load_state_dict(load_fp_params(work / "unet.npz", model))
    t0 = time.perf_counter()
    xs, ts, cs = _sd_inputs(task, 2, seed=5)
    qstate = init_act_qstate(model, init_weight_qstate(model), xs, ts, cs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_act = sum(1 for slots in qstate.values() for s in slots
                if s not in ("w", "w0"))
    check(n_act > 0, "sd sim: no activation quantizer initialised")
    save_qstate(work / "w8a8_qstate.npz", qstate)

    model.to(torch.bfloat16)
    step = make_quantized_step(model, qstate, engine="sim")
    x, t, c = _sd_inputs(task, 2 * SD_BATCH, seed=6, dtype=torch.bfloat16)
    n_sm = flash_attention.launches_sm_q
    eps = step(x, t, c)
    torch.cuda.synchronize()
    step_sm = flash_attention.launches_sm_q - n_sm
    check(tuple(eps.shape) == tuple(x.shape)
          and bool(torch.isfinite(eps).all()), "sd sim bf16 step output")
    check(step_sm == 10, f"sd sim step: {step_sm} B2 launches with sm_q, "
                         "expected 10")
    step_ms = _time_ms(lambda: step(x, t, c), reps=2)
    del model, step, eps
    torch.cuda.empty_cache()

    n_sm = flash_attention.launches_sm_q
    n3 = streaming_flash_attention.launches
    res = cli.main(["sample", "--task", "sd_v1",
                    "--ckpt", str(work / "unet.npz"),
                    "--vae-ckpt", str(work / "vae.npz"),
                    "--clip-ckpt", str(work / "clip.npz"),
                    "--token-ids", str(work / "token_ids.npz"),
                    "--qstate", str(work / "w8a8_qstate.npz"),
                    "--weight-bit", "8", "--quant-act", "--act-bit", "8",
                    "--engine", "sim", "--dtype", "float32",
                    "--n", str(SD_BATCH), "--batch", str(SD_BATCH),
                    "--timesteps", "5",
                    "--npz-out", str(work / "sd_sim.npz"),
                    "--device", "cuda"])
    cli_sm = flash_attention.launches_sm_q - n_sm
    cli_b3 = streaming_flash_attention.launches - n3
    check(res["nonfinite"] == 0, f"sd sim PLMS: {res['nonfinite']} "
                                 "non-finite")
    check(res["model_calls"] == [6], f"sd sim PLMS-5 calls "
                                     f"{res['model_calls']}")
    check(cli_sm == 60 and cli_b3 == 1,
          f"sd sim PLMS-5: {cli_sm} B2 launches with sm_q (expected 60), "
          f"{cli_b3} B3 (expected 1)")
    row = {"phase": "sd_sim", "act_quantizers": n_act,
           "act_init_seconds": init_s, "bf16_step_batch": 2 * SD_BATCH,
           "bf16_step_ms": step_ms, "bf16_step_b2_sm_q_launches": step_sm,
           "plms5_f32_seconds": res["batch_seconds"][0],
           "plms5_decode_seconds": res["decode_seconds"][0],
           "plms5_b2_sm_q_launches": cli_sm, "plms5_b3_launches": cli_b3}
    _emit(row)
    return row


def phase_sd_profile(task, work: Path, out: Path) -> dict:
    """Three bf16 fold W4 UNet calls at the CFG batch, with context."""
    from qdiffusion_torch.cli import load_fp_params
    from qdiffusion_torch.deploy import fold_weights
    from qdiffusion_torch.utils.checkpoints import load_qstate

    model = _sd_unet(task, weight_bit=4)
    model.load_state_dict(load_fp_params(work / "unet.npz", model))
    model.load_state_dict(fold_weights(model, load_qstate(
        work / "w4_qstate.npz", "cuda")))
    model.to(torch.bfloat16)
    x, t, c = _sd_inputs(task, 2 * SD_BATCH, dtype=torch.bfloat16)

    def run():
        with torch.no_grad():
            model(x, t, None, c)

    row = {"phase": "sd_profile", **profile_breakdown(
        run, 3, out / "sd_unet_call_trace.json",
        f"SD v1 fold W4 bf16 UNet call, batch {2 * SD_BATCH} (CFG)")}
    _emit(row)
    return row


# -- the int8 and stream deployment engines (B4, B5, B6) ---------------------

def b4_spy() -> Spy:
    """Every B4 call of the int8 engine (ops/int8.py's dispatch): (M, K,
    N) of the product."""
    import qdiffusion_torch.ops.int8 as int8

    return Spy([(int8, "int8_dense_pallas")],
               lambda a, kw: (a[0].shape[0], a[0].shape[1], a[1].shape[1]))


def stream_spy() -> Spy:
    """Every B5 / B6 call of the stream engine, as (M, K, N), and every
    streamed conv, as the shape of its input."""
    import qdiffusion_torch.ops.qlayers as ql

    def record(a, kw):
        if isinstance(a[0], dict):  # _stream_conv2d(packed, x)
            return tuple(a[1].shape)
        return (a[0].numel() // a[0].shape[-1], a[0].shape[-1],
                a[1].shape[1])

    return Spy([(ql, "int8_dense_stream"), (ql, "int4_dense_stream"),
                (ql, "_stream_conv2d")], record)


def _calls(seen, name) -> list:
    return [r for n, r in seen if n == name]


def int8_setup(task, out: Path, check: Checks) -> dict:
    """The CLI's W4A8 split-shortcut CIFAR model (seeded), its activation
    qstate from 8 inputs (saved for the CLI), and one int8 step at batch
    64 under the B4 spy."""
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step, pack_model
    from qdiffusion_torch.utils.checkpoints import save_qstate

    model = _seeded_model(task, weight_bit=4, quant_act=True, split=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = torch.randn((8, 32, 32, 3), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (8,), generator=gen, device="cuda").float()
    qstate = init_act_qstate(model, init_weight_qstate(model), xs, ts)
    save_qstate(out / "w4a8_qstate.npz", qstate)
    packed = pack_model(model, qstate)
    segments = sum(len(p.segments) for p in packed.values())
    check(len(packed) == 113 and segments == 125,
          f"int8: {len(packed)} packed sites, {segments} segments "
          "(expected 113, 125)")
    step = make_quantized_step(model, qstate, engine="int8")
    x = torch.randn((BATCH, 32, 32, 3), generator=gen, device="cuda")
    t = torch.full((BATCH,), 500.0, device="cuda")
    with b4_spy() as spy:
        eps = step(x, t)
    torch.cuda.synchronize()
    check(tuple(eps.shape) == (BATCH, 32, 32, 3)
          and bool(torch.isfinite(eps).all()), "int8 step output")
    shapes = _calls(spy.seen, "int8_dense_pallas")
    check(len(shapes) == segments, f"int8 step: {len(shapes)} B4 calls, "
                                   f"expected {segments}")
    row = {"phase": "int8_spy", "packed_sites": len(packed),
           "b4_per_step": len(shapes), "distinct_shapes": len(set(shapes)),
           "step_ms": _time_ms(lambda: step(x, t), reps=3)}
    _emit(row)
    return {"model": model, "qstate": qstate, "step": step, "x": x, "t": t,
            "shapes": shapes, "row": row}


def sd_stream_spy(task, work: Path, wbits: int, check: Checks,
                  profile_to: Path = None) -> dict:
    """One SD stream UNet call at batch 2 with context (f32, the CLI's
    stream_convs=True) under spies of B5/B6, the streamed convs, B1 and
    B2/B3. W8 writes its 'mse' weight qstate first. profile_to: also
    profile three such calls."""
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.cli import load_fp_params
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.utils.checkpoints import load_qstate, save_qstate

    model = _sd_unet(task, weight_bit=wbits)
    model.load_state_dict(load_fp_params(work / "unet.npz", model))
    qpath = work / f"w{wbits}_qstate.npz"
    if not qpath.exists():
        save_qstate(qpath, init_weight_qstate(model))
    step = make_quantized_step(model, load_qstate(qpath, "cuda"),
                               engine="stream", stream_convs=True)
    x, t, c = _sd_inputs(task, 2, seed=8)
    with stream_spy() as spy, gn_spy() as gn, attn_spy() as att:
        eps = step(x, t, c)
    torch.cuda.synchronize()
    check(tuple(eps.shape) == tuple(x.shape)
          and bool(torch.isfinite(eps).all()), f"sd stream W{wbits} call")
    kernel = "int4_dense_stream" if wbits == 4 else "int8_dense_stream"
    convs = _calls(spy.seen, "_stream_conv2d")
    conv_sites = sum(1 for n, cfg in model.layer_cfgs.items()
                     if model.get_submodule(n).weight.ndim == 4)
    res = {"wbits": wbits, "shapes": _calls(spy.seen, kernel),
           "other_kernel_calls": len(spy.seen) - len(convs)
           - len(_calls(spy.seen, kernel)),
           "streamed_convs": len(convs), "conv_sites": conv_sites,
           "streamed_conv_inputs": sorted(set(convs)),
           "unet_call": {"group_norm": len(gn.seen),
                         "flash_attention": len(_calls(att.seen,
                                                       "flash_attention")),
                         "flash_streaming": len(_calls(
                             att.seen, "streaming_flash_attention"))}}
    check(res["shapes"] and res["other_kernel_calls"] == 0,
          f"sd stream W{wbits}: {len(res['shapes'])} {kernel} calls, "
          f"{res['other_kernel_calls']} of the other kernel")
    check(0 < len(convs) < conv_sites, f"sd stream W{wbits}: {len(convs)} "
          f"of {conv_sites} conv sites stream")
    prof = None
    if profile_to is not None:
        def run():
            step(x, t, c)
        prof = profile_breakdown(
            run, 3, profile_to / "sd_stream_w4_call_trace.json",
            f"SD v1 stream W{wbits} f32 UNet call, batch 2 (CFG of batch 1)")
        _emit({"phase": "sd_stream_profile", **prof})
    _emit({"phase": "sd_stream_spy", "per_call": len(res["shapes"]),
           "distinct_shapes": len(set(res["shapes"])),
           **{k: v for k, v in res.items() if k != "shapes"}})
    del model, step, eps
    torch.cuda.empty_cache()
    return {**res, "profile": prof}


def _counts(shapes) -> dict:
    out: dict = {}
    for s in shapes:
        out[s] = out.get(s, 0) + 1
    return out


def _b4_case(M, K, N, gen, check) -> dict:
    from qdiffusion_torch.ops.int8_matmul import int8_dense_pallas, \
        int8_matmul_dequant, int8_matmul_plain

    def ints(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    x, w = ints(M, K), ints(K, N)
    a = 1e-4 + 1e-3 * torch.rand(N, generator=gen, device="cuda")
    bc = 1e-3 * torch.randn(N, generator=gen, device="cuda")
    c = torch.randn(N, generator=gen, device="cuda")
    got = int8_dense_pallas(x, w, a, bc, c)
    want = int8_matmul_plain(x, w, a, bc, c)
    one, zero = torch.ones(N, device="cuda"), torch.zeros(N, device="cuda")
    acc = int8_matmul_dequant(x, w, one, zero, zero)
    exact = torch.matmul(x.double(), w.double())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    acc_exact = float(exact.abs().max()) < 2**24 and bool(
        torch.equal(acc.double(), exact))
    ok = acc_exact and rel <= B4_REL
    check(ok, f"int8_matmul {(M, K, N)}: int32 product exact {acc_exact}, "
              f"output rel err {rel} over {B4_REL}")
    del got, want, acc, exact
    # (x, w) sets cycled so that neither operand stays in the L2
    sets = rotations(lambda: (x.clone(), w.clone()), M * K + K * N, cap=32)
    # torch._int_mm wants M > 16 and K, N multiples of 8: zero-pad
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    pad = torch.nn.functional.pad
    lib_sets = [(pad(xx, (0, Kp - K, 0, Mp - M)), pad(ww, (0, Np - N, 0,
                                                          Kp - K)))
                for xx, ww in sets]
    ap, bp, cp = (pad(v, (0, Np - N)) for v in (a, bc, c))

    def library(xp, wp):
        acc = torch._int_mm(xp, wp)
        s = xp.float().sum(dim=-1, keepdim=True)
        return acc.float() * ap + s * bp + cp

    try:
        lib_ms = _graph_ms([lambda s=s: library(*s) for s in lib_sets])
        lib_note = "torch._int_mm + torch epilogue"
    except RuntimeError as e:  # a yardstick only: record why it is missing
        lib_ms, lib_note = None, f"torch._int_mm refused: {str(e)[:120]}"
    del lib_sets
    return {
        "max_abs_err": err, "rel_err": rel, "int32_exact": acc_exact,
        "tolerance": f"int32 product exact, output {B4_REL} relative",
        "ok": ok,
        "ms": _graph_ms([lambda s=s: int8_dense_pallas(*s, a, bc, c)
                         for s in sets]),
        "plain_ms": _graph_ms([lambda s=s: int8_matmul_plain(*s, a, bc, c)
                               for s in sets], min_calls=5),
        "library_ms": lib_ms, "library": lib_note,
        **bound(M * K + K * N + 4 * M * N, 2 * M * N * K / INT8_OPS * 1e3)}


def _stream_case(kernel, M, K, N, gen, check) -> dict:
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream, \
        int4_stream_plain, unpack_int4_weight
    from qdiffusion_torch.ops.int8_matmul import int8_dense_stream, \
        int8_stream_plain

    int4 = kernel == "int4_stream_matmul"
    x = torch.randn((M, K), generator=gen, device="cuda")  # f32, as the
    # stream engine's f32 activations reach it
    if int4:
        w = torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda",
                          dtype=torch.uint8)
    else:
        w = torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
    scale = 1e-4 + 1e-3 * torch.rand(N, generator=gen, device="cuda")
    shift = 1e-2 * torch.randn(N, generator=gen, device="cuda")
    bias = torch.randn(N, generator=gen, device="cuda")
    fn, plain = (int4_dense_stream, int4_stream_plain) if int4 else (
        int8_dense_stream, int8_stream_plain)
    got = fn(x, w, scale, shift, bias=bias)
    want = plain(x, w, scale, shift, bias)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    ok = rel <= STREAM_REL
    check(ok, f"{kernel} {(M, K, N)}: rel err {rel} over {STREAM_REL}")
    del got, want
    # (x, w) sets cycled so that neither operand stays in the L2; the
    # library call multiplies bf16 x by the fold engine's bf16 weight
    sets = rotations(lambda: (x.clone(), w.clone()), 4 * M * K + w.numel(),
                     cap=32)

    def folded(ww):
        wf = unpack_int4_weight(ww).float() if int4 else ww.float()
        return (wf * scale + shift).to(torch.bfloat16)

    lib_sets = [(xx.to(torch.bfloat16), folded(ww)) for xx, ww in sets]
    row = {
        "max_abs_err": err, "rel_err": rel,
        "tolerance": f"{STREAM_REL} of the largest output", "ok": ok,
        "ms": _graph_ms([lambda s=s: fn(*s, scale, shift, bias=bias)
                         for s in sets]),
        "plain_ms": _graph_ms([lambda s=s: plain(*s, scale, shift, bias)
                               for s in sets], min_calls=5),
        "library_ms": _graph_ms([lambda s=s: torch.matmul(*s)
                                 for s in lib_sets]),
        "library": "torch.matmul(bf16 x, bf16 folded weight)",
        # x arrives in f32 on this path: 4 bytes per element read
        **bound(4 * M * K + w.numel() + 4 * M * N,
                2 * M * N * K / BF16_FLOPS * 1e3)}
    del sets, lib_sets
    return row


def phase_int_kernels(b4: list, b5: list, b6: list, check: Checks) -> list:
    """B4 at every distinct (M, K, N) of one CIFAR int8 step, B5 / B6 at
    every distinct one of one SD stream UNet call (call-order lists, so a
    shape's multiplicity is its count per step / call)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for kernel, shapes, where in (
            ("int8_matmul", b4, f"cifar10 W4A8 int8 step, batch {BATCH}"),
            ("int8_stream_matmul", b5, "sd_v1 stream W8 UNet call, batch 2"),
            ("int4_stream_matmul", b6, "sd_v1 stream W4 UNet call, batch 2")):
        for (M, K, N), per_call in _counts(shapes).items():
            case = _b4_case(M, K, N, gen, check) if kernel == "int8_matmul" \
                else _stream_case(kernel, M, K, N, gen, check)
            row = {"phase": "int_kernel", "kernel": kernel, "where": where,
                   "shape": [M, K, N], "per_call": per_call, **case}
            _emit(row)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def phase_int8_cli(task, out: Path, setup: dict, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.ops.int8_matmul import int8_matmul_dequant

    per_step = len(setup["shapes"])
    batches = INT8_N // BATCH
    fused_group_norm.launches = int8_matmul_dequant.launches = 0
    res = cli.main(["sample", "--task", "cifar10",
                    "--qstate", str(out / "w4a8_qstate.npz"),
                    "--weight-bit", "4", "--quant-act", "--split",
                    "--engine", "int8", "--n", str(INT8_N),
                    "--batch", str(BATCH), "--npz-out", str(out / "int8.npz"),
                    "--device", "cuda"])
    launches = {"int8_matmul": int8_matmul_dequant.launches,
                "group_norm": fused_group_norm.launches}
    want = {"int8_matmul": batches * STEPS * per_step,
            "group_norm": batches * STEPS * 51}
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    check(imgs.shape == (INT8_N, 32, 32, 3) and imgs.dtype == np.uint8,
          f"int8 npz {imgs.shape} {imgs.dtype}")
    check(res["nonfinite"] == 0, f"int8: {res['nonfinite']} non-finite")
    check(res["steps"] == STEPS and res["engine"] == "int8",
          f"int8 ran {res['steps']} steps on {res['engine']}")
    check(launches == want, f"int8 launches {launches}, expected {want}")
    secs = res["batch_seconds"]
    row = {"phase": "int8_cli", "n": INT8_N, "batch": BATCH, "steps": STEPS,
           "batch_seconds": secs, "img_per_s": BATCH / secs[-1],
           "ms_per_step": secs[-1] / STEPS * 1e3,
           "first_batch_img_per_s": BATCH / secs[0], "launches": launches,
           "expected_launches": want, "image_mean": float(imgs.mean()),
           "image_std": float(imgs.std())}
    _emit(row)
    return row


class QuantRecorder:
    """Records every activation quantization of the int8 engine, as (f32
    input, int8 output, delta) on the CPU, for the length of a `with`."""

    def __enter__(self):
        import qdiffusion_torch.ops.int8 as int8

        self.mod, self.real, self.rec = int8, int8.quantize_act, []

        def spy(x, seg):
            q = self.real(x, seg)
            self.rec.append((x.float().cpu(), q.cpu(), float(seg.a_delta)))
            return q

        int8.quantize_act = spy
        return self

    def __exit__(self, *exc):
        self.mod.quantize_act = self.real


def phase_int8_card_vs_cpu(task, out: Path, setup: dict,
                           check: Checks) -> dict:
    """One int8 step at batch 2: the card's bf16 and f32 carriers against
    the CPU's f32 carrier, each int8 activation of the f32 steps held to
    one bucket beyond its input's drift, and the card's f32 carrier
    against the card's sim step."""
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.utils.checkpoints import load_qstate

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    t = torch.tensor([10.0, 500.0])
    cpu_model = _seeded_model(task, "cpu", weight_bit=4, quant_act=True,
                              split=True)
    with QuantRecorder() as rec_cpu:
        ref = make_quantized_step(cpu_model, load_qstate(
            out / "w4a8_qstate.npz", "cpu"), engine="int8",
            carrier_dtype=torch.float32)(x, t)
    del cpu_model
    model, q = setup["model"], setup["qstate"]
    xc, tc = x.cuda(), t.cuda()
    eps = {"bf16": make_quantized_step(model, q, engine="int8")(xc, tc),
           "sim": make_quantized_step(model, q, engine="sim")(xc, tc)}
    with QuantRecorder() as rec_card:
        eps["f32"] = make_quantized_step(
            model, q, engine="int8", carrier_dtype=torch.float32)(xc, tc)
    eps = {k: v.float().cpu() for k, v in eps.items()}

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    sites_ok = len(rec_card.rec) == len(rec_cpu.rec) > 0
    flips = total = 0
    for (xg, qg, delta), (xr, qr, _) in zip(rec_card.rec, rec_cpu.rec):
        dq = (qg.int() - qr.int()).abs()
        sites_ok &= xg.shape == xr.shape and bool(
            (dq <= (xg - xr).abs() / delta + 1 + 1e-5).all())
        flips += int((dq > 0).sum())
        total += dq.numel()
    first_exact = sites_ok and bool(torch.equal(rec_card.rec[0][1],
                                                rec_cpu.rec[0][1]))
    row = {"phase": "int8_card_vs_cpu", "batch": 2,
           "rel_l2_card_bf16_vs_cpu_f32": rel(eps["bf16"], ref),
           "rel_l2_card_f32_vs_cpu_f32": rel(eps["f32"], ref),
           "rel_l2_card_f32_vs_card_sim": rel(eps["f32"], eps["sim"]),
           "tolerance": REL_L2_INT8,
           "quantized_sites": len(rec_card.rec),
           "sites_within_one_bucket": sites_ok,
           "first_site_exact": first_exact,
           "int8_values_apart": flips, "int8_values": total}
    check(all(bool(torch.isfinite(e).all()) for e in eps.values()),
          "int8 batch-2 steps not finite")
    check(sites_ok and first_exact, f"int8 card vs CPU: {len(rec_card.rec)}"
          f" vs {len(rec_cpu.rec)} quantized sites, within one bucket "
          f"{sites_ok}, first site exact {first_exact}")
    for key in ("rel_l2_card_bf16_vs_cpu_f32", "rel_l2_card_f32_vs_cpu_f32",
                "rel_l2_card_f32_vs_card_sim"):
        check(row[key] <= REL_L2_INT8, f"int8 {key}: {row[key]} over "
                                       f"{REL_L2_INT8}")
    _emit(row)
    return row


def phase_sd_stream_cli(task, work: Path, spy: dict, st: dict,
                        check: Checks) -> dict:
    """`cli sample --engine stream --stream-convs` at W4 (PLMS-50) and W8
    (PLMS-5), batch 1 with CFG; launch counts against the spies."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.ops.int4_matmul import int4_stream_matmul
    from qdiffusion_torch.ops.int8_matmul import int8_stream_matmul

    counters = {"group_norm": fused_group_norm,
                "flash_attention": flash_attention,
                "flash_streaming": streaming_flash_attention,
                "int4_stream_matmul": int4_stream_matmul,
                "int8_stream_matmul": int8_stream_matmul}
    batches = STREAM_N // STREAM_BATCH
    out = {}
    for wbits, steps in ((4, SD_STEPS), (8, 5)):
        s = st[wbits]
        calls = steps + 1  # PLMS evaluates the first step twice
        unet = {**s["unet_call"],
                "int4_stream_matmul": len(s["shapes"]) if wbits == 4 else 0,
                "int8_stream_matmul": len(s["shapes"]) if wbits == 8 else 0}
        dec = {**spy["decode"], "int4_stream_matmul": 0,
               "int8_stream_matmul": 0}
        want = {k: batches * (calls * unet[k] + dec[k]) for k in counters}
        for f in counters.values():
            f.launches = 0
        res = cli.main(["sample", "--task", "sd_v1",
                        "--ckpt", str(work / "unet.npz"),
                        "--vae-ckpt", str(work / "vae.npz"),
                        "--clip-ckpt", str(work / "clip.npz"),
                        "--token-ids", str(work / "token_ids.npz"),
                        "--qstate", str(work / f"w{wbits}_qstate.npz"),
                        "--weight-bit", str(wbits), "--engine", "stream",
                        "--stream-convs", "--timesteps", str(steps),
                        "--n", str(STREAM_N), "--batch", str(STREAM_BATCH),
                        "--npz-out", str(work / f"sd_stream_w{wbits}.npz"),
                        "--device", "cuda"])
        launches = {k: f.launches for k, f in counters.items()}
        with np.load(res["path"]) as f:
            imgs = f["arr_0"]
        tag = f"sd stream W{wbits}"
        check(imgs.shape == (STREAM_N, 512, 512, 3)
              and imgs.dtype == np.uint8, f"{tag} npz {imgs.shape}")
        check(res["nonfinite"] == 0, f"{tag}: {res['nonfinite']} non-finite")
        check(res["sampler"] == "plms" and res["guidance_scale"] == 7.5
              and res["model_calls"] == [calls] * batches,
              f"{tag}: {res['sampler']} {res['model_calls']} calls at "
              f"scale {res['guidance_scale']}")
        check(launches == want, f"{tag} launches {launches}, expected {want}")
        kernel = "int4_stream_matmul" if wbits == 4 else "int8_stream_matmul"
        check(launches[kernel] > 0, f"{tag}: {kernel} not launched")
        secs, dec_s = res["batch_seconds"], res["decode_seconds"]
        row = {"phase": "sd_stream_cli", "weight_bit": wbits, "n": STREAM_N,
               "batch": STREAM_BATCH, "steps": steps,
               "batch_seconds": secs, "decode_seconds": dec_s,
               "img_per_s": STREAM_BATCH / secs[-1],
               "ms_per_unet_call": (secs[-1] - dec_s[-1]) / calls * 1e3,
               "unet_calls": res["model_calls"], "launches": launches,
               "expected_launches": want,
               "streamed_convs": s["streamed_convs"],
               "conv_sites": s["conv_sites"],
               "image_mean": float(imgs.mean()),
               "image_std": float(imgs.std())}
        _emit(row)
        out[wbits] = row
    return out


def phase_int8_profile(setup: dict, out: Path) -> dict:
    """Three CIFAR W4A8 int8 steps at batch 64 (bf16 carrier)."""
    step, x, t = setup["step"], setup["x"], setup["t"]
    row = {"phase": "int8_profile", **profile_breakdown(
        lambda: step(x, t), 3, out / "int8_step_trace.json",
        f"CIFAR-10 W4A8 int8 step, batch {BATCH}")}
    _emit(row)
    return row


def _int_row(rows, name, replaces, launches, per):
    """A kernels-line row: per-call sums over the shapes of `name`."""
    sel = [r for r in rows if r["kernel"] == name]
    tot = lambda key: sum(r[key] * r["per_call"] for r in sel)
    by_bytes = sum(r["bound_ms"] * r["per_call"] for r in sel
                   if r["bound_by"] == "bytes")
    return {
        "name": name, "route": "cuda",
        "source": "qdiffusion_torch/csrc/int_matmul.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in sel),
        "max_rel_err": max(r["rel_err"] for r in sel),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"),
        "bound_ms": tot("bound_ms"),
        "bound_by": "bytes" if by_bytes >= tot("bound_ms") / 2
        else "operations",
        "library_ms": None if any(r["library_ms"] is None for r in sel)
        else tot("library_ms"),
        "per": per, "shapes": len(sel)}


def _gn_row(rows, where, per, launches):
    bytes_ms = per_call_sum(rows, "bytes_ms")
    ops_ms = per_call_sum(rows, "ops_ms")
    return {
        "name": "group_norm", "route": "triton",
        "source": "qdiffusion_torch/ops/groupnorm.py",
        "replaces": "qdiffusion_tpu/ops/pallas/groupnorm.py:116",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_call_sum(rows, "ms"),
        "plain_ms": per_call_sum(rows, "plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_call_sum(rows, "library_ms"),
        "per": per, "eager_ms": per_call_sum(rows, "eager_ms")}


def _attn_row(rows, name, source, replaces, launches, per):
    sel = [r for r in rows if r["kernel"] == name]
    main = [r for r in sel if r["dtype"] == "bfloat16" and not r["quant"]]
    bsum = lambda key: sum(r[key] * r["per_call"] for r in main)
    bytes_ms, ops_ms = bsum("bytes_ms"), bsum("ops_ms")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in sel),
        "ms": bsum("ms"), "plain_ms": bsum("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": bsum("library_ms"), "per": per}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = Path(__file__).resolve().parent
    p.add_argument("--out", default=str(root / "runs" / "chip_smoke"),
                   help="report.json and profiler traces")
    p.add_argument("--work", default=str(root / "runs" / "chip_smoke_work"),
                   help="the SD weight files (about 4.5 GB), removed at "
                        "the end")
    p.add_argument("--profile", action="store_true",
                   help="add torch.profiler breakdowns of a CIFAR fold "
                        "step, an SD fold UNet call, a CIFAR int8 step and "
                        "an SD stream W4 UNet call")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.config import PRESETS
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    t_start = time.perf_counter()
    out, work = Path(args.out), Path(args.work)
    out.mkdir(parents=True, exist_ok=True)
    work.mkdir(parents=True, exist_ok=True)
    check = Checks()
    resolve_device("cuda")  # pins cudnn / matmul TF32 off
    smi = nvidia_smi()
    import triton  # B1's compiler, on the card's machine

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    _emit({"phase": "device", "nvidia_smi": smi, **device,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "triton": triton.__version__,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    t0 = time.perf_counter()
    built = _cuda.build_all()
    ptxas = ptxas_report(_cuda.BUILD)
    _emit({"phase": "build", "nvcc_seconds": built,
           "wall_seconds": time.perf_counter() - t0,
           "directory": str(_cuda.BUILD), "arch": _cuda.ARCH,
           "ptxas": ptxas})

    # CIFAR-10, slice 1's path
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
    rows = phase_kernels([(BATCH,) + s[1:] for s in shapes], check,
                         where="cifar10 UNet step")
    fold = phase_fold(task, out, per_step, check)
    check(fold["group_norm_launches"] > 0, "cifar fold: B1 not launched")
    card_cpu = phase_card_vs_cpu(task, out, check)
    sim = phase_sim(task, out, per_step, check)
    prof = phase_profile(task, out) if args.profile else None
    torch.cuda.empty_cache()

    # Stable Diffusion v1, this slice's path
    sd = PRESETS["sd_v1"]
    spy = phase_sd_spy(sd, check)
    gn_unet = phase_kernels(spy["unet_gn_shapes"], check,
                            dtypes=(torch.bfloat16,), phase="gn_sd",
                            where="sd_v1 UNet call")
    gn_dec = phase_kernels(spy["decode_gn_shapes"], check,
                           dtypes=(torch.bfloat16,), phase="gn_sd",
                           where="sd_v1 VAE decode")
    attn = phase_attn_kernels(check)
    files = phase_sd_files(sd, work, check)
    sd_fold = phase_sd_fold_cli(sd, work, spy, check)
    sd_cpu = phase_sd_card_vs_cpu(sd, work, check)
    sd_sim = phase_sd_sim(sd, work, check)
    sd_prof = phase_sd_profile(sd, work, out) if args.profile else None
    sd_launches = sd_fold["launches"]
    for name, n in sd_launches.items():
        check(n > 0, f"sd fold: {name} not launched")

    # the int8 and stream deployment engines, this slice's paths
    i8 = int8_setup(task, out, check)
    st = {4: sd_stream_spy(sd, work, 4, check,
                           profile_to=out if args.profile else None),
          8: sd_stream_spy(sd, work, 8, check)}
    ints = phase_int_kernels(i8["shapes"], st[8]["shapes"], st[4]["shapes"],
                             check)
    int8_cli = phase_int8_cli(task, out, i8, check)
    int8_cpu = phase_int8_card_vs_cpu(task, out, i8, check)
    int8_prof = phase_int8_profile(i8, out) if args.profile else None
    i8_row, b4_per_step = i8["row"], len(i8["shapes"])
    del i8
    torch.cuda.empty_cache()
    sd_stream = phase_sd_stream_cli(sd, work, spy, st, check)
    for name, n in int8_cli["launches"].items():
        check(n > 0, f"int8 cli: {name} not launched")
    for wbits, row in sd_stream.items():
        for name in ("group_norm", "flash_attention", "flash_streaming"):
            check(row["launches"][name] > 0,
                  f"sd stream W{wbits}: {name} not launched")

    # P, slice 4's path: the epilogue probe on B2's bf16 kernel
    p_rows = phase_flash_epilogue(check)
    p_launches = p_rows[0]["launches_in_entry_point_run"]
    check(p_launches > 0, "flash_epilogue: not launched by its entry point")

    gn_sd = gn_unet + gn_dec
    kernels = [
        {**_gn_row(gn_sd, "sd",
                   f"the {len(spy['unet_gn_shapes'])} GroupNorms of one SD "
                   f"bf16 UNet call at batch {2 * SD_BATCH} plus the "
                   f"{len(spy['decode_gn_shapes'])} of one VAE decode at "
                   f"batch {SD_BATCH}; device time in a CUDA graph",
                   sd_launches["group_norm"]),
         "launches_by_path": {
             "cifar10_fold": fold["group_norm_launches"],
             "sd_v1_fold": sd_launches["group_norm"],
             "cifar10_int8": int8_cli["launches"]["group_norm"],
             "sd_v1_stream_w4": sd_stream[4]["launches"]["group_norm"],
             "sd_v1_stream_w8": sd_stream[8]["launches"]["group_norm"]},
         "cifar10_step_ms": per_call_sum(rows, "ms"),
         "cifar10_step_bound_ms": max(per_call_sum(rows, "bytes_ms"),
                                      per_call_sum(rows, "ops_ms"))},
        _attn_row(attn, "flash_attention",
                  "qdiffusion_torch/csrc/flash_attention.cu",
                  "qdiffusion_tpu/ops/pallas/flash_attention.py:170",
                  sd_launches["flash_attention"],
                  "the 10 flash sites of one SD bf16 UNet call at batch "
                  f"{2 * SD_BATCH} (5 x (8,4096,8,40), 5 x (8,1024,8,80)), "
                  "no quantizer; CUDA graph"),
        _attn_row(attn, "flash_streaming",
                  "qdiffusion_torch/csrc/flash_attention.cu",
                  "qdiffusion_tpu/ops/pallas/flash_streaming.py:153",
                  sd_launches["flash_streaming"],
                  f"the VAE mid attention of one bf16 decode at batch "
                  f"{SD_BATCH} (4,4096,1,512); CUDA graph"),
        _int_row(ints, "int8_matmul",
                 "qdiffusion_tpu/ops/pallas/int8_matmul.py:88",
                 int8_cli["launches"]["int8_matmul"],
                 f"the {b4_per_step} B4 calls of one CIFAR W4A8 int8 step "
                 f"at batch {BATCH}; CUDA graph over (x, w) sets"),
        _int_row(ints, "int8_stream_matmul",
                 "qdiffusion_tpu/ops/pallas/int8_matmul.py:216",
                 sd_stream[8]["launches"]["int8_stream_matmul"],
                 f"the {len(st[8]['shapes'])} B5 calls (streamed convs) of "
                 "one SD stream W8 f32 UNet call at batch 2; CUDA graph"),
        _int_row(ints, "int4_stream_matmul",
                 "qdiffusion_tpu/ops/pallas/int4_matmul.py:129",
                 sd_stream[4]["launches"]["int4_stream_matmul"],
                 f"the {len(st[4]['shapes'])} B6 calls (linears and "
                 "streamed convs) of one SD stream W4 f32 UNet call at "
                 "batch 2; CUDA graph"),
        _p_row(p_rows, p_launches),
    ]
    for row, key in ((kernels[1], "flash_attention"),
                     (kernels[2], "flash_streaming")):
        row["launches_by_path"] = {
            "sd_v1_fold": sd_launches[key],
            "sd_v1_stream_w4": sd_stream[4]["launches"][key],
            "sd_v1_stream_w8": sd_stream[8]["launches"][key]}
    report = {"device": device, "nvidia_smi": smi, "build": built,
              "ptxas": ptxas,
              "kernels": kernels, "kernel_shapes": rows, "gn_sd": gn_sd,
              "attn_kernels": attn, "fold": fold, "card_vs_cpu": card_cpu,
              "sim": sim, "profile": prof, "sd_spy": {
                  k: v for k, v in spy.items() if not k.endswith("shapes")},
              "sd_files": files, "sd_fold": sd_fold,
              "sd_card_vs_cpu": sd_cpu, "sd_sim": sd_sim,
              "sd_profile": sd_prof, "int8_spy": i8_row,
              "sd_stream_spy": {w: {k: v for k, v in r.items()
                                    if k != "shapes"} for w, r in st.items()},
              "int_kernels": ints, "int8_cli": int8_cli,
              "int8_card_vs_cpu": int8_cpu, "int8_profile": int8_prof,
              "sd_stream_cli": sd_stream, "flash_epilogue": p_rows,
              "failed": check.failed,
              "launch_totals": {
                  "flash_attention": flash_attention.launches,
                  "flash_streaming": streaming_flash_attention.launches},
              "seconds": time.perf_counter() - t_start}
    (out / "report.json").write_text(json.dumps(report, indent=1))
    shutil.rmtree(work, ignore_errors=True)
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
