#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (qdiffusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile] [--quality-only]

Builds the port's CUDA kernels (nvcc, one process per source, started
together) into qdiffusion_torch/_build/, then drives the main paths of
every ported slice through the entry points a user calls and holds
every kernel of them against its plain PyTorch version:

  The `quality` phase starts first, in a process of its own
  (`chip_smoke.py --quality-only`, report in DIR/quality/): it is
  host-bound and small on the card. Beside it run the build, the spies
  and `designs`, the SD files and sd_card_vs_cpu (8), which report no
  time, then calib, calib_act and export. The smoke then waits for the
  quality report and runs every other phase after it, alone, in the
  order below (1-4, 5-7, 9, calib_sd, 10-13, the samplers, LSUN, P).
  Every phase row emitted before the join is tagged `beside_quality`
  (its seconds shared the card and the host), and the quality row lists
  them (`beside`).
  First the GroupNorm shapes of a CIFAR step (batch 1, spy), of a TINY
  call of the quality harness and of an SD UNet call and decode (phase
  6's spy), then `designs`: every kernel whose design a check reads is
  launched once under torch.profiler before any CUDA graph exists in the
  process.
  CIFAR-10 (DDIMUNetConfig(), full width):
  1. kernels  - GroupNorm kernel B1 at every GroupNorm shape of the UNet
                at batch 64, bf16 and f32 (error, kernel / plain /
                F.group_norm device time in a CUDA graph over inputs that
                outgrow the L2, CUDA events, median; the device-memory
                bound; the plan's path, "rows" or "split", which the
                profiler's kernel names must show);
  2. fold     - `cli sample --task cifar10 --engine fold --weight-bit 4
                --dtype bfloat16 --n 128 --batch 64` (DDIM-100, the
                second batch timed), the B1 launch count against 100 x
                the per-step count;
  3. card/CPU - one fold step at batch 2, then a DPM-Solver sample
                (singlestep order 3, 6 steps: [3, 3]) at batch 2 on the
                same step, card bf16 against CPU f32 (5e-2 relative L2);
  4. sim      - W8A8, activation qstate from 8 inputs, one f32 step at
                batch 64 and a 10-step DDIM through the CLI.
  calib       - the AdaRound weight pass through the CLI: `make-cali-data
                --n 32 --timesteps 100`, `calibrate --weight-bit 4 --split
                --cali-st 8 --cali-n 8 --cali-batch-size 32 --cali-iters
                20` over all 38 units (reference: 256 x 20 samples,
                20,000 iterations), `sample --engine fold --qstate <run
                dir>/qstate.npz --n 64 --batch 64`; spies time each capture
                and reconstruction, count B1 launches (none inside a
                reconstruction; captures, trajectory and sample launch it)
                and hold each unit's hard-rounded block error to 1.02x
                nearest rounding's on its captured inputs, the sum strictly
                lower; then up.3.block.0 reconstructed on the card and on
                the CPU (50 iterations, same inputs and indices): losses
                within 1e-3 relative, hard roundings 99.9 % equal.
  calib_act   - the activation pass through the CLI on the calib phase's
                qstate and trajectory: `calibrate --resume-w <qstate>
                --quant-act --running-stat --weight-bit 4 --split
                --cali-iters-a 20` (W4A8, all 38 units; reference 5,000
                iterations); spies time the act init (64 rows, 51 B1
                launches), the EMA sweep (1 batch of 64, 51), the FP
                capture and each reconstruction (B1 0 launches inside),
                and hold each unit's act block error with its learned
                deltas to 1.02x its init/EMA deltas' on its captured FP
                inputs, the sum over those units strictly lower, wherever
                every trained delta is at least the learning rate (a
                post-softmax delta of a flat softmax may not be: Adam's
                first step overshoots it, in JAX too; such a unit's
                ratio is printed); the Fisher grads of mid.block_1 and
                down.1.attn.0 on the card against the CPU from the same
                16 rows, the CPU's fed the card's captures (1e-4 of the
                largest |g|; each device's own capture's gap printed
                beside it), and a 20-iteration fisher_diag
                reconstruction on the card (finite losses);
                a run with --run-dir whose spy raises in the 13th
                reconstruction, then the same command resuming from the
                marker (act, unit 7): 30 units, the restored sites
                bit-equal to the snapshot; `sample --engine int8 --quant-act
                --split` on the calibrated qstate, 64 images (B4 100 x 113
                and B1 100 x 51 launches), and the int8 eps of 8 held
                inputs against the FP eps, calibrated and init-only deltas.
  export      - `deploy.export_quantized_checkpoint` of the calib phase's
                W4 --split qstate (38 units) and its seeded params, then
                `load_quantized_checkpoint` of the file on the card: its
                bytes under a quarter of the f32 params' (the JAX bound),
                the reloaded quantized weights equal to `fold_weights`' bit
                for bit, one f32 step at batch 64 of the reloaded model
                within rtol = atol = 2e-3 of the fold engine's (fp16
                biases), B1 launched in both.
  quality     - `qdiffusion_torch/scripts/quality_evidence.py::
                run_protocol` at the JAX test's settings (2,500 training
                steps of the TINY UNet at batch 128, 384 samples, DDIM-50,
                1,000 reconstruction iterations, 48 x 5 calibration rows,
                W4 and W4A8): the test's five FID bounds; B1 launches
                around every part and, by engine spies, inside captures,
                act inits, the EMA sweep and reconstructions: 0 in
                training and in every reconstruction, launched in every
                sampling arm, capture, act init and the sweep; every
                reconstruction's block error before and after, the act
                deltas below the lr; B1 against its plain version at every
                distinct shape the spy saw (f32); after the join, B1
                timed at the sampling call's shapes (probed with the
                others up front) in the smoke's own process.
  Stable Diffusion v1 (sd_v1 preset, full width, seeded random weights
  with no zero-initialised branch; no checkpoint or vocabulary needed):
  5. attn_kernels - B2 (flash_attention) at (8, 4096, 8, 40) and
                (8, 1024, 8, 80), B3 (streaming_flash_attention) at
                (4, 4096, 1, 512), bf16 and f32, with and without the
                softmax/V quantizers, B2 at P's (2, 4096, 8, 40) in
                bf16, B2 at the SD stream call's (2, 4096, 8, 40) and
                (2, 1024, 8, 80) and B3 at the stream decode's
                (1, 4096, 1, 512) in f32: error against the plain version,
                with the softmax quantizer also the share of quantized
                probabilities that differ from the plain version's
                (`bucket_flip_share`, at most 1e-3), kernel / plain /
                F.scaled_dot_product_attention time, the bound (bytes, MMA
                flops, exponentials) and the CUDA design that ran, from
                the profiler's kernel names ("mma": flash_mma_kernel, for
                bf16 at D <= 128; "tf32": flash_tf32_kernel, for f32 at
                D <= 128; "wide": flash_wide_kernel, for D = 512; a row on
                another design fails). Every design check reads
                the names of one launch per case and shape made right after
                the build, before any CUDA graph: after one, the profiler
                here keeps only some kernels of a short window;
  6. gn_sd    - B1 at every GroupNorm shape of one SD UNet call (batch 8,
                CFG) and one VAE decode (batch 4), bf16 and f32, as in 1;
  7. sd_fold_cli - writes the UNet / VAE / CLIP npz files, a token-ids
                npz and a W4 'mse' qstate, then `cli sample --task sd_v1
                --engine fold --weight-bit 4 --dtype bfloat16 --n 8
                --batch 4` (PLMS-50, CFG 7.5, 512x512): output, 51 UNet
                calls per batch, and the B1/B2/B3 launch counts against a
                spy's count of one UNet call and one decode;
  8. sd_card_vs_cpu - one fold UNet call with context at 32x32 latents,
                batch 1, then a DPM-Solver sample (multistep order 2, 4
                steps, so its order-2 update runs; CFG 7.5) on the same
                models, card bf16 against CPU f32 (the 1024-token sites
                reach B2: 5 a call);
  9. sd_sim   - W8A8: activation qstate from 2 inputs, one bf16 UNet call
                at batch 8 and a 5-step PLMS through the CLI (f32), with
                B2 launched with its softmax quantizer.
  calib_sd    - the latent models' calibration through the CLI at full
                SD width, shaped as the JAX package's flagship run:
                `make-cali-data --task sd_v1 --token-ids --n 2` (PLMS-50,
                CFG 7.5, f32; B2 10 and B1 per UNet call as the spy counts
                them), `calibrate --weight-bit 4 --split --alpha-dtype
                bfloat16 --cali-st 4 --cali-n 2 --cali-batch-size 4
                --cali-iters 10` (20 rows, cond then uncond; all 80 units),
                `calibrate --resume-w <it> --quant-act --sm-abit 16
                --running-stat --act-init-batch 4 --cali-iters-a 10`, then
                PLMS-5 samples at batch 1 of both qstates (fold, and sim
                W4A8 with B2's 16-bit softmax quantizer), launch counts
                against
                the spy; spies time every part (trajectory, captures, act
                init, EMA, reconstructions by unit kind, snapshots), hold
                B1/B2/B3 at 0 inside the reconstructions and B2/B3 at 0 in
                the captures, act init and EMA, and each unit's block error
                after its reconstruction to 1.02x its start's (nearest
                rounding; init/EMA deltas where no trained delta is below
                the lr), the sums lower; then the 16x16 transformer block
                reconstructed on the card and on the CPU from the same
                captures (both passes, 10 iterations), and B2's bucket-flip
                share at (2, 4096, 8, 40) f32 with the 16-bit softmax
                quantizer (at most 1e-3).
  The int8 and stream deployment engines (kernels B4, B5, B6):
  10. int_kernels - B4 (int8_conv, the implicit-GEMM convolution) at
                every distinct site of one CIFAR W4A8 int8 step at batch 64
                (geometry, segments and the step's own bf16 input, from a
                spy), B6 (int4_stream_matmul) and B5 (int8_stream_matmul)
                at every distinct shape of one SD stream UNet call at
                batch 2 (W4 and W8): error against the plain version (B4:
                the plain composition on the card, the output bit for bit
                and the int32 products exactly; B5/B6: 1e-3 of the
                largest output), kernel / plain / library time in a CUDA
                graph over inputs that outgrow the L2 (B4's library: the
                torch._int_mm route with the quantize, pad and gather
                passes; also cuDNN's bf16 convolution), and the bound; for
                B5/B6 also the launch plan (tile rows, K splits), two
                launches bit-equal, and the design from the profiler's
                kernel names ("mma": stream_mma_kernel, with
                stream_reduce_kernel exactly when K is split);
  11. int8_cli - `cli sample --task cifar10 --weight-bit 4 --quant-act
                --split --engine int8 --n 128 --batch 64` (DDIM-100): the
                B4 launches against 100 x the spy's per-step site count
                (113: one launch per site) per batch; then one int8 step
                at batch 2: the card's bf16 and f32 carriers against the
                CPU's f32 carrier (every int8
                activation within one bucket beyond its input's drift)
                and the card's f32 carrier against its sim step;
  (sd_stream_sites: before 10, one SD stream W4 and one W8 UNet call at
                batch 2 in which every B6 / B5 call also runs its plain
                version on the CPU on a copy of that call's inputs: the
                largest per-site error, 1e-3 of the site's largest output.)
  12. sd_stream_cli - `cli sample --task sd_v1 --weight-bit 4 --engine
                stream --stream-convs --n 2 --batch 1` (PLMS-50, CFG 7.5;
                B6 launches against 51 x the spy's per-call count per
                batch; img/s of batch 2) and the same at --weight-bit
                8 --timesteps 5 --n 2 (B5 on the streamed convs), with the
                streamed conv sites.
  The remaining samplers (DPM-Solver++ and ancestral DDPM) through `cli
  sample --sampler`, after 12, on the files and qstates of 2, 7 and 11:
  sampler_cli - under `_spied_cli` (every kernel counter set to 0 just
                before, the wrapper calls split at each UNet call):
                CIFAR-10 fold W4 bf16 `--sampler dpm_solver --timesteps
                20` (singlestep order 3, [3]*6 + [2]: 20 UNet calls) and
                `--sampler ddpm_noisy` (the preset's 100), int8 W4A8
                --split `--sampler dpm_solver --timesteps 20`, two batches
                of 64; SD v1 fold W4 bf16 at batch 4 `--sampler dpm_solver
                --timesteps 50` (multistep order 2, CFG 7.5: txt2img's
                --dpm_solver) and stream W4 --stream-convs at batch 1
                `--timesteps 20`, two batches each: UNet calls = the
                solver's NFE, every kernel's launches per UNet call equal
                to the same engine's under DDIM / PLMS (B1 51 and B4 113 a
                CIFAR call; B1 61, B2 10 and B6 220 a SD call; the decode's
                B1 30 and B3 1), launches = the wrappers' calls, finite
                uint8 output; img/s and ms per UNet call of the second
                batch beside the same engine's DDIM / PLMS run above;
                then each of these sampler loops and its DDIM / PLMS base
                at the runs' shapes with a model that returns a fixed eps:
                the solver's own ms per model call. Their card-vs-CPU
                checks ride in 3 and 8.
  The LSUN latent-diffusion family (lsun_beds256: LDM-4, VQ-f4 decode,
  DDIM-200 at eta 1; lsun_churches256: LDM-8, KL-f8 decode, DDIM "400",
  which the reference's stride makes 500 UNet calls, at eta 0; full
  width, seeded weights; `lsun_spy`, before `designs`, records the B1,
  B2 and B3 shapes of one bf16 UNet call and decode at batch 8, and B6's
  of one stream W4 call at batch 1, each of whose B6 calls it also holds
  against the plain version on the CPU on a copy of the call's inputs,
  1e-3 of the site's largest output):
  gn_lsun / attn_lsun - B1 at every GroupNorm shape of those calls and
                decodes, bf16 and f32, as in 1; B2/B3 at LSUN_ATTN_CASES
                as in 5 (B2 at 14 heads of 32 and 8 heads of 24 in bf16
                and f32 with and without the quantizers, the KL-f8
                decode's 1024 keys of 512 on B2's wide design, the VQ-f4
                decode's 4096 keys on B3, B3 at 1024 keys);
  lsun        - per preset: a seeded VAE npz file and W4, W8A8 and
                W4A8 --split qstates of the UNet the CLI draws without
                --ckpt (acts 'max' from 4 latents, on the
                act-quant partition that --quant-act builds); `cli sample`
                through fold (bf16, batch 8, two batches; beds at the
                preset's DDIM-200, churches at DDIM-100, 100 of its
                preset's 500 calls, for time), sim W8A8 (f32, DDIM-5, two batches of 4), int8
                W4A8 --split (DDIM-5, two batches of 4) and stream W4
                --stream-convs (DDIM-20, two batches of 1), the second
                batch timed, each with every kernel's launch count
                set to 0 just before and under a spy of every kernel
                wrapper, split at the UNet-call and decode markers:
                launches = the spies' count = UNet calls x per call +
                decodes x per decode, every call alike, UNet calls = the
                sampler table's length per batch, uint8 256x256 output,
                finite; one fold UNet call at batch 1 card bf16 against
                CPU f32 (5e-2 relative L2); one int8 W4A8 call at batch 1
                and half the latent size on the card's and the CPU's f32
                carriers, every int8
                activation within one bucket beyond its input's drift and
                every B4 call bit for bit against the plain composition;
                beds: the VQ codes of 8 seeded latents, card against CPU
                (an f32 flip must be a near-tie within 1e-4 of
                |z|^2 + |e|^2; bf16 within 2^-6); then B4 at every
                distinct site of one int8 call at batch 4 and full
                latents, on the inputs it gave each, as in 10 (bit for
                bit and int32-exact against the plain composition, timed
                beside the torch._int_mm route, cuDNN bf16 and the
                bound), and B6 at every distinct (M, K, N) of the stream
                call lsun_spy recorded, as in 10;
  calib_lsun  - the beds W4A8 calibration through the CLI in the
                reference's LSUN form: `make-cali-data --n 4` (DDIM-200 at
                eta 1, f32), one `calibrate --weight-bit 4 --split
                --quant-act --a-min-max --running-stat --cali-st 10
                --cali-n 4 --cali-batch-size 8 --cali-iters 10
                --cali-iters-a 10` (40 rows; every unit of both passes),
                then DDIM-5 samples of its qstate through sim and int8 in
                two batches of 1; spies as in calib_sd (per-part seconds, peak
                memory per pass, block errors, B1/B2/B3 0 inside the
                reconstructions, B2/B3 0 in captures, act init and EMA).
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
  fold UNet call, a CIFAR int8 step, an SD stream W4 UNet call, the
  last in three windows, and of each LSUN preset's fold, int8 and stream
  UNet calls and bf16 decode; by kind from each kernel's own interval, beside
  the union of the intervals, which is less where kernels overlap on
  several streams, as cuDNN's f32 convolutions do.)

Each phase prints one JSON line (13: one per mode, after the entry
point's own nine). Then come the `kernels` line, the raw
nvidia-smi line and, only if every check passed, the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero without it.
A full report goes to DIR/report.json (default runs/chip_smoke).
Needs CUDA: without a card it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qdiffusion_torch.utils.timing import BF16_FLOPS, F32_FLOPS, \
    HBM_BYTES_PER_S, INT8_OPS, attention_bound, bound, nvidia_smi, rotations
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
DPM_CPU_STEPS = 6  # CIFAR DPM-Solver card vs CPU: order 3 plans [3, 3]
SD_DPM_CPU_STEPS = 4  # SD: multistep reaches its order-2 update
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
STREAM_N_W4 = 2  # W4 PLMS-50: batch 2 timed (4 until the LSUN phases)
STREAM_REL = 1e-3  # B5/B6: the same bf16 products, summed in another order
P_SHAPE = (2, 4096, 8, 40)  # P's (B, T, H, D), bench_flash_epilogue.py:112
# calib: the AdaRound weight pass at full CIFAR width. The reference
# calibrates on 256 samples x 20 steps with 20,000 iterations per unit;
# the smoke cuts only those two: a 32-sample DDIM-100 trajectory, 8
# samples at each of its 9 sampled steps (cali_st 8 slices every 12th of
# 100 steps; 16 until the LSUN phases needed the time), 20 iterations per
# unit (50 until then).
CALIB_N, CALIB_ST, CALIB_CALI_N, CALIB_ITERS = 32, 8, 8, 20
CALIB_BATCH = 32  # reconstruction minibatch (the reference's)
RECON_BOUND = 1.02  # after <= 1.02 x before, tests/test_calibration.py:97
CARD_CPU_UNIT = "up.3.block.0"  # a split up block (4x4, 512 -> 256)
CARD_CPU_ITERS = 50
CARD_CPU_LOSS_REL = 1e-3  # per-iteration loss, card against CPU
CARD_CPU_FLIPS = 1e-3  # share of hard roundings that may differ
# calib_act: the activation pass on the calib phase's weight qstate and
# trajectory (the same 72 samples), W4A8 split, running-stat EMA, 20
# iterations a unit (reference 5,000; 50 until the LSUN phases)
ACT_ITERS = 20
ACT_INIT = 64  # act init rows and EMA batch (the reference's)
ACT_RESUME_ITERS = 10  # the crash-and-resume run checks control flow only
ACT_CRASH_AT = 13  # the resume run's spy raises in this reconstruction
FISHER_UNITS = ("mid.block_1", "down.1.attn.0")  # a ResnetBlock, attention
FISHER_ROWS = 16  # calibration rows of the card-vs-CPU Fisher grads
FISHER_REL = 1e-4  # of the largest |g|
FISHER_ITERS = 20
HELD = 8  # held inputs of the int8-vs-FP eps comparison
# calib_sd: the latent models' calibration at full SD v1 width, shaped as
# the JAX package's flagship run (scripts/run_sd_calibration.sh: W4A8,
# --split, --sm-abit 16, --running-stat, bf16 alphas, batch 4) and cut in
# scale only: a 2-image PLMS-50 trajectory, 2 samples at each of the 5
# steps it slices (cali_st 4 takes every 12th of 50), cond and uncond: 20
# rows (40 until the LSUN phases needed the time); SDC_ITERS weight and
# SDC_ITERS_A act iterations a unit (reference 20,000 and 5,000): the
# fewest tried at which every unit's quality bound holds.
SDC_N, SDC_ST, SDC_CALI_N = 2, 4, 2
# minibatch, act init rows and EMA batch: one f32 score tensor of a
# 4096-token self-attention is 2.1 GB at batch 4, and autograd keeps
# several (at the CLI's default 32, 17 GB each)
SDC_BATCH = 4
SDC_ITERS = SDC_ITERS_A = 10
SDC_SAMPLE_STEPS = 5  # PLMS-5 samples of both qstates, batch 1, decoded
SDC_UNIT = "input_blocks.7.1.transformer_blocks.0"  # 16x16, 640 channels
SDC_UNIT_ITERS = 10  # its reconstruction on the card and on the CPU
SDC_FLIP_SHAPE = (2, 4096, 8, 40)  # B2 with the 16-bit softmax quantizer


T_START = time.perf_counter()


# the phases whose lines were emitted while the quality process ran,
# None when it does not run
BESIDE_QUALITY = None


def _emit(obj: dict):
    """One JSON line; a phase's line also gets `wall_s`, the seconds since
    the script started, so the gaps between lines time the phases. While
    the quality process runs, a phase's dict (which the report keeps) is
    tagged `beside_quality`: its seconds shared the card and the host."""
    if "phase" in obj:
        if BESIDE_QUALITY is not None:
            obj["beside_quality"] = True
            BESIDE_QUALITY.append(obj["phase"])
        obj = {**obj, "wall_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def ptxas_report(build: Path) -> dict:
    """Registers and spill bytes of each kernel, from the `-Xptxas -v`
    reports that ops/_cuda.py writes beside the libraries: {source:
    {kernel: [registers, spill stores, spill loads]}}, kernels by their
    template arguments (flash_mma_kernel<D/16, epilogue>,
    flash_tf32_kernel<D class, sm_q>, flash_wide_kernel<type, D class,
    epilogue>, stream_mma_kernel<BM, BN, WM, STAGES, MINB, x type, NH>,
    int8_conv_kernel<segments, MINB>, int8_quantize_kernel<x type>)."""
    import re

    out = {}
    for f in sorted(build.glob("*.ptxas.txt")):
        rows, name = {}, None
        for line in f.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(flash_mma_kernel|flash_tf32_kernel|"
                              r"flash_wide_kernel|stream_mma_kernel|"
                              r"int8_conv_kernel|int8_quantize_kernel)"
                              r"I(\w+?)EvN", m.group(1))
                args = k and re.findall(
                    r"L[ib](\d+)E|(f|a)(?=Li|E)|13__nv_(bf16)",
                    k.group(2).replace("bfloat", "bf"))
                name = (f"{k.group(1)}<{','.join(''.join(a) for a in args)}>"
                        if k else m.group(1)[-60:])
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


def gn_plan(shape, dtype):
    from qdiffusion_torch.ops.groupnorm import group_norm_plan

    b, c = shape[0], shape[-1]
    return group_norm_plan(b, int(np.prod(shape[1:-1])), c, 32,
                           torch.tensor([], dtype=dtype).element_size(),
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)


def _gn_design(names):
    """B1's path that kernel names show: "rows" (group_norm_rows_kernel),
    "split" (group_norm_apply_kernel, after group_norm_stats_kernel), or
    None when they show neither or both (the profiler may keep only a
    window's last kernel, so the split path is read from its last one)."""
    rows = any("group_norm_rows_kernel" in n for n in names)
    split = any("group_norm_apply_kernel" in n for n in names)
    return "rows" if rows and not split else "split" if split and not rows \
        else None


def phase_kernels(shapes: list, check: Checks, designs: dict, *,
                  dtypes=(torch.bfloat16, torch.float32),
                  phase: str = "kernel_shape", where: str = "",
                  time_dtypes=None) -> list:
    """B1 at each distinct full (B, ..., C) shape of `shapes` (a call-order
    list, so a shape's multiplicity is its count per call); the path that
    ran, from `designs` (probe_designs' kernel names), must be the plan's.
    The plain version and F.group_norm are timed in `time_dtypes`
    (default: every dtype), else None."""
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
            plan = gn_plan(shape, dtype)
            names = designs.get(("group_norm", tuple(shape), dtype))
            design = _gn_design(names or [])
            seen = [n for n in names or [] if "group" in n]
            check(design == plan.path, f"group_norm {dtype} {shape}: "
                  f"profiler kernels {seen} for the {plan.path} path" + (
                      "" if names is not None else " (shape not probed)"))
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
                "per_call": per_call, "path": plan.path, "design": design,
                "plan": {"chunks": plan.chunks, "groups": plan.groups,
                         "splits": plan.splits, "block_c": plan.block_c},
                "max_abs_err": err, "tolerance": TOL[dtype], "ok": ok,
                "ms": _graph_ms([lambda a=a: fused_group_norm(a, scale, bias)
                                 for a in xs]),
                "plain_ms": _graph_ms([lambda a=a: group_norm_plain(
                    a, scale, bias) for a in xs], min_calls=5)
                if dtype in (time_dtypes or dtypes) else None,
                "library_ms": _graph_ms([lambda a=a: lib(
                    a.movedim(-1, 1), 32, scale, bias, eps=1e-6)
                    for a in xs])
                if dtype in (time_dtypes or dtypes) else None,
                "eager_ms": _time_ms(lambda: fused_group_norm(x, scale,
                                                              bias)),
                **bound(nbytes, GN_FLOPS_PER_ELEM * x.numel() / F32_FLOPS
                        * 1e3),
                # the split path reads the slab twice
                "moved_bytes_ms": (nbytes + (x.numel() * x.element_size()
                                             if plan.path == "split" else 0))
                / HBM_BYTES_PER_S * 1e3,
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

    n = 2 * BATCH  # two batches, the second timed
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
    """One fold step at batch 2, then a DPM-Solver sample (singlestep
    order 3, DPM_CPU_STEPS) at batch 2 through the pixel pipeline on the
    same step: card bf16 against CPU f32, each within
    REL_L2_CARD_VS_CPU relative L2."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.pipelines import PixelDiffusionPipeline
    from qdiffusion_torch.utils.checkpoints import load_qstate

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    t = torch.tensor([10.0, 500.0])
    x0 = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    eps, dpm, b1 = {}, {}, 0
    for dev, dtype in (("cpu", None), ("cuda", torch.bfloat16)):
        model = _seeded_model(task, dev, weight_bit=4)
        step = make_quantized_step(model, load_qstate(out / "w4_qstate.npz",
                                                      dev),
                                   engine="fold", dtype=dtype)
        xin = x.to(dev) if dtype is None else x.to(dev, dtype)
        with torch.no_grad():
            eps[dev] = step(xin, t.to(dev)).float().cpu()
        n = fused_group_norm.launches
        dpm[dev] = PixelDiffusionPipeline(model, cli._schedule(task)).sample(
            2, timesteps=DPM_CPU_STEPS, sample_type="dpm_solver",
            x_init=x0.to(dev), eval_dtype=dtype, model_fn=step).cpu()
        b1 = fused_group_norm.launches - n
    row = {"phase": "card_vs_cpu", "batch": 2,
           "step": _rel_row("cifar fold step", eps["cuda"], eps["cpu"],
                            check),
           "dpm_solver": _rel_row("cifar fold dpm_solver sample",
                                  dpm["cuda"], dpm["cpu"], check)}
    check(b1 == DPM_CPU_STEPS * 51, f"card fold dpm_solver: {b1} B1 "
                                    f"launches, expected {DPM_CPU_STEPS} x 51")
    row["dpm_solver"].update(steps=DPM_CPU_STEPS, b1_launches=b1)
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


def profile_breakdown(run, reps: int, trace, what: str) -> dict:
    """torch.profiler over `reps` calls of `run`: device time by kernel
    kind and the device's idle share against the unprofiled call time;
    the chrome trace goes to `trace` unless it is None."""
    from torch.profiler import ProfilerActivity, profile

    call_ms = _time_ms(run, reps=reps)  # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace is not None:
        prof.export_chrome_trace(str(trace))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only: an operator's own entry repeats the time of
    # the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages()
            if e.device_type == cuda and dev_us(e) > 0]
    # each kernel once, by its own interval on the device
    dev_events = [e for e in prof.events() if e.device_type == cuda
                  and e.time_range.end > e.time_range.start]
    # busy time as the union of the kernels' intervals: kernels that run
    # concurrently count once
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
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
    for e in dev_events:  # by kind, from the same events as the union
        name = e.name.lower()
        kind = ("group_norm" if "group_norm" in name else
                "flash_attention" if any(s in name for s in (
                    "flash_mma_kernel", "flash_tf32_kernel",
                    "flash_wide_kernel")) else
                "int matmul (B4-B6)" if any(s in name for s in (
                    "int8_quantize_kernel", "int8_conv_kernel",
                    "int8_conv_reduce_kernel", "stream_mma_kernel",
                    "stream_reduce_kernel")) else
                "conv" if any(s in name for s in ("conv", "fprop",
                                                   "implicit")) else
                # cuBLAS's Hopper GEMMs are named nvjet_*
                "gemm" if any(s in name for s in ("gemm", "matmul",
                                                   "cutlass", "nvjet")) else
                "elementwise and other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + (e.time_range.end - e.time_range.start)
                       / (1e3 * reps), n + 1 / reps)
    event_sum_ms = sum(e.time_range.end - e.time_range.start
                       for e in dev_events) / 1e3
    streams = sorted({getattr(e, "device_resource_id", None)
                      for e in dev_events}, key=str)
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    return {"what": what, "calls": reps, "call_ms": call_ms,
            "profiled_call_ms": wall_ms / reps,
            "device_busy_ms_per_call": busy_ms / reps,
            "kernel_time_sum_ms_per_call": kernel_sum_ms / reps,
            # the by-kind sum: above the busy union only where kernels
            # overlap on the device (more than one stream)
            "event_sum_ms_per_call": event_sum_ms / reps,
            "device_streams": [str(x) for x in streams],
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


# -- calibration: the AdaRound weight pass ----------------------------------

def _block_mse(unit, qstate, inps, out, chunk: int = CALIB_BATCH,
               acts: bool = False) -> float:
    """Mean squared error of the unit's hard-rounded forward (alphas where
    qstate has them, nearest rounding elsewhere; with acts, activations
    quantized too) on captured inputs."""
    from qdiffusion_torch.quant.context import QuantCtx, QuantMode

    ctx = QuantCtx(qstate, mode=QuantMode(w=True, a=acts))
    se, n = 0.0, 0
    with torch.no_grad():
        for i in range(0, out.shape[0], chunk):
            pred = unit.apply(ctx, *(a[i:i + chunk] for a in inps))
            se += float(((pred - out[i:i + chunk]).double() ** 2).sum())
            n += pred.numel()
    return se / n


def _nearest(qstate: dict, unit) -> dict:
    """qstate with the unit's own alphas removed: round-to-nearest there."""
    return {s: ({k: {n: v for n, v in st.items() if n != "alpha"}
                 for k, st in sl.items()} if s in unit.layer_names else sl)
            for s, sl in qstate.items()}


def _to(qstate: dict, dev) -> dict:
    return {s: {k: {n: v.to(dev) for n, v in st.items()}
                for k, st in sl.items()} for s, sl in qstate.items()}


def phase_calib(task, work: Path, smi: str, check: Checks) -> dict:
    """The weight pass through the CLI at full width (make-cali-data,
    calibrate, sample --engine fold on its qstate), with spies around
    the engine's captures and reconstructions: per-unit times, B1's
    launches (none inside a reconstruction), and each unit's block error
    with nearest and with learned hard rounding on its captured inputs.
    Then one split up block reconstructed on the card and on the CPU
    from the same inputs and minibatch indices."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib import capture, engine
    from qdiffusion_torch.ops.groupnorm import fused_group_norm

    gn = fused_group_norm
    work = work / "calib"
    traj = work / "traj.npz"
    gn.launches = 0
    t0 = time.perf_counter()
    made = cli.main(["make-cali-data", "--task", "cifar10", "--n",
                     str(CALIB_N), "--timesteps", str(STEPS), "--out",
                     str(traj), "--device", "cuda"])
    make_s = time.perf_counter() - t0
    launches = {"make_cali_data": gn.launches}
    check(made["shapes"]["xs"] == (STEPS, CALIB_N, 32, 32, 3),
          f"make-cali-data trajectory {made['shapes']}")
    check(gn.launches == STEPS * 51,
          f"make-cali-data: {gn.launches} B1 launches, expected "
          f"{STEPS * 51}")

    units, groups, kept = [], [], {}
    count = {"capture": 0, "recon": 0, "error": 0}
    real = (engine.reconstruct_unit, capture.GroupedCapture.fp_capture,
            capture.GroupedCapture.quant_capture)

    def timed(key, fn, *a, **kw):
        torch.cuda.synchronize()
        b0, t0 = gn.launches, time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        count[key] += gn.launches - b0
        return res, time.perf_counter() - t0, gn.launches - b0

    def fp_spy(self, group, *a, **kw):
        res, sec, n = timed("capture", real[1], self, group, *a, **kw)
        groups.append({"units": list(group), "fp_capture_s": sec,
                       "b1_launches": n})
        return res

    def q_spy(self, qstate, name, *a, **kw):
        res, sec, n = timed("capture", real[2], self, qstate, name, *a, **kw)
        units.append({"unit": name, "asym_capture_s": sec,
                      "capture_b1_launches": n})
        return res

    def recon_spy(model, qstate, unit, inps, target, cfg, **kw):
        b0 = gn.launches
        before = _block_mse(unit, _nearest(qstate, unit), inps, target)
        count["error"] += gn.launches - b0
        new, sec, n = timed("recon", real[0], model, qstate, unit, inps,
                            target, cfg, **kw)
        b0 = gn.launches
        after = _block_mse(unit, new, inps, target)
        count["error"] += gn.launches - b0
        row = units[-1]
        row.update(kind=unit.kind, samples=int(target.shape[0]),
                   recon_s=sec, ms_per_iter=sec / cfg.iters * 1e3,
                   recon_b1_launches=n, mse_nearest=before,
                   mse_adaround=after, ratio=after / before)
        if unit.name == CARD_CPU_UNIT:
            kept.update(inps=tuple(a.cpu() for a in inps), out=target.cpu(),
                        qstate=_to(qstate, "cpu"))
        return new

    engine.reconstruct_unit = recon_spy
    capture.GroupedCapture.fp_capture = fp_spy
    capture.GroupedCapture.quant_capture = q_spy
    torch.cuda.reset_peak_memory_stats()
    b0 = gn.launches
    t0 = time.perf_counter()
    try:
        cal = cli.main([
            "calibrate", "--task", "cifar10", "--cali-data", str(traj),
            "--weight-bit", "4", "--split", "--cali-st", str(CALIB_ST),
            "--cali-n", str(CALIB_CALI_N), "--cali-batch-size",
            str(CALIB_BATCH), "--cali-iters", str(CALIB_ITERS),
            "--run-dir", str(work / "run"), "--device", "cuda"])
    finally:
        engine.reconstruct_unit = real[0]
        (capture.GroupedCapture.fp_capture,
         capture.GroupedCapture.quant_capture) = real[1:]
    calib_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches.update(calibrate=gn.launches - b0 - count["error"],
                    captures=count["capture"], reconstructions=count["recon"])

    ref = _seeded_model(task, "cpu", weight_bit=4, split=True)
    check(len(units) == len(ref.units) and all("ratio" in r for r in units),
          f"calibrate reconstructed {len(units)} of {len(ref.units)} units")
    check(count["recon"] == 0, f"B1 launched {count['recon']} times inside "
                               "the reconstruction loops")
    check(count["capture"] > 0, "B1 not launched by the captures")
    for r in units:
        check(r.get("ratio", 2.0) <= RECON_BOUND,
              f"{r['unit']}: hard-rounded block error {r.get('ratio')} x "
              f"nearest, bound {RECON_BOUND}")
    before = sum(r.get("mse_nearest", 0.0) for r in units)
    after = sum(r.get("mse_adaround", 0.0) for r in units)
    check(after < before, f"sum of block errors {after} not below nearest "
                          f"rounding's {before}")
    from qdiffusion_torch.utils.checkpoints import load_qstate

    q = load_qstate(cal["path"])
    missing = [n for n, c in ref.layer_cfgs.items()
               for slot in (("w", "w0") if c.split else ("w",))
               if "alpha" not in q.get(n, {}).get(slot, {})]
    del ref
    check(not missing, f"weight quantizers without alpha: {missing}")

    b0 = gn.launches
    res = cli.main(["sample", "--task", "cifar10", "--qstate", cal["path"],
                    "--weight-bit", "4", "--split", "--engine", "fold",
                    "--n", str(BATCH), "--batch", str(BATCH), "--npz-out",
                    str(work / "fold.npz"), "--device", "cuda"])
    launches["sample"] = gn.launches - b0
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    check(imgs.shape == (BATCH, 32, 32, 3) and imgs.dtype == np.uint8
          and res["nonfinite"] == 0,
          f"calibrated fold sample {imgs.shape} {imgs.dtype}, "
          f"{res['nonfinite']} non-finite")
    check(launches["sample"] == STEPS * 51,
          f"calibrated fold sample: {launches['sample']} B1 launches")
    launches["path"] = (launches["make_cali_data"] + launches["calibrate"]
                        + launches["sample"])

    card_cpu = _calib_card_vs_cpu(task, kept, check) if kept else None
    check(card_cpu is not None, f"{CARD_CPU_UNIT} was not reconstructed")
    kinds: dict = {}
    for r in units:
        if "ms_per_iter" in r:
            kinds.setdefault(r["kind"], []).append(r["ms_per_iter"])
    row = {"phase": "calib", "nvidia_smi": smi,
           "reduced": {"calibration samples": f"{CALIB_CALI_N} x 9 steps "
                       "(reference 256 x 20)", "iterations per unit":
                       f"{CALIB_ITERS} (reference 20000)"},
           "make_cali_data_s": make_s, "calibrate_s": calib_s,
           "calibrate_cli_s": cal["seconds"], "samples": cal["samples"],
           "peak_device_gb": peak_gb,
           "ms_per_iter_by_kind": {k: {"median": float(np.median(v)),
                                       "max": max(v), "units": len(v)}
                                   for k, v in kinds.items()},
           "capture_s": sum(g["fp_capture_s"] for g in groups)
           + sum(r["asym_capture_s"] for r in units),
           "recon_s": sum(r.get("recon_s", 0.0) for r in units),
           "groups": groups, "units": units, "b1_launches": launches,
           "mse_nearest_sum": before, "mse_adaround_sum": after,
           "worst_ratio": max(r.get("ratio", 0.0) for r in units),
           "sample_seconds": res["batch_seconds"],
           "image_mean": float(imgs.mean()), "image_std": float(imgs.std()),
           "card_vs_cpu": card_cpu}
    _emit({k: v for k, v in row.items() if k not in ("units", "groups")})
    for r in units:
        _emit({"phase": "calib_unit", "nvidia_smi": smi, **r})
    return row


def _calib_card_vs_cpu(task, kept: dict, check: Checks) -> dict:
    """reconstruct_unit for CARD_CPU_UNIT on the card and on the CPU from
    the same captured inputs (copied to the CPU), the same qstate and the
    same minibatch indices (drawn once, put in place of _batch_indices),
    CARD_CPU_ITERS iterations: the per-iteration losses (read through the
    loss function) and the learned hard roundings."""
    from qdiffusion_torch.calib import recon

    idx = torch.randint(0, kept["out"].shape[0], (CARD_CPU_ITERS,
                                                  CALIB_BATCH),
                        generator=torch.Generator().manual_seed(0))
    cfg = recon.ReconConfig(iters=CARD_CPU_ITERS, batch_size=CALIB_BATCH)
    real_idx, real_loss = recon._batch_indices, recon.recon_loss
    res = {}
    try:
        recon._batch_indices = lambda i, n, bs, gen: idx[i]
        for dev in ("cuda", "cpu"):
            losses = []

            def loss_spy(*a, **kw):
                loss = real_loss(*a, **kw)
                losses.append(loss.detach())
                return loss

            recon.recon_loss = loss_spy
            model = _seeded_model(task, dev, weight_bit=4, split=True)
            unit = next(u for u in model.units if u.name == CARD_CPU_UNIT)
            t0 = time.perf_counter()
            q = recon.reconstruct_unit(
                model, _to(kept["qstate"], dev), unit,
                tuple(a.to(dev).contiguous(memory_format=torch.channels_last)
                      if a.ndim == 4 else a.to(dev) for a in kept["inps"]),
                kept["out"].to(dev).contiguous(
                    memory_format=torch.channels_last), cfg)
            if dev == "cuda":
                torch.cuda.synchronize()
            res[dev] = (torch.stack(losses).cpu(),
                        {(s, k): q[s][k]["alpha"].cpu()
                         for s in unit.layer_names for k in q[s]},
                        time.perf_counter() - t0)
    finally:
        recon._batch_indices, recon.recon_loss = real_idx, real_loss
    (lc, ac, sc), (lp, ap, sp) = res["cuda"], res["cpu"]
    loss_rel = float(((lc - lp).abs() / lp.abs()).max())
    n = flips = 0
    alpha_diff = 0.0
    for key, a in ap.items():
        n += a.numel()
        flips += int(((ac[key] >= 0) != (a >= 0)).sum())
        alpha_diff = max(alpha_diff, float((ac[key] - a).abs().max()))
    check(len(lc) == CARD_CPU_ITERS and loss_rel <= CARD_CPU_LOSS_REL,
          f"{CARD_CPU_UNIT} card vs CPU: per-iteration loss relative "
          f"difference {loss_rel}, limit {CARD_CPU_LOSS_REL}")
    check(flips <= CARD_CPU_FLIPS * n,
          f"{CARD_CPU_UNIT} card vs CPU: {flips} of {n} hard roundings "
          "differ")
    return {"unit": CARD_CPU_UNIT, "iters": CARD_CPU_ITERS,
            "loss_rel_max": loss_rel, "loss_first": float(lp[0]),
            "loss_last": float(lp[-1]), "flip_share": flips / n,
            "weights": n, "alpha_abs_diff_max": alpha_diff,
            "card_s": sc, "cpu_s": sp}


# -- calibration: the activation pass ---------------------------------------

def _calib_act_argv(work: Path, run: Path, iters: int) -> list:
    return ["calibrate", "--task", "cifar10",
            "--cali-data", str(work / "calib" / "traj.npz"),
            "--resume-w", str(work / "calib" / "run" / "qstate.npz"),
            "--weight-bit", "4", "--split", "--quant-act", "--running-stat",
            "--cali-st", str(CALIB_ST), "--cali-n", str(CALIB_CALI_N),
            "--cali-batch-size", str(CALIB_BATCH), "--cali-iters-a",
            str(iters), "--act-init-batch", str(ACT_INIT), "--run-dir",
            str(run), "--device", "cuda"]


def phase_calib_act(task, work: Path, smi: str, check: Checks) -> dict:
    """The activation pass through the CLI at full width on the calib
    phase's weight qstate and trajectory (`calibrate --resume-w`), with
    spies around the act init, the EMA sweep, the FP capture and each
    reconstruction: seconds, B1 launches (none inside a reconstruction)
    and each unit's block error with its init/EMA deltas and with its
    learned ones. Then the Fisher grads card against CPU and a
    fisher_diag reconstruction on the card, a crash-and-resume through
    --run-dir, and `sample --engine int8` on the calibrated qstate (B4
    and B1 launch counts, and the eps of the calibrated and the
    init-only deltas against the FP eps)."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib import capture, engine, recon
    from qdiffusion_torch.ops.groupnorm import fused_group_norm as gn
    from qdiffusion_torch.ops.int8_conv import int8_conv

    work_a = work / "calib_act"
    units, parts, kept = [], {}, {}
    count = {"recon": 0, "error": 0}
    real = (engine.reconstruct_unit, engine.init_act_qstate,
            engine.run_running_stat, capture.GroupedCapture.fp_capture)

    def timed(key, fn, *a, **kw):
        torch.cuda.synchronize()
        b0, t0 = gn.launches, time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        parts.setdefault(key, {"seconds": 0.0, "b1_launches": 0, "calls": 0})
        parts[key]["seconds"] += time.perf_counter() - t0
        parts[key]["b1_launches"] += gn.launches - b0
        parts[key]["calls"] += 1
        return res, time.perf_counter() - t0, gn.launches - b0

    def init_spy(*a, **kw):
        kept["init"] = timed("act_init", real[1], *a, **kw)[0]
        return kept["init"]

    def ema_spy(*a, **kw):
        return timed("ema_sweep", real[2], *a, **kw)[0]

    def fp_spy(self, *a, **kw):
        return timed("fp_capture", real[3], self, *a, **kw)[0]

    def recon_spy(model, qstate, unit, inps, target, cfg, **kw):
        b0 = gn.launches
        small = recon.deltas_below_lr(qstate, unit, cfg.lr)
        before = _block_mse(unit, qstate, inps, target, acts=True)
        count["error"] += gn.launches - b0
        new, sec, n = timed("reconstructions", real[0], model, qstate, unit,
                            inps, target, cfg, **kw)
        count["recon"] += n
        b0 = gn.launches
        after = _block_mse(unit, new, inps, target, acts=True)
        count["error"] += gn.launches - b0
        units.append({"unit": unit.name, "kind": unit.kind,
                      "recon_s": sec, "ms_per_iter": sec / cfg.iters * 1e3,
                      "recon_b1_launches": n, "mse_init": before,
                      "mse_learned": after, "ratio": after / before,
                      "deltas_below_lr": [f"{s}/{k}" for s, k in small]})
        return new

    engine.reconstruct_unit, engine.init_act_qstate = recon_spy, init_spy
    engine.run_running_stat = ema_spy
    capture.GroupedCapture.fp_capture = fp_spy
    torch.cuda.reset_peak_memory_stats()
    gn.launches = int8_conv.launches = 0
    t0 = time.perf_counter()
    try:
        cal = cli.main(_calib_act_argv(work, work_a / "run", ACT_ITERS))
    finally:
        (engine.reconstruct_unit, engine.init_act_qstate,
         engine.run_running_stat) = real[:3]
        capture.GroupedCapture.fp_capture = real[3]
    calib_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"calibrate": gn.launches - count["error"]}
    names = [u.name for u in _seeded_model(task, "cpu", weight_bit=4,
                                           split=True).units]
    check([r["unit"] for r in units] == names,
          f"calib_act reconstructed {len(units)} of {len(names)} units")
    check(count["recon"] == 0, f"calib_act: B1 launched {count['recon']} "
                               "times inside the reconstruction loops")
    want_b1 = {"act_init": 51, "ema_sweep": 51 * (
        (cal["samples"] - ACT_INIT) // ACT_INIT + 1)}
    for key, n in want_b1.items():
        got = parts.get(key, {}).get("b1_launches")
        check(got == n, f"calib_act {key}: {got} B1 launches, expected {n}")
    check(parts.get("fp_capture", {}).get("b1_launches", 0) > 0,
          "calib_act: B1 not launched by the FP captures")
    # the quality bound holds where Adam can train every delta: a delta
    # below the lr is overshot by the first step (lr x the gradient's
    # sign), as in the JAX package (tests/test_torch_calib_act.py)
    held = [r for r in units if not r["deltas_below_lr"]]
    below = [r for r in units if r["deltas_below_lr"]]
    check(all(r["kind"] == "attn" for r in below),
          f"calib_act: deltas below the lr outside attention: "
          f"{[(r['unit'], r['deltas_below_lr']) for r in below]}")
    for r in held:
        check(r["ratio"] <= RECON_BOUND,
              f"{r['unit']}: act block error {r['ratio']} x its init/EMA "
              f"deltas', bound {RECON_BOUND}")
    before = sum(r["mse_init"] for r in held)
    after = sum(r["mse_learned"] for r in held)
    check(after < before, f"calib_act: sum of block errors {after} not "
                          f"below the init/EMA deltas' {before}")

    fisher = _fisher_card_vs_cpu(task, work, cal["path"], check)
    resume = _calib_act_resume(names, work, check)
    int8 = _calib_act_int8(task, work, cal["path"], kept["init"], check)
    launches["int8_sample"] = int8["launches"]["group_norm"]
    launches["path"] = launches["calibrate"] + launches["int8_sample"]

    kinds: dict = {}
    for r in units:
        kinds.setdefault(r["kind"], []).append(r["ms_per_iter"])
    row = {"phase": "calib_act", "nvidia_smi": smi,
           "reduced": {"calibration samples": f"{CALIB_CALI_N} x 9 steps "
                       "(reference 256 x 20)", "iterations per unit":
                       f"{ACT_ITERS} (reference 5000)"},
           "calibrate_s": calib_s, "calibrate_cli_s": cal["seconds"],
           "samples": cal["samples"], "peak_device_gb": peak_gb,
           "parts": parts,
           "ms_per_iter_by_kind": {k: {"median": float(np.median(v)),
                                       "max": max(v), "units": len(v)}
                                   for k, v in kinds.items()},
           "b1_launches": launches, "mse_init_sum": before,
           "mse_learned_sum": after,
           "worst_ratio": max((r["ratio"] for r in held), default=None),
           "below_lr_units": {r["unit"]: {"ratio": r["ratio"],
                                          "deltas": r["deltas_below_lr"]}
                              for r in below},
           "fisher": fisher, "resume": resume, "int8": int8}
    _emit({k: v for k, v in row.items() if k != "units"})
    for r in units:
        _emit({"phase": "calib_act_unit", "nvidia_smi": smi, **r})
    row["units"] = units
    return row


def _fisher_card_vs_cpu(task, work: Path, qpath: str, check: Checks) -> dict:
    """save_grad_data (act_quant) for FISHER_UNITS on the card and on the
    CPU from the same FISHER_ROWS calibration rows and qstate. The
    card's KL gradients are held against the CPU's computed from the
    card's own captures (each batch's FP output and W4A8 unit output,
    recorded at fisher._kl_grad): the device's arithmetic alone. The
    CPU's whole save_grad_data is printed beside them: its W4A8 capture
    lands some activations in other buckets than the card's, and the
    gradients (|g| - 1 about 1e-3) follow. Then one fisher_diag act
    reconstruction of FISHER_ITERS iterations of the ResnetBlock on the
    card (its losses read through recon_loss)."""
    from qdiffusion_torch.calib import fisher, recon
    from qdiffusion_torch.calib.capture import capture_unit_io
    from qdiffusion_torch.calib.samples import get_train_samples
    from qdiffusion_torch.ops.groupnorm import fused_group_norm as gn
    from qdiffusion_torch.utils.checkpoints import load_qstate

    with np.load(work / "calib" / "traj.npz") as f:
        traj = {k: torch.from_numpy(f[k]) for k in ("xs", "ts")}
    xs, ts = (a[:FISHER_ROWS] for a in get_train_samples(
        traj, CALIB_CALI_N, CALIB_ST))
    out, grads, seen = {}, {}, {}
    real = fisher._kl_grad

    def kl_spy(model, qstate, name, *a):
        if a[0].device.type == "cuda":
            seen.setdefault(name, []).append(
                tuple(None if v is None else v.cpu() for v in a))
        return real(model, qstate, name, *a)

    models = {}
    fisher._kl_grad = kl_spy
    try:
        for dev in ("cuda", "cpu"):
            models[dev] = _seeded_model(task, dev, weight_bit=4,
                                        quant_act=True, split=True)
            q = load_qstate(qpath, dev)
            for name in FISHER_UNITS:
                b0, t0 = gn.launches, time.perf_counter()
                grads[dev, name] = fisher.save_grad_data(
                    models[dev], q, name, xs.to(dev), ts.to(dev),
                    act_quant=True, batch_size=8).cpu()
                out.setdefault(name, {})[f"{dev}_s"] = \
                    time.perf_counter() - t0
                if dev == "cuda":
                    out[name]["b1_launches"] = gn.launches - b0
    finally:
        fisher._kl_grad = real
    q_cpu = load_qstate(qpath, "cpu")
    for name in FISHER_UNITS:
        g_card, g_cpu = grads["cuda", name], grads["cpu", name]
        g_same = torch.cat([real(models["cpu"], q_cpu, name, *batch)
                            for batch in seen[name]])
        err = float((g_card - g_same).abs().max() / g_same.abs().max())
        captures = max(float((b[3] - _unit_out(models["cpu"], q_cpu, name,
                                               b[0], b[1])).abs().max())
                       for b in seen[name])
        out[name].update(
            shape=list(g_cpu.shape), rel_err=err,
            rel_err_own_capture=float((g_card - g_cpu).abs().max()
                                      / g_cpu.abs().max()),
            capture_abs_diff_max=captures,
            g_max=float(g_cpu.abs().max()), g_mean=float(g_cpu.mean()))
        check(err <= FISHER_REL, f"Fisher grads of {name}, card vs CPU on "
                                 f"the card's captures: {err} of the "
                                 f"largest |g|, limit {FISHER_REL}")
        check(out[name].get("b1_launches", 0) > 0,
              f"Fisher grads of {name}: B1 not launched")

    model = _seeded_model(task, "cuda", weight_bit=4, quant_act=True,
                          split=True)
    q = load_qstate(qpath, "cuda")
    name = FISHER_UNITS[0]
    unit = next(u for u in model.units if u.name == name)
    inps, target = capture_unit_io(model, q, name, xs.cuda(), ts.cuda(),
                                   batch_size=8)
    losses, real = [], recon.recon_loss

    def loss_spy(*a, **kw):
        loss = real(*a, **kw)
        losses.append(loss.detach())
        return loss

    recon.recon_loss = loss_spy
    b0, t0 = gn.launches, time.perf_counter()
    try:
        recon.reconstruct_unit(
            model, q, unit, inps, target,
            recon.ReconConfig(iters=FISHER_ITERS, batch_size=CALIB_BATCH,
                              p=2.4, opt_mode="fisher_diag"),
            act_quant=True, cached_grads=grads["cuda", name].cuda())
        torch.cuda.synchronize()
    finally:
        recon.recon_loss = real
    losses = torch.stack(losses).cpu()
    out["fisher_diag_recon"] = {
        "unit": name, "iters": FISHER_ITERS, "seconds":
        time.perf_counter() - t0, "b1_launches": gn.launches - b0,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    check(len(losses) == FISHER_ITERS and bool(torch.isfinite(losses).all()),
          f"fisher_diag reconstruction of {name}: losses {losses.tolist()}")
    check(gn.launches == b0, "fisher_diag reconstruction launched B1")
    return out


def _unit_out(model, qstate, name, x, t):
    """The W4A8 capture of unit `name`'s output for one batch."""
    from qdiffusion_torch.calib.capture import _forward
    from qdiffusion_torch.quant.context import QuantMode

    with torch.no_grad():
        return _forward(model, qstate, QuantMode(w=True, a=True), (name,),
                        x, t)[name][1]


def _calib_act_resume(names: list, work: Path, check: Checks) -> dict:
    """The act pass through the CLI with --run-dir, a spy raising in its
    ACT_CRASH_AT-th reconstruction; then the same command again: it must
    resume from the marker (act, unit 7), reconstruct the 30 units after
    it and leave the restored sites bit-equal to the snapshot files."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib import engine
    from qdiffusion_torch.utils.checkpoints import CalibCheckpointer, \
        load_qstate

    run = work / "calib_act" / "resume"
    argv = _calib_act_argv(work, run, ACT_RESUME_ITERS)
    real, calls = engine.reconstruct_unit, []
    crash = [True]

    def spy(model, qstate, unit, *a, **kw):
        if crash[0] and len(calls) == ACT_CRASH_AT - 1:
            raise RuntimeError("chip_smoke: simulated crash")
        calls.append(unit.name)
        return real(model, qstate, unit, *a, **kw)

    engine.reconstruct_unit = spy
    t0 = time.perf_counter()
    try:
        try:
            cli.main(argv)
            crashed = False
        except RuntimeError as e:
            crashed = "simulated crash" in str(e)
        first_s = time.perf_counter() - t0
        check(crashed, "calib_act resume: the first run did not crash")
        progress = json.loads((run / "calib_progress.json").read_text())
        snap, _ = CalibCheckpointer(run).load()
        done = list(calls)
        calls.clear()
        crash[0] = False
        t0 = time.perf_counter()
        res = cli.main(argv)
    finally:
        engine.reconstruct_unit = real
    want = names[progress["unit_idx"] + 1:]
    check(progress["phase"] == "act" and progress["unit_idx"] == 7,
          f"calib_act resume: marker {progress}, expected act unit 7")
    check(calls == want and len(calls) == len(names) - 8,
          f"calib_act resume: the rerun reconstructed {len(calls)} units "
          f"from {calls[:1]}, expected {len(want)} from {want[:1]}")
    final = load_qstate(res["path"])
    sites = [s for s in snap if any(s == n or s.startswith(n + ".")
                                    for n in names[:progress["unit_idx"] + 1])]
    equal = all(torch.equal(final[s][k][n], t) for s in sites
                for k, st in snap[s].items() for n, t in st.items())
    check(bool(sites) and equal, f"calib_act resume: the {len(sites)} "
                                 "restored sites differ from the snapshot")
    check(not (run / "calib_progress.json").exists(),
          "calib_act resume: the marker is still there")
    return {"iters": ACT_RESUME_ITERS, "crash_in": ACT_CRASH_AT,
            "first_run_units": len(done), "marker": progress,
            "rerun_units": len(calls), "rerun_first": calls[:1],
            "restored_sites": len(sites), "restored_bit_equal": equal,
            "first_s": first_s, "rerun_s": time.perf_counter() - t0}


def _calib_act_int8(task, work: Path, qpath: str, init_q: dict,
                    check: Checks) -> dict:
    """`sample --engine int8` on the calibrated W4A8 qstate (64 images,
    DDIM-100; B4 and B1 counted from 0), then the int8 step's eps on HELD
    inputs against the FP eps, with the calibrated deltas and with the
    init-only ones (the act init's qstate)."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.ops.groupnorm import fused_group_norm as gn
    from qdiffusion_torch.ops.int8_conv import int8_conv
    from qdiffusion_torch.utils.checkpoints import load_qstate

    gn.launches = int8_conv.launches = 0
    res = cli.main(["sample", "--task", "cifar10", "--qstate", qpath,
                    "--weight-bit", "4", "--quant-act", "--split",
                    "--engine", "int8", "--n", str(BATCH), "--batch",
                    str(BATCH), "--npz-out",
                    str(work / "calib_act" / "int8.npz"), "--device",
                    "cuda"])
    launches = {"int8_conv": int8_conv.launches, "group_norm": gn.launches}
    want = {"int8_conv": STEPS * 113, "group_norm": STEPS * 51}
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    check(imgs.shape == (BATCH, 32, 32, 3) and imgs.dtype == np.uint8
          and res["nonfinite"] == 0,
          f"calib_act int8 sample {imgs.shape} {imgs.dtype}, "
          f"{res['nonfinite']} non-finite")
    check(launches == want, f"calib_act int8 sample: launches {launches}, "
                            f"expected {want}")
    model = _seeded_model(task, weight_bit=4, quant_act=True, split=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((HELD, 32, 32, 3), generator=gen, device="cuda")
    t = torch.linspace(0, 999, HELD, device="cuda")
    with torch.no_grad():
        fp = model(x, t).float()

    def rel(q):
        eps = make_quantized_step(model, q, engine="int8")(x, t).float()
        return float(torch.linalg.vector_norm(eps - fp)
                     / torch.linalg.vector_norm(fp))

    calibrated = load_qstate(qpath, "cuda")
    return {"images": int(imgs.shape[0]), "steps": res["steps"],
            "batch_seconds": res["batch_seconds"],
            "img_per_s": BATCH / res["batch_seconds"][-1],
            "launches": launches, "expected_launches": want,
            "image_mean": float(imgs.mean()), "image_std": float(imgs.std()),
            "eps_rel_l2_vs_fp": {"calibrated": rel(calibrated),
                                 "init_only": rel(init_q)}}


# -- quantized-checkpoint export / load (slice 13) ----------------------------

EXPORT_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_export.py: fp16 biases


def phase_export(task, work: Path, smi: str, check: Checks) -> dict:
    """`deploy.export_quantized_checkpoint` of the calib phase's
    full-width W4 --split qstate and its seeded params, then
    `load_quantized_checkpoint` of that file on the card: its bytes
    against the f32 params' (JAX's bound: under a quarter), the reloaded
    quantized weights against `fold_weights`' bit for bit, and one f32
    step at batch 64 of the reloaded model against the fold engine's
    (rtol = atol = 2e-3), B1 launched in both."""
    from qdiffusion_torch.deploy import export_quantized_checkpoint, \
        fold_weights, load_quantized_checkpoint, make_quantized_step
    from qdiffusion_torch.models.unet_ddim import DDIMUNet
    from qdiffusion_torch.ops.groupnorm import fused_group_norm as gn
    from qdiffusion_torch.utils.checkpoints import load_qstate

    model = _seeded_model(task, weight_bit=4, split=True)
    # init_params zeroes every bias, which fp16 holds exactly: seeded
    # biases make the /fp16 leaves round (the qstate's weights stay)
    gen = torch.Generator(device="cuda").manual_seed(14)
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if name.endswith(".bias"):
                v.add_(0.02 * torch.randn(v.shape, generator=gen,
                                          device="cuda"))
    qstate = load_qstate(work / "calib" / "run" / "qstate.npz", "cuda")
    path = work / "export" / "w4.npz"
    gn.launches = 0
    t0 = time.perf_counter()
    manifest = export_quantized_checkpoint(model, qstate, path)
    export_s = time.perf_counter() - t0
    f32_bytes = 4 * sum(p.numel() for p in model.state_dict().values())
    file_bytes = path.stat().st_size
    check(file_bytes < f32_bytes / 4, f"export: {file_bytes} bytes, not "
          f"under a quarter of the f32 params' {f32_bytes}")
    want_layers = [n for n in model.layer_cfgs if "w" in qstate.get(n, {})]
    check(sorted(manifest) == sorted(want_layers),
          f"export: manifest {len(manifest)} layers, qstate "
          f"{len(want_layers)}")
    check(len(model.units) == 38 and any(v["split"]
                                         for v in manifest.values()),
          f"export: {len(model.units)} units, split layers "
          f"{sum(bool(v['split']) for v in manifest.values())}")
    t0 = time.perf_counter()
    sd, loaded = load_quantized_checkpoint(path)
    sd = {k: v.to("cuda") for k, v in sd.items()}
    load_s = time.perf_counter() - t0
    check(loaded == json.loads(json.dumps(manifest)),
          "export: the file's manifest is not the one returned")
    folded = fold_weights(model, qstate)
    differ = [n for n in manifest if not torch.equal(
        sd[f"{n}.weight"], folded[f"{n}.weight"])]
    check(not differ, f"export: reloaded weights differ from fold_weights' "
                      f"at {differ}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((BATCH, 32, 32, 3), generator=gen, device="cuda")
    t = torch.linspace(0, 999, BATCH, device="cuda")
    b0 = gn.launches
    want = make_quantized_step(model, qstate, "fold")(x, t)
    fold_launches = gn.launches - b0
    reloaded = DDIMUNet(model.cfg, model.policy, device="cuda")
    reloaded.load_state_dict(sd)
    b0 = gn.launches
    with torch.no_grad():
        got = reloaded(x, t)
    reload_launches = gn.launches - b0
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **EXPORT_TOL))
    check(ok, f"export: reloaded step max abs err {err} over {EXPORT_TOL}")
    check(fold_launches == 51 and reload_launches == 51,
          f"export: B1 launches {fold_launches} (fold), {reload_launches} "
          "(reloaded), expected 51 each")
    row = {"phase": "export", "nvidia_smi": smi,
           "layers": len(manifest), "units": len(model.units),
           "file_bytes": file_bytes, "f32_param_bytes": f32_bytes,
           "bytes_ratio": file_bytes / f32_bytes,
           "int4_layers": sum(v["bits"] <= 4 for v in manifest.values()),
           "export_s": export_s, "load_s": load_s,
           "bit_equal_layers": len(manifest) - len(differ),
           "fp16_rounded_biases": sum(
               not torch.equal(sd[k], v) for k, v in
               model.state_dict().items() if k.endswith(".bias")),
           "step_max_abs_err": err, "step_tolerance": EXPORT_TOL,
           "step_rel_l2": float(torch.linalg.vector_norm(got - want)
                                / torch.linalg.vector_norm(want)),
           "b1_launches": gn.launches}
    _emit(row)
    return row


# -- the quality-evidence harness (slice 13) ----------------------------------

# tests/test_quality_evidence.py:46-48, the JAX test's settings (not cut)
QUALITY = dict(train_steps=2500, n_samples=384, recon_iters=1000, bits=4,
               sample_steps=50, cali_n=48, cali_st=5, seed=0,
               act_quant=True)


def quality_gn_shapes() -> list:
    """(B, H, W, C) of every GroupNorm input of one call of the harness's
    TINY UNet at its sampling batch, in call order."""
    from qdiffusion_torch.models.unet_ddim import DDIMUNet
    from qdiffusion_torch.scripts import quality_evidence as qe

    model = DDIMUNet(qe.CFG, device="cuda")
    with gn_spy() as spy, torch.no_grad():
        model(torch.zeros(1, qe.RES, qe.RES, 3, device="cuda"),
              torch.zeros(1, device="cuda"))
    return [(QUALITY["n_samples"],) + s[1:] for _, s in spy.seen]


def phase_quality(smi: str, check: Checks) -> dict:
    """`run_protocol` of qdiffusion_torch/scripts/quality_evidence.py at
    the JAX test's settings (QUALITY), held to that test's five bounds.
    B1's launches are read around every part of the protocol and, by
    spies in the engine, around its captures, act init, EMA sweep and
    reconstructions: 0 in training and in every reconstruction, launched
    in every sampling arm, the captures, the act inits and the sweep.
    Every reconstruction's block error on its captured inputs is printed
    (weight pass: nearest rounding and learned; act pass: init/EMA deltas
    and learned, with the deltas below the lr). Then B1 against its plain
    version at every distinct shape the spy saw, f32. (B1's time at the
    sampling call's shapes is taken by the caller, `quality_gn_time`.)"""
    from qdiffusion_torch.calib import capture, engine
    from qdiffusion_torch.ops.groupnorm import fused_group_norm as gn, \
        group_norm_plain
    from qdiffusion_torch.scripts import quality_evidence as qe

    parts: dict = {}
    sub = {k: 0 for k in ("fp_capture", "quant_capture", "act_init",
                          "ema_sweep", "reconstructions")}
    units = []
    real = (engine.reconstruct_unit, engine.init_act_qstate,
            engine.run_running_stat, capture.GroupedCapture.fp_capture,
            capture.GroupedCapture.quant_capture)

    @contextlib.contextmanager
    def part(name):
        b0 = gn.launches
        yield
        parts[name] = gn.launches - b0

    def counted(key, fn):
        def spy(*a, **kw):
            b0 = gn.launches
            res = fn(*a, **kw)
            sub[key] += gn.launches - b0
            return res
        return spy

    def recon_spy(model, qstate, unit, inps, target, cfg, **kw):
        acts = kw.get("act_quant", False)
        start = qstate if acts else _nearest(qstate, unit)
        b0 = gn.launches
        before = _block_mse(unit, start, inps, target, acts=acts)
        b1 = gn.launches
        new = real[0](model, qstate, unit, inps, target, cfg, **kw)
        b2 = gn.launches
        after = _block_mse(unit, new, inps, target, acts=acts)
        sub["reconstructions"] += b2 - b1
        units.append({"pass": "act" if acts else "weight",
                      "unit": unit.name, "kind": unit.kind,
                      "mse_before": before, "mse_after": after,
                      "ratio": after / before if before else None,
                      "recon_b1_launches": b2 - b1,
                      "error_b1_launches": (b1 - b0) + (gn.launches - b2)})
        return new

    engine.reconstruct_unit = recon_spy
    engine.init_act_qstate = counted("act_init", real[1])
    engine.run_running_stat = counted("ema_sweep", real[2])
    capture.GroupedCapture.fp_capture = counted("fp_capture", real[3])
    capture.GroupedCapture.quant_capture = counted("quant_capture", real[4])
    stats, lines = {}, []

    def log(msg):  # the protocol's progress, to stderr as it goes
        lines.append(msg)
        print(f"quality {time.perf_counter() - T_START:8.1f} s: {msg}",
              file=sys.stderr, flush=True)

    gn.launches = 0
    t0 = time.perf_counter()
    try:
        with gn_spy() as spy:
            out = qe.run_protocol(**QUALITY, log=log, device="cuda",
                                  stats=stats, part=part)
    finally:
        (engine.reconstruct_unit, engine.init_act_qstate,
         engine.run_running_stat, capture.GroupedCapture.fp_capture,
         capture.GroupedCapture.quant_capture) = real
    wall_s = time.perf_counter() - t0
    # the block-error sweeps run inside the calibration parts
    error_launches = sum(r["error_b1_launches"] for r in units)
    path_launches = gn.launches - error_launches

    bounds = {
        "fid_naive > 3 fid_fp": out["fid_naive"] > 3 * out["fid_fp"],
        "fid_calib < 0.5 fid_naive":
            out["fid_calib"] < 0.5 * out["fid_naive"],
        "recovered_frac > 0.4": out["recovered_frac"] > 0.4,
        "fid_calib_a8 < fid_naive_a8":
            out["fid_calib_a8"] < out["fid_naive_a8"],
        "fid_calib_a8 < 0.6 fid_naive":
            out["fid_calib_a8"] < 0.6 * out["fid_naive"]}
    for what, ok in bounds.items():
        check(ok, f"quality: {what} fails: {out}")
    check(all(np.isfinite(v) for v in out.values()
              if isinstance(v, float)), f"quality: non-finite {out}")
    check(parts.get("train") == 0,
          f"quality: B1 launched {parts.get('train')} times in training")
    check(sub["reconstructions"] == 0, f"quality: B1 launched "
          f"{sub['reconstructions']} times inside the reconstructions")
    for name in ("sample_fp", "sample_naive", "sample_calib", "naive_a8",
                 "sample_naive_a8", "sample_calib_a8"):
        check(parts.get(name, 0) > 0, f"quality: B1 not launched in {name}")
    for name in ("fp_capture", "quant_capture", "act_init", "ema_sweep"):
        check(sub[name] > 0, f"quality: B1 not launched in {name}")
    passes = {p: sum(r["pass"] == p for r in units) for p in ("weight",
                                                               "act")}
    check(passes["weight"] > 0 and passes["act"] > 0,
          f"quality: reconstructions {passes}")

    # B1 against its plain version at every distinct shape it ran at
    seen = sorted({s for _, s in spy.seen})
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = 0.0
    for shape in seen:
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5
        scale = 1.0 + 0.5 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.5 * torch.randn(c, generator=gen, device="cuda")
        y, ref = gn(x, scale, bias), group_norm_plain(x, scale, bias)
        err = float((y - ref).abs().max())
        worst = max(worst, err)
        check(bool(torch.allclose(y, ref, **TOL[torch.float32])),
              f"quality: group_norm {shape}: max abs err {err}")
    below = stats.get("deltas_below_lr", {})
    row = {"phase": "quality", "nvidia_smi": smi, "settings": QUALITY,
           **out, "bounds": bounds, "seconds": stats["seconds"],
           "wall_s_protocol": wall_s,
           "peak_device_gb": stats.get("peak_device_gb"),
           "train_loss": stats.get("train_loss"),
           "deltas_below_lr": {u: s for u, s in below.items() if s},
           "act_units": len(below),
           "b1_launches": {"parts": parts, "engine": sub,
                           "block_error_sweeps": error_launches,
                           "path": path_launches},
           "b1_shapes": [list(s) for s in seen],
           "b1_max_abs_err": worst,
           "reconstructions": {
               p: {"units": passes[p], "worst_ratio": max(
                   (r["ratio"] for r in units
                    if r["pass"] == p and r["ratio"] is not None),
                   default=None)} for p in passes},
           "below_lr_act_ratios": {r["unit"]: r["ratio"] for r in units
                                   if r["pass"] == "act"
                                   and below.get(r["unit"])}}
    _emit(row)
    for r in units:
        _emit({"phase": "quality_unit", **r})
    row["units"], row["log"] = units, lines
    return row


def quality_gn_time(gn_call: list, designs: dict, check: Checks) -> dict:
    """B1 at the GroupNorm shapes of one TINY sampling call of the
    quality phase, f32, as in 1: per-call sums of the rows."""
    rows = phase_kernels(gn_call, check, designs, dtypes=(torch.float32,),
                         phase="gn_quality",
                         where=f"quality TINY UNet call, batch "
                               f"{QUALITY['n_samples']}")
    return {**{k: sum(r[k] * r["per_call"] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "bytes_ms",
                         "ops_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "rows": rows}


def start_quality(out: Path):
    """The quality phase in a process of its own (`--quality-only`),
    started before the build: it is host-bound and holds under 1 GB of
    the card. Inline it would add about 230 s to a smoke near 870 s, and
    beside the phases that report no time alone the smoke waited 109 s
    for it (PERF.md section 4), so the CIFAR calibration phases run
    beside it too; every phase emitted until the join is tagged (_emit).
    Its report lands in out/quality."""
    global BESIDE_QUALITY
    import subprocess

    BESIDE_QUALITY = []
    qdir = out / "quality"
    qdir.mkdir(parents=True, exist_ok=True)
    (qdir / "quality.json").unlink(missing_ok=True)
    logs = [open(qdir / name, "w") for name in ("stdout.txt", "stderr.txt")]
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--quality-only",
         "--out", str(qdir)], stdout=logs[0], stderr=logs[1],
        cwd=str(Path(__file__).resolve().parent))
    return proc, qdir, logs


def join_quality(started, smi: str, check: Checks,
                 timeout: float = 700.0) -> dict:
    """Wait for the quality process and read its report; a report that
    is missing or names failed checks fails here. The report's row names
    the phases that ran beside it (`beside`)."""
    global BESIDE_QUALITY
    proc, qdir, logs = started
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in logs:
            f.close()
    waited = time.perf_counter() - t0
    beside = sorted(set(BESIDE_QUALITY or []))
    BESIDE_QUALITY = None
    path = qdir / "quality.json"
    if not path.exists():
        tail = (qdir / "stderr.txt").read_text()[-3000:]
        check(False, f"quality: no report (exit {proc.returncode}): {tail}")
        return {"b1_launches": {"path": 0}, "failed": ["no report"]}
    row = json.loads(path.read_text())
    for what in row.get("failed", []):
        check(False, what)
    check(rc == 0, f"quality: process exit {rc}")
    row["beside"] = beside
    _emit({**{k: v for k, v in row.items() if k not in ("units", "log")},
           "phase": "quality", "nvidia_smi": smi, "waited_s": waited})
    return row


def quality_only(out: Path) -> int:
    """`chip_smoke.py --quality-only`: the quality phase alone, its
    report (with the checks that failed) to out/quality.json; exit 1 if
    a check failed."""
    from qdiffusion_torch import resolve_device

    resolve_device("cuda")
    out.mkdir(parents=True, exist_ok=True)
    check = Checks()
    smi = nvidia_smi()
    row = phase_quality(smi, check)
    row["failed"] = check.failed
    (out / "quality.json").write_text(json.dumps(row, indent=1))
    print(smi, flush=True)
    return 1 if check.failed else 0


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


def _kernel_names(run, family: str, tries: int = 3):
    """`run()` under torch.profiler, and the names of what it recorded.
    Reliable only before the process captures its first CUDA graph: after
    one, the profiler here (torch 2.11, CUDA 12.8) keeps only some kernels
    of a short window (at times the last one alone), so `probe_designs`
    calls it before any phase times a graph. Even then a window at times
    holds no kernel of the run (once, for one B2 case, on an H100), so
    a window with no name containing `family` is profiled again, up to
    `tries` windows in all; which kernel ran is left to the caller."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a kernel of PyTorch's own first: once the profiler has run
            # earlier in the process, it records no kernel of a window
            # until PyTorch launches one
            torch.zeros(1, device="cuda").add_(1)
            out = run()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        if any(family in n for n in names):
            break
    return out, names


FLASH_DESIGNS = {"mma": "flash_mma_kernel", "tf32": "flash_tf32_kernel",
                 "wide": "flash_wide_kernel"}


def _flash_design(names) -> str:
    """The flash design that kernel names show ("mma", "tf32" or "wide",
    FLASH_DESIGNS), or None when they show none or more than one."""
    seen = [d for d, k in FLASH_DESIGNS.items()
            if any(k in n for n in names)]
    return seen[0] if len(seen) == 1 else None


def want_flash_design(dtype, d: int) -> str:
    """The design qdt_flash_attention dispatches (dtype, head dim) to."""
    if d > 128:
        return "wide"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _stream_design(names, splits: int):
    """"mma" when the names show B5/B6's Hopper kernel, stream_mma_kernel,
    with stream_reduce_kernel exactly when K is split, else None (the
    first design was stream_kernel)."""
    mma = any("stream_mma_kernel" in n for n in names)
    reduce = any("stream_reduce_kernel" in n for n in names)
    return "mma" if mma and reduce == (splits > 1) else None


# (kernel, shape, sites per SD call or decode, dtypes, quantizers on) of
# B2 / B3; (2, 4096, 8, 40) is P's shape, on no SD fold site; in f32 it and
# (2, 1024, 8, 80) are the 10 flash sites of one SD stream call (batch 2,
# f32) and (1, 4096, 1, 512) the stream decode's B3, where SDPA in f32 is
# timed as the yardstick
_BOTH = (torch.bfloat16, torch.float32)
ATTN_CASES = [
    ("flash_attention", (8, 4096, 8, 40), 5, _BOTH, (False, True)),
    ("flash_attention", (8, 1024, 8, 80), 5, _BOTH, (False, True)),
    ("flash_streaming", (4, 4096, 1, 512), 1, _BOTH, (False, True)),
    ("flash_attention", P_SHAPE, 0, (torch.bfloat16,), (False,)),
    ("flash_attention", (2, 4096, 8, 40), 5, (torch.float32,), (False,)),
    ("flash_attention", (2, 1024, 8, 80), 5, (torch.float32,), (False,)),
    ("flash_streaming", (1, 4096, 1, 512), 1, (torch.float32,), (False,))]
STREAM_ATTN = {(2, 4096, 8, 40), (2, 1024, 8, 80), (1, 4096, 1, 512)}
# the LSUN paths' shapes, (kernel, shape, sites per call or decode, dtypes,
# quantizers on): the beds UNet's 14 heads of 32 and the churches UNet's
# 8 heads of 24 (D class 32, zero-padded) at 32x32 tokens, in bf16 (fold,
# batch 8) and f32 (the trajectory; stream at batch 1); the churches
# KL-f8 decode's mid attention at 1024 tokens, which the TPU cost model
# sends to B2 (its wide design); the beds VQ-f4 decode's at 4096 tokens
# (B3); and B3 at 1024 keys, held against its plain version though no
# path sends that shape to it
LSUN_ATTN_CASES = [
    ("flash_attention", (8, 1024, 14, 32), 5, _BOTH, (False, True)),
    ("flash_attention", (8, 1024, 8, 24), 5, _BOTH, (False, True)),
    ("flash_attention", (1, 1024, 14, 32), 5, (torch.float32,), (False,)),
    ("flash_attention", (1, 1024, 8, 24), 5, (torch.float32,), (False,)),
    ("flash_attention", (8, 1024, 1, 512), 1, (torch.bfloat16,), (False,)),
    ("flash_streaming", (8, 4096, 1, 512), 1, (torch.bfloat16,), (False,)),
    ("flash_streaming", (8, 1024, 1, 512), 0, _BOTH, (False, True))]


def _stream_operands(kernel, M, K, N, gen):
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
    return x, w, scale, shift, bias


def probe_designs(gn_shapes, streams=()) -> dict:
    """Kernel names of one launch of every B2/B3 case of `ATTN_CASES`, of
    B5/B6 at every shape of an SD stream call (the fixed lists of
    ops/int8_matmul.py, which the int_kernels phase holds its spies'
    shapes to) and at each (kernel, (M, K, N)) of `streams`, and of B1 at
    each of `gn_shapes` in bf16 and f32, each
    under torch.profiler before any CUDA graph exists in the process:
    {(kernel, shape, dtype, quant) or (kernel, (M, K, N)) or
    ("group_norm", shape, dtype): names}."""
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream
    from qdiffusion_torch.ops.int8_matmul import SD_STREAM_W4, \
        SD_STREAM_W8, int8_dense_stream

    fns = {"flash_attention": flash_attention,
           "flash_streaming": streaming_flash_attention,
           "int4_stream_matmul": int4_dense_stream,
           "int8_stream_matmul": int8_dense_stream}
    out = {}
    for seed, (name, shape, _, dtypes, quants) in enumerate(
            ATTN_CASES + LSUN_ATTN_CASES):
        for dtype in dtypes:
            for quant in quants:
                (q, k, v), sm_q, v_q = _attn_case(shape, dtype, quant, seed)
                _, out[(name, shape, dtype, quant)] = _kernel_names(
                    lambda: fns[name](q, k, v, scale=shape[-1] ** -0.5,
                                      sm_q=sm_q, v_q=v_q), "flash")
                del q, k, v
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [("int4_stream_matmul", s) for s in SD_STREAM_W4] + [
        ("int8_stream_matmul", s) for s in SD_STREAM_W8] + list(streams)
    for kernel, (M, K, N) in dict.fromkeys(cases):
        x, w, scale, shift, bias = _stream_operands(kernel, M, K, N, gen)
        _, out[(kernel, (M, K, N))] = _kernel_names(
            lambda: fns[kernel](x, w, scale, shift, bias=bias), "stream_")
    for shape in sorted(set(gn_shapes)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.ones(shape[-1], device="cuda", dtype=dtype)
            _, out[("group_norm", shape, dtype)] = _kernel_names(
                lambda: fused_group_norm(x, w, w), "group_norm")
            del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def phase_attn_kernels(check: Checks, designs: dict, cases=ATTN_CASES,
                       path: str = "sd_v1", first_seed: int = 0,
                       f32_library=STREAM_ATTN) -> list:
    """B2 and B3 at `cases` (the SD and VAE shapes; B2 also at P's shape in
    bf16 and at the SD stream call's shapes in f32) against their plain
    versions, timed in CUDA graphs over inputs that outgrow the L2. Case i
    draws its inputs from seed first_seed + i, as `probe_designs` did.
    SDPA is timed beside every case without quantizers in bf16, and in f32
    at the shapes of `f32_library`. `designs`: `probe_designs`' kernel
    names."""
    from qdiffusion_torch.ops.flash_attention import bucket_flip_share, \
        flash_attention, flash_attention_plain
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention, streaming_flash_attention_plain

    fns = {"flash_attention": (flash_attention, flash_attention_plain),
           "flash_streaming": (streaming_flash_attention,
                               streaming_flash_attention_plain)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for seed, (name, shape, per_call, dtypes, quants) in enumerate(
            cases, first_seed):
        fn, plain = fns[name]
        d = shape[-1]
        scale = d ** -0.5
        for dtype in dtypes:
            for quant in quants:
                (q, k, v), sm_q, v_q = _attn_case(shape, dtype, quant, seed)
                kw = dict(scale=scale, sm_q=sm_q, v_q=v_q)
                got = fn(q, k, v, **kw)
                design = _flash_design(designs[(name, shape, dtype, quant)])
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
                    beyond = float((diff > 5e-5).float().mean())
                    ok = err <= 5e-5 + flip and beyond <= 1e-3
                check(ok, f"{name} {shape} {dtype} quant={quant}: max abs "
                          f"err {err} over {tol}")
                # the dispatch of qdt_flash_attention, as the profiler saw it
                want_design = want_flash_design(dtype, d)
                check(design == want_design,
                      f"{name} {shape} {dtype} quant={quant}: ran the "
                      f"{design} design, not {want_design}")
                del got, want, diff
                flips = None
                if quant:  # p as it fed PV, against the plain version's
                    flips = bucket_flip_share(fn, plain, q, k, scale=scale,
                                              sm_q=sm_q)
                    check(flips <= 1e-3,
                          f"{name} {shape} {dtype}: {flips} of the quantized "
                          "softmax probabilities differ from the plain "
                          "version's (limit 1e-3)")
                es = q.element_size()
                sets = rotations(lambda: tuple(a.clone() for a in (q, k, v)),
                                 3 * q.numel() * es)
                row = {
                    "phase": "attn_kernel", "path": path, "kernel": name,
                    "shape": list(shape),
                    "dtype": str(dtype).replace("torch.", ""),
                    "quant": quant, "per_call": per_call,
                    "design": design,
                    "max_abs_err": err, "tolerance": tol, "ok": ok,
                    "bucket_flip_share": flips,
                    "share_beyond_5e-5": beyond if dtype == torch.float32
                    and quant else None,
                    "ms": _graph_ms([lambda s=s: fn(*s, **kw)
                                     for s in sets], min_calls=10),
                    "plain_ms": _graph_ms([lambda s=s: plain(*s, **kw)
                                           for s in sets], min_calls=2),
                    # one PyTorch call computes the unquantized function
                    "library_ms": _graph_ms([lambda s=s: sdpa(
                        *(a.transpose(1, 2) for a in s), scale=scale)
                        for s in sets], min_calls=10)
                    if not quant and (dtype == torch.bfloat16
                                      or shape in f32_library) else None,
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


def _rel_row(tag: str, got, ref, check: Checks) -> dict:
    """Card against CPU within REL_L2_CARD_VS_CPU relative L2."""
    rel = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    check(bool(torch.isfinite(got).all()), f"{tag} on the card not finite")
    check(rel <= REL_L2_CARD_VS_CPU,
          f"{tag}, card bf16 vs CPU f32: relative L2 {rel}")
    return {"rel_l2": rel, "tolerance": REL_L2_CARD_VS_CPU,
            "max_abs_err": float((got - ref).abs().max()),
            "ref_abs_max": float(ref.abs().max())}


def _fold_card_vs_cpu(tag: str, build, args: tuple, check: Checks,
                      sample=None) -> dict:
    """One fold W4 UNet call, card bf16 (B1, and B2 at the five 1024-token
    sites) against CPU f32 within REL_L2_CARD_VS_CPU relative L2:
    `build(dev)` gives the folded f32 model on `dev`, `args` the call's
    CPU inputs, x first (cast to bf16 on the card). `sample(model, dev,
    dtype)`, when given, runs on the same models: its result is held to
    the same bound, and its B2 launches on the card are returned."""
    from qdiffusion_torch.ops.flash_attention import flash_attention

    eps, out, b2, b2_sample = {}, {}, 0, 0
    for dev, dtype in (("cpu", None), ("cuda", torch.bfloat16)):
        model = build(dev)
        xs = [None if a is None else a.to(dev) for a in args]
        if dtype is not None:
            model.to(dtype)
            xs[0] = xs[0].to(dtype)
        n = flash_attention.launches
        with torch.no_grad():
            eps[dev] = model(*xs).float().cpu()
        b2 = flash_attention.launches - n if dev == "cuda" else b2
        if sample is not None:
            n = flash_attention.launches
            out[dev] = sample(model, dev, dtype).float().cpu()
            b2_sample = flash_attention.launches - n
        del model
    check(b2 == 5, f"{tag} card vs CPU: {b2} B2 launches, expected 5")
    row = {**_rel_row(f"{tag} fold call", eps["cuda"], eps["cpu"], check),
           "flash_attention_launches": b2}
    if sample is not None:
        row["sample"] = {**_rel_row(f"{tag} fold sample", out["cuda"],
                                    out["cpu"], check),
                         "flash_attention_launches": b2_sample}
    return row


def phase_sd_card_vs_cpu(task, work: Path, check: Checks) -> dict:
    """One fold W4 UNet call with context at 32x32 latents, batch 1 (2
    until the LSUN phases needed the time), then on the same models a
    DPM-Solver sample (SD_DPM_CPU_STEPS, its order-2 multistep update
    reached, CFG 7.5 over [uncond; cond]) from the same latents: card
    bf16 against CPU f32."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.cli import load_fp_params
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.deploy import fold_weights
    from qdiffusion_torch.models.unet_ldm import LDMUNet
    from qdiffusion_torch.pipelines import LatentDiffusionPipeline
    from qdiffusion_torch.utils.checkpoints import load_qstate

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(
        np.float32))[:1]
    t = torch.tensor([10.0])
    c, u = torch.from_numpy(rng.standard_normal((2, 77, 768)).astype(
        np.float32)).split(1)

    def build(dev):
        model = LDMUNet(task.unet_ldm, QuantFlags(weight_bit=4).policy_ldm(),
                        device=dev)
        model.load_state_dict(load_fp_params(work / "unet.npz", model))
        model.load_state_dict(fold_weights(
            model, load_qstate(work / "w4_qstate.npz", dev)))
        return model

    def sample(model, dev, dtype):
        """DPM-Solver (multistep order 2, SD_DPM_CPU_STEPS, CFG 7.5) on
        the same model, batch 1, from x."""
        pipe = LatentDiffusionPipeline(unet=model, vae=None,
                                       schedule=cli._schedule(task))
        return pipe.sample(
            1, sampler="dpm_solver", steps=SD_DPM_CPU_STEPS,
            cond=c.to(dev), uncond=u.to(dev), guidance_scale=7.5,
            decode=False, x_init=x.to(dev), eval_dtype=dtype,
            model_fn=lambda x, t, ctx: model(x, t, None, ctx))

    row = {"phase": "sd_card_vs_cpu", "batch": 1, "latent": 32,
           **_fold_card_vs_cpu("sd", build, (x, t, None, c), check,
                               sample)}
    b2 = row["sample"]["flash_attention_launches"]
    check(b2 == 5 * SD_DPM_CPU_STEPS, f"sd dpm_solver card vs CPU: {b2} B2 "
                                      f"launches, expected "
                                      f"{SD_DPM_CPU_STEPS} x 5")
    row["sample"]["steps"] = SD_DPM_CPU_STEPS
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


# -- Stable Diffusion v1 calibration: the latent models' path ---------------

def _kernel_counters(*names) -> dict:
    """Each kernel's launching wrapper, whose `.launches` is its count, by
    the name the kernels line gives it: `names`, or every kernel but P."""
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.ops.int4_matmul import int4_stream_matmul
    from qdiffusion_torch.ops.int8_conv import int8_conv
    from qdiffusion_torch.ops.int8_matmul import int8_stream_matmul

    table = {"group_norm": fused_group_norm,
             "flash_attention": flash_attention,
             "flash_streaming": streaming_flash_attention,
             "int8_conv": int8_conv,
             "int4_stream_matmul": int4_stream_matmul,
             "int8_stream_matmul": int8_stream_matmul}
    return {k: table[k] for k in names or table}


def _launch_counts() -> dict:
    """B1/B2/B3's launch counts now, and B2's launches with sm_q."""
    counters = _kernel_counters("group_norm", "flash_attention",
                                "flash_streaming")
    out = {k: f.launches for k, f in counters.items()}
    out["flash_attention_sm_q"] = counters["flash_attention"].launches_sm_q
    return out


class _Parts:
    """Seconds, calls and kernel launches of the parts of a run, each
    call timed between two synchronisations."""

    def __init__(self):
        self.parts: dict = {}

    def __call__(self, key, fn, *a, **kw):
        torch.cuda.synchronize()
        c0, t0 = _launch_counts(), time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: v - c0[k] for k, v in _launch_counts().items()}
        p = self.parts.setdefault(key, {"seconds": 0.0, "calls": 0,
                                        **{k: 0 for k in got}})
        p["seconds"] += sec
        p["calls"] += 1
        for k, v in got.items():
            p[k] += v
        return res, sec, got


class _CalibSpies:
    """The calibration engine's parts under spies for the length of a
    `with`, each timed into `parts` with its launches: every
    reconstruction (its unit's block error before and after it, on the
    unit's captured inputs, into `units[pass]`), the FP and asym
    captures, the act init, the EMA sweep and the snapshots. `kept[pass]`
    gets the inputs, target and sites of unit `keep`; `on_act_start` is
    called before the first act init (the act pass begins)."""

    def __init__(self, parts: "_Parts", batch: int, keep: str = None,
                 on_act_start=None):
        self.parts, self.batch, self.keep = parts, batch, keep
        self.on_act_start = on_act_start
        self.units = {"weight": [], "act": []}
        self.kept: dict = {}

    def __enter__(self):
        from qdiffusion_torch.calib import capture, engine, recon
        from qdiffusion_torch.utils import checkpoints

        parts, units, kept = self.parts, self.units, self.kept
        self.targets = ((engine, "reconstruct_unit"),
                        (capture.GroupedCapture, "fp_capture"),
                        (capture.GroupedCapture, "quant_capture"),
                        (engine, "init_act_qstate"),
                        (engine, "run_running_stat"),
                        (checkpoints.CalibCheckpointer, "save"))
        real = self.real = [getattr(m, a) for m, a in self.targets]

        def recon_spy(model, qstate, unit, inps, target, cfg, **kw):
            act = kw.get("act_quant", False)
            small = recon.deltas_below_lr(qstate, unit, cfg.lr,
                                          kw.get("sm_abit", 8)) if act else []
            start = qstate if act else _nearest(qstate, unit)
            before = parts("block_error", _block_mse, unit, start, inps,
                           target, self.batch, act)[0]
            if unit.name == self.keep:
                kept["act" if act else "weight"] = dict(
                    inps=tuple(a.cpu() for a in inps), out=target.cpu(),
                    qstate=_to({s: qstate[s] for s in recon._sites(unit)
                                if s in qstate}, "cpu"))
            new, sec, got = parts(f"recon_{unit.kind}", real[0], model,
                                  qstate, unit, inps, target, cfg, **kw)
            after = parts("block_error", _block_mse, unit, new, inps,
                          target, self.batch, act)[0]
            units["act" if act else "weight"].append({
                "unit": unit.name, "kind": unit.kind, "recon_s": sec,
                "ms_per_iter": sec / cfg.iters * 1e3, "launches": got,
                "mse_before": before, "mse_after": after,
                "ratio": after / before,
                "deltas_below_lr": [f"{s}/{k}" for s, k in small]})
            return new

        def init_spy(*a, **kw):
            if self.on_act_start is not None \
                    and "act_init" not in parts.parts:
                self.on_act_start()
            return parts("act_init", real[3], *a, **kw)[0]

        def timed(key, fn):
            return lambda *a, **kw: parts(key, fn, *a, **kw)[0]

        spies = (recon_spy, timed("fp_capture", real[1]),
                 timed("asym_capture", real[2]), init_spy,
                 timed("ema_sweep", real[4]), timed("snapshots", real[5]))
        for (m, a), fn in zip(self.targets, spies):
            setattr(m, a, fn)
        return self

    def __exit__(self, *exc):
        for (m, a), fn in zip(self.targets, self.real):
            setattr(m, a, fn)


def _calib_checks(tag: str, parts: "_Parts", units: dict, want: dict,
                  check: Checks) -> dict:
    """The checks of a spied calibration: each pass reconstructed the
    units of `want[pass]` in order; B1/B2/B3 never launched inside a
    reconstruction; the captures, act init and EMA launched B1 and never
    B2/B3; each unit's block error after at most RECON_BOUND x before
    (units with a trained delta below the lr exempt, and printed), the
    sums lower. Returns the quality summary per pass."""
    for what, names in want.items():
        check([r["unit"] for r in units[what]] == names,
              f"{tag} {what} pass reconstructed {len(units[what])} of "
              f"{len(names)} units")
    zero = ("group_norm", "flash_attention", "flash_streaming")
    for what, rows in units.items():
        inside = [r["unit"] for r in rows
                  if any(r["launches"][k] for k in zero)]
        check(not inside, f"{tag} {what} pass: B1/B2/B3 launched inside "
                          f"the reconstructions of {inside[:4]}")
    for key in ("fp_capture", "asym_capture", "act_init", "ema_sweep"):
        p = parts.parts.get(key, {})
        check(p.get("calls", 0) > 0 and p["group_norm"] > 0,
              f"{tag} {key}: {p.get('calls', 0)} calls, B1 "
              f"{p.get('group_norm')} launches")
        check(p.get("flash_attention", 1) == 0
              and p.get("flash_streaming", 1) == 0,
              f"{tag} {key}: B2/B3 launched {p.get('flash_attention')} / "
              f"{p.get('flash_streaming')} times (they materialize)")
    quality = {}
    for what, rows in units.items():
        held = [r for r in rows if not r["deltas_below_lr"]]
        for r in held:
            check(r["ratio"] <= RECON_BOUND,
                  f"{tag} {what} {r['unit']}: block error {r['ratio']} x "
                  f"the start's, bound {RECON_BOUND}")
        before = sum(r["mse_before"] for r in held)
        after = sum(r["mse_after"] for r in held)
        check(after < before, f"{tag} {what} pass: sum of block errors "
                              f"{after} not below {before}")
        exempt = {r["unit"]: {"ratio": r["ratio"],
                              "deltas": r["deltas_below_lr"]}
                  for r in rows if r["deltas_below_lr"]}
        print(f"{tag} {what} pass: exempt units (a trained delta below "
              f"the lr): {exempt or 'none'}", flush=True)
        quality[what] = {"units": len(rows), "held": len(held),
                         "mse_before_sum": before, "mse_after_sum": after,
                         "worst_ratio": max((r["ratio"] for r in held),
                                            default=None),
                         "below_lr_units": exempt}
    return quality


def _sd_calib_argv(work: Path, run: str, *extra) -> list:
    return ["calibrate", "--task", "sd_v1", "--ckpt", str(work / "unet.npz"),
            "--cali-data", str(work / "calib_sd" / "traj.npz"),
            "--weight-bit", "4", "--split", "--alpha-dtype", "bfloat16",
            "--cali-st", str(SDC_ST), "--cali-n", str(SDC_CALI_N),
            "--cali-batch-size", str(SDC_BATCH), "--act-init-batch",
            str(SDC_BATCH), "--run-dir", str(work / "calib_sd" / run),
            "--device", "cuda", *extra]


def _sd_sample_argv(work: Path, qstate: str, out: str, *extra) -> list:
    return ["sample", "--task", "sd_v1", "--ckpt", str(work / "unet.npz"),
            "--vae-ckpt", str(work / "vae.npz"),
            "--clip-ckpt", str(work / "clip.npz"),
            "--token-ids", str(work / "token_ids.npz"), "--qstate", qstate,
            "--weight-bit", "4", "--split", "--n", "1", "--batch", "1",
            "--timesteps", str(SDC_SAMPLE_STEPS), "--npz-out",
            str(work / "calib_sd" / out), "--device", "cuda", *extra]


def phase_calib_sd(task, work: Path, spy: dict, smi: str,
                   check: Checks) -> dict:
    """The latent models' calibration at full SD v1 width through the CLI,
    shaped as the JAX package's flagship run (W4A8, --split, --sm-abit 16,
    --running-stat, bf16 alphas, batch 4): make-cali-data --token-ids
    (PLMS-50, CFG 7.5, f32), calibrate (the weight pass over every unit),
    calibrate --resume-w --quant-act (the act pass), then PLMS-5 samples
    of both qstates (fold, and sim W4A8 with B2's 16-bit softmax
    quantizer). Spies time every part and count B1/B2/B3 launches in each;
    every unit's block error is held before and after its
    reconstruction. Then SDC_UNIT reconstructed on the card and on the
    CPU from the same captures, and B2's bucket-flip share at a 16-bit
    softmax quantizer."""
    from qdiffusion_torch import cli

    work_c = work / "calib_sd"
    traj = work_c / "traj.npz"
    calls = SD_STEPS + 1
    unet, dec = spy["unet_call"], spy["decode"]
    parts = _Parts()
    c0 = _launch_counts()
    made = parts("trajectory", cli.main, [
        "make-cali-data", "--task", "sd_v1", "--ckpt", str(work / "unet.npz"),
        "--clip-ckpt", str(work / "clip.npz"), "--token-ids",
        str(work / "token_ids.npz"), "--n", str(SDC_N), "--out", str(traj),
        "--device", "cuda"])[0]
    traj_launches = parts.parts["trajectory"]
    want_traj = {"group_norm": calls * unet["group_norm"],
                 "flash_attention": calls * unet["flash_attention"],
                 "flash_streaming": 0}
    check(made["shapes"] == {"xs": (SD_STEPS, SDC_N, 64, 64, 4),
                             "ts": (SD_STEPS, SDC_N),
                             "cs": (SD_STEPS, SDC_N, 77, 768),
                             "ucs": (SD_STEPS, SDC_N, 77, 768)},
          f"calib_sd trajectory {made['shapes']}")
    check({k: traj_launches[k] for k in want_traj} == want_traj,
          f"calib_sd make-cali-data launches {traj_launches}, expected "
          f"{want_traj} ({calls} UNet calls)")

    torch.cuda.reset_peak_memory_stats()
    with _CalibSpies(parts, SDC_BATCH, keep=SDC_UNIT) as spies:
        cal_w = parts("calibrate_weight", cli.main, _sd_calib_argv(
            work, "run_w", "--cali-iters", str(SDC_ITERS)))[0]
        peak_w = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        cal_a = parts("calibrate_act", cli.main, _sd_calib_argv(
            work, "run_a", "--resume-w", cal_w["path"], "--quant-act",
            "--act-bit", "8", "--sm-abit", "16", "--running-stat",
            "--cali-iters-a", str(SDC_ITERS_A)))[0]
        peak_a = torch.cuda.max_memory_allocated() / 1e9
    units, kept = spies.units, spies.kept
    torch.cuda.empty_cache()

    # the reference's unit list, and the CPU side of the card-vs-CPU check
    cpu_m = _sd_model(task, work, "cpu")
    names = [u.name for u in cpu_m.units]
    n_weight = sum(1 for u in cpu_m.units if u.layer_names)
    quality = _calib_checks("calib_sd", parts, units, {
        "weight": [u.name for u in cpu_m.units if u.layer_names],
        "act": names}, check)

    samples = {}
    for key, qpath, extra, sm in (
            ("fold", cal_w["path"], ("--engine", "fold"), 0),
            ("sim_w4a8", cal_a["path"], ("--engine", "sim", "--quant-act",
                                         "--act-bit", "8", "--sm-abit",
                                         "16"), 1)):
        res = parts(f"sample_{key}", cli.main, _sd_sample_argv(
            work, qpath, f"{key}.npz", *extra))[0]
        got = parts.parts[f"sample_{key}"]
        n_calls = SDC_SAMPLE_STEPS + 1
        want = {"group_norm": n_calls * unet["group_norm"]
                + dec["group_norm"],
                "flash_attention": n_calls * unet["flash_attention"],
                "flash_attention_sm_q": sm * n_calls
                * unet["flash_attention"],
                "flash_streaming": dec["flash_streaming"]}
        with np.load(res["path"]) as f:
            imgs = f["arr_0"]
        check(imgs.shape == (1, 512, 512, 3) and res["nonfinite"] == 0
              and res["model_calls"] == [n_calls],
              f"calib_sd {key} sample {imgs.shape}, {res['nonfinite']} "
              f"non-finite, calls {res['model_calls']}")
        check({k: got[k] for k in want} == want,
              f"calib_sd {key} sample launches {got}, expected {want}")
        samples[key] = {"seconds": res["batch_seconds"],
                        "decode_seconds": res["decode_seconds"],
                        "launches": {k: got[k] for k in want},
                        "image_mean": float(imgs.mean()),
                        "image_std": float(imgs.std())}
    path = {k: v - c0[k] - parts.parts["block_error"][k]
            for k, v in _launch_counts().items()}
    card_cpu = _sd_unit_card_vs_cpu(task, work, cpu_m, kept, check)
    del cpu_m
    flips = _sm16_flip_share(check)

    kinds = {}
    for what, rows in units.items():
        for r in rows:
            kinds.setdefault(f"{what}/{r['kind']}", []).append(
                r["ms_per_iter"])
    p = parts.parts
    row = {"phase": "calib_sd", "nvidia_smi": smi,
           "reduced": {"trajectory": f"{SDC_N} images, PLMS-{SD_STEPS} "
                       "(reference: the prompts of a calibration set)",
                       "calibration samples": f"{SDC_CALI_N} x "
                       f"{len(range(0, SD_STEPS, SD_STEPS // SDC_ST))} "
                       "steps, cond and uncond (reference 256 x 20 x 2)",
                       "iterations per unit": f"{SDC_ITERS} weight, "
                       f"{SDC_ITERS_A} act (reference 20000, 5000)",
                       "samples": f"PLMS-{SDC_SAMPLE_STEPS}, batch 1"},
           "samples_rows": cal_w["samples"], "units": len(names),
           "weight_units": n_weight,
           "seconds": {k: v["seconds"] for k, v in p.items()},
           "calls": {k: v["calls"] for k, v in p.items()},
           "launches": {k: {n: v[n] for n in (
               "group_norm", "flash_attention", "flash_streaming")}
               for k, v in p.items()},
           "peak_device_gb": {"weight": peak_w, "act": peak_a},
           "ms_per_iter_by_kind": {k: {"median": float(np.median(v)),
                                       "max": max(v), "units": len(v)}
                                   for k, v in kinds.items()},
           "quality": quality, "samples": samples,
           "path_launches": path, "card_vs_cpu": card_cpu,
           "sm16_bucket_flip_share": flips}
    _emit(row)
    for what, rows in units.items():
        for r in rows:
            _emit({"phase": f"calib_sd_{what}_unit", **r})
    return row


def _sd_model(task, work: Path, dev: str):
    """The SD UNet of the calibrate CLI (split shortcut, W4A8 policy with
    the 16-bit softmax, act-quant partition) with the seeded weights."""
    import dataclasses

    from qdiffusion_torch.cli import load_fp_params
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.models.unet_ldm import LDMUNet

    flags = QuantFlags(weight_bit=4, quant_act=True, act_bit=8, sm_abit=16,
                       split=True)
    model = LDMUNet(dataclasses.replace(task.unet_ldm, split_shortcut=True),
                    flags.policy_ldm(), act_quant_partition=True, device=dev)
    model.load_state_dict(load_fp_params(work / "unet.npz", model))
    return model


def _sd_unit_card_vs_cpu(task, work: Path, cpu_m, kept: dict,
                         check: Checks) -> dict:
    """SDC_UNIT's weight and act reconstructions (SDC_UNIT_ITERS
    iterations) on the card and on the CPU from the captures and qstate
    the calibration gave it, with one set of minibatch indices: alphas
    (stored in f32 here, so no storage rounding enters) within 3.7e-6 of
    the largest |alpha| or four times the card's own spread under 2e-6
    relative input noise, whichever is larger, at most CARD_CPU_FLIPS of
    the hard roundings flipped; act deltas within 1e-4 relative or four
    times that spread (tests/test_torch_calib_ldm.py's bounds)."""
    from qdiffusion_torch.calib import recon

    check(set(kept) == {"weight", "act"},
          f"calib_sd: {SDC_UNIT} captures kept for {sorted(kept)}")
    if set(kept) != {"weight", "act"}:
        return {}
    card_m = _sd_model(task, work, "cuda")
    out = {"unit": SDC_UNIT, "iters": SDC_UNIT_ITERS}
    real_idx = recon._batch_indices
    try:
        for what, act in (("weight", False), ("act", True)):
            k = kept[what]
            n = k["out"].shape[0]
            idx = torch.randint(0, n, (SDC_UNIT_ITERS, SDC_BATCH),
                                generator=torch.Generator().manual_seed(1))
            recon._batch_indices = lambda i, n_, bs, gen: idx[i]
            cfg = recon.ReconConfig(iters=SDC_UNIT_ITERS,
                                    batch_size=SDC_BATCH, p=2.4 if act
                                    else 2.0)
            mode = "act" if act else "weight"

            def run(model, dev, seed=0):
                noise = [1.0 if seed == 0 else 1.0 + 2e-6 * torch.randn(
                    a.shape, generator=torch.Generator().manual_seed(seed))
                    for a in k["inps"]]
                unit = next(u for u in model.units if u.name == SDC_UNIT)
                t0 = time.perf_counter()
                new = recon.reconstruct_unit(
                    model, _to(k["qstate"], dev), unit,
                    tuple((a * z).to(dev) for a, z in zip(k["inps"], noise)),
                    k["out"].to(dev), cfg, act_quant=act, sm_abit=16)
                if dev == "cuda":
                    torch.cuda.synchronize()
                return ({(s, sl): v.float().cpu() for s, sls in
                         recon.extract_trainable(new, unit, mode, 16).items()
                         for sl, v in sls.items()},
                        time.perf_counter() - t0)

            got, card_s = run(card_m, "cuda")
            spread = [run(card_m, "cuda", seed)[0] for seed in (1, 2, 3, 4)]
            want, cpu_s = run(cpu_m, "cpu")
            worst, bound_used, flips, total = 0.0, 0.0, 0, 0
            for key, w in want.items():
                if act:
                    rel = lambda a: float(((a - w).abs() / w.abs()).max())
                    floor = 1e-4
                else:
                    top = float(w.abs().max())
                    rel = lambda a: float((a - w).abs().max()) / top
                    floor = 3.7e-6
                    flips += int(((got[key] >= 0) != (w >= 0)).sum())
                    total += w.numel()
                err = rel(got[key])
                bound = max(floor, 4.0 * max(rel(r[key]) for r in spread))
                check(err <= bound, f"calib_sd {SDC_UNIT} {what} card vs "
                                    f"CPU: {key} {err}, bound {bound}")
                worst, bound_used = max(worst, err), max(bound_used, bound)
            if not act:
                check(flips <= CARD_CPU_FLIPS * total,
                      f"calib_sd {SDC_UNIT} weight card vs CPU: {flips} of "
                      f"{total} hard roundings differ")
            out[what] = {"leaves": len(want), "worst_rel": worst,
                         "largest_bound": bound_used, "flips": flips,
                         "weights": total, "card_s": card_s, "cpu_s": cpu_s}
    finally:
        recon._batch_indices = real_idx
    del card_m
    torch.cuda.empty_cache()
    return out


def _sm16_flip_share(check: Checks) -> dict:
    """B2 at SDC_FLIP_SHAPE, f32, with the 16-bit softmax quantizer of
    the sim W4A8 sample (always_zero, delta 1/65535): the share of
    quantized probabilities that differ from the plain version's."""
    from qdiffusion_torch.models.unet_ldm import LDMQuantPolicy
    from qdiffusion_torch.ops.flash_attention import bucket_flip_share, \
        flash_attention, flash_attention_plain

    (q, k, _), _, _ = _attn_case(SDC_FLIP_SHAPE, torch.float32, False, 9)
    spec = LDMQuantPolicy(sm_abit=16).sm_aq_transformer
    f = lambda a: torch.tensor(a, device="cuda")
    sm_q = ({"delta": f(1.0 / 65535), "zero_point": f(0.0)}, spec)
    t0 = time.perf_counter()
    share = bucket_flip_share(flash_attention, flash_attention_plain, q, k,
                              scale=SDC_FLIP_SHAPE[-1] ** -0.5, sm_q=sm_q)
    check(share <= 1e-3, f"B2 {SDC_FLIP_SHAPE} f32 with a 16-bit softmax "
                         f"quantizer: bucket-flip share {share} (limit 1e-3)")
    return {"shape": list(SDC_FLIP_SHAPE), "dtype": "float32", "sm_bits": 16,
            "share": share, "seconds": time.perf_counter() - t0}


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

class B4Sites(Spy):
    """Every B4 site of the int8 engine (ops/int8.py's int8_conv2d and
    int8_dense, which qlayers calls): its geometry key (kind, x shape,
    strides and dtype, each segment's channels and filter, N, stride,
    padding) in call order in `seen`, and for the first call of each key
    a copy of its input and its packed weight in `inputs`."""

    def __init__(self):
        import qdiffusion_torch.ops.int8 as int8

        self.inputs = {}
        super().__init__([(int8, "int8_conv2d"), (int8, "int8_dense")],
                         self._record)

    def _record(self, a, kw):
        x, packed = a[0], a[1]
        conv = packed.segments[0].kshape != ()
        stride = kw.get("stride", 1)
        stride = (stride, stride) if isinstance(stride, int) else tuple(
            stride)
        key = ("conv" if conv else "dense", tuple(x.shape), tuple(x.stride()),
               str(x.dtype).replace("torch.", ""),
               tuple((s.in_ch, s.kshape) for s in packed.segments),
               int(packed.segments[0].w_c.shape[1]),
               stride if conv else None,
               kw.get("padding", 0) if conv else None)
        if key not in self.inputs:
            self.inputs[key] = (x.clone(memory_format=torch.preserve_format),
                                packed)
        return key


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
    64 under the B4 site spy: one B4 launch per site, every conv input
    channels_last (the kernel reads it in place)."""
    from qdiffusion_torch.ops.int8_conv import int8_conv
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
    before = int8_conv.launches
    with B4Sites() as spy:
        eps = step(x, t)
    torch.cuda.synchronize()
    launched = int8_conv.launches - before
    check(tuple(eps.shape) == (BATCH, 32, 32, 3)
          and bool(torch.isfinite(eps).all()), "int8 step output")
    sites = [k for _, k in spy.seen]
    check(len(sites) == len(packed) == launched,
          f"int8 step: {len(sites)} B4 sites, {launched} launches, "
          f"{len(packed)} packed sites")
    layouts = all(k[0] == "dense" or k[2][1] == 1 for k in sites)
    check(layouts, "int8 step: a conv input that is not channels_last")
    row = {"phase": "int8_spy", "packed_sites": len(packed),
           "segments": segments, "b4_per_step": len(sites),
           "b4_launches_per_step": launched,
           "distinct_sites": len(spy.inputs), "channels_last": layouts,
           "step_ms": _time_ms(lambda: step(x, t), reps=3)}
    _emit(row)
    return {"model": model, "qstate": qstate, "step": step, "x": x, "t": t,
            "sites": sites, "inputs": spy.inputs, "row": row}


class stream_site_check:
    """For the length of a `with` block, every B5 / B6 call of the stream
    engine (qlayers' int8_dense_stream / int4_dense_stream) also runs the
    plain version on the CPU on a copy of that call's own inputs; `errs`
    gets ((M, K, N), max|card - CPU| / max|CPU|) per call. The same
    inputs per site, so each error is the kernel's alone."""

    def __enter__(self):
        import qdiffusion_torch.ops.qlayers as ql

        self.ql, self.errs = ql, []
        self.saved = ql.int8_dense_stream, ql.int4_dense_stream
        ql.int8_dense_stream, ql.int4_dense_stream = (
            self._wrap(f) for f in self.saved)
        return self

    def _wrap(self, real):
        def cpu(a):
            return a.cpu() if isinstance(a, torch.Tensor) else a

        def run(x, w, scale, shift, bias=None, *, out_dtype=None):
            got = real(x, w, scale, shift, bias, out_dtype=out_dtype)
            want = real(*(cpu(a) for a in (x, w, scale, shift, bias)),
                        out_dtype=out_dtype).float()
            err = float((got.cpu().float() - want).abs().max())
            self.errs.append(((x.numel() // x.shape[-1], x.shape[-1],
                               got.shape[-1]),
                              err / max(float(want.abs().max()), 1e-30)))
            return got
        return run

    def __exit__(self, *exc):
        self.ql.int8_dense_stream, self.ql.int4_dense_stream = self.saved


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
    with stream_site_check() as sites:
        step(x, t, c)
    worst = max(sites.errs, key=lambda e: e[1])
    res["sites"] = {"sites": len(sites.errs), "max_rel_err": worst[1],
                    "worst_site": list(worst[0]),
                    "tolerance": f"{STREAM_REL} of the site's largest output",
                    "ok": worst[1] <= STREAM_REL}
    check(len(sites.errs) == len(res["shapes"]) and res["sites"]["ok"],
          f"sd stream W{wbits} per site: {len(sites.errs)} sites, largest "
          f"rel err {worst[1]} at {worst[0]} (limit {STREAM_REL})")
    _emit({"phase": "sd_stream_sites", "wbits": wbits, **res["sites"]})
    prof = None
    if profile_to is not None:
        def run():
            step(x, t, c)
        prof = profile_breakdown(
            run, 3, profile_to / "sd_stream_w4_call_trace.json",
            f"SD v1 stream W{wbits} f32 UNet call, batch 2 (CFG of batch 1)")
        # two more windows: the busy time's spread within this run
        prof["device_busy_ms_per_call_windows"] = [
            prof["device_busy_ms_per_call"]] + [profile_breakdown(
                run, 3, None, "")["device_busy_ms_per_call"]
                for _ in range(2)]
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


def _identity_packed(packed):
    """The same site with the epilogue y = float(acc): A = 1, Bc = C = 0,
    no bias."""
    import dataclasses

    return dataclasses.replace(packed, bias=None, segments=[
        dataclasses.replace(seg, scale_a=torch.ones_like(seg.scale_a),
                            scale_s=torch.zeros_like(seg.scale_s),
                            const=torch.zeros_like(seg.const))
        for seg in packed.segments])


def _b4_site(key, x, packed, check) -> dict:
    """B4 at one int8 site on the input the int8 call gave it: the
    kernel against the plain composition on the card (the output bit for
    bit; the int32 products exactly, through an identity epilogue on the
    f32 input), then the times in CUDA graphs over copies of x that
    outgrow the L2: the kernel, the plain composition, the torch._int_mm
    route (quantize, pad, gather, torch._int_mm on patches padded to its
    multiples of 8, the epilogue) and cuDNN's bf16 convolution (or
    F.linear) at the same shape, beside the bound of the fused function
    and that of the TPU design's product over gathered patches."""
    import torch.nn.functional as F

    from qdiffusion_torch import nn
    from qdiffusion_torch.ops import int8
    from qdiffusion_torch.ops.int8_conv import conv_plan, stages

    kind, _, _, _, segs, n, stride, padding = key
    conv = kind == "conv"

    def kernel(a, pk=packed):
        return int8.int8_conv2d(a, pk, stride=stride, padding=padding) \
            if conv else int8.int8_dense(a, pk)

    def plain(a, pk=packed):
        return int8.int8_conv2d_plain(a, pk, stride=stride, padding=padding) \
            if conv else int8.int8_dense_plain(a, pk)

    got, want = kernel(x), plain(x)
    ident = _identity_packed(packed)
    acc, acc_plain = kernel(x.float(), ident), plain(x.float(), ident)
    torch.cuda.synchronize()
    bit_equal = got.shape == want.shape and bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    exact = float(acc_plain.abs().max()) < 2**24 and bool(
        torch.equal(acc, acc_plain))
    ok = bit_equal and exact
    check(ok, f"int8_conv {key}: output bit for bit {bit_equal} (max abs "
              f"err {err}), int32 products exact {exact}")
    m, k_tot = got.numel() // n, sum(c * int(np.prod(ks or (1,)))
                                     for c, ks in segs)
    plan = conv_plan(m, n, [stages(c * int(np.prod(ks or (1,))))
                            for c, ks in segs],
                     torch.cuda.get_device_properties(0)
                     .multi_processor_count)
    del got, want, acc, acc_plain
    xb = x.numel() * x.element_size()
    xs = rotations(lambda: x.clone(memory_format=torch.preserve_format), xb,
                   cap=64)
    # the torch._int_mm route: its operands padded to M > 16 and K, N
    # multiples of 8
    n8 = -(-n // 8) * 8
    wpad = [F.pad(seg.w_c, (0, n8 - n, 0, -(-seg.w_c.shape[0] // 8) * 8
                            - seg.w_c.shape[0])) for seg in packed.segments]

    def int_mm_route(a):
        y = None
        axis = 1 if conv else -1
        for seg, w8, xseg in zip(packed.segments, wpad,
                                 int8._segments_of(a, packed, axis)):
            q = int8.quantize_act(xseg, seg)
            if conv:
                pads = nn.pad_amounts(padding, seg.kshape, stride,
                                      xseg.shape[2:])
                q = nn.patches(q, seg.kshape, stride, pads, value=seg.a_pad)
            p2 = q.reshape(-1, q.shape[-1])
            p2 = F.pad(p2, (0, w8.shape[0] - p2.shape[1], 0,
                            max(0, 17 - p2.shape[0])))
            part = torch._int_mm(p2, w8)[:m, :n].float() * seg.scale_a \
                + p2[:m].float().sum(dim=-1, keepdim=True) * seg.scale_s \
                + seg.const
            y = part if y is None else y + part
        if packed.bias is not None:
            y = y + packed.bias
        return y.to(x.dtype)

    gen = torch.Generator(device="cuda").manual_seed(5)
    c_tot = sum(c for c, _ in segs)
    kshape = segs[0][1] or ()
    w_bf = torch.randn((n, c_tot, *kshape), generator=gen,
                       device="cuda").to(torch.bfloat16)

    def cudnn(a):
        a = a.to(torch.bfloat16)
        return F.conv2d(a, w_bf, stride=stride, padding=padding) if conv \
            else F.linear(a, w_bf)

    row = {
        "max_abs_err": err, "rel_err": rel,
        "bit_equal": bit_equal, "int32_exact": exact,
        "tolerance": "output bit for bit, int32 products exact", "ok": ok,
        "M": m, "K": k_tot, "N": n,
        "plan": {"splits": plan.splits, "sps": plan.sps,
                 "grid": list(plan.grid)},
        "ms": _graph_ms([lambda a=a: kernel(a) for a in xs]),
        "plain_ms": _graph_ms([lambda a=a: plain(a) for a in xs],
                              min_calls=5),
        "library_ms": _graph_ms([lambda a=a: int_mm_route(a) for a in xs]),
        "library": "quantize + pad + gather + torch._int_mm + epilogue",
        "cudnn_bf16_ms": _graph_ms([lambda a=a: cudnn(a) for a in xs]),
        # x read once, the int8 weights, the output written once
        **bound(xb + n * k_tot + m * n * x.element_size(),
                2 * m * n * k_tot / INT8_OPS * 1e3),
        # the TPU design's product: int8 patches read, f32 output written
        "patch_bound_ms": (m * k_tot + k_tot * n + 4 * m * n)
        / HBM_BYTES_PER_S * 1e3}
    del xs
    return row


def phase_b4_sites(sites: list, inputs: dict, where: str,
                   check: Checks) -> list:
    """B4 at every distinct site of one int8 call (a B4Sites spy's `seen`
    keys and `inputs`); per_call is the site's count per call."""
    counts = _counts(sites)
    rows = []
    for key, (x, packed) in inputs.items():
        kind, shape, strides, dtype, segs, n, stride, padding = key
        row = {"phase": "int_kernel", "kernel": "int8_conv", "where": where,
               "site": {"kind": kind, "x_shape": list(shape),
                        "x_strides": list(strides), "dtype": dtype,
                        "segments": [[c, list(k)] for c, k in segs], "N": n,
                        "stride": stride, "padding": padding},
               "per_call": counts[key], **_b4_site(key, x, packed, check)}
        _emit(row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _stream_case(kernel, M, K, N, gen, check, names) -> dict:
    """B5 / B6 at (M, K, N) against the plain version, two launches
    compared bit for bit, the design from `names` (the profiler's kernel
    names of a launch at this shape, None if none was probed), times and
    the bound."""
    from qdiffusion_torch.ops.int4_matmul import int4_dense_stream, \
        int4_stream_plain, unpack_int4_weight
    from qdiffusion_torch.ops.int8_matmul import int8_dense_stream, \
        int8_stream_plain, stream_plan

    int4 = kernel == "int4_stream_matmul"
    x, w, scale, shift, bias = _stream_operands(kernel, M, K, N, gen)
    fn, plain = (int4_dense_stream, int4_stream_plain) if int4 else (
        int8_dense_stream, int8_stream_plain)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = stream_plan(M, N, K, int4, sms)
    got = fn(x, w, scale, shift, bias=bias)
    again = fn(x, w, scale, shift, bias=bias)
    want = plain(x, w, scale, shift, bias)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    ok = rel <= STREAM_REL
    check(ok, f"{kernel} {(M, K, N)}: rel err {rel} over {STREAM_REL}")
    same = bool(torch.equal(got, again))
    check(same, f"{kernel} {(M, K, N)}: two launches differ")
    design = _stream_design(names or [], plan.splits)
    check(design == "mma", f"{kernel} {(M, K, N)}: profiler kernels "
          f"{[n for n in names or [] if 'stream' in n]} for plan {plan}"
          + ("" if names is not None else " (shape not probed)"))
    del got, again, want
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
        "plan": {"bm": plan.bm, "bn": plan.bn, "splits": plan.splits,
                 "kps": plan.kps, "grid": list(plan.grid)},
        "bit_equal_relaunch": same, "design": design,
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


def _stream_rows(kernel: str, shapes: list, where: str, check: Checks,
                 designs: dict) -> list:
    """B5 or B6 at every distinct (M, K, N) of one stream UNet call
    (`shapes` in call order, so a shape's multiplicity is its count per
    call), as `_stream_case`."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for (M, K, N), per_call in _counts(shapes).items():
        case = _stream_case(kernel, M, K, N, gen, check,
                            designs.get((kernel, (M, K, N))))
        row = {"phase": "int_kernel", "kernel": kernel, "where": where,
               "shape": [M, K, N], "per_call": per_call, **case}
        _emit(row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_int_kernels(b4: dict, b5: list, b6: list, check: Checks,
                      designs: dict) -> list:
    """B4 at every distinct site of one CIFAR int8 step (`b4`: int8_setup's
    spy), B5 / B6 at every distinct (M, K, N) of one SD stream UNet call."""
    return phase_b4_sites(
        b4["sites"], b4["inputs"], f"cifar10 W4A8 int8 step, batch {BATCH}",
        check) + _stream_rows(
        "int8_stream_matmul", b5, "sd_v1 stream W8 UNet call, batch 2",
        check, designs) + _stream_rows(
        "int4_stream_matmul", b6, "sd_v1 stream W4 UNet call, batch 2",
        check, designs)


def phase_int8_cli(task, out: Path, setup: dict, check: Checks) -> dict:
    from qdiffusion_torch import cli
    from qdiffusion_torch.ops.groupnorm import fused_group_norm
    from qdiffusion_torch.ops.int8_conv import int8_conv

    per_step = len(setup["sites"])
    batches = INT8_N // BATCH
    fused_group_norm.launches = int8_conv.launches = 0
    res = cli.main(["sample", "--task", "cifar10",
                    "--qstate", str(out / "w4a8_qstate.npz"),
                    "--weight-bit", "4", "--quant-act", "--split",
                    "--engine", "int8", "--n", str(INT8_N),
                    "--batch", str(BATCH), "--npz-out", str(out / "int8.npz"),
                    "--device", "cuda"])
    launches = {"int8_conv": int8_conv.launches,
                "group_norm": fused_group_norm.launches}
    want = {"int8_conv": batches * STEPS * per_step,
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
    """Records the activation quantization of every segment of every int8
    site (ops/int8.py's int8_conv2d / int8_dense), as (f32 input, int8
    output, delta) on the CPU, for the length of a `with`. The int8 values
    are quantize_act's on the input's own device: on the card that is the
    plain version of what B4 computes in its load path. So on the card
    each site's B4 output is also held bit for bit against the plain
    composition (int8_conv2d_plain / int8_dense_plain) on the same input:
    `plain_sites` counts the sites compared, `plain_equal` those equal."""

    def __enter__(self):
        import qdiffusion_torch.ops.int8 as int8

        self.mod, self.rec = int8, []
        self.plain_sites = self.plain_equal = 0
        self.real = int8.int8_conv2d, int8.int8_dense

        def record(x, packed, axis):
            for seg, xs in zip(packed.segments,
                               int8._segments_of(x, packed, axis)):
                q = int8.quantize_act(xs, seg)
                self.rec.append((xs.float().cpu(), q.cpu(),
                                 float(seg.a_delta)))

        def against_plain(y, plain):
            if y.device.type == "cuda":
                self.plain_sites += 1
                self.plain_equal += bool(torch.equal(y, plain()))
            return y

        def conv(x, packed, **kw):
            record(x, packed, 1)
            return against_plain(self.real[0](x, packed, **kw),
                                 lambda: int8.int8_conv2d_plain(x, packed,
                                                                **kw))

        def dense(x, packed, **kw):
            record(x, packed, -1)
            return against_plain(self.real[1](x, packed, **kw),
                                 lambda: int8.int8_dense_plain(x, packed,
                                                               **kw))

        int8.int8_conv2d, int8.int8_dense = conv, dense
        return self

    def __exit__(self, *exc):
        self.mod.int8_conv2d, self.mod.int8_dense = self.real


def _within_one_bucket(card: "QuantRecorder", cpu: "QuantRecorder"):
    """(every site of the two runs paired and each int8 activation of the
    card's within one bucket beyond its input's drift of the CPU's, the
    int8 values apart, the int8 values)."""
    ok = len(card.rec) == len(cpu.rec) > 0
    flips = total = 0
    for (xg, qg, delta), (xr, qr, _) in zip(card.rec, cpu.rec):
        dq = (qg.int() - qr.int()).abs()
        ok &= xg.shape == xr.shape and bool(
            (dq <= (xg - xr).abs() / delta + 1 + 1e-5).all())
        flips += int((dq > 0).sum())
        total += dq.numel()
    return ok, flips, total


def phase_int8_card_vs_cpu(task, out: Path, setup: dict,
                           check: Checks) -> dict:
    """One int8 step at batch 2: the card's bf16 and f32 carriers against
    the CPU's f32 carrier, each int8 activation of the f32 steps held to
    one bucket beyond its input's drift, each B4 call of both card steps
    bit for bit against the plain composition on its own input, and the
    card's f32 carrier against the card's sim step."""
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
    with QuantRecorder() as rec_bf16:
        eps = {"bf16": make_quantized_step(model, q, engine="int8")(xc, tc)}
    eps["sim"] = make_quantized_step(model, q, engine="sim")(xc, tc)
    with QuantRecorder() as rec_card:
        eps["f32"] = make_quantized_step(
            model, q, engine="int8", carrier_dtype=torch.float32)(xc, tc)
    eps = {k: v.float().cpu() for k, v in eps.items()}

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    sites_ok, flips, total = _within_one_bucket(rec_card, rec_cpu)
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
           "int8_values_apart": flips, "int8_values": total,
           "b4_calls_vs_plain": {k: [r.plain_sites, r.plain_equal] for k, r
                                 in (("bf16", rec_bf16), ("f32", rec_card))}}
    check(all(bool(torch.isfinite(e).all()) for e in eps.values()),
          "int8 batch-2 steps not finite")
    check(sites_ok and first_exact, f"int8 card vs CPU: {len(rec_card.rec)}"
          f" vs {len(rec_cpu.rec)} quantized sites, within one bucket "
          f"{sites_ok}, first site exact {first_exact}")
    for key, (n, eq) in row["b4_calls_vs_plain"].items():
        check(n > 0 and eq == n, f"int8 {key} step: {eq} of {n} B4 calls "
                                 "bit-equal to the plain composition")
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

    counters = _kernel_counters("group_norm", "flash_attention",
                                "flash_streaming", "int4_stream_matmul",
                                "int8_stream_matmul")
    out = {}
    for wbits, steps, n in ((4, SD_STEPS, STREAM_N_W4), (8, 5, STREAM_N)):
        batches = n // STREAM_BATCH
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
                        "--n", str(n), "--batch", str(STREAM_BATCH),
                        "--npz-out", str(work / f"sd_stream_w{wbits}.npz"),
                        "--device", "cuda"])
        launches = {k: f.launches for k, f in counters.items()}
        with np.load(res["path"]) as f:
            imgs = f["arr_0"]
        tag = f"sd stream W{wbits}"
        check(imgs.shape == (n, 512, 512, 3)
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
        row = {"phase": "sd_stream_cli", "weight_bit": wbits, "n": n,
               "batch": STREAM_BATCH, "steps": steps,
               "batch_seconds": secs, "decode_seconds": dec_s,
               "img_per_s": STREAM_BATCH / secs[-1],
               # every batch after the first (which builds and warms up)
               "img_per_s_by_batch": [STREAM_BATCH / x for x in secs[1:]],
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
    row["elementwise_kernels_per_call"] = row["by_kind"].get(
        "elementwise and other", {}).get("kernels_per_call", 0)
    _emit(row)
    return row


# -- the remaining samplers (DPM-Solver++, ancestral DDPM) through
#    `sample --sampler` on the CIFAR-10 and SD v1 engines ---------------------

DPM_STEPS = 20  # --timesteps of the DPM-Solver runs (NFE 20)
SD_DPM_STEPS = 50  # txt2img's --dpm_solver at its default 50 steps


def _sampler_run(argv: list, tag: str, sampler: str, steps: int, n: int,
                 batch: int, decodes: bool, per_call: dict, base: dict,
                 check: Checks) -> dict:
    """`cli sample ... --sampler S --timesteps N` under `_spied_cli`: one
    UNet call per solver evaluation (`steps` a batch for DPM-Solver and
    DDPM alike), each launching every kernel as `per_call` (the same
    engine's count under DDIM / PLMS) says, finite uint8 output; img/s
    and ms per UNet call of the last batch beside `base`, the same
    engine's DDIM / PLMS run in this smoke."""
    batches = n // batch
    res, spied = _spied_cli(argv + ["--sampler", sampler, "--timesteps",
                                    str(steps), "--n", str(n), "--batch",
                                    str(batch), "--device", "cuda"],
                            tag, batches * steps, batches if decodes else 0,
                            check)
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    check(imgs.dtype == np.uint8 and imgs.shape[0] == n,
          f"{tag}: npz {imgs.shape} {imgs.dtype}")
    check(res["nonfinite"] == 0, f"{tag}: {res['nonfinite']} non-finite")
    check(res["sampler"] == sampler and res["model_calls"] == [steps]
          * batches, f"{tag}: {res['sampler']} with UNet calls "
                     f"{res['model_calls']}, expected {steps} a batch")
    got = {k: spied["per_unet_call"][k] for k in per_call}
    check(got == per_call and all(
        v == 0 for k, v in spied["per_unet_call"].items()
        if k not in per_call), f"{tag}: launches per UNet call "
                               f"{spied['per_unet_call']}, the DDIM / "
                               f"PLMS path's {per_call}")
    secs = res["batch_seconds"]
    dec = res.get("decode_seconds") or [0.0]
    ms = (secs[-1] - dec[-1]) / steps * 1e3
    row = {"phase": "sampler_cli", "run": tag, "sampler": sampler,
           "steps": steps, "n": n, "batch": batch, "batch_seconds": secs,
           "img_per_s": batch / secs[-1], "ms_per_unet_call": ms,
           "base": base, "ms_per_call_minus_base":
               ms - base["ms_per_unet_call"],
           "image_shape": list(imgs.shape), **spied,
           "image_mean": float(imgs.mean()), "image_std": float(imgs.std())}
    _emit(row)
    return row


def _sampler_loop_ms(task, sd) -> dict:
    """The "Pipeline + sampler" layer alone: ms per model call of each
    sampler loop of the sampler_cli runs and of their DDIM / PLMS base,
    at the runs' shapes and carriers, with a model that returns a fixed
    eps (a view: no kernel), so what is left is the solver's host work
    and elementwise kernels. Host clock around a synchronised loop, the
    median of three."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.samplers.ddim import ddim_sample, ddpm_sample
    from qdiffusion_torch.samplers.dpm_solver import NoiseScheduleVP, \
        dpm_solver_sample
    from qdiffusion_torch.samplers.ldm import DDIMTables, plms_sample
    from qdiffusion_torch.schedules import make_skip_sequence

    g = torch.Generator(device="cuda").manual_seed(9)
    bf16 = torch.bfloat16

    def ms(run, x, calls, dtype=None):
        e = torch.randn((2 * x.shape[0],) + x.shape[1:], generator=g,
                        device="cuda").to(dtype or x.dtype)
        fn = lambda x, t, *c: e[:x.shape[0]]  # noqa: E731
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(fn, x.clone())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / calls * 1e3)
        return sorted(times)[1]

    px = torch.randn((BATCH, 32, 32, 3), generator=g, device="cuda")
    pbetas = cli._schedule(task).betas
    seq = make_skip_sequence(1000, STEPS, task.sampler.skip_type)
    pns = NoiseScheduleVP("discrete", betas=pbetas)
    lbetas = cli._schedule(sd).betas
    lns = NoiseScheduleVP("discrete", betas=lbetas)
    tables = DDIMTables.build(np.cumprod(1.0 - lbetas), SD_STEPS, 0.0)
    c = torch.randn((SD_BATCH, 77, 768), generator=g, device="cuda")
    out = {"cifar10 (64, 32, 32, 3), bf16 carrier": {
        "ddim_100": ms(lambda f, x: ddim_sample(
            f, x, seq, pbetas, eval_dtype=bf16), px, STEPS, bf16),
        "ddpm_100": ms(lambda f, x: ddpm_sample(
            f, x, seq, pbetas, generator=g, eval_dtype=bf16), px, STEPS,
            bf16),
        "dpm_solver_20": ms(lambda f, x: dpm_solver_sample(
            f, x, pns, steps=DPM_STEPS, order=3, method="singlestep",
            eval_dtype=bf16), px, DPM_STEPS, bf16)}}
    for key, n, dtype, dpm_steps in (
            ("sd_v1 fold (4, 64, 64, 4), CFG, bf16 carrier", SD_BATCH, bf16,
             SD_DPM_STEPS),
            ("sd_v1 stream (1, 64, 64, 4), CFG, f32", STREAM_BATCH, None,
             DPM_STEPS)):
        lx = torch.randn((n, 64, 64, 4), generator=g, device="cuda")
        cfg = dict(cond=c[:n], uncond=c[:n], guidance_scale=7.5,
                   eval_dtype=dtype)
        out[key] = {
            f"plms_{SD_STEPS}": ms(lambda f, x: plms_sample(
                f, x, tables, **cfg), lx, SD_STEPS + 1, dtype),
            f"dpm_solver_{dpm_steps}": ms(lambda f, x: dpm_solver_sample(
                f, x, lns, steps=dpm_steps, order=2, method="multistep",
                with_context=True, **cfg), lx, dpm_steps, dtype)}
    return out


def phase_samplers(task, sd, out: Path, work: Path, per_step: int,
                   b4_per_step: int, spy: dict, st: dict, base: dict,
                   check: Checks) -> dict:
    """The pixel and latent samplers beyond DDIM and PLMS through `cli
    sample --sampler` at full width: CIFAR-10 fold W4 bf16 with
    DPM-Solver (20 steps) and DDPM (the preset's 100), int8 W4A8 --split
    with DPM-Solver (20), two batches of 64; SD v1 fold W4 bf16 with
    DPM-Solver-50 and CFG 7.5 at batch 4 and stream W4 --stream-convs
    with DPM-Solver-20 at batch 1, two batches each. `base`: the same
    engines' DDIM / PLMS rows of this smoke."""
    w4 = ["--qstate", str(out / "w4_qstate.npz"), "--weight-bit", "4"]
    cifar = ["sample", "--task", "cifar10"]
    fold_call = {"group_norm": per_step}
    int8_call = {"group_norm": per_step, "int8_conv": b4_per_step}
    runs = {}
    for key, flags, sampler, steps, per_call in (
            ("cifar10_fold_dpm_solver", w4 + ["--engine", "fold", "--dtype",
                                               "bfloat16"],
             "dpm_solver", DPM_STEPS, fold_call),
            ("cifar10_fold_ddpm", w4 + ["--engine", "fold", "--dtype",
                                        "bfloat16"],
             "ddpm_noisy", STEPS, fold_call),
            ("cifar10_int8_dpm_solver",
             ["--qstate", str(out / "w4a8_qstate.npz"), "--weight-bit", "4",
              "--quant-act", "--split", "--engine", "int8"],
             "dpm_solver", DPM_STEPS, int8_call)):
        engine = "int8" if "int8" in key else "fold"
        runs[key] = _sampler_run(
            cifar + flags + ["--npz-out", str(out / f"{key}.npz")], key,
            sampler, steps, 2 * BATCH, BATCH, False, per_call,
            base[f"cifar10_{engine}"], check)
    sd_files = ["sample", "--task", "sd_v1", "--ckpt", str(work / "unet.npz"),
                "--vae-ckpt", str(work / "vae.npz"), "--clip-ckpt",
                str(work / "clip.npz"), "--token-ids",
                str(work / "token_ids.npz"), "--qstate",
                str(work / "w4_qstate.npz"), "--weight-bit", "4"]
    fold_sd = dict(spy["unet_call"])
    stream_sd = {**st[4]["unet_call"],
                 "int4_stream_matmul": len(st[4]["shapes"])}
    for key, flags, steps, n, batch, per_call in (
            ("sd_v1_fold_dpm_solver", ["--engine", "fold", "--dtype",
                                       "bfloat16"], SD_DPM_STEPS, SD_N,
             SD_BATCH, fold_sd),
            ("sd_v1_stream_w4_dpm_solver", ["--engine", "stream",
                                            "--stream-convs"], DPM_STEPS,
             STREAM_N_W4, STREAM_BATCH, stream_sd)):
        runs[key] = _sampler_run(
            sd_files + flags + ["--npz-out", str(work / f"{key}.npz")], key,
            "dpm_solver", steps, n, batch, True, per_call,
            base[key.replace("_dpm_solver", "")], check)
        check(runs[key]["per_decode"] == {**dict.fromkeys(
            runs[key]["per_decode"], 0), **spy["decode"]},
            f"{key}: launches per decode {runs[key]['per_decode']}, the "
            f"spy's {spy['decode']}")
    loops = _sampler_loop_ms(task, sd)
    _emit({"phase": "sampler_loops", "ms_per_model_call": loops})
    return {**runs, "sampler_loops": loops}


# -- the LSUN latent-diffusion family (beds LDM-4 + VQ-f4, churches LDM-8
#    + KL-f8) through every engine, and the beds W4A8 calibration ----------

def lsun_spy() -> Spy:
    """Every kernel-wrapper call of a sampling run, in call order:
    B1 at both its call sites, the blockwise dispatch's B2 / B3, the int8
    engine's B4, the stream engine's B6 / B5 (and each conv it streams,
    as (input shape, kernel, stride)), with the markers "forward" (an
    LDMUNet or DDIMUNet call begins) and "decode" (a first-stage decode
    begins)."""
    import qdiffusion_torch.models.unet_ddim as unet_ddim
    import qdiffusion_torch.models.unet_ldm as unet_ldm
    import qdiffusion_torch.nn as qnn
    import qdiffusion_torch.ops.attention as att
    import qdiffusion_torch.ops.int8 as int8
    import qdiffusion_torch.ops.qlayers as ql
    from qdiffusion_torch.pipelines import LatentDiffusionPipeline

    def record(a, kw):
        if isinstance(a[0], dict):  # _stream_conv2d(packed, x): a site
            return (tuple(a[1].shape), tuple(a[0]["kshape"]),
                    kw.get("stride", 1))
        return tuple(a[0].shape) if isinstance(a[0], torch.Tensor) else None

    return Spy([(qnn, "fused_group_norm"), (unet_ldm, "fused_group_norm"),
                (att, "flash_attention"), (att, "streaming_flash_attention"),
                (int8, "int8_conv"), (ql, "int4_dense_stream"),
                (ql, "int8_dense_stream"), (ql, "_stream_conv2d"),
                (unet_ldm.LDMUNet, "forward"),
                (unet_ddim.DDIMUNet, "forward"),
                (LatentDiffusionPipeline, "decode")], record)


# wrapper (as the spy names it) -> its kernel's launch counter
LSUN_WRAPPERS = {"fused_group_norm": "group_norm",
                 "flash_attention": "flash_attention",
                 "streaming_flash_attention": "flash_streaming",
                 "int8_conv": "int8_conv",
                 "int4_dense_stream": "int4_stream_matmul",
                 "int8_dense_stream": "int8_stream_matmul"}


def _spied_cli(argv: list, tag: str, unet_calls: int, decodes: int,
               check: Checks) -> tuple:
    """`cli.main(argv)` under `lsun_spy`, with every kernel's launch count
    set to 0 just before and read just after. The spy's calls split at
    its markers into UNet calls and decodes: there must be `unet_calls`
    and `decodes` of them, each UNet call making the same wrapper calls
    as the first (and each decode as the first decode), and each kernel's
    launches must equal its wrapper's calls. Returns (the CLI's result,
    {launches, per UNet call, per decode, B2 sites of a call})."""
    from qdiffusion_torch import cli

    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    counters["flash_attention"].launches_sm_q = 0
    with lsun_spy() as spy:
        res = cli.main(argv)
    launches = {k: f.launches for k, f in counters.items()}
    launches["flash_attention_sm_q"] = \
        counters["flash_attention"].launches_sm_q
    segs, pre = [], []
    for name, rec in spy.seen:
        if name in ("forward", "decode"):
            segs.append(("unet" if name == "forward" else "decode", []))
        else:
            (segs[-1][1] if segs else pre).append((name, rec))

    def count(items):
        out = dict.fromkeys(counters, 0)
        for name, _ in items:
            if name in LSUN_WRAPPERS:
                out[LSUN_WRAPPERS[name]] += 1
        return out

    unet = [count(s) for k, s in segs if k == "unet"]
    dec = [count(s) for k, s in segs if k == "decode"]
    zero = dict.fromkeys(counters, 0)
    per_call, per_dec = (unet or [zero])[0], (dec or [zero])[0]
    check(not pre, f"{tag}: {len(pre)} kernel calls before the first UNet "
                   "call")
    check(len(unet) == unet_calls and len(dec) == decodes,
          f"{tag}: {len(unet)} UNet calls and {len(dec)} decodes, expected "
          f"{unet_calls} and {decodes}")
    check(all(c == per_call for c in unet) and all(c == per_dec
                                                   for c in dec),
          f"{tag}: UNet calls or decodes with different kernel calls")
    want = {k: len(unet) * per_call[k] + len(dec) * per_dec[k]
            for k in counters}
    check({k: launches[k] for k in counters} == want,
          f"{tag}: launches {launches}, the spies count {want}")
    first = next((s for k, s in segs if k == "unet"), [])
    b2 = [r for n, r in first if n == "flash_attention"]
    streamed = [r for n, r in first if n == "_stream_conv2d"]
    return res, {"launches": launches, "per_unet_call": per_call,
                 "per_decode": per_dec, "unet_calls": len(unet),
                 "decodes": len(dec),
                 "flash_sites_per_call": sorted(
                     {str(r): b2.count(r) for r in b2}.items()),
                 "streamed_convs_per_call": sorted(
                     {str(r): streamed.count(r) for r in streamed}.items())}


LSUN = ("lsun_beds256", "lsun_churches256")
LSUN_BATCH = 8  # fold: the JAX package's headline batch
# (scripts/throughput_headline.py:37), two batches, the second timed
LSUN_SIM_STEPS = LSUN_INT8_STEPS = 5  # DDIM-5 (the presets: 200, 400)
LSUN_STREAM_STEPS = 20  # batch-1 stream: DDIM-20
# fold --timesteps per preset (None: the preset's); churches' "400" (500
# UNet calls a batch) cut to 100 for the smoke's time limit
LSUN_FOLD_STEPS = {"lsun_beds256": None, "lsun_churches256": 100}
# engine -> (flags of `cli sample`, qstate file, n, batch, --timesteps;
# None runs the preset's steps)
LSUN_RUNS = {
    "fold": (("--weight-bit", "4", "--engine", "fold", "--dtype",
              "bfloat16"), "w4", 2 * LSUN_BATCH, LSUN_BATCH, None),
    "sim": (("--weight-bit", "8", "--quant-act", "--engine", "sim"), "w8a8",
            8, 4, LSUN_SIM_STEPS),
    "int8": (("--weight-bit", "4", "--quant-act", "--split", "--engine",
              "int8"), "w4a8", 8, 4, LSUN_INT8_STEPS),
    "stream": (("--weight-bit", "4", "--engine", "stream",
                "--stream-convs"), "w4", 2, 1, LSUN_STREAM_STEPS)}
# (QuantFlags, act init) of each qstate file, as `calibrate` would build
# the model it calibrates: --quant-act builds the act-quant partition
LSUN_QSTATES = {"w4": (dict(weight_bit=4), False),
                "w8a8": (dict(weight_bit=8, quant_act=True, a_min_max=True),
                         True),
                "w4a8": (dict(weight_bit=4, quant_act=True, a_min_max=True,
                              split=True), True)}
VQ_TIE = 1e-4  # an f32 code that flips: the two distances within 1e-4 of
# |z|^2 + |e|^2, the size of the terms whose rounding they carry
VQ_TIE_BF16 = 2.0 ** -6  # the same for bf16 distances: a few bf16 ulps


def _ddim_calls(task, steps=None) -> int:
    """Entries of the preset's DDIM table at `steps` (default the
    preset's): one UNet call each. Churches' 400 give 500 (the
    reference's stride 1000 // 400 = 2)."""
    from qdiffusion_torch.schedules import make_ddim_timesteps

    return len(make_ddim_timesteps(task.sampler.skip_type,
                                   steps or task.sampler.timesteps,
                                   task.schedule.num_timesteps))


def _bsc(shapes: list) -> list:
    """Channel-last GroupNorm input shapes as (B, S, C), the three numbers
    B1's plan and kernels read: an NHWC slab and the (B, T, C) tokens of
    an AttentionBlock's norm of the same size are one shape."""
    return [(s[0], int(np.prod(s[1:-1])), s[-1]) for s in shapes]


def phase_lsun_spy(task, check: Checks) -> dict:
    """One bf16 UNet call at batch LSUN_BATCH and one decode of it, seeded
    weights, with every B1 call and blockwise dispatch recorded: the
    shapes the kernel phases hold B1, B2 and B3 at. Then one stream W4
    UNet call at batch 1 (f32, --stream-convs; 'mse' weights of the UNet
    the CLI draws), recording B6's (M, K, N) per call for `probe_designs`
    and the int-kernel phase, with every B6 call also run by its plain
    version on the CPU on a copy of its own inputs (STREAM_REL)."""
    from qdiffusion_torch.calib.engine import init_weight_qstate
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.models.vae import VAE

    model = _sd_unet(task, torch.bfloat16, weight_bit=4)
    model.load_state_dict(model.init_params(0))
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(0)
    s = task.latent_size
    x = torch.randn((LSUN_BATCH, s, s, task.latent_channels), generator=g,
                    device="cuda").to(torch.bfloat16)
    t = torch.randint(1, 1000, (LSUN_BATCH,), generator=g,
                      device="cuda").float()
    with gn_spy() as gn, attn_spy() as att, torch.no_grad():
        eps = model(x, t)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(eps).all()), f"{task.name} spy: UNet call "
                                           "not finite")
    del model, eps
    vae = VAE(task.vae).to(torch.bfloat16)
    vae.load_state_dict(vae.init_params(1))
    vae_params = sum(p.numel() for p in vae.parameters())
    with gn_spy() as gn_dec, attn_spy() as att_dec, torch.no_grad():
        img = vae.decode(x / task.scale_factor)
    torch.cuda.synchronize()
    check(tuple(img.shape) == (LSUN_BATCH, 256, 256, 3)
          and bool(torch.isfinite(img).all()), f"{task.name} spy: decode")
    del vae, img
    model = _lsun_unet(task, "cuda", "w4")
    step = make_quantized_step(model, init_weight_qstate(model),
                               engine="stream", stream_convs=True)
    with stream_site_check() as sites, stream_spy() as st, torch.no_grad():
        eps = step(x[:1].float(), t[:1])
    torch.cuda.synchronize()
    b6 = _calls(st.seen, "int4_dense_stream")
    worst = max(sites.errs, key=lambda e: e[1], default=((), float("inf")))
    check(bool(torch.isfinite(eps).all()) and b6
          and not _calls(st.seen, "int8_dense_stream"),
          f"{task.name} spy: stream W4 call, {len(b6)} B6 calls")
    check(len(sites.errs) == len(b6) and worst[1] <= STREAM_REL,
          f"{task.name} stream W4 per site: {len(sites.errs)} sites, "
          f"largest rel err {worst[1]} at {worst[0]} (limit {STREAM_REL})")
    del model, step, eps
    torch.cuda.empty_cache()
    row = {"phase": "lsun_spy", "task": task.name, "unet_params": n_params,
           "vae_params": vae_params, "batch": LSUN_BATCH,
           "unet_attention": [(n, r[0]) for n, r in att.seen],
           "decode_attention": [(n, r[0]) for n, r in att_dec.seen],
           "unet_gn_shapes": [s for _, s in gn.seen],
           "decode_gn_shapes": [s for _, s in gn_dec.seen],
           "stream_sites": {"sites": len(sites.errs),
                            "max_rel_err": worst[1],
                            "worst_site": list(worst[0]),
                            "tolerance": f"{STREAM_REL} of the site's "
                                         "largest output"},
           "streamed_convs": len(_calls(st.seen, "_stream_conv2d")),
           "b6_shapes": b6}
    # beds: 14 heads of 32 at 32x32 (5 sites); churches: 8 heads of 24 at
    # 32x32 (5); below 1024 tokens the blocks materialize
    want = {"lsun_beds256": ((LSUN_BATCH, 1024, 14, 32),
                             ("streaming_flash_attention",
                              (LSUN_BATCH, 4096, 1, 512))),
            "lsun_churches256": ((LSUN_BATCH, 1024, 8, 24),
                                 ("flash_attention",
                                  (LSUN_BATCH, 1024, 1, 512)))}[task.name]
    check(row["unet_attention"] == [("flash_attention", want[0])] * 5,
          f"{task.name} spy: UNet attention {row['unet_attention']}")
    check(row["decode_attention"] == [want[1]],
          f"{task.name} spy: decode attention {row['decode_attention']}")
    _emit({k: v for k, v in row.items() if not k.endswith("shapes")})
    return row


def phase_lsun_files(task, work: Path, check: Checks) -> dict:
    """The seeded VAE npz file in the JAX format and the three qstates of
    LSUN_QSTATES: W4 'mse' weights; W8A8 and W4A8 --split of the
    partitioned model, acts from 4 seeded latents ('max', the --a-min-max
    init of the LSUN calibration). The UNet is the one `cli` builds
    without --ckpt (init_params(0) on the card), so no UNet file is
    written or read."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.calib.engine import init_act_qstate, \
        init_weight_qstate
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.convert import to_jax_params
    from qdiffusion_torch.models.vae import VAE
    from qdiffusion_torch.utils.checkpoints import save_nested, save_qstate

    d = work / task.name
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    vae = VAE(task.vae)
    vae.load_state_dict(vae.init_params(1))
    save_nested(d / "vae.npz", to_jax_params(vae.state_dict()))
    del vae
    g = torch.Generator(device="cuda").manual_seed(2)
    s = task.latent_size
    xs = torch.randn((4, s, s, task.latent_channels), generator=g,
                     device="cuda")
    ts = torch.tensor([50.0, 300.0, 600.0, 950.0], device="cuda")
    init_s = {}
    for key, (flags, acts) in LSUN_QSTATES.items():
        model, _ = cli.build_model_and_pipeline(task, QuantFlags(**flags),
                                                "cuda", act_quant=acts)
        model.load_state_dict(model.init_params(0))
        t1 = time.perf_counter()
        q = init_weight_qstate(model)
        if acts:
            q = init_act_qstate(model, q, xs, ts)
        torch.cuda.synchronize()
        init_s[key] = time.perf_counter() - t1
        save_qstate(d / f"{key}.npz", q)
        if key == "w4a8":
            parts = [n for n in q if ".attention." in n]
            check(len(parts) == 2 * sum(1 for n in q if n.endswith(
                ".attention.smv_matmul")) > 0,
                f"{task.name} W4A8: partition sites {parts[:4]}")
        del model, q
    torch.cuda.empty_cache()
    row = {"phase": "lsun_files", "task": task.name,
           "seconds": time.perf_counter() - t0, "qstate_init_seconds": init_s,
           "mib": {f.name: f.stat().st_size / 2**20
                   for f in sorted(d.glob("*.npz"))}}
    _emit(row)
    return row


def _lsun_sample(task, work: Path, engine: str, check: Checks, *,
                 flags=None, qstate: Path = None, n=None, batch=None,
                 steps=None, out: str = None) -> dict:
    """`cli sample --task <LSUN preset>` through `engine` under
    `_spied_cli` (LSUN_RUNS' flags, qstate, n, batch and steps unless
    given): uint8 output of the right shape, finite, the sampler's table
    length in UNet calls per batch; img/s and ms per UNet call of the
    last batch (the first builds and warms up)."""
    flags0, qfile, n0, b0, steps0 = LSUN_RUNS[engine]
    flags, n, batch = flags or flags0, n or n0, batch or b0
    steps = steps or steps0
    d = work / task.name
    qstate = qstate or d / f"{qfile}.npz"
    calls = _ddim_calls(task, steps)
    batches = -(-n // batch)
    tag = f"{task.name} {engine}"
    res, spied = _spied_cli(
        ["sample", "--task", task.name,
         "--vae-ckpt", str(d / "vae.npz"), "--qstate", str(qstate), *flags,
         "--n", str(n), "--batch", str(batch),
         *(("--timesteps", str(steps)) if steps else ()),
         "--npz-out", str(d / f"{out or engine}.npz"), "--device",
         "cuda"],
        tag, calls * batches, batches, check)
    with np.load(res["path"]) as f:
        imgs = f["arr_0"]
    check(imgs.shape == (n, 256, 256, 3) and imgs.dtype == np.uint8,
          f"{tag}: npz {imgs.shape} {imgs.dtype}")
    check(res["nonfinite"] == 0, f"{tag}: {res['nonfinite']} non-finite")
    check(res["sampler"] == "ddim" and res["model_calls"] == [calls]
          * batches, f"{tag}: {res['sampler']} with UNet calls "
                     f"{res['model_calls']}, the table has {calls}")
    secs, dec_s = res["batch_seconds"], res["decode_seconds"]
    row = {"phase": "lsun_sample", "task": task.name, "engine": engine,
           "flags": list(flags), "n": n, "batch": batch,
           "steps": steps or task.sampler.timesteps, "table_length": calls,
           "eta": task.sampler.eta, "batch_seconds": secs,
           "decode_seconds": dec_s, "img_per_s": batch / secs[-1],
           "ms_per_unet_call": (secs[-1] - dec_s[-1]) / calls * 1e3,
           "decode_ms": dec_s[-1] * 1e3, **spied,
           "image_mean": float(imgs.mean()), "image_std": float(imgs.std())}
    _emit(row)
    return row


def _lsun_unet(task, dev: str, key: str):
    """The UNet of `cli sample` for qstate `key` on `dev`, with the weights
    the CLI draws without --ckpt: init_params(0) on the card (a CPU model
    gets a copy; a CPU generator draws other numbers)."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.config import QuantFlags

    flags, acts = LSUN_QSTATES[key]

    def build(where):
        return cli.build_model_and_pipeline(task, QuantFlags(**flags), where,
                                            act_quant=acts)[0]

    card = build("cuda")
    card.load_state_dict(card.init_params(0))
    if dev == "cuda":
        return card
    model = build(dev)
    model.load_state_dict({k: v.cpu() for k, v in
                           card.state_dict().items()})
    del card
    torch.cuda.empty_cache()
    return model


def _lsun_card_vs_cpu(task, work: Path, check: Checks) -> dict:
    """One full-width fold W4 UNet call at batch 1, card bf16 against CPU
    f32, and one int8 W4A8 --split call at batch 1 and half the latent
    size on the card's and the CPU's f32 carriers: every int8 activation
    within one bucket beyond its input's drift, every B4 call of the card
    bit for bit against the plain composition on its own input."""
    from qdiffusion_torch.deploy import fold_weights, make_quantized_step
    from qdiffusion_torch.utils.checkpoints import load_qstate

    d = work / task.name
    s, c = task.latent_size, task.latent_channels
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, s, s, c)).astype(
        np.float32))
    t = torch.tensor([500.0])

    def build(dev):
        model = _lsun_unet(task, dev, "w4")
        model.load_state_dict(fold_weights(model, load_qstate(
            d / "w4.npz", dev)))
        return model

    t0 = time.perf_counter()
    fold = {"batch": 1, **_fold_card_vs_cpu(task.name, build, (x, t),
                                            check)}
    secs = {"fold": time.perf_counter() - t0}
    # half the latent size: every int8 site at a quarter of the CPU time
    xh = torch.from_numpy(rng.standard_normal((1, s // 2, s // 2, c)).astype(
        np.float32))
    recs = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        model = _lsun_unet(task, dev, "w4a8")
        step = make_quantized_step(model, load_qstate(d / "w4a8.npz", dev),
                                   engine="int8",
                                   carrier_dtype=torch.float32)
        with QuantRecorder() as recs[dev]:
            out = step(xh.to(dev), t.to(dev))
        check(bool(torch.isfinite(out).all()), f"{task.name} int8 f32 call "
                                               f"on {dev}")
        del model, step, out
        secs[f"int8_{dev}"] = time.perf_counter() - t0
    rec_cpu, rec_card = recs["cpu"], recs["cuda"]
    sites_ok, flips, total = _within_one_bucket(rec_card, rec_cpu)
    check(sites_ok, f"{task.name} int8 card vs CPU: {len(rec_card.rec)} vs "
                    f"{len(rec_cpu.rec)} quantized sites, each within one "
                    f"bucket: {sites_ok}")
    check(rec_card.plain_sites > 0
          and rec_card.plain_equal == rec_card.plain_sites,
          f"{task.name} int8: {rec_card.plain_equal} of "
          f"{rec_card.plain_sites} B4 calls bit-equal to the plain "
          "composition")
    torch.cuda.empty_cache()
    return {"fold": fold,
            "int8": {"batch": 1, "latent": s // 2,
                     "quantized_sites": len(rec_card.rec),
                     "sites_within_one_bucket": sites_ok,
                     "int8_values_apart": flips, "int8_values": total,
                     "b4_calls_vs_plain": [rec_card.plain_sites,
                                           rec_card.plain_equal]},
            "seconds": secs}


def _vq_check(task, work: Path, check: Checks) -> dict:
    """The VQ codes of LSUN_BATCH seeded latents on the card against the
    CPU's from the same codebook (the seeded VAE file): f32 on both, and
    the card's bf16 carrier (the fold engine decodes in bf16) against the
    CPU in bf16 and in f32. Every f32 flip must be a near-tie: its two
    distances, recomputed in f64, within VQ_TIE of |z|^2 + |e|^2 (bf16:
    VQ_TIE_BF16)."""
    from qdiffusion_torch.cli import load_nested_params
    from qdiffusion_torch.models.vae import VAE

    g = torch.Generator().manual_seed(11)
    s = task.latent_size
    z = torch.randn((LSUN_BATCH, task.latent_channels, s, s), generator=g)
    sd = load_nested_params(work / task.name / "vae.npz", "--vae-ckpt")
    codes = {}
    for dev in ("cpu", "cuda"):
        vae = VAE(task.vae, device=dev)
        vae.load_state_dict(sd)
        for dtype in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                codes[(dev, dtype)] = vae.to(dtype).vq_codes(
                    z.to(dev, dtype).contiguous(
                        memory_format=torch.channels_last)).cpu()
        del vae
    emb = sd["quantize.embedding.weight"].double()
    flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]).double()

    def flipped(a, b, tie=None):
        at = (a != b).nonzero().flatten()
        ea, eb = emb[a[at]], emb[b[at]]
        x = flat[at]
        da = ((x - ea) ** 2).sum(1)
        db = ((x - eb) ** 2).sum(1)
        size = (x ** 2).sum(1) + torch.maximum((ea ** 2).sum(1),
                                               (eb ** 2).sum(1))
        gap = ((da - db).abs() / size)
        out = {"flipped": int(at.numel()), "share": at.numel() / a.numel(),
               "max_gap": float(gap.max()) if at.numel() else 0.0}
        if tie is not None:
            out["near_ties"] = bool((gap <= tie).all())
        return out

    f32 = flipped(codes[("cuda", torch.float32)],
                  codes[("cpu", torch.float32)], VQ_TIE)
    bf16 = flipped(codes[("cuda", torch.bfloat16)],
                   codes[("cpu", torch.bfloat16)], VQ_TIE_BF16)
    carrier = flipped(codes[("cuda", torch.bfloat16)],
                      codes[("cpu", torch.float32)])
    check(f32["near_ties"], f"{task.name} VQ codes f32 card vs CPU: "
                            f"{f32['flipped']} flips, gap {f32['max_gap']}"
                            f" over {VQ_TIE}")
    check(bf16["near_ties"], f"{task.name} VQ codes bf16 card vs CPU: "
                             f"{bf16['flipped']} flips, gap "
                             f"{bf16['max_gap']} over {VQ_TIE_BF16}")
    return {"codes": int(flat.shape[0]), "codebook": list(emb.shape),
            "f32_card_vs_cpu": f32, "bf16_card_vs_cpu": bf16,
            "bf16_card_vs_cpu_f32": carrier,
            "distinct_codes_f32": int(codes[("cpu", torch.float32)]
                                      .unique().numel())}


def phase_lsun_int_kernels(task, work: Path, b6: list, per_call: dict,
                           check: Checks, designs: dict) -> list:
    """B4 and B6 at the preset's path shapes, each against its plain
    version and timed as at the CIFAR and SD sites: B4 at every distinct
    site of one int8 W4A8 --split UNet call at the CLI's batch and full
    latents (a B4Sites spy's inputs; `_b4_site`: bit for bit, int32
    products exact), B6 at every distinct (M, K, N) of the stream W4 call
    that `phase_lsun_spy` recorded (`b6`). The spies' calls per UNet call
    must equal the CLI runs' launches per call (`per_call`, by engine)."""
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.ops.int8_conv import int8_conv
    from qdiffusion_torch.utils.checkpoints import load_qstate

    batch = LSUN_RUNS["int8"][3]
    s, c = task.latent_size, task.latent_channels
    model = _lsun_unet(task, "cuda", "w4a8")
    step = make_quantized_step(model, load_qstate(
        work / task.name / "w4a8.npz", "cuda"), engine="int8")
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((batch, s, s, c), generator=g, device="cuda")
    t = torch.full((batch,), 500.0, device="cuda")
    before = int8_conv.launches
    with B4Sites() as spy, torch.no_grad():
        eps = step(x, t)
    torch.cuda.synchronize()
    launched = int8_conv.launches - before
    sites = [k for _, k in spy.seen]
    want = per_call["int8"]["int8_conv"]
    check(bool(torch.isfinite(eps).all()) and len(sites) == launched == want,
          f"{task.name} int8 call: {len(sites)} B4 sites, {launched} "
          f"launches, the CLI's {want} per call")
    del model, step, eps
    torch.cuda.empty_cache()
    rows = phase_b4_sites(sites, spy.inputs,
                          f"{task.name} W4A8 int8 UNet call, batch {batch}",
                          check)
    del spy
    want = per_call["stream"]["int4_stream_matmul"]
    check(len(b6) == want, f"{task.name} stream: {len(b6)} B6 calls in the "
                           f"spied call, the CLI's {want} per call")
    return rows + _stream_rows("int4_stream_matmul", b6,
                               f"{task.name} stream W4 UNet call, batch 1",
                               check, designs)


def phase_lsun(task, work: Path, smi: str, spied: dict, check: Checks,
               designs: dict) -> dict:
    """An LSUN preset through `cli sample` on every engine (LSUN_RUNS),
    then card against CPU (fold, int8 per site), for a VQ first stage its
    codes, and B4 / B6 at the path's shapes (`spied`: the preset's
    `phase_lsun_spy` row)."""
    t0 = time.perf_counter()
    files = phase_lsun_files(task, work, check)
    runs = {engine: _lsun_sample(
        task, work, engine, check,
        steps=LSUN_FOLD_STEPS[task.name] if engine == "fold" else None)
        for engine in LSUN_RUNS}
    fold, st = runs["fold"]["per_unet_call"], runs["stream"]
    check(fold["flash_attention"] == 5 and fold["int8_conv"] == 0,
          f"{task.name} fold: per call {fold}")
    check(runs["sim"]["per_unet_call"]["flash_attention"] == 0,
          f"{task.name} sim: B2 in a partitioned call (it materializes)")
    check(runs["int8"]["per_unet_call"]["int8_conv"] > 0
          and runs["int8"]["per_unet_call"]["flash_attention"] == 0,
          f"{task.name} int8: per call {runs['int8']['per_unet_call']}")
    check(st["per_unet_call"]["int4_stream_matmul"] > 0
          and st["per_unet_call"]["flash_attention"] == 5,
          f"{task.name} stream: per call {st['per_unet_call']}")
    card_cpu = _lsun_card_vs_cpu(task, work, check)
    vq = _vq_check(task, work, check) if task.vae.n_embed else None
    ints = phase_lsun_int_kernels(
        task, work, spied["b6_shapes"],
        {e: r["per_unet_call"] for e, r in runs.items()}, check, designs)
    row = {"phase": "lsun", "task": task.name, "nvidia_smi": smi,
           "reduced": {"weights": "seeded (the LSUN checkpoints are not "
                       "in the repo)",
                       "steps": {e: r["steps"] for e, r in runs.items()}},
           "files": files, "card_vs_cpu": card_cpu, "vq": vq,
           "img_per_s": {e: r["img_per_s"] for e, r in runs.items()},
           "ms_per_unet_call": {e: r["ms_per_unet_call"]
                                for e, r in runs.items()},
           "launches": {e: r["launches"] for e, r in runs.items()},
           "seconds": time.perf_counter() - t0}
    _emit(row)
    return {**row, "runs": runs, "int_kernels": ints}


def phase_lsun_profile(task, work: Path, out: Path) -> dict:
    """torch.profiler over three UNet calls of each engine at its LSUN_RUNS
    batch: fold W4 bf16 (8), int8 W4A8 --split (4), stream W4 f32 with
    the convs the cost model streams (1); and three bf16 decodes at 8."""
    from qdiffusion_torch import cli
    from qdiffusion_torch.deploy import make_quantized_step
    from qdiffusion_torch.utils.checkpoints import load_qstate

    d = work / task.name
    s, c = task.latent_size, task.latent_channels
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for engine, key, kw in (("fold", "w4", dict(dtype=torch.bfloat16)),
                            ("int8", "w4a8", {}),
                            ("stream", "w4", dict(stream_convs=True))):
        batch = LSUN_RUNS[engine][3]
        model = _lsun_unet(task, "cuda", key)
        step = make_quantized_step(model, load_qstate(d / f"{key}.npz",
                                                      "cuda"),
                                   engine=engine, **kw)
        x = torch.randn((batch, s, s, c), generator=g, device="cuda")
        x = x.to(kw.get("dtype", torch.float32))
        t = torch.full((batch,), 500.0, device="cuda")
        rows[engine] = profile_breakdown(
            lambda: step(x, t), 3,
            out / f"{task.name}_{engine}_trace.json",
            f"{task.name} {engine} UNet call, batch {batch}")
        del model, step
        torch.cuda.empty_cache()
    _, pipe = cli.build_model_and_pipeline(task, None, "cuda")
    pipe.vae.load_state_dict(cli.load_nested_params(d / "vae.npz",
                                                    "--vae-ckpt"))
    pipe.vae.to(torch.bfloat16)
    z = torch.randn((LSUN_BATCH, s, s, c), generator=g, device="cuda")
    rows["decode"] = profile_breakdown(
        lambda: pipe.decode(z, torch.bfloat16), 3, None,
        f"{task.name} bf16 decode, batch {LSUN_BATCH}")
    del pipe
    torch.cuda.empty_cache()
    row = {"phase": "lsun_profile", "task": task.name, **rows}
    _emit(row)
    return row


# calib_lsun: the beds W4A8 calibration in the reference's LSUN form (one
# `calibrate --quant-act` on the partitioned model: the weight pass, then
# the act pass with the 'max' act init of --a-min-max and the EMA of
# --running-stat), cut in scale only: a 4-image DDIM-200 (eta 1)
# trajectory, 4 samples at each of the 10 steps cali_st 10 slices (40
# rows; reference 256 x 20), LC_ITERS iterations a unit in each pass
# (reference 20,000 and 5,000), batch LC_BATCH
LC_N, LC_ST, LC_CALI_N, LC_BATCH = 4, 10, 4, 8
LC_ITERS = 10
LC_SAMPLE_STEPS = 5  # DDIM-5 samples of the qstate, sim and int8: two
# batches of 1, the second timed


def phase_calib_lsun(task, work: Path, smi: str, check: Checks) -> dict:
    """make-cali-data --task lsun_beds256 --n 4 (DDIM-200 at eta 1, f32),
    calibrate --weight-bit 4 --split --quant-act --a-min-max --running-stat
    over every unit of both passes, then DDIM-5 samples of its qstate
    through sim and int8. Spies time every part, count B1/B2/B3 in each
    and hold every unit's block error after its reconstruction to 1.02x
    its start's, the sums lower; B1/B2/B3 never launch inside a
    reconstruction, B2/B3 never in a capture, the act init or the EMA
    (the partition materializes the 14 x 1024^2 attention)."""
    from qdiffusion_torch import cli

    wc = work / "calib_lsun"
    wc.mkdir(parents=True, exist_ok=True)
    traj = wc / "traj.npz"
    parts = _Parts()
    steps = _ddim_calls(task)
    t0 = time.perf_counter()
    made, spied = _spied_cli(
        ["make-cali-data", "--task", task.name, "--n", str(LC_N), "--out",
         str(traj),
         "--device", "cuda"], "calib_lsun trajectory", steps, 0, check)
    parts.parts["trajectory"] = {"seconds": time.perf_counter() - t0,
                                 "calls": 1, **spied["launches"]}
    s = task.latent_size
    check(made["shapes"] == {"xs": (steps, LC_N, s, s, 3),
                             "ts": (steps, LC_N)},
          f"calib_lsun trajectory {made['shapes']}")
    check(spied["per_unet_call"]["flash_attention"] == 5,
          f"calib_lsun trajectory: per call {spied['per_unet_call']}")

    torch.cuda.reset_peak_memory_stats()
    peaks = {}

    def act_start():
        peaks["weight"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    with _CalibSpies(parts, LC_BATCH, on_act_start=act_start) as spies:
        cal = parts("calibrate", cli.main, [
            "calibrate", "--task", task.name, "--cali-data", str(traj), "--weight-bit", "4", "--split",
            "--quant-act", "--a-min-max", "--running-stat",
            "--cali-st", str(LC_ST), "--cali-n", str(LC_CALI_N),
            "--cali-batch-size", str(LC_BATCH), "--act-init-batch",
            str(LC_BATCH), "--cali-iters", str(LC_ITERS), "--cali-iters-a",
            str(LC_ITERS), "--run-dir", str(wc / "run"), "--device",
            "cuda"])[0]
    peaks["act"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    check(cal["samples"] == LC_ST * LC_CALI_N,
          f"calib_lsun: {cal['samples']} calibration rows")
    model = _lsun_unet(task, "cpu", "w4a8")
    units = [u.name for u in model.units]
    weight_units = [u.name for u in model.units if u.layer_names]
    del model
    quality = _calib_checks("calib_lsun", parts, spies.units,
                            {"weight": weight_units, "act": units}, check)

    samples = {}
    for engine in ("sim", "int8"):
        samples[engine] = _lsun_sample(
            task, work, engine, check, flags=(
                "--weight-bit", "4", "--quant-act", "--split", "--engine",
                engine), qstate=Path(cal["path"]), n=2, batch=1,
            steps=LC_SAMPLE_STEPS, out=f"calib_{engine}")
    # the path's launches: trajectory, calibrate (without the spies' own
    # block-error forwards) and samples
    p = parts.parts
    path = {k: p["trajectory"][k] + p["calibrate"][k] - p["block_error"][k]
            + sum(r["launches"][k] for r in samples.values())
            for k in ("group_norm", "flash_attention", "flash_streaming")}
    kinds = {}
    for what, rows in spies.units.items():
        for r in rows:
            kinds.setdefault(f"{what}/{r['kind']}", []).append(
                r["ms_per_iter"])
    row = {"phase": "calib_lsun", "task": task.name, "nvidia_smi": smi,
           "reduced": {"trajectory": f"{LC_N} images, DDIM-{steps} at eta "
                       f"{task.sampler.eta}",
                       "calibration samples": f"{LC_CALI_N} x {LC_ST} steps "
                       "(reference 256 x 20)",
                       "iterations per unit": f"{LC_ITERS} weight, "
                       f"{LC_ITERS} act (reference 20000, 5000)",
                       "batch": LC_BATCH,
                       "samples": f"DDIM-{LC_SAMPLE_STEPS}, two batches "
                                  "of 1"},
           "samples_rows": cal["samples"], "units": len(units),
           "weight_units": len(weight_units),
           "seconds": {k: v["seconds"] for k, v in p.items()},
           "calls": {k: v["calls"] for k, v in p.items()},
           "launches": {k: {n: v.get(n, 0) for n in (
               "group_norm", "flash_attention", "flash_streaming")}
               for k, v in p.items()},
           "peak_device_gb": peaks,
           "ms_per_iter_by_kind": {k: {"median": float(np.median(v)),
                                       "max": max(v), "units": len(v)}
                                   for k, v in kinds.items()},
           "quality": quality,
           "samples": {e: {k: r[k] for k in (
               "batch_seconds", "decode_seconds", "launches",
               "per_unet_call", "image_mean", "image_std")}
               for e, r in samples.items()},
           "path_launches": path}
    _emit(row)
    for what, rows in spies.units.items():
        for r in rows:
            _emit({"phase": f"calib_lsun_{what}_unit", **r})
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
        "per": per, "shapes": len(sel),
        **({"design": "mma" if all(r["design"] == "mma" for r in sel)
            else None,
            "bit_equal_relaunch": all(r["bit_equal_relaunch"] for r in sel)}
           if "design" in sel[0] else {})}


def _lsun_int_summary(lsun: dict, name: str) -> dict:
    """B4 or B6 at the LSUN paths' shapes for the kernels line: per-call
    sums over the distinct sites of one int8 W4A8 UNet call at batch 4 or
    one stream W4 call at batch 1 of each preset (`phase_lsun`'s rows)."""
    out = {}
    for task_name in LSUN:
        sel = [x for x in lsun[task_name]["int_kernels"]
               if x["kernel"] == name]
        r = _int_row(sel, name, None, None, None)
        out[sel[0]["where"]] = {
            "sites": sum(x["per_call"] for x in sel),
            **{k: r[k] for k in ("shapes", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
            **({"cudnn_bf16_ms": sum(x["cudnn_bf16_ms"] * x["per_call"]
                                     for x in sel),
                "bit_equal_sites": sum(x["bit_equal"] and x["int32_exact"]
                                       for x in sel)}
               if name == "int8_conv" else {})}
    return out


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
    p.add_argument("--quality-only", action="store_true",
                   help="run only the quality phase (the full smoke runs "
                        "it so, in a process of its own)")
    p.add_argument("--profile", action="store_true",
                   help="add torch.profiler breakdowns of a CIFAR fold "
                        "step, an SD fold UNet call, a CIFAR int8 step, "
                        "an SD stream W4 UNet call and the LSUN presets' "
                        "fold, int8 and stream calls and decodes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.quality_only:
        return quality_only(Path(args.out))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    quality_proc = start_quality(out)
    try:
        return _smoke(args, out, quality_proc)
    finally:
        proc = quality_proc[0]
        if proc.poll() is None:  # a phase raised before the join
            proc.kill()
            proc.wait()


def _smoke(args, out: Path, quality_proc) -> int:
    from qdiffusion_torch import resolve_device
    from qdiffusion_torch.config import PRESETS
    from qdiffusion_torch.ops import _cuda
    from qdiffusion_torch.ops.flash_attention import flash_attention
    from qdiffusion_torch.ops.flash_streaming import \
        streaming_flash_attention

    t_start = time.perf_counter()
    work = Path(args.work)
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
    # the GroupNorm shapes of the CIFAR step and of an SD UNet call and
    # decode (spies, no CUDA graph), then the designs that ran, from the
    # profiler, before any CUDA graph
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
    cifar_gn = [(BATCH,) + s[1:] for s in shapes]
    quality_shapes = quality_gn_shapes()
    sd = PRESETS["sd_v1"]
    spy = phase_sd_spy(sd, check)
    torch.cuda.empty_cache()
    lsun_spy_rows = {name: phase_lsun_spy(PRESETS[name], check)
                     for name in LSUN}
    lsun_gn_bsc = {name: {key: _bsc(r[key]) for key in (
        "unet_gn_shapes", "decode_gn_shapes")}
        for name, r in lsun_spy_rows.items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    designs = probe_designs(cifar_gn + quality_shapes + spy["unet_gn_shapes"]
                            + spy["decode_gn_shapes"] + [
                                s for r in lsun_gn_bsc.values()
                                for v in r.values() for s in v], [
                                ("int4_stream_matmul", m)
                                for r in lsun_spy_rows.values()
                                for m in r["b6_shapes"]])
    _emit({"phase": "designs", "probed": len(designs),
           "seconds": time.perf_counter() - t0})

    # beside the quality process (their rows tagged): slice 10's inputs
    # and the SD card-vs-CPU check, which time nothing, then the CIFAR-10
    # calibration, slice 8's path: the AdaRound weight pass
    files = phase_sd_files(sd, work, check)
    sd_cpu = phase_sd_card_vs_cpu(sd, work, check)
    torch.cuda.empty_cache()
    calib = phase_calib(task, work, smi, check)
    torch.cuda.empty_cache()
    # slice 9's path: the activation pass on its qstate, then int8
    calib_act = phase_calib_act(task, work, smi, check)
    for name, n in calib_act["int8"]["launches"].items():
        check(n > 0, f"calib_act int8 sample: {name} not launched")
    torch.cuda.empty_cache()
    # slice 13's path: the calib phase's W4 qstate exported and reloaded
    export = phase_export(task, work, smi, check)
    torch.cuda.empty_cache()
    # slice 13's path: the quality evidence at the JAX test's settings,
    # run in its own process since the start; every phase from here on
    # has the card and the host to itself
    quality = join_quality(quality_proc, smi, check)
    quality_gn = quality_gn_time(quality_shapes, designs, check)

    # CIFAR-10, slice 1's path
    rows = phase_kernels(cifar_gn, check, designs,
                         where="cifar10 UNet step")
    fold = phase_fold(task, out, per_step, check)
    check(fold["group_norm_launches"] > 0, "cifar fold: B1 not launched")
    card_cpu = phase_card_vs_cpu(task, out, check)
    sim = phase_sim(task, out, per_step, check)
    prof = phase_profile(task, out) if args.profile else None
    torch.cuda.empty_cache()

    # Stable Diffusion v1, slice 2's path
    gn_unet = phase_kernels(spy["unet_gn_shapes"], check, designs,
                            phase="gn_sd", where="sd_v1 UNet call")
    gn_dec = phase_kernels(spy["decode_gn_shapes"], check, designs,
                           phase="gn_sd", where="sd_v1 VAE decode")
    attn = phase_attn_kernels(check, designs)
    sd_fold = phase_sd_fold_cli(sd, work, spy, check)
    sd_sim = phase_sd_sim(sd, work, check)
    # slice 10's path: the latent models' calibration
    torch.cuda.empty_cache()
    calib_sd = phase_calib_sd(sd, work, spy, smi, check)
    torch.cuda.empty_cache()
    sd_prof = phase_sd_profile(sd, work, out) if args.profile else None
    sd_launches = sd_fold["launches"]
    for name, n in sd_launches.items():
        check(n > 0, f"sd fold: {name} not launched")

    # the int8 and stream deployment engines, this slice's paths
    i8 = int8_setup(task, out, check)
    st = {4: sd_stream_spy(sd, work, 4, check,
                           profile_to=out if args.profile else None),
          8: sd_stream_spy(sd, work, 8, check)}
    ints = phase_int_kernels(i8, st[8]["shapes"], st[4]["shapes"],
                             check, designs)
    int8_cli = phase_int8_cli(task, out, i8, check)
    int8_cpu = phase_int8_card_vs_cpu(task, out, i8, check)
    int8_prof = phase_int8_profile(i8, out) if args.profile else None
    i8_row, b4_per_step = i8["row"], len(i8["sites"])
    del i8
    torch.cuda.empty_cache()
    sd_stream = phase_sd_stream_cli(sd, work, spy, st, check)
    for name, n in int8_cli["launches"].items():
        check(n > 0, f"int8 cli: {name} not launched")
    for wbits, row in sd_stream.items():
        for name in ("group_norm", "flash_attention", "flash_streaming"):
            check(row["launches"][name] > 0,
                  f"sd stream W{wbits}: {name} not launched")

    # slice 12's paths: DPM-Solver and DDPM through `sample --sampler`,
    # beside the same engines' DDIM / PLMS runs above
    base = {"cifar10_fold": ("generalized", fold["ms_per_step"],
                             fold["img_per_s"]),
            "cifar10_int8": ("generalized", int8_cli["ms_per_step"],
                             int8_cli["img_per_s"]),
            "sd_v1_fold": ("plms", sd_fold["s_per_unet_call"] * 1e3,
                           sd_fold["img_per_s"]),
            "sd_v1_stream_w4": ("plms", sd_stream[4]["ms_per_unet_call"],
                                sd_stream[4]["img_per_s"])}
    base = {k: dict(zip(("sampler", "ms_per_unet_call", "img_per_s"), v))
            for k, v in base.items()}
    samplers = phase_samplers(task, sd, out, work, per_step, b4_per_step,
                              spy, st, base, check)
    sampler_paths = {k: r["launches"] for k, r in samplers.items()
                     if k != "sampler_loops"}
    for k in ("group_norm", "flash_attention", "flash_streaming",
              "int8_conv", "int4_stream_matmul"):
        check(sum(v[k] for v in sampler_paths.values()) > 0,
              f"samplers: {k} not launched on any sampler path")
    torch.cuda.empty_cache()

    # the LSUN latent-diffusion family, slice 11's paths: B1 and B2/B3 at
    # their shapes, each preset through every engine, then the beds W4A8
    # calibration
    gn_lsun = []
    for name, r in lsun_gn_bsc.items():
        for key, where in (("unet_gn_shapes", "UNet call"),
                           ("decode_gn_shapes", "decode")):
            gn_lsun += phase_kernels(r[key], check, designs,
                                     phase="gn_lsun",
                                     where=f"{name} {where}",
                                     time_dtypes=(torch.bfloat16,))
    attn_lsun = phase_attn_kernels(
        check, designs, LSUN_ATTN_CASES, path="lsun",
        first_seed=len(ATTN_CASES),
        f32_library={shape for _, shape, *_ in LSUN_ATTN_CASES})
    lsun = {name: phase_lsun(PRESETS[name], work, smi, lsun_spy_rows[name],
                             check, designs)
            for name in LSUN}
    lsun_prof = {name: phase_lsun_profile(PRESETS[name], work, out)
                 for name in LSUN} if args.profile else None
    torch.cuda.empty_cache()
    calib_lsun = phase_calib_lsun(PRESETS["lsun_beds256"], work, smi, check)
    torch.cuda.empty_cache()
    lsun_paths = {f"{name}_{engine}": r["launches"] for name in LSUN
                  for engine, r in lsun[name]["runs"].items()}
    for k in ("group_norm", "flash_attention", "flash_streaming",
              "int8_conv", "int4_stream_matmul"):
        check(sum(v[k] for v in lsun_paths.values()) > 0,
              f"lsun: {k} not launched on any LSUN path")

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
             "cifar10_calib": calib["b1_launches"]["path"],
             "cifar10_calib_act": calib_act["b1_launches"]["path"],
             "sd_v1_calib": calib_sd["path_launches"]["group_norm"],
             "sd_v1_stream_w4": sd_stream[4]["launches"]["group_norm"],
             "sd_v1_stream_w8": sd_stream[8]["launches"]["group_norm"],
             "quality": quality["b1_launches"]["path"],
             "export": export["b1_launches"]},
         "quality_sampling_call": {
             **{k: v for k, v in quality_gn.items() if k != "rows"},
             "per": f"the {len(quality_shapes)} GroupNorms of one TINY "
                    f"f32 UNet call at batch {QUALITY['n_samples']}; CUDA "
                    "graph"},
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
        {**_int_row(ints, "int8_conv",
                    "qdiffusion_tpu/ops/pallas/int8_matmul.py:88",
                    int8_cli["launches"]["int8_conv"],
                    f"the {b4_per_step} B4 sites of one CIFAR W4A8 int8 "
                    f"step at batch {BATCH} (one launch each); CUDA graph "
                    "over copies of each site's input"),
         "launches_by_path": {
             "cifar10_int8": int8_cli["launches"]["int8_conv"],
             "cifar10_calib_act_int8":
                 calib_act["int8"]["launches"]["int8_conv"]},
         "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] * r["per_call"]
                              for r in ints if r["kernel"] == "int8_conv"),
         "bit_equal_sites": sum(r["bit_equal"] and r["int32_exact"]
                                for r in ints if r["kernel"] == "int8_conv")},
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
    stream_f32 = [r for r in attn if r["kernel"] == "flash_attention"
                  and r["dtype"] == "float32" and r["shape"][0] == 2]
    ssum = lambda key: sum(r[key] * r["per_call"] for r in stream_f32)
    kernels[1]["f32_route"] = {
        "per": "the 10 flash sites of one SD stream f32 UNet call at batch "
               "2 (5 x (2,4096,8,40), 5 x (2,1024,8,80)); CUDA graph",
        "design": sorted({str(r["design"]) for r in stream_f32}),
        "ms": ssum("ms"), "plain_ms": ssum("plain_ms"),
        "bound_ms": max(ssum("bytes_ms"), ssum("ops_ms")),
        "bound_by": "bytes" if ssum("bytes_ms") >= ssum("ops_ms")
        else "operations",
        "f32_fma_ms": ssum("f32_fma_ms"),
        "library_ms": ssum("library_ms")}
    stream_dec = [r for r in attn if r["kernel"] == "flash_streaming"
                  and tuple(r["shape"]) in STREAM_ATTN]
    kernels[2]["f32_route"] = {
        "per": "the VAE mid attention of one stream f32 decode at batch 1 "
               "(1,4096,1,512); CUDA graph",
        **{k: stream_dec[0][k] for k in (
            "design", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "f32_fma_ms", "max_abs_err")}}
    for row, key in ((kernels[1], "flash_attention"),
                     (kernels[2], "flash_streaming")):
        row["launches_by_path"] = {
            "sd_v1_fold": sd_launches[key],
            "sd_v1_calib": calib_sd["path_launches"][key],
            "sd_v1_stream_w4": sd_stream[4]["launches"][key],
            "sd_v1_stream_w8": sd_stream[8]["launches"][key]}
    lsun_paths["lsun_beds256_calib"] = {
        **calib_lsun["path_launches"],
        **{k: sum(r["launches"][k] for r in calib_lsun["samples"].values())
           for k in ("int8_conv", "int4_stream_matmul")}}
    for row, key in ((kernels[0], "group_norm"),
                     (kernels[1], "flash_attention"),
                     (kernels[2], "flash_streaming"),
                     (kernels[3], "int8_conv"),
                     (kernels[5], "int4_stream_matmul")):
        row.setdefault("launches_by_path", {}).update(
            {p: v[key] for p, v in {**lsun_paths, **sampler_paths}.items()
             if v[key]})
    kernels[0]["lsun"] = {
        r["where"]: {k: per_call_sum([x for x in gn_lsun
                                      if x["where"] == r["where"]], k)
                     for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        for r in gn_lsun}
    for row, name, cases in (
            (kernels[1], "flash_attention", {
                "lsun_beds256 UNet call": (8, 1024, 14, 32),
                "lsun_churches256 UNet call": (8, 1024, 8, 24),
                "lsun_churches256 decode": (8, 1024, 1, 512)}),
            (kernels[2], "flash_streaming", {
                "lsun_beds256 decode": (8, 4096, 1, 512),
                "S = 1024 (no path)": (8, 1024, 1, 512)})):
        row["lsun"] = {}
        for where, shape in cases.items():
            r = next(x for x in attn_lsun if x["kernel"] == name
                     and tuple(x["shape"]) == shape
                     and x["dtype"] == "bfloat16" and not x["quant"])
            n = max(r["per_call"], 1)
            row["lsun"][where] = {
                "shape": list(shape), "sites": r["per_call"],
                "design": r["design"], "bound_by": r["bound_by"],
                **{k: r[k] * n for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms")}}
    kernels[3]["lsun"] = _lsun_int_summary(lsun, "int8_conv")
    kernels[5]["lsun"] = _lsun_int_summary(lsun, "int4_stream_matmul")
    report = {"device": device, "nvidia_smi": smi, "build": built,
              "ptxas": ptxas,
              "kernels": kernels, "kernel_shapes": rows, "gn_sd": gn_sd,
              "attn_kernels": attn, "fold": fold, "card_vs_cpu": card_cpu,
              "sim": sim, "profile": prof, "calib": calib,
              "calib_act": calib_act, "sd_spy": {
                  k: v for k, v in spy.items() if not k.endswith("shapes")},
              "sd_files": files, "sd_fold": sd_fold,
              "sd_card_vs_cpu": sd_cpu, "sd_sim": sd_sim,
              "calib_sd": calib_sd,
              "sd_profile": sd_prof, "int8_spy": i8_row,
              "sd_stream_spy": {w: {k: v for k, v in r.items()
                                    if k != "shapes"} for w, r in st.items()},
              "int_kernels": ints, "int8_cli": int8_cli,
              "int8_card_vs_cpu": int8_cpu, "int8_profile": int8_prof,
              "sd_stream_cli": sd_stream, "flash_epilogue": p_rows,
              "lsun_spy": {n: {k: v for k, v in r.items()
                               if not k.endswith("shapes")}
                           for n, r in lsun_spy_rows.items()},
              "gn_lsun": gn_lsun, "attn_lsun": attn_lsun, "lsun": lsun,
              "calib_lsun": calib_lsun, "lsun_profile": lsun_prof,
              "samplers": samplers, "export": export, "quality": quality,
              "gn_quality": quality_gn["rows"],
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
