"""Quality evidence for the PTQ pipeline: calibrated W4 (and W4A8) against
naive rounding, scored by FID (port of scripts/quality_evidence.py).

The paper's claim is that AdaRound + block reconstruction keeps sample
quality close to FP at 4-bit weights. Real-checkpoint FID needs external
weights, so this runs the claim in miniature, end to end:

  1. Train a tiny DDPM (models/unet_ddim.py, the TINY config below) on a
     procedural two-blob image distribution: Adam at 2e-3 (optax's
     defaults), batch 128, noise-prediction MSE over uniform timesteps.
     Training forwards run under QuantCtx(differentiable=True), so
     GroupNorm takes its differentiable PyTorch form: kernel B1 has no
     backward.
  2. Sample with the FP model (samplers/ddim.py, DDIM at eta 0), keep the
     trajectory, and draw the calibration set from it
     (calib/samples.py::get_train_samples).
  3. Quantize weights to `bits` two ways: nearest rounding
     (init_weight_qstate) and the calibration pipeline (AdaRound + block
     reconstruction, calib.engine.calibrate). With `act_quant`, also
     W{bits}A8: the naive arm adds a first-batch act scale init, the
     calibrated arm the act pass (act-delta reconstruction at a quarter
     of the iterations, after a running-stat EMA sweep). The calibrated
     W4A8 arm starts from the calibrated W4 qstate (skip_weight_pass) on
     the same generator: the JAX engine's W4A8 weight pass draws what its
     W4 run draws and gives the same weight qstate (a CPU test holds it).
  4. Score every sample set against fresh true samples with the FID of
     metrics/fid.py over a fixed seeded random CNN (three 3x3 stride-2
     convs with JAX's SAME padding, leaky ReLU 0.2, mean over H and W).

Seeds seed .. seed + 5 seed the generators of the init, the sample
noise, the sampler, the calibration, the feature CNN and the true set;
training draws from seed + 1000. The draws differ from the JAX script's
(another generator), so its FIDs do too: the port is held to the JAX
test's bounds, not to its numbers. Training runs exactly `train_steps`
steps (the JAX loop runs whole chunks of 250).

    python -m qdiffusion_torch.scripts.quality_evidence [--act] [--bits 4]
        [--fast] [--train-steps N] [--samples N] [--recon-iters N]
        [--sample-steps N] [--cali-n N] [--cali-st N] [--device cuda|cpu]

Prints one JSON line: {"fid_fp", "fid_naive", "fid_calib",
"recovered_frac" = (fid_naive - fid_calib) / (fid_naive - fid_fp), ...},
with --act also fid_naive_a8, fid_calib_a8 and recovered_frac_a8. It runs
on the card and raises without CUDA unless the caller passes --device
cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import time
from typing import Callable, ContextManager, Optional

import numpy as np
import torch
import torch.nn.functional as F

from qdiffusion_torch.calib.engine import (
    CalibConfig,
    calibrate,
    init_act_qstate,
    init_weight_qstate,
)
from qdiffusion_torch.calib.recon import ReconConfig
from qdiffusion_torch.calib.samples import get_train_samples
from qdiffusion_torch.device import resolve_device
from qdiffusion_torch.metrics import fid_from_features
from qdiffusion_torch.models.unet_ddim import (
    DDIMUNet,
    DDIMUNetConfig,
    QuantPolicy,
)
from qdiffusion_torch.quant.affine import AffineQuantizerSpec
from qdiffusion_torch.quant.context import QuantCtx, QuantMode
from qdiffusion_torch.samplers.ddim import ddim_sample
from qdiffusion_torch.schedules import get_beta_schedule, make_skip_sequence

RES = 16
T = 1000
CFG = DDIMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), resolution=RES)
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                          num_diffusion_timesteps=T)
ABAR = np.cumprod(1.0 - BETAS).astype(np.float32)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- data


def synth_draws(generator: torch.Generator, n: int):
    """The random part of a two-blob batch, on the generator's device:
    pos (n, 2, 2) in [4, RES - 4), col (n, 2, 3) in [-1, 1), sig (n, 2)
    in [1.2, 2.5)."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    return (uniform((n, 2, 2), 4.0, RES - 4.0),
            uniform((n, 2, 3), -1.0, 1.0), uniform((n, 2), 1.2, 2.5))


def render_blobs(pos: torch.Tensor, col: torch.Tensor,
                 sig: torch.Tensor) -> torch.Tensor:
    """(n, RES, RES, 3) images in [-1, 1]: two Gaussian color blobs at
    `pos` with widths `sig` and colors `col` on a zero background."""
    r = torch.arange(RES, dtype=torch.float32, device=pos.device)
    grid = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)  # (H, W, 2)
    d2 = torch.sum((grid[None, None] - pos[:, :, None, None, :]) ** 2, -1)
    blob = torch.exp(-d2 / (2.0 * sig[:, :, None, None] ** 2))  # (n,2,H,W)
    return torch.clamp(torch.einsum("nbhw,nbc->nhwc", blob, col), -1.0, 1.0)


def synth_batch(generator: torch.Generator, n: int) -> torch.Tensor:
    """n images of the procedural distribution: the dataset is a function
    of the generator's state."""
    return render_blobs(*synth_draws(generator, n))


# ---------------------------------------------------------------- training


def train_step(model, opt, abar: torch.Tensor, x0: torch.Tensor,
               t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """One Adam step on the noise-prediction MSE at timesteps t (int64)
    with noise eps; returns the loss (a device scalar)."""
    a = abar[t][:, None, None, None]
    xt = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    pred = model(xt, t.float(), QuantCtx(differentiable=True))
    loss = torch.mean((pred - eps) ** 2)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train(model, *, steps: int, batch: int = 128, lr: float = 2e-3,
          chunk: int = 250, seed: int = 0, log=print):
    """DDPM training of `model` in place: each step draws a fresh batch,
    uniform timesteps and noise from one generator (seed + 1000) on the
    model's device. Logs and returns the mean loss of every `chunk`
    steps (the last chunk may be shorter)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    abar = torch.from_numpy(ABAR).to(dev)
    model.requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    t0, total, means = time.perf_counter(), torch.zeros((), device=dev), []
    for i in range(steps):
        x0 = synth_batch(gen, batch)
        t = torch.randint(0, T, (batch,), generator=gen, device=dev)
        eps = torch.randn(x0.shape, generator=gen, device=dev)
        total += train_step(model, opt, abar, x0, t, eps)
        if (i + 1) % chunk == 0 or i + 1 == steps:
            means.append(float(total) / ((i % chunk) + 1))
            log(f"  train step {i + 1}/{steps}: loss {means[-1]:.4f} "
                f"({time.perf_counter() - t0:.0f}s)")
            total = torch.zeros((), device=dev)
    model.requires_grad_(False)
    return means


# ---------------------------------------------------------------- sampling


def make_gen(model, seq, n: int, quantized: bool, trajectory: bool = False,
             act: bool = False):
    """gen(qstate, noise, generator) -> (x, trajectory or None): DDIM over
    `seq` at eta 0, the model FP or under QuantCtx(qstate, w=True, a=act)
    (the sim engine)."""
    def gen(qstate, noise, generator=None):
        def model_fn(x, t):
            ctx = (QuantCtx(qstate, mode=QuantMode(w=True, a=act))
                   if quantized else QuantCtx())
            return model(x, t, ctx)

        with torch.no_grad():
            out = ddim_sample(model_fn, noise, seq, BETAS,
                              generator=generator,
                              return_trajectory=trajectory)
        return out if trajectory else (out, None)

    return gen


# ---------------------------------------------------------------- features


def feature_params(generator: torch.Generator, widths=(32, 64, 128)):
    """Fixed random 3x3 stride-2 CNN, OIHW weights N(0, 1/(9 cin)): the
    fixture feature space."""
    ps, cin = [], 3
    for w in widths:
        ps.append(torch.randn((w, cin, 3, 3), generator=generator,
                              device=generator.device) / np.sqrt(9 * cin))
        cin = w
    return ps


def _same_pads(n: int, k: int = 3, s: int = 2):
    """(low, high) padding of XLA's SAME at size n: (0, 1) on even sizes
    at stride 2, not F.conv2d's (1, 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


@torch.no_grad()
def extract_features(fps, imgs: torch.Tensor) -> np.ndarray:
    """imgs: (N, H, W, 3) in [-1, 1] -> (N, widths[-1]) pooled features
    (f32 numpy)."""
    h = imgs.permute(0, 3, 1, 2)
    for w in fps:
        (ht, hb), (wl, wr) = _same_pads(h.shape[2]), _same_pads(h.shape[3])
        h = F.conv2d(F.pad(h, (wl, wr, ht, hb)), w, stride=2)
        h = F.leaky_relu(h, 0.2)
    return h.mean(dim=(2, 3)).cpu().numpy()


# ---------------------------------------------------------------- protocol


class _DeltasBelowLr(logging.Handler):
    """Collects calib/recon.py's per-unit act-pass records: {unit:
    ["site/slot", ...]} of the deltas below the learning rate."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.units: dict = {}

    def emit(self, record):
        small = getattr(record, "deltas_below_lr", None)
        if small is not None:
            self.units[record.unit] = [f"{s}/{k}" for s, k in small]


@contextlib.contextmanager
def _recording_deltas():
    log = logging.getLogger("qdiffusion_torch.calib.recon")
    handler, level = _DeltasBelowLr(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        yield handler.units
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def _deterministic_cudnn(fn):
    """Run `fn` with cuDNN's deterministic algorithms, then restore the
    setting. Its default backward algorithms add with atomics, so two
    runs of one seed differ in the last bits; 2,500 training steps and
    18,000 AdaRound steps carry that into other roundings, and the
    calibrated arm's FID moved from 1.27 to 2.42 between two such runs
    on an H100. The JAX test is a regression gate because its run is
    deterministic; this keeps the port's run so."""
    @functools.wraps(fn)
    def run(*a, **kw):
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return fn(*a, **kw)
        finally:
            torch.backends.cudnn.deterministic = saved
    return run


@_deterministic_cudnn
def run_protocol(*, train_steps: int, n_samples: int, recon_iters: int,
                 bits: int, sample_steps: int = 100, cali_n: int = 64,
                 cali_st: int = 8, seed: int = 0, log=print,
                 act_quant: bool = False, recon_iters_a: int = None,
                 device="cuda", stats: Optional[dict] = None,
                 part: Optional[Callable[[str], ContextManager]] = None
                 ) -> dict:
    """The whole protocol; returns the JAX script's result dict. `stats`,
    if given, receives "seconds" per part (train, sample_fp, naive_w4,
    calib_w4, sample_naive, sample_calib, naive_a8, calib_a8,
    sample_naive_a8, sample_calib_a8, fid), "deltas_below_lr" ({act-pass
    unit: ["site/slot", ...]}), "train_loss" (the mean of every 250
    steps) and, on the card, "peak_device_gb". `part(name)`, if given, is
    entered around each part (a caller's counters)."""
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    seconds = stats.setdefault("seconds", {})

    @contextlib.contextmanager
    def timed(name):
        with part(name) if part else contextlib.nullcontext():
            _sync(dev)
            t0 = time.perf_counter()
            yield
            _sync(dev)
        seconds[name] = time.perf_counter() - t0

    def generator(k):
        return torch.Generator(device=dev).manual_seed(seed + k)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    policy = QuantPolicy(
        wq=AffineQuantizerSpec(n_bits=bits, channel_wise=True,
                               channel_axis=0, scale_method="max"),
        aq=AffineQuantizerSpec(n_bits=8, scale_method="max",
                               leaf_param=True))
    model = DDIMUNet(CFG, policy, device=dev)
    model.load_state_dict(model.init_params(seed))

    log(f"training tiny DDPM ({train_steps} steps, device={dev})")
    with timed("train"):
        stats["train_loss"] = train(model, steps=train_steps, seed=seed,
                                    log=log)

    seq = make_skip_sequence(T, sample_steps)
    noise = torch.randn((n_samples, RES, RES, 3), generator=generator(1),
                        device=dev)
    gen_rng = generator(2)

    log("sampling FP (+ calibration trajectory)")
    with timed("sample_fp"):
        x_fp, traj = make_gen(model, seq, n_samples, quantized=False,
                              trajectory=True)(None, noise, gen_rng)
    cali_xs, cali_ts = get_train_samples(traj, cali_n, cali_st)
    del traj

    log("quantizing: naive nearest rounding")
    with timed("naive_w4"):
        qstate_naive = init_weight_qstate(model)

    log(f"quantizing: AdaRound + block reconstruction "
        f"({recon_iters} iters/unit)")
    ccfg = CalibConfig(weight=ReconConfig(iters=recon_iters, p=2.0),
                       quant_act=False, capture_batch=32)
    cal_rng = generator(3)
    with timed("calib_w4"):
        qstate_calib = calibrate(model, (cali_xs, cali_ts), ccfg,
                                 generator=cal_rng)
    log(f"  calibration done in {seconds['calib_w4']:.0f}s")

    gen_q = make_gen(model, seq, n_samples, quantized=True)
    log("sampling naive-W%d" % bits)
    with timed("sample_naive"):
        x_naive, _ = gen_q(qstate_naive, noise, gen_rng)
    log("sampling calibrated-W%d" % bits)
    with timed("sample_calib"):
        x_calib, _ = gen_q(qstate_calib, noise, gen_rng)

    score_sets = [("fp", x_fp), ("naive", x_naive), ("calib", x_calib)]

    if act_quant:
        # W{bits}A8: naive = nearest weights + first-batch act scale init
        # (the reference's uncalibrated init); calib = the act pass with
        # running stats on the calibrated weights
        n_init = min(64, cali_xs.shape[0])
        log("quantizing acts: naive first-batch init (W%dA8)" % bits)
        with timed("naive_a8"):
            q_naive_a = init_act_qstate(model, qstate_naive,
                                        cali_xs[:n_init], cali_ts[:n_init])
        iters_a = recon_iters_a or max(recon_iters // 4, 1)
        log(f"quantizing acts: full W{bits}A8 calibration "
            f"({recon_iters} w-iters + {iters_a} a-iters/unit + "
            "running stats)")
        ccfg_a = CalibConfig(weight=ReconConfig(iters=recon_iters, p=2.0),
                             act=ReconConfig(iters=iters_a, p=2.0),
                             quant_act=True, running_stat=True,
                             capture_batch=32)
        # the weight pass is the W4 arm's: its qstate, and the generator
        # where that pass left it
        with timed("calib_a8"), _recording_deltas() as below:
            q_calib_a = calibrate(model, (cali_xs, cali_ts), ccfg_a,
                                  generator=cal_rng, qstate=qstate_calib,
                                  skip_weight_pass=True)
        stats["deltas_below_lr"] = below
        log(f"  W{bits}A8 calibration done in {seconds['calib_a8']:.0f}s; "
            f"act deltas below the lr: "
            f"{ {u: s for u, s in below.items() if s} }")
        gen_qa = make_gen(model, seq, n_samples, quantized=True, act=True)
        log("sampling naive-W%dA8" % bits)
        with timed("sample_naive_a8"):
            x_naive_a, _ = gen_qa(q_naive_a, noise, gen_rng)
        log("sampling calibrated-W%dA8" % bits)
        with timed("sample_calib_a8"):
            x_calib_a, _ = gen_qa(q_calib_a, noise, gen_rng)
        score_sets += [("naive_a8", x_naive_a), ("calib_a8", x_calib_a)]

    log("scoring FID over fixture features")
    fids = {}
    with timed("fid"):
        fps = feature_params(generator(4))
        real = synth_batch(generator(5), max(n_samples, 2048))
        f_real = extract_features(fps, real)
        for tag, x in score_sets:
            f = extract_features(fps, torch.clamp(x, -1.0, 1.0))
            fids[tag] = float(fid_from_features(f, f_real))
            log(f"  fid_{tag} = {fids[tag]:.4f}")
    if dev.type == "cuda":
        stats["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    gap = fids["naive"] - fids["fp"]
    recovered = (fids["naive"] - fids["calib"]) / gap if gap > 0 else 0.0
    out = {
        "metric": "quality_evidence_fid",
        "bits": bits,
        "train_steps": train_steps,
        "n_samples": n_samples,
        "recon_iters": recon_iters,
        "fid_fp": round(fids["fp"], 4),
        "fid_naive": round(fids["naive"], 4),
        "fid_calib": round(fids["calib"], 4),
        "recovered_frac": round(recovered, 4),
    }
    if act_quant:
        gap_a = fids["naive_a8"] - fids["fp"]
        rec_a = ((fids["naive_a8"] - fids["calib_a8"]) / gap_a
                 if gap_a > 0 else 0.0)
        out.update({
            "recon_iters_a": iters_a,
            "fid_naive_a8": round(fids["naive_a8"], 4),
            "fid_calib_a8": round(fids["calib_a8"], 4),
            "recovered_frac_a8": round(rec_a, 4),
        })
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="reduced settings (CI-scale)")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--recon-iters", type=int, default=None)
    ap.add_argument("--sample-steps", type=int, default=100)
    ap.add_argument("--cali-n", type=int, default=64)
    ap.add_argument("--cali-st", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--act", action="store_true",
                    help="add the W{bits}A8 arm (naive first-batch act "
                         "init vs full act-recon + running-stat "
                         "calibration)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    steps = args.train_steps or (1500 if args.fast else 6000)
    n = args.samples or (256 if args.fast else 1024)
    iters = args.recon_iters or (500 if args.fast else 3000)
    out = run_protocol(train_steps=steps, n_samples=n, recon_iters=iters,
                       bits=args.bits, sample_steps=args.sample_steps,
                       cali_n=args.cali_n, cali_st=args.cali_st,
                       seed=args.seed, act_quant=args.act,
                       device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
