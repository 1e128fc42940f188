"""Command-line entry point of the port: the `sample`, `make-cali-data`
and `calibrate` subcommands of qdiffusion_tpu/cli.py for the pixel, ldm
and sd families (calibrate: the weight pass, then the activation pass
with --quant-act):

  python -m qdiffusion_torch.cli make-cali-data --task cifar10 \\
      --n 256 --out cali/traj.npz
  python -m qdiffusion_torch.cli calibrate --task cifar10 \\
      --cali-data cali/traj.npz --weight-bit 4 --split --quant-act \\
      --running-stat --run-dir logs/w4a8
  python -m qdiffusion_torch.cli sample --task cifar10 \\
      --qstate logs/w4a8/qstate.npz --weight-bit 4 --quant-act --split \\
      --engine int8

  python -m qdiffusion_torch.cli sample --task cifar10 \\
      --qstate qstate.npz --weight-bit 4 --engine fold --dtype bfloat16 \\
      --n 128 --batch 64 --npz-out samples/

  python -m qdiffusion_torch.cli sample --task sd_v1 --ckpt unet.npz \\
      --vae-ckpt vae.npz --clip-ckpt clip.npz --token-ids ids.npz \\
      --qstate w4.npz --weight-bit 4 --engine fold --dtype bfloat16 \\
      --n 8 --batch 4 --npz-out samples/

  python -m qdiffusion_torch.cli sample --task lsun_beds256 \\
      --ckpt unet.npz --vae-ckpt vq_f4.npz --qstate w4.npz \\
      --weight-bit 4 --engine fold --dtype bfloat16 --n 16 --batch 8 \\
      --npz-out samples/
  python -m qdiffusion_torch.cli make-cali-data --task lsun_beds256 \\
      --ckpt unet.npz --n 4 --out cali/beds_traj.npz
  python -m qdiffusion_torch.cli calibrate --task lsun_beds256 \\
      --ckpt unet.npz --cali-data cali/beds_traj.npz --weight-bit 4 \\
      --split --quant-act --a-min-max --running-stat --run-dir logs/beds
  python -m qdiffusion_torch.cli sample --task lsun_churches256 \\
      --ckpt unet.npz --vae-ckpt kl_f8.npz --qstate w4a8.npz \\
      --weight-bit 4 --quant-act --split --engine int8 --n 8 --batch 4

  python -m qdiffusion_torch.cli make-cali-data --task sd_v1 \\
      --ckpt unet.npz --clip-ckpt clip.npz --token-ids ids.npz --n 4 \\
      --out cali/sd_traj.npz
  python -m qdiffusion_torch.cli calibrate --task sd_v1 --ckpt unet.npz \\
      --cali-data cali/sd_traj.npz --weight-bit 4 --split --quant-act \\
      --sm-abit 16 --running-stat --alpha-dtype bfloat16 \\
      --act-init-batch 4 --cali-batch-size 4 --run-dir logs/sd_w4a8

Engines (--engine, with --qstate; cli.py:334-379 of the JAX package):
sim (fake-quant), fold (weight-only, folded weights), int8 (with
--quant-act: integer kernels, bf16 carriers; without it, the weight-only
sim), stream (weight-only with integer weights resident on the card;
--stream-convs also streams the convs the byte cost model picks). int8
and stream ignore --dtype, as in the JAX package (cli.py:405-406).

`sample --sampler` picks the sampler (default: the preset's): for the
pixel tasks generalized (DDIM), ddpm_noisy (ancestral DDPM, its step
noise from a generator seeded with --seed) or dpm_solver (DPM-Solver++,
singlestep order 3 on the time-uniform grid, --timesteps model calls);
for the latent tasks ddim, plms or dpm_solver (DPM-Solver++, multistep
order 2, --timesteps UNet calls, CFG at --scale: txt2img's --dpm_solver):

  python -m qdiffusion_torch.cli sample --task cifar10 \\
      --qstate qstate.npz --weight-bit 4 --engine fold --dtype bfloat16 \\
      --sampler dpm_solver --timesteps 20
  python -m qdiffusion_torch.cli sample --task sd_v1 --ckpt unet.npz \\
      --vae-ckpt vae.npz --clip-ckpt clip.npz --token-ids ids.npz \\
      --qstate w4.npz --weight-bit 4 --engine stream --stream-convs \\
      --sampler dpm_solver --timesteps 20 --n 1 --batch 1

The LSUN presets run their DDIM: lsun_beds256 200 steps at eta 1 (a
VQ-f4 decode), lsun_churches256 "400" steps at eta 0, which the
reference's stride 1000 // 400 makes 500 UNet calls (a KL-f8 decode);
the step noise of eta > 0 comes from a generator seeded with --seed.

Runs on the card unless --device cpu. With no --ckpt the UNet is
initialised from seed 0, as the JAX CLI does (cli.py:349-350). Checkpoints
are the JAX package's npz files: the UNet a `save_pytree` npz, the VAE and
the CLIP text tower `save_nested` npz (torch .ckpt files are not read).
SD conditioning comes from --token-ids (an npz with 'cond' (P, 77) and
'uncond' (1, 77) CLIP ids, cli.py:159-163); --prompt and the tokenizer
are not ported. The output is the bulk uint8 npz of the JAX CLI
(N x H x W x C); PNG output is not ported.

make-cali-data writes the FP sampling trajectory (JAX keys "xs" [S, B,
H, W, C] and "ts" [S, B]; for sd also "cs" and "ucs" [S, B, 77, D], the
cond and uncond contexts at every step), so either package's calibrate
reads the other's file; its initial noise is drawn per item as `sample`
draws it. The latent tasks run their preset sampler (DDIM or PLMS, CFG
at --scale) without the decode; an sd task needs --token-ids (the port
has no tokenizer). calibrate (calib/engine.py) runs the AdaRound weight
pass, then with --quant-act the activation pass (sd: on the cond and
uncond contexts back to back); --resume-w QSTATE runs only the
activation pass on a weight pass's qstate. It snapshots into the run
directory (utils/checkpoints.py::CalibCheckpointer) and writes <run
dir>/qstate.npz in the JAX layout, which `sample --qstate` and the JAX
package both read; `--run-dir` of a run that stopped resumes it after
the last snapshot, whichever package wrote it. With --quant-act,
calibrate and sample build the LDM UNet with act_quant_partition, as the
JAX CLI does (cli.py:88, :334), so an AttentionBlock's attention
quantizers sit at the sites the JAX package calibrates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from qdiffusion_torch.convert import from_jax_params, jax_param_shapes
from qdiffusion_torch.device import resolve_device


def resolve_task(args):
    from qdiffusion_torch.config import PRESETS

    try:
        return PRESETS[args.task]
    except KeyError:
        raise SystemExit(f"unknown task {args.task!r} "
                         f"(presets: {sorted(PRESETS)})")


def _schedule(task):
    from qdiffusion_torch.schedules import NoiseSchedule

    s = task.schedule
    if s.kind == "ddpm":
        return NoiseSchedule.ddpm(s.beta_schedule, s.beta_start, s.beta_end,
                                  s.num_timesteps)
    return NoiseSchedule.ldm(s.beta_schedule, s.num_timesteps, s.beta_start,
                             s.beta_end)


def build_model_and_pipeline(task, qflags=None, device="cuda",
                             act_quant=False):
    from qdiffusion_torch.pipelines import (
        LatentDiffusionPipeline,
        PixelDiffusionPipeline,
    )

    sched = _schedule(task)
    split = qflags is not None and qflags.split
    if task.family == "pixel":
        from qdiffusion_torch.models.unet_ddim import DDIMUNet

        cfg = dataclasses.replace(task.unet_ddim, split_shortcut=True) \
            if split else task.unet_ddim
        policy = qflags.policy_ddim() if qflags else None
        model = DDIMUNet(cfg, policy, device=device)
        return model, PixelDiffusionPipeline(model, sched)

    from qdiffusion_torch.models.clip_text import (
        CLIPTextConfig,
        CLIPTextEncoder,
    )
    from qdiffusion_torch.models.unet_ldm import LDMUNet
    from qdiffusion_torch.models.vae import VAE

    cfg = dataclasses.replace(task.unet_ldm, split_shortcut=True) \
        if split else task.unet_ldm
    policy = qflags.policy_ldm() if qflags else None
    model = LDMUNet(cfg, policy, act_quant_partition=act_quant,
                    device=device)
    text = CLIPTextEncoder(task.clip or CLIPTextConfig(), device=device) \
        if task.family == "sd" else None
    pipe = LatentDiffusionPipeline(
        unet=model, vae=VAE(task.vae, device=device), schedule=sched,
        scale_factor=task.scale_factor,
        conditioning_key=task.conditioning_key, text_encoder=text)
    return model, pipe


def load_fp_params(path, model) -> dict:
    """FP params from a JAX `save_pytree` npz, as a state_dict."""
    from qdiffusion_torch.utils.checkpoints import load_pytree

    path = Path(path)
    if path.suffix != ".npz":
        raise SystemExit(f"--ckpt {path}: only the JAX package's params npz "
                         "is read by the port")
    return from_jax_params(load_pytree(path,
                                       jax_param_shapes(model.state_dict())))


def load_nested_params(path, flag: str) -> dict:
    """A JAX `save_nested` npz (the VAE, the CLIP tower), as a
    state_dict."""
    from qdiffusion_torch.utils.checkpoints import load_nested

    path = Path(path)
    if path.suffix != ".npz":
        raise SystemExit(f"{flag} {path}: only the JAX package's nested npz "
                         "is read by the port")
    return from_jax_params(load_nested(path))


def build_conditioning(args, task, pipe, device):
    """(cond (P, 77, D), uncond (1, 77, D)) from --token-ids through the
    CLIP tower in f32 (the JAX CLI leaves the context in f32 under
    --dtype bfloat16, cli.py:410); (None, None) without them."""
    if task.family != "sd" or not args.token_ids:
        if task.family == "sd":
            print("sd task without --token-ids: sampling unconditionally "
                  "(no CFG)")
        return None, None
    if not args.clip_ckpt:
        raise SystemExit("--token-ids needs the CLIP text weights: "
                         "--clip-ckpt clip.npz")
    pipe.text_encoder.load_state_dict(
        load_nested_params(args.clip_ckpt, "--clip-ckpt"))
    with np.load(args.token_ids) as data:
        ids = [torch.from_numpy(np.asarray(data[k], np.int64)).to(device)
               for k in ("cond", "uncond")]
    return tuple(pipe.get_learned_conditioning(i) for i in ids)


def tile_conditioning(cond, uncond, n):
    """(P, L, D) prompt rows to a batch of n, the uncond row to n
    (cli.py:187-199, serving.py:315-319)."""
    if cond is None:
        return None, None
    if n % cond.shape[0]:
        raise SystemExit(f"batch {n} not divisible by {cond.shape[0]} "
                         "prompts")
    return (cond.repeat(n // cond.shape[0], 1, 1),
            uncond[:1].expand(n, -1, -1))


def _item_noise(seeds, shape) -> torch.Tensor:
    """Initial noise drawn per item from its own seed, so an image does
    not depend on the batch it lands in (as the JAX CLI's per-item
    seeds, cli.py:485-487)."""
    return torch.stack([
        torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
        for s in seeds])


def _step_noise(seed: int, device) -> torch.Generator:
    """The generator of the samplers' step noise (eta > 0, e.g. the
    LSUN-beds DDIM at eta 1), seeded from --seed as the JAX CLI seeds its
    sampling key (cli.py:212, :427)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def cmd_make_cali_data(args) -> dict:
    device = resolve_device(args.device)
    task = resolve_task(args)
    if task.family == "sd" and not args.token_ids:
        raise SystemExit("make-cali-data for an sd task needs --token-ids "
                         "(and --clip-ckpt): calibrate reads the cond and "
                         "uncond contexts of every step, and the port has "
                         "no tokenizer for --prompt")
    model, pipe = build_model_and_pipeline(task, device=device)
    model.load_state_dict(load_fp_params(args.ckpt, model) if args.ckpt
                          else model.init_params(0))
    seeds = np.arange(args.n, dtype=np.int64) \
        + np.int64(args.seed) * 1000003
    steps = args.timesteps or task.sampler.timesteps
    t0 = time.perf_counter()
    if task.family == "pixel":
        x0 = _item_noise(seeds, (task.image_size, task.image_size,
                                 task.channels)).to(device)
        _, traj = pipe.sample(args.n, timesteps=steps,
                              skip_type=task.sampler.skip_type,
                              eta=task.sampler.eta, x_init=x0,
                              return_trajectory=True)
    else:
        # the preset's sampler without the decode, CFG at --scale
        # (JAX cli.py:219-232)
        cond, uncond = tile_conditioning(
            *build_conditioning(args, task, pipe, device), args.n)
        x0 = _item_noise(seeds, (task.latent_size, task.latent_size,
                                 task.latent_channels)).to(device)
        sampler = task.sampler.sample_type \
            if task.sampler.sample_type in ("ddim", "plms") else "ddim"
        _, traj = pipe.sample(
            args.n, sampler=sampler, steps=steps, eta=task.sampler.eta,
            generator=_step_noise(args.seed, device), cond=cond,
            uncond=uncond,
            guidance_scale=args.scale if args.scale is not None
            else task.sampler.guidance_scale,
            decode=False, x_init=x0, return_trajectory=True)
    _sync(device)
    seconds = time.perf_counter() - t0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **{k: v.cpu().numpy() for k, v in traj.items()})
    shapes = {k: tuple(v.shape) for k, v in traj.items()}
    print(f"saved trajectory {shapes} -> {out} ({seconds:.3f} s on "
          f"{device})")
    return {"path": str(out), "shapes": shapes, "seconds": seconds}


def cmd_calibrate(args) -> dict:
    from qdiffusion_torch.calib.engine import calibrate
    from qdiffusion_torch.calib.samples import get_train_samples
    from qdiffusion_torch.utils.checkpoints import CalibCheckpointer, \
        load_qstate

    task = resolve_task(args)
    device = resolve_device(args.device)
    cond = task.family == "sd"
    qflags = _quant_flags(
        args, cali_st=args.cali_st, cali_n=args.cali_n,
        cali_batch_size=args.cali_batch_size, cali_iters=args.cali_iters,
        cali_iters_a=args.cali_iters_a, cali_lr=args.cali_lr,
        cali_p=args.cali_p, alpha_dtype=args.alpha_dtype,
        capture_group_bytes=int(args.capture_group_mb) << 20,
        act_init_batch=args.act_init_batch)
    run_dir = Path(args.run_dir) if args.run_dir else Path(args.logdir) \
        / f"calib-{task.name}-{datetime.now():%Y-%m-%d-%H-%M-%S}"
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "calib_config.json").write_text(json.dumps(
        {"task": task.name, "quant": dataclasses.asdict(qflags),
         "args": vars(args)}, default=str, indent=2))
    log = logging.FileHandler(run_dir / "run.log")
    log.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    root = logging.getLogger()
    root.addHandler(log)
    level = root.level
    root.setLevel(logging.INFO)
    try:
        with np.load(args.cali_data) as data:
            keys = ("xs", "ts") + (("cs", "ucs") if cond else ())
            missing = [k for k in keys if k not in data.files]
            if missing:
                raise SystemExit(
                    f"{args.cali_data} has no {missing}: an sd trajectory "
                    "comes from make-cali-data --token-ids")
            traj = {k: torch.from_numpy(data[k]).to(device) for k in keys}
        model, _ = build_model_and_pipeline(task, qflags, device,
                                            act_quant=args.quant_act)
        model.load_state_dict(load_fp_params(args.ckpt, model) if args.ckpt
                              else model.init_params(0))
        cali = get_train_samples(traj, qflags.cali_n, qflags.cali_st,
                                 cond=cond)
        del traj
        logging.getLogger(__name__).info(
            "calibration data: %s", [tuple(c.shape) for c in cali])
        qstate0 = None
        if args.resume_w:
            # reference --resume_w: a weight pass's qstate, then only the
            # activation pass
            qstate0 = load_qstate(args.resume_w, device)
            logging.getLogger(__name__).info(
                "resuming from weight qstate %s", args.resume_w)
        t0 = time.perf_counter()
        calibrate(model, cali, qflags.calib_config(),
                  torch.Generator(device=device).manual_seed(args.seed),
                  qstate=qstate0, checkpointer=CalibCheckpointer(run_dir),
                  skip_weight_pass=qstate0 is not None)
        _sync(device)
        seconds = time.perf_counter() - t0
        path = run_dir / "qstate.npz"
    finally:
        root.removeHandler(log)
        root.setLevel(level)
        log.close()
    print(f"calibrated quantizer state -> {path} ({seconds:.3f} s on "
          f"{device})")
    return {"path": str(path), "run_dir": str(run_dir), "seconds": seconds,
            "samples": int(cali[0].shape[0])}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quant_flags(args, **calib):
    """QuantFlags from the quantization flags that `sample` and
    `calibrate` share (JAX cli.py:682-695), plus calibrate's own."""
    from qdiffusion_torch.config import QuantFlags

    return QuantFlags(
        weight_bit=args.weight_bit, quant_act=args.quant_act,
        act_bit=args.act_bit, a_sym=args.a_sym, sm_abit=args.sm_abit,
        split=args.split, running_stat=args.running_stat,
        rs_sm_only=args.rs_sm_only, a_min_max=args.a_min_max, **calib)


def cmd_sample(args) -> dict:
    from qdiffusion_torch.deploy import fold_weights, make_quantized_step
    from qdiffusion_torch.quant.context import QuantMode
    from qdiffusion_torch.samplers.ddim import inverse_data_transform
    from qdiffusion_torch.utils.checkpoints import load_qstate

    device = resolve_device(args.device)
    print(f"device {device}: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (float32 in full "
          "precision)")
    task = resolve_task(args)
    pixel = task.family == "pixel"
    qflags = _quant_flags(args) if args.qstate else None
    model, pipe = build_model_and_pipeline(task, qflags, device,
                                           act_quant=args.quant_act)
    model.load_state_dict(load_fp_params(args.ckpt, model) if args.ckpt
                          else model.init_params(0))
    if not pixel:
        if not args.vae_ckpt:
            raise SystemExit("--vae-ckpt required for latent-space tasks")
        pipe.vae.load_state_dict(load_nested_params(args.vae_ckpt,
                                                    "--vae-ckpt"))

    qstate, mode, model_fn = None, None, None
    if args.qstate:
        qstate = load_qstate(args.qstate, device)
        if args.engine == "fold":
            if args.quant_act:
                raise SystemExit("--engine fold is weight-only: drop "
                                 "--quant-act or use --engine sim")
            model.load_state_dict(fold_weights(model, qstate))
            qstate = None
        elif (args.engine == "int8" and args.quant_act) \
                or args.engine == "stream":
            model_fn = make_quantized_step(model, qstate, engine=args.engine,
                                           stream_convs=args.stream_convs)
            qstate = None
        else:
            mode = QuantMode(w=True, a=args.quant_act)
    cond, uncond = (None, None) if pixel else build_conditioning(
        args, task, pipe, device)
    # --dtype bfloat16: bf16 params and carrier for the UNet and the VAE;
    # the sampler math and the CLIP context stay f32. The int8 and stream
    # engines keep their own carriers.
    eval_dtype = torch.bfloat16 \
        if args.dtype == "bfloat16" and model_fn is None else None
    if eval_dtype is not None:
        model.to(eval_dtype)
        if not pixel:
            pipe.vae.to(eval_dtype)

    steps = args.timesteps or task.sampler.timesteps
    scale = args.scale if args.scale is not None \
        else task.sampler.guidance_scale
    sampler = args.sampler or task.sampler.sample_type
    calls = [0]
    base_fn = model_fn or pipe.model_fn(qstate, mode)

    def model_fn(x, t, *context):
        calls[0] += 1
        return base_fn(x, t, *context)

    images, batch_seconds, decode_seconds, model_calls = [], [], [], []
    nonfinite, idx = 0, 0
    gen = _step_noise(args.seed, device)
    while idx < args.n:
        n = min(args.batch, args.n - idx)
        seeds = np.arange(idx, idx + n, dtype=np.int64) \
            + np.int64(args.seed) * 1000003
        calls[0] = 0
        t0 = time.perf_counter()
        if pixel:
            x0 = _item_noise(seeds, (task.image_size, task.image_size,
                                     task.channels)).to(device)
            x = pipe.sample(n, timesteps=steps,
                            skip_type=task.sampler.skip_type,
                            eta=task.sampler.eta, sample_type=sampler,
                            generator=gen, x_init=x0, eval_dtype=eval_dtype,
                            model_fn=model_fn)
            _sync(device)
            batch_seconds.append(time.perf_counter() - t0)
            model_calls.append(calls[0])
            nonfinite += int((~torch.isfinite(x)).sum())
            imgs = inverse_data_transform(x.float())
        else:
            x0 = _item_noise(seeds, (task.latent_size, task.latent_size,
                                     task.latent_channels)).to(device)
            cond_n, uncond_n = tile_conditioning(cond, uncond, n)
            z = pipe.sample(n, sampler=sampler, steps=steps,
                            eta=task.sampler.eta, generator=gen,
                            cond=cond_n, uncond=uncond_n, guidance_scale=scale,
                            model_fn=model_fn, decode=False, x_init=x0,
                            eval_dtype=eval_dtype)
            _sync(device)
            t1 = time.perf_counter()
            imgs = pipe.decode(z, eval_dtype)
            _sync(device)
            decode_seconds.append(time.perf_counter() - t1)
            batch_seconds.append(time.perf_counter() - t0)
            model_calls.append(calls[0])
            nonfinite += int((~torch.isfinite(imgs)).sum()) \
                + int((~torch.isfinite(z)).sum())
        images.append((imgs.cpu().numpy() * 255.0).astype(np.uint8))
        idx += n

    all_img = np.concatenate(images, axis=0)
    out = Path(args.npz_out)
    if out.suffix != ".npz":
        out = out / ("x".join(str(s) for s in all_img.shape) + "-samples.npz")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, all_img)
    total = sum(batch_seconds)
    print(f"sampled {all_img.shape[0]} images ({steps} steps, "
          f"{len(batch_seconds)} batches) in {total:.3f} s on {device}; "
          f"wrote {all_img.shape} -> {out}")
    res = {"path": str(out), "n": int(all_img.shape[0]), "steps": steps,
           "batch_seconds": batch_seconds, "nonfinite": nonfinite,
           "engine": args.engine if args.qstate else None,
           "sampler": sampler, "model_calls": model_calls}
    if not pixel:
        res.update(decode_seconds=decode_seconds, guidance_scale=scale)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m qdiffusion_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_quant_flags(sp):
        sp.add_argument("--weight-bit", type=int, default=8)
        sp.add_argument("--quant-act", action="store_true",
                        help="activation quantizers (calibrate: run the "
                             "activation pass)")
        sp.add_argument("--act-bit", type=int, default=8)
        sp.add_argument("--a-sym", action="store_true")
        sp.add_argument("--sm-abit", type=int, default=8)
        sp.add_argument("--split", action="store_true")
        sp.add_argument("--running-stat", action="store_true")
        sp.add_argument("--rs-sm-only", action="store_true",
                        help="running stats only for post-softmax "
                             "quantizers")
        sp.add_argument("--a-min-max", action="store_true",
                        help="act scale init 'max' instead of 'mse' (LDM)")
    sp = sub.add_parser("sample", help="generate images")
    sp.add_argument("--task", required=True)
    sp.add_argument("--ckpt", help="FP UNet params npz (JAX save_pytree "
                                   "format)")
    sp.add_argument("--vae-ckpt", help="VAE params npz (JAX save_nested "
                                       "format; latent tasks)")
    sp.add_argument("--clip-ckpt", help="CLIP text-tower params npz (JAX "
                                        "save_nested format; sd tasks)")
    sp.add_argument("--token-ids",
                    help="npz with 'cond' (P, 77) and 'uncond' (1, 77) CLIP "
                         "token ids (sd tasks)")
    sp.add_argument("--scale", type=float,
                    help="CFG guidance scale (default: task preset)")
    sp.add_argument("--sampler",
                    help="sampler (default: task preset): pixel tasks "
                         "generalized (DDIM), ddpm_noisy (ancestral DDPM) "
                         "or dpm_solver (DPM-Solver++ singlestep order 3, "
                         "--timesteps model calls); latent tasks ddim, "
                         "plms or dpm_solver (DPM-Solver++ multistep order "
                         "2, --timesteps UNet calls, CFG at --scale)")
    sp.add_argument("--qstate", help="calibrated qstate npz (JAX format)")
    add_quant_flags(sp)
    sp.add_argument("--engine", default="sim",
                    choices=["sim", "fold", "int8", "stream"])
    sp.add_argument("--stream-convs", action="store_true",
                    help="stream engine: also keep conv weights integer on "
                         "the card, streamed where a per-site byte cost "
                         "model says so (batch-1 serving)")
    sp.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="model dtype for the sim and fold engines; the "
                         "sampler math stays float32")
    sp.add_argument("--n", type=int, default=64)
    sp.add_argument("--batch", type=int, default=64)
    sp.add_argument("--timesteps", type=int)
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--npz-out", default="samples",
                    help="samples npz: a .npz path, or a directory that "
                         "gets NxHxWxC-samples.npz")
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                         "host)")
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("make-cali-data",
                        help="FP sampling trajectory for calibration")
    sp.add_argument("--task", required=True)
    sp.add_argument("--ckpt", help="FP UNet params npz (JAX save_pytree "
                                   "format)")
    sp.add_argument("--clip-ckpt", help="CLIP text-tower params npz (sd "
                                        "tasks)")
    sp.add_argument("--token-ids",
                    help="npz with 'cond' (P, 77) and 'uncond' (1, 77) CLIP "
                         "token ids (sd tasks; --n divisible by P)")
    sp.add_argument("--scale", type=float,
                    help="CFG guidance scale (default: task preset)")
    sp.add_argument("--n", type=int, default=256)
    sp.add_argument("--timesteps", type=int)
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--out", required=True)
    sp.add_argument("--device", default="cuda")
    sp.set_defaults(fn=cmd_make_cali_data)

    sp = sub.add_parser("calibrate",
                        help="PTQ calibration -> <run dir>/qstate.npz")
    sp.add_argument("--task", required=True)
    sp.add_argument("--ckpt", help="FP UNet params npz (JAX save_pytree "
                                   "format)")
    sp.add_argument("--cali-data", required=True)
    sp.add_argument("--resume-w", help="a weight pass's qstate npz: run "
                                       "only the activation pass on it")
    add_quant_flags(sp)
    sp.add_argument("--cali-st", type=int, default=20)
    sp.add_argument("--cali-n", type=int, default=256)
    sp.add_argument("--cali-batch-size", type=int, default=32)
    sp.add_argument("--cali-iters", type=int, default=20000,
                    help="weight-pass iterations per unit")
    sp.add_argument("--cali-iters-a", type=int, default=5000,
                    help="act-pass iterations per unit")
    sp.add_argument("--cali-lr", type=float, default=4e-4,
                    help="act-delta learning rate (cosine-annealed)")
    sp.add_argument("--cali-p", type=float, default=2.4,
                    help="act-pass Lp norm")
    sp.add_argument("--act-init-batch", type=int, default=64,
                    help="act scale-init rows and running-stat batch")
    sp.add_argument("--capture-group-mb", type=int, default=3072,
                    help="grouped-capture residency cap in MB")
    sp.add_argument("--alpha-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="AdaRound alpha storage dtype; the optimisation "
                         "runs in float32 either way")
    sp.add_argument("--logdir", default="logs")
    sp.add_argument("--run-dir", default=None,
                    help="write into this run directory instead of a new "
                         "timestamped one under --logdir; a run that "
                         "stopped there resumes after its last snapshot")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda")
    sp.set_defaults(fn=cmd_calibrate)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
