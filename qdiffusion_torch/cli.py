"""Command-line entry point of the port (the `sample` subcommand of
qdiffusion_tpu/cli.py for the pixel family):

  python -m qdiffusion_torch.cli sample --task cifar10 \
      --qstate qstate.npz --weight-bit 4 --engine fold --dtype bfloat16 \
      --n 128 --batch 64 --npz-out samples/

Runs on the card unless --device cpu. With no --ckpt the parameters are
initialised from seed 0, as the JAX CLI does (cli.py:349-350). The output
is the bulk uint8 npz of the JAX CLI (N x H x W x C); PNG output is not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from qdiffusion_torch.convert import from_jax_params, to_jax_params
from qdiffusion_torch.device import resolve_device


def resolve_task(args):
    from qdiffusion_torch.config import PRESETS

    try:
        return PRESETS[args.task]
    except KeyError:
        raise SystemExit(f"unknown task {args.task!r} "
                         f"(presets: {sorted(PRESETS)})")


def build_model_and_pipeline(task, qflags=None, device="cuda"):
    from qdiffusion_torch.models.unet_ddim import DDIMUNet
    from qdiffusion_torch.pipelines import PixelDiffusionPipeline
    from qdiffusion_torch.schedules import NoiseSchedule

    s = task.schedule
    sched = NoiseSchedule.ddpm(s.beta_schedule, s.beta_start, s.beta_end,
                               s.num_timesteps)
    cfg = task.unet_ddim
    if qflags is not None and qflags.split:
        cfg = dataclasses.replace(cfg, split_shortcut=True)
    policy = qflags.policy_ddim() if qflags else None
    model = DDIMUNet(cfg, policy, device=device)
    return model, PixelDiffusionPipeline(model, sched)


def load_fp_params(path, model) -> dict:
    """FP params from a JAX `save_pytree` npz, as a state_dict."""
    from qdiffusion_torch.utils.checkpoints import load_pytree

    path = Path(path)
    if path.suffix != ".npz":
        raise SystemExit(f"--ckpt {path}: only the JAX package's params npz "
                         "is read by the port")
    like = to_jax_params(model.state_dict())
    return from_jax_params(load_pytree(path, like))


def _item_noise(seeds, shape) -> torch.Tensor:
    """Initial noise drawn per item from its own seed, so an image does
    not depend on the batch it lands in (as the JAX CLI's per-item
    seeds, cli.py:485-487)."""
    return torch.stack([
        torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
        for s in seeds])


def cmd_sample(args) -> dict:
    from qdiffusion_torch.config import QuantFlags
    from qdiffusion_torch.deploy import fold_weights
    from qdiffusion_torch.quant.context import QuantMode
    from qdiffusion_torch.samplers.ddim import inverse_data_transform
    from qdiffusion_torch.utils.checkpoints import load_qstate

    device = resolve_device(args.device)
    print(f"device {device}: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (float32 in full "
          "precision)")
    task = resolve_task(args)
    qflags = QuantFlags(weight_bit=args.weight_bit, quant_act=args.quant_act,
                        act_bit=args.act_bit, split=args.split) \
        if args.qstate else None
    model, pipe = build_model_and_pipeline(task, qflags, device)
    model.load_state_dict(load_fp_params(args.ckpt, model) if args.ckpt
                          else model.init_params(0))

    qstate, mode = None, None
    if args.qstate:
        qstate = load_qstate(args.qstate, device)
        if args.engine == "fold":
            if args.quant_act:
                raise SystemExit("--engine fold is weight-only: drop "
                                 "--quant-act or use --engine sim")
            model.load_state_dict(fold_weights(model, qstate))
            qstate = None
        else:
            mode = QuantMode(w=True, a=args.quant_act)
    # --dtype bfloat16: bf16 params and model carrier; the sampler math
    # stays f32 (samplers/ddim.py)
    eval_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    if eval_dtype is not None:
        model.to(eval_dtype)

    steps = args.timesteps or task.sampler.timesteps
    shape = (task.image_size, task.image_size, task.channels)
    images, batch_seconds, nonfinite = [], [], 0
    idx = 0
    while idx < args.n:
        n = min(args.batch, args.n - idx)
        seeds = np.arange(idx, idx + n, dtype=np.int64) \
            + np.int64(args.seed) * 1000003
        x0 = _item_noise(seeds, shape).to(device)
        t0 = time.perf_counter()
        x = pipe.sample(n, timesteps=steps, skip_type=task.sampler.skip_type,
                        eta=task.sampler.eta,
                        sample_type=task.sampler.sample_type,
                        qstate=qstate, mode=mode, x_init=x0,
                        eval_dtype=eval_dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        batch_seconds.append(time.perf_counter() - t0)
        nonfinite += int((~torch.isfinite(x)).sum())
        imgs = inverse_data_transform(x.float())
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
    return {"path": str(out), "n": int(all_img.shape[0]), "steps": steps,
            "batch_seconds": batch_seconds, "nonfinite": nonfinite}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m qdiffusion_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("sample", help="generate images (pixel family)")
    sp.add_argument("--task", required=True)
    sp.add_argument("--ckpt", help="FP params npz (JAX save_pytree format)")
    sp.add_argument("--qstate", help="calibrated qstate npz (JAX format)")
    sp.add_argument("--weight-bit", type=int, default=8)
    sp.add_argument("--quant-act", action="store_true")
    sp.add_argument("--act-bit", type=int, default=8)
    sp.add_argument("--split", action="store_true")
    sp.add_argument("--engine", default="sim", choices=["sim", "fold"])
    sp.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="model dtype; the sampler math stays float32")
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
