"""Schedules, DDIM sampling, the pixel pipeline and the cifar10 preset,
port vs JAX.

Schedules, skip sequences and the DDIM step tables are numpy in both
packages and must agree exactly. The 3-step DDIM (eta = 0) runs the tiny
UNet of test_torch_unet.py through both pipelines from the same initial
noise, f32, rtol = atol = 1e-4 (the per-step eps agrees to ~2e-6 and the
update is a fixed linear map of it).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdiffusion_tpu import config as jax_config
from qdiffusion_tpu import schedules as jax_sched
from qdiffusion_tpu.pipelines import PixelDiffusionPipeline as JaxPipeline
from qdiffusion_tpu.samplers import ddim as jax_ddim

from qdiffusion_torch import config, schedules
from qdiffusion_torch.pipelines import PixelDiffusionPipeline
from qdiffusion_torch.samplers import ddim

from test_torch_unet import build_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["linear", "quad", "const", "jsd",
                                  "sigmoid"])
def test_beta_schedules_equal(kind):
    kw = dict(beta_start=1e-4, beta_end=2e-2, num_diffusion_timesteps=1000)
    np.testing.assert_array_equal(schedules.get_beta_schedule(kind, **kw),
                                  jax_sched.get_beta_schedule(kind, **kw))


@pytest.mark.parametrize("skip_type", ["uniform", "quad"])
@pytest.mark.parametrize("T,steps", [(1000, 100), (1000, 3), (100, 8),
                                     (1000, 250)])
def test_skip_sequence_and_step_tables_equal(skip_type, T, steps):
    seq = schedules.make_skip_sequence(T, steps, skip_type)
    assert seq == jax_sched.make_skip_sequence(T, steps, skip_type)
    betas = schedules.NoiseSchedule.ddpm("linear", 1e-4, 2e-2, T).betas
    for got, want in zip(ddim._alpha_tables(betas, seq),
                         jax_ddim._alpha_tables(betas, seq)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_ddim_3_steps_matches_jax():
    jm, tm, params = build_pair()
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    sched = schedules.NoiseSchedule.ddpm("linear", 1e-4, 2e-2, 1000)
    jsched = jax_sched.NoiseSchedule.ddpm("linear", 1e-4, 2e-2, 1000)
    kw = dict(timesteps=3, skip_type="quad", eta=0.0, image_size=16)
    want, _ = JaxPipeline(jm, jsched).sample(params, 2, x_init=jnp.asarray(x0),
                                             **kw)
    got = PixelDiffusionPipeline(tm, sched).sample(
        2, x_init=torch.from_numpy(x0), **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ddim_bf16_carrier_keeps_f32_carry():
    """eval_dtype=bf16: the model sees bf16 input, the carry stays f32."""
    seen = []

    def model_fn(x, t):
        seen.append(x.dtype)
        return 0.1 * x

    x = torch.ones((1, 4, 4, 3))
    seq = schedules.make_skip_sequence(1000, 3, "uniform")
    out = ddim.ddim_sample(model_fn, x, seq,
                           schedules.NoiseSchedule.ddpm(
                               "linear", 1e-4, 2e-2, 1000).betas,
                           eval_dtype=torch.bfloat16)
    assert seen == [torch.bfloat16] * len(seq) and out.dtype == torch.float32


def test_inverse_data_transform():
    x = torch.tensor([-2.0, -1.0, 0.0, 1.0, 3.0])
    np.testing.assert_array_equal(ddim.inverse_data_transform(x).numpy(),
                                  [0.0, 0.0, 0.5, 1.0, 1.0])


def test_cifar10_preset_matches_jax():
    got, want = config.PRESETS["cifar10"], jax_config.PRESETS["cifar10"]
    assert dataclasses.asdict(got.schedule) == dataclasses.asdict(
        want.schedule)
    assert (got.sampler.sample_type, got.sampler.timesteps,
            got.sampler.skip_type, got.sampler.eta) == (
        want.sampler.sample_type, want.sampler.timesteps,
        want.sampler.skip_type, want.sampler.eta)
    assert dataclasses.asdict(got.unet_ddim) == dataclasses.asdict(
        want.unet_ddim)
    assert (got.image_size, got.channels) == (want.image_size, want.channels)


@pytest.mark.parametrize("flags", [dict(weight_bit=4),
                                   dict(weight_bit=8, quant_act=True,
                                        act_bit=8)])
def test_policy_ddim_matches_jax(flags):
    """The same specs, except the weight channel axis: OIHW 0, HWIO -1."""
    got = config.QuantFlags(**flags).policy_ddim()
    want = jax_config.QuantFlags(**flags).policy_ddim()
    assert got.sm_abit == want.sm_abit
    assert got.wq.channel_axis == 0 and want.wq.channel_axis == -1
    for g, w in ((got.wq, want.wq), (got.aq, want.aq)):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gd.pop("channel_axis"), wd.pop("channel_axis")
        assert gd == {k: wd[k] for k in gd}, (gd, wd)
