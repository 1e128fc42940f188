"""LDM DDIM and PLMS samplers of the port against the JAX package, on the
CPU, f32: 5 steps with classifier-free guidance, driven on both sides by
the same numpy-defined eps function of (x, t, context). rtol = atol =
1e-5 (the f32 update arithmetic in another order). Also the PLMS call
count (S + 1 model calls for S steps) and the [uncond; cond] batch order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdiffusion_tpu.samplers.ldm import DDIMTables as JaxTables
from qdiffusion_tpu.samplers.ldm import ddim_sample_ldm as jax_ddim
from qdiffusion_tpu.samplers.ldm import plms_sample as jax_plms
from qdiffusion_tpu.schedules import NoiseSchedule as JaxSchedule

from qdiffusion_torch.samplers.ldm import DDIMTables, ddim_sample_ldm, \
    plms_sample
from qdiffusion_torch.schedules import NoiseSchedule

SCHED = NoiseSchedule.ldm("linear", 1000, 0.00085, 0.012)


def eps(xp, x, t, c):
    """The same function in numpy-style arithmetic for jnp and torch."""
    e = 0.1 * x + 0.001 * t[:, None, None, None]
    if c is not None:
        m = c.mean(axis=(1, 2)) if xp is jnp else c.mean(dim=(1, 2))
        e = e + 0.05 * m[:, None, None, None]
    return e


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond = rng.standard_normal((2, 7, 16)).astype(np.float32)
    uncond = rng.standard_normal((2, 7, 16)).astype(np.float32)
    return x, cond, uncond


def test_schedule_tables_match_jax():
    js = JaxSchedule.ldm("linear", 1000, 0.00085, 0.012)
    np.testing.assert_array_equal(SCHED.betas, js.betas)
    np.testing.assert_array_equal(SCHED.alphas_cumprod, js.alphas_cumprod)
    for eta in (0.0, 1.0):
        a = DDIMTables.build(SCHED.alphas_cumprod, 50, eta)
        b = JaxTables.build(js.alphas_cumprod, 50, eta)
        for f in ("timesteps", "alphas", "alphas_prev",
                  "sqrt_one_minus_alphas", "sigmas"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
@pytest.mark.parametrize("scale", [1.0, 7.5])
def test_sampler_matches_jax(sampler, scale):
    x, cond, uncond = _inputs()
    ac = SCHED.alphas_cumprod
    tables = DDIMTables.build(ac, 5, 0.0)
    jtables = JaxTables.build(ac, 5, 0.0)
    calls = []

    def tfn(x, t, c):
        calls.append(x.shape[0])
        return eps(torch, x, t, c)

    kw = dict(guidance_scale=scale)
    if sampler == "ddim":
        got = ddim_sample_ldm(tfn, torch.from_numpy(x), tables,
                              cond=torch.from_numpy(cond),
                              uncond=torch.from_numpy(uncond),
                              eta_noise=False, **kw)
        want, _ = jax_ddim(lambda x, t, c: eps(jnp, x, t, c), jnp.asarray(x),
                           jtables, cond=jnp.asarray(cond),
                           uncond=jnp.asarray(uncond), eta_noise=False, **kw)
    else:
        got = plms_sample(tfn, torch.from_numpy(x), tables,
                          cond=torch.from_numpy(cond),
                          uncond=torch.from_numpy(uncond), **kw)
        want, _ = jax_plms(lambda x, t, c: eps(jnp, x, t, c), jnp.asarray(x),
                           jtables, cond=jnp.asarray(cond),
                           uncond=jnp.asarray(uncond), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # one batched call per evaluation: 2n rows under CFG, n without
    assert set(calls) == {4 if scale != 1.0 else 2}
    assert len(calls) == (6 if sampler == "plms" else 5)


def test_cfg_batch_order_is_uncond_then_cond():
    from qdiffusion_torch.samplers.ldm import _cfg_eps

    x = torch.zeros((1, 2, 2, 1))
    cond, uncond = torch.ones((1, 3, 4)), torch.zeros((1, 3, 4))
    seen = []

    def fn(x, t, c):
        seen.append(c[:, 0, 0].tolist())
        return c.mean(dim=(1, 2))[:, None, None, None].expand(-1, 2, 2, 1)

    e = _cfg_eps(fn, x, torch.zeros(1), cond, uncond, 7.5)
    assert seen == [[0.0, 1.0]]
    torch.testing.assert_close(e, torch.full((1, 2, 2, 1), 7.5))


def test_bf16_eval_dtype_keeps_an_f32_carry():
    x, cond, uncond = _inputs(1)
    dtypes = []

    def tfn(x, t, c):
        dtypes.append(x.dtype)
        return eps(torch, x.float(), t, c).to(x.dtype)

    out = plms_sample(tfn, torch.from_numpy(x), DDIMTables.build(
        SCHED.alphas_cumprod, 4, 0.0), cond=torch.from_numpy(cond),
        uncond=torch.from_numpy(uncond), guidance_scale=7.5,
        eval_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and set(dtypes) == {torch.bfloat16}
