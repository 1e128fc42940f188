"""DPM-Solver(++) of the port against the JAX package, on the CPU, f32,
driven on both sides by the same numpy-defined model function of (x, t,
context) (the pattern of test_torch_samplers_ldm.py).

  * NoiseScheduleVP (discrete, linear, cosine), get_time_steps (three skip
    types) and singlestep_orders: exactly equal, float64;
  * the fixed-grid solvers over method x order x algorithm_type x
    solver_type x model_type x classifier-free guidance, 6 steps on the
    SD schedule: rtol = atol = 1e-5 (observed at most 2.6e-6, singlestep
    order 3 dpmsolver++ with 'taylor' corrections, 'v');
  * the adaptive method, orders 2 and 3 on the discrete schedule the
    pipelines run: first the number of tries and of accepted steps (JAX's
    counted inside its while_loop, the port's read from its model calls),
    then x within 1e-4 (observed at most 2e-5). The accept test E <= 1
    reads an error estimate that is a difference of two nearly equal
    solutions: on the cosine schedule at order 3 JAX's compiled
    while_loop and the same loop run op by op already take different
    numbers of tries;
  * denoise_to_zero, classifier guidance with a toy classifier whose
    gradient is known, the [uncond; cond] batch order, the fractional
    model times, and the bf16 carrier's f32 carry.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdiffusion_tpu.samplers import dpm_solver as jdpm

from qdiffusion_torch.samplers import dpm_solver as tdpm
from qdiffusion_torch.schedules import NoiseSchedule

torch.set_num_threads(1)

BETAS = NoiseSchedule.ldm("linear", 1000, 0.00085, 0.012).betas


def model(xp, x, t, c=None):
    """The same function in jnp and torch arithmetic: near a denoiser of
    unit-variance data (eps ~ x), so every parameterization stays O(1)."""
    e = 0.9 * x + 1e-4 * t[:, None, None, None] + 0.05 * xp.sin(3.0 * x)
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


def _schedules(kind):
    if kind == "discrete":
        return (jdpm.NoiseScheduleVP("discrete", betas=BETAS),
                tdpm.NoiseScheduleVP("discrete", betas=BETAS))
    return jdpm.NoiseScheduleVP(kind), tdpm.NoiseScheduleVP(kind)


# the toy's output scaled per parameterization so that the eps it
# implies stays near x: a small x0, a negative score
OUT_SCALE = {"noise": 1.0, "x_start": 0.1, "v": 1.0, "score": -1.0}


def _both(x, cfg, model_type="noise", **kw):
    """(port, JAX) samples of `model` from x, with CFG 7.5 when cfg."""
    _, cond, uncond = _inputs()
    js, ts = _schedules("discrete")
    g = dict(guidance_scale=7.5) if cfg else {}
    k = OUT_SCALE[model_type]
    kw["model_type"] = model_type
    want = jdpm.dpm_solver_sample(
        lambda x, t, c=None: k * model(jnp, x, t, c), jnp.asarray(x), js,
        **(dict(cond=jnp.asarray(cond), uncond=jnp.asarray(uncond), **g)
           if cfg else {}), **kw)
    got = tdpm.dpm_solver_sample(
        lambda x, t, c=None: k * model(torch, x, t, c), torch.from_numpy(x),
        ts, with_context=cfg,
        **(dict(cond=torch.from_numpy(cond), uncond=torch.from_numpy(uncond),
                **g) if cfg else {}), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kind", ["discrete", "linear", "cosine"])
def test_noise_schedule_equals_jax(kind):
    js, ts = _schedules(kind)
    assert (ts.total_N, ts.T) == (js.total_N, js.T)
    t = np.linspace(1e-3, js.T, 97)
    for f in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
              "marginal_lambda", "model_input_time"):
        np.testing.assert_array_equal(getattr(ts, f)(t), getattr(js, f)(t))
    lam = js.marginal_lambda(t)
    np.testing.assert_array_equal(ts.inverse_lambda(lam),
                                  js.inverse_lambda(lam))


@pytest.mark.parametrize("kind", ["discrete", "linear", "cosine"])
def test_time_steps_and_orders_equal_jax(kind):
    js, ts = _schedules(kind)
    for skip, n in itertools.product(("logSNR", "time_uniform",
                                      "time_quadratic"), (1, 3, 20, 50)):
        got = tdpm.get_time_steps(ts, skip, ts.T, 1.0 / ts.total_N, n)
        want = jdpm.get_time_steps(js, skip, js.T, 1.0 / js.total_N, n)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    for steps, order in itertools.product(range(1, 31), (1, 2, 3)):
        assert tdpm.singlestep_orders(steps, order) == \
            jdpm.singlestep_orders(steps, order)
    with pytest.raises(ValueError):
        tdpm.singlestep_orders(10, 4)


@pytest.mark.parametrize("cfg", [False, True])
@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
@pytest.mark.parametrize("solver_type", ["dpmsolver", "taylor"])
@pytest.mark.parametrize("algorithm_type", ["dpmsolver", "dpmsolver++"])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("method", ["singlestep", "singlestep_fixed",
                                    "multistep"])
def test_fixed_grid_matches_jax(method, order, algorithm_type, solver_type,
                                model_type, cfg):
    x, _, _ = _inputs()
    got, want = _both(x, cfg, steps=6, order=order, method=method,
                      algorithm_type=algorithm_type, solver_type=solver_type,
                      model_type=model_type)
    assert np.abs(want).max() < 10  # the toy model keeps x bounded
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _JaxTries:
    """jax.lax.while_loop with the number of tries and of accepted steps
    (the carry's s moved) counted inside the compiled loop."""

    def __init__(self):
        self.real = jax.lax.while_loop
        self.tries = self.accepted = None

    def __call__(self, cond, body, init):
        def counted(c):
            carry, n = c
            new = body(carry)
            return new, n + (new[2] != carry[2]).astype(jnp.int32)

        out, n = self.real(lambda c: cond(c[0]), counted,
                           (init, jnp.int32(0)))
        self.tries, self.accepted = int(out[4]), int(n)
        return out


@pytest.mark.parametrize("solver_type", ["dpmsolver", "taylor"])
@pytest.mark.parametrize("algorithm_type", ["dpmsolver", "dpmsolver++"])
@pytest.mark.parametrize("order", [2, 3])
def test_adaptive_takes_jax_steps(monkeypatch, order, algorithm_type,
                                  solver_type):
    x, _, _ = _inputs()
    js, ts = _schedules("discrete")
    kw = dict(method="adaptive", order=order, algorithm_type=algorithm_type,
              solver_type=solver_type)
    tries = _JaxTries()
    monkeypatch.setattr(jax.lax, "while_loop", tries)
    want = np.asarray(jdpm.dpm_solver_sample(
        lambda x, t: model(jnp, x, t), jnp.asarray(x), js, **kw))
    monkeypatch.setattr(jax.lax, "while_loop", tries.real)
    times = []

    def fn(x, t):
        times.append(float(t[0]))
        assert t.dtype == torch.float32 and t.shape == (2,)
        return model(torch, x, t)

    got = tdpm.dpm_solver_sample(fn, torch.from_numpy(x), ts, **kw).numpy()
    # each try calls the model `order` times, first at its start time s;
    # a rejected try leaves s, and the last try ends at t_0
    starts = times[::order]
    assert len(times) == order * len(starts)
    accepted = sum(a != b for a, b in zip(starts, starts[1:])) + 1
    assert (len(starts), accepted) == (tries.tries, tries.accepted)
    assert tries.accepted >= 5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_adaptive_refuses_order_1():
    x, _, _ = _inputs()
    with pytest.raises(ValueError):
        tdpm.dpm_solver_sample(lambda x, t: x, torch.from_numpy(x),
                               _schedules("discrete")[1], method="adaptive",
                               order=1)


@pytest.mark.parametrize("algorithm_type", ["dpmsolver", "dpmsolver++"])
@pytest.mark.parametrize("method", ["singlestep", "multistep"])
def test_denoise_to_zero_matches_jax(method, algorithm_type):
    x, _, _ = _inputs(2)
    got, want = _both(x, True, steps=5, order=2, method=method,
                      algorithm_type=algorithm_type, denoise_to_zero=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain, _ = _both(x, True, steps=5, order=2, method=method,
                     algorithm_type=algorithm_type)
    assert np.abs(got - plain).max() > 1e-4  # the last step ran


MU = 0.3


def _log_prob(xp):
    """log p(c | x, t) = -0.5 sum (x - MU)^2 per row: gradient MU - x."""
    def f(x, t):
        d = x - MU
        return -0.5 * (d * d).reshape(x.shape[0], -1).sum(-1) * (
            1.0 + 0.0 * t)
    return f


@pytest.mark.parametrize("method", ["singlestep", "multistep", "adaptive"])
def test_classifier_guidance_matches_jax(method):
    x, _, _ = _inputs(3)
    js, ts = _schedules("discrete")
    kw = dict(steps=6, order=2, method=method, classifier_scale=2.0)
    want = np.asarray(jdpm.dpm_solver_sample(
        lambda x, t: model(jnp, x, t), jnp.asarray(x), js,
        classifier_fn=_log_prob(jnp), **kw))
    with torch.no_grad():  # as the pipelines run it
        got = tdpm.dpm_solver_sample(
            lambda x, t: model(torch, x, t), torch.from_numpy(x), ts,
            classifier_fn=_log_prob(torch), **kw)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    unguided = tdpm.dpm_solver_sample(lambda x, t: model(torch, x, t),
                                      torch.from_numpy(x), ts,
                                      **{k: v for k, v in kw.items()
                                         if k != "classifier_scale"})
    assert (got - unguided).abs().max() > 1e-3


def test_classifier_gradient_is_the_analytic_one():
    x = torch.from_numpy(_inputs(4)[0])
    with torch.no_grad():
        g = tdpm._classifier_grad(_log_prob(torch))(x, torch.ones(2))
    torch.testing.assert_close(g, MU - x)
    seen = []

    def eps_fn(x, t):
        return torch.zeros_like(x)

    def grad_fn(x, t):
        seen.append(t)
        return torch.ones_like(x)

    sol = tdpm._Solver(eps_fn, 2, pp=False, classifier_grad_fn=grad_fn,
                       classifier_scale=3.0)
    e = sol.noise_pred(x, torch.zeros(2), 0.8, 0.6)
    torch.testing.assert_close(e, torch.full_like(x, -3.0 * 0.6))
    assert len(seen) == 1


def test_cfg_batch_order_is_uncond_then_cond():
    x = torch.zeros((1, 2, 2, 1))
    cond, uncond = torch.ones((1, 3, 4)), torch.zeros((1, 3, 4))
    seen = []

    def fn(x, t, c):
        seen.append(c[:, 0, 0].tolist())
        return c.mean(dim=(1, 2))[:, None, None, None].expand(-1, 2, 2, 1)

    e = tdpm.make_cfg_eps_fn(fn, cond, uncond, 7.5)(x, torch.zeros(1))
    assert seen == [[0.0, 1.0]]
    torch.testing.assert_close(e, torch.full((1, 2, 2, 1), 7.5))


@pytest.mark.parametrize("method", ["singlestep", "multistep", "adaptive"])
def test_model_times_are_fractional_f32(method):
    """The discrete model sees (t - 1/N) * 1000 as f32, not rounded:
    JAX's times, call for call."""
    x, _, _ = _inputs(5)
    js, ts = _schedules("discrete")
    jt, tt = [], []

    def jfn(x, t):
        jt.append(t)
        return model(jnp, x, t)

    def tfn(x, t):
        tt.append(t.clone())
        return model(torch, x, t)

    kw = dict(steps=5, order=3, method=method)
    if method == "adaptive":
        tdpm.dpm_solver_sample(tfn, torch.from_numpy(x), ts, **kw)
        assert all(t.dtype == torch.float32 for t in tt)
        assert any(float(t[0]) != round(float(t[0])) for t in tt)
        return
    jdpm.dpm_solver_sample(jfn, jnp.asarray(x), js, **kw)
    tdpm.dpm_solver_sample(tfn, torch.from_numpy(x), ts, **kw)
    assert len(tt) == len(jt) == 5
    for a, b in zip(tt, jt):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert any(float(t[0]) != round(float(t[0])) for t in tt)


def test_bf16_eval_dtype_keeps_an_f32_carry():
    x, cond, uncond = _inputs(6)
    dtypes = []

    def fn(x, t, c):
        dtypes.append(x.dtype)
        return model(torch, x.float(), t, c).to(x.dtype)

    out = tdpm.dpm_solver_sample(
        fn, torch.from_numpy(x), _schedules("discrete")[1], steps=4,
        order=2, method="multistep", with_context=True,
        cond=torch.from_numpy(cond), uncond=torch.from_numpy(uncond),
        guidance_scale=7.5, eval_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and set(dtypes) == {torch.bfloat16}
    assert len(dtypes) == 4
