"""DPM-Solver / DPM-Solver++ (Lu et al. 2022), port of
qdiffusion_tpu/samplers/dpm_solver.py (reference ddim/dpm_solver_pytorch.py
and its ldm copy).

The discrete / linear / cosine NoiseScheduleVP, the four model
parameterizations ('noise' / 'x_start' / 'v' / 'score', reference
:360-383), classifier-free guidance (uncond rows first) and classifier
guidance, the singlestep and multistep solvers of order 1-3 for both
algorithm types ('dpmsolver++' predicts data, 'dpmsolver' noise) and both
solver types ('dpmsolver', 'taylor'), and the adaptive step-size method.

Fixed-grid methods: every time, logSNR and coefficient is computed on the
host in float64 (numpy), in the JAX package's order of operations, and
applied to the f32 tensors as a Python float. The adaptive method is data
dependent: it runs as a Python loop whose schedule math stays in f32
tensors on x's device, as JAX's on-device `lax.while_loop` computes it,
so that the accept test E <= 1 sees the same numbers; it makes one host
sync per step. The update rules are written once for both: `_HostTime`
and `_DeviceTime` give the schedule queries and say how a coefficient
reaches the tensors.

Classifier guidance differentiates `classifier_fn` with torch.autograd
under a local torch.enable_grad() (the pipelines sample under no_grad).
The B1/B2/B3 kernels have no backward and refuse a card input that
requires grad: a classifier that is a model of this package must run its
GroupNorm and attention with fused_ok=False.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch


class NoiseScheduleVP:
    """Continuous-time VP schedule (reference dpm_solver_pytorch.py:6-176).
    Host-side: every query takes and returns numpy float64."""

    def __init__(self, schedule: str = "discrete",
                 betas: Optional[np.ndarray] = None,
                 alphas_cumprod: Optional[np.ndarray] = None,
                 continuous_beta_0: float = 0.1,
                 continuous_beta_1: float = 20.0):
        self.schedule = schedule
        if schedule == "discrete":
            if betas is not None:
                log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas)))
            else:
                log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod))
            self.total_N = len(log_alphas)
            self.T = 1.0
            self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
            self.log_alpha_array = log_alphas
        elif schedule in ("linear", "cosine"):
            self.total_N = 1000
            self.beta_0 = continuous_beta_0
            self.beta_1 = continuous_beta_1
            # improved-DDPM cosine constants (reference :112-122)
            self.cosine_s = 0.008
            self.cosine_beta_max = 999.0
            self.cosine_t_max = (
                math.atan(self.cosine_beta_max * (1.0 + self.cosine_s)
                          / math.pi)
                * 2.0 * (1.0 + self.cosine_s) / math.pi - self.cosine_s)
            self.cosine_log_alpha_0 = math.log(
                math.cos(self.cosine_s / (1.0 + self.cosine_s) * math.pi / 2))
            # T = 1 is numerically singular for cosine (reference :118-121)
            self.T = 0.9946 if schedule == "cosine" else 1.0
        else:
            raise NotImplementedError(schedule)

    def marginal_log_mean_coeff(self, t):
        t = np.asarray(t, np.float64)
        if self.schedule == "discrete":
            return np.interp(t, self.t_array, self.log_alpha_array)
        if self.schedule == "linear":
            return (-0.25 * t**2 * (self.beta_1 - self.beta_0)
                    - 0.5 * t * self.beta_0)
        return (np.log(np.cos((t + self.cosine_s) / (1.0 + self.cosine_s)
                              * math.pi / 2))
                - self.cosine_log_alpha_0)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mc = self.marginal_log_mean_coeff(t)
        return log_mc - 0.5 * np.log(1.0 - np.exp(2.0 * log_mc))

    def inverse_lambda(self, lamb):
        lamb = np.asarray(lamb, np.float64)
        if self.schedule == "discrete":
            log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
            # log_alpha_array decreases with t: flip for np.interp
            return np.interp(log_alpha, self.log_alpha_array[::-1],
                             self.t_array[::-1])
        if self.schedule == "linear":
            tmp = (2.0 * (self.beta_1 - self.beta_0)
                   * np.logaddexp(-2.0 * lamb, 0.0))
            delta = self.beta_0**2 + tmp
            return (tmp / (np.sqrt(delta) + self.beta_0)
                    / (self.beta_1 - self.beta_0))
        log_alpha = -0.5 * np.logaddexp(-2.0 * lamb, 0.0)
        return (np.arccos(np.exp(log_alpha + self.cosine_log_alpha_0))
                * 2.0 * (1.0 + self.cosine_s) / math.pi - self.cosine_s)

    def model_input_time(self, t_continuous):
        """Continuous time -> the discrete model's timestep input
        (reference get_model_input_time, dpm_solver_pytorch.py:346-355);
        continuous-time models take t_continuous unchanged."""
        if self.schedule == "discrete":
            return (np.asarray(t_continuous) - 1.0 / self.total_N) * 1000.0
        return np.asarray(t_continuous)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp's arithmetic (constant ends), f32 tensors."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, len(xp) - 1)[0]
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class _HostTime:
    """Times as Python floats, the schedule in numpy float64; a
    coefficient reaches the tensors as a Python float."""

    def __init__(self, ns: NoiseScheduleVP):
        self.ns = ns
        self.lmc = ns.marginal_log_mean_coeff
        self.alpha, self.std = ns.marginal_alpha, ns.marginal_std
        self.lam, self.inverse_lambda = ns.marginal_lambda, ns.inverse_lambda
        self.exp, self.expm1 = np.exp, np.expm1

    c = staticmethod(float)

    def model_time(self, t, batch: int, device) -> torch.Tensor:
        return torch.full((batch,), float(self.ns.model_input_time(t)),
                          dtype=torch.float32, device=device)


class _DeviceTime:
    """Times as 0-d f32 tensors on x's device, the schedule in f32 as
    JAX's _DeviceSchedule computes it under its while_loop (:125-176);
    a coefficient is a 0-d tensor."""

    def __init__(self, ns: NoiseScheduleVP, device):
        self.ns, self.device = ns, device
        if ns.schedule == "discrete":
            self.t_array = torch.tensor(ns.t_array, dtype=torch.float32,
                                        device=device)
            self.log_alpha_array = torch.tensor(
                ns.log_alpha_array, dtype=torch.float32, device=device)
        self.exp, self.expm1 = torch.exp, torch.expm1

    @staticmethod
    def c(v):
        return v

    def time(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def lmc(self, t):
        ns = self.ns
        if ns.schedule == "discrete":
            return _interp(t, self.t_array, self.log_alpha_array)
        if ns.schedule == "linear":
            return (-0.25 * t**2 * (ns.beta_1 - ns.beta_0)
                    - 0.5 * t * ns.beta_0)
        return (torch.log(torch.cos((t + ns.cosine_s) / (1.0 + ns.cosine_s)
                                    * math.pi / 2))
                - ns.cosine_log_alpha_0)

    def alpha(self, t):
        return torch.exp(self.lmc(t))

    def std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.lmc(t)))

    def lam(self, t):
        log_mc = self.lmc(t)
        return log_mc - 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mc))

    def inverse_lambda(self, lamb):
        ns, zero = self.ns, torch.zeros_like(lamb)
        if ns.schedule == "discrete":
            log_alpha = -0.5 * torch.logaddexp(zero, -2.0 * lamb)
            return _interp(log_alpha, self.log_alpha_array.flip(0),
                           self.t_array.flip(0))
        if ns.schedule == "linear":
            tmp = (2.0 * (ns.beta_1 - ns.beta_0)
                   * torch.logaddexp(-2.0 * lamb, zero))
            delta = ns.beta_0**2 + tmp
            return (tmp / (torch.sqrt(delta) + ns.beta_0)
                    / (ns.beta_1 - ns.beta_0))
        log_alpha = -0.5 * torch.logaddexp(-2.0 * lamb, zero)
        return (torch.arccos(torch.exp(log_alpha + ns.cosine_log_alpha_0))
                * 2.0 * (1.0 + ns.cosine_s) / math.pi - ns.cosine_s)

    def model_time(self, t, batch: int, device) -> torch.Tensor:
        if self.ns.schedule == "discrete":
            t = (t - 1.0 / self.ns.total_N) * 1000.0
        return t.reshape(1).expand(batch).contiguous()


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                   t_0: float, N: int) -> np.ndarray:
    if skip_type == "logSNR":
        lam_T = ns.marginal_lambda(t_T)
        lam_0 = ns.marginal_lambda(t_0)
        return ns.inverse_lambda(np.linspace(lam_T, lam_0, N + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T**0.5, t_0**0.5, N + 1) ** 2
    raise ValueError(skip_type)


def singlestep_orders(steps: int, order: int) -> List[int]:
    """DPM-Solver-fast order plan (reference :490-546)."""
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (K - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (K - 1) + [1]
        return [3] * (K - 1) + [2]
    if order == 2:
        K = steps // 2
        if steps % 2 == 0:
            return [2] * K
        return [2] * K + [1]
    if order == 1:
        return [1] * steps
    raise ValueError(order)


# (x, t_model_batched) -> model output, guidance folded in
EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_cfg_eps_fn(model_fn, cond=None, uncond=None,
                    guidance_scale: float = 1.0) -> EpsFn:
    """Classifier-free-guided model call (reference model_wrapper
    'classifier-free' branch, dpm_solver_pytorch.py:414-424): one call on
    [uncond; cond], in that order, then split."""

    def eps(x, t):
        if cond is None or uncond is None or guidance_scale == 1.0:
            return model_fn(x, t, cond)
        e = model_fn(torch.cat([x, x]), torch.cat([t, t]),
                     torch.cat([uncond, cond]))
        e_u, e_c = e.chunk(2)
        return e_u + guidance_scale * (e_c - e_u)

    return eps


def _to_eps(raw, x, alpha_t, sigma_t, model_type: str):
    """A raw model output as a noise prediction (reference noise_pred_fn,
    dpm_solver_pytorch.py:360-383)."""
    if model_type == "noise":
        return raw
    if model_type == "x_start":
        return (x - alpha_t * raw) / sigma_t
    if model_type == "v":
        return alpha_t * raw + sigma_t * x
    if model_type == "score":
        return -sigma_t * raw
    raise ValueError(model_type)


def _classifier_grad(classifier_fn: Callable) -> Callable:
    """(x, t) -> d/dx sum(classifier_fn(x, t)), under a local
    enable_grad (the samplers run under no_grad)."""

    def grad(x, t):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(classifier_fn(xx, t).sum(), xx)
        return g

    return grad


class _Solver:
    """The update rules (reference :560-860), each written once for both
    time representations: `S` is a _HostTime (fixed grids) or a
    _DeviceTime (adaptive)."""

    def __init__(self, eps_fn: EpsFn, batch: int, pp: bool,
                 model_type: str = "noise",
                 classifier_grad_fn: Optional[Callable] = None,
                 classifier_scale: float = 1.0):
        self.eps_fn, self.batch, self.pp = eps_fn, batch, pp
        self.model_type = model_type
        # classifier guidance (reference :385-412): eps <- eps - s*sigma*grad
        self.classifier_grad_fn = classifier_grad_fn
        self.classifier_scale = classifier_scale

    def noise_pred(self, x, tb, alpha_t, sigma_t):
        eps = _to_eps(self.eps_fn(x, tb), x, alpha_t, sigma_t,
                      self.model_type)
        if self.classifier_grad_fn is not None:
            grad = self.classifier_grad_fn(x, tb)
            eps = eps - self.classifier_scale * sigma_t * grad
        return eps

    def model(self, x, t, S):
        """eps (dpmsolver) or the predicted x0 (dpmsolver++,
        data_prediction_fn :441-450) at continuous time t."""
        tb = S.model_time(t, self.batch, x.device)
        alpha, sigma = S.c(S.alpha(t)), S.c(S.std(t))
        eps = self.noise_pred(x, tb, alpha, sigma)
        if not self.pp:
            return eps
        return (x - sigma * eps) / alpha

    def first_update(self, x, s, t, S, model_s=None):
        if model_s is None:
            model_s = self.model(x, s, S)
        c = S.c
        h = S.lam(t) - S.lam(s)
        if self.pp:
            x_t = (c(S.std(t) / S.std(s)) * x
                   - c(S.alpha(t) * S.expm1(-h)) * model_s)
        else:
            x_t = (c(S.exp(S.lmc(t) - S.lmc(s))) * x
                   - c(S.std(t) * S.expm1(h)) * model_s)
        return x_t, model_s

    def second_update(self, x, s, t, S, r1: float = 0.5,
                      solver_type: str = "dpmsolver", model_s=None):
        """Singlestep order 2 (reference :602-676): (x_t, model_s,
        model_s1)."""
        c = S.c
        lam_s, lam_t = S.lam(s), S.lam(t)
        h = lam_t - lam_s
        s1 = S.inverse_lambda(lam_s + r1 * h)
        if model_s is None:
            model_s = self.model(x, s, S)
        if self.pp:
            phi11, phi1 = S.expm1(-r1 * h), S.expm1(-h)
            x_s1 = (c(S.std(s1) / S.std(s)) * x
                    - c(S.alpha(s1) * phi11) * model_s)
            model_s1 = self.model(x_s1, s1, S)
            if solver_type == "taylor":
                c_d = c(1.0 / r1 * S.alpha(t) * (phi1 / h + 1.0))
            else:
                c_d = c(-0.5 / r1 * S.alpha(t) * phi1)
            x_t = (c(S.std(t) / S.std(s)) * x
                   - c(S.alpha(t) * phi1) * model_s
                   + c_d * (model_s1 - model_s))
        else:
            phi11, phi1 = S.expm1(r1 * h), S.expm1(h)
            x_s1 = (c(S.exp(S.lmc(s1) - S.lmc(s))) * x
                    - c(S.std(s1) * phi11) * model_s)
            model_s1 = self.model(x_s1, s1, S)
            if solver_type == "taylor":
                c_d = c(-1.0 / r1 * S.std(t) * (phi1 / h - 1.0))
            else:
                c_d = c(-0.5 / r1 * S.std(t) * phi1)
            x_t = (c(S.exp(S.lmc(t) - S.lmc(s))) * x
                   - c(S.std(t) * phi1) * model_s
                   + c_d * (model_s1 - model_s))
        return x_t, model_s, model_s1

    def third_update(self, x, s, t, S, r1: float = 1.0 / 3.0,
                     r2: float = 2.0 / 3.0, solver_type: str = "dpmsolver",
                     model_s=None, model_s1=None):
        """Singlestep order 3 (reference :686-801). The adaptive method
        passes taylor=False whatever its solver_type, as JAX's
        third_update_dev has no taylor branch (ROADMAP §C)."""
        c = S.c
        taylor = solver_type == "taylor"
        lam_s, lam_t = S.lam(s), S.lam(t)
        h = lam_t - lam_s
        s1 = S.inverse_lambda(lam_s + r1 * h)
        s2 = S.inverse_lambda(lam_s + r2 * h)
        if model_s is None:
            model_s = self.model(x, s, S)
        if self.pp:
            phi11, phi12, phi1 = (S.expm1(-r1 * h), S.expm1(-r2 * h),
                                  S.expm1(-h))
            phi22 = S.expm1(-r2 * h) / (r2 * h) + 1.0
            phi2 = phi1 / h + 1.0
            phi3 = phi2 / h - 0.5
            if model_s1 is None:
                x_s1 = (c(S.std(s1) / S.std(s)) * x
                        - c(S.alpha(s1) * phi11) * model_s)
                model_s1 = self.model(x_s1, s1, S)
            x_s2 = (c(S.std(s2) / S.std(s)) * x
                    - c(S.alpha(s2) * phi12) * model_s
                    + c(r2 / r1 * S.alpha(s2) * phi22) * (model_s1 - model_s))
            model_s2 = self.model(x_s2, s2, S)
            if taylor:
                d1, d2 = _taylor_d(model_s, model_s1, model_s2, r1, r2)
                return (c(S.std(t) / S.std(s)) * x
                        - c(S.alpha(t) * phi1) * model_s
                        + c(S.alpha(t) * phi2) * d1
                        - c(S.alpha(t) * phi3) * d2)
            return (c(S.std(t) / S.std(s)) * x
                    - c(S.alpha(t) * phi1) * model_s
                    + c(1.0 / r2 * S.alpha(t) * phi2) * (model_s2 - model_s))
        phi11, phi12, phi1 = S.expm1(r1 * h), S.expm1(r2 * h), S.expm1(h)
        phi22 = S.expm1(r2 * h) / (r2 * h) - 1.0
        phi2 = phi1 / h - 1.0
        phi3 = phi2 / h - 0.5
        if model_s1 is None:
            x_s1 = (c(S.exp(S.lmc(s1) - S.lmc(s))) * x
                    - c(S.std(s1) * phi11) * model_s)
            model_s1 = self.model(x_s1, s1, S)
        x_s2 = (c(S.exp(S.lmc(s2) - S.lmc(s))) * x
                - c(S.std(s2) * phi12) * model_s
                - c(r2 / r1 * S.std(s2) * phi22) * (model_s1 - model_s))
        model_s2 = self.model(x_s2, s2, S)
        if taylor:
            d1, d2 = _taylor_d(model_s, model_s1, model_s2, r1, r2)
            return (c(S.exp(S.lmc(t) - S.lmc(s))) * x
                    - c(S.std(t) * phi1) * model_s
                    - c(S.std(t) * phi2) * d1
                    - c(S.std(t) * phi3) * d2)
        return (c(S.exp(S.lmc(t) - S.lmc(s))) * x
                - c(S.std(t) * phi1) * model_s
                - c(1.0 / r2 * S.std(t) * phi2) * (model_s2 - model_s))

    def multistep_second(self, x, m0, m1, t_prev1: float, t_prev0: float,
                         t: float, S, solver_type: str = "dpmsolver"):
        c = S.c
        lam_p1, lam_p0, lam_t = (S.lam(v) for v in (t_prev1, t_prev0, t))
        h0, h = lam_p0 - lam_p1, lam_t - lam_p0
        r0 = h0 / h
        d1 = (m0 - m1) / c(r0)
        if self.pp:
            phi1 = S.expm1(-h)
            a_t = S.alpha(t)
            if solver_type == "taylor":
                c_d = c(a_t * (phi1 / h + 1.0))
            else:
                c_d = c(-0.5 * a_t * phi1)
            return (c(S.std(t) / S.std(t_prev0)) * x
                    - c(a_t * phi1) * m0 + c_d * d1)
        phi1 = S.expm1(h)
        sig_t = S.std(t)
        c_x = S.exp(S.lmc(t) - S.lmc(t_prev0))
        if solver_type == "taylor":
            c_d = c(-sig_t * (phi1 / h - 1.0))
        else:
            c_d = c(-0.5 * sig_t * phi1)
        return c(c_x) * x - c(sig_t * phi1) * m0 + c_d * d1

    def multistep_third(self, x, m0, m1, m2, t_prev2: float, t_prev1: float,
                        t_prev0: float, t: float, S):
        c = S.c
        lam_p2, lam_p1, lam_p0, lam_t = (
            S.lam(v) for v in (t_prev2, t_prev1, t_prev0, t))
        h1, h0, h = lam_p1 - lam_p2, lam_p0 - lam_p1, lam_t - lam_p0
        r0, r1 = h0 / h, h1 / h
        d1_0 = (m0 - m1) / c(r0)
        d1_1 = (m1 - m2) / c(r1)
        d1 = d1_0 + c(r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) / c(r0 + r1)
        if self.pp:
            phi1 = S.expm1(-h)
            phi2 = phi1 / h + 1.0
            phi3 = phi2 / h - 0.5
            a_t = S.alpha(t)
            return (c(S.std(t) / S.std(t_prev0)) * x
                    - c(a_t * phi1) * m0 + c(a_t * phi2) * d1
                    - c(a_t * phi3) * d2)
        phi1 = S.expm1(h)
        phi2 = phi1 / h - 1.0
        phi3 = phi2 / h - 0.5
        sig_t = S.std(t)
        c_x = S.exp(S.lmc(t) - S.lmc(t_prev0))
        return (c(c_x) * x - c(sig_t * phi1) * m0
                - c(sig_t * phi2) * d1 - c(sig_t * phi3) * d2)


def _taylor_d(m_s, m_s1, m_s2, r1: float, r2: float):
    """The third-order 'taylor' first and second differences."""
    d1_0 = (1.0 / r1) * (m_s1 - m_s)
    d1_1 = (1.0 / r2) * (m_s2 - m_s)
    d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
    d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
    return d1, d2


def dpm_solver_adaptive(sol: _Solver, x: torch.Tensor, ns: NoiseScheduleVP,
                        t_T: float, t_0: float, *, order: int = 3,
                        h_init: float = 0.05, atol: float = 0.0078,
                        rtol: float = 0.05, theta: float = 0.9,
                        t_err: float = 1e-5, solver_type: str = "dpmsolver",
                        max_nfe_steps: int = 400) -> torch.Tensor:
    """Adaptive DPM-Solver (reference :962-1019): a lower / higher order
    pair, accept when the local error estimate E <= 1, step size h <-
    theta h E^(-1/order). The schedule math is f32 on x's device, as in
    JAX's while_loop; E and the step's end time come to the host once a
    step. `max_nfe_steps` bounds the number of tries."""
    if order not in (2, 3):
        raise ValueError(f"adaptive solver order must be 2 or 3, got {order}")
    S = _DeviceTime(ns, x.device)
    f32 = np.float32
    lam_0 = S.lam(S.time(t_0))
    s, h = S.time(t_T), S.time(h_init)
    s_host = f32(t_T)
    x_prev = x
    for _ in range(max_nfe_steps):
        if not np.abs(s_host - f32(t_0)) > f32(t_err):
            break
        t = S.inverse_lambda(S.lam(s) + h)
        if order == 2:
            x_low, model_s = sol.first_update(x, s, t, S)
            x_high, _, _ = sol.second_update(x, s, t, S, 0.5, solver_type,
                                             model_s=model_s)
        else:
            r1, r2 = 1.0 / 3.0, 2.0 / 3.0
            x_low, model_s, model_s1 = sol.second_update(x, s, t, S, r1,
                                                         solver_type)
            x_high = sol.third_update(x, s, t, S, r1, r2, "dpmsolver",
                                      model_s=model_s, model_s1=model_s1)
        delta = torch.clamp_min(rtol * torch.maximum(x_low.abs(),
                                                     x_prev.abs()), atol)
        err2 = ((x_high - x_low) / delta).square().reshape(
            x.shape[0], -1).mean(dim=-1)
        E = err2.sqrt().max()
        e_host, t_host = torch.stack([E, t]).tolist()  # the step's sync
        if e_host <= 1.0:
            x, x_prev, s, s_host = x_high, x_low, t, f32(t_host)
        h = torch.minimum(theta * h * E ** (-1.0 / order), lam_0 - S.lam(s))
    return x


def dpm_solver_sample(
    model_fn: Callable,
    x: torch.Tensor,
    ns: NoiseScheduleVP,
    *,
    steps: int = 20,
    order: int = 3,
    skip_type: str = "time_uniform",
    method: str = "singlestep",
    algorithm_type: str = "dpmsolver++",
    solver_type: str = "dpmsolver",
    model_type: str = "noise",
    lower_order_final: bool = True,
    denoise_to_zero: bool = False,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    with_context: bool = False,
    cond: Optional[torch.Tensor] = None,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    classifier_fn: Optional[Callable] = None,
    classifier_scale: float = 1.0,
    atol: float = 0.0078,
    rtol: float = 0.05,
    eval_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Sample with DPM-Solver(++) (reference DPM_Solver.sample,
    dpm_solver_pytorch.py:1055-1259) for method in {'singlestep',
    'singlestep_fixed', 'multistep', 'adaptive'}.

    model_fn(x, t) -> model output in the `model_type` parameterization;
    with_context=True: model_fn(x, t, context) with context = cond, or
    [uncond; cond] under classifier-free guidance (guidance_scale != 1).
    classifier_fn(x, t) -> log p(c | x, t): its summed gradient is folded
    into eps (reference cond_grad_fn + 'classifier' branch :385-412).
    eval_dtype: the model's carrier (bf16 deployment): the solver carry
    and math stay f32, only the model input and output are cast."""
    if solver_type not in ("dpmsolver", "taylor"):
        raise ValueError(solver_type)
    t_0 = 1.0 / ns.total_N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    if with_context:
        base_fn = model_fn
    else:
        base_fn = lambda xx, tt, c=None: model_fn(xx, tt)  # noqa: E731
    if eval_dtype is not None:
        x = x.float()  # f32 solver carry
        inner_fn = base_fn
        base_fn = lambda xx, tt, c=None: inner_fn(  # noqa: E731
            xx.to(eval_dtype), tt, c).to(xx.dtype)
    sol = _Solver(make_cfg_eps_fn(base_fn, cond, uncond, guidance_scale),
                  batch=x.shape[0], pp=algorithm_type == "dpmsolver++",
                  model_type=model_type,
                  classifier_grad_fn=_classifier_grad(classifier_fn)
                  if classifier_fn is not None else None,
                  classifier_scale=classifier_scale)
    S = _HostTime(ns)

    if method == "adaptive":
        x = dpm_solver_adaptive(sol, x, ns, t_T, t_0, order=order,
                                solver_type=solver_type, atol=atol, rtol=rtol)
    elif method in ("singlestep", "singlestep_fixed"):
        if method == "singlestep":
            orders = singlestep_orders(steps, order)
            if skip_type == "logSNR":
                ts_outer = get_time_steps(ns, skip_type, t_T, t_0, len(orders))
            else:
                ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
                ts_outer = ts[np.cumsum([0] + orders)]
        else:
            K = steps // order
            orders = [order] * K
            ts_outer = get_time_steps(ns, skip_type, t_T, t_0, K)
        for i, o in enumerate(orders):
            s, t = float(ts_outer[i]), float(ts_outer[i + 1])
            lam = ns.marginal_lambda(get_time_steps(ns, skip_type, s, t, o))
            h = lam[-1] - lam[0]
            if o == 1:
                x, _ = sol.first_update(x, s, t, S)
            elif o == 2:
                x, _, _ = sol.second_update(
                    x, s, t, S, r1=float((lam[1] - lam[0]) / h),
                    solver_type=solver_type)
            else:
                x = sol.third_update(x, s, t, S,
                                     r1=float((lam[1] - lam[0]) / h),
                                     r2=float((lam[2] - lam[0]) / h),
                                     solver_type=solver_type)
    elif method == "multistep":
        assert steps >= order
        ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
        t_prev: List[float] = [float(ts[0])]
        m_prev: list = [sol.model(x, float(ts[0]), S)]
        for step in range(1, order):
            t = float(ts[step])
            x = _ms_update(sol, S, x, m_prev, t_prev, t, step, solver_type)
            t_prev.append(t)
            m_prev.append(sol.model(x, t, S))
        for step in range(order, steps + 1):
            t = float(ts[step])
            step_order = (min(order, steps + 1 - step)
                          if lower_order_final and steps < 10 else order)
            x = _ms_update(sol, S, x, m_prev, t_prev, t, step_order,
                           solver_type)
            t_prev = t_prev[1:] + [t] if len(t_prev) >= order else t_prev + [t]
            if step < steps:
                m_new = sol.model(x, t, S)
                m_prev = (m_prev[1:] + [m_new] if len(m_prev) >= order
                          else m_prev + [m_new])
    else:
        raise ValueError(method)

    if denoise_to_zero:
        # a last Euler step to t = 0 with x0 in place of eps (reference
        # denoise_to_zero_fn :432-439)
        alpha, sigma = float(ns.marginal_alpha(t_0)), float(
            ns.marginal_std(t_0))
        eps = sol.noise_pred(x, S.model_time(t_0, x.shape[0], x.device),
                             alpha, sigma)
        x = (x - sigma * eps) / alpha
    return x


def _ms_update(sol: _Solver, S, x, m_prev, t_prev, t: float, order: int,
               solver_type: str = "dpmsolver"):
    if order == 1:
        return sol.first_update(x, t_prev[-1], t, S, model_s=m_prev[-1])[0]
    if order == 2:
        return sol.multistep_second(x, m_prev[-1], m_prev[-2], t_prev[-2],
                                    t_prev[-1], t, S, solver_type)
    return sol.multistep_third(x, m_prev[-1], m_prev[-2], m_prev[-3],
                               t_prev[-3], t_prev[-2], t_prev[-1], t, S)
