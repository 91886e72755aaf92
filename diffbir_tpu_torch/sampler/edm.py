"""EDM / k-diffusion sampler zoo as host loops.

Counterpart of ``diffbir_tpu/sampler/edm.py``: the sigma schedule from the
discrete alphas (``make_schedule``: sigma0 = 1e4 on the v2.1 schedule, whose
first alpha-bar is set to 1e-8), the eps/v denoiser with c_skip/c_out/c_in
and the nearest-training-timestep model t, the ``x_T * sqrt(1 + sigma0^2)``
start, and the solvers: dpm++_3m_sde (the CLI's default), dpm++_2m_sde and
euler_a on host float64 coefficient rows rounded to fp32, as the JAX scans
read them; euler, heun, dpm_2, dpm_2_a, lms (scipy ``quad`` on the host),
dpm_fast, dpm_adaptive (the eager float64 PID controller), dpm++_2s_a,
dpm++_sde and dpm++_2m unrolled, in float64 host scalars.

Every scalar is a Python float; x stays fp32 and reaches the model's dtype
only inside the model. Noise (``NoiseSource``): the three row solvers draw
at step i where that step's noise coefficient is non-zero, row i of a
``noise_table`` [steps, *x]; dpm++_sde takes rows [steps, 2, *x] (its two
reference noise-sampler calls); the other solvers draw in call order (row
after row of a table), where the JAX solvers call ``jax.random.normal``.

Restoration guidance (``cond_fn``) keeps the JAX package's two semantics.
The row solvers guide each step's denoised output, gated per row by
``guidance_gate`` on the row's model t, so the multistep history holds the
guided values. The unrolled solvers add exactly one euler-equivalent nudge
a step, ``(guide(D) - D) * (1 - sigma_next / sigma_from)`` from the step's
primary evaluation D (``gnudge``), gated by the host model t of
sigma_from; dpm_adaptive too, on each accepted step.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch

from .base import GuidedModel, ModelFn, NoiseSource, Sampler, apply_guidance, guidance_gate

SOLVER_HPARAMS = {
    "euler": ("s_churn", "s_tmin", "s_tmax", "s_noise"),
    "euler_a": ("eta", "s_noise"),
    "heun": ("s_churn", "s_tmin", "s_tmax", "s_noise"),
    "dpm_2": ("s_churn", "s_tmin", "s_tmax", "s_noise"),
    "dpm_2_a": ("eta", "s_noise"),
    "lms": ("order",),
    "dpm_fast": ("eta", "s_noise"),
    "dpm_adaptive": ("order", "eta", "s_noise"),
    "dpm++_2s_a": ("eta", "s_noise"),
    "dpm++_sde": ("eta", "s_noise"),
    "dpm++_2m": (),
    "dpm++_2m_sde": ("eta", "s_noise"),
    "dpm++_3m_sde": ("eta", "s_noise"),
}
ROW_SOLVERS = ("dpm++_3m_sde", "dpm++_2m_sde", "euler_a")


def _ancestral_step(s_from: float, s_to: float, eta: float):
    """sigma_down/up for an ancestral step."""
    if not eta:
        return s_to, 0.0
    su = min(s_to, eta * (s_to**2 * (s_from**2 - s_to**2) / s_from**2) ** 0.5)
    sd = (s_to**2 - su**2) ** 0.5
    return sd, su


def _lms_coeff(order, t, i, j):
    from scipy import integrate

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]


def _nudged(x: torch.Tensor, gnudge, denoised: torch.Tensor, sigma_from: float,
            sigma_to: float) -> torch.Tensor:
    """x plus the step's guidance nudge (``gnudge``) where guidance acts."""
    nudge = None if gnudge is None else gnudge(denoised, sigma_from, sigma_to)
    return x if nudge is None else x + nudge


def _f32(v) -> float:
    """A host coefficient as the fp32 value a JAX table row holds."""
    return float(np.float32(v))


class EDMSampler(Sampler):
    def __init__(self, betas: np.ndarray, parameterization: str, rescale_cfg: bool,
                 solver_type: str, s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0, eta: float = 1.0,
                 order: int = 4):
        super().__init__(betas, parameterization, rescale_cfg)
        if solver_type.startswith("edm_"):
            solver_type = solver_type[len("edm_"):]
        if solver_type not in SOLVER_HPARAMS:
            raise NotImplementedError(f"edm solver {solver_type!r}")
        self.solver_type = solver_type
        self.s_churn, self.s_tmin, self.s_tmax = s_churn, s_tmin, s_tmax
        self.s_noise, self.eta, self.order = s_noise, eta, order

    # ------------------------------------------------------------------ #
    def make_schedule(self, steps: int):
        """Discrete alphas -> sigmas (float64), with a final 0, and the
        training timestep of each."""
        T = len(self.training_alphas_cumprod)
        ts = np.linspace(T - 1, 0, steps, endpoint=False).astype(int)
        ac = self.training_alphas_cumprod[ts].copy()
        ac[0] = 1e-8
        sigmas = ((1 - ac) / ac) ** 0.5
        return np.append(sigmas, 0.0), np.append(ts, 0)

    def _model_t(self, sigma: float, sigmas: np.ndarray, ts: np.ndarray) -> float:
        """sigma -> the training timestep of the nearest schedule sigma."""
        return float(ts[np.abs(sigma - sigmas).argmin()])

    def model_ts(self, steps: int) -> np.ndarray:
        """``_model_t`` always returns an element of the schedule's grid, so
        the grid is a superset for every solver."""
        return np.asarray(self.make_schedule(steps)[1], np.float32)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def sample(self, model_fn: ModelFn, x_T: torch.Tensor, cond: Mapping[str, torch.Tensor],
               uncond: Optional[Mapping[str, torch.Tensor]], cfg_scale: float, steps: int,
               generator: Optional[torch.Generator] = None,
               noise_table: Optional[torch.Tensor] = None, cond_fn=None,
               guidance_target: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoise ``x_T`` (fp32 NHWC, unit variance). Exactly one of
        ``generator`` and ``noise_table`` supplies the noise (see the
        module's notes for the table's layout); ``cond_fn`` guides toward
        ``guidance_target``."""
        sigmas, ts = self.make_schedule(steps)
        use_cfg = uncond is not None and cfg_scale != 1.0
        model = GuidedModel(model_fn, cond, uncond if use_cfg else None)
        x = x_T.float() * float(np.sqrt(1.0 + sigmas[0] ** 2))
        want = {s: (steps, *x.shape) for s in ROW_SOLVERS}
        want["dpm++_sde"] = (steps, 2, *x.shape)
        if noise_table is not None and self.solver_type in want \
                and tuple(noise_table.shape) != want[self.solver_type]:
            raise ValueError(f"noise_table shape {tuple(noise_table.shape)} != "
                             f"{want[self.solver_type]}")
        noise = NoiseSource(x.shape, x.device, generator, noise_table)
        if self.solver_type in ROW_SOLVERS:
            return self._sample_rows(model, x, steps, cfg_scale, noise, cond_fn,
                                     guidance_target)
        v_param = self.parameterization == "v"

        def den(xx, sigma: float, cfg: float) -> torch.Tensor:
            """x0 prediction at host sigma (float64 scalar math)."""
            sigma = float(sigma)
            if v_param:
                c_skip = 1.0 / (sigma**2 + 1.0)
                c_out = -sigma / (sigma**2 + 1.0) ** 0.5
            else:
                c_skip, c_out = 1.0, -sigma
            c_in = 1.0 / (sigma**2 + 1.0) ** 0.5
            x2 = model.batch(xx)
            out = model.raw(x2 * c_in, self._model_t(sigma, sigmas, ts)).float()
            return model.combine(out * c_out + x2 * c_skip, cfg)

        def cfg_at(sigma: float) -> float:
            t_model = self._model_t(sigma, sigmas, ts)
            return float(self.cfg_scales(cfg_scale, np.array([t_model]))[0])

        gnudge = None
        if cond_fn is not None:
            def gnudge(denoised, sigma_from: float, sigma_to: float):
                """The step's guidance displacement, or None where the gate
                is off."""
                t_model = self._model_t(sigma_from, sigmas, ts)
                if not guidance_gate(cond_fn, np.array([t_model]))[0]:
                    return None
                guided = apply_guidance(cond_fn, guidance_target, denoised, True)
                return (guided - denoised) * (1.0 - float(sigma_to) / float(sigma_from))

        solver = getattr(self, "_solve_" + self.solver_type.replace("+", "p"))
        return solver(den, x, sigmas, cfg_at, noise, gnudge)

    # ------------------------------------------------------------------ #
    # the row solvers: per-step coefficients on the host, fp32 as JAX reads
    # ------------------------------------------------------------------ #
    def _denoiser_rows(self, sigmas, ts, cfg_scale, v_param, n):
        rows = {k: np.zeros(n) for k in ("c_skip", "c_out", "c_in", "t_model", "cfg")}
        for i in range(n):
            sig = sigmas[i]
            if v_param:
                rows["c_skip"][i] = 1.0 / (sig**2 + 1.0)
                rows["c_out"][i] = -sig / (sig**2 + 1.0) ** 0.5
            else:
                rows["c_skip"][i] = 1.0
                rows["c_out"][i] = -sig
            rows["c_in"][i] = 1.0 / (sig**2 + 1.0) ** 0.5
            t_model = self._model_t(sig, sigmas, ts)
            rows["t_model"][i] = t_model
            rows["cfg"][i] = float(self.cfg_scales(cfg_scale, np.array([t_model]))[0])
        return rows

    def _rows_2m_sde(self, sigmas, ts, cfg_scale, v_param):
        n = len(sigmas) - 1
        eta, s_noise = self.eta, self.s_noise
        rows = self._denoiser_rows(sigmas, ts, cfg_scale, v_param, n)
        for k in ("a", "b", "coefA", "coefB", "noise"):
            rows[k] = np.zeros(n)
        h_last = None
        for i in range(n):
            if sigmas[i + 1] == 0:
                rows["a"][i], rows["b"][i] = 0.0, 1.0
                continue
            t, s = -np.log(sigmas[i]), -np.log(sigmas[i + 1])
            h = s - t
            eta_h = eta * h
            rows["a"][i] = (sigmas[i + 1] / sigmas[i]) * np.exp(-eta_h)
            rows["b"][i] = -np.expm1(-h - eta_h)
            if h_last is not None:
                rows["coefA"][i] = 0.5 * (-np.expm1(-h - eta_h)) / (h_last / h)
            if eta:
                rows["noise"][i] = sigmas[i + 1] * np.sqrt(-np.expm1(-2 * eta_h)) * s_noise
            h_last = h
        return rows

    def _rows_euler_a(self, sigmas, ts, cfg_scale, v_param):
        n = len(sigmas) - 1
        rows = self._denoiser_rows(sigmas, ts, cfg_scale, v_param, n)
        for k in ("a", "b", "coefA", "coefB", "noise"):
            rows[k] = np.zeros(n)
        for i in range(n):
            sd, su = _ancestral_step(sigmas[i], sigmas[i + 1], self.eta)
            ratio = (sd - sigmas[i]) / sigmas[i]
            rows["a"][i] = 1.0 + ratio
            rows["b"][i] = -ratio
            if sigmas[i + 1] > 0:
                rows["noise"][i] = self.s_noise * su
        return rows

    def _rows_3m_sde(self, sigmas, ts, cfg_scale, v_param):
        n = len(sigmas) - 1
        eta, s_noise = self.eta, self.s_noise
        rows = self._denoiser_rows(sigmas, ts, cfg_scale, v_param, n)
        for k in ("a", "b", "coefA", "coefB", "noise"):
            rows[k] = np.zeros(n)
        h_1 = h_2 = None
        for i in range(n):
            if sigmas[i + 1] == 0:
                rows["a"][i], rows["b"][i] = 0.0, 1.0  # x <- denoised
                continue
            t, s = -np.log(sigmas[i]), -np.log(sigmas[i + 1])
            h = s - t
            h_eta = h * (eta + 1)
            rows["a"][i] = np.exp(-h_eta)
            rows["b"][i] = -np.expm1(-h_eta)
            phi_2 = np.expm1(-h_eta) / h_eta + 1.0
            phi_3 = phi_2 / h_eta - 0.5
            if h_2 is not None:
                r0, r1 = h_1 / h, h_2 / h
                k = r0 / (r0 + r1)
                rows["coefA"][i] = (phi_2 * (1 + k) - phi_3 / (r0 + r1)) / r0
                rows["coefB"][i] = (-phi_2 * k + phi_3 / (r0 + r1)) / r1
            elif h_1 is not None:
                rows["coefA"][i] = phi_2 / (h_1 / h)
            if eta:
                rows["noise"][i] = sigmas[i + 1] * np.sqrt(-np.expm1(-2 * h * eta)) * s_noise
            h_1, h_2 = h, h_1
        return rows

    def make_tables(self, steps: int, cfg_scale: float) -> dict:
        """The row solver's per-step coefficients as the fp32 values of the
        JAX scan's tables (Python floats), one list per name."""
        if self.solver_type not in ROW_SOLVERS:
            raise NotImplementedError(f"no coefficient rows for {self.solver_type}")
        sigmas, ts = self.make_schedule(steps)
        build = {"dpm++_3m_sde": self._rows_3m_sde, "dpm++_2m_sde": self._rows_2m_sde,
                 "euler_a": self._rows_euler_a}[self.solver_type]
        rows = build(sigmas, ts, cfg_scale, self.parameterization == "v")
        return {k: [_f32(v) for v in vals] for k, vals in rows.items()}

    def _sample_rows(self, model: GuidedModel, x, steps: int, cfg_scale: float,
                     noise: NoiseSource, cond_fn=None, guidance_target=None):
        """x_{i+1} = a x + b D + A (D - D1) + B (D1 - D2) + noise z, with D
        the step's x0 prediction and D1, D2 the two before (dpm++_3m_sde;
        dpm++_2m_sde has B = 0, euler_a A = B = 0). A term whose
        coefficient is 0 is skipped (exact: it adds 0)."""
        tables = self.make_tables(steps, cfg_scale)
        g_on = (guidance_gate(cond_fn, tables["t_model"]) if cond_fn is not None
                else np.zeros(steps, bool))
        d1 = d2 = None
        for i in range(steps):
            r = {k: v[i] for k, v in tables.items()}
            x2 = model.batch(x)
            out = model.raw(x2 * r["c_in"], r["t_model"]).float()
            denoised = model.combine(out * r["c_out"] + x2 * r["c_skip"], r["cfg"])
            denoised = apply_guidance(cond_fn, guidance_target, denoised, g_on[i])
            x_new = r["b"] * denoised if r["a"] == 0.0 else r["a"] * x + r["b"] * denoised
            if r["coefA"]:
                x_new = x_new + r["coefA"] * (denoised - d1)
            if r["coefB"]:
                x_new = x_new + r["coefB"] * (d1 - d2)
            if r["noise"]:
                x_new = x_new + r["noise"] * noise.draw(i)
            x, d1, d2 = x_new, denoised, d1
        return x

    # ------------------------------------------------------------------ #
    # unrolled solvers (float64 host scalars)
    # ------------------------------------------------------------------ #
    def _churn(self, n, sigma):
        if self.s_tmin <= sigma <= self.s_tmax:
            return min(self.s_churn / (n - 1), 2**0.5 - 1)
        return 0.0

    def _churned(self, x, sigma, n, noise):
        """(x, sigma_hat) after the s_churn noise step."""
        gamma = self._churn(n, sigma)
        sigma_hat = float(sigma * (gamma + 1))
        if gamma > 0:
            eps = noise.draw() * self.s_noise
            x = x + eps * float((sigma_hat**2 - sigma**2) ** 0.5)
        return x, sigma_hat

    def _solve_euler(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        for i in range(n):
            x, sigma_hat = self._churned(x, sigmas[i], n + 1, noise)
            denoised = den(x, sigma_hat, cfg_at(sigma_hat))
            d = (x - denoised) / sigma_hat
            x = x + d * float(sigmas[i + 1] - sigma_hat)
            x = _nudged(x, gnudge, denoised, sigma_hat, sigmas[i + 1])
        return x

    def _solve_heun(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        for i in range(n):
            x, sigma_hat = self._churned(x, sigmas[i], n + 1, noise)
            denoised = den(x, sigma_hat, cfg_at(sigma_hat))
            d = (x - denoised) / sigma_hat
            dt = float(sigmas[i + 1] - sigma_hat)
            if sigmas[i + 1] == 0:
                x = x + d * dt
            else:
                s1 = float(sigmas[i + 1])
                x_2 = x + d * dt
                d_2 = (x_2 - den(x_2, s1, cfg_at(s1))) / s1
                x = x + (d + d_2) / 2 * dt
            x = _nudged(x, gnudge, denoised, sigma_hat, sigmas[i + 1])
        return x

    def _solve_dpm_2(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        for i in range(n):
            x, sigma_hat = self._churned(x, sigmas[i], n + 1, noise)
            denoised = den(x, sigma_hat, cfg_at(sigma_hat))
            d = (x - denoised) / sigma_hat
            if sigmas[i + 1] == 0:
                x = x + d * float(sigmas[i + 1] - sigma_hat)
            else:
                sigma_mid = float(np.exp(np.log(sigma_hat) * 0.5 + np.log(sigmas[i + 1]) * 0.5))
                x_2 = x + d * (sigma_mid - sigma_hat)
                d_2 = (x_2 - den(x_2, sigma_mid, cfg_at(sigma_mid))) / sigma_mid
                x = x + d_2 * float(sigmas[i + 1] - sigma_hat)
            x = _nudged(x, gnudge, denoised, sigma_hat, sigmas[i + 1])
        return x

    def _solve_dpm_2_a(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        for i in range(n):
            denoised = den(x, sigmas[i], cfg_at(sigmas[i]))
            sd, su = _ancestral_step(sigmas[i], sigmas[i + 1], self.eta)
            d = (x - denoised) / float(sigmas[i])
            if sd == 0:
                x = x + d * float(sd - sigmas[i])
                x = _nudged(x, gnudge, denoised, sigmas[i], sd)
            else:
                sigma_mid = float(np.exp(np.log(sigmas[i]) * 0.5 + np.log(sd) * 0.5))
                x_2 = x + d * float(sigma_mid - sigmas[i])
                d_2 = (x_2 - den(x_2, sigma_mid, cfg_at(sigma_mid))) / sigma_mid
                x = x + d_2 * float(sd - sigmas[i])
                x = _nudged(x, gnudge, denoised, sigmas[i], sd)
                x = x + noise.draw() * self.s_noise * float(su)
        return x

    def _solve_lms(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        ds = []
        for i in range(n):
            denoised = den(x, sigmas[i], cfg_at(sigmas[i]))
            ds.append((x - denoised) / float(sigmas[i]))
            if len(ds) > self.order:
                ds.pop(0)
            cur_order = min(i + 1, self.order)
            coeffs = [float(_lms_coeff(cur_order, sigmas, i, j)) for j in range(cur_order)]
            x = x + sum(c * d_ for c, d_ in zip(coeffs, reversed(ds)))
            x = _nudged(x, gnudge, denoised, sigmas[i], sigmas[i + 1])
        return x

    # -- k-diffusion DPM-Solver (eps-parameterised, t = -log sigma) -------- #
    def _kd_eps(self, den, x, t, cfg_at):
        sig = float(np.exp(-t))
        return (x - den(x, sig, cfg_at(sig))) / sig

    def _kd_step(self, den, x, t, t_next, order, cfg_at, eps0=None, r1=None, eps_r1=None):
        """dpm_solver_{1,2,3}_step; eps0 / eps_r1 may be shared between
        steps (the reference's eps_cache)."""
        h = t_next - t

        def sig(tt):
            return float(np.exp(-tt))

        em = float(np.expm1(h))
        eps = eps0 if eps0 is not None else self._kd_eps(den, x, t, cfg_at)
        if order == 1:
            return x - sig(t_next) * em * eps
        if order == 2:
            r1 = 0.5 if r1 is None else r1
            s1 = t + r1 * h
            if eps_r1 is None:
                u1 = x - sig(s1) * float(np.expm1(r1 * h)) * eps
                eps_r1 = self._kd_eps(den, u1, s1, cfg_at)
            return (x - sig(t_next) * em * eps
                    - sig(t_next) / (2 * r1) * em * (eps_r1 - eps))
        r1, r2 = 1 / 3, 2 / 3
        s1, s2 = t + r1 * h, t + r2 * h
        if eps_r1 is None:
            u1 = x - sig(s1) * float(np.expm1(r1 * h)) * eps
            eps_r1 = self._kd_eps(den, u1, s1, cfg_at)
        em2 = float(np.expm1(r2 * h))
        u2 = (x - sig(s2) * em2 * eps
              - sig(s2) * (r2 / r1) * (em2 / (r2 * h) - 1) * (eps_r1 - eps))
        eps_r2 = self._kd_eps(den, u2, s2, cfg_at)
        return (x - sig(t_next) * em * eps
                - sig(t_next) / r2 * (em / h - 1) * (eps_r2 - eps))

    def _solve_dpm_fast(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        """DPM-Solver-Fast, fixed step."""
        pos = sigmas[sigmas > 0]
        t_start, t_end = -np.log(pos.max()), -np.log(pos.min())
        n = len(sigmas) - 1
        m = n // 3 + 1
        tgrid = np.linspace(t_start, t_end, m + 1)
        orders = [3] * (m - 2) + [2, 1] if n % 3 == 0 else [3] * (m - 1) + [n % 3]
        for i, o in enumerate(orders):
            t, t_next = float(tgrid[i]), float(tgrid[i + 1])
            if self.eta:
                sd, _ = _ancestral_step(np.exp(-t), np.exp(-t_next), self.eta)
                t_next_ = min(t_end, -np.log(sd))
                su = max(np.exp(-2 * t_next) - np.exp(-2 * t_next_), 0.0) ** 0.5
            else:
                t_next_, su = t_next, 0.0
            eps0 = self._kd_eps(den, x, t, cfg_at)
            x_new = self._kd_step(den, x, t, float(t_next_), o, cfg_at, eps0=eps0)
            if gnudge is not None:
                sig = float(np.exp(-t))
                x_new = _nudged(x_new, gnudge, x - sig * eps0, sig, float(np.exp(-t_next_)))
            x = x_new
            if su > 0:
                x = x + float(su) * self.s_noise * noise.draw()
        return x

    def _solve_dpm_adaptive(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        """DPM-Solver-12/23 with PID-controlled adaptive steps: the eager
        float64 controller of the JAX solver (the error norm read back once
        a try)."""
        if self.order == 4:  # the class default stands for "unset": 3
            order = 3
        elif self.order in (2, 3):
            order = self.order
        else:
            raise ValueError("dpm_adaptive: order should be 2 or 3")
        rtol, atol = 0.05, 0.0078
        pcoeff, icoeff, dcoeff, accept_safety = 0.0, 1.0, 0.0, 0.81
        eta, s_noise = self.eta, self.s_noise
        pos = sigmas[sigmas > 0]
        t_start, t_end = -np.log(pos.max()), -np.log(pos.min())
        h = 0.05
        b1 = (pcoeff + icoeff + dcoeff) / (1.5 if eta else order)
        b2 = -(pcoeff + 2 * dcoeff) / (1.5 if eta else order)
        b3 = dcoeff / (1.5 if eta else order)
        errs: list = []
        s = t_start
        x_prev = x
        while s < t_end - 1e-5:
            t = min(t_end, s + h)
            if eta:
                sd, _ = _ancestral_step(np.exp(-s), np.exp(-t), eta)
                t_ = min(t_end, -np.log(sd))
                su = max(np.exp(-2 * t) - np.exp(-2 * t_), 0.0) ** 0.5
            else:
                t_, su = t, 0.0
            s_, t_ = float(s), float(t_)
            eps0 = self._kd_eps(den, x, s_, cfg_at)
            if order == 2:
                x_low = self._kd_step(den, x, s_, t_, 1, cfg_at, eps0=eps0)
                x_high = self._kd_step(den, x, s_, t_, 2, cfg_at, eps0=eps0)
            else:
                hh = t_ - s_
                s1 = s_ + hh / 3
                u1 = x - float(np.exp(-s1)) * float(np.expm1(hh / 3)) * eps0
                eps_r1 = self._kd_eps(den, u1, s1, cfg_at)
                x_low = self._kd_step(den, x, s_, t_, 2, cfg_at, eps0=eps0, r1=1 / 3,
                                      eps_r1=eps_r1)
                x_high = self._kd_step(den, x, s_, t_, 3, cfg_at, eps0=eps0, eps_r1=eps_r1)
            delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
            error = float(torch.linalg.vector_norm((x_low - x_high) / delta)
                          / (x.numel() ** 0.5))
            inv_err = 1.0 / (error + 1e-8)
            if not errs:
                errs = [inv_err, inv_err, inv_err]
            errs[0] = inv_err
            factor = errs[0] ** b1 * errs[1] ** b2 * errs[2] ** b3
            factor = 1 + math.atan(factor - 1)
            if factor >= accept_safety:
                errs[2], errs[1] = errs[1], errs[0]
                x_prev = x_low
                if gnudge is not None:
                    sig = float(np.exp(-s_))
                    x_high = _nudged(x_high, gnudge, x - sig * eps0, sig, float(np.exp(-t_)))
                x = x_high
                if su > 0:
                    x = x + float(su) * s_noise * noise.draw()
                s = t
            h *= factor
        return x

    def _solve_dpmpp_2s_a(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        for i in range(n):
            denoised = den(x, sigmas[i], cfg_at(sigmas[i]))
            sd, su = _ancestral_step(sigmas[i], sigmas[i + 1], self.eta)
            if sd == 0:
                d = (x - denoised) / float(sigmas[i])
                x = x + d * float(sd - sigmas[i])
            else:
                t, t_next = -np.log(sigmas[i]), -np.log(sd)
                h = t_next - t
                s = t + 0.5 * h
                x_2 = float(np.exp(-s + t)) * x - float(np.expm1(-h * 0.5)) * denoised
                sig_s = float(np.exp(-s))
                denoised_2 = den(x_2, sig_s, cfg_at(sig_s))
                x = float(np.exp(-t_next + t)) * x - float(np.expm1(-h)) * denoised_2
            x = _nudged(x, gnudge, denoised, sigmas[i], sd)
            if sigmas[i + 1] > 0:
                x = x + noise.draw() * self.s_noise * float(su)
        return x

    def _solve_dpmpp_sde(self, den, x, sigmas, cfg_at, noise, gnudge=None, r=0.5):
        n = len(sigmas) - 1
        for i in range(n):
            denoised = den(x, sigmas[i], cfg_at(sigmas[i]))
            if sigmas[i + 1] == 0:
                d = (x - denoised) / float(sigmas[i])
                x = x + d * float(sigmas[i + 1] - sigmas[i])
                x = _nudged(x, gnudge, denoised, sigmas[i], sigmas[i + 1])
                continue
            t, t_next = -np.log(sigmas[i]), -np.log(sigmas[i + 1])
            h = t_next - t
            s = t + h * r
            fac = 1 / (2 * r)
            sig_s = float(np.exp(-s))
            if noise.table is not None:
                n1, n2 = noise.draw(i).unbind(0)  # the step's two reference draws
            else:
                # Brownian increments over overlapping intervals, from two
                # independent sub-increments (sigma_i -> sig_s -> sigma_next)
                a, b = noise.draw(), noise.draw()
                v1 = abs(sigmas[i] - sig_s)
                v2 = abs(sig_s - sigmas[i + 1])
                n1 = a
                n2 = (a * float(np.sqrt(v1)) + b * float(np.sqrt(v2))) / float(np.sqrt(v1 + v2))
            sd, su = _ancestral_step(sigmas[i], sig_s, self.eta)
            s_ = -np.log(sd)
            x_2 = float(np.exp(-(s_ - t))) * x - float(np.expm1(t - s_)) * denoised
            x_2 = x_2 + n1 * self.s_noise * float(su)
            denoised_2 = den(x_2, sig_s, cfg_at(sig_s))
            sd, su = _ancestral_step(sigmas[i], sigmas[i + 1], self.eta)
            t_next_ = -np.log(sd)
            denoised_d = (1 - fac) * denoised + fac * denoised_2
            x = float(np.exp(-(t_next_ - t))) * x - float(np.expm1(t - t_next_)) * denoised_d
            x = x + n2 * self.s_noise * float(su)
            x = _nudged(x, gnudge, denoised, sigmas[i], sigmas[i + 1])
        return x

    def _solve_dpmpp_2m(self, den, x, sigmas, cfg_at, noise, gnudge=None):
        n = len(sigmas) - 1
        old_denoised = None
        for i in range(n):
            denoised = den(x, sigmas[i], cfg_at(sigmas[i]))
            if sigmas[i + 1] == 0:
                x = denoised  # sigma_fn(t_next) = 0 collapses the update
            else:
                t, t_next = -np.log(sigmas[i]), -np.log(sigmas[i + 1])
                h = t_next - t
                ratio, em = float(np.exp(-h)), float(np.expm1(-h))
                if old_denoised is None:
                    x = ratio * x - em * denoised
                else:
                    h_last = t - (-np.log(sigmas[i - 1]))
                    r_ = float(h_last / h)
                    denoised_d = (1 + 1 / (2 * r_)) * denoised - (1 / (2 * r_)) * old_denoised
                    x = ratio * x - em * denoised_d
            x = _nudged(x, gnudge, denoised, sigmas[i], sigmas[i + 1])
            old_denoised = denoised
        return x
