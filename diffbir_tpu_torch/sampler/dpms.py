"""DPM-Solver / DPM-Solver++ (multistep and singlestep).

Counterpart of ``diffbir_tpu/sampler/dpms.py``: the discrete VP noise
schedule on the host (``_DiscreteVPSchedule``: log-alpha interpolation, the
numerical lambda clip, model t = (t - 1/N) * 1000), the ``model_spec``
strings ("dpm++_m2" -> dpmsolver++, multistep, order 2), time-uniform steps
with lower-order warm-up and (below 10 steps) cool-down, and the
singlestep DPM-Solver-fast block orders. One model call per step (batched
CFG); every coefficient is a float64 host scalar. Exact math at every size:
the JAX package's fallback to latent tiling above 40960 tokens (a TPU
envelope guard) is not carried over.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .base import GuidedModel, ModelFn, Sampler


class _DiscreteVPSchedule:
    """Host-side NoiseScheduleVP(schedule='discrete'); every method returns
    a Python float for a float t."""

    def __init__(self, betas: np.ndarray, clipped_lambda: float = -5.1):
        # numerical clip: drop trailing entries with lambda < clipped_lambda
        # (a zero-terminal-SNR schedule's last beta is 1: log 0 = -inf there)
        with np.errstate(divide="ignore", invalid="ignore"):
            log_alphas = 0.5 * np.cumsum(np.log(1.0 - betas))
            log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
            lambs = log_alphas - log_sigmas
        idx = np.searchsorted(np.flip(lambs), clipped_lambda)
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        self.log_alpha_array = log_alphas
        self.total_N = len(log_alphas)
        self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
        self.T = 1.0

    def log_alpha(self, t):
        return float(np.interp(t, self.t_array, self.log_alpha_array))

    def alpha(self, t):
        return float(np.exp(self.log_alpha(t)))

    def sigma(self, t):
        return float(np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t))))

    def lam(self, t):
        la = self.log_alpha(t)
        return float(la - 0.5 * np.log(1.0 - np.exp(2.0 * la)))

    def model_t(self, t):
        """Continuous t -> discrete model timestep input."""
        return (t - 1.0 / self.total_N) * 1000.0


def _em(v) -> float:
    return float(np.expm1(v))


class DPMSolverSampler(Sampler):
    def __init__(self, betas, parameterization, rescale_cfg, model_spec: str):
        super().__init__(betas, parameterization, rescale_cfg)
        solver, mo = model_spec.split("_")
        self.algorithm = {"dpm": "dpmsolver", "dpm++": "dpmsolver++"}[solver]
        self.method = {"s": "singlestep", "m": "multistep"}[mo[0]]
        self.order = int(mo[1])

    def model_ts(self, steps: int) -> np.ndarray:
        """Every model timestep: the outer grid and the singlestep inner
        points, by ``sample``'s own arithmetic."""
        ns = _DiscreteVPSchedule(self.training_betas)
        fine = np.linspace(ns.T, 1.0 / ns.total_N, steps + 1)
        t_cont = list(fine)
        if self.method == "singlestep":
            orders = self._singlestep_orders(steps)
            outer = fine[np.cumsum([0] + orders)]
            for blk, o in enumerate(orders):
                if o > 1:
                    inner = np.linspace(outer[blk], outer[blk + 1], o + 1)
                    t_cont.extend(float(v) for v in inner[1:-1])
        return np.asarray([ns.model_t(t) for t in t_cont], np.float32)

    def _singlestep_orders(self, steps: int):
        order = self.order
        if order == 3:
            K = steps // 3 + 1
            return {0: [3] * (K - 2) + [2, 1], 1: [3] * (K - 1) + [1],
                    2: [3] * (K - 1) + [2]}[steps % 3]
        if order == 2:
            K = steps // 2
            return [2] * K if steps % 2 == 0 else [2] * K + [1]
        return [1] * steps

    @torch.no_grad()
    def sample(self, model_fn: ModelFn, x_T: torch.Tensor, cond: Mapping[str, torch.Tensor],
               uncond: Optional[Mapping[str, torch.Tensor]], cfg_scale: float, steps: int,
               generator: Optional[torch.Generator] = None,
               noise_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic: ``generator`` and ``noise_table`` are not read."""
        ns = _DiscreteVPSchedule(self.training_betas)
        ts = np.linspace(ns.T, 1.0 / ns.total_N, steps + 1)
        v_param = self.parameterization == "v"
        data_pred = self.algorithm == "dpmsolver++"
        model = GuidedModel(model_fn, cond, uncond if cfg_scale != 1.0 else None)

        def eval_model(x, t_cont: float):
            """x0 (dpmsolver++) or eps (dpmsolver) prediction at time t."""
            mt = ns.model_t(t_cont)
            alpha, sigma = ns.alpha(t_cont), ns.sigma(t_cont)
            cur_cfg = float(self.cfg_scales(cfg_scale, np.array([mt]))[0])
            out = model(x, float(np.float32(mt)), cur_cfg).float()
            eps = alpha * out + sigma * x if v_param else out
            return (x - sigma * eps) / alpha if data_pred else eps

        def first_update(x, s, t, model_s):
            h = ns.lam(t) - ns.lam(s)
            if data_pred:
                return (ns.sigma(t) / ns.sigma(s)) * x - ns.alpha(t) * _em(-h) * model_s
            return (float(np.exp(ns.log_alpha(t) - ns.log_alpha(s))) * x
                    - ns.sigma(t) * _em(h) * model_s)

        def second_update(x, m_prev, t_prev, t):
            (m1, m0), (t1, t0_) = m_prev[-2:], t_prev[-2:]
            l1, l0, lt = ns.lam(t1), ns.lam(t0_), ns.lam(t)
            h0, h = l0 - l1, lt - l0
            r0 = h0 / h
            D1_0 = (1.0 / r0) * (m0 - m1)
            if data_pred:
                phi_1 = _em(-h)
                return ((ns.sigma(t) / ns.sigma(t0_)) * x - ns.alpha(t) * phi_1 * m0
                        - 0.5 * ns.alpha(t) * phi_1 * D1_0)
            phi_1 = _em(h)
            return (float(np.exp(ns.log_alpha(t) - ns.log_alpha(t0_))) * x
                    - ns.sigma(t) * phi_1 * m0 - 0.5 * ns.sigma(t) * phi_1 * D1_0)

        def third_update(x, m_prev, t_prev, t):
            m2, m1, m0 = m_prev[-3:]
            t2, t1, t0_ = t_prev[-3:]
            l2, l1, l0, lt = ns.lam(t2), ns.lam(t1), ns.lam(t0_), ns.lam(t)
            h1, h0, h = l1 - l2, l0 - l1, lt - l0
            r0, r1 = h0 / h, h1 / h
            D1_0 = (1.0 / r0) * (m0 - m1)
            D1_1 = (1.0 / r1) * (m1 - m2)
            D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
            D2 = (1.0 / (r0 + r1)) * (D1_0 - D1_1)
            if data_pred:
                phi_1 = _em(-h)
                phi_2 = phi_1 / h + 1.0
                phi_3 = phi_2 / h - 0.5
                return ((ns.sigma(t) / ns.sigma(t0_)) * x - ns.alpha(t) * phi_1 * m0
                        + ns.alpha(t) * phi_2 * D1 - ns.alpha(t) * phi_3 * D2)
            phi_1 = _em(h)
            phi_2 = phi_1 / h - 1.0
            phi_3 = phi_2 / h - 0.5
            return (float(np.exp(ns.log_alpha(t) - ns.log_alpha(t0_))) * x
                    - ns.sigma(t) * phi_1 * m0 - ns.sigma(t) * phi_2 * D1
                    - ns.sigma(t) * phi_3 * D2)

        def update(x, m_prev, t_prev, t, order):
            if order == 1:
                return first_update(x, t_prev[-1], t, m_prev[-1])
            if order == 2:
                return second_update(x, m_prev, t_prev, t)
            return third_update(x, m_prev, t_prev, t)

        if self.method == "singlestep":
            return self._sample_singlestep(eval_model, ns, x_T.float(), steps)

        order = self.order
        x = x_T.float()
        t_prev = [float(ts[0])]
        m_prev = [eval_model(x, float(ts[0]))]
        for step in range(1, order):  # warm-up with increasing order
            t = float(ts[step])
            x = update(x, m_prev, t_prev, t, step)
            t_prev.append(t)
            m_prev.append(eval_model(x, t))
        for step in range(order, steps + 1):
            t = float(ts[step])
            step_order = min(order, steps + 1 - step) if steps < 10 else order
            x = update(x, m_prev, t_prev, t, step_order)
            t_prev = t_prev[1:] + [t] if len(t_prev) >= order else t_prev + [t]
            if step < steps:
                m_prev = (m_prev[1:] if len(m_prev) >= order else m_prev) + [eval_model(x, t)]
        return x

    def _sample_singlestep(self, eval_model, ns, x, steps):
        """Singlestep DPM-Solver-fast: mixed-order blocks using all NFE."""
        orders = self._singlestep_orders(steps)
        fine = np.linspace(ns.T, 1.0 / ns.total_N, steps + 1)
        outer = fine[np.cumsum([0] + orders)]
        data_pred = self.algorithm == "dpmsolver++"
        sigma, alpha = ns.sigma, ns.alpha

        def decay(a, b):  # exp(log_alpha(a) - log_alpha(b))
            return float(np.exp(ns.log_alpha(a) - ns.log_alpha(b)))

        for blk, o in enumerate(orders):
            s, t = float(outer[blk]), float(outer[blk + 1])
            h = ns.lam(t) - ns.lam(s)
            model_s = eval_model(x, s)
            if o == 1:
                if data_pred:
                    x = (sigma(t) / sigma(s)) * x - alpha(t) * _em(-h) * model_s
                else:
                    x = decay(t, s) * x - sigma(t) * _em(h) * model_s
                continue
            # r1/r2 from time-uniform inner points
            inner = np.linspace(s, t, o + 1)
            lam_inner = np.array([ns.lam(ti) for ti in inner])
            r1 = float((lam_inner[1] - lam_inner[0]) / h)
            s1 = float(inner[1])
            if data_pred:
                x_s1 = (sigma(s1) / sigma(s)) * x - alpha(s1) * _em(-r1 * h) * model_s
            else:
                x_s1 = decay(s1, s) * x - sigma(s1) * _em(r1 * h) * model_s
            model_s1 = eval_model(x_s1, s1)
            if o == 2:
                if data_pred:
                    phi_1 = _em(-h)
                    x = ((sigma(t) / sigma(s)) * x - alpha(t) * phi_1 * model_s
                         - (0.5 / r1) * alpha(t) * phi_1 * (model_s1 - model_s))
                else:
                    phi_1 = _em(h)
                    x = (decay(t, s) * x - sigma(t) * phi_1 * model_s
                         - (0.5 / r1) * sigma(t) * phi_1 * (model_s1 - model_s))
                continue
            r2 = float((lam_inner[2] - lam_inner[0]) / h)
            s2 = float(inner[2])
            if data_pred:
                phi_12 = _em(-r2 * h)
                phi_22 = phi_12 / (r2 * h) + 1.0
                x_s2 = ((sigma(s2) / sigma(s)) * x - alpha(s2) * phi_12 * model_s
                        + (r2 / r1) * alpha(s2) * phi_22 * (model_s1 - model_s))
                model_s2 = eval_model(x_s2, s2)
                phi_1 = _em(-h)
                phi_2 = phi_1 / h + 1.0
                x = ((sigma(t) / sigma(s)) * x - alpha(t) * phi_1 * model_s
                     + (1.0 / r2) * alpha(t) * phi_2 * (model_s2 - model_s))
            else:
                phi_12 = _em(r2 * h)
                phi_22 = phi_12 / (r2 * h) - 1.0
                x_s2 = (decay(s2, s) * x - sigma(s2) * phi_12 * model_s
                        - (r2 / r1) * sigma(s2) * phi_22 * (model_s1 - model_s))
                model_s2 = eval_model(x_s2, s2)
                phi_1 = _em(h)
                phi_2 = phi_1 / h - 1.0
                x = (decay(t, s) * x - sigma(t) * phi_1 * model_s
                     - (1.0 / r2) * sigma(t) * phi_2 * (model_s2 - model_s))
        return x
