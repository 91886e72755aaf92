"""Every sampler of the CLI against the JAX package, fp32 on the CPU.

A fixed model function, linear in x (and in the condition), stands in for
the UNet: the same fp32 operations on both sides (no reduction, whose sum
order would differ; the v2.1 start at sigma 1e4 amplifies a last-bit
difference), JAX on its [B] timestep vector, the port on the vector it
makes from the host value. Each entry of ``SAMPLER_CHOICES`` runs on the
v2.1 schedule (v, zero terminal SNR) and on the v1 schedule (eps), each with
CFG 4.0 and without, at the CLI's defaults (eta 1, 10 steps), plus the churn
variants of euler, heun and dpm_2. Noise: the row solvers and dpm++_sde on
a ``noise_table`` both sides read; the unrolled ancestral solvers' draws
(``jax.random.normal`` in JAX) are the rows of one table, handed to the JAX
solver in call order and to the port as its ``noise_table``; the spaced
sampler's are JAX's own key chain. Limit: max abs error <= 1e-5 x max|ref|,
except for dpm_adaptive, 1e-3 x max|ref|: its step-size controller reads
the difference of two solutions of a step, so a last-bit difference of the
state (fp32 sums in another order) becomes a ~1e-4 relative difference of
the error estimate and of the next step size (measured: up to 9e-5 x
max|ref| at the end); the JAX package holds its own eager and jitted
versions of it to 2e-3.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.pipeline import build_sampler as jax_build_sampler
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu_torch.pipeline import SAMPLER_CHOICES, build_sampler
from diffbir_tpu_torch.sampler.base import timestep_vector
from diffbir_tpu_torch.sampler.edm import ROW_SOLVERS
from diffbir_tpu_torch.schedule import Schedule
from inference import SAMPLER_CHOICES as JAX_SAMPLER_CHOICES

TOL, ADAPTIVE_TOL = 1e-5, 1e-3
STEPS = 10
CLI_KW = dict(eta=1.0, s_churn=0.0, s_tmin=0.0, s_tmax=300.0, s_noise=1.0, order=4)
SHAPE = (1, 4, 4, 4)
CTX = (1, 77, 8)


def _model_jax(x, t, c):
    return 0.8 * x * (1.0 - t[:, None, None, None] / 2000.0) + 0.3 * c["c_img"] \
        + 0.5 * c["c_txt"][:, 0, 0][:, None, None, None]


def _model_torch(x, t, c):
    t = timestep_vector(t, x)[:, None, None, None]  # fp32, as the model's input
    return 0.8 * x * (1.0 - t / 2000.0) + 0.3 * c["c_img"] \
        + 0.5 * c["c_txt"][:, 0, 0][:, None, None, None]


def _schedules(name):
    v = name == "v21"
    kw = dict(linear_start=0.00085, linear_end=0.0120, parameterization="v" if v else "eps",
              zero_snr=v)
    return (JaxSchedule.create(timesteps=1000, beta_schedule="linear", **kw),
            Schedule.create(1000, **kw))


def _solver(sampler_type):
    return sampler_type[len("edm_"):] if sampler_type.startswith("edm_") else None


class _Draws:
    """jax.random.normal replaced by the rows of a table, in call order."""

    def __init__(self, table):
        self.table, self.used = table, 0

    def __call__(self, key, shape, dtype=jnp.float32):
        assert tuple(shape) == self.table.shape[1:], shape
        row = self.table[self.used]
        self.used += 1
        return jnp.asarray(row, dtype)


CASES = ([(s, sched, cfg, {}) for sched in ("v21", "eps") for cfg in (4.0, 1.0)
          for s in SAMPLER_CHOICES]
         + [(s, "v21", 4.0, dict(s_churn=1.0)) for s in ("edm_euler", "edm_heun", "edm_dpm_2")])


def test_sampler_choices_match_the_jax_cli():
    assert SAMPLER_CHOICES == JAX_SAMPLER_CHOICES


@pytest.mark.parametrize("sampler_type,sched,cfg,extra", CASES,
                         ids=[f"{s}-{n}-cfg{c:g}{'-churn' if e else ''}" for s, n, c, e in CASES])
def test_sampler_matches_jax(sampler_type, sched, cfg, extra, monkeypatch):
    rng = np.random.default_rng(zlib.crc32(f"{sampler_type}-{sched}-{cfg}".encode()))
    js, ts = _schedules(sched)
    kw = {**CLI_KW, **extra}
    x_T = rng.standard_normal(SHAPE).astype(np.float32)
    cond = {"c_img": rng.standard_normal(SHAPE).astype(np.float32),
            "c_txt": rng.standard_normal(CTX).astype(np.float32)}
    uncond = None if cfg == 1.0 else {
        "c_img": cond["c_img"], "c_txt": rng.standard_normal(CTX).astype(np.float32)}
    jsam = jax_build_sampler(sampler_type, js, False, **kw)
    tsam = build_sampler(sampler_type, ts, False, **kw)
    key = jax.random.PRNGKey(3)
    args = (_model_jax, jnp.asarray(x_T), cond, uncond, cfg, STEPS, key)
    solver = _solver(sampler_type)
    table = None
    if solver in ROW_SOLVERS:
        table = rng.standard_normal((STEPS, *SHAPE)).astype(np.float32)
        ref = jsam.sample(*args, noise_table=jnp.asarray(table))
    elif solver == "dpm++_sde":
        table = rng.standard_normal((STEPS, 2, *SHAPE)).astype(np.float32)
        ref = jsam.sample(*args, noise_table=jnp.asarray(table))
    elif solver is not None:
        table = rng.standard_normal((400, *SHAPE)).astype(np.float32)
        draws = _Draws(table)
        monkeypatch.setattr(jax.random, "normal", draws)
        ref = jsam.sample(*args)
        monkeypatch.undo()
        table = table[:max(draws.used, 1)]
    elif sampler_type == "spaced":
        ref = jsam.sample(*args)
        noise, r = [], key
        for _ in range(STEPS):
            r, sub = jax.random.split(r)
            noise.append(np.asarray(jax.random.normal(sub, SHAPE, jnp.float32)))
        table = np.stack(noise)
    else:  # ddim (eta 0) and the DPM-Solvers: no draws
        ref = jsam.sample(*args)
    to_t = (lambda d: None if d is None else {k: torch.from_numpy(v) for k, v in d.items()})
    out = tsam.sample(_model_torch, torch.from_numpy(x_T), to_t(cond), to_t(uncond), cfg, STEPS,
                      generator=None if table is not None else torch.Generator().manual_seed(0),
                      noise_table=None if table is None else torch.from_numpy(table))
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and np.all(np.isfinite(ref))
    err = np.abs(out.numpy() - ref).max()
    tol = ADAPTIVE_TOL if sampler_type == "edm_dpm_adaptive" else TOL
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("sampler_type", ["spaced", "ddim", "dpm++_m2", "dpm++_s3",
                                          "edm_dpm++_3m_sde", "edm_dpm_adaptive"])
def test_model_ts_cover_every_model_call(sampler_type):
    """The hoisted grid (``model_ts``) holds every timestep the sampler
    calls the model at, as the port's host value and as JAX publishes it."""
    js, ts = _schedules("v21")
    tsam = build_sampler(sampler_type, ts, False, **CLI_KW)
    grid = set(np.asarray(tsam.model_ts(STEPS), np.float32).tolist())
    ref = jax_build_sampler(sampler_type, js, False, **CLI_KW).model_ts(STEPS)
    assert grid == set(np.asarray(ref, np.float32).tolist())
    seen = []

    def model(x, t, c):
        seen.append(float(np.float32(t)))
        return _model_torch(x, t, c)

    cond = {"c_img": torch.zeros(SHAPE), "c_txt": torch.zeros(CTX)}
    tsam.sample(model, torch.randn(SHAPE, generator=torch.Generator().manual_seed(0)), cond,
                None, 1.0, STEPS, generator=torch.Generator().manual_seed(1))
    assert seen and set(seen) <= grid


def test_3m_sde_generator_is_seeded_and_checks_its_table():
    _, ts = _schedules("v21")
    s = build_sampler("edm_dpm++_3m_sde", ts, False, **CLI_KW)
    cond = {"c_img": torch.zeros(SHAPE), "c_txt": torch.zeros(CTX)}
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    outs = [s.sample(_model_torch, x_T, cond, None, 1.0, STEPS,
                     generator=torch.Generator().manual_seed(seed)) for seed in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="noise_table shape"):
        s.sample(_model_torch, x_T, cond, None, 1.0, STEPS,
                 noise_table=torch.zeros(STEPS - 1, *SHAPE))
    with pytest.raises(ValueError, match="exactly one"):
        s.sample(_model_torch, x_T, cond, None, 1.0, STEPS)
