"""Restoration guidance in the port against the JAX package, fp32 on the CPU.

- The losses and their gradient steps (``utils.cond_fn``): ``MSEGuidance``
  and ``WeightedMSEGuidance`` (its 2x2-block Sobel weight too) on seeded
  inputs at even sizes; an odd size, and w_mse on a 4-channel latent, fail
  on both sides. ``RGBSpaceGuidance`` through the tiny ControlLDM's VAE
  decoder (converted weights), the target smaller than the decoded image:
  loss and gradient. Limit 1e-4 x max(1, max|ref|), the model tolerance of
  ``test_torch_models``.
- Guided sampling on ``test_torch_samplers``' linear model function (JAX's
  draws fed in): spaced, ddim, the EDM row solvers (dpm++_3m_sde,
  dpm++_2m_sde, euler_a: the step's denoised output guided, gated per row)
  and every unrolled solver (one euler-equivalent nudge a step;
  dpm_adaptive's on each accepted step), with a partial window and two
  rounds; limit 1e-5 x max|ref| (dpm_adaptive 1e-3), as there.
  ``repeat = 0`` and a window that no step reaches leave the output bit-equal
  to the unguided one.
- The pipeline: the ValueError for a sampler outside spaced, ddim and
  ``edm_*``; ``IdentityCleanerPipeline.run`` guided in the latent space
  (mse) and in RGB (w_mse, through the decoder), 3 spaced steps at CFG 4.0
  on the stand-in prompts, against the JAX pipeline within 1 uint8 level
  (``test_torch_pipeline``'s limit), and moved off the unguided output.
- The d = 512 dispatch under a gradient (``FLASH_MIN_WIDE_GRAD``, 4096):
  plain math below it, flash from it; without a gradient ``FLASH_MIN_WIDE``
  holds.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.pipeline import IdentityCleanerPipeline as JaxIdentityPipeline
from diffbir_tpu.pipeline import build_sampler as jax_build_sampler
from diffbir_tpu.utils import cond_fn as jax_cond
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.ops.attention import FLASH_MIN_WIDE, FLASH_MIN_WIDE_GRAD, attention
from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline, build_sampler
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.utils import cond_fn as port_cond
from tests.test_torch_models import assert_close
from tests.test_torch_pipeline import cldm_pair  # noqa: F401  (the tiny ControlLDM pair)
from tests.test_torch_pipeline import CFG, STEPS, jax_noise, word_tokenizer
from tests.test_torch_samplers import (ADAPTIVE_TOL, CLI_KW, CTX, SHAPE, TOL, _Draws, _model_jax,
                                       _model_torch, _schedules)

LOSSES = ("MSEGuidance", "WeightedMSEGuidance")


def _pair(name, *args):
    return getattr(jax_cond, name)(*args), getattr(port_cond, name)(*args)


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("hw", [(8, 8), (16, 12), (7, 9)])
def test_guidance_step_matches_jax(name, hw):
    """(g, loss) of a guidance call on an RGB-shaped [2, H, W, 3] pair, and
    the w_mse weight map; an odd size fails on both sides."""
    rng = np.random.default_rng(zlib.crc32(f"{name}{hw}".encode()))
    pred, target = (rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32) for _ in range(2))
    jg, tg = _pair(name, 0.01, 1001, -1, "rgb", 1)
    ref_fn = jax.jit(lambda t, p: jg(t, p))
    if hw[0] % 2 and name == "WeightedMSEGuidance":
        with pytest.raises(TypeError):
            ref_fn(target, pred)
        with pytest.raises(ValueError, match="even"):
            tg(torch.from_numpy(target), torch.from_numpy(pred))
        return
    ref_g, ref_loss = ref_fn(target, pred)
    g, loss = tg(torch.from_numpy(target), torch.from_numpy(pred))
    assert_close(ref_g, g.numpy())
    assert_close(ref_loss, loss.numpy())
    assert float(np.abs(g.numpy()).max()) > 0
    if name == "WeightedMSEGuidance":
        t01 = (target + 1) / 2
        w = port_cond.WeightedMSEGuidance.weight(torch.from_numpy(t01))
        assert_close(jax.jit(jg._weight)(t01), w.numpy())
        assert 0.0 <= float(w.min()) and float(w.max()) <= 1.0


def test_weighted_guidance_needs_an_rgb_target():
    """w_mse on a 4-channel latent: JAX's gray contraction fails, and the
    port says so."""
    z = np.zeros((1, 8, 8, 4), np.float32)
    jg, tg = _pair("WeightedMSEGuidance", 0.5, 1001, -1, "latent", 1)
    with pytest.raises(TypeError):
        jg(jnp.asarray(z), jnp.asarray(z))
    with pytest.raises(ValueError, match="RGB"):
        tg(torch.from_numpy(z), torch.from_numpy(z))


@pytest.mark.parametrize("name", LOSSES)
def test_rgb_space_guidance_matches_jax(cldm_pair, name):
    """Loss and gradient through the VAE decoder: z [1, 8, 8, 4] decodes to
    64x64, the target is 56x64 (the decode is cropped)."""
    jc, params, tc = cldm_pair
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 56, 64, 3)).astype(np.float32)
    ji, ti = _pair(name, 0.05, 1001, -1, "rgb", 1)
    jg = jax_cond.RGBSpaceGuidance(ji, lambda v: jc.vae_decode(params, v))
    ref_g, ref_loss = jax.jit(lambda t, v: jg(t, v))(target, z)
    tg = port_cond.RGBSpaceGuidance(ti, tc.vae_decode)
    with torch.no_grad():  # as the samplers call it
        g, loss = tg(torch.from_numpy(target), torch.from_numpy(z))
    assert_close(ref_loss, loss.numpy())
    assert_close(ref_g, g.numpy())
    assert float(np.abs(g.numpy()).max()) > 0


# (sampler, schedule, loss, window (t_start, t_stop), repeat)
SAMPLE_CASES = [
    ("spaced", "v21", "MSEGuidance", (1001, -1), 1),
    ("spaced", "eps", "WeightedMSEGuidance", (600, 200), 2),
    ("ddim", "v21", "MSEGuidance", (1001, -1), 1),
    ("ddim", "eps", "WeightedMSEGuidance", (600, 200), 2),
    ("edm_dpm++_3m_sde", "v21", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm++_3m_sde", "eps", "WeightedMSEGuidance", (600, 200), 2),
    ("edm_dpm++_2m_sde", "v21", "WeightedMSEGuidance", (800, 100), 1),
    ("edm_euler_a", "eps", "MSEGuidance", (1001, -1), 2),
    ("edm_heun", "v21", "MSEGuidance", (1001, -1), 1),
    ("edm_heun", "eps", "WeightedMSEGuidance", (600, 200), 2),
    ("edm_dpm++_2m", "v21", "MSEGuidance", (800, 100), 1),
    ("edm_euler", "eps", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm_2", "eps", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm_2_a", "eps", "MSEGuidance", (800, 100), 1),
    ("edm_lms", "eps", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm++_2s_a", "eps", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm++_sde", "eps", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm_fast", "eps", "MSEGuidance", (1001, -1), 1),
    ("edm_dpm_adaptive", "eps", "MSEGuidance", (1001, -1), 1),
]
RGB_SHAPE = (1, 4, 4, 3)  # w_mse weighs RGB: the samplers' state has 3 channels here


def _guided_sample(sampler_type, sched, loss, window, repeat, rgb):
    """(JAX's output, the port's) of one guided request on the linear model
    function, the draws fed in as in test_torch_samplers."""
    shape = RGB_SHAPE if rgb else SHAPE
    rng = np.random.default_rng(zlib.crc32(f"{sampler_type}{sched}{loss}{repeat}".encode()))
    js, ts = _schedules(sched)
    x_T = rng.standard_normal(shape).astype(np.float32)
    cond = {"c_img": rng.standard_normal(shape).astype(np.float32),
            "c_txt": rng.standard_normal(CTX).astype(np.float32)}
    uncond = {"c_img": cond["c_img"], "c_txt": rng.standard_normal(CTX).astype(np.float32)}
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    jg, tg = _pair(loss, 0.002, *window, "latent", repeat)
    jsam = jax_build_sampler(sampler_type, js, False, **CLI_KW)
    tsam = build_sampler(sampler_type, ts, False, **CLI_KW)
    key = jax.random.PRNGKey(3)
    guide = dict(cond_fn=jg, guidance_target=jnp.asarray(target))
    args = (_model_jax, jnp.asarray(x_T), cond, uncond, 4.0, STEPS_GUIDED, key)
    table = None
    if sampler_type.startswith("edm_") and sampler_type[4:] in ("dpm++_3m_sde",
                                                                 "dpm++_2m_sde", "euler_a"):
        table = rng.standard_normal((STEPS_GUIDED, *shape)).astype(np.float32)
        ref = jsam.sample(*args, noise_table=jnp.asarray(table), **guide)
    elif sampler_type == "edm_dpm++_sde":
        table = rng.standard_normal((STEPS_GUIDED, 2, *shape)).astype(np.float32)
        ref = jsam.sample(*args, noise_table=jnp.asarray(table), **guide)
    elif sampler_type == "spaced":
        ref = jsam.sample(*args, **guide)
        noise, r = [], key
        for _ in range(STEPS_GUIDED):
            r, sub = jax.random.split(r)
            noise.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
        table = np.stack(noise)
    elif sampler_type.startswith("edm_"):  # unrolled, eta 1: draws in call order
        table = rng.standard_normal((400, *shape)).astype(np.float32)
        draws = _Draws(table)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", draws)
            ref = jsam.sample(*args, **guide)
        assert draws.used < len(table)  # the port reads the rows in the same order
    else:  # ddim at eta 0 draws nothing
        ref = jsam.sample(*args, **guide)

    def run(cond_fn):
        to_t = (lambda d: {k: torch.from_numpy(v) for k, v in d.items()})
        return tsam.sample(
            _model_torch, torch.from_numpy(x_T), to_t(cond), to_t(uncond), 4.0, STEPS_GUIDED,
            generator=None if table is not None else torch.Generator().manual_seed(0),
            noise_table=None if table is None else torch.from_numpy(table),
            cond_fn=cond_fn, guidance_target=torch.from_numpy(target))

    return np.asarray(ref), run, tg


STEPS_GUIDED = 6


@pytest.mark.parametrize("sampler_type,sched,loss,window,repeat", SAMPLE_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2][:4]}-r{c[4]}" for c in SAMPLE_CASES])
def test_guided_sampler_matches_jax(sampler_type, sched, loss, window, repeat):
    rgb = loss == "WeightedMSEGuidance"
    ref, run, tg = _guided_sample(sampler_type, sched, loss, window, repeat, rgb)
    out = run(tg)
    assert np.all(np.isfinite(ref))
    err = np.abs(out.numpy() - ref).max()
    tol = ADAPTIVE_TOL if sampler_type == "edm_dpm_adaptive" else TOL
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())
    unguided = run(None)
    assert not torch.equal(out, unguided)  # the window reaches some step
    # off: no rounds, or a window that no step reaches (DDIM takes e_t back
    # from x0 on every step when it has a cond_fn, as JAX does: equal up to
    # rounding there)
    for off in (port_cond.MSEGuidance(0.002, *window, "latent", 0),
                port_cond.MSEGuidance(0.002, -5, -10, "latent", repeat)):
        if sampler_type == "ddim":
            assert np.abs((run(off) - unguided).numpy()).max() <= TOL * np.abs(ref).max()
        else:
            assert torch.equal(run(off), unguided)


@pytest.fixture(scope="module")
def guided_pipelines(cldm_pair):
    """(JAX pipeline, port pipeline) per guidance: latent mse and rgb w_mse."""
    jc, params, tc = cldm_pair
    jsched = _schedules("v21")[0]
    out = {}
    for space, loss, scale in (("latent", "MSEGuidance", 0.01), ("rgb", "WeightedMSEGuidance",
                                                                  0.05)):
        jg, tg = _pair(loss, scale, 1001, -1, space, 1)
        out[space] = (
            JaxIdentityPipeline(None, jc, params, jsched, tokenizer=word_tokenizer,
                                cond_fn=jg, min_cond_size=64),
            IdentityCleanerPipeline(tc, Schedule.v21(), torch.device("cpu"), min_cond_size=64,
                                    tokenizer=word_tokenizer, cond_fn=tg))
    return out


@pytest.mark.parametrize("space", ["latent", "rgb"])
def test_guided_pipeline_run_matches_jax(guided_pipelines, space):
    jp, tp = guided_pipelines[space]
    lq = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=5)
    x_T, noise = jax_noise(5, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    tp.cond_fn, cond_fn = None, tp.cond_fn
    try:
        plain = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    finally:
        tp.cond_fn = cond_fn
    assert np.any(plain != out)


def test_guidance_refuses_other_samplers(guided_pipelines):
    _, tp = guided_pipelines["latent"]
    lq = np.zeros((1, 64, 64, 3), np.uint8)
    for sampler in ("dpm++_m2", "dpm_m3"):
        with pytest.raises(ValueError, match="guidance"):
            tp.run(lq, steps=2, cfg_scale=1.0, sampler_type=sampler)


@pytest.mark.parametrize("tokens", [16, FLASH_MIN_WIDE, FLASH_MIN_WIDE_GRAD - 1,
                                    FLASH_MIN_WIDE_GRAD])
def test_wide_attention_under_a_gradient_takes_plain_math(monkeypatch, tokens):
    """d = 512 with a gradient of q goes to plain math below
    FLASH_MIN_WIDE_GRAD (4096, the H100's reading: K1_wide and the wide
    tensor-core K2a/K2b beat plain math under autograd from there) and to
    flash from it; the same call without a gradient follows FLASH_MIN_WIDE.
    Both callees are counted, not run."""
    assert FLASH_MIN_WIDE_GRAD == 4096
    from diffbir_tpu_torch.ops import attention as attention_mod

    calls = []
    monkeypatch.setattr(port_flash, "flash_attention",
                        lambda q, k, v: calls.append("flash") or torch.empty_like(q))
    monkeypatch.setattr(attention_mod, "plain_attention",
                        lambda q, k, v, **kw: calls.append("plain") or torch.empty_like(q))
    wide = torch.empty(1, tokens, 1, 512, device="meta")
    attention(wide.requires_grad_(), wide, wide)
    with torch.no_grad():
        attention(wide, wide, wide)
    grad_path = "flash" if tokens >= FLASH_MIN_WIDE_GRAD else "plain"
    assert calls == [grad_path, "flash" if tokens >= FLASH_MIN_WIDE else "plain"]
