"""Turbo control caching in the port, fp32 on the CPU, on the tiny ControlLDM.

- At interval 1 the cached model (``ControlLDM.make_cached_control_model``)
  is the plain model function, bit for bit, through every sampler that takes
  it (spaced, ddim, edm dpm++_3m_sde / dpm++_2m_sde / euler_a), with and
  without the UNet encoder cache, on the request's hoisted tables.
- At intervals 2 and 3, with and without the encoder cache, it matches the
  JAX ``make_cached_control_model`` through the same samplers (JAX's draws
  fed in), within 1e-4 x max(1, max|ref|), the model tolerance of
  ``test_torch_models``; and it moves off the plain trajectory (the cache is
  reused).
- ``UNetModel``'s ``phase="encode"`` then ``"decode"`` is ``"full"`` bit for
  bit; "encode" matches JAX's and does not read the control residuals.
- A second turbo request on one pipeline gives the first one's output (the
  cache is the request's); a sampler outside the five, and the tiled
  diffusion, raise ValueError.
- ``utils.common.ssim`` / ``psnr`` / ``rgb2ycbcr_y`` against JAX's: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.pipeline import build_sampler as jax_build_sampler
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu.utils import common as jax_common
from diffbir_tpu_torch.pipeline import (TURBO_SAMPLERS, IdentityCleanerPipeline, build_sampler,
                                        model_function)
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.utils import common as port_common
from tests.test_torch_models import assert_close
from tests.test_torch_pipeline import cldm_pair  # noqa: F401  (the tiny ControlLDM pair)
from tests.test_torch_pipeline import word_tokenizer

X_SHAPE, CTX_SHAPE, STEPS, CFG = (1, 8, 8, 4), (1, 77, 64), 5, 2.0
SCHED_KW = dict(linear_start=0.00085, linear_end=0.0120, parameterization="eps",
                zero_snr=False)
ROW_SOLVERS = ("edm_dpm++_3m_sde", "edm_dpm++_2m_sde", "edm_euler_a")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal(X_SHAPE).astype(np.float32)
    c_img = rng.standard_normal(X_SHAPE).astype(np.float32)
    cond = {"c_txt": rng.standard_normal(CTX_SHAPE).astype(np.float32), "c_img": c_img}
    uncond = {"c_txt": rng.standard_normal(CTX_SHAPE).astype(np.float32), "c_img": c_img}
    return x_T, cond, uncond


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _port_sample(sampler_type, model_fn, x_T, cond, uncond, noise_table=None):
    sampler = build_sampler(sampler_type, Schedule.create(1000, **SCHED_KW), False, eta=1.0)
    gen = None if noise_table is not None else torch.Generator().manual_seed(0)
    return sampler.sample(model_fn, torch.from_numpy(x_T), _torch(cond), _torch(uncond), CFG,
                          STEPS, generator=gen, noise_table=noise_table)


@pytest.mark.parametrize("encoder", [False, True], ids=["control", "control+encoder"])
@pytest.mark.parametrize("sampler_type", TURBO_SAMPLERS)
def test_interval_1_is_the_plain_model_bit_for_bit(cldm_pair, sampler_type, encoder):
    tc = cldm_pair[2]
    x_T, cond, uncond = _inputs(1)
    sampler = build_sampler(sampler_type, Schedule.create(1000, **SCHED_KW), False, eta=1.0)
    ctx = torch.from_numpy(np.concatenate([cond["c_txt"], uncond["c_txt"]]))
    tables = tc.make_hoist_tables(ctx, sampler.model_ts(STEPS))
    plain = _port_sample(sampler_type, model_function(tc, 0.7, tables), x_T, cond, uncond)
    cached = tc.make_cached_control_model(0.7, 1, encoder, tables)
    out = _port_sample(sampler_type, cached, x_T, cond, uncond)
    assert cached.calls == STEPS
    assert torch.equal(out, plain)


@pytest.fixture(scope="module")
def jax_turbo(cldm_pair):
    """{(sampler, interval, encoder): (JAX output, noise table)} on
    ``_inputs(2)``, one jitted JAX sample each."""
    jc, params, _ = cldm_pair
    js = JaxSchedule.create(timesteps=1000, beta_schedule="linear", **SCHED_KW)
    x_T, cond, uncond = _inputs(2)
    out = {}
    for sampler_type, interval, encoder in TURBO_CASES:
        model = jc.make_cached_control_model(params, 0.7, interval, (8, 8), call_batch=2,
                                             cache_unet_encoder=encoder)
        sampler = jax_build_sampler(sampler_type, js, False, eta=1.0)
        key = jax.random.PRNGKey(4)
        table = None
        kw = {}
        if sampler_type in ROW_SOLVERS:
            table = np.random.default_rng(3).standard_normal((STEPS, *X_SHAPE)).astype(
                np.float32)
            kw["noise_table"] = jnp.asarray(table)
        elif sampler_type == "spaced":
            noise, r = [], key
            for _ in range(STEPS):
                r, sub = jax.random.split(r)
                noise.append(np.asarray(jax.random.normal(sub, X_SHAPE, jnp.float32)))
            table = np.stack(noise)
        ref = sampler.sample(model, jnp.asarray(x_T), cond, uncond, CFG, STEPS, key, **kw)
        out[sampler_type, interval, encoder] = (np.asarray(ref), table)
    return out


# each sampler once, and each pair of an interval and an encoder setting (one
# JAX compile a case, ~9.5 s on the CPU)
TURBO_CASES = [("spaced", 2, False), ("ddim", 3, True), ("edm_dpm++_3m_sde", 2, True),
               ("edm_dpm++_2m_sde", 3, False), ("edm_euler_a", 3, True)]


@pytest.mark.parametrize("sampler_type,interval,encoder", TURBO_CASES,
                         ids=[f"{s}-k{k}{'-enc' if e else ''}" for s, k, e in TURBO_CASES])
def test_turbo_matches_jax(cldm_pair, jax_turbo, sampler_type, interval, encoder):
    tc = cldm_pair[2]
    x_T, cond, uncond = _inputs(2)
    ref, table = jax_turbo[sampler_type, interval, encoder]
    noise = None if table is None else torch.from_numpy(table)
    cached = tc.make_cached_control_model(0.7, interval, encoder)
    out = _port_sample(sampler_type, cached, x_T, cond, uncond, noise)
    assert_close(ref, out.numpy())
    plain = _port_sample(sampler_type, model_function(tc, 0.7), x_T, cond, uncond, noise)
    assert np.abs((out - plain).numpy()).max() > 1e-3  # the cache was reused


def test_unet_phases_split_the_full_forward(cldm_pair):
    jc, params, tc = cldm_pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([999.0, 21.0], np.float32)
    xn, tt, c = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(ctx)
    with torch.no_grad():
        control = tc.controlnet(xn, xn, tt, c)
        full = tc.unet(xn, tt, c, control=control)
        enc = tc.unet(xn, tt, c, phase="encode")
        assert all(torch.equal(a, b) for a, b in zip(
            enc[1], tc.unet(xn, tt, c, control=control, phase="encode")[1]))
        split = tc.unet(None, tt, c, control=control, phase="decode", cached=enc)
    assert torch.equal(split, full)
    ref_h, ref_hs = jax.jit(lambda p: jc.unet.apply(p["unet"], x, t, ctx, phase="encode"))(params)
    assert_close(ref_h, enc[0].permute(0, 2, 3, 1).numpy())
    assert len(ref_hs) == len(enc[1]) == 6  # the tiny UNet's skips
    for r, h in zip(ref_hs, enc[1]):
        assert_close(r, h.permute(0, 2, 3, 1).numpy())
    with pytest.raises(ValueError):
        tc.unet(xn, tt, c, phase="middle")


@pytest.fixture(scope="module")
def pipeline(cldm_pair):
    return IdentityCleanerPipeline(cldm_pair[2], Schedule.v21(), torch.device("cpu"),
                                   min_cond_size=64, tokenizer=word_tokenizer)


def test_turbo_requests_start_from_an_empty_cache(pipeline):
    lq = np.random.default_rng(6).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    kw = dict(steps=4, cfg_scale=4.0, seed=3, sampler_type="edm_dpm++_3m_sde")
    a = pipeline.run(lq, control_interval=2, turbo_encoder=True, **kw)
    b = pipeline.run(lq, control_interval=2, turbo_encoder=True, **kw)
    np.testing.assert_array_equal(a, b)
    assert np.any(a != pipeline.run(lq, **kw))


def test_turbo_refusals(pipeline):
    lq = np.zeros((1, 64, 64, 3), np.uint8)
    for sampler in ("edm_heun", "dpm++_m2", "edm_dpm++_sde"):
        with pytest.raises(ValueError, match="stateful"):
            pipeline.run(lq, steps=2, control_interval=2, sampler_type=sampler)
    with pytest.raises(ValueError, match="cldm_tiled"):
        pipeline.run(np.zeros((1, 128, 128, 3), np.uint8), steps=2, control_interval=3,
                     cldm_tiled=True, cldm_tile_size=64, cldm_tile_stride=32)


def test_image_metrics_match_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert_close(jax_common.ssim(a, b), port_common.ssim(ta, tb).numpy(), tol=1e-5)
    assert_close(jax_common.psnr(a, b), port_common.psnr(ta, tb).numpy(), tol=1e-5)
    assert_close(jax_common.psnr(a, b, crop_border=4, test_y=True),
                 port_common.psnr(ta, tb, crop_border=4, test_y=True).numpy(), tol=1e-5)
    assert_close(jax_common.rgb2ycbcr_y(a), port_common.rgb2ycbcr_y(ta).numpy(), tol=1e-5)
    assert np.allclose(port_common.ssim(ta, ta).numpy(), 1.0, atol=1e-6)
    assert float(port_common.ssim(ta, tb).max()) < 1.0

