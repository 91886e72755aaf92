"""The ported slice as a whole against the JAX pipeline, fp32 on the CPU.

Tiny ControlLDM (``ControlLDM.tiny()``) behind the identity cleaner and
behind a tiny SwinIR, 3 spaced steps at CFG 4.0 on the v2.1 schedule. The
port is handed x_T and the per-step noise that the JAX pipeline draws from
its key chain (split(PRNGKey(seed), 4) -> k_start for x_T, k_sample for the
steps). Both pipelines take the same stand-in tokenizer, so the default
negative prompt reaches CLIP and cond differs from uncond. Tolerances:
apply_cldm's float output 1e-3 abs; run's uint8 output 1 LSB.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.pipeline import IdentityCleanerPipeline as JaxIdentityPipeline
from diffbir_tpu.pipeline import SwinIRPipeline as JaxSwinIRPipeline
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.pipeline import EOT, SOT, IdentityCleanerPipeline, SwinIRPipeline
from diffbir_tpu_torch.schedule import Schedule
from tests.test_torch_models import fill_params, load_port

STEPS, CFG, SEED = 3, 4.0, 5
SWIN_KW = dict(embed_dim=24, depths=(2,), num_heads=(4,), window_size=4)


def word_tokenizer(texts):
    """A deterministic stand-in for the CLIP tokenizer: each word's id from
    its crc32, in [0, SOT), between SOT and EOT, zero-padded to 77."""
    out = np.zeros((len(texts), 77), np.int32)
    for row, text in zip(out, texts):
        ids = [zlib.crc32(w.encode()) % SOT for w in text.split()[:75]]
        row[:len(ids) + 2] = [SOT, *ids, EOT]
    return out


def jax_noise(seed, shape, steps, aug: bool = False):
    """x_T and the per-step noise table of the JAX pipeline (split(key, 4)
    -> k_start, k_aug, k_sample) and its scan (the spaced and the EDM row
    samplers: rng, sub = split(rng) each step); with ``aug`` also the
    noise_aug draw."""
    _, k_start, k_aug, k_sample = jax.random.split(jax.random.PRNGKey(seed), 4)
    x_T = np.asarray(jax.random.normal(k_start, shape, jnp.float32))
    noise, r = [], k_sample
    for _ in range(steps):
        r, sub = jax.random.split(r)
        noise.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    out = (torch.from_numpy(x_T.copy()), torch.from_numpy(np.stack(noise)))
    if aug:
        out += (torch.from_numpy(np.asarray(jax.random.normal(k_aug, shape, jnp.float32))),)
    return out


@pytest.fixture(scope="module")
def cldm_pair():
    jc = JaxControlLDM.tiny()
    params = fill_params(jc.eval_shapes((8, 8)), seed=0)
    tc = load_port(ControlLDM.tiny(), params)
    return jc, jax.tree_util.tree_map(jnp.asarray, params), tc


@pytest.fixture(scope="module")
def identity_pair(cldm_pair):
    jc, params, tc = cldm_pair
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization="v", zero_snr=True)
    jp = JaxIdentityPipeline(None, jc, params, sched, tokenizer=word_tokenizer,
                             min_cond_size=64)
    return jp, IdentityCleanerPipeline(tc, Schedule.v21(), torch.device("cpu"), min_cond_size=64,
                                       tokenizer=word_tokenizer)


@pytest.fixture(scope="module")
def lq():
    return np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)


def test_apply_cldm_matches_jax(identity_pair, lq):
    jp, tp = identity_pair
    cond_img = lq.astype(np.float32) / 255.0
    ref = np.asarray(jp.apply_cldm(jnp.asarray(cond_img), STEPS, 1.0, "", "", CFG,
                                   rng=jax.random.PRNGKey(SEED)))
    x_T, noise = jax_noise(SEED, (1, 8, 8, 4), STEPS)
    out = tp.apply_cldm(torch.from_numpy(cond_img), STEPS, 1.0, "", "", CFG,
                        x_T=x_T, noise_table=noise)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)


def test_identity_pipeline_run_matches_jax(identity_pair, lq):
    jp, tp = identity_pair
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=SEED)
    x_T, noise = jax_noise(SEED, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    assert out.shape == ref.shape == (1, 64, 64, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert ref.std() > 1.0


def test_swinir_pipeline_run_matches_jax(cldm_pair):
    """SwinIR cleaner (pad to x64, clip to [0, 1]) -> stage 2 -> colour fix
    -> resize to the LQ size, on a non-square LQ."""
    jc, params, tc = cldm_pair
    js = JaxSwinIR(**SWIN_KW)
    sparams = fill_params(
        jax.eval_shape(js.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), seed=1)
    ts = load_port(SwinIR(**SWIN_KW), sparams)
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization="v", zero_snr=True)
    cleaner = jax.jit(lambda x: jnp.clip(js.apply(sparams, x), 0.0, 1.0))
    jp = JaxSwinIRPipeline(cleaner, jc, params, sched, tokenizer=word_tokenizer,
                           min_cond_size=64)
    tp = SwinIRPipeline(ts, tc, Schedule.v21(), torch.device("cpu"), min_cond_size=64,
                        tokenizer=word_tokenizer)
    lq = np.random.default_rng(1).integers(0, 256, (1, 72, 64, 3), dtype=np.uint8)
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=SEED + 1)
    # the condition pads to 128x64, an 16x8 latent
    x_T, noise = jax_noise(SEED + 1, (1, 16, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    assert out.shape == ref.shape == (1, 72, 64, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_seeded_run_is_deterministic(identity_pair, lq):
    _, tp = identity_pair
    a = tp.run(lq, steps=2, cfg_scale=CFG, seed=7)
    b = tp.run(lq, steps=2, cfg_scale=CFG, seed=7)
    c = tp.run(lq, steps=2, cfg_scale=CFG, seed=8)
    assert a.shape == (1, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert np.any(a != c)


def test_prompt_text_reaches_clip_and_matches_jax(identity_pair, lq):
    """Non-empty positive and negative text through the tokenizer: the port
    equals the JAX pipeline, and the output differs from the empty-prompt
    run's, so the text reaches CLIP."""
    jp, tp = identity_pair
    pos, neg = "a sharp photo of a red fox in snow", "blurry, noisy, low quality"
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=SEED, pos_prompt=pos, neg_prompt=neg)
    x_T, noise = jax_noise(SEED, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, pos_prompt=pos,
                 neg_prompt=neg)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    empty = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, pos_prompt="",
                   neg_prompt="")
    assert np.any(out != empty)
    assert torch.equal(tp.tokenize(pos, 2), torch.from_numpy(word_tokenizer([pos])).long()
                       .repeat(2, 1))


def test_prompt_text_without_a_tokenizer_raises(cldm_pair, lq):
    """Without a tokenizer only the empty prompt is encoded (SOT, EOT,
    zeros); text raises instead of being dropped."""
    tp = IdentityCleanerPipeline(cldm_pair[2], Schedule.v21(), torch.device("cpu"),
                                 min_cond_size=64)
    ids = tp.tokenize("", 2)
    assert ids.shape == (2, 77) and ids[:, :2].tolist() == [[SOT, EOT]] * 2
    assert not ids[:, 2:].any()
    with pytest.raises(ValueError, match="tokenizer"):
        tp.run(lq, steps=2, cfg_scale=CFG, seed=7)  # the default negative prompt
    with pytest.raises(ValueError, match="tokenizer"):
        tp.run(lq, steps=2, cfg_scale=CFG, seed=7, pos_prompt="a fox", neg_prompt="")
    out = tp.run(lq, steps=2, cfg_scale=CFG, seed=7, neg_prompt="")
    assert out.shape == (1, 64, 64, 3)


@pytest.mark.parametrize("kwargs", [dict(control_interval=2)])
def test_unported_options_raise(identity_pair, lq, kwargs):
    """Once refused as unported, now ported: turbo at interval 2 runs, within
    1 uint8 level of the JAX pipeline's run of the same request, and off
    the plain request's output."""
    jp, tp = identity_pair
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=SEED, **kwargs)
    x_T, noise = jax_noise(SEED, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, **kwargs)
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    plain = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    assert np.any(plain != out)


# --------------------------------------------------------------------------- #
# the CLI's sampler and the rest of Pipeline.run
# --------------------------------------------------------------------------- #
def _eps_pair(cldm_pair):
    """Identity pipelines on the v1 (eps, nonzero terminal alpha) schedule,
    where the "cond" start keeps part of the condition."""
    jc, params, tc = cldm_pair
    kw = dict(linear_start=0.00085, linear_end=0.0120, parameterization="eps", zero_snr=False)
    jp = JaxIdentityPipeline(None, jc, params,
                             JaxSchedule.create(timesteps=1000, beta_schedule="linear", **kw),
                             tokenizer=word_tokenizer, min_cond_size=64)
    tp = IdentityCleanerPipeline(tc, Schedule.create(1000, **kw), torch.device("cpu"),
                                 min_cond_size=64, tokenizer=word_tokenizer)
    return jp, tp


@pytest.mark.parametrize("case", ["cond_start", "noise_aug"])
def test_run_options_match_jax(identity_pair, cldm_pair, lq, case):
    """The CLI's default sampler (edm_dpm++_3m_sde at eta 1, noise on every
    step) with the "cond" start point (v1 schedule) and with noise
    augmentation (v2.1), each against the JAX pipeline on its draws."""
    jp, tp = _eps_pair(cldm_pair) if case == "cond_start" else identity_pair
    kw = dict(steps=STEPS, cfg_scale=CFG, pos_prompt="a red fox", eta=1.0,
              sampler_type="edm_dpm++_3m_sde")
    kw.update({"cond_start": dict(start_point_type="cond"),
               "noise_aug": dict(noise_aug=200)}[case])
    ref = jp.run(lq, seed=SEED, **kw)
    x_T, noise, aug = jax_noise(SEED, (1, 8, 8, 4), STEPS, aug=True)
    out = tp.run(lq, x_T=x_T, noise_table=noise, aug_noise=aug, **kw)
    assert out.shape == ref.shape == (1, 64, 64, 3) and ref.std() > 1.0
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    plain = tp.run(lq, x_T=x_T, noise_table=noise, aug_noise=aug,
                   **{**kw, "sampler_type": "spaced", "start_point_type": "noise",
                      "noise_aug": 0})
    assert np.any(out != plain)  # the option changed the request


def test_size_bucket_matches_jax(identity_pair):
    """A 72x60 LQ: reflect-padded to 128x64, the condition reflect-padded
    to multiples of 96 (192x96, a 24x16 latent after the x64 pad), the
    output cropped back to 72x60; the CLI's sampler."""
    jp, tp = identity_pair
    lq = np.random.default_rng(3).integers(0, 256, (1, 72, 60, 3), dtype=np.uint8)
    kw = dict(steps=2, cfg_scale=CFG, size_bucket=96, sampler_type="edm_dpm++_3m_sde",
              eta=1.0)
    ref = jp.run(lq, seed=SEED, **kw)
    x_T, noise = jax_noise(SEED, (1, 24, 16, 4), 2)
    out = tp.run(lq, x_T=x_T, noise_table=noise, **kw)
    assert out.shape == ref.shape == (1, 72, 60, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_hoisting_off_matches_on(identity_pair, lq):
    """The pipeline's ``hoist`` switch: the same request with the loop's own
    k/v and timestep embedding, within the uint8 rounding."""
    _, tp = identity_pair
    x_T, noise = jax_noise(SEED, (1, 8, 8, 4), STEPS)
    kw = dict(steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise,
              sampler_type="edm_dpm++_3m_sde", eta=1.0)
    on = tp.run(lq, **kw)
    tp.hoist = False
    try:
        off = tp.run(lq, **kw)
    finally:
        tp.hoist = True
    assert np.abs(on.astype(int) - off.astype(int)).max() <= 1
