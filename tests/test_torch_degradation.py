"""The port's differentiable JPEG and batch degradation functions against
the JAX package, fp32 on the CPU.

- ``diff_jpeg`` (hard and soft rounding) at several qualities and sizes,
  within JPEG_TOL x max|ref|, and its input gradient (the soft rounding);
  a planted fault (the luma table transposed) must fail the limit;
- ``quality_to_factor``, ``filter2d_batch`` and ``usm_sharp_batch``
  within TOL x max|ref|;
- ``add_gaussian_noise_batch`` on JAX's own standard-normal draws (split
  from its key as JAX splits it), within TOL;
- ``add_poisson_noise_batch`` by its statistics: JAX's Poisson generator
  cannot be matched, so per image the noise's mean and standard deviation
  over many pixels against JAX's within STAT_TOL, gray images one draw for
  all channels, and one generator state giving one result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.dataset import degradation as jax_deg
from diffbir_tpu.ops import diffjpeg as jax_jpeg
from diffbir_tpu_torch.dataset import degradation
from diffbir_tpu_torch.ops import diffjpeg

# fp32, the same arithmetic in another order (sums of 64 products in the
# DCTs). Measured on the CPU, x max|ref|: diff_jpeg 2.1e-7-3.2e-7 (hard and
# soft rounding; no coefficient landed on a half step), its gradient
# 1.6e-6, filter2d_batch 1.1e-6, usm_sharp_batch 9.2e-7; the transposed
# luma table 2.9e-2-4.3e-2
JPEG_TOL, TOL = 1e-5, 1e-5
# standard error of a mean or std over 16384 noise samples is ~1 %
STAT_TOL = 0.05


def t(x):
    return torch.from_numpy(np.asarray(x))


def err(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    assert ref.shape == out.shape
    return float(np.abs(ref - out).max()) / max(float(np.abs(ref).max()), 1e-30)


@pytest.mark.parametrize("quality", [10.0, 49.0, 50.0, 75.0, 95.0, 100.0])
def test_quality_to_factor(quality):
    assert diffjpeg.quality_to_factor(quality) == jax_jpeg.quality_to_factor(quality)


@pytest.mark.parametrize("hw,differentiable", [((32, 32), True), ((48, 80), True),
                                               ((16, 112), False), ((64, 48), False)])
def test_diff_jpeg_matches_jax(hw, differentiable, monkeypatch):
    rng = np.random.default_rng(hw[0] * hw[1])
    x = rng.random((3, *hw, 3)).astype(np.float32)
    q = np.array([15.0, 50.0, 90.0], np.float32)
    fn = jax.jit(lambda a, b: jax_jpeg.diff_jpeg(a, b, differentiable))
    ref = fn(x, q)
    out = diffjpeg.diff_jpeg(t(x), t(q), differentiable)
    assert err(ref, out) <= JPEG_TOL
    monkeypatch.setattr(diffjpeg, "Y_TABLE", diffjpeg.Y_TABLE.T.copy())
    faulty = diffjpeg.diff_jpeg(t(x), t(q), differentiable)
    assert err(ref, faulty) > 100 * JPEG_TOL


def test_diff_jpeg_gradient_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 48, 3)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    q = np.array([30.0, 80.0], np.float32)
    ref = jax.jit(jax.grad(lambda a: jnp.sum(jax_jpeg.diff_jpeg(a, q) * w)))(x)
    xt = t(x).requires_grad_(True)
    (diffjpeg.diff_jpeg(xt, t(q)) * t(w)).sum().backward()
    assert err(ref, xt.grad) <= JPEG_TOL


def test_filter2d_and_usm_sharp_match_jax():
    rng = np.random.default_rng(6)
    img = rng.random((3, 64, 72, 3)).astype(np.float32)
    k = rng.random((3, 21, 21)).astype(np.float32)
    k /= k.sum(axis=(1, 2), keepdims=True)
    assert err(jax.jit(jax_deg.filter2d_batch)(img, k),
               degradation.filter2d_batch(t(img), t(k))) <= TOL
    for radius in (50, 7):
        ref = jax.jit(lambda a: jax_deg.usm_sharp_batch(a, radius=radius))(img)
        assert err(ref, degradation.usm_sharp_batch(t(img), radius=radius)) <= TOL


def test_gaussian_noise_on_jax_draws():
    rng = np.random.default_rng(7)
    img = rng.random((4, 32, 40, 3)).astype(np.float32)
    sigma = np.array([0.01, 0.05, 0.1, 0.2], np.float32)
    gray = np.array([False, True, False, True])
    key = jax.random.PRNGKey(3)
    ref = jax.jit(jax_deg.add_gaussian_noise_batch)(key, img, sigma, gray)
    k1, k2 = jax.random.split(key)
    draws = {"rgb": t(jax.random.normal(k1, img.shape)),
             "gray": t(jax.random.normal(k2, img.shape[:3] + (1,)))}
    out = degradation.add_gaussian_noise_batch(t(img), t(sigma), t(gray), draws=draws)
    assert err(ref, out) <= TOL
    drawn = degradation.add_gaussian_noise_batch(t(img), t(sigma), t(gray),
                                                 generator=torch.Generator().manual_seed(1))
    assert drawn.shape == img.shape and 0 <= float(drawn.min()) and float(drawn.max()) <= 1
    assert same_across_channels(drawn.numpy()[1], img[1])


def same_across_channels(out, img):
    """A gray image's noise is one draw for every channel (where no channel
    was clipped; img + noise rounds per channel, so to 1e-6)."""
    inside = ((out > 0) & (out < 1)).all(-1)
    noise = (out - img)[inside]
    return inside.mean() > 0.5 and np.abs(noise - noise[:, :1]).max() <= 1e-6


def test_poisson_noise_statistics_match_jax():
    rng = np.random.default_rng(8)
    levels = np.array([4, 16, 64, 256])
    img = np.stack([0.2 + 0.6 * np.floor(rng.random((128, 128, 3)) * lv) / lv
                    for lv in levels]).astype(np.float32)
    scale = np.array([1.0, 2.0, 1.0, 3.0], np.float32)
    gray = np.array([False, True, True, False])
    ref = np.asarray(jax.jit(jax_deg.add_poisson_noise_batch)(jax.random.PRNGKey(4), img, scale,
                                                              gray)) - img
    gen = torch.Generator().manual_seed(2)
    out = degradation.add_poisson_noise_batch(t(img), t(scale), t(gray), generator=gen)
    noise = out.numpy() - img
    for i in range(4):
        assert abs(noise[i].std() / ref[i].std() - 1) < STAT_TOL, i
        assert abs(noise[i].mean() - ref[i].mean()) < STAT_TOL * ref[i].std(), i
    for i in np.nonzero(gray)[0]:
        assert same_across_channels(out.numpy()[i], img[i]), i
    again = degradation.add_poisson_noise_batch(t(img), t(scale), t(gray),
                                                generator=torch.Generator().manual_seed(2))
    assert torch.equal(out, again)
