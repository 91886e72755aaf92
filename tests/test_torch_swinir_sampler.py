"""diffbir_tpu_torch SwinIR and spaced sampler against the JAX package, fp32
on the CPU. Tolerance: max abs error <= 1e-4 * max(1, max |ref|)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.sampler.spaced import SpacedSampler as JaxSpacedSampler
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.sampler.base import timestep_vector
from diffbir_tpu_torch.sampler.spaced import SpacedSampler
from diffbir_tpu_torch.schedule import Schedule
from tests.test_torch_models import assert_close, converted_shapes, fill_params, load_port

SWIN_KW = dict(embed_dim=24, depths=(2, 2), num_heads=(4, 4), window_size=4)


@pytest.fixture(scope="module")
def swin_pair():
    js = JaxSwinIR(**SWIN_KW)
    shapes = jax.eval_shape(js.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = fill_params(shapes, seed=3)
    return js, params, load_port(SwinIR(**SWIN_KW), params)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (56, 72), (8, 40)])
def test_swinir_matches_jax(swin_pair, hw):
    """Shifted windows (every second block), the x8 unshuffle + upsampler,
    and the pad rule: none, reflect to the 32-multiple, edge for tiny inputs."""
    js, params, ts = swin_pair
    x = np.random.default_rng(hw[0] + hw[1]).random((1, *hw, 3)).astype(np.float32)
    ref = jax.jit(js.apply)(params, x)
    with torch.no_grad():
        out = ts(torch.from_numpy(x))
    assert_close(ref, out.numpy())


def test_swinir_default_structure_matches_jax_on_meta():
    shapes = jax.eval_shape(JaxSwinIR().init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    ref = converted_shapes(shapes)
    got = {k: tuple(v.shape) for k, v in SwinIR(device=torch.device("meta")).state_dict().items()}
    assert got == ref


def _model_jax(x, t, c):
    return jnp.tanh(x) * (t[:, None, None, None] / 1000.0) + 0.3 * c["c_img"] \
        + c["c_txt"].mean(axis=(1, 2))[:, None, None, None]


def _model_torch(x, t, c):
    t = timestep_vector(t, x)  # the port's samplers hand the model a host value
    return torch.tanh(x) * (t[:, None, None, None] / 1000.0) + 0.3 * c["c_img"] \
        + c["c_txt"].mean(dim=(1, 2))[:, None, None, None]


@pytest.mark.parametrize("param,cfg,steps", [("v", 4.0, 6), ("eps", 1.0, 5)])
def test_spaced_sampler_matches_jax_with_its_noise(param, cfg, steps):
    """The port's loop over make_tables rows, fed JAX's per-step draws
    (the scan's key chain: rng, sub = split(rng) each step)."""
    rng = np.random.default_rng(7)
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization=param, zero_snr=param == "v")
    x_T = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond = {"c_img": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
            "c_txt": rng.standard_normal((2, 77, 16)).astype(np.float32)}
    uncond = {"c_img": cond["c_img"], "c_txt": rng.standard_normal((2, 77, 16)).astype(np.float32)}
    if cfg == 1.0:
        uncond = None
    key = jax.random.PRNGKey(11)
    ref = JaxSpacedSampler(sched.betas, param, False).sample(
        _model_jax, jnp.asarray(x_T), cond, uncond, cfg, steps, key)
    noise, r = [], key
    for _ in range(steps):
        r, sub = jax.random.split(r)
        noise.append(np.asarray(jax.random.normal(sub, x_T.shape, jnp.float32)))
    to_t = (lambda d: None if d is None else {k: torch.from_numpy(v) for k, v in d.items()})
    out = SpacedSampler(Schedule(sched.betas, param).betas, param, False).sample(
        _model_torch, torch.from_numpy(x_T), to_t(cond), to_t(uncond), cfg, steps,
        noise_table=torch.from_numpy(np.stack(noise)))
    assert_close(ref, out.numpy())


def test_spaced_sampler_generator_is_deterministic():
    s = SpacedSampler(Schedule.v21().betas, "v", False)
    cond = {"c_img": torch.zeros(1, 4, 4, 4), "c_txt": torch.zeros(1, 77, 8)}
    x_T = torch.randn(1, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    outs = [s.sample(_model_torch, x_T, cond, None, 1.0, 3,
                     generator=torch.Generator().manual_seed(seed)) for seed in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        s.sample(_model_torch, x_T, cond, None, 1.0, 3)
