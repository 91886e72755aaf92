"""The serving modes as a whole against the JAX package, fp32 on the CPU.

Two configurations, as the JAX CLI runs them:

- "fused": ``--fused_resblock --fused_ffn`` with the packed flash layout
  (``ControlLDM.tiny(fused_resblock=True)``, ``DIFFBIR_TPU_FUSED_FFN=1``,
  ``DIFFBIR_TPU_FLASH_LAYOUT=packed`` on the JAX side) on float weights;
- "int8": ``--quant_dense --fused_resblock --quant_conv``, packed, on the
  JAX ``quantize_dense_params`` + ``quantize_conv_params`` tree, converted.

``--fast_gelu`` (``set_serving(fast_gelu=True)``, the tanh GELU) against
JAX's ``DIFFBIR_TPU_FAST_GELU=1`` on the float and the int8 model; under
``--fused_ffn`` it changes nothing (K7 keeps erf, as JAX's kernel does).

The tiny ControlLDM forward, then ``IdentityCleanerPipeline.run`` (3 spaced
steps, CFG 4.0, the v2.1 schedule, the JAX pipeline's x_T and noise, the
default negative prompt through a stand-in tokenizer, so cond and uncond
differ). On the CPU the JAX model runs the fused modes' XLA fallbacks (the
same math at fp32, up to the int8 conv weights dequantised before the conv,
~1e-7) and the port the kernels' plain versions. Tolerances: "fused" as the
slice test's, the forward 1e-4 x max(1, max|ref|) and the uint8 output 1
LSB. "int8": the forward 1e-2 x max(1, max|ref|), because K4 rounds every
activation to bf16 before its product: fp32 sums taken in another order put
some elements on the other side of a bf16 rounding step, and the network
carries those steps on (a 1e-6 relative change of the input moves this
model's int8 output by 1.1e-2, against 9.4e-3 between port and JAX).

Through the pipeline CFG 4.0 multiplies the cond - uncond difference, and
with it that spread. With empty prompts (cond = uncond) the int8 output
stays within 4 LSB of JAX's ("int8_empty_prompts"). On the default negative
prompt ("int8") it is held within the port's own spread: the same run with
x_T moved by 1e-6 relative, over four seeded perturbations
(``python -m tests.test_torch_modes`` measures it). Measured on these
inputs (fp32, CPU): the port's perturbed runs differ from its unperturbed
one by 8-13 LSB at most, with 2.3-4.9 % of the values more than 4 LSB off;
JAX's own, the same way, by 7-14 LSB and 0.9-5.1 %; port and JAX by 10 LSB
and 2.3 %. So the difference is the rounding-order spread, not a fault of
the port. The limits are 1.5x the largest of the port's readings:
``INT8_MAX_LSB`` (19) and ``INT8_SHARE`` (7.4 %). The same comparison with
the port's float model in place of its int8 one must fail them (13 LSB,
10.9 % more than 4 LSB off: the quantisation error), which shows they
still hold the int8 path.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models import cldm as jax_cldm
from diffbir_tpu.pipeline import IdentityCleanerPipeline as JaxIdentityPipeline
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu_torch.models import cldm as port_cldm
from diffbir_tpu_torch.models.unet import GEGLU, CrossAttention, FeedForward, ResBlock
from diffbir_tpu_torch.ops.quant_matmul import QuantLinear
from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import assert_close, fill_params
from tests.test_torch_pipeline import CFG, STEPS, jax_noise, word_tokenizer

MODES = {
    "fused": dict(fused_resblock=True),
    "int8": dict(quant_dense=True, fused_resblock=True, quant_conv=True),
}
PORT_EXTRA = {"fused": dict(fused_ffn=True), "int8": {}}
FORWARD_TOL = {"fused": 1e-4, "int8": 1e-2}
LSB_TOL = {"fused": 1, "int8": 4}
# the int8 pipeline on distinct prompts: 1.5x the largest of the port's own
# spread readings (13 LSB, 4.9 % of the values more than 4 LSB off)
INT8_MAX_LSB = 19
INT8_SHARE = 0.074
# pipeline cases: (mode, prompts); "int8_empty_prompts" keeps cond = uncond
PIPELINE_CASES = {"fused": ("fused", {}), "int8": ("int8", {}),
                  "int8_empty_prompts": ("int8", {"neg_prompt": ""})}


def _lsb_stats(out, ref):
    """(largest uint8 difference, share of values more than LSB_TOL["int8"]
    apart)."""
    err = np.abs(out.astype(int) - ref.astype(int))
    return int(err.max()), float(np.mean(err > LSB_TOL["int8"]))


def _within(case, out, ref):
    """Whether a pipeline output meets its case's limits."""
    if case == "int8":
        err_max, err_share = _lsb_stats(out, ref)
        return err_max <= INT8_MAX_LSB and err_share <= INT8_SHARE
    return np.abs(out.astype(int) - ref.astype(int)).max() <= LSB_TOL[PIPELINE_CASES[case][0]]


@pytest.fixture(scope="module")
def float_params():
    return fill_params(jax_cldm.ControlLDM.tiny().eval_shapes((8, 8)), seed=0)


def _pair(mode, float_params):
    """(JAX ControlLDM, its params as jnp arrays, the port's ControlLDM)."""
    params = float_params
    if mode == "int8":
        params = jax.device_get(jax_cldm.quantize_conv_params(
            jax_cldm.quantize_dense_params(params)))
    jc = jax_cldm.ControlLDM.tiny(**MODES[mode])
    tc = port_cldm.ControlLDM.tiny(**MODES[mode], **PORT_EXTRA[mode], flash_layout="packed")
    tc.load_state_dict(flax_to_state_dict(params), strict=True)
    return jc, jax.tree_util.tree_map(jnp.asarray, params), tc.eval()


@pytest.fixture
def jax_env(monkeypatch):
    monkeypatch.setenv("DIFFBIR_TPU_FUSED_FFN", "1")
    monkeypatch.setenv("DIFFBIR_TPU_FLASH_LAYOUT", "packed")


@pytest.mark.parametrize("mode", list(MODES))
def test_controlldm_forward_matches_jax_in_mode(mode, float_params, jax_env):
    jc, params, tc = _pair(mode, float_params)
    assert all(m.fused for m in tc.modules() if isinstance(m, ResBlock))
    assert all(m.fused == (mode == "fused") for m in tc.modules() if isinstance(m, FeedForward))
    rng = np.random.default_rng(1)
    x, c_img = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    c_txt = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([999.0, 21.0], np.float32)
    ref = jax.jit(lambda p: jc(p, x, t, {"c_txt": c_txt, "c_img": c_img}))(params)
    cond = {"c_txt": torch.from_numpy(c_txt), "c_img": torch.from_numpy(c_img)}
    with torch.no_grad():
        out = tc(torch.from_numpy(x), torch.from_numpy(t), cond)
    assert_close(ref, out.numpy(), tol=FORWARD_TOL[mode])
    if mode == "int8":  # the limit's power: the float model misses it
        _, _, float_model = _pair("fused", float_params)
        with torch.no_grad():
            out_f = float_model(torch.from_numpy(x), torch.from_numpy(t), cond)
        with pytest.raises(AssertionError):
            assert_close(ref, out_f.numpy(), tol=FORWARD_TOL[mode])


def _forward_inputs():
    rng = np.random.default_rng(1)
    x, c_img = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    c_txt = rng.standard_normal((2, 77, 64)).astype(np.float32)
    return x, np.array([999.0, 21.0], np.float32), {"c_txt": c_txt, "c_img": c_img}


def _port_forward(tc, x, t, cond):
    with torch.no_grad():
        return tc(torch.from_numpy(x), torch.from_numpy(t),
                  {k: torch.from_numpy(v) for k, v in cond.items()}).numpy()


@pytest.mark.parametrize("mode", ["default", "int8"])
def test_fast_gelu_matches_jax(mode, float_params, monkeypatch):
    """--fast_gelu (``set_serving(fast_gelu=True)``): the tanh GELU in every
    unfused GEGLU, the int8 ones too, against the JAX model traced afresh
    under DIFFBIR_TPU_FAST_GELU=1 (its switch, read at trace time), within
    the mode's forward tolerance; and not the exact-erf output."""
    if mode == "int8":
        monkeypatch.setenv("DIFFBIR_TPU_FLASH_LAYOUT", "packed")
        jc, params, tc = _pair("int8", float_params)
        flags = MODES["int8"]
    else:
        jc = jax_cldm.ControlLDM.tiny()
        params = jax.tree_util.tree_map(jnp.asarray, float_params)
        tc = port_cldm.ControlLDM.tiny()
        tc.load_state_dict(flax_to_state_dict(float_params), strict=True)
        tc, flags = tc.eval(), {}
    x, t, cond = _forward_inputs()
    exact = _port_forward(tc, x, t, cond)
    tc.set_serving(**flags, fast_gelu=True)
    geglus = [m for m in tc._denoisers() if isinstance(m, GEGLU)]
    assert geglus and {m.approximate for m in geglus} == {"tanh"}
    out = _port_forward(tc, x, t, cond)
    monkeypatch.setenv("DIFFBIR_TPU_FAST_GELU", "1")
    ref = jax.jit(lambda p: jc(p, x, t, cond))(params)
    assert_close(ref, out, tol=FORWARD_TOL.get(mode, 1e-4))
    assert np.abs(out - exact).max() > 1e-4
    if mode == "default":  # the limit's power: the exact-erf output misses it
        with pytest.raises(AssertionError):
            assert_close(ref, exact)
    tc.set_serving(**flags)
    assert {m.approximate for m in geglus} == {"none"}


def test_fused_ffn_keeps_erf_under_fast_gelu(float_params, jax_env, monkeypatch):
    """With --fused_ffn every FFN is one K7 call, which keeps the exact erf
    as the JAX fused kernel does: --fast_gelu changes nothing there, bit for
    bit, and JAX under both switches agrees."""
    jc, params, tc = _pair("fused", float_params)
    x, t, cond = _forward_inputs()
    fused = _port_forward(tc, x, t, cond)
    tc.set_serving(fused_resblock=True, fused_ffn=True, fast_gelu=True)
    np.testing.assert_array_equal(_port_forward(tc, x, t, cond), fused)
    monkeypatch.setenv("DIFFBIR_TPU_FAST_GELU", "1")
    ref = jax.jit(lambda p: jc(p, x, t, cond))(params)
    assert_close(ref, fused, tol=FORWARD_TOL["fused"])


def _pipelines(mode, float_params):
    """(JAX pipeline, the port's pipeline, the port's float-model pipeline)
    on the tiny ControlLDM in ``mode``."""
    jc, params, tc = _pair(mode, float_params)
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization="v", zero_snr=True)
    jp = JaxIdentityPipeline(None, jc, params, sched, tokenizer=word_tokenizer,
                             min_cond_size=64)
    tp, tp_f = (IdentityCleanerPipeline(m, Schedule.v21(), torch.device("cpu"),
                                        min_cond_size=64, tokenizer=word_tokenizer)
                for m in (tc, _pair("fused", float_params)[2]))
    return jp, tp, tp_f


def _lq():
    return np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("mode", list(PIPELINE_CASES))
def test_identity_pipeline_run_matches_jax_in_mode(mode, float_params, jax_env):
    base, prompts = PIPELINE_CASES[mode]
    jp, tp, tp_f = _pipelines(base, float_params)
    lq = _lq()
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=5, **prompts)
    x_T, noise = jax_noise(5, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, **prompts)
    assert out.shape == ref.shape == (1, 64, 64, 3) and out.dtype == np.uint8
    assert ref.std() > 1.0
    assert _within(mode, out, ref), _lsb_stats(out, ref)
    if base == "int8":  # the limits' power: the float model misses them
        out_f = tp_f.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, **prompts)
        assert not _within(mode, out_f, ref), _lsb_stats(out_f, ref)


def test_set_mode_composes_the_serving_modes(float_params):
    """``ControlLDM.set_mode`` on a float model: "fused" and "default" switch
    the fused paths and the flash layout both ways; "int8" quantises the
    model into the layout of one built in the mode (its state dict loads
    there, strictly)."""
    model = port_cldm.ControlLDM.tiny()
    model.load_state_dict(flax_to_state_dict(float_params), strict=True)

    def state():
        mods = list(model._denoisers())
        return ({m.fused for m in mods if isinstance(m, (ResBlock, FeedForward))},
                {m.flash_layout for m in mods if isinstance(m, CrossAttention)})

    assert model.set_mode("fused") is model and state() == ({True}, {"packed"})
    assert model.set_mode("default") is model and state() == ({False}, {"folded"})
    model.set_mode("int8")
    assert any(isinstance(m, QuantLinear) for m in model.modules())
    assert all(m.quant_conv and m.fused for m in model.modules() if isinstance(m, ResBlock))
    assert {m.fused for m in model.modules() if isinstance(m, FeedForward)} == {False}
    port_cldm.ControlLDM.tiny(**MODES["int8"]).load_state_dict(model.state_dict(), strict=True)
    with pytest.raises(ValueError):
        model.set_mode("int4")


def _jax_run_with_x_T_moved(float_params, lq, r):
    """The JAX int8 pipeline's output with its x_T (the first normal draw of
    a fresh trace) moved by 1e-6 x r relative."""
    jp = _pipelines("int8", float_params)[0]
    normal, draws = jax.random.normal, []

    def moved(key, shape=(), dtype=jnp.float32):
        z = normal(key, shape, dtype)
        draws.append(tuple(shape))
        return z * (1 + 1e-6 * jnp.asarray(r)) if len(draws) == 1 else z

    with mock.patch.object(jax.random, "normal", moved):
        out = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=5)
    assert draws and draws[0] == r.shape, draws
    return out


def measure_int8_spread(n: int = 4) -> None:
    """Print the readings the int8 limits come from: the port's int8 output
    on the default negative prompt against itself with x_T moved by 1e-6
    relative (n seeded perturbations), JAX's the same way, port against JAX,
    and the float model against JAX (largest uint8 difference, share of
    values more than 4 LSB off)."""
    float_params = fill_params(jax_cldm.ControlLDM.tiny().eval_shapes((8, 8)), seed=0)
    jp, tp, tp_f = _pipelines("int8", float_params)
    lq = _lq()
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=5)
    x_T, noise = jax_noise(5, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    for s in range(n):
        r = np.random.default_rng(100 + s).standard_normal(x_T.shape).astype(np.float32)
        moved = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T * (1 + 1e-6 * torch.from_numpy(r)),
                       noise_table=noise)
        print(f"port vs port with x_T perturbed (seed {100 + s}): {_lsb_stats(moved, out)}")
        print(f"JAX vs JAX with x_T perturbed (seed {100 + s}): "
              f"{_lsb_stats(_jax_run_with_x_T_moved(float_params, lq, r), ref)}")
    print(f"port vs JAX: {_lsb_stats(out, ref)}")
    out_f = tp_f.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise)
    print(f"float model vs JAX: {_lsb_stats(out_f, ref)}")


if __name__ == "__main__":
    import os

    os.environ.update(DIFFBIR_TPU_FUSED_FFN="1", DIFFBIR_TPU_FLASH_LAYOUT="packed")
    measure_int8_spread()
