"""The serving modes as a whole against the JAX package, fp32 on the CPU.

Two configurations, as the JAX CLI runs them:

- "fused": ``--fused_resblock --fused_ffn`` with the packed flash layout
  (``ControlLDM.tiny(fused_resblock=True)``, ``DIFFBIR_TPU_FUSED_FFN=1``,
  ``DIFFBIR_TPU_FLASH_LAYOUT=packed`` on the JAX side) on float weights;
- "int8": ``--quant_dense --fused_resblock --quant_conv``, packed, on the
  JAX ``quantize_dense_params`` + ``quantize_conv_params`` tree, converted.

The tiny ControlLDM forward, then ``IdentityCleanerPipeline.run`` (3 spaced
steps, CFG 4.0, the v2.1 schedule, the JAX pipeline's x_T and noise). On the
CPU the JAX model runs the fused modes' XLA fallbacks (the same math at fp32,
up to the int8 conv weights dequantised before the conv, ~1e-7) and the port
the kernels' plain versions. Tolerances: "fused" as the slice test's, the
forward 1e-4 x max(1, max|ref|) and the uint8 output 1 LSB. "int8": the
forward 1e-2 x max(1, max|ref|) and 4 LSB, because K4 rounds every
activation to bf16 before its product: fp32 sums taken in another order put
some elements on the other side of a bf16 rounding step, and the network
carries those steps on (a 1e-6 relative change of the input moves this
model's int8 output by 1.1e-2, against 9.4e-3 between port and JAX). The
same comparison with the port's float model in place of its int8 one must
fail these limits (the quantisation error is 5.4e-2), which shows they still
hold the int8 path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models import cldm as jax_cldm
from diffbir_tpu.pipeline import IdentityCleanerPipeline as JaxIdentityPipeline
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu_torch.models import cldm as port_cldm
from diffbir_tpu_torch.models.unet import FeedForward, ResBlock
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


@pytest.mark.parametrize("mode", list(MODES))
def test_identity_pipeline_run_matches_jax_in_mode(mode, float_params, jax_env):
    jc, params, tc = _pair(mode, float_params)
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization="v", zero_snr=True)
    jp = JaxIdentityPipeline(None, jc, params, sched, tokenizer=word_tokenizer,
                             min_cond_size=64)
    tp = IdentityCleanerPipeline(tc, Schedule.v21(), torch.device("cpu"), min_cond_size=64,
                                 tokenizer=word_tokenizer)
    lq = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    # "fused" runs the default negative prompt through the tokenizer, so cond
    # and uncond differ; "int8" keeps both prompts empty, the inputs its 4-LSB
    # limit was set on: with distinct texts CFG (4.0) multiplies the cond -
    # uncond difference, and with it the bf16 rounding-order spread above
    # (10 LSB on these inputs)
    prompts = {} if mode == "fused" else {"neg_prompt": ""}
    ref = jp.run(lq, steps=STEPS, cfg_scale=CFG, seed=5, **prompts)
    x_T, noise = jax_noise(5, (1, 8, 8, 4), STEPS)
    out = tp.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, **prompts)
    assert out.shape == ref.shape == (1, 64, 64, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= LSB_TOL[mode]
    assert ref.std() > 1.0
    if mode == "int8":  # the limit's power: the float model misses it
        _, _, float_model = _pair("fused", float_params)
        tp_f = IdentityCleanerPipeline(float_model, Schedule.v21(), torch.device("cpu"),
                                       min_cond_size=64, tokenizer=word_tokenizer)
        out_f = tp_f.run(lq, steps=STEPS, cfg_scale=CFG, x_T=x_T, noise_table=noise, **prompts)
        assert np.abs(out_f.astype(int) - ref.astype(int)).max() > LSB_TOL[mode]
