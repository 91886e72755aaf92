"""The int8 serving mode's pieces against the JAX package, on the CPU:
the quantisers (bit-equal int8 and scales), K4's plain version against the
Pallas kernel in interpret mode and the XLA fallback, ``QuantLinear``
against ``QuantDense``, the converter on a quantised tree, and the kernel
build key.

Tolerances: K4's plain version rounds x to bf16 on both sides and sums exact
bf16 x int8 products in fp32, so fp32 outputs agree to 1e-5 x max|ref| (the
sum order); bf16 outputs to one bf16 ulp of the largest value (2^-8 x
max|ref|, a rounding that lands on either side).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models import cldm as jax_cldm
from diffbir_tpu.models.layers import QuantDense
from diffbir_tpu.ops import fused_resblock as jax_fr
from diffbir_tpu.ops import quant_matmul as jax_qm
from diffbir_tpu_torch.models import cldm as port_cldm
from diffbir_tpu_torch.ops import _cuda
from diffbir_tpu_torch.ops import fused_resblock as port_fr
from diffbir_tpu_torch.ops import quant_matmul as port_qm
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import fill_params

FP32_TOL, BF16_TOL = 1e-5, 2.0 ** -8


def _err_limit(ref, out, tol):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    return np.abs(ref - out).max(), tol * np.abs(ref).max()


def _weights(shape, seed):
    """Seeded weights with an all-zero output channel (the scale floor) and
    a channel whose absmax is 127, so w / scale hits .5 ties exactly."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0
    tie = np.round(rng.standard_normal(shape[:-1]) * 30) + 0.5
    tie.reshape(-1)[0] = 127.0
    w[..., 1] = tie
    return w


@pytest.mark.parametrize("shape", [(320, 640), (77, 130), (1024, 5)])
def test_quantize_weight_is_bit_equal_to_jax(shape):
    w = _weights(shape, 0)
    q_ref, s_ref = jax_qm.quantize_weight(jnp.asarray(w))
    q, s = port_qm.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert s[0].item() == np.float32(1e-8)


@pytest.mark.parametrize("shape", [(3, 3, 64, 96), (1, 1, 96, 32), (3, 3, 7, 5)])
def test_quantize_conv_weight_is_bit_equal_to_jax(shape):
    w = _weights(shape, 1)
    q_ref, s_ref = jax_fr.quantize_conv_weight(jnp.asarray(w))
    q, s = port_fr.quantize_conv_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert s[0].item() == np.float32(np.float32(1e-12) / np.float32(127.0))


@pytest.mark.parametrize("m,k,n", [(154, 256, 384), (128, 320, 320), (2, 1280, 320)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_ref_matches_pallas_and_xla(m, k, n, dtype):
    """The 320-wide case, which the JAX dispatch sends to XLA, goes through
    the Pallas kernel here too (interpret mode takes any block)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q, scale = jax_qm.quantize_weight(jnp.asarray(_weights((k, n), 3)))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    pallas = jax_qm._pallas_quant_matmul(xj, w_q, scale, block_n=n, block_k=k,
                                         interpret=True)
    xla = jax_qm._xla_quant_matmul(xj, w_q, scale)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = port_qm.quant_matmul(xt, torch.from_numpy(np.array(w_q)),
                               torch.from_numpy(np.array(scale)))
    assert out.dtype == xt.dtype and out.shape == (m, n)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    for ref in (pallas, xla):
        err, limit = _err_limit(np.asarray(ref.astype(jnp.float32)), out.float().numpy(), tol)
        assert err <= limit, (err, limit)


def test_quant_linear_matches_quant_dense():
    """QuantLinear from a float Linear == QuantDense on the quantised tree:
    same int8 tensor (the JAX [in, out] layout), bias added after."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((96, 160)).astype(np.float32) * 0.1
    b = rng.standard_normal(160).astype(np.float32)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    q, s = jax_qm.quantize_weight(jnp.asarray(w))
    params = {"params": {"kernel_q": q, "scale": s, "bias": jnp.asarray(b)}}
    ref = QuantDense(160).apply(params, jnp.asarray(x))
    lin = torch.nn.Linear(96, 160)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    ql = port_qm.QuantLinear.from_linear(lin)
    assert ql.weight_q.is_contiguous()  # else every K4 call copies it
    np.testing.assert_array_equal(ql.weight_q.numpy(), np.asarray(q))
    loaded = port_qm.QuantLinear(96, 160)
    loaded.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    with torch.no_grad():
        for mod in (ql, loaded):
            err, limit = _err_limit(ref, mod(torch.from_numpy(x)).numpy(), FP32_TOL)
            assert err <= limit, (err, limit)


def test_converter_loads_the_quantised_jax_tree():
    """A JAX quantize_dense_params + quantize_conv_params tree of
    ControlLDM.tiny converts (kernel_q -> weight_q int8 in the JAX layout,
    scale -> weight_scale fp32) and loads strict=True into the port's int8
    model, equal to the port's own in-place quantisation of the same float
    weights."""
    jc = jax_cldm.ControlLDM.tiny()
    params = fill_params(jc.eval_shapes((8, 8)), seed=0)
    jq = jax.device_get(jax_cldm.quantize_conv_params(jax_cldm.quantize_dense_params(params)))
    converted = flax_to_state_dict({k: jq[k] for k in ("unet", "controlnet", "vae", "clip")})
    target = port_cldm.ControlLDM.tiny(quant_dense=True, fused_resblock=True, quant_conv=True)
    target.load_state_dict(converted, strict=True)

    own = port_cldm.ControlLDM.tiny(fused_resblock=True)
    own.load_state_dict(flax_to_state_dict(params), strict=True)
    port_cldm.quantize_conv_params(port_cldm.quantize_dense_params(own))
    sd_target, sd_own = target.state_dict(), own.state_dict()
    assert sd_target.keys() == sd_own.keys()
    n_int8 = 0
    for key, t in sd_target.items():
        assert t.dtype == sd_own[key].dtype, key
        assert torch.equal(t, sd_own[key]), key
        n_int8 += t.dtype == torch.int8
    # 12 dense sites in each of 16 transformers, 18 emb_layers.1; 2 convs in
    # each of 18 ResBlocks, plus the 1x1 skips
    n_skip = sum(k.endswith("skip_connection.weight_q") for k in sd_target)
    assert n_skip > 0 and n_int8 == 16 * 12 + 18 + 2 * 18 + n_skip
    assert converted["unet.input_blocks.1.0.in_layers.2.weight_q"].shape == (3, 3, 32, 32)
    assert converted["unet.input_blocks.1.1.proj_in.weight_q"].shape == (32, 32)


def test_build_key_covers_the_shared_headers(tmp_path):
    """Editing a csrc/*.cuh header changes every source's library name, so a
    stale library is never loaded; editing an unrelated file does not."""
    src = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    source = src / "quant_matmul.cu"
    before = _cuda.build_key(source)
    (src / "notes.txt").write_text("not a header")
    assert _cuda.build_key(source) == before
    header = src / "tile_gemm.cuh"
    header.write_text(header.read_text() + "\n// touched\n")
    assert _cuda.build_key(source) != before
