"""The port's BSRNet and SCUNet cleaners and their pipelines against the JAX
package, fp32 on the CPU.

- ``RRDBNet`` (x4 and x2) and ``SCUNet`` (two blocks in some stages, so the
  shifted windows and their mask run; sizes that are no multiple of 64, so
  its edge pad runs; batch 2) on the JAX module's weights, converted with
  ``weights.convert.flax_to_state_dict``;
- the other direction: the port's SCUNet ``state_dict`` filled into the JAX
  tree by the JAX ``fill_flax_params`` (the KAIR checkpoint's layout,
  ConvTranspose weights (in, out, kh, kw)), the outputs equal;
- the ConvTranspose kernel both ways: flax's ``transpose_kernel=True``
  layout by the HWIO rule, flax's default layout (flipped) by the module's
  shapes against ``nn.ConvTranspose``'s own output, and the ambiguous
  in == out case refused on both sides;
- ``BSRNetPipeline.apply_cleaner`` (x4, then bicubic to lq x upscale, or
  the short edge to ``min_cond_size``) and ``SCUNetPipeline.apply_cleaner``
  untiled and tiled, against the JAX pipelines.

Weights are seeded numpy (``tests.test_torch_models.fill_params``); inputs
seeded numpy. Tolerance: max abs error <= 1e-4 * max(1, max |ref|). The
JAX references are jitted, one compile each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from diffbir_tpu.models.bsrnet import RRDBNet as JaxRRDBNet
from diffbir_tpu.models.scunet import SCUNet as JaxSCUNet
from diffbir_tpu.pipeline import BSRNetPipeline as JaxBSRNetPipeline
from diffbir_tpu.pipeline import SCUNetPipeline as JaxSCUNetPipeline
from diffbir_tpu.weights import convert as jax_convert
from diffbir_tpu_torch.models.bsrnet import RRDBNet
from diffbir_tpu_torch.models.scunet import SCUNet
from diffbir_tpu_torch.pipeline import BSRNetPipeline, SCUNetPipeline
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import assert_close, fill_params

RRDB_KW = dict(nf=8, nb=2, gc=4)
# two blocks in some stages: a plain and a shifted window block
SCU_KW = dict(config=(2, 1, 1, 2, 1, 1, 2), dim=16, head_dim=8)
CPU = torch.device("cpu")


def _shapes(module, hw=(64, 64)):
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))


def _port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def rrdb():
    jm = JaxRRDBNet(**RRDB_KW, sf=4)
    params = fill_params(_shapes(jm, (16, 16)), seed=3)
    return jax.jit(jm.apply), params, _port(RRDBNet(**RRDB_KW, sf=4), params)


@pytest.fixture(scope="module")
def scunet():
    jm = JaxSCUNet(**SCU_KW)
    params = fill_params(_shapes(jm), seed=4)
    return jax.jit(jm.apply), params, _port(SCUNet(**SCU_KW), params)


def _lq(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 13, 21, 3)])
def test_rrdbnet_matches_jax(rrdb, shape):
    apply, params, tm = rrdb
    x = _lq(shape[1], shape)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    assert_close(apply(params, x), out.numpy())


def test_rrdbnet_x2_matches_jax():
    jm = JaxRRDBNet(**RRDB_KW, sf=2)
    params = fill_params(_shapes(jm, (16, 16)), seed=5)
    x = _lq(0, (1, 12, 10, 3))
    with torch.no_grad():
        out = _port(RRDBNet(**RRDB_KW, sf=2), params)(torch.from_numpy(x))
    assert out.shape == (1, 24, 20, 3)
    assert_close(jm.apply(params, x), out.numpy())
    with pytest.raises(ValueError, match="x8"):
        RRDBNet(**RRDB_KW, sf=8)


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 37, 50, 3), (1, 70, 45, 3)])
def test_scunet_matches_jax(scunet, shape):
    """Edge-padded to x64 (37x50 -> 64x64, 70x45 -> 128x64: several shifted
    windows at each level), batch 2 (the mask tiled per image)."""
    apply, params, tm = scunet
    x = _lq(shape[1], shape)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == shape
    assert_close(apply(params, x), out.numpy())


def test_scunet_state_dict_fills_the_jax_tree(scunet):
    """The port's weights in the checkpoint's layout (ConvTranspose (in, out,
    kh, kw)) read by the JAX loader give the JAX module the same output."""
    apply, params, _ = scunet
    torch.manual_seed(0)
    tm = SCUNet(**SCU_KW).eval()
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    up = tm.m_up3[0].weight.detach()
    assert tuple(up.shape) == (8 * 16, 4 * 16, 2, 2)  # (in, out, kh, kw)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    filled, missing, used = jax_convert.fill_flax_params(params, sd, strict=True)
    assert not missing and used == set(sd)
    np.testing.assert_array_equal(
        filled["params"]["m_up3.0"]["kernel"], up.numpy().transpose(2, 3, 1, 0))
    x = _lq(9, (1, 40, 64, 3))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert_close(apply(filled, x), out.numpy())
    # and back: the JAX tree converts to the port's tensors exactly
    back = flax_to_state_dict(filled, {k: v.shape for k, v in tm.state_dict().items()})
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k


def test_conv_transpose_default_layout_and_refusal():
    """flax's default ConvTranspose layout (kh, kw, in, out), the kernel
    flipped, placed by the module's shapes: the torch layer's output equals
    flax's; with in == out the layouts share a shape and a misfit is refused,
    by the JAX loader and by the port's converter alike."""
    x = _lq(1, (1, 5, 7, 6))
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), use_bias=False)
    params = fill_params(jax.eval_shape(layer.init, jax.random.PRNGKey(0), x), seed=6)
    ref = layer.apply(params, x)
    tl = torch.nn.ConvTranspose2d(6, 4, 2, stride=2, bias=False)
    shapes = {k: v.shape for k, v in tl.state_dict().items()}
    tl.load_state_dict(flax_to_state_dict(params, shapes), strict=True)
    with torch.no_grad():
        out = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (1, 10, 14, 4)
    assert_close(ref, out.numpy())
    # without the shapes the HWIO rule reads it as transpose_kernel=True's
    # (kh, kw, out, in): the strict load then fails on the shape (6 != 4)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tl.load_state_dict(flax_to_state_dict(params), strict=True)
    square = np.zeros((2, 2, 4, 4), np.float32)
    with pytest.raises(ValueError, match="ambiguous"):
        flax_to_state_dict({"up": {"kernel": square}}, {"up.weight": (4, 4, 3, 3)})
    with pytest.raises(ValueError, match="ambiguous"):
        jax_convert._convert_value(square.transpose(3, 2, 0, 1), True, (3, 3, 4, 4))
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict({"up": {"bias": np.zeros(3, np.float32)}}, {"up.bias": (4,)})


@pytest.mark.parametrize("tiled,upscale", [(False, 4.0), (False, 2.0), (True, 4.0),
                                           (True, 3.0)])
def test_bsrnet_pipeline_cleaner_matches_jax(rrdb, tiled, upscale):
    """x4 on the LQ, then bicubic to lq x upscale (the identity-sized resize
    at 4), or the short edge to min_cond_size when the output is smaller
    (x2 of 48x40); tiled: 32-pixel tiles at stride 16, x4 tiles blended."""
    apply, params, tm = rrdb
    x = _lq(7, (1, 48, 40, 3))
    jp = JaxBSRNetPipeline(jax.jit(lambda v: jnp.clip(apply(params, v), 0.0, 1.0)), None,
                           None, None, upscale=upscale, min_cond_size=96)
    tp = BSRNetPipeline(tm, None, None, CPU, upscale=upscale, min_cond_size=96)
    jp.set_output_size(x.shape[1:3])
    tp.set_output_size(x.shape[1:3])
    assert tp.output_size == jp.output_size
    ref = jp.apply_cleaner(jnp.asarray(x), tiled, 32, 16)
    with torch.no_grad():
        out = tp.apply_cleaner(torch.from_numpy(x), tiled, 32, 16)
    expect = {2.0: (115, 96), 3.0: (144, 120), 4.0: (192, 160)}[upscale]
    assert out.shape == (1, *expect, 3)
    assert_close(ref, out.numpy())


@pytest.mark.parametrize("tiled", [False, True])
def test_scunet_pipeline_cleaner_matches_jax(scunet, tiled):
    """x1 SCUNet, tiled at 64 / 32 on a 96x80 LQ (6 tiles) or not; the short
    edge resized up to min_cond_size (96)."""
    apply, params, tm = scunet
    x = _lq(8, (1, 96, 80, 3))
    jp = JaxSCUNetPipeline(jax.jit(lambda v: jnp.clip(apply(params, v), 0.0, 1.0)), None,
                           None, None, min_cond_size=96)
    tp = SCUNetPipeline(tm, None, None, CPU, min_cond_size=96)
    ref = jp.apply_cleaner(jnp.asarray(x), tiled, 64, 32)
    with torch.no_grad():
        out = tp.apply_cleaner(torch.from_numpy(x), tiled, 64, 32)
    assert out.shape == (1, 115, 96, 3)
    assert_close(ref, out.numpy())
