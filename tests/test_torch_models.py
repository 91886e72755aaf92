"""diffbir_tpu_torch models against the JAX package, fp32 on the CPU.

Weights: the JAX module's param shapes (``eval_shape``, no init compile) are
filled from a seeded numpy generator, every leaf non-zero (zero-init layers
included, so every path carries signal); the same tree goes to JAX as params
and to the port through ``weights.convert.flax_to_state_dict`` with
``load_state_dict(strict=True)``. Inputs are seeded numpy arrays.
Tolerance: max abs error <= 1e-4 * max(1, max |ref|).
"""

import numpy as np
import pytest
import torch

import jax

from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.models.clip import CLIPTextEncoder as JaxCLIP
from diffbir_tpu.models.unet import ControlNet as JaxControlNet
from diffbir_tpu.models.unet import UNetModel as JaxUNet
from diffbir_tpu.models.vae import AutoencoderKL as JaxVAE
from diffbir_tpu_torch.models import cldm as port_cldm
from diffbir_tpu_torch.models.clip import CLIPTextEncoder
from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
from diffbir_tpu_torch.models.vae import AutoencoderKL
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.weights.convert import convert_leaf, flax_to_state_dict

# head dim 64 (so self-attention takes the flash dispatch), two levels
UNET_KW = dict(model_channels=64, num_head_channels=64, channel_mult=(1, 2),
               attention_resolutions=(2, 1), context_dim=64, num_res_blocks=1)
VAE_KW = dict(ch=64, ch_mult=(1, 1), num_res_blocks=1)  # mid attention d=64
CLIP_KW = dict(width=64, heads=4, layers=3)


def fill_params(shapes, seed=0):
    """Seeded non-zero values for an eval_shape param tree (numpy fp32)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("embedding", "in_proj_weight", "positional_embedding",
                    "relative_position_bias_table"):
            return rng.standard_normal(s.shape) / np.sqrt(s.shape[-1])
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def load_port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.eval()


def assert_close(ref, out, tol=1e-4):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err = np.abs(ref - out).max()
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"max abs err {err} > {bound}"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def tiny_pair(seed=0):
    """(JAX ControlLDM, filled params, port ControlLDM) at the test sizes."""
    jc = JaxControlLDM(unet=JaxUNet(**UNET_KW), vae=JaxVAE(**VAE_KW),
                       clip=JaxCLIP(**CLIP_KW), controlnet=JaxControlNet(**UNET_KW))
    params = fill_params(jc.eval_shapes((8, 8)), seed)
    tc = port_cldm.ControlLDM(
        unet=UNetModel(**UNET_KW), vae=AutoencoderKL(**VAE_KW),
        clip=CLIPTextEncoder(**CLIP_KW), controlnet=ControlNet(**UNET_KW))
    return jc, params, load_port(tc, params)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return dict(
        x=rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
        c_img=rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
        c_txt=rng.standard_normal((2, 77, 64)).astype(np.float32),
        t=np.array([999.0, 21.0], np.float32),
        img=rng.random((1, 64, 48, 3)).astype(np.float32),
        tokens=np.concatenate(
            [np.array([[49406, 320, 1125, 49407]]), np.zeros((1, 73), np.int64)], 1),
    )


def test_unet_with_control_matches_jax(pair, inputs):
    jc, params, tc = pair
    rng = np.random.default_rng(2)
    x, t, ctx = inputs["x"], inputs["t"], inputs["c_txt"]
    shapes = jax.eval_shape(
        lambda: jc.controlnet.apply(params["controlnet"], x, inputs["c_img"], t, ctx))
    control = tuple(rng.standard_normal(s.shape).astype(np.float32) for s in shapes)
    ref = jax.jit(lambda p, c: jc.unet.apply(p, x, t, ctx, control=c))(params["unet"], control)
    with torch.no_grad():
        out = tc.unet(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      control=tuple(nchw(c) for c in control))
    assert_close(ref, to_nhwc(out))


def test_controlnet_matches_jax(pair, inputs):
    jc, params, tc = pair
    ref = jax.jit(jc.controlnet.apply)(
        params["controlnet"], inputs["x"], inputs["c_img"], inputs["t"], inputs["c_txt"])
    with torch.no_grad():
        out = tc.controlnet(nchw(inputs["x"]), nchw(inputs["c_img"]),
                            torch.from_numpy(inputs["t"]), torch.from_numpy(inputs["c_txt"]))
    assert len(out) == len(ref) == 5
    for r, o in zip(ref, out):
        assert_close(r, to_nhwc(o))


def test_cldm_call_matches_jax_through_flash_dispatch(pair, inputs, monkeypatch):
    """ControlNet -> scaled residuals -> UNet; every self-attention site
    (d=64) goes through the flash wrapper (its plain version on the CPU)."""
    jc, params, tc = pair
    cond = {"c_img": inputs["c_img"], "c_txt": inputs["c_txt"]}
    ref = jax.jit(lambda p, x, t, c: jc(p, x, t, c, control_scales=0.7))(
        params, inputs["x"], inputs["t"], cond)
    calls = []
    real = port_flash.flash_attention
    monkeypatch.setattr(port_flash, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    with torch.no_grad():
        out = tc(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
                 {k: torch.from_numpy(v) for k, v in cond.items()}, control_scales=0.7)
    assert_close(ref, out.numpy())
    # self-attention sites: UNet 2 in + 1 mid + 4 out, ControlNet 2 in + 1 mid
    assert len(calls) == 10
    assert port_flash.KERNEL.launches == 0  # no kernel on the CPU


def test_clip_matches_jax(pair, inputs):
    jc, params, tc = pair
    ref = jax.jit(jc.clip.apply)(params["clip"], inputs["tokens"].astype(np.int32))
    with torch.no_grad():
        out = tc.clip(torch.from_numpy(inputs["tokens"]))
    assert_close(ref, out.numpy())


def test_prepare_condition_matches_jax(pair, inputs):
    """VAE encode (posterior mean, scaled) + CLIP text features."""
    jc, params, tc = pair
    ref = jax.jit(jc.prepare_condition)(params, inputs["img"],
                                        inputs["tokens"].astype(np.int32))
    with torch.no_grad():
        out = tc.prepare_condition(torch.from_numpy(inputs["img"]),
                                   torch.from_numpy(inputs["tokens"]))
    for key in ("c_txt", "c_img"):
        assert_close(ref[key], out[key].numpy())


def test_vae_encode_decode_matches_jax(pair, inputs):
    jc, params, tc = pair
    img = inputs["img"] * 2 - 1
    mean, logvar = jax.jit(lambda p, x: jc.vae.apply(p, x, method=jc.vae.encode_moments))(
        params["vae"], img)
    z = inputs["x"][:1, :8, :6]
    dec = jax.jit(jc.vae_decode)(params, z)
    with torch.no_grad():
        t_mean, t_logvar = tc.vae.encode_moments(nchw(img))
        t_dec = tc.vae_decode(torch.from_numpy(z))
    assert_close(mean, to_nhwc(t_mean))
    assert_close(logvar, to_nhwc(t_logvar))
    assert_close(dec, t_dec.numpy())


def converted_shapes(shapes) -> dict:
    """{torch key: shape} of an eval_shape param tree, converted by the
    port's rules on zero-stride views (nothing is allocated)."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key, v = convert_leaf(tuple(p.key for p in path),
                              np.broadcast_to(np.float32(0), s.shape))
        out[key] = tuple(v.shape)
    return out


def test_sd21_structure_matches_jax_on_meta():
    """Full-width sd21: the port's state-dict keys and shapes equal the
    conversion of the JAX param tree, without computing anything."""
    ref = converted_shapes(JaxControlLDM.sd21().eval_shapes((64, 64)))
    port = port_cldm.ControlLDM.sd21(device=torch.device("meta"))
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got.keys() == ref.keys()
    assert got == ref
    n_params = sum(int(np.prod(s)) for s in got.values())
    assert n_params > 1_500_000_000  # UNet + ControlNet + VAE + 23-block CLIP

