"""The port's tiled high-resolution path against the JAX package, fp32 on
the CPU, on tiny configs and seeded numpy inputs.

- ``tiling.py``: ``sliding_windows`` and ``gaussian_weights`` equal to
  JAX's; ``make_tiled_fn`` on a fixed convolution with the same weights
  (scale up and down, a channel change, ``tiles_per_batch`` 1, 2 and 4 with
  a short last chunk, ``tile_coords``, and more than 32 tiles, where JAX
  runs its ``lax.scan`` branch): 1e-5 x max|ref|.
- ``GroupNorm32(cross_batch=True)`` against JAX's, and equal to the plain
  GroupNorm of the stitched image: 1e-5 x max|ref|.
- ``vae_stream.decode_sync`` / ``encode_sync_moments`` against JAX's on the
  tiny VAE at chunk 2 and 64, and against the port's own
  ``Decoder(gn_cross=True)`` / ``Encoder(gn_cross=True)`` on the stacked
  tiles: 1e-4 x max(1, max|ref|) (``test_torch_models``' model tolerance).
- ``ControlLDM.vae_encode`` / ``vae_decode`` tiled, "blend" and "sync_gn",
  against JAX's on converted weights: the same tolerance.
- The tiled SwinIR cleaner (tile 64, stride 32) against JAX's: 1e-4.
- ``IdentityCleanerPipeline.run`` with the diffusion and the VAE decoder
  tiled, CFG on the stand-in tokenizer's prompts, ``tiles_per_batch`` 1 (a
  96x96 LQ) and 4 (128x128, a short last group), against JAX within 1 uint8
  level; the port is handed JAX's x_T and step noise. (The JAX tiled
  program unrolls one UNet per tile group: ~8 s of compile each.)
- The policy: sync_gn falls back to blend at batch 2, tiny inputs switch
  tiling off, and the tile-size and turbo ValueErrors.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from diffbir_tpu import tiling as jax_tiling
from diffbir_tpu.models.clip import CLIPTextEncoder as JaxCLIP
from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.models.layers import GroupNorm32 as JaxGroupNorm32
from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.models.unet import ControlNet as JaxControlNet
from diffbir_tpu.models.unet import UNetModel as JaxUNet
from diffbir_tpu.models.vae import AutoencoderKL as JaxVAE
from diffbir_tpu.models.vae_stream import decode_sync as jax_decode_sync
from diffbir_tpu.models.vae_stream import encode_sync_moments as jax_encode_sync
from diffbir_tpu.pipeline import IdentityCleanerPipeline as JaxIdentityPipeline
from diffbir_tpu.pipeline import SwinIRPipeline as JaxSwinIRPipeline
from diffbir_tpu.schedule import Schedule as JaxSchedule
from diffbir_tpu_torch import tiling
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.clip import CLIPTextEncoder
from diffbir_tpu_torch.models.layers import GroupNorm32
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
from diffbir_tpu_torch.models.vae import AutoencoderKL, Decoder, Encoder
from diffbir_tpu_torch.models.vae_stream import decode_sync, encode_sync_moments
from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline, SwinIRPipeline
from diffbir_tpu_torch.schedule import Schedule
from tests.test_torch_models import CLIP_KW, UNET_KW, assert_close, fill_params, load_port
from tests.test_torch_pipeline import jax_noise, word_tokenizer

SWIN_KW = dict(embed_dim=24, depths=(2,), num_heads=(4,), window_size=4)
# a true f8 VAE, as ControlLDM.tiny's; the UNet of test_torch_models (one
# ResBlock per level), whose JAX pipeline compiles faster than tiny()'s
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
TILE_TOL = 1e-5


def rel_close(ref, out, tol=TILE_TOL):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err, bound = np.abs(ref - out).max(), tol * np.abs(ref).max()
    assert err <= bound, f"max abs err {err} > {bound}"


# --------------------------------------------------------------------------- #
# tiling.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("h,w,size,stride", [
    (100, 70, 32, 24), (128, 128, 64, 32), (1024, 1024, 512, 256), (128, 128, 8, 4),
    (64, 48, 64, 32), (40, 56, 16, 16), (72, 88, 24, 10)])
def test_windows_and_weights_equal_jax(h, w, size, stride):
    assert tiling.sliding_windows(h, w, size, stride) == \
        jax_tiling.sliding_windows(h, w, size, stride)
    np.testing.assert_array_equal(tiling.gaussian_weights(size, stride + 3),
                                  jax_tiling.gaussian_weights(size, stride + 3))


def conv_pair(cin, cout, seed, stride=1):
    """One 3x3 convolution with the same seeded weights as a JAX and a port
    NHWC function."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)

    def jax_fn(x):
        y = jax.lax.conv_general_dilated(x, jnp.asarray(k), (stride, stride), [(1, 1), (1, 1)],
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + bias

    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()

    def port_fn(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), wt, torch.from_numpy(bias), stride=stride, padding=1)
        return y.permute(0, 2, 3, 1)

    return jax_fn, port_fn


def _up2(fn, lib):
    def up(x):
        y = fn(x)
        if lib == "jax":
            return jnp.repeat(jnp.repeat(y, 2, 1), 2, 2)
        return y.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return up


# (case, input hw, size, stride, kwargs): 9 tiles unless named
TILED_CASES = [
    ("same", (40, 40), 16, 12, {}),
    ("up2_channels", (40, 40), 16, 12, dict(scale_type="up", scale=2, channel=5)),
    ("down2", (48, 40), 16, 8, dict(scale_type="down", scale=2, channel=5)),
    ("per2_short_last", (40, 40), 16, 12, dict(tiles_per_batch=2)),
    ("per4_short_last", (40, 40), 16, 12, dict(tiles_per_batch=4)),
    ("down2_per3_short_last", (48, 40), 16, 8, dict(scale_type="down", scale=2,
                                                     tiles_per_batch=3)),
    ("scan_195_tiles", (64, 56), 8, 4, dict(scale_type="up", scale=2)),
    ("scan_per4", (64, 56), 8, 4, dict(tiles_per_batch=4)),
]


@pytest.mark.parametrize("case,hw,size,stride,kw", TILED_CASES, ids=[c[0] for c in TILED_CASES])
def test_make_tiled_fn_matches_jax(case, hw, size, stride, kw):
    cout = kw.get("channel", 3)
    down = kw.get("scale_type") == "down"
    jax_fn, port_fn = conv_pair(3, cout, seed=len(case), stride=2 if down else 1)
    if kw.get("scale_type") == "up":
        jax_fn, port_fn = _up2(jax_fn, "jax"), _up2(port_fn, "torch")
    x = np.random.default_rng(1).random((2, *hw, 3)).astype(np.float32)
    n_tiles = len(tiling.sliding_windows(*hw, size, stride))
    if case.startswith("scan"):
        assert n_tiles > jax_tiling.SCAN_THRESHOLD
    ref = jax_tiling.make_tiled_fn(jax_fn, size, stride, **kw)(jnp.asarray(x))
    out = tiling.make_tiled_fn(port_fn, size, stride, **kw)(torch.from_numpy(x))
    assert out.dtype == torch.float32
    rel_close(ref, out.numpy())


@pytest.mark.parametrize("per", [1, 2, 4])
def test_tile_coords_slice_an_auxiliary_input_in_step(per):
    """A function that declares ``tile_coords`` gets each chunk's corners
    and slices a second input there (the diffusion hint's protocol); the
    sum of both per tile, blended, equals JAX's."""
    x, aux = (np.random.default_rng(s).random((2, 40, 40, 4)).astype(np.float32) for s in (2, 3))
    jax_conv, port_conv = conv_pair(4, 4, seed=7)

    def jax_fn(t, a, tile_coords=()):
        sl = jnp.concatenate([a[:, hi: hi + 16, wi: wi + 16] for hi, wi in tile_coords], 0)
        return jax_conv(t) * sl

    jax_fn.tile_kwargs = ("tile_coords",)
    seen = []

    def port_fn(t, a, tile_coords=()):
        seen.append(tile_coords)
        sl = torch.cat([a[:, hi: hi + 16, wi: wi + 16] for hi, wi in tile_coords], 0)
        return port_conv(t) * sl

    ref = jax_tiling.make_tiled_fn(jax_fn, 16, 12, tiles_per_batch=per)(
        jnp.asarray(x), jnp.asarray(aux))
    out = tiling.make_tiled_fn(port_fn, 16, 12, tiles_per_batch=per)(
        torch.from_numpy(x), torch.from_numpy(aux))
    rel_close(ref, out.numpy())
    coords = tiling.sliding_windows(40, 40, 16, 12)
    assert [c for chunk in seen for c in chunk] == coords
    assert [len(c) for c in seen] == [min(per, len(coords) - i)
                                      for i in range(0, len(coords), per)]


# --------------------------------------------------------------------------- #
# cross-batch GroupNorm
# --------------------------------------------------------------------------- #
def test_cross_batch_groupnorm_matches_jax_and_the_stitched_image():
    rng = np.random.default_rng(7)
    full = (rng.standard_normal((1, 16, 16, 64)) + np.linspace(-2, 2, 16)[None, :, None, None]
            ).astype(np.float32)
    tiles = np.concatenate([full[:, i:i + 8, j:j + 8] for i in (0, 8) for j in (0, 8)], 0)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jgn = JaxGroupNorm32(eps=1e-6, cross_batch=True)
    ref = jgn.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(tiles))
    gn = GroupNorm32(64, eps=1e-6, cross_batch=True)
    plain = GroupNorm32(64, eps=1e-6)
    with torch.no_grad():
        for m in (gn, plain):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        out = gn(torch.from_numpy(tiles).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        whole = plain(torch.from_numpy(full).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    rel_close(ref, out)
    stitched = np.zeros_like(full)
    for t, (i, j) in enumerate([(0, 0), (0, 8), (8, 0), (8, 8)]):
        stitched[:, i:i + 8, j:j + 8] = out[t:t + 1]
    rel_close(whole, stitched)
    assert list(gn.state_dict()) == ["weight", "bias"]


# --------------------------------------------------------------------------- #
# vae_stream and the tiled VAE
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_cldm():
    jc = JaxControlLDM(unet=JaxUNet(**UNET_KW), vae=JaxVAE(**VAE_KW), clip=JaxCLIP(**CLIP_KW),
                       controlnet=JaxControlNet(**UNET_KW))
    params = fill_params(jc.eval_shapes((8, 8)), seed=0)
    tc = ControlLDM(unet=UNetModel(**UNET_KW), vae=AutoencoderKL(**VAE_KW),
                    clip=CLIPTextEncoder(**CLIP_KW), controlnet=ControlNet(**UNET_KW))
    return jc, jax.tree_util.tree_map(jnp.asarray, params), load_port(tc, params)


def _tiles(seed, shape, ramp=1.0):
    """Seeded tiles with a ramp across the tile axis, so tiles differ in
    their statistics."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.5
    return x + ramp * np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None, None, None]


@pytest.mark.parametrize("chunk", [2, 64])
def test_vae_stream_matches_jax_and_gn_cross_modules(tiny_cldm, chunk):
    jc, params, tc = tiny_cldm
    vae = jc.vae
    z = _tiles(1, (5, 12, 12, 4))
    img = _tiles(2, (3, 32, 32, 3), ramp=0.5)
    kw = dict(ch_mult=vae.ch_mult, num_res_blocks=vae.num_res_blocks, dtype=vae.dtype,
              chunk=chunk)
    ref_dec = jax.jit(lambda p, v: jax_decode_sync(p, v, **kw))(params["vae"], z)
    ref_mean, ref_logvar = jax.jit(lambda p, v: jax_encode_sync(p, v, **kw))(params["vae"], img)
    dec = decode_sync(tc.vae, torch.from_numpy(z), chunk=chunk)
    mean, logvar = encode_sync_moments(tc.vae, torch.from_numpy(img), chunk=chunk)
    assert_close(ref_dec, dec.numpy())
    assert_close(ref_mean, mean.numpy())
    assert_close(ref_logvar, logvar.numpy())
    # the exactness contract: the modules with gn_cross on the stacked tiles
    dec_x = Decoder(**VAE_KW, gn_cross=True)
    dec_x.load_state_dict(tc.vae.decoder.state_dict())
    enc_x = Encoder(**VAE_KW, gn_cross=True)
    enc_x.load_state_dict(tc.vae.encoder.state_dict())
    with torch.no_grad():
        whole = dec_x(tc.vae.post_quant_conv(torch.from_numpy(z).permute(0, 3, 1, 2)))
        moments = tc.vae.quant_conv(enc_x(torch.from_numpy(img).permute(0, 3, 1, 2)))
    assert_close(whole.permute(0, 2, 3, 1).numpy(), dec.numpy())
    assert_close(moments[:, :4].permute(0, 2, 3, 1).numpy(), mean.numpy())


@pytest.mark.parametrize("mode", ["blend", "sync_gn"])
def test_tiled_vae_encode_decode_match_jax(tiny_cldm, mode):
    """A 96x112 image, encoder tile 64 (blend: 4 tiles at stride 32; sync_gn:
    4 tiles, padded to 128x128, with a 32-pixel halo); a 16x20 latent,
    decoder tile 12 (blend: 4 tiles at stride 6; sync_gn: 4 tiles, padded to
    24x24, with an 11-pixel halo)."""
    jc, params, tc = tiny_cldm
    rng = np.random.default_rng(5)
    img = (rng.random((1, 96, 112, 3)) * 2 - 1).astype(np.float32)
    z = (rng.standard_normal((1, 16, 20, 4)) * 0.5).astype(np.float32)
    ref_z = jax.jit(lambda p, x: jc.vae_encode(p, x, sample=False, tiled=True, tile_size=64,
                                               tile_mode=mode))(params, img)
    ref_x = jax.jit(lambda p, v: jc.vae_decode(p, v, tiled=True, tile_size=12,
                                               tile_mode=mode))(params, z)
    with torch.no_grad():
        out_z = tc.vae_encode(torch.from_numpy(img), sample=False, tiled=True, tile_size=64,
                              tile_mode=mode)
        out_x = tc.vae_decode(torch.from_numpy(z), tiled=True, tile_size=12, tile_mode=mode)
    assert out_z.shape == (1, 12, 14, 4) and out_x.shape == (1, 128, 160, 3)
    assert_close(ref_z, out_z.numpy())
    assert_close(ref_x, out_x.numpy())


def test_tiled_swinir_cleaner_matches_jax():
    js = JaxSwinIR(**SWIN_KW)
    sparams = fill_params(
        jax.eval_shape(js.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), seed=1)
    ts = load_port(SwinIR(**SWIN_KW), sparams)
    cleaner = jax.jit(lambda x: jnp.clip(js.apply(sparams, x), 0.0, 1.0))
    jp = JaxSwinIRPipeline(cleaner, None, None, None, min_cond_size=64)
    tp = SwinIRPipeline(ts, None, None, torch.device("cpu"), min_cond_size=64)
    lq = np.random.default_rng(6).random((1, 128, 96, 3)).astype(np.float32)
    ref = jp.apply_cleaner(jnp.asarray(lq), True, 64, 32)
    with torch.no_grad():
        out = tp.apply_cleaner(torch.from_numpy(lq), True, 64, 32)
        untiled = tp.apply_cleaner(torch.from_numpy(lq))
    assert out.shape == (1, 128, 96, 3)
    assert_close(ref, out.numpy())
    assert np.abs(out.numpy() - untiled.numpy()).max() > 1e-3  # the tiles did blend
    with pytest.raises(ValueError, match="multiple of 64"):
        tp.apply_cleaner(torch.from_numpy(lq), True, 96, 48)


# --------------------------------------------------------------------------- #
# the tiled pipeline
# --------------------------------------------------------------------------- #
TILED_RUN = dict(cldm_tiled=True, cldm_tile_size=64, cldm_tile_stride=32,
                 vae_decoder_tiled=True, vae_decoder_tile_size=64)


@pytest.fixture(scope="module")
def identity_pair(tiny_cldm):
    jc, params, tc = tiny_cldm
    sched = JaxSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                               linear_end=0.0120, parameterization="v", zero_snr=True)
    jp = JaxIdentityPipeline(None, jc, params, sched, tokenizer=word_tokenizer,
                             min_cond_size=64)
    return jp, IdentityCleanerPipeline(tc, Schedule.v21(), torch.device("cpu"), min_cond_size=64,
                                       tokenizer=word_tokenizer)


@pytest.mark.parametrize("size,per", [(96, 1), (128, 4)])
def test_tiled_identity_pipeline_matches_jax(identity_pair, size, per):
    """LQs of 96x96 (4 latent tiles of 8x8 at stride 4, one model call
    each) and 128x128 (9 tiles in groups of 4, the last one short: JAX pads
    it), decoder tile 64 (4 and 9 tiles), 2 spaced steps at CFG 4.0 on the
    stand-in tokenizer's prompts."""
    jp, tp = identity_pair
    lq = np.random.default_rng(4).integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    kw = dict(steps=2, cfg_scale=4.0, pos_prompt="a red fox", cldm_tiles_per_batch=per,
              **TILED_RUN)
    ref = jp.run(lq, seed=3, **kw)
    x_T, noise = jax_noise(3, (1, size // 8, size // 8, 4), 2)
    out = tp.run(lq, x_T=x_T, noise_table=noise, **kw)
    assert out.shape == ref.shape == (1, size, size, 3) and ref.std() > 1.0
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_batch_two_sync_gn_falls_back_to_blend(identity_pair):
    _, tp = identity_pair
    lq = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    kw = dict(steps=2, cfg_scale=1.5, neg_prompt="", seed=5, vae_decoder_tiled=True,
              vae_decoder_tile_size=32, vae_encoder_tiled=True, vae_encoder_tile_size=32)
    sync = tp.run(lq, vae_tile_mode="sync_gn", **kw)
    blend = tp.run(lq, vae_tile_mode="blend", **kw)
    assert sync.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(sync, blend)
    one = tp.run(lq[:1], vae_tile_mode="sync_gn", **kw)
    assert np.any(one[0] != tp.run(lq[:1], vae_tile_mode="blend", **kw)[0])


def test_tiny_inputs_switch_tiling_off_and_policy_errors(identity_pair):
    _, tp = identity_pair
    lq = np.random.default_rng(8).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    kw = dict(steps=2, cfg_scale=1.5, neg_prompt="", seed=5)
    plain = tp.run(lq, **kw)
    big = tp.run(lq, cldm_tiled=True, vae_encoder_tiled=True, vae_decoder_tiled=True,
                 vae_encoder_tile_size=128, vae_decoder_tile_size=128, **kw)
    np.testing.assert_array_equal(plain, big)
    with pytest.raises(ValueError, match="VAE encoder tile size must be a multiple of 8"):
        tp.run(lq, vae_encoder_tiled=True, vae_encoder_tile_size=60, **kw)
    with pytest.raises(ValueError, match="Diffusion tile size must be a multiple of 64"):
        tp.run(lq, cldm_tiled=True, cldm_tile_size=32, cldm_tile_stride=16, **kw)
    with pytest.raises(ValueError, match="control_interval > 1 .* cldm_tiled"):
        tp.run(lq, cldm_tiled=True, cldm_tile_size=64, control_interval=2, **kw)
