"""diffbir_tpu_torch layers, schedule, attention/flash, utils and guards
against the JAX package, fp32 on the CPU.

The flash kernel's plain version is held against the Pallas kernel run in
interpret mode and against the XLA attention. Tolerances: 1e-5 for the
attention math, 1e-4 * max(1, max |ref|) elsewhere.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffbir_tpu import schedule as jax_schedule
from diffbir_tpu.models import layers as jax_layers
from diffbir_tpu.ops.attention import xla_attention
from diffbir_tpu.ops.flash_attention import _flash_attention_impl
from diffbir_tpu.sampler.spaced import SpacedSampler as JaxSpacedSampler
from diffbir_tpu.utils import common as jax_common
from diffbir_tpu_torch import schedule
from diffbir_tpu_torch.models import layers
from diffbir_tpu_torch.ops import _cuda
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.ops.attention import FLASH_MIN_WIDE, attention, plain_attention
from diffbir_tpu_torch.sampler.spaced import SpacedSampler
from diffbir_tpu_torch.utils import common
from diffbir_tpu_torch.weights.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]


def assert_close(ref, out, tol=1e-4):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err = np.abs(ref - out).max()
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"max abs err {err} > {bound}"


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dim", [320, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 1.0, 499.0, 999.0], np.float32)
    ref = jax_layers.timestep_embedding(jnp.asarray(t), dim)
    assert_close(ref, layers.timestep_embedding(torch.from_numpy(t), dim).numpy())


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm32_matches_jax(eps):
    """Two-pass fp32 statistics on a large-mean input (where one-pass
    variance cancels)."""
    rng = np.random.default_rng(0)
    x = (50.0 + rng.standard_normal((2, 6, 5, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias}}
    ref = jax_layers.GroupNorm32(eps=eps).apply(params, jnp.asarray(x))
    gn = layers.GroupNorm32(64, eps=eps)
    gn.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        out = gn(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert_close(ref, out)


def test_layernorm_fp32_matches_jax_and_keeps_dtype():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    params = {"params": {"scale": (1 + rng.standard_normal(48)).astype(np.float32),
                         "bias": rng.standard_normal(48).astype(np.float32)}}
    ref = jax_layers.LayerNormFp32().apply(params, jnp.asarray(x))
    ln = layers.LayerNormFp32(48)
    ln.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        assert_close(ref, ln(torch.from_numpy(x)).numpy())
        assert ln(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_nearest_upsample_matches_jax():
    x = np.random.default_rng(2).standard_normal((1, 3, 4, 5)).astype(np.float32)
    ref = jax_layers.nearest_upsample_2x(jnp.asarray(x))
    out = layers.nearest_upsample_2x(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert_close(ref, out.numpy().transpose(0, 2, 3, 1), tol=0)


def test_conv_and_dense_layout_conversion():
    """HWIO -> OIHW and (I, O) -> (O, I) with 'kernel' -> 'weight'."""
    rng = np.random.default_rng(3)
    kc = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    kd = rng.standard_normal((5, 7)).astype(np.float32)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    y = rng.standard_normal((2, 5)).astype(np.float32)
    ref_c = jax_layers.conv(6, 3).apply({"params": {"kernel": kc, "bias": np.zeros(6, np.float32)}}, x)
    ref_d = jax_layers.dense(7).apply({"params": {"kernel": kd, "bias": np.ones(7, np.float32)}}, y)
    c, d = layers.conv(4, 6, 3), layers.dense(5, 7)
    c.load_state_dict(flax_to_state_dict({"kernel": kc, "bias": np.zeros(6)}), strict=True)
    d.load_state_dict(flax_to_state_dict({"params": {"kernel": kd, "bias": np.ones(7)}}),
                      strict=True)
    with torch.no_grad():
        assert_close(ref_c, c(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1))
        assert_close(ref_d, d(torch.from_numpy(y)).numpy())


# --------------------------------------------------------------------------- #
# schedule + sampler tables
# --------------------------------------------------------------------------- #
def test_schedule_tables_match_jax():
    jv = jax_schedule.Schedule.create(
        timesteps=1000, beta_schedule="linear", linear_start=0.00085,
        linear_end=0.0120, parameterization="v", zero_snr=True)
    # the v1/v2 eps schedule: the same linear betas without the rescale
    je = jax_schedule.Schedule.create(timesteps=1000, beta_schedule="linear",
                                      linear_start=0.00085, linear_end=0.0120)
    np.testing.assert_array_equal(je.betas, schedule.linear_betas(1000, 0.00085, 0.0120))
    pv = schedule.Schedule.v21()
    np.testing.assert_array_equal(jv.betas, pv.betas)
    for steps in (50, 7):
        jt = JaxSpacedSampler(jv.betas, "v", False).make_tables(steps, 4.0)
        pt = SpacedSampler(pv.betas, "v", False).make_tables(steps, 4.0)
        for key, val in pt.items():
            np.testing.assert_array_equal(jt[key], val, err_msg=key)
    ts = np.array([999.0, 500.0, 1.0])
    np.testing.assert_array_equal(jax_schedule.cfg_scale_schedule(4.0, ts, True),
                                  schedule.cfg_scale_schedule(4.0, ts, True))


# --------------------------------------------------------------------------- #
# attention: the flash kernel's plain version and the dispatch
# --------------------------------------------------------------------------- #
FWD_ENTRIES = (port_flash.KERNEL_TC, port_flash.KERNEL_PRESCALED_TC, port_flash.KERNEL,
               port_flash.KERNEL_PRESCALED, port_flash.KERNEL_WIDE_TC)


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 256, 256, 2, 64),
    (2, 200, 200, 1, 64),   # ragged q and kv against the Pallas blocks
    (1, 130, 77, 2, 64),    # ragged cross shape
    (1, 256, 256, 1, 512),
    (1, 150, 150, 1, 512),
])
def test_flash_ref_matches_pallas_interpret_and_xla(b, sq, skv, h, d):
    rng = np.random.default_rng(sq + d)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    pallas = np.asarray(_flash_attention_impl(q, k, v, interpret=True))
    xla = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = port_flash.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, xla, atol=1e-5, rtol=0)
    # the CPU wrapper is the plain version and launches nothing
    before = [e.launches for e in FWD_ENTRIES]
    wrapped = port_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(wrapped, out)
    assert [e.launches for e in FWD_ENTRIES] == before


def test_plain_attention_mask_and_bias_match_xla():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 9, 3, 16)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, 3, 9, 9)).astype(np.float32)
    mask = np.tril(np.ones((9, 9), bool))[None, None]
    ref = xla_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask),
                        bias=jnp.asarray(bias))
    out = plain_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask),
                          bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_attention_dispatch_sends_only_plain_self_attention_to_flash(monkeypatch):
    calls = []
    monkeypatch.setattr(port_flash, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or port_flash.flash_attention_ref(q, k, v))
    x = torch.randn(1, 16, 2, 64)
    ctx = torch.randn(1, 77, 2, 64)
    attention(x, x, x)  # self, d=64: flash
    attention(torch.randn(1, 4, 1, 256), torch.randn(1, 4, 1, 256), torch.randn(1, 4, 1, 256))
    attention(torch.randn(1, 4, 1, 512), torch.randn(1, 4, 1, 512),
              torch.randn(1, 4, 1, 512))  # d=512 below FLASH_MIN_WIDE tokens: plain
    attention(x, ctx, ctx)  # cross: plain
    attention(x, x, x, bias=torch.zeros(1, 2, 16, 16))  # bias: plain
    attention(x, x, x, mask=torch.ones(1, 1, 16, 16, dtype=torch.bool))  # mask: plain
    attention(torch.randn(1, 16, 4, 16), torch.randn(1, 16, 4, 16), torch.randn(1, 16, 4, 16))
    attention(x, x, x, impl="plain")
    assert calls == [(1, 16, 2, 64), (1, 4, 1, 256)]
    with pytest.raises(ValueError):
        attention(x, x, x, impl="xla")


@pytest.mark.parametrize("tokens,flash", [(16, False), (FLASH_MIN_WIDE - 1, False),
                                          (FLASH_MIN_WIDE, True), (8191, True), (8192, True),
                                          (8200, True)])
def test_wide_self_attention_goes_to_flash_from_8192_tokens(monkeypatch, tokens, flash):
    """d = 512 (the VAE's mid-block) takes plain math below FLASH_MIN_WIDE
    tokens (4096, the H100's reading) and flash from there, so also from
    the reference's 8192 on; d = 64 takes flash at any length. Both callees
    are counted, not run."""
    assert FLASH_MIN_WIDE == 4096
    from diffbir_tpu_torch.ops import attention as attention_mod

    calls = []
    monkeypatch.setattr(port_flash, "flash_attention",
                        lambda q, k, v: calls.append("flash") or torch.empty_like(q))
    monkeypatch.setattr(attention_mod, "plain_attention",
                        lambda q, k, v, **kw: calls.append("plain") or torch.empty_like(q))
    wide = torch.empty(1, tokens, 1, 512)
    attention(wide, wide, wide)
    narrow = torch.empty(1, tokens, 1, 64)
    attention(narrow, narrow, narrow)
    assert calls == ["flash" if flash else "plain", "flash"]


@pytest.mark.parametrize("prescale_q", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_fwd_entries_state_the_rule(d, dtype, prescale_q):
    """bf16 at d = 64/128 takes the tensor-core K1 (K3 when prescaled), bf16
    at d = 512 the wide tensor-core K1 (K3 stays on the CUDA cores); fp32 at
    any d and bf16 at d = 256 the CUDA-core entries."""
    q = torch.empty(2, 8, 1, d, dtype=dtype, device="meta")
    bf16 = dtype == torch.bfloat16
    if prescale_q:
        expected = (port_flash.KERNEL_PRESCALED_TC if bf16 and d in (64, 128)
                    else port_flash.KERNEL_PRESCALED)
    elif bf16 and d in (64, 128):
        expected = port_flash.KERNEL_TC
    else:
        expected = port_flash.KERNEL_WIDE_TC if bf16 and d == 512 else port_flash.KERNEL
    assert port_flash.fwd_entries(q, prescale_q) is expected
    assert port_flash.TC_HEAD_DIMS == (64, 128) and port_flash.WIDE_TC_HEAD_DIMS == (512,)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.randn(1, 8, 1, 64)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, q[:, :, :, :32], q)
    with pytest.raises(ValueError):
        port_flash.flash_attention(torch.randn(1, 8, 1, 48), torch.randn(1, 8, 1, 48),
                                   torch.randn(1, 8, 1, 48))
    with pytest.raises(RuntimeError):
        port_flash.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# --------------------------------------------------------------------------- #
# image utilities
# --------------------------------------------------------------------------- #
def test_wavelet_reconstruction_matches_jax():
    rng = np.random.default_rng(5)
    content = rng.random((1, 80, 72, 3)).astype(np.float32)
    style = rng.random((1, 80, 72, 3)).astype(np.float32)
    ref = jax_common.wavelet_reconstruction(jnp.asarray(content), jnp.asarray(style))
    out = common.wavelet_reconstruction(torch.from_numpy(content), torch.from_numpy(style))
    assert_close(ref, out.numpy())


@pytest.mark.parametrize("in_hw,out_hw", [((48, 48), (64, 64)), ((80, 80), (64, 64)),
                                          ((80, 48), (64, 96)), ((37, 64), (64, 111))])
def test_bicubic_resize_matches_jax_image_resize(in_hw, out_hw):
    x = np.random.default_rng(6).random((2, *in_hw, 3)).astype(np.float32)
    ref = jax_common.bicubic_resize(jnp.asarray(x), out_hw)
    assert_close(ref, common.bicubic_resize(torch.from_numpy(x), out_hw).numpy())


def test_resize_short_edge_and_pad_match_jax():
    x = np.random.default_rng(7).random((1, 40, 56, 3)).astype(np.float32)
    assert_close(jax_common.resize_short_edge_to(jnp.asarray(x), 64),
                 common.resize_short_edge_to(torch.from_numpy(x), 64).numpy())
    assert_close(jax_common.pad_to_multiples_of(jnp.asarray(x), 64),
                 common.pad_to_multiples_of(torch.from_numpy(x), 64).numpy(), tol=0)


# --------------------------------------------------------------------------- #
# guards
# --------------------------------------------------------------------------- #
def test_port_imports_no_jax():
    """Every module of the port (walked, not listed) and chip_smoke.py import
    nothing of JAX, flax or the JAX package, nor a package the GPU machine
    lacks (PIL, cv2, yaml, orbax, regex, facexlib, gradio, torchvision,
    pandas, tensorboardX; the trainer imports tensorboardX only inside a
    ``try``, where it runs)."""
    code = ("import importlib, pkgutil, sys, diffbir_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(diffbir_tpu_torch.__path__,\n"
            "                                               'diffbir_tpu_torch.')]\n"
            "for name in names + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in (\n"
            "    'jax', 'flax', 'diffbir_tpu', 'PIL', 'cv2', 'yaml', 'orbax', 'regex',\n"
            "    'facexlib', 'gradio', 'torchvision', 'pandas', 'tensorboardX')]\n"
            "print(len(names), bad); sys.exit(1 if bad or len(names) < 20 else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda.os.path, "isfile", lambda p: False)
    assert _cuda.find_nvcc() is None
    kernel = _cuda.CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.load()
    assert kernel.launches == 0
