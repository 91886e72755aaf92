"""The port's stage-2 training path against the JAX package, on the CPU.

Covers the flash-attention backward (the plain versions of K1's logsumexp and
of K2a/K2b, and the autograd Function around them), the training schedule,
posterior sampling, the ControlNet's initialisation from the UNet, gradient
checkpointing and the tiny ControlLDM train step. Inputs, weights and the
step's random draws come from numpy or are re-derived from the JAX key, and
go to both packages. Each tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diffbir_tpu import schedule as jax_schedule
from diffbir_tpu.models.cldm import ControlLDM as JaxControlLDM
from diffbir_tpu.models.clip import CLIPTextEncoder as JaxCLIP
from diffbir_tpu.models.unet import ControlNet as JaxControlNet
from diffbir_tpu.models.unet import UNetModel as JaxUNet
from diffbir_tpu.models.vae import AutoencoderKL as JaxVAE
from diffbir_tpu.ops.flash_attention import _flash_attention_bwd_impl, _flash_attention_impl
from diffbir_tpu.train import stage2 as jax_stage2
from diffbir_tpu_torch import schedule
from diffbir_tpu_torch.models import cldm as port_cldm
from diffbir_tpu_torch.models.clip import CLIPTextEncoder
from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
from diffbir_tpu_torch.models.vae import AutoencoderKL
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.train import stage2
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from test_torch_models import CLIP_KW, UNET_KW, VAE_KW, assert_close, fill_params, load_port

# the JAX flash tests' own tolerances for fp32 gradients against XLA
FLASH_ATOL, FLASH_RTOL = 5e-4, 1e-3


@pytest.fixture(scope="module")
def jax_tiny():
    """(JAX ControlLDM, filled numpy params) at the test sizes."""
    jc = JaxControlLDM(unet=JaxUNet(**UNET_KW), vae=JaxVAE(**VAE_KW),
                       clip=JaxCLIP(**CLIP_KW), controlnet=JaxControlNet(**UNET_KW))
    return jc, fill_params(jc.eval_shapes((8, 8)), 0)


def port_tiny(params, use_checkpoint=False):
    """The port's ControlLDM at the test sizes, loaded with ``params``."""
    tc = port_cldm.ControlLDM(
        unet=UNetModel(**UNET_KW, use_checkpoint=use_checkpoint), vae=AutoencoderKL(**VAE_KW),
        clip=CLIPTextEncoder(**CLIP_KW),
        controlnet=ControlNet(**UNET_KW, use_checkpoint=use_checkpoint))
    return load_port(tc, params)


# --------------------------------------------------------------------------- #
# (a) flash attention: lse and backward against the Pallas kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sq,skv,h,d", [
    (256, 256, 2, 64),
    (256, 77, 2, 64),    # kv shorter than a block: the masked kv path
    (200, 200, 2, 64),   # ragged q and kv against 128-row blocks
    (256, 256, 1, 512),
    (150, 150, 1, 512),  # ragged at d = 512 against 128-row blocks
])
def test_flash_lse_and_backward_match_pallas_interpret(sq, skv, h, d, monkeypatch):
    if sq == 200:
        for name in ("BQ", "BK", "BWD_BQ", "BWD_BK"):
            monkeypatch.setenv(f"DIFFBIR_TPU_FLASH_{name}", "128")
    rng = np.random.default_rng(sq + skv + d)
    q = rng.standard_normal((1, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((1, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((1, skv, h, d)).astype(np.float32)
    g = rng.standard_normal((1, sq, h, d)).astype(np.float32)
    o_j, lse_j = _flash_attention_impl(q, k, v, interpret=True, return_lse=True)
    dq_j, dk_j, dv_j = _flash_attention_bwd_impl(q, k, v, o_j, lse_j, g, interpret=True)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = port_flash.flash_attention_lse_ref(tq, tk, tv)
    assert lse.shape == (1, h, sq) and lse.dtype == torch.float32
    lse_ref = np.asarray(lse_j)[:, :sq, 0].reshape(1, h, sq)  # lane-replicated (B*H, Sq, 128)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=FLASH_ATOL, rtol=FLASH_RTOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=FLASH_ATOL, rtol=FLASH_RTOL)
    grads = port_flash.flash_attention_bwd_ref(tq, tk, tv, o, lse, tg)
    for out, ref in zip(grads, (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL,
                                   rtol=FLASH_RTOL)

    # the autograd Function's CPU path is the same two plain versions
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (port_flash.KERNEL.launches, port_flash.KERNEL_DQ.launches,
              port_flash.KERNEL_DKV.launches)
    out = port_flash.flash_attention(*leaves)
    assert out.grad_fn is not None
    auto = torch.autograd.grad(out, leaves, tg)
    for a, b in zip(auto, grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (port_flash.KERNEL.launches, port_flash.KERNEL_DQ.launches,
            port_flash.KERNEL_DKV.launches) == before  # no kernel on the CPU


# --------------------------------------------------------------------------- #
# (b) the Function's CPU path, gradient-checked in float64
# --------------------------------------------------------------------------- #
def test_flash_attention_function_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 5, 2, 64, generator=gen, dtype=torch.float64, requires_grad=True)
    k = torch.randn(1, 7, 2, 64, generator=gen, dtype=torch.float64, requires_grad=True)
    v = torch.randn(1, 7, 2, 64, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(port_flash.flash_attention, (q, k, v))
    with torch.no_grad():  # serving: no lse, no autograd node
        assert port_flash.flash_attention(q, k, v).grad_fn is None


def test_flash_backward_wrapper_checks_its_inputs():
    q = torch.randn(1, 8, 1, 64)
    o, lse = port_flash.flash_attention_lse_ref(q, q, q)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(q, q, q, o, lse[:, :, :4], o)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(q, q, q, o[:, :4], lse, o)
    with pytest.raises(RuntimeError):
        m = q.to("meta")
        port_flash.flash_attention_bwd(m, m, m, m, lse.to("meta"), m)


# --------------------------------------------------------------------------- #
# (c) the training schedule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(timesteps=1000, linear_start=0.00085, linear_end=0.012, zero_snr=True,
         parameterization="v"),
    dict(timesteps=50, parameterization="eps", loss_type="l1"),
])
def test_schedule_training_math_matches_jax(kw):
    js = jax_schedule.Schedule.create(beta_schedule="linear", **kw)
    ps = schedule.Schedule.create(**kw)
    np.testing.assert_array_equal(js.betas, ps.betas)
    assert ps.num_timesteps == js.num_timesteps
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    eps = rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    pred = rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    t = np.array([0, kw["timesteps"] // 2, kw["timesteps"] - 1], np.int32)
    tx, te, tt = torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(t)
    assert_close(js.q_sample(x, t, eps), ps.q_sample(tx, tt, te).numpy(), tol=1e-6)
    assert_close(js.get_v(x, eps, t), ps.get_v(tx, te, tt).numpy(), tol=1e-6)
    target = js.target(x, eps, t)
    assert_close(target, ps.target(tx, te, tt).numpy(), tol=1e-6)
    assert_close(js.loss(pred, target),
                 ps.loss(torch.from_numpy(pred), ps.target(tx, te, tt)).numpy(), tol=1e-6)


def test_schedule_v21_is_create():
    ps = schedule.Schedule.v21()
    assert (ps.parameterization, ps.loss_type) == ("v", "l2")
    ref = schedule.Schedule.create(1000, linear_start=0.00085, linear_end=0.012,
                                   zero_snr=True, parameterization="v")
    np.testing.assert_array_equal(ps.betas, ref.betas)


# --------------------------------------------------------------------------- #
# (d) posterior sampling, (e) ControlNet from UNet
# --------------------------------------------------------------------------- #
def test_vae_posterior_sample_matches_jax(jax_tiny):
    """The port with eps passed in equals JAX's vae_encode(sample=True) with
    the eps its key draws."""
    jc, params = jax_tiny
    tc = port_tiny(params)
    img = np.random.default_rng(4).uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, x: jc.vae_encode(p, x, sample=True, rng=key))(params, img)
    eps = np.asarray(jax.random.normal(key, ref.shape, jnp.float32))
    with torch.no_grad():
        out = tc.vae_encode(torch.from_numpy(img), sample=True, eps=torch.tensor(eps))
        mean = tc.vae_encode(torch.from_numpy(img), sample=False)
    assert_close(ref, out.numpy())
    assert not np.allclose(out.numpy(), mean.numpy())
    with pytest.raises(ValueError):
        tc.vae_encode(torch.from_numpy(img))  # sample=True needs a generator or eps


def test_load_controlnet_from_unet_matches_jax(jax_tiny):
    jc, params = jax_tiny
    tc = port_tiny(params)
    ref = flax_to_state_dict(jc.load_controlnet_from_unet(params)["controlnet"])
    zero_conv_before = tc.controlnet.zero_convs[0][0].weight.detach().clone()
    tc.load_controlnet_from_unet()
    got = tc.controlnet.state_dict()
    assert got.keys() == ref.keys()
    for key in ref:
        torch.testing.assert_close(got[key], ref[key], atol=0, rtol=0, msg=key)
    w = tc.controlnet.input_blocks[0][0].weight
    assert w.shape[1] == 8 and float(w.detach()[:, 4:].abs().max()) == 0.0  # zero hint channels
    torch.testing.assert_close(tc.controlnet.zero_convs[0][0].weight, zero_conv_before)


# --------------------------------------------------------------------------- #
# (f) gradient checkpointing
# --------------------------------------------------------------------------- #
def test_use_checkpoint_gives_the_same_gradients(jax_tiny, monkeypatch):
    """Recomputing ResBlocks and transformers in the backward changes no
    gradient (the CPU recompute is deterministic, so they are bit-equal)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    cond = {"c_img": torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32)),
            "c_txt": torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))}
    t = torch.tensor([999.0, 21.0])
    grads = {}
    for ckpt in (False, True):
        tc = port_tiny(jax_tiny[1], use_checkpoint=ckpt)
        stage2.init_train_state(tc)
        calls = []
        real = port_flash.flash_attention_fwd
        monkeypatch.setattr(port_flash, "flash_attention_fwd",
                            lambda *a, **k: calls.append(k) or real(*a, **k))
        (tc(x, t, cond) ** 2).mean().backward()
        monkeypatch.undo()
        grads[ckpt] = [p.grad for p in tc.controlnet.parameters()]
        # the 3 UNet input/middle sites carry no gradient; the 4 UNet output
        # and 3 ControlNet sites run with lse, and again in the recompute
        # under checkpointing
        with_lse = sum(bool(c.get("with_lse")) for c in calls)
        assert (len(calls), with_lse) == ((17, 14) if ckpt else (10, 7))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# --------------------------------------------------------------------------- #
# (g) the tiny ControlLDM train step
# --------------------------------------------------------------------------- #
LR = 1e-4
NOISE_AUG = 200


def jax_draws(batch, key):
    """The step's draws, split from ``key`` as diffbir_tpu/train/stage2.py
    splits it (fp32 model: the posterior eps is fp32 too)."""
    _, k_z, k_aug, k_t, k_noise = jax.random.split(key, 5)
    bs, h, w, _ = batch["gt"].shape
    f = 2 ** (len(VAE_KW["ch_mult"]) - 1)  # the test VAE's downsampling
    shape = (bs, h // f, w // f, 4)
    return {
        "posterior": np.asarray(jax.random.normal(k_z, shape, jnp.float32)),
        "aug": np.asarray(jax.random.normal(k_aug, shape, jnp.float32)),
        "t": np.asarray(jax.random.randint(k_t, (bs,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(k_noise, shape, jnp.float32)),
    }


@pytest.mark.parametrize("accum", [1, 2])
def test_tiny_train_step_matches_jax(jax_tiny, accum):
    """Two steps through both packages, fp32; with accum_steps 2 the second
    step takes the mean of both micro-batches' gradients.

    Tolerances: loss and grad norm 1e-4 relative, and each gradient tensor
    1e-4 of its own largest element: fp32 convolutions and matmuls sum in
    another order in XLA and in torch (about 1e-6 relative per layer,
    compounded through ~40 layers forward and back). Parameters after the
    update: atol lr, the size of one AdamW step. AdamW moves a parameter by
    lr * m / sqrt(v) whatever the gradient's size, so where a gradient
    element is as small as that rounding, its step can differ between the
    packages by up to the step itself; elsewhere they agree far closer."""
    jc, params = jax_tiny
    rng = np.random.default_rng(7)
    batch = {
        "gt": (0.2 * rng.standard_normal((2, 32, 32, 3))).astype(np.float32),
        "lq": rng.random((2, 32, 32, 3)).astype(np.float32),
        "tokens": np.concatenate([np.array([[49406, 49407]] * 2), np.zeros((2, 75), int)],
                                 1).astype(np.int32),
    }
    t_batch = {k: torch.tensor(v, dtype=torch.long if k == "tokens" else torch.float32)
               for k, v in batch.items()}
    js = jax_schedule.Schedule.create(timesteps=1000, linear_start=0.00085,
                                      linear_end=0.012, zero_snr=True, parameterization="v")
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    jopt = jax_stage2.make_optimizer(LR, accum_steps=accum)
    jstate = jax_stage2.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax.jit(jax_stage2.make_train_step(jc, js, jopt, noise_aug_timestep=NOISE_AUG))

    tc = port_tiny(params)
    opt = stage2.init_train_state(tc, LR, accum_steps=accum)
    step = stage2.make_train_step(tc, schedule.Schedule.v21(), opt,
                                  noise_aug_timestep=NOISE_AUG)
    names = [n for n, _ in tc.controlnet.named_parameters()]
    for i, key in enumerate(keys):
        jstate, jm = jstep(jstate, batch, key)
        m = step(t_batch, draws={k: torch.tensor(v) for k, v in jax_draws(batch, key).items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert opt.updates == (i + 1) // accum
        if i == 0:  # the step's gradient: acc_grads (accum 2) or mu / (1 - b1)
            if accum == 2:
                ref = optax.tree_utils.tree_get(jstate.opt_state, "acc_grads")
                got = [mt.grad for mt in opt.masters]
            else:
                ref = jax.tree_util.tree_map(
                    lambda x: x / 0.1, optax.tree_utils.tree_get(jstate.opt_state, "mu"))
                got = [opt.optimizer.state[mt]["exp_avg"] / 0.1 for mt in opt.masters]
            ref = flax_to_state_dict(jax.device_get(ref))
            for name, g in zip(names, got):
                scale = max(float(ref[name].abs().max()), 1e-30)
                assert_close(ref[name].numpy() / scale, g.numpy() / scale)
    new = flax_to_state_dict(jax.device_get(jstate.params["controlnet"]))
    start = flax_to_state_dict(params["controlnet"])
    moved = 0.0
    for name, p in tc.controlnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), atol=LR,
                                   rtol=0, err_msg=name)
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > 0.5 * LR  # the step did move the ControlNet
    for name, p in tc.unet.named_parameters():  # the UNet is frozen
        assert p.grad is None and not p.requires_grad, name
