"""The flash-attention kernels (K1 forward, K2a/K2b backward) on a CUDA
device, against their plain versions and against the CPU.

These tests need a card: they skip without one. The GPU machine has no JAX,
and ``tests/conftest.py`` imports it, so run them there without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

from diffbir_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


# limit = TOL * max|ref|: bf16 two bf16 ulps of the largest reference value
# (kernel and plain version round p, ds and the output at the same points and
# differ by at most one ulp of an element); fp32, and the logsumexp (fp32 on
# both sides), the same math with sums in another order
BF16_TOL, FP32_TOL = 2.0 ** -6, 1e-4


def _limit(ref, tol):
    return tol * ref.float().abs().max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, b, sq, skv, h, d, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, h, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, h, d, generator=g, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 333, 333, 3, 64), (1, 130, 77, 2, 128), (1, 70, 200, 2, 256), (1, 257, 257, 1, 512),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_kernel_matches_plain_version(cuda, b, sq, skv, h, d, dtype, tol):
    """Every head dim, ragged Sq and Skv (cross shapes too), both dtypes;
    one launch counted per call."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, dtype)
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    ref = fa.flash_attention_ref(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, tol)


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 333, 333, 3, 64), (1, 130, 77, 2, 128), (1, 70, 200, 2, 256), (1, 257, 257, 1, 512),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_lse_and_backward_kernels_match_plain_versions(cuda, b, sq, skv, h, d, dtype, tol):
    """K1's lse, K2a's dq and K2b's dk, dv within tol * max|ref| of their
    plain versions (lse within FP32_TOL); one launch of each per call; a second backward is
    bit-identical (no atomics)."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, dtype)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda).to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = (fa.KERNEL_DQ.launches, fa.KERNEL_DKV.launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    assert (fa.KERNEL_DQ.launches, fa.KERNEL_DKV.launches) == (before[0] + 1, before[1] + 1)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v)
    refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, g)
    for out, ref, t in zip((o, lse, *grads), (o_ref, lse_ref, *refs),
                           (tol, FP32_TOL, tol, tol, tol)):
        assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, t)
    again = fa.flash_attention_bwd(q, k, v, o, lse, g)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


def test_gradients_flow_through_flash_attention_on_the_card(cuda):
    """The autograd Function: q, k and v get their gradients from K2 (the
    port's first forward wrote K1's output into a fresh tensor without an
    autograd node, so they got none), equal to the CPU's."""
    q, k, v = _qkv(cuda, 2, 100, 100, 2, 64, torch.float32)
    g = torch.randn(q.shape, device=cuda)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = fa.KERNEL_DQ.launches
        (fa.flash_attention(*leaves) * g.to(dev)).sum().backward()
        res[dev.type] = ([t.grad.cpu() for t in leaves], fa.KERNEL_DQ.launches - before)
    assert res["cuda"][1] == 1 and res["cpu"][1] == 0
    for a, c in zip(res["cuda"][0], res["cpu"][0]):
        assert (a - c).abs().max().item() <= _limit(c, FP32_TOL)


def test_kernel_reads_strided_views(cuda):
    """q, k, v as views of one projection output: no copies, same result."""
    qkv = torch.randn(2, 300, 3 * 128, device=cuda)
    q, k, v = (t.reshape(2, 300, 2, 64) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    assert (out - ref).abs().max().item() <= 1e-4


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 16, 1, 64, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 16, 1, 64, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)


def test_small_fp32_pipeline_matches_cpu(cuda):
    """A small fp32 model (head dim 64, so K1 runs at fp32) through the
    pipeline on the card and on the CPU, same weights and noise."""
    import numpy as np

    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.clip import CLIPTextEncoder
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
    from diffbir_tpu_torch.models.vae import AutoencoderKL
    from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline
    from diffbir_tpu_torch.schedule import Schedule

    kw = dict(model_channels=64, num_head_channels=64, channel_mult=(1, 2),
              attention_resolutions=(2, 1), context_dim=64, num_res_blocks=1)

    def small():
        return ControlLDM(unet=UNetModel(**kw), vae=AutoencoderKL(ch=64, ch_mult=(1, 1, 1, 1),
                          num_res_blocks=1), clip=CLIPTextEncoder(width=64, heads=4, layers=3),
                          controlnet=ControlNet(**kw))

    torch.backends.cudnn.allow_tf32 = False
    cpu = random_init_(small(), torch.Generator().manual_seed(3)).eval()
    gpu = small().to(cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    steps, cfg = 4, 4.0
    x_T = torch.randn(1, 8, 8, 4, generator=gen)
    noise = torch.randn(steps, 1, 8, 8, 4, generator=gen)
    lq = np.random.default_rng(5).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    res = {}
    for dev, model in ((torch.device("cpu"), cpu), (cuda, gpu)):
        pipe = IdentityCleanerPipeline(model, Schedule.v21(), dev, min_cond_size=64)
        cond_img = torch.as_tensor(lq, device=dev).float() / 255
        before = fa.KERNEL.launches
        with torch.no_grad():
            flt = pipe.apply_cldm(cond_img, steps, 1.0, "", "", cfg, x_T=x_T, noise_table=noise)
        out = pipe.run(lq, steps=steps, cfg_scale=cfg, x_T=x_T, noise_table=noise)
        res[dev.type] = (flt.cpu(), out, fa.KERNEL.launches - before)
    assert res["cpu"][2] == 0 and res["cuda"][2] > 0
    assert bool(torch.isfinite(res["cuda"][0]).all())
    assert (res["cpu"][0] - res["cuda"][0]).abs().max().item() <= 1e-3
    assert np.abs(res["cpu"][1].astype(int) - res["cuda"][1].astype(int)).max() <= 1


def test_small_fp32_controlnet_gradients_match_cpu(cuda):
    """One training loss of a small fp32 ControlLDM (head dim 64, so K1 and
    K2 run at fp32) on the card and on the CPU, same weights and draws: the
    ControlNet's gradients agree within 1e-3 of each tensor's largest
    element (fp32 cuDNN and cuBLAS sums in another order than the CPU's)."""
    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.clip import CLIPTextEncoder
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
    from diffbir_tpu_torch.models.vae import AutoencoderKL
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.train import stage2

    kw = dict(model_channels=64, num_head_channels=64, channel_mult=(1, 2),
              attention_resolutions=(2, 1), context_dim=64, num_res_blocks=1,
              use_checkpoint=True)

    def small():
        return ControlLDM(unet=UNetModel(**kw), vae=AutoencoderKL(ch=64, ch_mult=(1, 1, 1, 1),
                          num_res_blocks=1), clip=CLIPTextEncoder(width=64, heads=4, layers=3),
                          controlnet=ControlNet(**kw))

    torch.backends.cudnn.allow_tf32 = False
    cpu = random_init_(small(), torch.Generator().manual_seed(3))
    gpu = small().to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    batch = {"gt": torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1,
             "lq": torch.rand(2, 64, 64, 3, generator=gen),
             "tokens": torch.zeros(2, 77, dtype=torch.long)}
    draws = {"posterior": torch.randn(2, 8, 8, 4, generator=gen),
             "aug": torch.randn(2, 8, 8, 4, generator=gen),
             "t": torch.tensor([999, 300]), "noise": torch.randn(2, 8, 8, 4, generator=gen)}
    res = {}
    for dev, model in ((torch.device("cpu"), cpu), (cuda, gpu)):
        stage2.init_train_state(model)
        loss_fn = stage2.make_loss_fn(model, Schedule.v21(), noise_aug_timestep=200)
        before = (fa.KERNEL.launches, fa.KERNEL_DQ.launches, fa.KERNEL_DKV.launches)
        loss = loss_fn({k: v.to(dev) for k, v in batch.items()},
                       draws={k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        after = (fa.KERNEL.launches, fa.KERNEL_DQ.launches, fa.KERNEL_DKV.launches)
        res[dev.type] = (loss.item(), [p.grad.cpu() for p in model.controlnet.parameters()],
                         tuple(a - b for a, b in zip(after, before)))
    assert res["cpu"][2] == (0, 0, 0)
    # 3 ControlNet + 4 UNet output sites carry gradients: K2 at each, K1 at
    # the 10 sites, the 2 VAE encodes and the 7 recomputed ones
    assert res["cuda"][2] == (19, 7, 7)
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * max(1.0, abs(res["cpu"][0]))
    for a, c in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - c).abs().max().item() <= 1e-3 * max(c.abs().max().item(), 1e-12)
