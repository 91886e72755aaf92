"""The flash-attention kernel (K1) on a CUDA device, against its plain version.

These tests need a card: they skip without one. The GPU machine has no JAX,
and ``tests/conftest.py`` imports it, so run them there without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

from diffbir_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(cuda, b, sq, skv, h, d, dtype, tol):
    """Every head dim, ragged Sq and Skv (cross shapes too), both dtypes;
    one launch counted per call."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, dtype)
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    err = (out.float() - fa.flash_attention_ref(q, k, v).float()).abs().max().item()
    assert err <= tol


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
