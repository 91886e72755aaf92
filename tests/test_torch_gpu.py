"""The kernels on a CUDA device, against their plain versions and against
the CPU: flash attention (K1 forward, K2a/K2b backward, K3 the prescaled-q
forward), the int8 matmul (K4), the packed-int4 matmul (K5: its tile and
GEMV forms), the fused ResBlock (K6: the tensor-core entry for bf16, the
CUDA-core one for fp32) and the fused GEGLU FFN (K7); the build key; the serving modes'
autograd and a small model; a small model's pipeline, untiled and tiled,
and RGB-guided; the wide backward (bf16, d = 512: the delta pre-pass,
K2a_wide, K2b_wide) and the d = 512 attention under a gradient (from 4096
tokens on K1_wide and the wide backward, against plain math); turbo at
interval 1 bit-equal to the plain model; the small BSRNet and SCUNet
cleaners against the CPU; a small LLaVA captioner.

These tests need a card: they skip without one. The GPU machine has no JAX,
and ``tests/conftest.py`` imports it, so run them there without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import shutil

import pytest
import torch

from diffbir_tpu_torch.ops import _cuda
from diffbir_tpu_torch.ops import flash_attention as fa
from diffbir_tpu_torch.ops import fused_ffn as ffn
from diffbir_tpu_torch.ops import fused_resblock as fr
from diffbir_tpu_torch.ops import quant_matmul as qm

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
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, b, sq, skv, h, d, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, h, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, h, d, generator=g, device=cuda).to(dtype)
    return q, k, v


FWD_ENTRIES = (fa.KERNEL_TC, fa.KERNEL_PRESCALED_TC, fa.KERNEL, fa.KERNEL_PRESCALED,
               fa.KERNEL_WIDE_TC)


def _fwd_launches():
    """Launch counts of the five forward entries: tensor-core K1, K3, then
    the CUDA-core K1, K3, then the wide tensor-core K1."""
    return [e.launches for e in FWD_ENTRIES]


def _one_launch_of(entry):
    return [int(e is entry) for e in FWD_ENTRIES]


def _moved(before, after):
    return [a - b for a, b in zip(after, before)]


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 333, 333, 3, 64), (1, 130, 77, 2, 128), (1, 70, 200, 2, 256), (1, 257, 257, 1, 512),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_kernel_matches_plain_version(cuda, b, sq, skv, h, d, dtype, tol):
    """Every head dim, ragged Sq and Skv (cross shapes too), both dtypes;
    one launch counted per call, on the entry that ``fwd_entries`` names
    (the tensor-core K1 for bf16 at d = 64/128, the wide one at d = 512)."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, dtype)
    before = _fwd_launches()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    entry = (fa.KERNEL_TC if bf16 and d in fa.TC_HEAD_DIMS
             else fa.KERNEL_WIDE_TC if bf16 and d in fa.WIDE_TC_HEAD_DIMS else fa.KERNEL)
    assert fa.fwd_entries(q) is entry
    assert _moved(before, _fwd_launches()) == _one_launch_of(entry)
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    ref = fa.flash_attention_ref(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, tol)


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 4096, 4096, 2, 64), (2, 333, 333, 3, 64), (1, 130, 77, 2, 64), (1, 70, 200, 2, 64),
    (1, 40, 40, 2, 64), (1, 300, 45, 2, 128), (2, 200, 260, 2, 128), (1, 577, 577, 4, 64),
])
@pytest.mark.parametrize("with_lse", [False, True])
def test_tensor_core_forward_matches_plain_version(cuda, b, sq, skv, h, d, with_lse):
    """The tensor-core K1 (bf16, d = 64/128) with and without lse: ragged Sq
    and Skv (multiples of neither tile), Sq != Skv, less than one tile; one
    launch on its own count; o within 2^-6 x max|ref|, lse within 1e-4."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, torch.bfloat16)
    before = _fwd_launches()
    res = fa.flash_attention_fwd(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    assert _moved(before, _fwd_launches()) == _one_launch_of(fa.KERNEL_TC)
    outs = res if with_lse else (res,)
    refs = fa.flash_attention_lse_ref(q, k, v) if with_lse else (fa.flash_attention_ref(q, k, v),)
    for out, ref, tol in zip(outs, refs, (BF16_TOL, FP32_TOL)):
        assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, tol)


@pytest.mark.parametrize("offset", [0, 4])
def test_tensor_core_forward_reads_strided_views(cuda, offset):
    """bf16 q, k, v as views of one projection output, read in place (offset
    0) or copied first because their rows are not 16-byte aligned (offset 4
    elements): the same bits as on contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 300, 3 * 128 + 8, generator=gen, device=cuda).bfloat16()
    q, k, v = (t.reshape(2, 300, 2, 64) for t in qkv[..., offset:offset + 384].chunk(3, dim=-1))
    assert not q.is_contiguous() and (q.data_ptr() % 16 == 0) == (offset == 0)
    before = _fwd_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    assert _moved(before, _fwd_launches()) == _one_launch_of(fa.KERNEL_TC)
    o_d, lse_d = fa.flash_attention_fwd(*(t.contiguous() for t in (q, k, v)), with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o_d) and torch.equal(lse, lse_d)
    ref = fa.flash_attention_ref(q, k, v)
    assert (o.float() - ref.float()).abs().max().item() <= _limit(ref, BF16_TOL)


def test_tensor_core_forward_entries_refuse_what_they_do_not_take(cuda):
    """The tensor-core K1 and K3 take bf16 at d = 64/128 only: launched on
    fp32, or on bf16 at d = 256, they raise and count nothing."""
    before = _fwd_launches()
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k, v = _qkv(cuda, 1, 64, 64, 1, d, dtype)
        for entry in (fa.KERNEL_TC, fa.KERNEL_PRESCALED_TC):
            with pytest.raises(RuntimeError):
                fa.launch_fwd(entry, q, k, v)
    assert _fwd_launches() == before


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 4096, 4096, 1, 512), (2, 257, 257, 1, 512), (1, 1000, 1000, 1, 512),
    (1, 130, 77, 1, 512), (1, 40, 40, 1, 512), (1, 70, 200, 2, 512),
])
@pytest.mark.parametrize("with_lse", [False, True])
def test_wide_tensor_core_forward_matches_plain_version(cuda, b, sq, skv, h, d, with_lse):
    """The wide tensor-core K1 (bf16, d = 512) with and without lse: ragged
    Sq and Skv (multiples of neither 64-row tile), Sq != Skv, less than one
    tile, two heads; one launch on its own count; o within 2^-6 x
    max|ref|, lse within 1e-4."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, torch.bfloat16)
    before = _fwd_launches()
    res = fa.flash_attention_fwd(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    assert _moved(before, _fwd_launches()) == _one_launch_of(fa.KERNEL_WIDE_TC)
    outs = res if with_lse else (res,)
    refs = fa.flash_attention_lse_ref(q, k, v) if with_lse else (fa.flash_attention_ref(q, k, v),)
    for out, ref, tol in zip(outs, refs, (BF16_TOL, FP32_TOL)):
        assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, tol)


@pytest.mark.parametrize("offset", [0, 4])
def test_wide_tensor_core_forward_reads_strided_views(cuda, offset):
    """bf16 d = 512 q, k, v as views of one projection output, read in place
    (offset 0) or copied first because their rows are not 16-byte aligned
    (offset 4 elements): the same bits as on contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn(1, 300, 3 * 512 + 8, generator=gen, device=cuda).bfloat16()
    q, k, v = (t.reshape(1, 300, 1, 512)
               for t in qkv[..., offset:offset + 1536].chunk(3, dim=-1))
    assert not q.is_contiguous() and (q.data_ptr() % 16 == 0) == (offset == 0)
    before = _fwd_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    assert _moved(before, _fwd_launches()) == _one_launch_of(fa.KERNEL_WIDE_TC)
    o_d, lse_d = fa.flash_attention_fwd(*(t.contiguous() for t in (q, k, v)), with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o_d) and torch.equal(lse, lse_d)
    ref = fa.flash_attention_ref(q, k, v)
    assert (o.float() - ref.float()).abs().max().item() <= _limit(ref, BF16_TOL)


def test_wide_tensor_core_entry_refuses_what_it_does_not_take(cuda):
    """The wide tensor-core K1 takes bf16 at d = 512 with 16-byte aligned
    rows only: launched on fp32, on bf16 at d = 64 or 256, or on rows that
    start 8 bytes off, it raises and counts nothing."""
    before = _fwd_launches()
    for dtype, d in ((torch.float32, 512), (torch.bfloat16, 64), (torch.bfloat16, 256)):
        q, k, v = _qkv(cuda, 1, 64, 64, 1, d, dtype)
        with pytest.raises(RuntimeError):
            fa.launch_fwd(fa.KERNEL_WIDE_TC, q, k, v)
    flat = torch.zeros(64 * 512 + 4, device=cuda, dtype=torch.bfloat16)
    q = flat[4:].reshape(1, 64, 1, 512)
    with pytest.raises(RuntimeError):
        fa.launch_fwd(fa.KERNEL_WIDE_TC, q, q, q)
    assert _fwd_launches() == before


def test_gradients_flow_through_tensor_core_flash_attention(cuda):
    """bf16 at d = 64 under autograd: the tensor-core K1 with lse forward and
    the tensor-core K2a/K2b backward, each once; q, k and v get gradients
    within 2^-6 x max|ref| of the plain backward on the same o and lse."""
    q, k, v = _qkv(cuda, 2, 300, 300, 2, 64, torch.bfloat16)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda).bfloat16()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = _fwd_launches() + _bwd_launches()
    out = fa.flash_attention(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    assert _moved(before, _fwd_launches() + _bwd_launches()) == (
        _one_launch_of(fa.KERNEL_TC) + [1, 1, 0, 0, 0, 0, 0])
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    assert torch.equal(out.detach(), o)
    for leaf, ref in zip(leaves, fa.flash_attention_bwd_ref(q, k, v, o, lse, g)):
        assert leaf.grad is not None
        assert (leaf.grad.float() - ref.float()).abs().max().item() <= _limit(ref, BF16_TOL)


BWD_ENTRIES = (fa.KERNEL_DQ_TC, fa.KERNEL_DKV_TC, fa.KERNEL_DQ, fa.KERNEL_DKV, fa.KERNEL_DELTA,
               fa.KERNEL_DQ_WIDE_TC, fa.KERNEL_DKV_WIDE_TC)
WIDE_BWD_LAUNCH = [0, 0, 0, 0, 1, 1, 1]  # the delta pre-pass, K2a_wide, K2b_wide


def _bwd_launches():
    """Launch counts of the seven backward entries: tensor-core K2a, K2b,
    the CUDA-core K2a, K2b, then the wide backward's delta pre-pass, K2a,
    K2b."""
    return [e.launches for e in BWD_ENTRIES]


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 333, 333, 3, 64), (1, 130, 77, 2, 128), (1, 70, 200, 2, 256), (1, 257, 257, 1, 512),
    (1, 40, 40, 2, 64), (1, 300, 45, 2, 64), (2, 200, 260, 2, 128),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_lse_and_backward_kernels_match_plain_versions(cuda, b, sq, skv, h, d, dtype, tol):
    """K1's lse, K2a's dq and K2b's dk, dv within tol * max|ref| of their
    plain versions (lse within FP32_TOL), ragged Sq and Skv, Sq != Skv, Sq or
    Skv below one tile; one launch of each per call, on the tensor-core
    entries for bf16 at d = 64/128, on the wide ones (after one delta
    pre-pass) for bf16 at d = 512 and on the CUDA-core entries otherwise; a
    second backward is bit-identical (no atomics)."""
    q, k, v = _qkv(cuda, b, sq, skv, h, d, dtype)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda).to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = _bwd_launches()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    moved = [a - c for a, c in zip(_bwd_launches(), before)]
    assert moved == ([1, 1, 0, 0, 0, 0, 0] if bf16 and d in fa.TC_HEAD_DIMS else
                     WIDE_BWD_LAUNCH if bf16 and d in fa.WIDE_TC_HEAD_DIMS else
                     [0, 0, 1, 1, 0, 0, 0])
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v)
    refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, g)
    for out, ref, t in zip((o, lse, *grads), (o_ref, lse_ref, *refs),
                           (tol, FP32_TOL, tol, tol, tol)):
        assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, t)
    again = fa.flash_attention_bwd(q, k, v, o, lse, g)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("offset", [0, 4])
def test_tensor_core_backward_reads_strided_views(cuda, offset):
    """bf16 q, k, v as views of one projection output and dO as a strided
    view, read in place (offset 0) or copied first because their rows are
    not 16-byte aligned (offset 4 elements): the tensor-core entries give
    the same bits as on contiguous copies, within the limit of the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 300, 3 * 128 + 8, generator=gen, device=cuda).bfloat16()
    q, k, v = (t.reshape(2, 300, 2, 64) for t in qkv[..., offset:offset + 384].chunk(3, dim=-1))
    g = torch.randn(2, 300, 2, 128, generator=gen, device=cuda).bfloat16()[..., :64]
    assert not (q.is_contiguous() or g.is_contiguous())
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = _bwd_launches()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
    assert [a - c for a, c in zip(_bwd_launches(), before)] == [1, 1, 0, 0, 0, 0, 0]
    dense = fa.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, o)), lse, g.contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(grads, dense))
    for out, ref in zip(grads, fa.flash_attention_bwd_ref(q, k, v, o, lse, g)):
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, BF16_TOL)


def test_tensor_core_entries_refuse_fp32(cuda):
    """The tensor-core entries take bf16 only: launched on fp32 they raise,
    and count nothing."""
    q, k, v = _qkv(cuda, 1, 64, 64, 1, 64, torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = _bwd_launches()
    with pytest.raises(RuntimeError):
        fa.launch_dq(fa.KERNEL_DQ_TC, q, k, v, o, lse, q)
    with pytest.raises(RuntimeError):
        fa.launch_dkv(fa.KERNEL_DKV_TC, q, k, v, o, lse, q)
    assert _bwd_launches() == before


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


def _small_fp32_pair(cuda):
    """A small fp32 ControlLDM (head dim 64, so K1 runs at fp32; a true f8
    VAE) on the CPU and the same weights on the card."""
    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.clip import CLIPTextEncoder
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
    from diffbir_tpu_torch.models.vae import AutoencoderKL

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
    return cpu, gpu


def _pipelines_on_both(cuda, lq, latent, steps=4, cfg=4.0, cond_fn=None, **tiles):
    """apply_cldm's float output and run's uint8 output of the small pair's
    IdentityCleanerPipeline (guided by ``cond_fn``) on the CPU and on the
    card (same weights, x_T, step noise and stand-in prompt ids: the default
    negative prompt), with the K1 launches of each."""
    from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline
    from diffbir_tpu_torch.profile_step import stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    gen = torch.Generator().manual_seed(4)
    x_T = torch.randn(1, latent, latent, 4, generator=gen)
    noise = torch.randn(steps, 1, latent, latent, 4, generator=gen)
    res = {}
    for dev, model in zip((torch.device("cpu"), cuda), _small_fp32_pair(cuda)):
        pipe = IdentityCleanerPipeline(model, Schedule.v21(), dev, min_cond_size=64,
                                       tokenizer=stand_in_tokenizer(), cond_fn=cond_fn)
        cond_img = torch.as_tensor(lq, device=dev).float() / 255
        before = fa.KERNEL.launches
        with torch.no_grad():
            flt = pipe.apply_cldm(cond_img, steps, 1.0, "", "", cfg, x_T=x_T, noise_table=noise,
                                  **tiles)
        out = pipe.run(lq, steps=steps, cfg_scale=cfg, x_T=x_T, noise_table=noise, **tiles)
        res[dev.type] = (flt.cpu(), out, fa.KERNEL.launches - before)
    return res


def test_small_fp32_pipeline_matches_cpu(cuda):
    """A small fp32 model (head dim 64, so K1 runs at fp32) through the
    pipeline on the card and on the CPU, same weights, noise and stand-in
    prompt ids (the default negative prompt)."""
    import numpy as np

    lq = np.random.default_rng(5).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    res = _pipelines_on_both(cuda, lq, 8)
    assert res["cpu"][2] == 0 and res["cuda"][2] > 0
    assert bool(torch.isfinite(res["cuda"][0]).all())
    assert (res["cpu"][0] - res["cuda"][0]).abs().max().item() <= 1e-3
    assert np.abs(res["cpu"][1].astype(int) - res["cuda"][1].astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["blend", "sync_gn"])
def test_small_fp32_tiled_pipeline_matches_cpu(cuda, mode):
    """The tiled path on the card against the CPU: a 128x128 condition, the
    VAE encoder and decoder tiled at 64 pixels in ``mode``, 9 latent tiles
    of 8x8 per step in groups of 4 (the last one short)."""
    import numpy as np

    lq = np.random.default_rng(6).integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    res = _pipelines_on_both(cuda, lq, 16, vae_encoder_tiled=True, vae_encoder_tile_size=64,
                             vae_decoder_tiled=True, vae_decoder_tile_size=64,
                             vae_tile_mode=mode, cldm_tiled=True, cldm_tile_size=64,
                             cldm_tile_stride=32, cldm_tiles_per_batch=4)
    assert res["cpu"][2] == 0 and res["cuda"][2] > 0
    assert bool(torch.isfinite(res["cuda"][0]).all())
    assert (res["cpu"][0] - res["cuda"][0]).abs().max().item() <= 1e-3
    assert np.abs(res["cpu"][1].astype(int) - res["cuda"][1].astype(int)).max() <= 1


@pytest.mark.parametrize("name", ["bsrnet", "scunet"])
def test_small_cleaners_on_the_card_match_the_cpu(cuda, name):
    """A small BSRNet (x4) and SCUNet (plain and shifted windows, edge pad)
    in fp32 on the card against the CPU on the same weights and input
    (1e-4 x max|ref|); no kernel of the port runs."""
    from diffbir_tpu_torch.models.bsrnet import RRDBNet
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.scunet import SCUNet

    def build(device):
        model = (RRDBNet(nf=16, nb=2, gc=8, device=device) if name == "bsrnet" else
                 SCUNet(config=(2, 1, 1, 2, 1, 1, 2), dim=16, head_dim=8, device=device))
        return random_init_(model, torch.Generator(device=device).manual_seed(3)).eval()

    cpu, gpu = build("cpu"), build(cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 40, 52, 3, generator=torch.Generator().manual_seed(4))
    kernels = [k for m in (fa, qm, fr, ffn) for k in vars(m).values()
               if isinstance(k, _cuda.CudaKernel)]
    before = [k.launches for k in kernels]
    with torch.no_grad():
        ref, out = cpu(x), gpu(x.to(cuda)).cpu()
    assert [k.launches for k in kernels] == before
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= FP32_TOL * ref.abs().max().item()


def _wide_grad_case(cuda, b, sq, skv, h, seed=0):
    q, k, v = _qkv(cuda, b, sq, skv, h, 512, torch.bfloat16, seed)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(seed + 9),
                    device=cuda).bfloat16()
    return q, k, v, g


@pytest.mark.parametrize("b,sq,skv,h", [
    (1, 257, 257, 1), (1, 130, 77, 1), (2, 200, 260, 2), (1, 40, 300, 1), (1, 1000, 1000, 1),
    (1, 64, 64, 1), (1, 8, 2100, 1),
])
def test_wide_backward_matches_plain_versions(cuda, b, sq, skv, h):
    """The wide tensor-core K2a and K2b (bf16, d = 512) after the delta
    pre-pass: ragged Sq and Skv (multiples of neither the 64-row q nor the
    32-row kv tile), Sq != Skv either way, two heads, less than one tile;
    one launch of each; dq, dk, dv within 2^-6 x max|ref| of the plain
    versions, delta within 1e-4; a second backward bit-identical; each
    entry alone (with delta given) gives the same bits."""
    q, k, v, g = _wide_grad_case(cuda, b, sq, skv, h)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = _bwd_launches()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    assert _moved(before, _bwd_launches()) == WIDE_BWD_LAUNCH
    for out, ref in zip(grads, fa.flash_attention_bwd_ref(q, k, v, o, lse, g)):
        assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, BF16_TOL)
    delta = fa.launch_delta(o, g)
    delta_ref = fa.flash_attention_bwd_delta_ref(o, g)
    assert delta.shape == (b, h, sq) and delta.dtype == torch.float32
    assert (delta - delta_ref).abs().max().item() <= _limit(delta_ref, FP32_TOL)
    again = fa.flash_attention_bwd(q, k, v, o, lse, g)
    alone = (fa.launch_dq(fa.KERNEL_DQ_WIDE_TC, q, k, v, o, lse, g, delta),
             *fa.launch_dkv(fa.KERNEL_DKV_WIDE_TC, q, k, v, o, lse, g, delta))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(grads, again, alone))


@pytest.mark.parametrize("offset", [0, 4])
def test_wide_backward_reads_strided_views(cuda, offset):
    """bf16 d = 512 q, k, v as views of one projection output and dO as a
    strided view, read in place (offset 0) or copied first because their
    rows are not 16-byte aligned (offset 4 elements): the wide entries give
    the same bits as on contiguous copies, within the limit of the plain
    versions."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(1, 300, 3 * 512 + 8, generator=gen, device=cuda).bfloat16()
    q, k, v = (t.reshape(1, 300, 1, 512)
               for t in qkv[..., offset:offset + 1536].chunk(3, dim=-1))
    g = torch.randn(1, 300, 1, 1024, generator=gen, device=cuda).bfloat16()[..., :512]
    assert not (q.is_contiguous() or g.is_contiguous())
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = _bwd_launches()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
    assert _moved(before, _bwd_launches()) == WIDE_BWD_LAUNCH
    dense = fa.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, o)), lse, g.contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(grads, dense))
    for out, ref in zip(grads, fa.flash_attention_bwd_ref(q, k, v, o, lse, g)):
        assert (out.float() - ref.float()).abs().max().item() <= _limit(ref, BF16_TOL)


def test_wide_backward_entries_refuse_what_they_do_not_take(cuda):
    """The wide K2a and K2b take bf16 at d = 512 with 16-byte aligned rows
    of q, k, v and dO: launched on fp32, on bf16 at d = 256 or on rows that
    start 8 bytes off they raise; the delta pre-pass refuses fp32 and
    misaligned rows; none counts a launch."""
    before = _bwd_launches()
    for dtype, d in ((torch.float32, 512), (torch.bfloat16, 256)):
        q, k, v = _qkv(cuda, 1, 64, 64, 1, d, dtype)
        delta = torch.zeros(1, 1, 64, device=cuda)
        lse = torch.zeros(1, 1, 64, device=cuda)
        with pytest.raises(RuntimeError):
            fa.launch_dq(fa.KERNEL_DQ_WIDE_TC, q, k, v, q, lse, q, delta)
        with pytest.raises(RuntimeError):
            fa.launch_dkv(fa.KERNEL_DKV_WIDE_TC, q, k, v, q, lse, q, delta)
    with pytest.raises(RuntimeError):
        fa.launch_delta(*_qkv(cuda, 1, 64, 64, 1, 512, torch.float32)[:2])
    flat = torch.zeros(64 * 512 + 4, device=cuda, dtype=torch.bfloat16)
    q = flat[4:].reshape(1, 64, 1, 512)
    delta = torch.zeros(1, 1, 64, device=cuda)
    with pytest.raises(RuntimeError):
        fa.launch_dq(fa.KERNEL_DQ_WIDE_TC, q, q, q, q, delta, q, delta)
    with pytest.raises(RuntimeError):
        fa.launch_dkv(fa.KERNEL_DKV_WIDE_TC, q, q, q, q, delta, q, delta)
    with pytest.raises(RuntimeError):
        fa.launch_delta(q, q)
    assert _bwd_launches() == before


def test_wide_attention_under_a_gradient_takes_the_wide_backward_on_the_card(cuda):
    """The VAE's d = 512 attention under a gradient, as RGB guidance takes
    it: from FLASH_MIN_WIDE_GRAD tokens (4096, a 512x512 decode) ``attention``
    launches K1_wide with lse, then the delta pre-pass, K2a_wide and K2b_wide
    once each, and its gradients agree with plain math's (``impl="plain"``,
    no launch) within two bf16 ulps of each one's largest element; one
    token below, it takes plain math (no launch)."""
    from diffbir_tpu_torch.ops.attention import FLASH_MIN_WIDE_GRAD, attention

    assert FLASH_MIN_WIDE_GRAD == 4096
    q, k, v, g = _wide_grad_case(cuda, 1, 4096, 4096, 1, seed=12)
    grads = {}
    for route, kw in (("flash", {}), ("plain", {"impl": "plain"})):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = _fwd_launches() + _bwd_launches()
        grads[route] = torch.autograd.grad(attention(*leaves, **kw), leaves, g)
        torch.cuda.synchronize()
        moved = _moved(before, _fwd_launches() + _bwd_launches())
        assert moved == ([0] * 12 if route == "plain"
                         else _one_launch_of(fa.KERNEL_WIDE_TC) + WIDE_BWD_LAUNCH)
    for a, c in zip(grads["plain"], grads["flash"]):
        assert (a.float() - c.float()).abs().max().item() <= 2 * _limit(a, BF16_TOL)
    below = [t[:, :4095].detach().clone().requires_grad_() for t in (q, k, v)]
    before = _fwd_launches() + _bwd_launches()
    torch.autograd.grad(attention(*below), below, g[:, :4095])
    torch.cuda.synchronize()
    assert _moved(before, _fwd_launches() + _bwd_launches()) == [0] * 12


def test_turbo_at_interval_1_is_the_plain_model_on_the_card(cuda):
    """The cached (turbo) model at interval 1 through the CLI's sampler is
    the plain model function bit for bit on the card, with and without the
    UNet encoder cache, on the request's hoisted tables."""
    from diffbir_tpu_torch.pipeline import build_sampler, model_function
    from diffbir_tpu_torch.schedule import Schedule

    _, model = _small_fp32_pair(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x_T = torch.randn(1, 8, 8, 4, generator=gen, device=cuda)
    c_img = torch.randn(1, 8, 8, 4, generator=gen, device=cuda)
    cond, uncond = ({"c_txt": torch.randn(1, 77, 64, generator=gen, device=cuda),
                     "c_img": c_img} for _ in range(2))
    noise = torch.randn(4, 1, 8, 8, 4, generator=gen, device=cuda)
    sampler = build_sampler("edm_dpm++_3m_sde", Schedule.v21(), False, eta=1.0)
    tables = model.make_hoist_tables(torch.cat([cond["c_txt"], uncond["c_txt"]]),
                                     sampler.model_ts(4))

    def sample(model_fn):
        with torch.no_grad():
            return sampler.sample(model_fn, x_T, cond, uncond, 4.0, 4, noise_table=noise)

    plain = sample(model_function(model, 1.0, tables))
    for encoder in (False, True):
        out = sample(model.make_cached_control_model(1.0, 1, encoder, tables))
        assert torch.equal(out, plain)
    assert not torch.equal(sample(model.make_cached_control_model(1.0, 2, True, tables)), plain)


def test_small_fp32_rgb_guided_pipeline_matches_cpu(cuda):
    """RGB guidance (w_mse, the gradient through the VAE decoder) in the
    small fp32 pipeline on the card and on the CPU, same weights and
    noise: within 1e-3 (float) and 1 uint8 level."""
    import numpy as np

    from diffbir_tpu_torch.utils.cond_fn import WeightedMSEGuidance

    lq = np.random.default_rng(7).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    res = _pipelines_on_both(cuda, lq, 8, cond_fn=WeightedMSEGuidance(0.05, 1001, -1, "rgb", 2))
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


# --------------------------------------------------------------------------- #
# the serving modes' kernels: K3, K4, K6, K7
# --------------------------------------------------------------------------- #
def _close(out, ref, tol):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err, limit = (out.float() - ref.float()).abs().max().item(), _limit(ref, tol)
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("shape", [(2, 256, 256, 3, 64), (1, 130, 130, 2, 128),
                                   (2, 64, 64, 20, 64), (1, 192, 384, 5, 64),
                                   (2, 100, 300, 2, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_prescaled_flash_matches_plain_version(cuda, shape, dtype, tol):
    """K3 (one launch on its own count: the tensor-core entry in bf16, the
    CUDA-core one in fp32; none on K1's) against the prescaled plain
    version, also at Sq != Skv (a band's queries against every band's k
    and v, as spatial parallelism calls it); in fp32 it is K1, bit for
    bit."""
    q, k, v = _qkv(cuda, *shape[:3], *shape[3:], dtype)
    before = _fwd_launches()
    out = fa.flash_attention(q, k, v, prescale_q=True)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert _moved(before, _fwd_launches()) == _one_launch_of(
        fa.KERNEL_PRESCALED_TC if bf16 else fa.KERNEL_PRESCALED)
    _close(out, fa.flash_attention_ref(q, k, v, prescale_q=True), tol)
    if dtype == torch.float32:
        assert torch.equal(out, fa.flash_attention(q, k, v))


def _k4_launches():
    """Launch counts of K4's entries: the tile form, the GEMV form, the
    CUDA-core one."""
    return [e.launches for e in (qm.KERNEL_TC, qm.KERNEL_GEMV, qm.KERNEL)]


def _k4_case(cuda, m, k, n, dtype, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w_q, scale = qm.quantize_weight(torch.randn(k, n, generator=g, device=cuda))
    return x, w_q, scale


@pytest.mark.parametrize("m,k,n", [(154, 320, 640), (2, 1280, 320), (130, 100, 70)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_TOL)])
def test_quant_matmul_matches_plain_version(cuda, m, k, n, dtype, tol):
    """K4 at ragged and 320-wide shapes, one launch of the entry that
    quant_entries names; x rounded to bf16 on both sides, so fp32 agrees to
    the sum order."""
    x, w_q, scale = _k4_case(cuda, m, k, n, dtype)
    entry = qm.quant_entries(x)
    before = _k4_launches()
    out = qm.quant_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert _moved(before, _k4_launches()) == [entry is qm.KERNEL_TC, entry is qm.KERNEL_GEMV, 0]
    _close(out, qm.quant_matmul_ref(x, w_q, scale), tol)


@pytest.mark.parametrize("entry,m,k,n", [
    ("TC", 300, 320, 320), ("TC", 154, 1024, 320), ("TC", 130, 200, 336),
    ("TC", 129, 1000, 640), ("TC", 9, 4096, 256), ("TC", 257, 100, 70),
    ("GEMV", 1, 4096, 1024), ("GEMV", 2, 1280, 320), ("GEMV", 3, 200, 336),
    ("GEMV", 8, 1000, 320), ("GEMV", 5, 100, 70)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_TOL)])
def test_quant_matmul_entries_match_plain_version(cuda, entry, m, k, n, dtype, tol):
    """Each new K4 entry on its own count: ragged M, N and K (K no multiple
    of the 64-deep stage, N = 320 on a masked 128-wide tile, K and N padded
    to whole 16-byte chunks where they are not), fp32 x on the tensor
    cores."""
    x, w_q, scale = _k4_case(cuda, m, k, n, dtype)
    kernel = getattr(qm, f"KERNEL_{entry}")
    before = _k4_launches()
    out = qm.launch_quant(kernel, x, w_q, scale)
    torch.cuda.synchronize()
    assert _moved(before, _k4_launches()) == [entry == "TC", entry == "GEMV", 0]
    assert out.shape == (m, n) and out.dtype == dtype
    _close(out, qm.quant_matmul_ref(x, w_q, scale), tol)


@pytest.mark.parametrize("m", [1, 200])
def test_quant_matmul_reads_strided_and_misaligned_views(cuda, m):
    """A strided x (every other column of a wider tensor), an x that starts
    2 bytes past a 16-byte boundary, and a misaligned int8 weight: each is
    copied for the tensor-core entries and gives the plain version's result."""
    k, n = 320, 640
    g = torch.Generator(device=cuda).manual_seed(8)
    wide = torch.randn(m, 2 * k, generator=g, device=cuda).to(torch.bfloat16)
    flat = torch.randn(m * k + 1, generator=g, device=cuda).to(torch.bfloat16)
    w_flat = torch.randint(-127, 128, (k * n + 3,), generator=g, device=cuda,
                           dtype=torch.int8)
    scale = torch.rand(n, generator=g, device=cuda) * 0.01
    w_q = w_flat[3:].view(k, n)
    assert w_q.data_ptr() % 16 and flat[1:].data_ptr() % 16
    for x in (wide[:, ::2], flat[1:].view(m, k)):
        _close(qm.quant_matmul(x, w_q, scale), qm.quant_matmul_ref(x, w_q, scale), BF16_TOL)


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (2, 11008, 640)])
def test_gemv_reruns_are_bit_identical(cuda, m, k, n):
    """The GEMV form sums its K splits in a fixed order, with no atomics."""
    x, w_q, scale = _k4_case(cuda, m, k, n, torch.bfloat16)
    first = qm.quant_matmul(x, w_q, scale)
    for _ in range(3):
        assert torch.equal(qm.quant_matmul(x, w_q, scale), first)


def _resblock_case(cuda, cin, cout, h, w, dtype, quant, seed=4, batch=2):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s)

    p = dict(gn1_scale=1 + rnd(cin, s=0.1), gn1_bias=rnd(cin, s=0.1),
             w1=rnd(cout, cin, 3, 3, s=0.1).to(dtype), b1=rnd(cout, s=0.1).to(dtype),
             gn2_scale=1 + rnd(cout, s=0.1), gn2_bias=rnd(cout, s=0.1),
             w2=rnd(cout, cout, 3, 3, s=0.1).to(dtype), b2=rnd(cout, s=0.1).to(dtype))
    if cin != cout:
        p["w_skip"], p["b_skip"] = rnd(cout, cin, 1, 1, s=0.2).to(dtype), rnd(cout).to(dtype)
    if quant:
        for name, scale in (("w1", "s1"), ("w2", "s2"), ("w_skip", "s_skip")):
            if name in p:
                p[name + "_q"], p[scale] = fr.quantize_conv_weight(
                    p.pop(name).float().permute(2, 3, 1, 0))
    x = (rnd(batch, cin, h, w) + 0.5).to(dtype)
    e = rnd(batch, cout).to(dtype)
    return x, e, p


@pytest.mark.parametrize("cin,cout,h,w", [(64, 64, 6, 5), (32, 64, 8, 8), (64, 32, 9, 13)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_fused_resblock_matches_plain_version(cuda, cin, cout, h, w, quant, dtype, tol):
    """K6, float and int8 weights, identity and 1x1 skip, ragged images; one
    launch of the entry that resblock_entries names (the tensor-core one
    for bf16, the CUDA-core one for fp32)."""
    x, e, p = _resblock_case(cuda, cin, cout, h, w, dtype, quant)
    entry = fr.resblock_entries(x)
    assert entry is (fr.KERNEL_TC if dtype == torch.bfloat16 else fr.KERNEL)
    before = (fr.KERNEL_TC.launches, fr.KERNEL.launches)
    out = fr.fused_resblock(x, e, p)
    torch.cuda.synchronize()
    assert (fr.KERNEL_TC.launches - before[0], fr.KERNEL.launches - before[1]) == (
        (1, 0) if entry is fr.KERNEL_TC else (0, 1))
    _close(out, fr.fused_resblock_ref(x, e, p), tol)


@pytest.mark.parametrize("b,cin,cout,h,w,groups", [
    (1, 64, 64, 12, 20, 32), (2, 96, 160, 12, 20, 32), (2, 40, 48, 7, 9, 8),
    (1, 320, 640, 8, 8, 32), (2, 128, 128, 3, 33, 32)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("splits", [None, (3, 2)])
def test_tensor_core_fused_resblock_matches_plain_version(cuda, b, cin, cout, h, w, groups,
                                                          quant, splits):
    """The tensor-core K6 on ragged shapes: H x W no multiple of the 128-row
    tile, Cin no multiple of the 64-deep stage, batch 1 and 2, identity and
    1x1 skip, float and int8 weights, its own split of K and a forced one
    (a partial-sum reduce launch per conv); reruns are bit-identical."""
    x, e, p = _resblock_case(cuda, cin, cout, h, w, torch.bfloat16, quant, batch=b)
    if splits is not None:
        total = [9 * -(-c // fr.TC_STAGE) for c in (cin, cout)]
        splits = tuple(-(-t // -(-t // min(s, t))) for s, t in zip(splits, total))
    before = (fr.KERNEL_TC.launches, fr.KERNEL.launches)
    out = fr.launch_resblock(fr.KERNEL_TC, x, e, p, groups, splits=splits)
    torch.cuda.synchronize()
    assert (fr.KERNEL_TC.launches - before[0], fr.KERNEL.launches - before[1]) == (1, 0)
    _close(out, fr.fused_resblock_ref(x, e, p, groups), BF16_TOL)
    for _ in range(2):
        assert torch.equal(fr.launch_resblock(fr.KERNEL_TC, x, e, p, groups, splits=splits), out)


def test_tensor_core_fused_resblock_refuses_fp32_and_odd_widths(cuda):
    """The tensor-core K6 takes bf16 only (fp32 products are the CUDA-core
    entry's), and Cin % 8 == 0, Cout % 16 == 0."""
    x, e, p = _resblock_case(cuda, 32, 64, 6, 7, torch.float32, quant=False)
    with pytest.raises(TypeError, match="bf16"):
        fr.launch_resblock(fr.KERNEL_TC, x, e, p)
    x, e, p = _resblock_case(cuda, 40, 40, 6, 7, torch.bfloat16, quant=False)
    with pytest.raises(ValueError, match="Cout % 16"):
        fr.launch_resblock(fr.KERNEL_TC, x, e, p, 8)


@pytest.mark.parametrize("quant", [False, True])
def test_tensor_core_fused_resblock_reads_strided_and_misaligned_views(cuda, quant):
    """x as every other channel of a wider tensor, and x 2 bytes past a
    16-byte boundary (copied for the tensor-core entry), give the plain
    version's result."""
    x, e, p = _resblock_case(cuda, 64, 32, 9, 13, torch.bfloat16, quant)
    wide = torch.repeat_interleave(x, 2, dim=1)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    flat[1:].copy_(x.reshape(-1))
    skewed = flat[1:].view(x.shape)
    assert skewed.data_ptr() % 16
    ref = fr.fused_resblock_ref(x, e, p)
    for view in (wide[:, ::2], skewed):
        _close(fr.fused_resblock(view, e, p), ref, BF16_TOL)


def test_resblock_module_feeds_its_tap_major_copies(cuda):
    """A bf16 ResBlock on the card hands K6 its float weights' HWIO copies,
    made once and kept until the weights change."""
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.unet import ResBlock

    block = random_init_(ResBlock(64, 128, 32, torch.bfloat16, device=cuda, fused=True),
                         torch.Generator(device=cuda).manual_seed(2))
    p = block.fused_params()
    assert all(p[n + "_t"].shape == p[n].permute(2, 3, 1, 0).shape for n in ("w1", "w2", "w_skip"))
    assert block.fused_params()["w1_t"] is p["w1_t"]
    x = torch.randn(2, 64, 8, 8, device=cuda).to(torch.bfloat16)
    emb = torch.randn(2, 32, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        out = block(x, emb)
        ref = fr.fused_resblock_ref(x, block.emb_layers(emb), p)
    _close(out, ref, BF16_TOL)


def _ffn_case(cuda, n, d, dtype, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    inner = 4 * d
    x = torch.randn(n, d, generator=g, device=cuda).to(dtype)
    w1 = (torch.randn(2 * inner, d, generator=g, device=cuda) * d ** -0.5).to(dtype)
    b1 = (torch.randn(2 * inner, generator=g, device=cuda) * 0.1).to(dtype)
    w2 = (torch.randn(d, inner, generator=g, device=cuda) * inner ** -0.5).to(dtype)
    b2 = (torch.randn(d, generator=g, device=cuda) * 0.1).to(dtype)
    return x, w1, b1, w2, b2


def _k7_launches():
    return [ffn.KERNEL_TC.launches, ffn.KERNEL.launches]


@pytest.mark.parametrize("n,d", [(70, 64), (24, 320)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_fused_ffn_matches_plain_version(cuda, n, d, dtype, tol):
    """One launch of the entry that ffn_entries names: the tensor-core one
    for bf16, the CUDA-core one for fp32."""
    args = _ffn_case(cuda, n, d, dtype)
    before = _k7_launches()
    out = ffn.fused_ffn(*args)
    torch.cuda.synchronize()
    assert _moved(before, _k7_launches()) == ([1, 0] if dtype == torch.bfloat16 else [0, 1])
    _close(out, ffn.fused_ffn_ref(*args), tol)


@pytest.mark.parametrize("n,d", [(130, 64), (300, 320), (129, 640), (8, 1280), (1000, 320),
                                 (40, 96)])
def test_tensor_core_fused_ffn_matches_plain_version(cuda, n, d):
    """The tensor-core K7 on ragged rows, d = 320 on a masked 128-wide down
    tile, d = 96 (one 128-wide tile, most of it masked), and a strided x
    (every other column of a wider tensor, copied first)."""
    args = _ffn_case(cuda, n, d, torch.bfloat16)
    ref = ffn.fused_ffn_ref(*args)
    out = ffn.launch_ffn(ffn.KERNEL_TC, *args)
    _close(out, ref, BF16_TOL)
    wide = torch.zeros(n, 2 * d, dtype=torch.bfloat16, device=cuda)
    wide[:, ::2] = args[0]
    _close(ffn.fused_ffn(wide[:, ::2], *args[1:]), ref, BF16_TOL)


def test_tensor_core_fused_ffn_refuses_fp32(cuda):
    """fp32 keeps the CUDA-core entry: the tensor-core one raises on it, in
    the wrapper and in the C entry."""
    args = _ffn_case(cuda, 24, 64, torch.float32)
    with pytest.raises(TypeError):
        ffn.launch_ffn(ffn.KERNEL_TC, *args)
    x = args[0]
    act = torch.empty(24, 256, device=cuda)
    with pytest.raises(RuntimeError):
        ffn.KERNEL_TC.launch(*(t.data_ptr() for t in (*args, act, torch.empty_like(x))),
                             0, 24, 64, 256, torch.cuda.current_stream().cuda_stream)


def test_fused_ffn_gradients_through_the_tensor_cores(cuda):
    """bf16 under autograd on the card: the forward on the tensor-core K7
    (one launch), the backward the recomputed plain version, so the
    gradients equal those of the plain version on the same device."""
    args = _ffn_case(cuda, 40, 64, torch.bfloat16)
    g = torch.randn(40, 64, device=cuda).to(torch.bfloat16)
    grads = {}
    for name, fn in (("kernel", ffn.fused_ffn), ("plain", ffn.fused_ffn_ref)):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        before = _k7_launches()
        out = fn(*leaves)
        assert _moved(before, _k7_launches()) == ([1, 0] if name == "kernel" else [0, 0])
        (out.float() * g.float()).sum().backward()
        grads[name] = [t.grad for t in leaves]
    for a, p in zip(grads["kernel"], grads["plain"]):
        _close(a, p, 1e-6)


def test_touching_a_header_rebuilds(cuda, tmp_path, monkeypatch):
    """The library's name covers csrc/*.cuh: after an edit to the shared
    header the source builds into a new library instead of loading the old."""
    src = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    first, log = _cuda.build(src / "quant_matmul.cu")
    assert first.exists() and log
    assert _cuda.build(src / "quant_matmul.cu") == (first, "")
    header = src / "tile_gemm.cuh"
    header.write_text(header.read_text() + "\n// touched\n")
    second, log = _cuda.build(src / "quant_matmul.cu")
    assert second != first and second.exists() and log


def test_fused_modes_gradients_match_cpu(cuda):
    """The float fused ResBlock and FFN under autograd on the card (K6 / K7
    forward, the recomputed plain version backward) against the CPU."""
    x, e, p = _resblock_case(cuda, 32, 64, 6, 7, torch.float32, quant=False)
    g = torch.Generator(device=cuda).manual_seed(6)
    w1 = torch.randn(512, 64, generator=g, device=cuda) * 0.1
    w2 = torch.randn(64, 256, generator=g, device=cuda) * 0.1
    b1, b2 = torch.randn(512, device=cuda), torch.randn(64, device=cuda)
    xf = torch.randn(30, 64, generator=g, device=cuda)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        before = (fr.KERNEL.launches, ffn.KERNEL.launches)
        leaves = {k: v.detach().to(dev).requires_grad_() for k, v in p.items()}
        xs, es = (t.detach().to(dev).requires_grad_() for t in (x, e))
        out = fr.fused_resblock(xs, es, leaves)
        fl = [t.detach().to(dev).requires_grad_() for t in (xf, w1, b1, w2, b2)]
        out2 = ffn.fused_ffn(*fl)
        (out.square().sum() + out2.square().sum()).backward()
        launched = (fr.KERNEL.launches - before[0], ffn.KERNEL.launches - before[1])
        res[dev.type] = ([t.grad.cpu() for t in (xs, es, *leaves.values(), *fl)], launched)
    assert res["cuda"][1] == (1, 1) and res["cpu"][1] == (0, 0)
    for a, c in zip(res["cuda"][0], res["cpu"][0]):
        assert (a - c).abs().max().item() <= 1e-4 * max(c.abs().max().item(), 1e-12)


def test_small_fp32_model_in_the_serving_modes_matches_cpu(cuda):
    """A small fp32 ControlLDM (head dim 64) in the fused mode (K6, K7, K3)
    and in the int8 mode (K4, K6 int8, K3) on the card and on the CPU, same
    weights. The fused forward agrees to fp32 sums (1e-3 of its largest
    value); the int8 one to 1e-2, since K4 rounds activations to bf16 and
    sums in another order move some of them by one bf16 step."""
    import copy

    from diffbir_tpu_torch.models.cldm import (ControlLDM, quantize_conv_params,
                                               quantize_dense_params)
    from diffbir_tpu_torch.models.clip import CLIPTextEncoder
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.unet import ControlNet, UNetModel
    from diffbir_tpu_torch.models.vae import AutoencoderKL

    kw = dict(model_channels=64, num_head_channels=64, channel_mult=(1, 2),
              attention_resolutions=(2, 1), context_dim=64, num_res_blocks=1,
              fused_resblock=True, fused_ffn=True)
    cpu = ControlLDM(unet=UNetModel(**kw), vae=AutoencoderKL(ch=64, ch_mult=(1, 1, 1, 1),
                     num_res_blocks=1), clip=CLIPTextEncoder(width=64, heads=4, layers=3),
                     controlnet=ControlNet(**kw))
    random_init_(cpu, torch.Generator().manual_seed(3)).eval()
    cpu.set_flash_layout("packed")
    int8 = quantize_conv_params(quantize_dense_params(copy.deepcopy(cpu)))
    gen = torch.Generator().manual_seed(4)
    x, c_img = torch.randn(2, 16, 16, 4, generator=gen), torch.randn(2, 16, 16, 4, generator=gen)
    cond = {"c_txt": torch.randn(2, 77, 64, generator=gen), "c_img": c_img}
    t = torch.tensor([999.0, 21.0])
    kernels = (fa.KERNEL_PRESCALED, qm.KERNEL_TC, qm.KERNEL_GEMV, qm.KERNEL, fr.KERNEL,
               ffn.KERNEL)
    # 12 ResBlocks and 10 transformers (UNet 8 + 7, ControlNet 4 + 3); 11
    # K4 sites per transformer (the tile form; the cross-attention k/v is
    # one product over cat(to_k, to_v)) and one per ResBlock (the GEMV form
    # on the 2 timestep rows); fp32 keeps K3 and K7 on their CUDA-core
    # entries, K4 on the tensor cores
    for model, tol, launched in ((cpu, 1e-3, (10, 0, 0, 0, 12, 10)),
                                 (int8, 1e-2, (10, 110, 12, 0, 12, 0))):
        with torch.no_grad():
            ref = model(x, t, cond)
            gpu = copy.deepcopy(model).to(cuda)
            before = [k.launches for k in kernels]
            out = gpu(x.to(cuda), t.to(cuda), {k: v.to(cuda) for k, v in cond.items()})
            torch.cuda.synchronize()
        assert tuple(k.launches - b for k, b in zip(kernels, before)) == launched
        assert bool(torch.isfinite(out).all())
        assert (out.cpu() - ref).abs().max().item() <= tol * ref.abs().max().item()


# --------------------------------------------------------------------------- #
# the captioner: K5 and a small LLaVA
# --------------------------------------------------------------------------- #
def _k5_launches():
    """Launch counts of K5's entries: the tile form, the GEMV form, the
    CUDA-core one."""
    return [e.launches for e in (qm.KERNEL_INT4_TC, qm.KERNEL_INT4_GEMV, qm.KERNEL_INT4)]


def _k5_case(cuda, m, k, n, dtype, seed=7):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    packed, scale = qm.quantize_weight_int4(torch.randn(k, n, generator=g, device=cuda))
    return x, packed, scale


@pytest.mark.parametrize("m,k,n", [(1, 512, 512), (1, 768, 70), (3, 256, 130), (9, 512, 64),
                                   (37, 768, 130)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_TOL)])
def test_quant_matmul_int4_matches_plain_version(cuda, m, k, n, dtype, tol):
    """K5 in its GEMV form (M <= 8; N % 16 == 0 and ragged N) and its tile
    form (ragged M and N), one launch of the entry that int4_entries names;
    x and the dequantised weight rounded to bf16 on both sides, so fp32
    agrees to the sum order."""
    x, packed, scale = _k5_case(cuda, m, k, n, dtype)
    entry = qm.int4_entries(x)
    before = _k5_launches()
    out = qm.quant_matmul_int4(x, packed, scale)
    torch.cuda.synchronize()
    assert _moved(before, _k5_launches()) == [entry is qm.KERNEL_INT4_TC,
                                              entry is qm.KERNEL_INT4_GEMV, 0]
    _close(out, qm.quant_matmul_int4_ref(x, packed, scale), tol)
    assert torch.equal(out, qm.quant_matmul_int4(x, packed, scale))  # no atomics
    with pytest.raises(ValueError, match="K %"):
        qm.quant_matmul_int4(x[:, :128], packed[:64], scale[:1])


@pytest.mark.parametrize("entry,m,k,n", [
    ("TC", 9, 4096, 4001), ("TC", 77, 4096, 4001), ("TC", 624, 512, 384), ("TC", 130, 4352, 64),
    ("GEMV", 1, 4096, 4001), ("GEMV", 2, 4096, 4001), ("GEMV", 8, 4352, 1024),
    ("GEMV", 1, 11008, 256), ("GEMV", 5, 256, 70)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_TOL)])
def test_quant_matmul_int4_entries_match_plain_version(cuda, entry, m, k, n, dtype, tol):
    """Each new K5 entry on its own count: N = 4001 (padded to whole 16-byte
    chunks), M = 1, 2, 8, 9 and 77, K of 17 and 43 windows (ragged splits),
    fp32 x on the tensor cores and in the GEMV form."""
    x, packed, scale = _k5_case(cuda, m, k, n, dtype)
    kernel = getattr(qm, f"KERNEL_INT4_{entry}")
    before = _k5_launches()
    out = qm.launch_int4(kernel, x, packed, scale)
    torch.cuda.synchronize()
    assert _moved(before, _k5_launches()) == [entry == "TC", entry == "GEMV", 0]
    assert out.shape == (m, n) and out.dtype == dtype
    _close(out, qm.quant_matmul_int4_ref(x, packed, scale), tol)


@pytest.mark.parametrize("m", [1, 200])
def test_quant_matmul_int4_reads_strided_and_misaligned_views(cuda, m):
    """A strided x, an x 2 bytes past a 16-byte boundary and a misaligned
    packed weight are copied for K5's entries and give the plain version's
    result."""
    k, n = 512, 256
    g = torch.Generator(device=cuda).manual_seed(8)
    wide = torch.randn(m, 2 * k, generator=g, device=cuda).to(torch.bfloat16)
    flat = torch.randn(m * k + 1, generator=g, device=cuda).to(torch.bfloat16)
    packed, scale = qm.quantize_weight_int4(torch.randn(k, n, generator=g, device=cuda))
    p_flat = torch.empty(packed.numel() + 3, dtype=torch.int8, device=cuda)
    p_flat[3:].copy_(packed.reshape(-1))
    skewed = p_flat[3:].view(packed.shape)
    assert skewed.data_ptr() % 16 and flat[1:].data_ptr() % 16
    for x in (wide[:, ::2], flat[1:].view(m, k)):
        _close(qm.quant_matmul_int4(x, skewed, scale), qm.quant_matmul_int4_ref(x, packed, scale),
               BF16_TOL)


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (2, 11008, 4096), (1, 4096, 11008)])
def test_int4_gemv_reruns_are_bit_identical(cuda, m, k, n):
    """K5's GEMV form sums its K splits in a fixed order, with no atomics."""
    x, packed, scale = _k5_case(cuda, m, k, n, torch.bfloat16)
    first = qm.quant_matmul_int4(x, packed, scale)
    for _ in range(3):
        assert torch.equal(qm.quant_matmul_int4(x, packed, scale), first)


def test_int4_linear_on_the_card_matches_cpu(cuda):
    lin = torch.nn.Linear(512, 96)
    torch.nn.init.normal_(lin.weight, std=0.05)
    layer = qm.Int4Linear.from_linear(lin)
    x = torch.randn(2, 3, 512)
    with torch.no_grad():
        ref = layer(x)
        out = layer.to(cuda)(x.to(cuda))
    assert out.device.type == "cuda"
    _close(out.cpu(), ref, 1e-5)


def test_small_llava_captioner_matches_cpu(cuda):
    """A small fp32 LLaVA (head dims 64: K1 in the vision tower) captions one
    image on the card and on the CPU, float and int4 (K5 at every one of its
    7 x 2 linears in the prefill and in each decode step). Teacher forcing
    on the CPU's ids: logits within 1e-3 x max|ref| (float) or 1e-2 (int4:
    activations rounded to bf16 before each product), and equal ids wherever
    the CPU's top-2 margin exceeds that limit."""
    import copy

    import numpy as np

    from diffbir_tpu_torch.captioners.llava import LLaVACaptioner
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.llava import (ClipVisionConfig, Llava, LlamaConfig,
                                                quantize_llama_)

    cfg = LlamaConfig(dim=256, n_layers=2, n_heads=4, ffn_dim=512, vocab_size=256)
    vcfg = ClipVisionConfig(image_size=112, patch_size=14, width=128, layers=3, heads=2,
                            mlp_dim=256)
    float_model = random_init_(Llava(cfg, vcfg), torch.Generator().manual_seed(3)).eval()
    image = np.random.default_rng(0).integers(0, 256, (90, 130, 3), dtype=np.uint8)
    for bits, tol in ((16, 1e-3), (4, 1e-2)):
        model = float_model if bits == 16 else quantize_llama_(copy.deepcopy(float_model), 4)
        caps = {dev: LLaVACaptioner(copy.deepcopy(model), [1, 7, 8], [9, 10], max_new_tokens=5,
                                    eos_id=-1, device=dev) for dev in ("cpu", "cuda")}
        before = (fa.KERNEL.launches, *_k5_launches())
        tokens = caps["cuda"].generate(image)
        torch.cuda.synchronize()
        launched = _moved(before, (fa.KERNEL.launches, *_k5_launches()))
        # int4: the prefill's 14 linears on the tile form, 4 decode steps' on
        # the GEMV form, none on the CUDA-core entry
        assert launched == ([2, 14, 14 * 4, 0] if bits == 4 else [2, 0, 0, 0])
        ref_tokens = caps["cpu"].generate(image)
        logits = {}
        for dev, cap in caps.items():
            with torch.no_grad():
                embeds = cap.prompt_embeds(image)
                seq = torch.cat([embeds, cap.model.language_model.model.embed_tokens(
                    ref_tokens[:, :-1].to(dev))], dim=1)
                logits[dev] = cap.model.language_model(seq)[0, embeds.shape[1] - 1:].cpu()
        ref = logits["cpu"]
        limit = tol * ref.abs().max().item()
        assert (logits["cuda"] - ref).abs().max().item() <= limit
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > limit
        assert torch.equal(tokens[0].cpu()[clear], ref_tokens[0][clear])


def _runtime_records(prof):
    """The profiler's CUDA runtime calls (host side), oldest first."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name.startswith("cuda")),
                  key=lambda e: e.time_range.start)


def _callers(e) -> str:
    names, p = [], e.cpu_parent
    while p is not None:
        names.append(p.name)
        p = p.cpu_parent
    return f"{e.name} under {' < '.join(names) or 'no operator'}"


def test_a_span_lies_on_the_profilers_timeline(cuda, monkeypatch):
    """A span around a sleep kernel's launch, shifted by the measured offset
    (``spans.profiler_offset_ns``), holds the launch's runtime record within
    the offset's uncertainty; its device time holds the kernel."""
    from torch.profiler import ProfilerActivity, profile

    from diffbir_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "_enabled", True)
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with spans.span("test.sleep", cuda) as sp:
            torch.cuda._sleep(2_000_000)
        marks = spans.clock_marks()
        torch.cuda.synchronize()
    offset, unc = spans.profiler_offset_ns(prof, marks)
    events = prof.profiler.kineto_results.events()
    kernel = min((e for e in events if spans.MARK_KERNEL in e.name()
                  and e.device_type().name == "CUDA"), key=lambda e: e.start_ns())
    launch = next(e for e in events if e.device_type().name == "CPU" and "Launch" in e.name()
                  and e.correlation_id() == kernel.correlation_id())
    print(f"offset {offset} ns +- {unc} ns; launch {launch.start_ns()}-{launch.end_ns()}, span "
          f"{sp.start_ns + offset}-{sp.end_ns + offset}; device {sp.seconds()[0] * 1e3:.4f} ms, "
          f"kernel {(kernel.end_ns() - kernel.start_ns()) / 1e6:.4f} ms")
    assert unc < 200_000
    assert sp.start_ns + offset - unc <= launch.start_ns() <= launch.end_ns() <= (
        sp.end_ns + offset + unc)
    assert sp.seconds()[1] == "device"
    assert sp.device_ms >= 0.9 * (kernel.end_ns() - kernel.start_ns()) / 1e6


def test_pipeline_timings_wait_only_at_the_final_copy(cuda):
    """``Pipeline.run(timings=)`` of the served pipeline (SwinIR cleaner,
    shifted windows) on the card issues no device or stream sync before the
    copy of its result to the host (the profiler's runtime records), and its
    stages' device times add up to at most the call."""
    import time

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.swinir import SwinIR
    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.profile_step import stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    _, model = _small_fp32_pair(cuda)
    swinir = SwinIR(embed_dim=16, depths=[2], num_heads=[2], window_size=4, mlp_ratio=2)
    swinir = random_init_(swinir, torch.Generator().manual_seed(2)).to(cuda).eval()
    pipe = SwinIRPipeline(swinir, model, Schedule.v21(), cuda, min_cond_size=64,
                          tokenizer=stand_in_tokenizer())
    lq = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    kw = dict(steps=3, cfg_scale=4.0, pos_prompt="a photo", sampler_type="edm_dpm++_3m_sde")
    pipe.run(lq, **kw)
    torch.cuda.synchronize()
    timings = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run(lq, timings=timings, **kw)
        wall = time.perf_counter() - t0
    runtime = _runtime_records(prof)
    last_copy = max(e.time_range.start for e in runtime if e.name.startswith("cudaMemcpy"))
    syncs = [e for e in runtime if e.name in ("cudaDeviceSynchronize", "cudaStreamSynchronize")
             and e.time_range.start < last_copy]
    assert not syncs, "; ".join(_callers(e) for e in syncs)
    assert list(timings) == ["cleaner", "condition", "hoist", "denoise", "decode", "colour_fix"]
    assert all(v > 0 for v in timings.values()) and sum(timings.values()) <= wall
