"""The plain versions of K6 (fused ResBlock), K7 (fused GEGLU FFN) and K3
(the prescaled-q flash forward) against the JAX package's Pallas kernels run
in interpret mode, on the CPU, and the float modes' gradients against
``jax.grad``.

Tolerances, as limit = tol x max|ref|: fp32 1e-5 (the same math, sums in
another order); bf16 2^-6 for K6 and K7, two bf16 ulps of the largest value:
both sides round at the same points, but XLA on the CPU may keep a bf16
product in fp32 where the kernel rounds it, and a rounding that lands on the
other side moves that element by one ulp, which the next layer carries;
bf16 2^-7 for K3, whose only rounding after the logits is p and the output;
gradients 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.ops import fused_ffn as jax_ffn
from diffbir_tpu.ops import fused_resblock as jax_fr
from diffbir_tpu.ops.flash_attention import _flash_attention_impl_packed
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.ops import fused_ffn as port_ffn
from diffbir_tpu_torch.ops import fused_resblock as port_fr

FP32_TOL, BF16_TOL, K3_BF16_TOL, GRAD_TOL = 1e-5, 2.0 ** -6, 2.0 ** -7, 1e-4


def _check(ref, out, tol):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err, limit = np.abs(ref - out).max(), tol * np.abs(ref).max()
    assert err <= limit, f"max abs err {err} > {limit}"
    return err


def _bf16_values(a):
    """fp32 numpy array of values representable in bf16."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _nchw(a, dtype=torch.float32):
    return _t(np.asarray(a, np.float32).transpose(0, 3, 1, 2), dtype)


# --------------------------------------------------------------------------- #
# K6: fused ResBlock
# --------------------------------------------------------------------------- #
def _resblock_params(rng, cin, cout, skip):
    """JAX-layout params (HWIO weights), bf16-representable values."""
    p = dict(gn1_scale=1 + 0.1 * rng.standard_normal(cin),
             gn1_bias=0.1 * rng.standard_normal(cin),
             w1=rng.standard_normal((3, 3, cin, cout)) * 0.1,
             b1=0.1 * rng.standard_normal(cout),
             gn2_scale=1 + 0.1 * rng.standard_normal(cout),
             gn2_bias=0.1 * rng.standard_normal(cout),
             w2=rng.standard_normal((3, 3, cout, cout)) * 0.1,
             b2=0.1 * rng.standard_normal(cout))
    if skip:
        p["w_skip"] = rng.standard_normal((1, 1, cin, cout)) * 0.2
        p["b_skip"] = 0.05 * rng.standard_normal(cout)
    return {k: _bf16_values(v.astype(np.float32)) for k, v in p.items()}


def _quantised(p):
    q = {k: v for k, v in p.items() if not k.startswith("w")}
    for wk, qk, sk in (("w1", "w1_q", "s1"), ("w2", "w2_q", "s2"),
                       ("w_skip", "w_skip_q", "s_skip")):
        if wk in p:
            w_q, s = jax_fr.quantize_conv_weight(jnp.asarray(p[wk]))
            q[qk], q[sk] = np.asarray(w_q), np.asarray(s)
    return q


def _port_params(p, dtype):
    """The port's dict: float weights OIHW in the dtype, int8 HWIO as they
    are, biases in the dtype, the GN affine and the scales fp32."""
    out = {}
    for k, v in p.items():
        if k.endswith("_q"):
            out[k] = torch.from_numpy(np.array(v))
        elif k in ("w1", "w2", "w_skip"):
            out[k] = _t(np.asarray(v).transpose(3, 2, 0, 1), dtype)
        elif k.startswith("b"):
            out[k] = _t(v, dtype)
        else:
            out[k] = _t(v)
    return out


@pytest.mark.parametrize("cin,cout,h,w", [(64, 64, 6, 5), (32, 64, 4, 8)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_resblock_ref_matches_pallas_interpret(cin, cout, h, w, quant, dtype):
    """Float and int8 weights, identity and 1x1 skip, fp32 and bf16."""
    rng = np.random.default_rng(0)
    p = _resblock_params(rng, cin, cout, skip=cin != cout)
    if quant:
        p = _quantised(p)
    x = _bf16_values(rng.standard_normal((2, h, w, cin)).astype(np.float32) + 0.5)
    e = _bf16_values(rng.standard_normal((2, cout)).astype(np.float32))
    jdt = getattr(jnp, dtype)
    ref = jax_fr.fused_resblock(jnp.asarray(x, jdt), jnp.asarray(e, jdt),
                                {k: jnp.asarray(v) for k, v in p.items()}, force="interpret")
    tdt = getattr(torch, dtype)
    out = port_fr.fused_resblock(_nchw(x, tdt), _t(e, tdt), _port_params(p, tdt))
    assert out.dtype == tdt and out.shape == (2, cout, h, w)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    _check(ref, out.float().numpy(), FP32_TOL if dtype == "float32" else BF16_TOL)


def test_fused_resblock_gradients_match_jax_grad():
    """Float mode: d(sum(out * g)) by x, e and every parameter, against
    jax.grad of the JAX fused block (its custom VJP)."""
    rng = np.random.default_rng(1)
    cin, cout = 32, 64
    p = _resblock_params(rng, cin, cout, skip=True)
    x = rng.standard_normal((2, 4, 6, cin)).astype(np.float32)
    e = rng.standard_normal((2, cout)).astype(np.float32)
    g = rng.standard_normal((2, 4, 6, cout)).astype(np.float32)

    def loss(x_, e_, p_):
        return jnp.sum(jax_fr.fused_resblock(x_, e_, p_, force="interpret") * g)

    gx, ge, gp = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(e),
                                                   {k: jnp.asarray(v) for k, v in p.items()})
    xt = _nchw(x).requires_grad_()
    et = _t(e).requires_grad_()
    pt = {k: v.requires_grad_() for k, v in _port_params(p, torch.float32).items()}
    out = port_fr.fused_resblock(xt, et, pt)
    (out * _nchw(g)).sum().backward()
    _check(np.asarray(gx).transpose(0, 3, 1, 2), xt.grad.numpy(), GRAD_TOL)
    _check(ge, et.grad.numpy(), GRAD_TOL)
    for k, v in gp.items():
        v = np.asarray(v)
        if k in ("w1", "w2", "w_skip"):
            v = v.transpose(3, 2, 0, 1)
        _check(v, pt[k].grad.numpy(), GRAD_TOL)


# --------------------------------------------------------------------------- #
# K7: fused GEGLU FFN
# --------------------------------------------------------------------------- #
def _ffn_inputs(rng, n, d):
    inner = 4 * d
    return [_bf16_values(a.astype(np.float32)) for a in (
        rng.standard_normal((n, d)), rng.standard_normal((d, 2 * inner)) / np.sqrt(d),
        0.1 * rng.standard_normal(2 * inner), rng.standard_normal((inner, d)) / np.sqrt(inner),
        0.1 * rng.standard_normal(d))]


@pytest.mark.parametrize("n,d", [(40, 64), (24, 320)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ffn_ref_matches_pallas_interpret(n, d, dtype):
    """d = 320 as well, which the JAX supported() sends to the XLA path."""
    x, w1, b1, w2, b2 = _ffn_inputs(np.random.default_rng(2), n, d)
    jdt = getattr(jnp, dtype)
    ref = jax_ffn._fused_ffn_impl(jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
                                  jnp.asarray(w2), jnp.asarray(b2), interpret=True)
    tdt = getattr(torch, dtype)
    out = port_ffn.fused_ffn(_t(x, tdt), _t(w1.T, tdt), _t(b1, tdt), _t(w2.T, tdt), _t(b2, tdt))
    assert out.dtype == tdt and out.shape == (n, d)
    _check(np.asarray(ref.astype(jnp.float32)), out.float().numpy(),
           FP32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("d", [320, 640, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_entries_take_the_tensor_cores_for_bf16(d, dtype):
    """ffn_entries names the tensor-core K7 for bf16 at every serving width
    (d = 320 too) and the CUDA-core one for fp32, whose products the bf16
    tensor cores do not give; on the CPU fused_ffn runs the plain version
    and launches neither."""
    want = port_ffn.KERNEL_TC if dtype == torch.bfloat16 else port_ffn.KERNEL
    x = torch.zeros(4, d, dtype=dtype)
    assert port_ffn.ffn_entries(x) is want
    rng = np.random.default_rng(6)
    x, w1, b1, w2, b2 = (_t(a, dtype) for a in _ffn_inputs(rng, 4, d))
    counts = [port_ffn.KERNEL.launches, port_ffn.KERNEL_TC.launches]
    out = port_ffn.fused_ffn(x, w1.T, b1, w2.T, b2)
    assert counts == [port_ffn.KERNEL.launches, port_ffn.KERNEL_TC.launches]
    np.testing.assert_array_equal(out.float().numpy(), port_ffn.fused_ffn_ref(
        x, w1.T, b1, w2.T, b2).float().numpy())


def test_fused_ffn_gradients_match_jax_grad():
    rng = np.random.default_rng(3)
    x, w1, b1, w2, b2 = _ffn_inputs(rng, 24, 64)
    g = rng.standard_normal((24, 64)).astype(np.float32)

    def loss(*args):
        return jnp.sum(jax_ffn.fused_ffn(*args) * g)

    refs = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    ts = [_t(a).requires_grad_() for a in (x, w1.T, b1, w2.T, b2)]
    (port_ffn.fused_ffn(*ts) * _t(g)).sum().backward()
    for ref, t, transpose in zip(refs, ts, (False, True, False, True, False)):
        ref = np.asarray(ref)
        _check(ref.T if transpose else ref, t.grad.numpy(), GRAD_TOL)


# --------------------------------------------------------------------------- #
# K3: prescaled-q flash forward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,h,d", [(1, 256, 2, 128), (2, 128, 3, 64)])
def test_prescaled_flash_ref_matches_packed_pallas_interpret(b, s, h, d):
    """bf16: the packed kernel rounds q once as bf16(q * d^-1/2). At d = 128
    that rounding shows (d^-1/2 is no power of two): the plain version with
    the prescale is closer to the kernel than without it. At d = 64 the
    scale is 1/8 and the two agree."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 2 for _ in range(3))
    ref = np.asarray(_flash_attention_impl_packed(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True).astype(jnp.float32))
    qt, kt, vt = (_t(a, torch.bfloat16) for a in (q, k, v))
    pre = port_flash.flash_attention_fwd(qt, kt, vt, prescale_q=True).float().numpy()
    plain = port_flash.flash_attention_fwd(qt, kt, vt).float().numpy()
    err_pre = _check(ref, pre, K3_BF16_TOL)
    err_plain = np.abs(ref - plain).max()
    if d == 64:
        np.testing.assert_array_equal(pre, plain)
    else:
        assert err_pre < err_plain, (err_pre, err_plain)
        assert np.mean(pre != ref) < np.mean(plain != ref)


def test_prescale_changes_nothing_in_fp32():
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((1, 64, 2, 128))) for _ in range(3))
    np.testing.assert_array_equal(
        port_flash.flash_attention_ref(q, k, v, prescale_q=True).numpy(),
        port_flash.flash_attention_ref(q, k, v).numpy())
