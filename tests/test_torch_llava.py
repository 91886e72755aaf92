"""The LLaVA-1.5 captioner slice against the JAX package, on the CPU: the
packed-int4 quantiser (bit-equal), K5's plain version against the Pallas
kernel in interpret mode and the XLA fallback, ``Int4Linear``, the converter,
the Llama decoder (float, int8, int4), the vision tower and projector, the
CLIP preprocessing and the whole tiny caption.

Tolerances:
- K5's plain version rounds x and the dequantised weight to bf16 on both
  sides and sums exact products in fp32: fp32 outputs agree to 1e-5 x
  max|ref| (the sum order), bf16 outputs to one bf16 ulp (2^-8 x max|ref|).
- Float modules at fp32: 1e-4 x max(1, max|ref|).
- The int8 and int4 models round activations to bf16 before every quantised
  product, so a sum-order difference of the input can move a value by one
  bf16 step: 1e-2 x max|ref|, and the float model must fail that limit
  against the int4 reference.
- ``clip_preprocess`` reproduces PIL's resampler: bit-equal (limit 0).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from diffbir_tpu.captioners import llava_tpu as jax_cap
from diffbir_tpu.models import llava as L
from diffbir_tpu.ops import quant_matmul as jax_qm
from diffbir_tpu_torch.captioners.llava import LLaVACaptioner, clip_preprocess
from diffbir_tpu_torch.models import llava as port
from diffbir_tpu_torch.ops import quant_matmul as port_qm
from diffbir_tpu_torch.weights.convert import llava_to_state_dict

FP32_TOL, BF16_TOL, MODEL_TOL, QUANT_REL = 1e-5, 2.0 ** -8, 1e-4, 1e-2
# int4 sites need K % 256 == 0, which LlamaConfig.tiny() (dim 64) lacks
CFG = L.LlamaConfig(dim=256, n_layers=2, n_heads=4, ffn_dim=512, vocab_size=256,
                    max_seq_len=64)
VCFG = L.ClipVisionConfig.tiny()
PRE_IDS, POST_IDS = [1, 5, 9, 13, 17], [21, 25, 29]


def _err_limit(ref, out, tol, floor=0.0):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    return np.abs(ref - out).max(), tol * max(floor, np.abs(ref).max())


def _vision_params(rng, vcfg, out_dim):
    """A JAX vision tree and projector with random biases and LayerNorm
    affines, so every term carries signal."""
    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    def ln(c):
        return {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

    w, p = vcfg.width, vcfg.patch_size
    vision = {
        "embeddings": {
            "class_embedding": rng.standard_normal(w).astype(np.float32),
            "patch_embedding": {"kernel": (rng.standard_normal((p, p, 3, w)) * 0.05)
                                .astype(np.float32)},
            "position_embedding": {"weight": (0.1 * rng.standard_normal((vcfg.n_patches + 1, w)))
                                   .astype(np.float32)},
        },
        "pre_layrnorm": ln(w),
        "layers": [{"layer_norm1": ln(w), "layer_norm2": ln(w),
                    "self_attn": {k: lin(w, w) for k in ("q_proj", "k_proj", "v_proj",
                                                         "out_proj")},
                    "mlp": {"fc1": lin(w, vcfg.mlp_dim), "fc2": lin(vcfg.mlp_dim, w)}}
                   for _ in range(vcfg.layers)],
    }
    return vision, {"linear_1": lin(w, out_dim), "linear_2": lin(out_dim, out_dim)}


@pytest.fixture(scope="module")
def trees():
    """{bits: (llama, vision, projector)} JAX trees, float (16), int8, int4."""
    rng = np.random.default_rng(0)
    llama = L.init_llama_params(rng, CFG)
    vision, projector = _vision_params(rng, VCFG, CFG.dim)
    out = {16: (llama, vision, projector)}
    for bits in (8, 4):  # the numpy twins: bit-equal, and no per-op compiles
        out[bits] = (L.quantize_llama_params(llama, bits=bits, host=True), vision, projector)
    return out


def _port_model(trees, bits):
    model = port.Llava(CFG, VCFG)
    if bits != 16:
        port.quantize_llama_(model, bits)
    model.load_state_dict(llava_to_state_dict(*trees[bits]), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def models(trees):
    return {bits: _port_model(trees, bits) for bits in (16, 8, 4)}


def _embeds(seed, t):
    return np.random.default_rng(seed).standard_normal((1, t, CFG.dim)).astype(np.float32) * 0.5


# the JAX references, jitted: one compile per tree layout and shape instead
# of one per eager op
_prefill = jax.jit(L.llama_prefill, static_argnums=(1, 3))
_decode_step = jax.jit(L.llama_decode_step, static_argnums=(1,))
_greedy = jax.jit(L.greedy_decode, static_argnums=(1, 3, 4))
_linear = jax.jit(L._linear)
_xla_int4 = jax.jit(jax_qm._xla_quant_matmul_int4)
_unpack_int4 = jax.jit(jax_qm._unpack_int4)


@jax.jit
def _jax_logits_all(llama, embeds):
    """JAX logits at every position of one causal pass (the layers of
    ``llama_prefill``, without its last-row cut)."""
    t = embeds.shape[1]
    causal = jnp.where(jnp.arange(t)[:, None] >= jnp.arange(t)[None, :], 0.0, -1e9)
    x = embeds
    for lp in llama["layers"]:
        x, _ = L.llama_block(lp, CFG, x, jnp.arange(t), None, causal.astype(jnp.float32))
    return L._linear(llama["lm_head"], L._rms_norm(llama["norm"]["weight"], x, CFG.norm_eps))


@jax.jit
def _jax_image_embeds(vision, projector, images):
    feats = L.clip_vision_features(vision, VCFG, images)
    return feats, L.project_image_features(projector, feats)


# --------------------------------------------------------------------------- #
# K5's math
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(512, 384), (256, 64), (768, 130)])
def test_quantize_weight_int4_is_bit_equal_to_jax(shape):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:128, 0] = 0.0  # an all-zero group: the scale floor
    w[128:256, 1] = rng.integers(-7, 7, 128) + 0.5  # .5 ties at scale 1
    w[128, 1] = 7.0
    # eager, as quantize_llama_params calls it (under jit XLA turns the /7
    # into a multiply by 1/7 and the scales move by an ulp)
    p_ref, s_ref = jax_qm.quantize_weight_int4(jnp.asarray(w))
    p_np, s_np = jax_qm.quantize_weight_int4_np(w)
    p, s = port_qm.quantize_weight_int4(torch.from_numpy(w))
    assert p.dtype == torch.int8 and s.dtype == torch.float32
    for pr, sr in ((np.asarray(p_ref), np.asarray(s_ref)), (p_np, s_np)):
        np.testing.assert_array_equal(p.numpy(), pr)
        np.testing.assert_array_equal(s.numpy(), sr)
    assert s[0, 0].item() == np.float32(1e-8) and s[1, 1].item() == 1.0
    np.testing.assert_array_equal(port_qm.unpack_int4(p).numpy(),
                                  np.asarray(_unpack_int4(p_ref)))


@pytest.mark.parametrize("m,k,n", [(1, 512, 512), (5, 256, 256), (37, 768, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_int4_ref_matches_pallas_and_xla(m, k, n, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed, scale = jax_qm.quantize_weight_int4_np(
        rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    pallas = jax_qm._pallas_quant_matmul_int4(xj, packed, scale, block_n=256, interpret=True)
    xla = _xla_int4(xj, packed, scale)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = port_qm.quant_matmul_int4(xt, torch.from_numpy(np.array(packed)),
                                    torch.from_numpy(np.array(scale)))
    assert out.dtype == xt.dtype and out.shape == (m, n)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    for ref in (pallas, xla):
        err, limit = _err_limit(np.asarray(ref.astype(jnp.float32)), out.float().numpy(), tol)
        assert err <= limit, (err, limit)


def test_int4_linear_matches_jax_linear():
    """Int4Linear from a float Linear holds the JAX quantiser's tensors and
    computes ``_linear`` on {w_q4, scale_g, bias}; so does one loaded from the
    converted tree."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((512, 96)).astype(np.float32) * 0.1
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((3, 5, 512)).astype(np.float32)
    q, s = jax_qm.quantize_weight_int4_np(w)
    ref = _linear({"w_q4": q, "scale_g": s, "bias": b}, x)
    lin = torch.nn.Linear(512, 96)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    ql = port_qm.Int4Linear.from_linear(lin)
    assert ql.weight_q4.is_contiguous() and ql.weight_scale_g.is_contiguous()
    np.testing.assert_array_equal(ql.weight_q4.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ql.weight_scale_g.numpy(), np.asarray(s))
    with torch.no_grad():
        err, limit = _err_limit(ref, ql(torch.from_numpy(x)).numpy(), FP32_TOL)
    assert err <= limit, (err, limit)
    with pytest.raises(ValueError, match="in_dim"):
        port_qm.Int4Linear(300, 8)


# --------------------------------------------------------------------------- #
# the converter and the quantised layouts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_converter_loads_the_jax_trees(trees, models, bits):
    """Each JAX tree loads strict=True (done by the fixture) and equals the
    port's own in-place quantisation of the same float weights; int4 sites
    where K % 256 == 0 (all of this config's), lm_head float."""
    converted = models[bits].state_dict()
    assert converted["vision_tower.vision_model.embeddings.patch_embedding.weight"].shape == (
        VCFG.width, 3, VCFG.patch_size, VCFG.patch_size)
    assert "vision_tower.vision_model.pre_layrnorm.weight" in converted
    assert converted["language_model.lm_head.weight"].dtype == torch.float32
    if bits == 16:
        return
    own = port.quantize_llama_(_port_model(trees, 16), bits)
    sd_own = own.state_dict()
    assert sd_own.keys() == converted.keys()
    for key, t in converted.items():
        assert t.dtype == sd_own[key].dtype and torch.equal(t, sd_own[key]), key
    leaf = "weight_q4" if bits == 4 else "weight_q"
    quantised = [k for k, t in converted.items() if t.dtype == torch.int8]
    assert len(quantised) == 7 * CFG.n_layers and all(k.endswith(leaf) for k in quantised)
    assert converted[f"language_model.model.layers.0.mlp.down_proj.{leaf}"].shape == (
        (CFG.ffn_dim // 2 if bits == 4 else CFG.ffn_dim), CFG.dim)


# --------------------------------------------------------------------------- #
# Llama
# --------------------------------------------------------------------------- #
def test_llama_prefill_and_decode_step_match_jax(trees, models):
    llama = trees[16][0]
    lm = models[16].language_model
    emb = _embeds(3, 9)
    ref_logits, ref_caches = _prefill(llama, CFG, emb, 12)
    with torch.no_grad():
        logits, cache = lm.prefill(torch.from_numpy(emb), 12)
    err, limit = _err_limit(ref_logits, logits.numpy(), MODEL_TOL, 1.0)
    assert err <= limit, ("logits", err, limit)
    for (rk, rv), (k, v) in zip(ref_caches, cache):
        for r, o in ((rk, k), (rv, v)):
            err, limit = _err_limit(r, o.numpy(), MODEL_TOL, 1.0)
            assert err <= limit, ("cache", err, limit)
    token = np.array([7], np.int32)
    ref_step, _ = _decode_step(llama, CFG, token, np.int32(9), ref_caches)
    with torch.no_grad():
        step = lm.decode_step(torch.from_numpy(token).long(), 9, cache)
    err, limit = _err_limit(ref_step, step.numpy(), MODEL_TOL, 1.0)
    assert err <= limit, ("decode", err, limit)


def test_greedy_decode_tokens_match_jax(trees, models):
    """Float model: the same tokens as JAX's greedy_decode, free-running and
    with the 2nd token made EOS (padded after it, as
    tests/test_llava.py::test_greedy_decode_eos_masking)."""
    llama = trees[16][0]
    lm = models[16].language_model
    emb = _embeds(4, 7)
    free = np.asarray(_greedy(llama, CFG, emb, 6, -1))
    got = lm.greedy_decode(torch.from_numpy(emb), 6, eos_id=-1)
    assert got.tolist() == free.tolist()
    eos = int(free[0, 1])
    ref = np.asarray(_greedy(llama, CFG, emb, 6, eos))
    got = lm.greedy_decode(torch.from_numpy(emb), 6, eos_id=eos)
    assert got.tolist() == ref.tolist() and got[0, 1] == eos
    assert all(t == eos for t in got[0, 2:].tolist())


def test_quantised_llama_logits_match_jax(trees, models):
    """int8 and int4 models against the JAX int8 and int4 trees, prefill and
    one decode step, within 1e-2 x max|ref|; the float model fails that limit
    against the int4 reference, so the limit sees the quantisation."""
    emb = _embeds(5, 9)
    res = {}
    for bits in (16, 8, 4):
        lm = models[bits].language_model
        with torch.no_grad():
            logits, cache = lm.prefill(torch.from_numpy(emb), 10)
            step = lm.decode_step(torch.tensor([3]), 9, cache)
        res[bits] = np.concatenate([logits.numpy(), step.numpy()])
    for bits in (8, 4):
        llama = trees[bits][0]
        ref, caches = _prefill(llama, CFG, emb, 10)
        ref_step, _ = _decode_step(llama, CFG, np.array([3], np.int32), np.int32(9), caches)
        ref = np.concatenate([np.asarray(ref), np.asarray(ref_step)])
        err, limit = _err_limit(ref, res[bits], QUANT_REL)
        assert err <= limit, (bits, err, limit)
        if bits == 4:
            err_float, _ = _err_limit(ref, res[16], QUANT_REL)
            assert err_float > limit, (err_float, limit)


# --------------------------------------------------------------------------- #
# vision tower, projector, preprocessing
# --------------------------------------------------------------------------- #
def test_vision_tower_and_projector_match_jax(trees, models):
    _, vision, projector = trees[16]
    images = np.random.default_rng(6).standard_normal(
        (2, VCFG.image_size, VCFG.image_size, 3)).astype(np.float32)
    feats, ref = _jax_image_embeds(vision, projector, images)
    model = models[16]
    with torch.no_grad():
        got_feats = model.vision_tower(torch.from_numpy(images))
        got = model.image_embeds(torch.from_numpy(images))
    assert got.shape == (2, VCFG.n_patches, CFG.dim)
    for r, o in ((feats, got_feats), (ref, got)):
        err, limit = _err_limit(r, o.numpy(), MODEL_TOL, 1.0)
        assert err <= limit, (err, limit)


@pytest.mark.parametrize("hw", [(100, 180), (512, 512)])
def test_clip_preprocess_is_pils(hw):
    """The torch resampler reproduces PIL's bicubic resize, so the
    normalised crop is bit-equal to the JAX captioner's (measured error 0 at
    both sizes; the limit is 0)."""
    img = np.random.default_rng(7).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jax_cap.clip_preprocess(Image.fromarray(img), 336)
    got = clip_preprocess(img, 336)
    assert got.dtype == torch.float32 and got.shape == (336, 336, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(clip_preprocess(torch.from_numpy(img), 336).numpy(), ref)


# --------------------------------------------------------------------------- #
# the whole tiny caption
# --------------------------------------------------------------------------- #
def _jax_caption(llama, vision, projector, image, n_new, eos_id):
    """The JAX captioner's composition (``llava_tpu.py`` caption_fn) on ids:
    (prompt embeds, tokens)."""
    x = jax_cap.clip_preprocess(Image.fromarray(image), VCFG.image_size)
    _, img = _jax_image_embeds(vision, projector, x[None])
    tok = llama["embed_tokens"]["weight"]
    embeds = np.concatenate([tok[PRE_IDS][None], np.asarray(img), tok[POST_IDS][None]], axis=1)
    return embeds, np.asarray(_greedy(llama, CFG, embeds, n_new, eos_id))


@pytest.mark.parametrize("bits", [16, 4])
def test_tiny_caption_matches_jax(trees, models, bits):
    """LLaVACaptioner on the CPU against the JAX composition. Float: the
    same ids. int4: teacher forcing, since a bf16 rounding step can flip a
    near-tie: the port's generated ids fed through both models, logits at
    every generated position within 1e-2 x max|ref|, and the port's token
    equal to JAX's argmax wherever JAX's top-2 margin exceeds that limit."""
    n_new, eos = 6, 2
    image = np.random.default_rng(8).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    cap = LLaVACaptioner(models[bits], PRE_IDS, POST_IDS, max_new_tokens=n_new, eos_id=eos,
                         device="cpu")
    tokens = cap.generate(image)
    ids = cap(image)
    assert ids == [t for t in tokens[0].tolist()][:len(ids)] and eos not in ids
    llama, vision, projector = trees[bits]
    ref_embeds, ref_tokens = _jax_caption(llama, vision, projector, image, n_new, eos)
    if bits == 16:
        assert tokens.tolist() == ref_tokens.tolist()
        return
    fed = tokens[:, :-1]
    with torch.no_grad():
        embeds = cap.prompt_embeds(image)
        err, limit = _err_limit(ref_embeds, embeds.numpy(), MODEL_TOL, 1.0)
        assert err <= limit, ("prompt embeds", err, limit)
        seq = torch.cat([embeds, cap.model.language_model.model.embed_tokens(fed)], dim=1)
        logits = cap.model.language_model(seq)[0, embeds.shape[1] - 1:].numpy()
    tok = np.asarray(llama["embed_tokens"]["weight"])
    ref_seq = np.concatenate([ref_embeds, tok[fed.numpy()]], axis=1)
    ref = np.asarray(_jax_logits_all(llama, ref_seq))[0, ref_embeds.shape[1] - 1:]
    err, limit = _err_limit(ref, logits, QUANT_REL)
    assert err <= limit, (err, limit)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > limit
    clear[len(ids) + 1:] = False  # after the first EOS the ids are padding
    assert clear.any()
    np.testing.assert_array_equal(tokens[0].numpy()[clear], ref.argmax(-1)[clear])
