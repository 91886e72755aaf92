"""RAM++ (``--captioner ram``) on the CPU at fp32 against the JAX package.

- ``SwinClassifier``, ``TaggingHead`` and ``RAMPlus`` at
  ``tests/test_ram_captioner.py``'s tiny config, on the JAX modules' seeded
  params converted by ``flax_to_state_dict`` and loaded with
  ``load_state_dict(strict=True)``: outputs within 1e-5 x max|ref| (fp32 sums
  in another order; RAMPlus measured 7.6e-7);
- the preprocessing's resize against PIL's ``Image.BILINEAR`` on uint8 (the
  limit is one level; measured 0 at four sizes, and ``pil_resize``'s BOX
  filter 0 too) and the normalised array equal to the JAX captioner's
  arithmetic;
- the tags of a tiny synthetic tag list: ``RAMCaptioner`` built from a torch
  checkpoint of the tiny model and the two tag files, against JAX's threshold
  rule on the JAX model's logits (the same tags, the same ", " caption);
- the non-strict load (a missing key zero and counted) and the missing
  files: ``--captioner ram`` without a checkpoint or a tag list raises
  FileNotFoundError naming the file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffbir_tpu.captioners import bert_tagging as jbert
from diffbir_tpu.captioners import ram as jram
from diffbir_tpu.captioners import swin_cls as jswin

from diffbir_tpu_torch.captioners import ram
from diffbir_tpu_torch.captioners.bert_tagging import TaggingHead
from diffbir_tpu_torch.captioners.swin_cls import SwinClassifier
from diffbir_tpu_torch.utils.caption import build_captioner
from diffbir_tpu_torch.utils.common import pil_resize
from diffbir_tpu_torch.weights.convert import flax_to_state_dict, load_partial

TINY = dict(num_class=10, des_per_class=3, embed_dim=32, hidden=48, swin_embed_dim=16,
            swin_depths=(1, 1), swin_heads=(2, 4), swin_window=4, tagging_heads=4,
            tagging_layers=1, tagging_intermediate=96)
SWIN = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 4), window_size=4)
TOL = 1e-5


def seeded(shapes, seed):
    """numpy params of a flax shape tree: N(0, 1/fan_in) for rank >= 2, 1 +
    0.1 N for LayerNorm scales, 0.1 N otherwise (label_embed N(0, 1))."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "label_embed":
            return rng.standard_normal(shape).astype(np.float32)
        if len(shape) >= 2:
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_port(module, tree):
    sd = flax_to_state_dict(tree, {k: tuple(v.shape) for k, v in module.state_dict().items()})
    module.load_state_dict(sd, strict=True)
    return module.eval()


def close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max()
    assert out.shape == ref.shape and err <= tol * np.abs(ref).max(), err


@pytest.fixture(scope="module")
def tiny_ram():
    """The JAX RAMPlus, its seeded params and the port's model on them."""
    jm = jram.RAMPlus(**TINY)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    tree = seeded(shapes, 0)
    logits = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    return jm, tree, x, logits, to_port(ram.RAMPlus(**TINY), tree)


def test_swin_classifier_matches_jax():
    jm = jswin.SwinClassifier(img_size=32, **SWIN)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    tree = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    ref = jax.jit(jm.apply)(tree, jnp.asarray(x))
    port = to_port(SwinClassifier(img_size=32, **SWIN), tree)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 1 + 16, 32)
    close(out, ref)


def test_tagging_head_matches_jax():
    jm = jbert.TaggingHead(hidden=48, heads=4, layers=2, intermediate=96)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 10, 48)).astype(np.float32)
    enc = rng.standard_normal((2, 17, 32)).astype(np.float32)
    tree = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(q),
                                 jnp.asarray(enc)), 5)
    ref = jax.jit(jm.apply)(tree, jnp.asarray(q), jnp.asarray(enc))
    port = to_port(TaggingHead(hidden=48, heads=4, layers=2, intermediate=96, enc_width=32),
                   tree)
    with torch.no_grad():
        out = port(torch.from_numpy(q), torch.from_numpy(enc)).numpy()
    close(out, ref)
    assert "encoder.layer.1.crossattention.self.query.weight" in port.state_dict()


def test_ramplus_matches_jax(tiny_ram):
    _, _, x, ref, port = tiny_ram
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 10) and out.dtype == np.float32
    close(out, ref)


@pytest.mark.parametrize("hw", [(37, 50), (512, 300), (384, 384)])
def test_preprocess_resize_is_pil_bilinear(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((384, 384), Image.BILINEAR))
    out = pil_resize(torch.from_numpy(img), (384, 384), "bilinear").numpy()
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    arr = (np.asarray(ref, np.float32) / 255.0 - jram.IMAGENET_MEAN) / jram.IMAGENET_STD
    np.testing.assert_array_equal(ram.preprocess(img), arr)


@pytest.fixture()
def tiny_files(tmp_path, tiny_ram):
    """The tiny model's torch checkpoint and a 10-tag list whose thresholds
    straddle the JAX model's probabilities of the test image."""
    jm, tree, _, _, port = tiny_ram
    img = np.random.default_rng(6).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    arr = (np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR), np.float32)
           / 255.0 - jram.IMAGENET_MEAN) / jram.IMAGENET_STD
    logits = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(arr[None])))[0]
    probs = 1.0 / (1.0 + np.exp(-logits))
    thresholds = np.where(np.arange(10) % 2 == 0, probs - 0.05, probs + 0.05)
    tags = [f"tag {i}" for i in range(10)]
    data = tmp_path / "ram_data"
    data.mkdir()
    (data / "ram_tag_list.txt").write_text("\n".join(tags) + "\n")
    (data / "ram_tag_list_threshold.txt").write_text(
        "\n".join(f"{t:.6f}" for t in thresholds) + "\n")
    ckpt = tmp_path / ram.CKPT_NAME
    torch.save({k: v.clone() for k, v in port.state_dict().items()}, ckpt)
    # JAX's rule on JAX's logits
    expected = [t for t, p, th in zip(tags, probs, np.asarray(thresholds, np.float32))
                if p > th]
    return img, str(ckpt), str(data), expected


def test_tags_match_jax_threshold_rule(tiny_files, monkeypatch):
    img, ckpt, data, expected = tiny_files
    full = ram.RAMPlus
    monkeypatch.setattr(ram, "RAMPlus", lambda num_class, dtype, device: full(
        **{**TINY, "num_class": num_class}, dtype=dtype, device=device))
    cap = ram.RAMCaptioner(ckpt, data, image_size=32, dtype=torch.float32, device="cpu")
    assert cap.tags(img) == expected and 0 < len(expected) < 10
    assert cap(img) == ", ".join(expected)


def test_load_partial_zeroes_and_counts_missing_keys(tiny_ram, capsys):
    port = ram.RAMPlus(**TINY)
    sd = {k: v for k, v in tiny_ram[4].state_dict().items() if k != "fc.bias"}
    assert load_partial(port, sd) == 1
    assert float(port.fc.bias.abs().sum()) == 0.0
    torch.testing.assert_close(port.label_embed, sd["label_embed"], rtol=0, atol=0)
    sd["fc.weight"] = sd["fc.weight"][:, :4]
    with pytest.raises(ValueError, match="fc.weight"):
        load_partial(port, sd, "x.pth")


def test_missing_files_raise_naming_them(tiny_files, tmp_path, monkeypatch):
    _, ckpt, data, _ = tiny_files
    monkeypatch.delenv("DIFFBIR_TPU_RAM_CKPT", raising=False)
    monkeypatch.setenv("DIFFBIR_TPU_RAM_DATA", data)
    with pytest.raises(FileNotFoundError, match=ram.CKPT_NAME):
        build_captioner("ram", device="cpu")
    monkeypatch.setenv("DIFFBIR_TPU_RAM_CKPT", str(tmp_path / "none.pth"))
    with pytest.raises(FileNotFoundError, match="none.pth"):
        build_captioner("ram", device="cpu")
    monkeypatch.setenv("DIFFBIR_TPU_RAM_CKPT", ckpt)
    os.remove(os.path.join(data, "ram_tag_list_threshold.txt"))
    with pytest.raises(FileNotFoundError, match="ram_tag_list_threshold.txt"):
        build_captioner("ram", device="cpu")
