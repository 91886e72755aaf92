"""The port's training data pipeline on the CPU against the JAX package and
OpenCV, on images and file lists the tests write.

- the kernel makers (the Real-ESRGAN mixture of each kind, the sinc) and the
  Gaussian noise: bit-equal to JAX's from one numpy seed;
- OpenCV's calls on fp32 as ``utils.warp`` computes them: ``filter2d``
  (``cv2.filter2D``, 21x21, fp32 and fp64 kernels), ``resize`` (INTER_AREA,
  INTER_LINEAR, INTER_CUBIC at shrinking, growing, integer and mixed
  factors) and the batch's 51-tap ``GaussianBlur``, each within 1e-5 x
  max|ref| (fp32 sums in another order; measured 6e-7, 5e-6, 3e-7);
- the JPEG round trip (``dataset/jpeg.py``) against cv2's imencode/imdecode
  at qualities 30-95 on smooth and noise images of even and odd sizes: bit
  for bit (the limit is 0 levels; measured 0 at every case); and the port's
  ``jpeg_compress_np`` equal to JAX's;
- ``RealESRGANDataset`` and ``CodeformerDataset`` on a PNG folder: one seed
  gives the JAX datasets' crops, kernels and prompts (equal), and
  CodeFormer's lq within 1 level (its blur and resize are fp32 sums in
  another order ahead of the JPEG's rounding; measured 1.2e-4 of a level);
- the batch transform at the v2.1 config, both packages seeded alike (the
  transform's generator and Python's ``random``): gt within 1e-6, lq within
  the limits set from its readings (``LQ_MAX_LEVELS`` and the two beside
  it), which a resize in another mode fails, the prompts and the queue's
  order equal; the noise alone
  (Gaussian, Poisson, gray) bit-equal with the generator left in the same
  state;
- ``PrefetchIterator``'s terminal state, close and error behaviour as
  ``tests/test_dataset.py`` holds JAX's; ``to_device`` on the CPU;
- the refusals: a non-PNG image, a ``.parquet`` list, ``petrel_backend``.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from diffbir_tpu.dataset import batch_transform as jbt  # noqa: E402
from diffbir_tpu.dataset import codeformer as jcf  # noqa: E402
from diffbir_tpu.dataset import degradation as jdeg  # noqa: E402
from diffbir_tpu.dataset import realesrgan as jre  # noqa: E402

from diffbir_tpu_torch import config as cfglib  # noqa: E402
from diffbir_tpu_torch import dataset as _registry  # noqa: E402,F401
from diffbir_tpu_torch.dataset import batch_transform as pbt  # noqa: E402
from diffbir_tpu_torch.dataset import codeformer as pcf  # noqa: E402
from diffbir_tpu_torch.dataset import degradation as pdeg  # noqa: E402
from diffbir_tpu_torch.dataset import realesrgan as pre  # noqa: E402
from diffbir_tpu_torch.dataset.jpeg import jpeg_round_trip  # noqa: E402
from diffbir_tpu_torch.dataset.prefetch import PrefetchIterator, to_device  # noqa: E402
from diffbir_tpu_torch.utils import warp  # noqa: E402

KINDS = ("iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso", "plateau_aniso")
CV_TOL = 1e-5
# train_stage2_v2.1.yaml's batch transform, with a pool of 4
V21_TRANSFORM = dict(
    use_sharpener=True, queue_size=4, resize_prob=[0.2, 0.7, 0.1], resize_range=[0.3, 1.5],
    gray_noise_prob=0.4, gaussian_noise_prob=0.5, noise_range=[1, 15],
    poisson_scale_range=[0.05, 2.0], jpeg_range=[60, 95], second_blur_prob=0.5,
    stage2_scale=4, resize_prob2=[0.3, 0.4, 0.3], resize_range2=[0.6, 1.2],
    gray_noise_prob2=0.4, gaussian_noise_prob2=0.5, noise_range2=[1, 12],
    poisson_scale_range2=[0.05, 1.0], jpeg_range2=[60, 95])


def smooth_image(rng, h, w, noise=0.03):
    """fp32 [h, w, 3] in [0, 1]: upsampled random colours plus a little
    noise (a photograph's spectrum, roughly)."""
    base = rng.random((h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img + noise * rng.standard_normal(img.shape), 0, 1).astype(np.float32)


def close(out, ref, tol=CV_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), err


# --------------------------------------------------------------------------- #
# kernels and noise
@pytest.mark.parametrize("kind", KINDS)
def test_mixed_kernels_bit_equal(kind):
    a = jdeg.random_mixed_kernels(np.random.default_rng(5), [kind], [1.0], 21)
    b = pdeg.random_mixed_kernels(np.random.default_rng(5), [kind], [1.0], 21)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,pad", [(7, 21), (13, 0), (21, 0)])
def test_sinc_kernel_bit_equal(size, pad):
    np.testing.assert_array_equal(jdeg.circular_lowpass_kernel(np.pi / 3, size, pad),
                                  pdeg.circular_lowpass_kernel(np.pi / 3, size, pad))


@pytest.mark.parametrize("gray", [False, True])
def test_gaussian_noise_bit_equal(gray):
    img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        jdeg.add_gaussian_noise_np(np.random.default_rng(1), img, 10.0, gray),
        pdeg.add_gaussian_noise_np(np.random.default_rng(1), img, 10.0, gray))


@pytest.mark.parametrize("gaussian,gray", [(1.0, 0.0), (1.0, 1.0), (0.0, 0.0), (0.0, 1.0)])
def test_batch_noise_bit_equal(gaussian, gray):
    img = np.stack([smooth_image(np.random.default_rng(i), 40, 32) for i in range(2)])
    ra, rb = np.random.default_rng(2), np.random.default_rng(2)
    a = jbt._add_noise(ra, img, (1, 15), (0.05, 2.0), gaussian, gray)
    b = pbt.add_noise(rb, img, (1, 15), (0.05, 2.0), gaussian, gray)
    np.testing.assert_array_equal(a, b)
    assert ra.bit_generator.state == rb.bit_generator.state


# --------------------------------------------------------------------------- #
# OpenCV's calls
@pytest.mark.parametrize("kdtype", [np.float32, np.float64])
def test_filter2d_against_cv2(kdtype):
    rng = np.random.default_rng(3)
    imgs = np.stack([smooth_image(rng, 48, 40) for _ in range(2)])
    ks = [jdeg.random_mixed_kernels(rng, list(KINDS), [1 / 6] * 6, 21).astype(kdtype)
          for _ in range(2)]
    ref = np.stack([cv2.filter2D(im, -1, k) for im, k in zip(imgs, ks)])
    close(warp.filter2d(torch.from_numpy(imgs), torch.from_numpy(np.stack(ks))), ref)


@pytest.mark.parametrize("mode,flag", [("area", cv2.INTER_AREA), ("linear", cv2.INTER_LINEAR),
                                       ("cubic", cv2.INTER_CUBIC)])
@pytest.mark.parametrize("wh", [(40, 48), (20, 24), (27, 31), (100, 130), (160, 192),
                                (53, 96), (80, 96)])
def test_resize_against_cv2(mode, flag, wh):
    img = np.random.default_rng(4).random((96, 80, 3)).astype(np.float32)
    ref = cv2.resize(img, wh, interpolation=flag)
    close(warp.resize(torch.from_numpy(img), wh, mode), ref)


def test_usm_blur_against_cv2():
    imgs = np.stack([smooth_image(np.random.default_rng(i), 64, 72) for i in range(2)])
    ref = np.stack([cv2.GaussianBlur(im, (51, 51), 0) for im in imgs])
    close(warp.gaussian_blur(torch.from_numpy(imgs), 51), ref)
    out = pbt.usm_sharp(torch.from_numpy(imgs)).numpy()
    close(out, np.stack([jbt._usm_sharp(im) for im in imgs]), 1e-5)


# --------------------------------------------------------------------------- #
# JPEG
def cv2_round_trip(rgb, quality):
    enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                       [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])[1]
    return cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)[..., ::-1]


@pytest.mark.parametrize("quality", [30, 45, 60, 75, 90, 95])
@pytest.mark.parametrize("hw,smooth", [((64, 64), True), ((37, 53), True), ((33, 17), False),
                                       ((96, 128), False)])
def test_jpeg_round_trip_bit_equal_to_cv2(quality, hw, smooth):
    rng = np.random.default_rng(quality + hw[0])
    img = smooth_image(rng, *hw) if smooth else rng.random((*hw, 3))
    u8 = (img * 255).round().astype(np.uint8)
    out = jpeg_round_trip(torch.from_numpy(u8), quality).numpy()
    np.testing.assert_array_equal(out, cv2_round_trip(u8, quality))


def test_jpeg_compress_np_equals_jax():
    img = smooth_image(np.random.default_rng(9), 48, 40)
    for q in (35, 80):
        np.testing.assert_array_equal(pdeg.jpeg_compress_np(img, q),
                                      jdeg.jpeg_compress_np(img, q))


# --------------------------------------------------------------------------- #
# datasets
@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """Six PNGs (96x96, 120x80, 200x150 and three more) and a txt list with
    prompts."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(11)
    sizes = [(96, 96), (80, 120), (150, 200), (96, 96), (130, 100), (96, 96)]
    paths = []
    for i, (h, w) in enumerate(sizes):
        p = str(root / f"img{i}.png")
        Image.fromarray((smooth_image(rng, h, w) * 255).round().astype(np.uint8)).save(p)
        paths.append(p)
    flist = root / "list.txt"
    flist.write_text("\n".join(f"{p}\ta photo number {i}" for i, p in enumerate(paths)) + "\n")
    return root, paths, str(flist)


@pytest.mark.parametrize("crop", ["none", "center", "random"])
def test_realesrgan_dataset_matches_jax(png_folder, crop):
    _, _, flist = png_folder
    kw = dict(file_list=flist, out_size=96, crop_type=crop, use_rot=True,
              p_empty_prompt=0.3, p_long_prompt=0.2)
    ja = jre.RealESRGANDataset(**kw).as_iterator(2, seed=4)
    jb = [next(ja) for _ in range(4)]
    pa = pre.RealESRGANDataset(**kw).as_iterator(2, seed=4)
    pb = [next(pa) for _ in range(4)]
    for a, b in zip(jb, pb):
        assert a["txt"] == b["txt"]
        for k in ("hq", "kernel1", "kernel2", "sinc_kernel"):
            np.testing.assert_array_equal(a[k], b[k])


def test_codeformer_dataset_matches_jax(png_folder):
    _, _, flist = png_folder
    kw = dict(file_list=flist, file_backend_cfg={"target": "hard_disk_backend"}, out_size=96,
              crop_type="center", blur_kernel_size=21, kernel_list=["iso", "aniso"],
              kernel_prob=[0.5, 0.5], blur_sigma=[0.1, 5], downsample_range=[1, 6],
              noise_range=[0, 10], jpeg_range=[40, 95], p_empty_prompt=0.5)
    ja = jcf.CodeformerDataset(**kw).as_iterator(2, seed=5)
    pa = pcf.CodeformerDataset(**kw).as_iterator(2, seed=5)
    for _ in range(3):
        a, b = next(ja), next(pa)
        assert a["prompt"] == b["prompt"]
        np.testing.assert_array_equal(a["gt"], b["gt"])
        assert np.abs(a["lq"] - b["lq"]).max() * 255 <= 1.0 + 1e-4


# the batch transform's lq against JAX's, in levels of 255: at most
# LQ_MAX_LEVELS apart, a mean under LQ_MEAN_LEVELS and at most LQ_DIFF_SHARE
# of values apart at all. Measured over seeds 0-3: at most 1 level, a mean of
# 9.0e-5 of a level, 9.0e-5 of values apart (a value rounded the other way
# ahead of a JPEG); the limits 2x, ~11x and ~11x those. A wrong resize mode
# reads 5-245 levels, a mean of 0.8-55 and 61-99 % apart.
LQ_MAX_LEVELS, LQ_MEAN_LEVELS, LQ_DIFF_SHARE = 2.0, 1e-3, 1e-3


def batch_transform_pairs(flist, seed):
    """Three batches of each package's transform at the v2.1 config, seeded
    alike (the transform's generator and Python's ``random``); the third
    draws from the pool."""
    outs = []
    for ds_mod, bt_mod in ((jre, jbt), (pre, pbt)):
        it = ds_mod.RealESRGANDataset(file_list=flist, out_size=96, crop_type="center"
                                      ).as_iterator(2, seed=seed)
        bt = bt_mod.RealESRGANBatchTransform(**V21_TRANSFORM)
        bt._rng = np.random.default_rng(100 + seed)
        random.seed(200 + seed)
        outs.append([bt(next(it)) for _ in range(3)])
    return list(zip(*outs))


def lq_within_limits(a, b) -> bool:
    d = np.abs(b["lq"] - a["lq"]) * 255
    return bool(d.max() <= LQ_MAX_LEVELS + 1e-3 and d.mean() <= LQ_MEAN_LEVELS
                and (d > 0.5).mean() <= LQ_DIFF_SHARE)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_transform_matches_jax(png_folder, seed):
    _, _, flist = png_folder
    for a, b in batch_transform_pairs(flist, seed):
        assert a["txt"] == b["txt"]
        close(b["gt"], a["gt"], 1e-6)
        assert b["lq"].shape == a["lq"].shape and b["lq"].dtype == np.float32
        d = np.abs(b["lq"] - a["lq"]) * 255
        assert lq_within_limits(a, b), (d.max(), d.mean(), (d > 0.5).mean())


@pytest.mark.parametrize("fault", [{"bilinear": "area"}, {"bicubic": "linear"},
                                   {"area": "linear"}])
def test_batch_transform_limits_catch_a_wrong_resize(png_folder, monkeypatch, fault):
    """The lq limits fail a port whose resize takes another mode."""
    _, _, flist = png_folder
    for mode, warp_mode in fault.items():
        monkeypatch.setitem(pbt._WARP, mode, warp_mode)
    assert not all(lq_within_limits(a, b) for a, b in batch_transform_pairs(flist, 0))


def test_registry_names_build_the_port():
    ds = cfglib.instantiate({"target": "identity_batch_transform"})
    assert isinstance(ds, pbt.IdentityBatchTransform)
    assert cfglib.resolve("realesrgan_dataset") is pre.RealESRGANDataset
    assert cfglib.resolve("codeformer_dataset") is pcf.CodeformerDataset
    assert cfglib.resolve("realesrgan_batch_transform") is pbt.RealESRGANBatchTransform


# --------------------------------------------------------------------------- #
# refusals
def test_refusals(png_folder, tmp_path):
    _, paths, _ = png_folder
    jpg = tmp_path / "photo.jpg"
    Image.open(paths[0]).save(jpg)
    flist = tmp_path / "jpg.txt"
    flist.write_text(str(jpg) + "\n")
    with pytest.raises(ValueError, match="JPEG, not a PNG"):
        pre.RealESRGANDataset(file_list=str(flist), out_size=96)[0]
    with pytest.raises(ValueError, match="pandas"):
        pre.RealESRGANDataset(file_metas=[{"file_list": "data/train.parquet"}])
    with pytest.raises(ImportError, match="petrel_client"):
        cfglib.instantiate({"target": "petrel_backend"})
    assert pre.load_image(cfglib.instantiate({"target": "hard_disk_backend"}),
                          str(tmp_path / "gone.png")) is None


# --------------------------------------------------------------------------- #
# prefetch
def test_prefetch_terminal_state_and_errors():
    it = PrefetchIterator(iter([1, 2]), transform=lambda b: b * 10)
    assert sorted([next(it), next(it)]) == [10, 20]
    for _ in range(3):  # the terminal state is sticky
        with pytest.raises(StopIteration):
            next(it)

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        while True:
            next(it)


def test_prefetch_close_does_not_deadlock():
    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    it = PrefetchIterator(infinite(), depth=1)
    assert isinstance(next(it), int)
    t0 = time.time()
    it.close()
    assert time.time() - t0 < 6.0
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_close_unblocks_a_waiting_consumer():
    def slow():
        yield 1
        time.sleep(30)
        yield 2

    it = PrefetchIterator(slow(), depth=1)
    assert next(it) == 1
    outcome = {}

    def consume():
        try:
            outcome["val"] = next(it)
        except StopIteration:
            outcome["stop"] = True

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.3)
    it.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and outcome.get("stop"), outcome


def test_to_device_on_the_cpu():
    put = to_device("cpu")
    out = put({"gt": np.ones((2, 3), np.float32), "t": torch.zeros(2), "txt": ["a", "b"]})
    assert torch.is_tensor(out["gt"]) and out["gt"].device.type == "cpu"
    assert out["txt"] == ["a", "b"]
    it = PrefetchIterator(iter([{"x": np.arange(3)}]), device_put=put)
    assert torch.equal(next(it)["x"], torch.arange(3))
