"""The port's binding of the native C++ data loader (``native/``), the cases
of ``tests/test_native_loader.py`` against ``diffbir_tpu_torch``: shapes
across an epoch, a PNG centre crop equal to PIL's pixels, seed determinism,
in-order delivery with many threads, the codeformer and Real-ESRGAN
datasets' ``native=True`` iterators (their crops equal to the Python path's
where no resize is involved, and a repeatable stream), an unreadable file
giving zeros. Skipped, as that file is, where the library neither exists
nor builds."""

import numpy as np
import pytest
from PIL import Image

from diffbir_tpu_torch.dataset.codeformer import CodeformerDataset
from diffbir_tpu_torch.dataset.native_loader import (
    NativeImageLoader,
    native_available,
    native_status,
)
from diffbir_tpu_torch.dataset.realesrgan import RealESRGANDataset


@pytest.fixture(autouse=True)
def needs_native():
    if not native_available():
        pytest.skip(f"native loader not built and no toolchain: {native_status()}")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        # mixed formats and sizes, some smaller than the crop
        h, w = [(80, 120), (64, 64), (200, 90), (48, 72), (128, 128), (90, 200)][i]
        arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        p = d / f"im{i}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    return paths


def codeformer(flist, out_size, crop_type="center"):
    return CodeformerDataset(
        file_list=str(flist), file_backend_cfg={"target": "hard_disk_backend"},
        out_size=out_size, crop_type=crop_type, blur_kernel_size=21,
        kernel_list=["iso", "aniso"], kernel_prob=[0.5, 0.5], blur_sigma=[0.1, 4.0],
        downsample_range=[1, 4], noise_range=[0, 10], jpeg_range=[60, 95], p_empty_prompt=0.0)


def test_status_names_the_library():
    assert native_status().startswith("on (") and "libdiffbir_loader.so" in native_status()


def test_shapes_and_range(image_dir):
    ld = NativeImageLoader(image_dir, batch_size=2, out_size=64, seed=1)
    assert ld.n_files == 6 and ld.batches_per_epoch == 3
    for _ in range(4):  # crosses an epoch boundary
        b = ld.next()
        assert b.shape == (2, 64, 64, 3) and b.dtype == np.uint8
        assert b.max() > 0  # decoded something real
    ld.close()


def test_center_crop_matches_pil(image_dir):
    """center crop, no augment, on a PNG (lossless): exact pixel match."""
    p = [q for q in image_dir if q.endswith("im1.png")]  # 64x64 -> identity
    ld = NativeImageLoader(p, batch_size=1, out_size=64, crop="center",
                           hflip=False, rot90=False, num_threads=1, seed=3)
    got = ld.next()[0]
    ref = np.asarray(Image.open(p[0]).convert("RGB"))
    np.testing.assert_array_equal(got, ref)
    ld.close()


def test_seed_determinism(image_dir):
    def collect(seed, n=3):
        ld = NativeImageLoader(image_dir, batch_size=2, out_size=64, seed=seed, num_threads=3)
        out = np.stack([ld.next() for _ in range(n)])
        ld.close()
        return out

    a, b = collect(7), collect(7)
    np.testing.assert_array_equal(a, b)  # thread-schedule independent
    assert np.any(a != collect(8))


def test_in_order_delivery_many_threads(image_dir):
    """8 workers, queue depth 8: the stream is still seed-deterministic."""
    def collect():
        ld = NativeImageLoader(image_dir, batch_size=1, out_size=48, seed=5,
                               num_threads=8, queue_depth=8)
        out = np.stack([ld.next() for _ in range(12)])  # 2 epochs
        ld.close()
        return out

    np.testing.assert_array_equal(collect(), collect())


def test_codeformer_native_iterator(image_dir, tmp_path):
    flist = tmp_path / "list.txt"
    flist.write_text("\n".join(f"{p}\ta photo" for p in image_dir))
    it = codeformer(flist, 48).as_iterator(2, seed=0, native=True)
    for _ in range(2):
        batch = next(it)
        assert batch["gt"].shape == (2, 48, 48, 3)
        assert batch["lq"].shape == (2, 48, 48, 3)
        assert -1.001 <= batch["gt"].min() and batch["gt"].max() <= 1.001
        assert 0 <= batch["lq"].min() and batch["lq"].max() <= 1
        assert batch["prompt"] == ["a photo", "a photo"]
    it.close()


def test_codeformer_native_crops_equal_the_python_path(tmp_path):
    """PNGs whose short side is the crop size (no resize): the native
    loader's centre crops are the Python path's, image for image, and a
    native stream repeats from its seed (the port reseeds the draws)."""
    rng = np.random.default_rng(4)
    paths = []
    for i, (h, w) in enumerate([(40, 32), (32, 56), (32, 32), (45, 32)]):
        p = tmp_path / f"c{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    flist = tmp_path / "list.txt"
    flist.write_text("\n".join(paths))
    ds = codeformer(flist, 32)
    ld = NativeImageLoader(paths, 2, 32, crop="center", hflip=False, rot90=False, seed=9)
    for _ in range(4):
        imgs, idx = ld.next_with_idx()
        for img, j in zip(imgs, idx):
            np.testing.assert_array_equal(img, ds._load_gt(paths[int(j)]))
    ld.close()
    a = [next(it) for it in [ds.as_iterator(2, seed=3, native=True)] for _ in range(2)]
    b = [next(it) for it in [codeformer(flist, 32).as_iterator(2, seed=3, native=True)]
         for _ in range(2)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["lq"], y["lq"])


def test_realesrgan_native_iterator(image_dir, tmp_path):
    flist = tmp_path / "list2.txt"
    flist.write_text("\n".join(f"{p}\ta photo" for p in image_dir))
    ds = RealESRGANDataset(file_list=str(flist), out_size=48, crop_type="random",
                           use_hflip=True, use_rot=False, p_empty_prompt=0.0)
    it = ds.as_iterator(2, seed=3, native=True)
    batch = next(it)
    assert batch["hq"].shape == (2, 48, 48, 3)
    assert 0.0 <= batch["hq"].min() and batch["hq"].max() <= 1.0
    for k in ("kernel1", "kernel2", "sinc_kernel"):
        assert batch[k].shape == (2, 21, 21)
    assert batch["txt"] == ["a photo", "a photo"]
    it.close()


def test_native_needs_a_crop(image_dir, tmp_path):
    flist = tmp_path / "list3.txt"
    flist.write_text("\n".join(image_dir))
    with pytest.raises(ValueError, match="crop_type"):
        next(codeformer(flist, 48, crop_type="none").as_iterator(2, native=True))


def test_unreadable_file_yields_zeros(tmp_path):
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"not an image")
    ld = NativeImageLoader([str(bad)], batch_size=1, out_size=32, crop="center", hflip=False,
                           seed=1)
    b = ld.next()
    assert b.shape == (1, 32, 32, 3) and b.sum() == 0
    ld.close()
