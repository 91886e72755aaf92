"""The port's face stack on the CPU against the JAX package and OpenCV.

- RetinaFace (``models/retinaface.py``) on the JAX network's seeded params
  (BatchNorm statistics perturbed, the heads scaled by 1/20 so that scores
  and boxes fall in a detector's range) at 64x64 and 96x64: loc, conf and landms
  within 1e-4 x max|ref|; ``prior_boxes``, ``decode_boxes``,
  ``decode_landms`` and ``nms`` against the JAX numpy functions (anchors
  exact, decodes 1e-6 relative, the same kept indices); ``detect_faces``
  against the JAX ``RetinaFaceDetector`` on a 90x50 image (the same faces,
  boxes and landmarks within 1e-3 pixels, scores 1e-5);
- ParseNet (``models/parsenet.py``) at ``TINY_PARSE``: logits and image
  within 1e-4 x max|ref|, the class map equal where the top-2 logit margin
  is above 1e-3;
- facexlib-layout torch files (``num_batches_tracked`` included) load with
  ``load_state_dict(strict=True)``, and a missing key raises naming the
  file; the JAX trees convert by ``flax_to_state_dict``;
- each ``utils/warp.py`` function against cv2 on seeded inputs: uint8
  warps and resizes within 1 level (the Lanczos and bilinear resizes bit
  for bit), fp32 warps within 1e-4 x max|ref| (bit-equal but in the last
  width mod 16 columns of a row, which OpenCV sums in another order),
  fp32 resizes and Gaussian blurs within 1e-5 x max|ref| (fp32 sums in
  another order), erosion exact, the LMEDS similarity
  within 1e-6 x max|M| on noisy landmarks and with one outlier (same
  inliers), the inverse exact;
- ``FaceRestoreHelper`` end to end against the JAX helper at upscale 1 and
  2, with and without the parser: affines 1e-6 x max, crops within 1 level,
  the merged image within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from diffbir_tpu.models import retinaface as jrf  # noqa: E402
from diffbir_tpu.models.parsenet import FaceParser as JaxFaceParser  # noqa: E402
from diffbir_tpu.models.parsenet import ParseNet as JaxParseNet  # noqa: E402
from diffbir_tpu.utils import face as jface  # noqa: E402

from diffbir_tpu_torch.models import retinaface as rf  # noqa: E402
from diffbir_tpu_torch.models.parsenet import FaceParser, ParseNet  # noqa: E402
from diffbir_tpu_torch.utils import face, warp  # noqa: E402
from diffbir_tpu_torch.weights.convert import flax_to_state_dict, load_facexlib  # noqa: E402

TINY_PARSE = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16, res_depth=2,
                  ch_range=(16, 64))


def seeded_tree(shapes, seed):
    """numpy params of a flax shape tree: kernels N(0, 1/fan_in), BatchNorm
    scale 1 + 0.1 N and var 1 + 0.1 |N|, biases and means 0.1 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "running_var":
            return (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_port(module, tree):
    sd = flax_to_state_dict(tree, {k: tuple(v.shape) for k, v in module.state_dict().items()})
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def retina():
    model = jrf.RetinaFace()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tree = seeded_tree(shapes, 0)
    for name, head in tree["params"].items():  # scores and boxes in a detector's range
        if "Head" in name:
            head["conv1x1"] = {k: v / 20 for k, v in head["conv1x1"].items()}
    jdet = jrf.RetinaFaceDetector(jax.tree_util.tree_map(jnp.asarray, tree))
    return jdet, to_port(rf.RetinaFace(), tree["params"]), tree


@pytest.fixture(scope="module")
def parse_pair():
    model = JaxParseNet(**TINY_PARSE)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tree = seeded_tree(shapes, 1)
    jparser = JaxFaceParser(jax.tree_util.tree_map(jnp.asarray, tree), model=model)
    return jparser, to_port(ParseNet(**TINY_PARSE), tree["params"]), tree


def close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, tol * np.abs(ref).max())


# --------------------------------------------------------------------------- #
# RetinaFace
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_retinaface_matches_jax(retina, hw):
    jdet, model, _ = retina
    x = np.random.default_rng(hw[0]).uniform(-120, 130, (1, *hw, 3)).astype(np.float32)
    ref = jdet._fwd(jdet.params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for o, r in zip(out, ref):
        close(o.numpy(), np.asarray(r), 1e-4)
    assert out[0].shape[1] == rf.prior_boxes(*hw).shape[0]


def test_anchors_decodes_and_nms_match_jax():
    for h, w in [(64, 64), (96, 64), (160, 128)]:
        np.testing.assert_array_equal(rf.prior_boxes(h, w).numpy(), jrf.prior_boxes(h, w))
    rng = np.random.default_rng(0)
    priors = jrf.prior_boxes(96, 64)
    loc = rng.normal(0, 1, (len(priors), 4)).astype(np.float32)
    pre = rng.normal(0, 1, (len(priors), 10)).astype(np.float32)
    tp = torch.from_numpy(priors)
    close(rf.decode_boxes(torch.from_numpy(loc), tp).numpy(), jrf.decode_boxes(loc, priors), 1e-6)
    close(rf.decode_landms(torch.from_numpy(pre), tp).numpy(), jrf.decode_landms(pre, priors),
          1e-6)
    for n in (3, 40, 300):
        xy = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(5, 60, (n, 2))
        dets = np.concatenate([xy, xy + wh, rng.random((n, 1))], 1).astype(np.float32)
        assert rf.nms(torch.from_numpy(dets), 0.4) == jrf.nms(dets, 0.4)
    dets = np.array([[0, 0, 10, 10, 0.9], [1, 1, 11, 11, 0.8], [50, 50, 60, 60, 0.7]],
                    np.float32)
    assert rf.nms(torch.from_numpy(dets), 0.4) == [0, 2]


def test_detect_faces_matches_jax(retina):
    jdet, model, _ = retina
    img = (np.random.default_rng(3).random((90, 50, 3)) * 255).astype(np.uint8)
    for thr in (0.5, 0.9):
        ref = jdet.detect_faces(img, thr)
        out = rf.RetinaFaceDetector(model).detect_faces(img, thr).numpy()
        assert out.shape == ref.shape and out.shape[1] == 15
        np.testing.assert_allclose(out[:, 4], ref[:, 4], atol=1e-5)
        np.testing.assert_allclose(out[:, :4], ref[:, :4], atol=1e-3)
        np.testing.assert_allclose(out[:, 5:], ref[:, 5:], atol=1e-3)
    assert len(jdet.detect_faces(img, 0.5)) > 1


# --------------------------------------------------------------------------- #
# ParseNet
# --------------------------------------------------------------------------- #
def test_parsenet_matches_jax(parse_pair):
    jparser, model, _ = parse_pair
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jparser.model.apply)(jparser.params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for o, r in zip(out, ref):
        close(o.numpy(), np.asarray(r), 1e-4)
    face01 = np.random.default_rng(5).random((64, 64, 3)).astype(np.float32)
    classes = FaceParser(model).parse(face01)
    ref_cls = jparser.parse(face01)
    assert classes.dtype == torch.int32 and classes.shape == (64, 64)
    logits = np.sort(np.asarray(jparser._fwd(jparser.params, jnp.asarray(face01)[None] * 2 - 1)
                                )[0], axis=-1)
    clear = logits[..., -1] - logits[..., -2] > 1e-3
    np.testing.assert_array_equal(classes.numpy()[clear], ref_cls[clear])


# --------------------------------------------------------------------------- #
# facexlib files
# --------------------------------------------------------------------------- #
def facexlib_file(path, module):
    """The module's state dict as facexlib's files hold it: ``module.``
    prefixes and every BatchNorm's ``num_batches_tracked``."""
    sd = {}
    for k, v in module.state_dict().items():
        sd["module." + k] = v.clone()
        if k.endswith("running_var"):
            sd["module." + k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("name", ["retinaface", "parsenet"])
def test_facexlib_files_load_strictly(retina, parse_pair, tmp_path, name):
    src = retina[1] if name == "retinaface" else parse_pair[1]
    path = str(tmp_path / f"{name}.pth")
    sd = facexlib_file(path, src)
    dst = load_facexlib(rf.RetinaFace() if name == "retinaface" else ParseNet(**TINY_PARSE),
                        path)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    sd.pop(next(k for k in sd if k.endswith("running_mean")))
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match=f"{name}.pth"):
        load_facexlib(rf.RetinaFace() if name == "retinaface" else ParseNet(**TINY_PARSE), path)


def test_missing_detector_weights_name_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFBIR_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="detection_Resnet50_Final.pth"):
        face.load_detector("cpu")
    assert face.load_parser("cpu") is None


# --------------------------------------------------------------------------- #
# warp.py against OpenCV
# --------------------------------------------------------------------------- #
T = face.FFHQ_TEMPLATE_512


def landmarks(rng, noise, outlier):
    a, s = rng.uniform(-0.6, 0.6), rng.uniform(0.3, 3.0)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) / s
    lm = ((T - 256) @ rot.T + rng.uniform(50, 400, 2)).astype(np.float32)
    lm += rng.normal(0, noise, lm.shape).astype(np.float32)
    if outlier:
        lm[outlier - 1] += rng.uniform(30, 80, 2).astype(np.float32)
    return lm


@pytest.mark.parametrize("outlier", [0, 1, 4])
def test_similarity_lmeds_matches_cv2(outlier):
    """Noisy landmarks (0.5 px), with the outlier-th one moved 30-80 px."""
    rng = np.random.default_rng(outlier)
    for _ in range(20):
        lm = landmarks(rng, 0.5, outlier)
        ref, inl = cv2.estimateAffinePartial2D(lm, T, method=cv2.LMEDS)
        out = warp.similarity_lmeds(torch.from_numpy(lm), torch.from_numpy(T)).numpy()
        assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
        assert not outlier or not inl[outlier - 1]
        np.testing.assert_array_equal(warp.invert_affine(torch.from_numpy(ref)).numpy(),
                                      cv2.invertAffineTransform(ref))


@pytest.mark.parametrize("border,cv_border", [("constant", cv2.BORDER_CONSTANT),
                                              ("reflect", cv2.BORDER_REFLECT),
                                              ("reflect101", cv2.BORDER_REFLECT101)])
@pytest.mark.parametrize("dsize", [(512, 512), (300, 211)])
def test_warp_affine_matches_cv2(border, cv_border, dsize):
    rng = np.random.default_rng(dsize[1])
    img = rng.integers(0, 256, (240, 330, 3), dtype=np.uint8)
    for _ in range(3):
        m = cv2.estimateAffinePartial2D(landmarks(rng, 0.0, 0), T, method=cv2.LMEDS)[0]
        m[:, 2] += rng.uniform(-80, 80, 2) + dsize[0] / 2 - 256
        ref = cv2.warpAffine(img, m, dsize, borderMode=cv_border, borderValue=(135, 133, 132))
        out = warp.warp_affine(torch.from_numpy(img), torch.from_numpy(m), dsize, border,
                               (135, 133, 132)).numpy()
        assert np.abs(out.astype(int) - ref).max() <= 1
        f = img[..., 1].astype(np.float32) / 3
        for flags in (cv2.INTER_LINEAR, 3):
            ref = cv2.warpAffine(f, m, dsize, flags=flags, borderMode=cv_border)
            out = warp.warp_affine(torch.from_numpy(f), torch.from_numpy(m), dsize, border)
            close(out.numpy(), ref, 1e-4)


@pytest.mark.parametrize("hw,dsize,f", [((37, 29), None, 512 / 29), ((300, 400), None, 640 / 300),
                                        ((64, 64), (512, 512), None), ((50, 70), (71, 333), None)])
def test_resizes_match_cv2(hw, dsize, f):
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    if dsize is None:
        ref = cv2.resize(img, (0, 0), fx=f, fy=f, interpolation=cv2.INTER_LINEAR)
        out = warp.resize_linear(torch.from_numpy(img), fx=f, fy=f).numpy()
        np.testing.assert_array_equal(out, ref)
        return
    for interp, fn in ((cv2.INTER_LINEAR, warp.resize_linear),
                       (cv2.INTER_LANCZOS4, warp.resize_lanczos4)):
        ref = cv2.resize(img, dsize, interpolation=interp)
        np.testing.assert_array_equal(fn(torch.from_numpy(img), dsize).numpy(), ref)
        np.testing.assert_array_equal(fn(torch.from_numpy(img), hw[::-1]).numpy(), img)
    mask = rng.random(hw).astype(np.float32)
    close(warp.resize_linear(torch.from_numpy(mask), dsize).numpy(), cv2.resize(mask, dsize),
          1e-5)


def test_erode_and_gaussian_blur_match_cv2():
    rng = np.random.default_rng(0)
    m = np.zeros((300, 320), np.float32)
    m[20:250, 30:300] = 1
    m[5:9, 0:40] = rng.random((4, 40))
    for k in (1, 2, 4, 9):
        np.testing.assert_array_equal(warp.erode(torch.from_numpy(m), k).numpy(),
                                      cv2.erode(m, np.ones((k, k), np.uint8)))
    for k, sigma in ((1, 0), (3, 0), (7, 0), (9, 0), (11, 0), (25, 0), (101, 11)):
        img = (rng.random((260, 270)) * 255).astype(np.float32)
        got = warp.gaussian_blur(torch.from_numpy(img)[None, :, :, None], k, sigma)
        close(got[0, :, :, 0].numpy(), cv2.GaussianBlur(img, (k, k), sigma), 1e-5)
        np.testing.assert_allclose(warp.gaussian_kernel(k, sigma),
                                   cv2.getGaussianKernel(k, sigma).ravel(), rtol=1e-6)


# --------------------------------------------------------------------------- #
# FaceRestoreHelper against the JAX helper
# --------------------------------------------------------------------------- #
def two_faces(img):
    """Landmarks of two faces placed by the image's size (one tilted)."""
    h, w = img.shape[:2]
    out = []
    for cx, cy, a, s in ((0.32 * w, 0.4 * h, 0.15, 0.5), (0.7 * w, 0.62 * h, -0.3, 0.35)):
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * s
        out.append((T - 256) @ rot.T + [cx, cy])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("upscale", [1, 2])
@pytest.mark.parametrize("parsed", [False, True])
def test_face_helper_matches_jax(parse_pair, upscale, parsed):
    jparser, model, _ = parse_pair
    rng = np.random.default_rng(upscale)
    base = np.linspace(0, 1, 300 * 380).reshape(300, 380, 1) * [200, 120, 60]
    img = (base + rng.integers(0, 50, (300, 380, 3))).astype(np.uint8)
    kw = dict(upscale_factor=upscale, face_size=512, landmarks_fn=two_faces)
    ref = jface.FaceRestoreHelper(**kw, face_parser=jparser if parsed else None)
    out = face.FaceRestoreHelper(**kw, face_parser=FaceParser(model) if parsed else None)
    for h in (ref, out):
        h.read_image(img)
        assert h.get_face_landmarks_5(resize=640) == 2
        h.align_warp_face()
    np.testing.assert_array_equal(out.input_img, ref.input_img)
    for a, b in zip(out.affine_matrices, ref.affine_matrices):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    for a, b in zip(out.cropped_faces, ref.cropped_faces):
        assert np.abs(a.astype(int) - b).max() <= 1
    for h in (ref, out):
        for crop in ref.cropped_faces:
            h.add_restored_face(255 - crop)
        h.get_inverse_affine()
    for a, b in zip(out.inverse_affine_matrices, ref.inverse_affine_matrices):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    bg = rng.integers(0, 256, (200, 250, 3), dtype=np.uint8)
    merged, merged_ref = out.paste_faces_to_input_image(bg), ref.paste_faces_to_input_image(bg)
    h, w = ref.input_img.shape[:2]
    assert merged.shape == merged_ref.shape == (h * upscale, w * upscale, 3)
    assert np.abs(merged.astype(int) - merged_ref).max() <= 1
    assert np.abs(merged.astype(int) - warp.resize_lanczos4(
        torch.from_numpy(bg), merged.shape[1::-1]).numpy()).max() > 100  # faces pasted
