"""Face alignment helper: detect -> align -> (restore) -> paste back.

Counterpart of ``diffbir_tpu/utils/face.py`` (``FaceRestoreHelper``): the
five-landmark similarity to the FFHQ template, the reference's eye-distance
filter, the crops, and the paste-back through the inverse affine with the
eroded and blurred box mask, or with the ParseNet mask fused into it. The
helper's surface is numpy uint8 RGB, as in JAX; the work runs in torch on
the helper's device: the OpenCV calls of the JAX helper through
``utils.warp`` (each held against OpenCV on the CPU), the detector and the
parser on their networks' device.

Detectors, in order: a ``landmarks_fn(img_rgb) -> [N, 5, 2]``, then a
``detector`` with ``detect_faces(img_bgr, threshold) -> [N, 15]`` (the
loops hand in the port's RetinaFace, ``load_detector``). The JAX helper
falls back to facexlib; nothing here does (no torch package of face models
sits beside the port): ``load_detector`` raises FileNotFoundError naming
``detection_Resnet50_Final.pth`` and its URL when the file is absent. The
parser is optional: ``load_parser`` returns None without
``parsing_parsenet.pth``, and the paste takes the box mask, as in JAX.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.parsenet import FaceParser, ParseNet
from ..models.retinaface import RetinaFace, RetinaFaceDetector
from ..weights.convert import load_facexlib
from . import warp

# FFHQ 512x512 five-point template (the JAX helper's FFHQ_TEMPLATE_512)
FFHQ_TEMPLATE_512 = np.array(
    [[192.98138, 239.94708], [318.90277, 240.19360], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)

# 19 parsing classes -> kept (255) or dropped (0): background, neck and the
# last four classes are dropped (the JAX helper's MASK_COLORMAP)
MASK_COLORMAP = np.array([0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                          0, 255, 0, 0, 0], np.float32)


def load_detector(device) -> RetinaFaceDetector:
    """The port's RetinaFace from ``retinaface_resnet50`` under the weights
    folder, loaded strictly; FileNotFoundError naming the file and its URL
    when it is absent."""
    from ..inference.pretrained_models import resolve_model

    path = resolve_model("retinaface_resnet50")
    model = RetinaFace(device=device)
    return RetinaFaceDetector(load_facexlib(model, path))


def load_parser(device) -> Optional[FaceParser]:
    """The port's ParseNet from ``parsenet`` under the weights folder, loaded
    strictly, or None when the file is absent (the paste then takes the box
    mask, as in JAX)."""
    from ..inference.pretrained_models import resolve_model

    try:
        path = resolve_model("parsenet")
    except FileNotFoundError:
        return None
    return FaceParser(load_facexlib(ParseNet(device=device), path))


class FaceRestoreHelper:
    def __init__(self, upscale_factor: float = 1.0, face_size: int = 512,
                 eye_dist_threshold: Optional[float] = 5.0,
                 landmarks_fn: Optional[Callable] = None, detector=None, face_parser=None,
                 device="cpu"):
        self.upscale_factor = upscale_factor
        self.face_size = face_size
        self.det_threshold = 0.8  # facexlib's detect_faces default
        self.face_template = FFHQ_TEMPLATE_512 * (face_size / 512.0)
        self.eye_dist_threshold = eye_dist_threshold
        self._landmarks_fn = landmarks_fn
        self._detector = detector
        self.face_parser = face_parser
        self.device = torch.device(device)
        self.input_img: Optional[np.ndarray] = None  # RGB uint8
        self.all_landmarks_5: List[np.ndarray] = []
        self.cropped_faces: List[np.ndarray] = []
        self.restored_faces: List[np.ndarray] = []
        self.affine_matrices: List[np.ndarray] = []
        self.inverse_affine_matrices: List[np.ndarray] = []

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------ #
    def clean_all(self) -> None:
        self.all_landmarks_5, self.cropped_faces = [], []
        self.restored_faces, self.affine_matrices = [], []
        self.inverse_affine_matrices = []

    def read_image(self, img: np.ndarray) -> None:
        """img: uint8 HWC RGB (grey broadcast). An image whose short side is
        below 512 is first enlarged to 512 (bilinear, OpenCV's fixed-point
        resize), before detection and paste-back, as in JAX."""
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        if min(img.shape[:2]) < 512:
            f = 512.0 / min(img.shape[:2])
            img = warp.resize_linear(self._t(img), fx=f, fy=f).cpu().numpy()
        self.input_img = img

    def _detect(self, img_rgb: np.ndarray) -> np.ndarray:
        """[N, 5, 2] landmarks: ``landmarks_fn``, else the detector."""
        if self._landmarks_fn is not None:
            return np.asarray(self._landmarks_fn(img_rgb), np.float32).reshape(-1, 5, 2)
        if self._detector is None:
            raise RuntimeError("no face detector: pass detector= (load_detector) or "
                               "landmarks_fn(img) -> [N, 5, 2] to FaceRestoreHelper")
        bboxes = self._detector.detect_faces(img_rgb[:, :, ::-1].copy(), self.det_threshold)
        return torch.as_tensor(bboxes)[:, 5:15].reshape(-1, 5, 2).cpu().numpy()

    def get_face_landmarks_5(self, resize: Optional[int] = None) -> int:
        """Detect the faces (the image first enlarged so its short side is
        ``resize``, never shrunk) and keep those whose reference eye metric
        passes the threshold; returns the count kept."""
        img = self.input_img
        scale = 1.0
        if resize is not None:
            h, w = img.shape[:2]
            scale = max(1.0, resize / min(h, w))
            if scale != 1.0:
                img = warp.resize_linear(self._t(img), (int(w * scale), int(h * scale))
                                         ).cpu().numpy()
        for lm in self._detect(img):
            lm = lm / scale
            # the reference's metric: norm([lm0.y - lm1.y, lm1.x - lm2.x]),
            # not the true eye distance; kept so that the same faces pass
            eye_dist = np.linalg.norm([lm[0][1] - lm[1][1], lm[1][0] - lm[2][0]])
            if self.eye_dist_threshold is not None and eye_dist < self.eye_dist_threshold:
                continue
            self.all_landmarks_5.append(lm.astype(np.float32))
        return len(self.all_landmarks_5)

    def align_warp_face(self, border_mode: str = "constant") -> None:
        """Each face's similarity to the template (LMEDS) and its crop."""
        img = self._t(self.input_img)
        template = self._t(self.face_template)
        for lm in self.all_landmarks_5:
            affine = warp.similarity_lmeds(self._t(lm), template)
            self.affine_matrices.append(affine.cpu().numpy())
            crop = warp.warp_affine(img, affine, (self.face_size, self.face_size), border_mode,
                                    (135, 133, 132))
            self.cropped_faces.append(crop.cpu().numpy())

    def add_restored_face(self, face: np.ndarray) -> None:
        self.restored_faces.append(face)

    def get_inverse_affine(self) -> None:
        for affine in self.affine_matrices:
            inv = warp.invert_affine(torch.as_tensor(affine)) * self.upscale_factor
            self.inverse_affine_matrices.append(inv.numpy())

    def paste_faces_to_input_image(self, upsample_img: Optional[np.ndarray] = None
                                   ) -> np.ndarray:
        """Paste the restored faces onto ``upsample_img`` (else the input),
        Lanczos-resized to the input x ``upscale_factor``, each through its
        soft mask: the warped box eroded and blurred, or its minimum with
        the parser's mask."""
        h, w = self.input_img.shape[:2]
        h_up, w_up = int(h * self.upscale_factor), int(w * self.upscale_factor)
        base = self.input_img if upsample_img is None else upsample_img
        out = warp.resize_lanczos4(self._t(base), (w_up, h_up)).float()
        ones = torch.ones((self.face_size, self.face_size), device=self.device)
        for face, inv in zip(self.restored_faces, self.inverse_affine_matrices):
            inv = torch.as_tensor(inv, dtype=torch.float64)
            if self.upscale_factor > 1:  # the reference's extra offset
                inv = inv.clone()
                inv[:, 2] += 0.5 * self.upscale_factor
            face_t = self._t(face)
            inv_restored = warp.warp_affine(face_t.float(), inv, (w_up, h_up))
            inv_mask = warp.warp_affine(ones, inv, (w_up, h_up))
            inv_mask_erosion = warp.erode(inv_mask, max(1, int(2 * self.upscale_factor)))
            total_face_area = float(inv_mask_erosion.double().sum())
            w_edge = int(total_face_area ** 0.5) // 20
            inv_mask_center = warp.erode(inv_mask_erosion, max(w_edge * 2, 1))
            soft = warp.gaussian_blur(inv_mask_center[None, :, :, None], w_edge * 2 + 1)[0]
            if self.face_parser is not None:
                soft = self._fuse_parse_mask(face_t, inv, soft, (w_up, h_up))
            out = soft * inv_restored + (1 - soft) * out
        return out.clamp(0, 255).to(torch.uint8).cpu().numpy()

    def _fuse_parse_mask(self, face: torch.Tensor, inv: torch.Tensor, soft: torch.Tensor,
                         size_up) -> torch.Tensor:
        """The parser's mask (blurred twice at 101 taps, sigma 11, a 10-pixel
        frame zeroed) warped back and taken where it is below the box mask."""
        face_512 = warp.resize_linear(face, (512, 512))
        classes = torch.as_tensor(self.face_parser.parse(face_512.float() / 255.0),
                                  device=self.device).long()
        parse_mask = self._t(MASK_COLORMAP)[classes]
        parse_mask = warp.gaussian_blur(parse_mask[None, :, :, None], 101, 11)
        parse_mask = warp.gaussian_blur(parse_mask, 101, 11)[0, :, :, 0]
        thres = 10
        parse_mask[:thres, :] = 0
        parse_mask[-thres:, :] = 0
        parse_mask[:, :thres] = 0
        parse_mask[:, -thres:] = 0
        parse_mask = parse_mask / 255.0
        parse_mask = warp.resize_linear(parse_mask, (self.face_size, self.face_size))
        parse_mask = warp.warp_affine(parse_mask, inv, size_up)[:, :, None]
        fuse = (parse_mask < soft).float()
        return parse_mask * fuse + soft * (1 - fuse)
