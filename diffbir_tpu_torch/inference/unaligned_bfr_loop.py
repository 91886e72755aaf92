"""Unaligned blind face restoration (``--task unaligned_face``): detect ->
restore each face and the background -> paste the faces back.

Counterpart of ``diffbir_tpu/inference/unaligned_bfr_loop.py``: the input
is upscaled by ``--upscale`` (Pillow's bicubic, ``pil_bicubic_resize``), its
faces detected at a short side of 640 and aligned to 512x512 crops
(``utils.face.FaceRestoreHelper``); each crop is a request of the face
pipeline (the face SwinIR), then the background one of the background
pipeline (v1 the general SwinIR, v2.1 the realesrgan SwinIR on the upscaled
image; v2 BSRNet on the original LQ, upscaling inside). Each background
sample is pasted over with the face samples of the same index.

Outputs: ``cropped_faces/<stem>_face<i>.png``,
``restored_faces/<stem>_face<i>_<sample>.png``,
``restored_backgrounds/<stem>_<sample>.png``, and the merged ``<stem>.png``
(``<stem>_<sample>.png`` with ``--n_samples`` > 1) in the output folder; a
``prompt.csv`` row for each restored face and each merged image.

The detector (``retinaface_resnet50``, required) and the parser
(``parsenet``, optional) load once, on the loop's device; ``face_helper``
builds the helper of one image, the one place a caller swaps in a
``landmarks_fn`` or another detector. ``timings`` adds "detect_align"
(resize, detection, alignment and crops) and "paste".
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np

from ..models.bsrnet import RRDBNet
from ..models.swinir import SwinIR
from ..pipeline import BSRNetPipeline, SwinIRPipeline
from ..utils.face import FaceRestoreHelper, load_detector, load_parser
from ..utils.image_io import write_png
from .loop import InferenceLoop


class UnAlignedBFRInferenceLoop(InferenceLoop):
    def load_cleaner(self) -> None:
        self.detector = load_detector(self.device)
        self.face_parser = load_parser(self.device)
        if self.args.version == "v2":
            self.bg_cleaner = self._load_cleaner(RRDBNet, "bsrnet")
        else:
            self.bg_cleaner = self._load_cleaner(
                SwinIR, "swinir_general" if self.args.version == "v1" else "swinir_realesrgan")
        self.face_cleaner = self._load_cleaner(SwinIR, "swinir_face")
        self.cleaner = self.bg_cleaner

    def load_pipeline(self) -> None:
        kw = dict(tokenizer=self._tokenizer(), cond_fn=self.cond_fn)
        face = SwinIRPipeline(self.face_cleaner, self.cldm, self.schedule, self.device, **kw)
        if self.args.version == "v2":
            bg = BSRNetPipeline(self.bg_cleaner, self.cldm, self.schedule, self.device,
                                upscale=self.args.upscale, **kw)
        else:
            bg = SwinIRPipeline(self.bg_cleaner, self.cldm, self.schedule, self.device, **kw)
        self.pipeline_dict = {"face": face, "background": bg}
        self.pipeline = face

    def face_helper(self) -> FaceRestoreHelper:
        """The helper of one image: 512x512 crops, the paste at x1, the
        loop's detector and parser on its device."""
        return FaceRestoreHelper(upscale_factor=1.0, face_size=512, detector=self.detector,
                                 face_parser=self.face_parser, device=self.device)

    def setup(self) -> None:
        super().setup()
        self.cropped_face_dir = os.path.join(self.save_dir, "cropped_faces")
        self.restored_face_dir = os.path.join(self.save_dir, "restored_faces")
        self.restored_bg_dir = os.path.join(self.save_dir, "restored_backgrounds")
        for d in (self.cropped_face_dir, self.restored_face_dir, self.restored_bg_dir):
            os.makedirs(d, exist_ok=True)

    def load_lq(self) -> Iterator[np.ndarray]:
        """Per input image: every aligned face crop, then the background."""
        for lq in super().load_lq():
            stem = self.loop_ctx["file_stem"]
            t0 = time.perf_counter()
            upscaled = self.pre_upscale(lq)
            helper = self.face_helper()
            helper.read_image(upscaled)
            n = helper.get_face_landmarks_5(resize=640)
            helper.align_warp_face()
            self._add("detect_align", time.perf_counter() - t0)
            print(f"[loop] detected {n} faces in {stem}", flush=True)
            self._helper = helper
            # face_samples[face][sample], paired per sample at the paste
            self._face_samples = {}
            for i, face in enumerate(helper.cropped_faces):
                write_png(os.path.join(self.cropped_face_dir, f"{stem}_face{i}.png"), face)
                self.loop_ctx.update(is_face=True, face_idx=i)
                yield face
            self.loop_ctx.update(is_face=False)
            # v2's BSRNetPipeline upscales inside: it takes the original LQ
            yield lq if self.args.version == "v2" else upscaled

    def after_load_lq(self, lq: np.ndarray) -> np.ndarray:
        self.pipeline = self.pipeline_dict["face" if self.loop_ctx["is_face"] else "background"]
        return lq

    def save(self, img: np.ndarray, sample_idx: int) -> None:
        stem = self.loop_ctx["file_stem"]
        if self.loop_ctx["is_face"]:
            idx = self.loop_ctx["face_idx"]
            name = f"{stem}_face{idx}_{sample_idx}.png"
            write_png(os.path.join(self.restored_face_dir, name), img)
            self._face_samples.setdefault(idx, {})[sample_idx] = img
            self.log_prompt(name)
            return
        write_png(os.path.join(self.restored_bg_dir, f"{stem}_{sample_idx}.png"), img)
        t0 = time.perf_counter()
        helper = self._helper
        if not helper.inverse_affine_matrices:
            helper.get_inverse_affine()
        # this background sample with the face samples of the same index
        helper.restored_faces = [self._face_samples[f][sample_idx]
                                 for f in sorted(self._face_samples)]
        merged = helper.paste_faces_to_input_image(img)
        self._add("paste", time.perf_counter() - t0)
        name = self.output_name(sample_idx)
        write_png(os.path.join(self.save_dir, name), merged)
        self.log_prompt(name)
