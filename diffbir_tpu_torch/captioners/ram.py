"""RAM++ (Recognize Anything Plus) image tagger, the ``--captioner ram`` prompt.

Counterpart of ``diffbir_tpu/captioners/ram.py``:

- ``RAMPlus``: swin-L tokens -> ``image_proj`` (512) -> the mean token,
  L2-normalised, against the CLIP label embeddings (51 descriptors a class)
  -> a softmax over each class's descriptors reweights them -> ``wordvec_proj``
  and ReLU -> the 2-layer tagging head cross-attending to the image
  embeddings -> ``fc`` -> one logit a class. The dtypes are JAX's:
  ``label_embed`` and ``reweight_scale`` are fp32, so the similarity product
  runs in fp32 on the promoted mean token, and ``fc`` runs in fp32 on an fp32
  cast; the rest runs in the model's dtype.
- ``RAMCaptioner``: an HWC uint8 RGB array (the port's image; JAX takes a PIL
  image) resized to 384x384 by Pillow's BILINEAR filter bit for bit
  (``utils.common.pil_resize``), /255, ImageNet mean and std; a tag is kept
  where its sigmoid exceeds its class threshold, and the tags are joined with
  ", ".

Files (nothing is downloaded; a missing one raises FileNotFoundError naming
it and its public source): the checkpoint ``ram_plus_swin_large_14m.pth``
from ``$DIFFBIR_TPU_RAM_CKPT`` (or the ``ckpt_path`` argument), and the tag
lists ``ram_tag_list.txt`` and ``ram_tag_list_threshold.txt`` from
``$DIFFBIR_TPU_RAM_DATA``, else ``./weights/ram_data`` (the JAX package also
tries the mounted reference's folder; the port does not). The checkpoint
loads non-strictly (``weights.convert.load_partial``, JAX's
``fill_flax_params(strict=False)``): a key of the model that the file lacks
is zero, and their count is printed.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.layers import dense
from ..utils.common import pil_resize
from .bert_tagging import TaggingHead
from .swin_cls import SwinClassifier

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CKPT_NAME = "ram_plus_swin_large_14m.pth"
CKPT_SOURCE = "https://huggingface.co/xinyu1205/recognize-anything-plus-model"
TAG_FILES = ("ram_tag_list.txt", "ram_tag_list_threshold.txt")
TAG_SOURCE = "https://github.com/xinyu1205/recognize-anything (ram/data)"


def tag_list_dir(data_dir: Optional[str] = None) -> str:
    """The folder of the tag lists: ``data_dir``, else
    ``$DIFFBIR_TPU_RAM_DATA``, else ``./weights/ram_data``; a missing file
    raises FileNotFoundError naming it and its source."""
    d = data_dir or os.environ.get("DIFFBIR_TPU_RAM_DATA") or os.path.join(
        os.getcwd(), "weights", "ram_data")
    for name in TAG_FILES:
        path = os.path.join(d, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"RAM++ tag list {path} not found (nothing is downloaded): fetch {name} from "
                f"{TAG_SOURCE}, or set DIFFBIR_TPU_RAM_DATA to the folder that holds "
                f"{' and '.join(TAG_FILES)}")
    return d


def checkpoint_path(ckpt_path: Optional[str] = None) -> str:
    """``ckpt_path``, else ``$DIFFBIR_TPU_RAM_CKPT``; unset or missing raises
    FileNotFoundError naming the file and its source."""
    path = ckpt_path or os.environ.get("DIFFBIR_TPU_RAM_CKPT", "")
    if not path or not os.path.isfile(path):
        where = f"{path} not found" if path else "DIFFBIR_TPU_RAM_CKPT is not set"
        raise FileNotFoundError(
            f"RAM++ checkpoint {CKPT_NAME}: {where} (nothing is downloaded): fetch it from "
            f"{CKPT_SOURCE} and set DIFFBIR_TPU_RAM_CKPT to its path")
    return path


def read_tag_lists(data_dir: str):
    """(tags as a numpy str array, fp32 thresholds) from the two files."""
    with open(os.path.join(data_dir, TAG_FILES[0]), encoding="utf-8") as f:
        tags = np.array([line.strip() for line in f if line.strip()])
    with open(os.path.join(data_dir, TAG_FILES[1])) as f:
        thresholds = np.array([float(s.strip()) for s in f if s.strip()], np.float32)
    if len(thresholds) != len(tags):
        raise ValueError(f"{data_dir}: the tag list ({len(tags)}) and the threshold file "
                         f"({len(thresholds)}) differ in length: mismatched data files")
    return tags, thresholds


class RAMPlus(nn.Module):
    """[B, 384, 384, 3] ImageNet-normalised NHWC -> fp32 logits [B, num_class]."""

    def __init__(self, num_class: int = 4585, des_per_class: int = 51,
                 vision_width: int = 1536, embed_dim: int = 512, hidden: int = 768,
                 swin_embed_dim: int = 192, swin_depths: Sequence[int] = (2, 2, 18, 2),
                 swin_heads: Sequence[int] = (6, 12, 24, 48), swin_window: int = 12,
                 tagging_heads: int = 4, tagging_layers: int = 2,
                 tagging_intermediate: int = 3072, dtype=torch.float32, device=None):
        super().__init__()
        self.num_class, self.des_per_class = num_class, des_per_class
        kw = dict(dtype=dtype, device=device)
        self.visual_encoder = SwinClassifier(embed_dim=swin_embed_dim, depths=swin_depths,
                                             num_heads=swin_heads, window_size=swin_window,
                                             **kw)
        # vision_width (1536 for swin-L) is what the encoder ends with; the
        # shapes come from the encoder, as in JAX
        self.image_proj = dense(self.visual_encoder.num_features, embed_dim, **kw)
        self.label_embed = nn.Parameter(torch.zeros(num_class * des_per_class, embed_dim,
                                                    device=device))
        self.reweight_scale = nn.Parameter(torch.full((), float(np.log(1 / 0.07)),
                                                      device=device))
        self.wordvec_proj = dense(embed_dim, hidden, **kw)
        self.tagging_head = TaggingHead(hidden, tagging_heads, tagging_layers,
                                        tagging_intermediate, embed_dim, **kw)
        self.fc = dense(hidden, 1, dtype=torch.float32, device=device)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        embeds = self.image_proj(self.visual_encoder(image))
        cls = embeds[:, 0, :]
        cls = cls / (torch.linalg.vector_norm(cls, dim=-1, keepdim=True) + 1e-12)
        logits = torch.exp(self.reweight_scale) * (cls.float() @ self.label_embed.T)
        b = cls.shape[0]
        w = logits.reshape(b, self.num_class, self.des_per_class).softmax(dim=2)
        descs = self.label_embed.reshape(self.num_class, self.des_per_class, -1)
        reweighted = torch.einsum("bnd,nde->bne", w, descs)
        queries = torch.relu(self.wordvec_proj(reweighted))
        tag_embed = self.tagging_head(queries, embeds)
        return self.fc(tag_embed.float())[..., 0]


def preprocess(image, size: int = 384) -> np.ndarray:
    """HWC uint8 RGB -> [size, size, 3] fp32: Pillow's BILINEAR resize, /255,
    ImageNet mean and std."""
    img = torch.from_numpy(np.ascontiguousarray(image))
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected an HWC uint8 RGB image, got {tuple(img.shape)} {img.dtype}")
    arr = pil_resize(img, (size, size), "bilinear").numpy()
    return (arr.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def tags_above(tag_list: np.ndarray, thresholds: np.ndarray, logits: np.ndarray) -> List[str]:
    """The tags whose sigmoid exceeds their threshold (JAX's rule, in fp32
    numpy)."""
    probs = 1.0 / (1.0 + np.exp(-logits))
    return [t for t, p, th in zip(tag_list, probs, thresholds) if p > th]


class RAMCaptioner:
    """``--captioner ram``: the image's RAM++ tags joined with ", ". On
    ``device`` (cuda unless the caller asks for the CPU)."""

    def __init__(self, ckpt_path: Optional[str] = None, data_dir: Optional[str] = None,
                 image_size: int = 384, dtype=torch.bfloat16, device="cuda"):
        from ..weights.convert import load_partial, load_torch_state_dict

        data_dir = tag_list_dir(data_dir)
        path = checkpoint_path(ckpt_path)
        self.tag_list, self.thresholds = read_tag_lists(data_dir)
        self.image_size = image_size
        self.device = torch.device(device)
        self.model = RAMPlus(num_class=len(self.tag_list), dtype=dtype,
                             device="meta").to_empty(device=self.device)
        missing = load_partial(self.model, load_torch_state_dict(path), path)
        if missing:
            print(f"RAM: {missing} params missing from checkpoint")
        self.model.eval()

    @torch.no_grad()
    def logits(self, image) -> np.ndarray:
        arr = preprocess(image, self.image_size)
        x = torch.from_numpy(arr[None]).to(self.device)
        return self.model(x)[0].float().cpu().numpy()

    def tags(self, image) -> List[str]:
        return tags_above(self.tag_list, self.thresholds, self.logits(image))

    def __call__(self, image) -> str:
        return ", ".join(self.tags(image))
