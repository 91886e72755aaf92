"""RetinaFace (ResNet-50 backbone) face detector.

Counterpart of ``diffbir_tpu/models/retinaface.py``: torchvision ResNet-50
C3/C4/C5 features -> a 3-level FPN (256 channels) -> SSH context modules ->
1x1 class, box and landmark heads with 2 anchors per location; then anchors,
box and landmark decoding and a greedy NMS as tensor functions on the
network's device.

Attribute names are facexlib's ``detection_Resnet50_Final.pth`` keys
(``body.layer2.0.conv1.weight``, ``ssh1.conv5X5_1.1.running_var``, ...), so
the published checkpoint loads with ``load_state_dict(strict=True)``; the
frozen BatchNorm takes the file's ``num_batches_tracked`` where it has one
and never reads it. The network runs NCHW in fp32; the detector takes HWC
BGR uint8 images, as facexlib's does.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """Inference BatchNorm: y = x * inv + (bias - mean * inv), inv =
    rsqrt(var + eps) * weight (the JAX ``FrozenBN``'s order)."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # torch BatchNorm's counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(c_in: int, c_out: int, kernel: int, stride: int = 1, padding=None,
          bias: bool = True, device=None) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2 if padding is None else padding,
                     bias=bias, device=device)


class ConvBN(nn.Sequential):
    """facexlib's conv_bn / conv_bn1X1 / conv_bn_no_relu: conv (no bias) "0",
    BatchNorm "1", then ReLU unless ``relu`` is False (the SSH and FPN
    slopes are 0 at 256 channels)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, device=None):
        super().__init__(_conv(c_in, c_out, kernel, stride, bias=False, device=device),
                         FrozenBN(c_out, device=device))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """torchvision's ResNet Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 x4."""

    def __init__(self, c_in: int, planes: int, stride: int = 1, downsample: bool = False,
                 device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.conv1 = _conv(c_in, planes, 1, padding=0, **kw)
        self.bn1 = FrozenBN(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, stride, **kw)
        self.bn2 = FrozenBN(planes, device=device)
        self.conv3 = _conv(planes, planes * 4, 1, padding=0, **kw)
        self.bn3 = FrozenBN(planes * 4, device=device)
        self.downsample = nn.Sequential(
            _conv(c_in, planes * 4, 1, stride, padding=0, **kw),
            FrozenBN(planes * 4, device=device)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet50Body(nn.Module):
    """torchvision's resnet50 through layer4; returns C3, C4, C5 (NCHW)."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, padding=3, bias=False, device=device)
        self.bn1 = FrozenBN(64, device=device)
        c_in = 64
        for li, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)], start=1):
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(c_in, planes, stride if bi == 0 else 1, bi == 0, device))
                c_in = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        h = self.layer1(h)
        c3 = self.layer2(h)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class SSH(nn.Module):
    """Context module: 3x3 + 5x5 (two 3x3) + 7x7 (three 3x3) branches,
    concatenated, ReLU."""

    def __init__(self, c_in: int, out: int = 256, device=None):
        super().__init__()
        self.conv3X3 = ConvBN(c_in, out // 2, relu=False, device=device)
        self.conv5X5_1 = ConvBN(c_in, out // 4, device=device)
        self.conv5X5_2 = ConvBN(out // 4, out // 4, relu=False, device=device)
        self.conv7X7_2 = ConvBN(out // 4, out // 4, device=device)
        self.conv7x7_3 = ConvBN(out // 4, out // 4, relu=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], dim=1))


class FPN(nn.Module):
    def __init__(self, out: int = 256, device=None):
        super().__init__()
        self.output1 = ConvBN(512, out, 1, device=device)
        self.output2 = ConvBN(1024, out, 1, device=device)
        self.output3 = ConvBN(2048, out, 1, device=device)
        self.merge1 = ConvBN(out, out, device=device)
        self.merge2 = ConvBN(out, out, device=device)

    def forward(self, feats):
        c3, c4, c5 = feats
        o1, o2, o3 = self.output1(c3), self.output2(c4), self.output3(c5)
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest"))
        return o1, o2, o3


class _Head(nn.Module):
    """1x1 conv head; output [B, anchors over (row, col, anchor), per]."""

    def __init__(self, c_in: int, per: int, anchors: int = 2, device=None):
        super().__init__()
        self.per = per
        self.conv1x1 = _conv(c_in, anchors * per, 1, padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1x1(x).permute(0, 2, 3, 1)
        return h.reshape(h.shape[0], -1, self.per)


class RetinaFace(nn.Module):
    """BGR-mean-subtracted NHWC fp32 -> (loc [B, A, 4], conf logits
    [B, A, 2], landms [B, A, 10])."""

    def __init__(self, out_channels: int = 256, device=None):
        super().__init__()
        self.body = ResNet50Body(device)
        self.fpn = FPN(out_channels, device)
        for i in (1, 2, 3):
            setattr(self, f"ssh{i}", SSH(out_channels, out_channels, device))
        self.BboxHead = nn.ModuleList(_Head(out_channels, 4, device=device) for _ in range(3))
        self.ClassHead = nn.ModuleList(_Head(out_channels, 2, device=device) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(
            _Head(out_channels, 10, device=device) for _ in range(3))

    def forward(self, x: torch.Tensor):
        f1, f2, f3 = self.fpn(self.body(x.permute(0, 3, 1, 2)))
        feats = [self.ssh1(f1), self.ssh2(f2), self.ssh3(f3)]
        return tuple(torch.cat([head(f) for head, f in zip(heads, feats)], dim=1)
                     for heads in (self.BboxHead, self.ClassHead, self.LandmarkHead))


# --------------------------------------------------------------------------- #
# anchors, decoding, NMS: tensor functions on the network's device
# --------------------------------------------------------------------------- #
MIN_SIZES = [[16, 32], [64, 128], [256, 512]]
STEPS = [8, 16, 32]
VARIANCE = (0.1, 0.2)


def prior_boxes(h: int, w: int, device=None) -> torch.Tensor:
    """Anchor centres and sizes normalised to [0, 1], fp32 [A, 4], in the
    heads' (level, row, col, anchor) order."""
    out = []
    for k, step in enumerate(STEPS):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        sizes = torch.tensor([[ms / w, ms / h] for ms in MIN_SIZES[k]], dtype=torch.float64)
        cy = (torch.arange(fh, dtype=torch.float64) + 0.5) * step / h
        cx = (torch.arange(fw, dtype=torch.float64) + 0.5) * step / w
        grid = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1)  # [fh, fw, (cy, cx)]
        centres = grid.flip(-1)[:, :, None, :].expand(fh, fw, len(sizes), 2)
        wh = sizes[None, None].expand(fh, fw, len(sizes), 2)
        out.append(torch.cat([centres, wh], -1).reshape(-1, 4))
    return torch.cat(out).to(device=device, dtype=torch.float32)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Box corners [A, 4] (x1, y1, x2, y2), fp32 in the JAX order of ops."""
    centre = priors[:, :2] + loc[:, :2] * VARIANCE[0] * priors[:, 2:]
    size = priors[:, 2:] * torch.exp(loc[:, 2:] * VARIANCE[1])
    x1y1 = centre - size / 2
    return torch.cat([x1y1, size + x1y1], dim=1)


def decode_landms(pre: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Five (x, y) landmarks [A, 10]."""
    return torch.cat([priors[:, :2] + pre[:, 2 * i:2 * i + 2] * VARIANCE[0] * priors[:, 2:]
                      for i in range(5)], dim=1)


def nms(dets: torch.Tensor, thresh: float) -> List[int]:
    """Greedy NMS over [N, 5] (x1, y1, x2, y2, score) with facexlib's +1
    areas: the indices kept, highest score first. The overlaps are one
    [N, N] product on the device; the greedy pass, sequential by nature,
    reads them on the host."""
    x1, y1, x2, y2, scores = dets.unbind(1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = torch.argsort(scores, descending=True, stable=True)
    x1, y1, x2, y2, areas = (t[order] for t in (x1, y1, x2, y2, areas))
    w = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None]) + 1)
    h = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None]) + 1)
    inter = w.clamp(min=0.0) * h.clamp(min=0.0)
    suppress = (inter / (areas[:, None] + areas[None] - inter) > thresh).cpu().numpy()
    order = order.cpu().tolist()
    alive = np.ones(len(order), bool)
    keep = []
    for i in range(len(order)):
        if alive[i]:
            keep.append(order[i])
            alive[i + 1:] &= ~suppress[i, i + 1:]
    return keep


class RetinaFaceDetector:
    """``detect_faces(img_bgr, conf_threshold)`` -> fp32 [N, 15] on the
    network's device: x1, y1, x2, y2, score, then 5 (x, y) landmarks (the
    facexlib layout). The image (uint8 HWC BGR, numpy or tensor) is padded
    at the bottom and right to multiples of 32 before the BGR mean is
    subtracted, so the pad pixels are -mean, as in JAX."""

    RGB_MEAN_BGR = (104.0, 117.0, 123.0)

    def __init__(self, model: RetinaFace, nms_threshold: float = 0.4):
        self.model = model.eval()
        self.nms_threshold = nms_threshold

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def detect_faces(self, img_bgr, conf_threshold: float = 0.8) -> torch.Tensor:
        img = torch.as_tensor(np.ascontiguousarray(img_bgr), device=self.device).float()
        h, w = img.shape[:2]
        ph, pw = (-h) % 32, (-w) % 32
        img = F.pad(img, (0, 0, 0, pw, 0, ph))
        img = img - torch.tensor(self.RGB_MEAN_BGR, device=self.device)
        loc, conf, landms = (t[0] for t in self.model(img[None]))
        scores = torch.softmax(conf, dim=-1)[:, 1]
        priors = prior_boxes(h + ph, w + pw, self.device)
        scale = torch.tensor([w + pw, h + ph], dtype=torch.float32, device=self.device)
        boxes = decode_boxes(loc, priors) * scale.repeat(2)
        lms = decode_landms(landms, priors) * scale.repeat(5)
        keep = scores > conf_threshold
        boxes, lms, scores = boxes[keep], lms[keep], scores[keep]
        if scores.numel() == 0:
            return torch.zeros((0, 15), device=self.device)
        order = torch.argsort(scores, descending=True, stable=True)[:5000]
        dets = torch.cat([boxes[order], scores[order, None]], dim=1)
        kept = torch.as_tensor(nms(dets, self.nms_threshold), device=self.device)
        return torch.cat([dets[kept], lms[order][kept]], dim=1)

