"""The pretrained weights the CLI loads, by name.

Counterpart of ``diffbir_tpu/inference/pretrained_models.py``: the same
public checkpoint URLs and the version/task -> model matrix:

- BSR: v1 swinir_general + v1_general | v2 bsrnet + v2 | v2.1 swinir_realesrgan + v2.1
- SD base: v1/v2 -> sd_v2.1; v2.1 -> sd_v2.1_zsnr

A name resolves to the file named as the URL's last part under
``$DIFFBIR_TPU_WEIGHTS``, else ``./weights``. Nothing is downloaded: a
missing file raises FileNotFoundError naming the file and its URL.
"""

from __future__ import annotations

import os

MODELS = {
    # stage-1 cleaners
    "bsrnet": "https://github.com/cszn/KAIR/releases/download/v1.0/BSRNet.pth",
    "swinir_face": "https://huggingface.co/lxq007/DiffBIR/resolve/main/face_swinir_v1.ckpt",
    "scunet_psnr": "https://github.com/cszn/KAIR/releases/download/v1.0/scunet_color_real_psnr.pth",
    "swinir_general": "https://huggingface.co/lxq007/DiffBIR/resolve/main/general_swinir_v1.ckpt",
    "swinir_realesrgan": "https://huggingface.co/lxq007/DiffBIR-v2/resolve/main/realesrgan_s4_swinir_100k.pth",
    # pre-trained stable diffusion
    "sd_v2.1": "https://huggingface.co/stabilityai/stable-diffusion-2-1-base/resolve/main/v2-1_512-ema-pruned.ckpt",
    "sd_v2.1_zsnr": "https://huggingface.co/lxq007/DiffBIR-v2/resolve/main/sd2.1-base-zsnr-laionaes5.ckpt",
    # IRControlNet
    "v1_face": "https://huggingface.co/lxq007/DiffBIR-v2/resolve/main/v1_face.pth",
    "v1_general": "https://huggingface.co/lxq007/DiffBIR-v2/resolve/main/v1_general.pth",
    "v2": "https://huggingface.co/lxq007/DiffBIR-v2/resolve/main/v2.pth",
    "v2.1": "https://huggingface.co/lxq007/DiffBIR-v2/resolve/main/DiffBIR_v2.1.pt",
    # face helper networks
    "retinaface_resnet50": "https://github.com/xinntao/facexlib/releases/download/v0.1.0/detection_Resnet50_Final.pth",
    "parsenet": "https://github.com/xinntao/facexlib/releases/download/v0.2.2/parsing_parsenet.pth",
}


def weights_dir() -> str:
    return os.environ.get("DIFFBIR_TPU_WEIGHTS", os.path.join(os.getcwd(), "weights"))


def resolve_model(name_or_path: str) -> str:
    """A registry name (or a local path) -> the local file's path."""
    if os.path.isfile(name_or_path):
        return name_or_path
    url = MODELS.get(name_or_path, name_or_path)
    path = os.path.join(weights_dir(), os.path.basename(url.split("?")[0]))
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"weights file {path} not found (nothing is downloaded): fetch {url} and place "
            f"it there, or set DIFFBIR_TPU_WEIGHTS to the folder that holds it")
    return path
