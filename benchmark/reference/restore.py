"""Plain reference of one served DiffBIR v2.1 restoration, in float32.

What a request to the batching server computes (``BatchingServer.submit``
with the server's defaults): the LQ upscaled by Pillow's bicubic filter, the
SwinIR cleaner clipped to [0, 1], the condition (the VAE posterior mean of
the cleaned image, the CLIP features of both prompts), classifier-free
guidance at a fixed scale, the DPM-Solver++(3M) SDE sampler of k-diffusion
on the v-parameterised zero-terminal-SNR schedule at eta 0 (the server
passes no eta, and the port's default is 0: no noise past the start), the
VAE decode, the wavelet colour fix and the cast to uint8. The start noise is the request batch's
first draw from ``torch.Generator(device).manual_seed(seed)``: the rows of
one [B, h/8, w/8, 4] standard-normal draw, B the batch the server formed.
Written from the DiffBIR and k-diffusion sources; nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .models import ControlLDM, SwinIR

# ------------------------------------------------------------ schedule ---- #


def v21_alphas_cumprod(T: int = 1000, start: float = 0.00085, end: float = 0.012) -> np.ndarray:
    """Linear-in-sqrt betas rescaled to zero terminal SNR (arXiv:2305.08891)."""
    betas = np.linspace(start ** 0.5, end ** 0.5, T, dtype=np.float64) ** 2
    s = np.sqrt(np.cumprod(1.0 - betas))
    s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
    return s ** 2


def dpmpp_3m_sde_rows(steps: int, cfg: float):
    """k-diffusion's sample_dpmpp_3m_sde at eta 0 on the discrete sigmas: per
    step the denoiser's (c_skip, c_out, c_in, model t) for v-prediction and
    the update x <- a x + b D + A (D - D1) + B (D1 - D2); every coefficient
    rounded to float32."""
    ac_all = v21_alphas_cumprod()
    T = len(ac_all)
    ts = np.linspace(T - 1, 0, steps, endpoint=False).astype(int)
    ac = ac_all[ts].copy()
    ac[0] = 1e-8  # the zero-SNR schedule's first alpha-bar
    sigmas = np.append(((1 - ac) / ac) ** 0.5, 0.0)
    grid = np.append(ts, 0)
    rows = []
    h_1 = h_2 = None
    for i in range(steps):
        sig = sigmas[i]
        r = dict(c_skip=1.0 / (sig ** 2 + 1.0), c_out=-sig / (sig ** 2 + 1.0) ** 0.5,
                 c_in=1.0 / (sig ** 2 + 1.0) ** 0.5,
                 t=float(grid[np.abs(sig - sigmas).argmin()]), cfg=cfg,
                 a=0.0, b=1.0, A=0.0, B=0.0)
        if sigmas[i + 1] > 0:
            h = np.log(sigmas[i]) - np.log(sigmas[i + 1])
            r["a"], r["b"] = np.exp(-h), -np.expm1(-h)
            phi2 = np.expm1(-h) / h + 1.0
            phi3 = phi2 / h - 0.5
            if h_2 is not None:
                r0, r1 = h_1 / h, h_2 / h
                k = r0 / (r0 + r1)
                r["A"] = (phi2 * (1 + k) - phi3 / (r0 + r1)) / r0
                r["B"] = (-phi2 * k + phi3 / (r0 + r1)) / r1
            elif h_1 is not None:
                r["A"] = phi2 / (h_1 / h)
            h_1, h_2 = h, h_1
        rows.append({k: float(np.float32(v)) for k, v in r.items()})
    return rows, float(np.sqrt(1.0 + sigmas[0] ** 2))


# ------------------------------------------------------- image helpers ---- #
_WAVELET = torch.tensor([[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
                         [0.0625, 0.125, 0.0625]])


def _blur(x, radius):
    c = x.shape[-1]
    k = _WAVELET.to(x.device, x.dtype)[None, None].repeat(c, 1, 1, 1)
    y = F.pad(x.permute(0, 3, 1, 2), (radius,) * 4, mode="replicate")
    return F.conv2d(y, k, dilation=radius, groups=c).permute(0, 2, 3, 1)


def wavelet_colour_fix(content, style, levels=5):
    """content's high frequencies + style's low frequencies (NHWC)."""
    def split(x):
        high, low = torch.zeros_like(x), x
        for i in range(levels):
            b = _blur(low, 2 ** i)
            high, low = high + (low - b), b
        return high, low
    return split(content)[0] + split(style)[1]


def _pil_cubic(x):
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return 0.0


def _pil_coeffs(n_in, n_out):
    """Pillow's fixed-point bicubic weights along one axis (Resample.c)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    out = np.zeros((n_out, n_in), np.int64)
    for o in range(n_out):
        c = (o + 0.5) * scale
        lo, hi = max(int(c - support + 0.5), 0), min(int(c + support + 0.5), n_in)
        w = [_pil_cubic((x - c + 0.5) / fs) for x in range(lo, hi)]
        tot = sum(w)
        for i, wi in enumerate(w):
            k = (wi / tot if tot else wi) * (1 << 22)
            out[o, lo + i] = int(k - 0.5) if k < 0 else int(k + 0.5)
    return out


def pil_bicubic_upscale(img: np.ndarray, factor: int) -> np.ndarray:
    """Pillow's ``Image.resize(BICUBIC)`` of a uint8 HWC image by ``factor``:
    the horizontal pass, then the vertical, each rounded and clipped."""
    x = img.astype(np.int64)
    h, w = x.shape[:2]
    for axis, n in ((1, w), (0, h)):
        k = _pil_coeffs(n, n * factor)
        s = np.einsum("ow,hwc->hoc", k, x) if axis == 1 else np.einsum("oh,hwc->owc", k, x)
        x = np.clip((s + (1 << 21)) >> 22, 0, 255)
    return x.astype(np.uint8)


# ---------------------------------------------------------- restoration ---- #
@torch.no_grad()
def restore_rows(cldm: ControlLDM, swinir: SwinIR, images: np.ndarray, pos_ids: torch.Tensor,
                 neg_ids: torch.Tensor, x_T: torch.Tensor, steps: int,
                 cfg: float) -> torch.Tensor:
    """Restore upscaled uint8 images [n, H, W, 3] (H, W multiples of 64)
    whose start noise is ``x_T`` [n, H/8, W/8, 4]; -> uint8 [n, H, W, 3]."""
    dev = x_T.device
    lq = torch.as_tensor(images, device=dev).float().div(255.0).clamp(0, 1)
    n = lq.shape[0]
    clean = swinir(lq).clamp(0.0, 1.0)
    c_img = cldm.encode(clean * 2 - 1)
    c_txt = cldm.clip(pos_ids.expand(n, -1))
    u_txt = cldm.clip(neg_ids.expand(n, -1))
    rows, start_scale = dpmpp_3m_sde_rows(steps, cfg)
    x = x_T.float() * start_scale
    ctx = torch.cat([c_txt, u_txt])
    hint = torch.cat([c_img, c_img])
    d1 = d2 = None
    for r in rows:
        x2 = torch.cat([x, x])
        t = torch.full((2 * n,), r["t"], device=dev)
        out = cldm(x2 * r["c_in"], t, ctx, hint) * r["c_out"] + x2 * r["c_skip"]
        o_c, o_u = out.chunk(2)
        d = o_u + r["cfg"] * (o_c - o_u)
        x_new = r["a"] * x + r["b"] * d
        if r["A"]:
            x_new = x_new + r["A"] * (d - d1)
        if r["B"]:
            x_new = x_new + r["B"] * (d1 - d2)
        x, d1, d2 = x_new, d, d1
    img = cldm.decode(x)
    img = wavelet_colour_fix((img + 1) / 2, clean)
    return (img * 255.0).clamp(0, 255).to(torch.uint8)
