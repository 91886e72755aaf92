"""The FLOP and byte counts against written formulas, at the tiny
ControlLDM's sizes (``ControlLDM.tiny``'s)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.drivers.common import sizes_json
from benchmark.lib import flops, peaks
from benchmark.reference.models import attention, build
from benchmark.tests.helpers import DATA, ROOT

TINY = json.loads((DATA / "tiny-sr.json").read_text())


def test_attention_sites_at_tiny_sizes():
    # model_channels 32, mult (1, 2), attention at ds 2 and 1, 16-wide heads
    s = flops.attention_sites(TINY["cldm"]["unet"], (8, 8))
    assert s["unet_in"] == [(64, 2, 16)] * 2 + [(16, 4, 16)] * 2
    assert s["unet_out"] == [(16, 4, 16)] * 3 + [(64, 2, 16)] * 3
    assert s["unet_mid"] == s["cn_mid"] == [(16, 4, 16)]
    assert s["cn_in"] == s["unet_in"]
    sd21 = json.loads((ROOT / "benchmark" / "configs" / "diffbir-v2.1-sr.json").read_text())
    full = flops.attention_sites(sd21["cldm"]["unet"], (64, 64))  # SD2.1: 23 sites a call
    assert sum(len(v) for v in full.values()) == 23


def test_attention_formulas():
    q, k, v = (torch.empty(2, 64, 2, 16, device="meta") for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        attention(q, k, v)
    f, nbytes = flops.attn_fwd(2, (64, 2, 16))
    assert fc.get_total_flops() == f == 4 * 2 * 2 * 64 * 64 * 16
    assert nbytes == 2 * 2 * 2 * 16 * 4 * 64
    fb, bb = flops.attn_bwd(2, (64, 2, 16))
    assert fb == 2.5 * f and bb == 2 * 2 * 2 * 16 * 8 * 64 + 8 * 2 * 2 * 64
    assert flops.least_us(peaks.BF16_FLOPS, 0) == pytest.approx(1e6)
    assert flops.least_us(0, peaks.HBM_BYTES) == pytest.approx(1e6)


def test_denoiser_call_products_match_the_sites():
    """The products of one CFG denoiser call (batch 2) that are attention:
    the self-attention sites' and the cross-attention to the 77 text rows."""
    with torch.device("meta"):
        cldm = build("cldm", TINY["cldm"])
    x = torch.empty(2, 8, 8, 4, device="meta")
    ctx = torch.empty(2, 77, 64, device="meta")
    with FlopCounterMode(display=False) as fc:
        cldm(x, torch.zeros(2, device="meta"), ctx, x)
    bmm = sum(v for op, v in fc.get_flop_counts()["Global"].items() if "bmm" in str(op))
    sites = [s for part in flops.attention_sites(TINY["cldm"]["unet"], (8, 8)).values()
             for s in part]
    self_attn = sum(flops.attn_fwd(2, s)[0] for s in sites)
    cross = sum(4 * 2 * h * t * 77 * d for t, h, d in sites)
    assert bmm == self_attn + cross


def test_serve_flops_grow_by_one_denoiser_call_a_step():
    sj = sizes_json(TINY)
    one, two = flops.serve_flops(sj, 64, 1), flops.serve_flops(sj, 64, 2)
    with torch.device("meta"):
        cldm = build("cldm", TINY["cldm"])
    with FlopCounterMode(display=False) as fc:
        x = torch.empty(2, 8, 8, 4, device="meta")
        cldm(x, torch.zeros(2, device="meta"), torch.empty(2, 77, 64, device="meta"), x)
    assert two - one == fc.get_total_flops()
    assert flops.train_flops(sj, 64) > 2 * fc.get_total_flops() / 2
