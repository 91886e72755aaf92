"""The float32 reference against the port at the tiny sizes on the CPU:
the same parameter names, the same served images and the same first
training step (the program in float32 here, so only rounding parts them)."""

import json

import torch

from benchmark.drivers.common import program_networks, reference_networks
from benchmark.tests.helpers import DATA, run_tiny

TINY = json.loads((DATA / "tiny-sr.json").read_text())


def test_same_parameters_and_weights():
    cldm, swinir = program_networks(TINY, torch.device("cpu"), 2**31 + 1)
    ref_cldm, ref_swinir = reference_networks(TINY, torch.device("cpu"), 2**31 + 1)
    for prog, ref in ((cldm, ref_cldm), (swinir, ref_swinir)):
        p, r = dict(prog.named_parameters()), dict(ref.named_parameters())
        assert p.keys() == r.keys()
        assert all(torch.equal(p[k].float(), r[k]) for k in p)


def test_served_images_match_the_reference():
    r = run_tiny("tiny-serve")
    assert r["correct"] and r["failed"] == 0
    assert r["compared"]["image_gap_share"]["value"] == 0.0
    assert set(r["metrics"]) == {"latency_p50_s", "peak_mem_gib", "setup_s"}


def test_training_step_matches_the_reference():
    r = run_tiny("tiny-train", seconds=2.0)
    assert r["correct"]
    c = {k: v["value"] for k, v in r["compared"].items()}
    assert c["loss_gap"] < 1e-5 and c["grad_norm_gap"] < 1e-4 and c["change_norm_gap"] < 1e-3
