"""A run whose timed path is broken underneath comes out not correct, for
each fault a cell can have: on the CPU at the tiny sizes, the card check
skipped. (One chip: there is no exchange between chips to leave out.)"""

import torch

from benchmark import faults
from benchmark.drivers import train_steps
from benchmark.drivers.common import Context
from benchmark.tests.helpers import DATA, run_tiny


def test_an_answer_altered():
    r = run_tiny("tiny-serve", faults={"answer": faults.answer_altered})
    assert not r["correct"] and r["compared"]["image_gap_share"]["value"] > 0.5


def test_half_the_batch():
    r = run_tiny("tiny-train", seconds=2.0, faults={"step": faults.half_batch})
    assert not r["correct"]
    assert r["compared"]["loss_gap"]["value"] > r["compared"]["loss_gap"]["limit"]


def test_a_state_left_unchanged():
    r = run_tiny("tiny-train", seconds=2.0, faults={"step": faults.state_unchanged})
    assert not r["correct"] and r["compared"]["grad_norm_gap"]["value"] == 1.0


def test_the_optimiser_moments_reset():
    r = run_tiny("tiny-train", seconds=2.0, faults={"step": faults.moments_reset})
    assert not r["correct"]
    assert r["compared"]["change_norm_gap"]["value"] > r["compared"]["change_norm_gap"]["limit"]


def test_the_training_control_reads_above_the_program():
    """The float8 control against the reference at the tiny sizes (the
    limits themselves are set from readings at the cell's size)."""
    import json

    cfg = json.loads((DATA / "tiny-train.json").read_text())
    tr = json.loads((DATA / "tiny-train-traffic.json").read_text())
    ctx = Context(cfg, tr, 5, 0, False, torch.device("cpu"), 0.0)
    ref = train_steps.reference_readings(ctx)
    ctl = train_steps.gaps(train_steps.reference_readings(ctx, faults.fp8_operands_), ref)
    assert ctl["grad_norm_gap"] > 10 * 1e-4 and ctl["loss_gap"] > 1e-4


def test_the_serving_control_reads_above_the_program():
    r = run_tiny("tiny-serve", overrides={"serving_mode": "int8"})
    assert r["compared"]["image_gap_share"]["value"] > 0.0
