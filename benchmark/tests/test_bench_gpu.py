"""The controls at the cells' own sizes, on the card (they skip here):

    python3 -m pytest benchmark/tests -m gpu -p no:cacheprovider

The serving control (the port's int8 serving mode in the program's place)
and the training control (the float32 reference on float8 operands in the
program's place) have to come out not correct; a sound short run correct."""

import pytest
import torch

from benchmark import faults, run
from benchmark.drivers import train_steps
from benchmark.drivers.common import Context

pytestmark = pytest.mark.gpu
SEED = 2**31 + 77


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_serving_control_is_not_correct(card):
    r = run.execute("v21-sr512-serve", SEED, 15.0, False, overrides={"serving_mode": "int8"})
    assert not r["correct"]


def test_sound_serving_run_is_correct(card):
    assert run.execute("v21-sr512-serve", SEED, 15.0, False)["correct"]


def test_training_control_is_not_correct(card):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.named(bench["workloads"], "v21-stage2-train", "workload")
    cfg = run.load_json(run.ROOT / run.named(bench["configs"], cell["config"], "config")["file"])
    tr = run.load_json(run.BENCH / "traffic" / f"{cell['traffic']}.json")
    ctx = Context(cfg, tr, SEED, 0, False, card, 0.0)
    ctl = train_steps.gaps(train_steps.reference_readings(ctx, faults.fp8_operands_),
                           train_steps.reference_readings(ctx))
    assert any(ctl[k] > tr[f"limit_{k}"] for k in ctl)
