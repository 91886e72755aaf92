"""Tiny cells for the benchmark's CPU tests: the real BENCHMARK.json's
metrics over two cells that run the tiny configurations and traffic of
``benchmark/tests/data`` on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NAMES = {"v21-sr512-serve": "tiny-serve", "v21-stage2-train": "tiny-train"}


def tiny_bench() -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-sr", "file": "benchmark/tests/data/tiny-sr.json"},
                        {"name": "tiny-train", "file": "benchmark/tests/data/tiny-train.json"}]
    bench["workloads"] = [
        {"name": "tiny-serve", "config": "tiny-sr", "traffic": "tiny-serve-traffic", "chips": 1},
        {"name": "tiny-train", "config": "tiny-train", "traffic": "tiny-train-traffic",
         "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [NAMES[w] for w in m["workloads"]]
    return bench


def run_tiny(workload: str, seed: int = 2**31 + 5, seconds: float = 3.0, trace: bool = False,
             **kw) -> dict:
    from benchmark import run

    return run.execute(workload, seed, seconds, trace, device="cpu", bench=tiny_bench(),
                       traffic_dir=DATA, **kw)
