"""Chip-side studies that set the benchmark's numbers; not run by the
benchmark itself. Each appends one JSON line per run to ``--out``.

    python3 benchmark/tools.py sweep --rates 1.5,2,2.5 [--seeds 1,2] --seconds 51 --out F
        the served cell at each offered rate and seed (no comparison): p50,
        p90, Mpix/s, the backlog at the close and the mean latency of each
        third of the requests, to find the highest rate sustained without a
        growing backlog (the cell runs at about 4/5 of it);
    python3 benchmark/tools.py batch --batches 32,40,48 --out F
        the training cell's step at each per-card batch: peak memory
        against 0.9 of the card, images/s;
    python3 benchmark/tools.py seeds --workload W --seeds 1,2,3
        [--fault NAME] [--set key=value] [--seconds S] --out F
        the cell's compared numbers on each seed; ``--set
        serving_mode="int8"`` runs the serving control: the program's own
        int8 serving path in its place; ``--fault`` plants a fault of
        ``benchmark/faults.py``;
    python3 benchmark/tools.py train_study --seeds 1,2,3
        --variants sound,half_batch,moments_reset,fp8 [--seconds S] --out F
        the training cell's compared numbers on each seed for each variant,
        against one reference run a seed: the program as it is (``sound``),
        with a fault of ``benchmark/faults.py`` planted, or the control
        (``fp8``: the reference on float8 operands in the program's place).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench_run  # noqa: E402
from benchmark.faults import SERVE_FAULTS, TRAIN_FAULTS  # noqa: E402
from benchmark.lib import stats  # noqa: E402


def _write(path: str, row: dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("sweep", "batch", "seeds", "train_study"))
    ap.add_argument("--fault", default=None, help="a fault of benchmark/faults.py")
    ap.add_argument("--workload", default="v21-sr512-serve")
    ap.add_argument("--rates", default="")
    ap.add_argument("--batches", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--variants", default="sound")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="key=value over the traffic file's or configuration's keys (JSON value)")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    import torch

    kind = torch.cuda.get_device_name(0)
    over = {k: json.loads(v) for k, v in (x.split("=", 1) for x in a.set)}
    if a.what == "sweep":
        for r, seed in [(float(x), int(s)) for x in a.rates.split(",")
                        for s in (a.seeds or "7777").split(",")]:
            t = time.perf_counter()
            out = bench_run.execute("v21-sr512-serve", seed, a.seconds, False,
                                    overrides={"rate_per_s": r}, check=False,
                                    t_process=time.perf_counter())
            lat = out["_driver"]["latencies"]  # in the order the requests were due
            n3 = len(lat) // 3
            _write(a.out, {"rate": r, "seed": seed, "metrics": out["metrics"],
                           "failed": out["failed"],
                           "p50": stats.percentile([x for x in lat if x], 50),
                           "p90": stats.percentile([x for x in lat if x], 90),
                           "thirds_mean_s": [sum(x for x in part if x) / max(1, len(part))
                                             for part in (lat[:n3], lat[n3:2 * n3],
                                                          lat[2 * n3:])],
                           "backlog": out["_driver"]["backlog"],
                           "attempted": out["attempted"], "device": kind,
                           "wall_s": time.perf_counter() - t})
    elif a.what == "batch":
        for b in [int(x) for x in a.batches.split(",")]:
            try:
                out = bench_run.execute("v21-stage2-train", 9000 + b, a.seconds, False,
                                        overrides={"batch_size": b}, check=False,
                                        t_process=time.perf_counter())
                row = {"batch": b, "metrics": out["metrics"]}
            except torch.OutOfMemoryError:
                row = {"batch": b, "oom": True}
            row.update(device=kind, total_gib=torch.cuda.get_device_properties(0).total_memory
                       / 2 ** 30)
            _write(a.out, row)
            torch.cuda.empty_cache()
    elif a.what == "train_study":
        from benchmark.drivers import train_steps
        from benchmark.drivers.common import Context
        from benchmark.faults import fp8_operands_

        bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
        cell = bench_run.named(bench["workloads"], "v21-stage2-train", "workload")
        cfg = bench_run.load_json(bench_run.ROOT / bench_run.named(
            bench["configs"], cell["config"], "config")["file"])
        traffic = bench_run.load_json(bench_run.BENCH / "traffic" / f"{cell['traffic']}.json")
        for k, v in over.items():
            (traffic if k in traffic else cfg)[k] = v
        for s in [int(x) for x in a.seeds.split(",")]:
            t = time.perf_counter()
            ctx = Context(cfg, traffic, s, 0, False, torch.device("cuda"), t)
            ref = train_steps.reference_readings(ctx)
            for v in a.variants.split(","):
                t = time.perf_counter()
                if v == "fp8":
                    prog = train_steps.reference_readings(ctx, fp8_operands_)
                else:
                    faults = {} if v == "sound" else {"step": TRAIN_FAULTS[v]}
                    prog = bench_run.execute(
                        "v21-stage2-train", s, a.seconds, False, faults=faults, overrides=over,
                        check=False, t_process=t)["_driver"]["program"]
                    torch.cuda.empty_cache()
                _write(a.out, {"seed": s, "variant": v, "set": over,
                               "compared": train_steps.gaps(prog, ref), "losses": prog["loss"],
                               "device": kind, "wall_s": time.perf_counter() - t})
    else:
        for s in [int(x) for x in a.seeds.split(",")]:
            t = time.perf_counter()
            try:
                faults = {}
                if a.fault in TRAIN_FAULTS:
                    faults["step"] = TRAIN_FAULTS[a.fault]
                elif a.fault:
                    faults["answer"] = SERVE_FAULTS[a.fault]
                out = bench_run.execute(a.workload, s, a.seconds, bool(a.trace),
                                        overrides=over, faults=faults,
                                        t_process=time.perf_counter())
                row = {"seed": s, "fault": a.fault, "set": over,
                       "correct": out["correct"],
                       "compared": out["compared"], "metrics": out["metrics"],
                       "failed": out["failed"], "device": out["device"]}
                if "breakdown" in out:
                    row["breakdown"] = out["breakdown"]
            except Exception:  # noqa: BLE001 - a crashed control is a reading too
                row = {"seed": s, "set": over, "error": traceback.format_exc()[-2000:]}
            row["wall_s"] = time.perf_counter() - t
            _write(a.out, row)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
