"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``diffbir_tpu_torch``) and
``BENCHMARK.json``. Everything is found by name: the cell in
``BENCHMARK.json``'s ``workloads``; its configuration in the file its
``configs`` entry names; its traffic in ``benchmark/traffic/<traffic>.json``,
whose ``driver`` names the general module under ``benchmark/drivers/`` that
runs it; each per-layer metric's reader in ``benchmark/metrics/<name>.py``
(a ``read(readings)`` that returns the number, or None where it finds
nothing to read). With ``--trace 0`` the result holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiled
sub-window. The last line of standard output is the result as JSON; the
last lines of standard error give each compared number beside its limit.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), or when the process has loaded JAX, Flax or the
JAX package (``lib.checks``).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache of the run inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench_cache" / "torch_ext"))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import checks  # noqa: E402


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The cell's end-to-end ("end_to_end") or per-layer ("per_layer")
    metric entries: those that list it, and those without a list whose
    (moved) end-to-end metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(workload: str, seed: int, seconds: float, trace: bool, device=None, faults=None,
            bench: dict = None, traffic_dir: Path = BENCH / "traffic",
            overrides: dict = None, check: bool = True, t_process: float = T_PROCESS) -> dict:
    """One run of a cell; returns the result object. ``device``, ``faults``,
    ``bench``, ``traffic_dir``, ``overrides`` (of the traffic file's or the
    configuration's keys, such as ``serving_mode`` for the serving control)
    and ``check`` (False: no comparison) are for tests, the control runs and
    the sweeps."""
    import torch

    from benchmark.drivers.common import Context

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = named(bench["workloads"], workload, "workload")
    config = load_json(ROOT / named(bench["configs"], cell["config"], "config")["file"])
    traffic = load_json(Path(traffic_dir) / f"{cell['traffic']}.json")
    for k, v in (overrides or {}).items():
        (traffic if k in traffic else config)[k] = v
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.set_num_threads(2)  # the host's cores to the server and its clients, not to
        # intra-op pools (the port's work on the host is small)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    ctx = Context(config, traffic, seed, seconds, trace, torch.device(device), t_process,
                  faults or {}, check)
    out = driver.run(ctx)
    if trace:
        metrics = {}
        for m in metrics_of(bench, workload, "per_layer"):
            value = reader(m["name"])(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        wanted = {m["name"] for m in metrics_of(bench, workload, "end_to_end")}
        metrics = {k: v for k, v in out["e2e"].items() if k in wanted}
    compared = out["compared"]
    result = {"correct": all(c["value"] <= c["limit"] for c in compared),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace:
        tr = out["readings"]["trace"]
        result["device"].update(busy_s=tr.busy_us / 1e6, window_s=tr.window_us / 1e6)
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in compared}
    result["_driver"] = {k: out[k] for k in ("latencies", "backlog", "program") if k in out}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    result.pop("_driver")
    bad = checks.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
