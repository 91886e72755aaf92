"""Cells, configurations, traffic and per-layer metrics are found as data,
and a later change adds a cell and a metric by adding files alone."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run
from benchmark.tests.helpers import DATA, ROOT


def test_every_entry_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("benchmark/")
    for cell in bench["workloads"]:
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
        per_layer = run.metrics_of(bench, cell["name"], "per_layer")
        e2e = {m["name"] for m in run.metrics_of(bench, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
        for m in per_layer:
            assert m["moves"] in e2e
            assert callable(run.reader(m["name"]))


def test_metrics_of_takes_listed_and_unlisted(bench):
    bench["per_layer"].append({"name": "x", "moves": "setup_s", "unit": "s"})
    names = {m["name"] for m in run.metrics_of(bench, "tiny-serve", "per_layer")}
    assert "x" in names and "serve.batch_mean" in names and "mfu.train" not in names
    e2e = {m["name"] for m in run.metrics_of(bench, "tiny-train", "end_to_end")}
    assert e2e == {"train_images_per_s", "peak_mem_gib", "setup_s"}


def test_a_cell_and_a_metric_from_added_files_only(tmp_path, bench):
    """A copy of the benchmark gains a traffic file, a metric reader and
    their entries in BENCHMARK.json; no file it had changes, and a run of
    the new cell reports the new metric."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    traffic = json.loads((DATA / "tiny-serve-traffic.json").read_text())
    traffic["rate_per_s"] = 3.0
    (tmp_path / "benchmark" / "traffic" / "tiny-serve-faster.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "serve.calls_in_window.py").write_text(
        'def read(r):\n    return len(r["steady_calls"]) or None\n')
    bench["workloads"].append({"name": "tiny-serve-faster", "config": "tiny-sr",
                               "traffic": "tiny-serve-faster", "chips": 1})
    bench["per_layer"].append({"name": "serve.calls_in_window", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving", "moves": "latency_p50_s",
                               "workloads": ["tiny-serve-faster"]})
    for m in bench["end_to_end"]:
        if "tiny-serve" in m.get("workloads", []):
            m["workloads"].append("tiny-serve-faster")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from benchmark import run; "
            "r = run.execute('tiny-serve-faster', 7, 3.0, True, device='cpu'); "
            "print(json.dumps(sorted(r['metrics'])))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "serve.calls_in_window" in json.loads(out.stdout.strip().splitlines()[-1])
    assert all(p.read_bytes() == b for p, b in before.items())
