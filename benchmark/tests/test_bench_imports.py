"""Nothing the benchmark loads is JAX, Flax or the JAX package (top-level
names compared whole: ``diffbir_tpu_torch`` is not ``diffbir_tpu``); the
reference loads nothing of the program; a directory holding only
BENCHMARK.json and the benchmark gives no result."""

import os
import shutil
import subprocess
import sys

from benchmark.lib.checks import forbidden_modules
from benchmark.tests.helpers import ROOT


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def test_names_compared_whole():
    assert forbidden_modules({"diffbir_tpu_torch", "diffbir_tpu_torch.serve", "jaxtyping"}) == []
    assert forbidden_modules({"diffbir_tpu.models", "jax", "flax.linen", "jaxlib"}) == [
        "diffbir_tpu.models", "flax.linen", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests/..'); "
            "from benchmark.tests.helpers import run_tiny; "
            "r = run_tiny('tiny-serve', trace=True); run_tiny('tiny-train', seconds=2.0); "
            "from benchmark.lib.checks import forbidden_modules; "
            "print('FORBIDDEN', forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.models, benchmark.reference.restore, "
            "benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'diffbir_tpu_torch', 'diffbir_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "v21-sr512-serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
