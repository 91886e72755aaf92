"""The benchmark's arithmetic: percentiles, rates, spreads, the busy union,
merged traces, idle gaps, and the roofline and mfu readers."""

import importlib.util
import math

import pytest

from benchmark.lib import peaks, stats
from benchmark.lib.trace import Trace, union_us
from benchmark.tests.helpers import ROOT


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert stats.percentile(v, 100) == 100
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.percentile([5.0], 90) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_rate():
    assert stats.rate(10.0, 4.0) == 2.5
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_exponential_gaps_same_set_any_order():
    a = stats.exponential_gaps(50, 2.0, range(50))
    b = stats.exponential_gaps(50, 2.0, list(reversed(range(50))))
    assert sorted(a) == sorted(b) and a != b
    assert sum(a) == pytest.approx(50 / 2.0, rel=0.05)
    assert a[0] == pytest.approx(-math.log(1 - 0.5 / 50) / 2.0)


def test_union_and_merge():
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_us([]) == 0
    t1 = Trace(10.0, [("k", 100.0, 104.0)], [("cudaLaunchKernel", 99.0, 101.0)])
    t2 = Trace(10.0, [("k", 0.0, 2.0), ("x", 5.0, 6.0)])
    m = Trace.merge([t1, t2])
    assert m.window_us == 20.0 and m.busy_us == 7.0 and len(m.kernels) == 3
    assert m.kernel_us("k") == [4.0, 2.0]
    assert m.top_ops(1) == [["k", 6e-6]]


def test_idle_gaps_named_by_the_host_call():
    t = Trace(10.0, [("a", 0.0, 1.0), ("b", 4.0, 5.0), ("c", 5.5, 6.0)],
              [("cudaMemcpyAsync", 1.0, 4.0), ("outer", 0.0, 10.0)])
    gaps = t.idle_gaps(2)
    assert gaps[0] == ["cudaMemcpyAsync", 3e-6]
    assert gaps[1][1] == pytest.approx(0.5e-6)


def test_roofline_and_mfu_readers():
    t = Trace(100.0, [("flash_fwd_tc_kernel<64>", 0.0, 40.0), ("gemm", 40.0, 60.0)])
    assert reader("k1_roofline")({"trace": t, "k1_least_us": 10.0,
                                        "k1_symbol": "flash_fwd_tc_kernel"}) == 25.0
    assert reader("k1_roofline")({"trace": Trace(1.0, []), "k1_least_us": 1.0,
                                        "k1_symbol": "flash_fwd_tc_kernel"}) is None
    t2 = Trace(100.0, [("flash_bwd_dq_tc_kernel", 0.0, 10.0),
                       ("flash_bwd_dkv_tc_kernel", 10.0, 30.0)])
    assert reader("k2_roofline")({"trace": t2, "k2_least_us": 6.0, "k2_symbols": (
        "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")}) == pytest.approx(20.0)
    r = {"steady_flops": peaks.BF16_FLOPS * 0.5, "steady_s": 2.0}
    assert reader("mfu.serve")(r) == pytest.approx(25.0)
    assert reader("mfu.train")(r) == pytest.approx(25.0)
    assert reader("device.idle_share.serve")({"trace": t}) == pytest.approx(40.0)
    assert reader("step.kernels_per_call.serve")({"trace": t, "denoiser_calls": 2}) == 1.0
