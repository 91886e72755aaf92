"""The traced run's profiled sub-window, reduced to what the per-layer
metrics read: device kernels by name and interval, the device's busy time
(the union of the kernel intervals: ``profile_step._union_us``'s
arithmetic, copied), the longest idle gaps with the CUDA runtime call the
host was in, and the device operations that took most time."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# device kernel names of the port's kernels (a copy of ``profile_step.KERNELS``
# for the entries the benchmark reads): K1 (K3 is its prescaled instance) and
# the backward pair K2a, K2b
KERNELS = {"K1": "flash_fwd_tc_kernel", "K2a": "flash_bwd_dq_tc_kernel",
           "K2b": "flash_bwd_dkv_tc_kernel"}


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


@dataclass
class Trace:
    """One profiled sub-window (times in microseconds)."""
    window_us: float
    kernels: List[Tuple[str, float, float]]            # (name, start, end)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @staticmethod
    def merge(traces) -> "Trace":
        """One trace of several sub-windows laid end to end (each shifted
        past the one before it)."""
        kernels, host, offset, window = [], [], 0.0, 0.0
        for t in traces:
            times = [s for _, s, _ in t.kernels + t.host_ops]
            if not times:
                continue
            shift = offset - min(times)
            kernels += [(n, s + shift, e + shift) for n, s, e in t.kernels]
            host += [(n, s + shift, e + shift) for n, s, e in t.host_ops]
            offset += t.window_us + 1.0
            window += t.window_us
        return Trace(window, kernels, host)

    @property
    def busy_us(self) -> float:
        return union_us((s, e) for _, s, e in self.kernels)

    def kernel_us(self, symbol: str) -> List[float]:
        """The durations of the kernels whose name holds ``symbol``."""
        return [e - s for n, s, e in self.kernels if symbol in n]

    def top_ops(self, n: int = 10) -> List[list]:
        """[[name, seconds], ...]: the device kernels with most total time."""
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            total[name] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[[host activity, seconds], ...]: the longest gaps between kernels,
        each named by the innermost CUDA runtime call running at its middle."""
        merged: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                      reverse=True)[:n]
        out = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            inside = [(oe - os_, name) for name, os_, oe in self.host_ops if os_ <= mid <= oe]
            name = min(inside)[1] if inside else "no CUDA runtime call (host code between launches)"
            out.append([name[:120], length / 1e6])
        return out


class SubWindow:
    """``start()`` / ``stop()`` a ``torch.profiler`` over the device's
    activity alone (kernels, copies and the CUDA runtime calls that launch
    them: recording every host operator as well slows the host-bound path
    several times over; no shapes, no stacks, no trace file), and
    ``reduce()`` it later, off the timed path. ``warm()`` pays the
    profiler's one-time start-up before the window."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.trace: Optional[Trace] = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        # without a card (the CPU tests) only host activity exists to record
        return profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                   else ProfilerActivity.CPU])

    def warm(self) -> None:
        import torch

        with self._profile():
            torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum().item()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> Trace:
        from torch.autograd import DeviceType

        events = self.prof.events()
        kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA]
        host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU]
        spans = [s for _, s, _ in kernels + host] + [e for _, _, e in kernels + host]
        window = (max(spans) - min(spans)) if spans else (self.t1 - self.t0) * 1e6
        self.trace = Trace(window, kernels, host)
        self.prof = None
        return self.trace
