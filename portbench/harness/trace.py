"""The traced run's device record: busy and idle time, device time by
kernel name, and idle gaps named by what the host was doing.

The device is traced with ``torch.profiler`` over CUDA activity only
(recording every host op as well slows the host, which issues the
work).  The host's side comes from the harness's own spans
(``Phases``), which cost a clock read each.  The two clocks are tied by a
marker: right after a synchronize, the first device operation is a fill the
harness launches at a host time it reads.
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Phases", "DeviceTrace"]


class Phases:
    """Host spans of the harness: ``with phases("label"): ...``."""

    def __init__(self):
        self.spans: List[Tuple[float, float, str]] = []
        self._starts: List[float] = []
        self._label = None

    def __call__(self, label: str):
        self._label = label
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._cur = self._label
        return self

    def __exit__(self, *exc):
        self.spans.append((self._t0, time.perf_counter(), self._cur))
        self._starts.append(self._t0)
        return False

    def label_at(self, t: float) -> str:
        """The label of the span that holds host time ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i][2]
        return "harness"


class DeviceTrace:
    """Start before the window, stop after it; then read."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.events: List[Tuple[float, float, str]] = []   # host seconds
        self._totals: Optional[Dict[str, float]] = None
        self._busy: Optional[List[Tuple[float, float]]] = None
        self.t0 = self.t1 = 0.0

    def start(self):
        torch = self.torch
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self._mark = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        self._mark.fill_(1.0)                    # the first device event
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.events = self._device_events()
        self.prof = None

    def _device_events(self):
        """The device's operations as (start, end, name) on the host's
        clock, read from the profiler's raw results (building its
        per-event Python objects takes minutes for a window of many small
        launches)."""
        from torch.autograd import DeviceType
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            a, b = ev.start_ns(), ev.end_ns()
            if b > a:
                raw.append((a, b, ev.name()))
        if not raw:
            return []
        raw.sort()
        off = self.t_mark - raw[0][0] / 1e9      # the marker
        return [(off + a / 1e9, off + b / 1e9, n) for a, b, n in raw[1:]
                if off + b / 1e9 > self.t0]

    # -- readings ------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        if self._busy is not None:
            return self._busy
        out: List[Tuple[float, float]] = []
        for a, b, _ in self.events:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        self._busy = out
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def _by_name(self) -> Dict[str, float]:
        if self._totals is None:
            self._totals = {}
            for a, b, n in self.events:
                self._totals[n] = self._totals.get(n, 0.0) + (b - a)
        return self._totals

    def seconds_matching(self, pattern: str) -> Optional[float]:
        """Device seconds of the operations whose name matches
        ``pattern`` (a regular expression, searched); None where none
        ran."""
        rx = re.compile(pattern)
        hits = [s for n, s in self._by_name().items() if rx.search(n)]
        return sum(hits) if hits else None

    def top_ops(self, k: int = 10) -> List[list]:
        return [[n[:200], s] for n, s in
                sorted(self._by_name().items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, phases: Phases, k: int = 10) -> List[list]:
        """Idle device time summed by the host span at each gap's middle,
        largest first."""
        by: Dict[str, float] = {}
        prev = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > prev:
                label = phases.label_at((a + prev) / 2)
                by[label] = by.get(label, 0.0) + (a - prev)
            prev = max(prev, b)
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]
