"""The program's own spans (``repro_torch.obs``) over a run's window, on
the host's clock, and the device's idle time named by them.  What a span
means belongs to its system: the readings made from a system's spans live
beside its readers (``metrics/_summa_spans.py``).

The program records its spans on its bus, which counts from an epoch on
``time.perf_counter``; ``ts_s + obs.epoch()`` puts a span on the clock of
the harness's ``Phases`` and of the device trace (``trace.py``).  Nothing
here imports the program: the bus is read from ``sys.modules`` where the
program loaded it.  Against a program whose bus has no shared epoch, or
that recorded no span in the window, :func:`window_spans` returns None and
idle gaps keep the harness's labels.
"""
from __future__ import annotations

import bisect
import sys
import threading
from typing import Dict, List, NamedTuple, Optional

__all__ = ["Span", "window_spans", "idle_by_span"]


class Span(NamedTuple):
    start: float                  # host perf_counter seconds
    end: float
    name: str
    span_id: int
    parent_id: Optional[int]
    tid: int
    attrs: dict


def window_spans(t0: float, t1: float) -> Optional[List[Span]]:
    """The spans the program's bus recorded inside [t0, t1] (host
    ``perf_counter`` seconds), by start, their device times resolved;
    None where the program has no such bus or it recorded none there."""
    obs = sys.modules.get("repro_torch.obs")
    if getattr(obs, "epoch", None) is None:
        return None
    obs.resolve_device()
    off = obs.epoch()
    out = [Span(off + e.ts_s, off + e.ts_s + e.dur_s, e.name, e.span_id,
                e.parent_id, e.tid, e.attrs)
           for e in obs.events()
           if e.kind == "span" and e.span_id is not None
           and off + e.ts_s >= t0 and off + e.ts_s + e.dur_s <= t1]
    return sorted(out, key=lambda s: (s.start, s.span_id)) or None


def _innermost(spans: List[Span], starts: List[float],
               by_id: Dict[int, Span], t: float) -> Optional[Span]:
    """The innermost span open at ``t``: spans of one thread nest, so it
    is the last span to start by ``t`` or one of its ancestors."""
    i = bisect.bisect_right(starts, t) - 1
    s = spans[i] if i >= 0 else None
    while s is not None and s.end < t:
        s = by_id.get(s.parent_id)
    return s


def idle_by_span(trace, phases, spans: Optional[List[Span]], k: int = 10,
                 tid: Optional[int] = None) -> List[list]:
    """The device's idle time, summed by the harness's label at each
    gap's middle joined by ">" to the innermost program span open there on
    the issuing thread (``tid``, the main thread by default), as
    ``[[label, seconds], ...]``, largest first.  A gap outside every
    program span keeps the harness's label."""
    tid = threading.main_thread().ident if tid is None else tid
    own = sorted((s for s in spans or () if s.tid == tid),
                 key=lambda s: (s.start, s.span_id))
    starts = [s.start for s in own]
    by_id = {s.span_id: s for s in own}
    by: Dict[str, float] = {}
    prev = trace.t0
    for a, b in trace.busy_intervals() + [(trace.t1, trace.t1)]:
        if a > prev:
            mid = (a + prev) / 2
            label = phases.label_at(mid)
            s = _innermost(own, starts, by_id, mid)
            if s is not None:
                label = f"{label}>{s.name}"
            by[label] = by.get(label, 0.0) + (a - prev)
        prev = max(prev, b)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
