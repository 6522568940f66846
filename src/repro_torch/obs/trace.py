"""Hierarchical tracing bus on the step / decode-step clock.

This is the repo's single telemetry seam: every producer (the elastic
trainer, the serving engines, the scheduler, the chaos campaign, the
kernel dispatchers) publishes **events** into one process-global
:class:`Tracer`, and every consumer (the chaos campaign's per-spec
collector, the straggler detector, the exporters in
:mod:`repro_torch.obs.export`) attaches through ``obs.subscribe(on_event)``.
The private stats structs that predate the bus (``EngineStats``,
``ElasticReport``, ``SchedStats``, campaign rows) keep their public APIs
but are views over the same happenings.  This module is a copy of the
reference package's ``repro/obs/trace.py``.

Design constraints, in order:

  * **zero dependencies** — stdlib only; in particular no torch import,
    so :func:`stamp` is safe to call from host callback threads and from
    module import time.
  * **cheap when idle** — with recording disabled and no subscribers, a
    span costs two ``perf_counter`` calls and one branch.
  * **two clocks** — every event carries a wall timestamp (monotonic
    ``perf_counter`` seconds since tracer start) *and* an optional
    logical ``step`` (train step or decode step).  Producers either pass
    ``step=`` explicitly or let the event inherit the tracer's current
    logical clock (:func:`set_step`).
  * **first-trace separation** — the first occurrence of each span name
    in the process is flagged ``first=True``.  Compile or kernel-build time
    rides the first occurrence (that is what "first-trace pollution" means), so
    :func:`rung_timeline` splits compile-inclusive from warm samples by
    this flag unless the producer measured the split itself and attached
    explicit ``compile_s`` / ``warm_s`` attrs (as ``ElasticReport`` and
    the campaign's warm re-measures do).

Event taxonomy:

  ``train/step``, ``serve/decode_step``, ``serve/prefill``  — span per
      unit of the respective clock;
  ``fault/inject``    — a fault entered the system (drill hook, campaign
      bit-flip, page corruption);
  ``fault/detect``    — a checksum / invariant / fingerprint tripped;
  ``recovery/<rung>`` — one rung of the recovery ladder ran; ``dur_s`` is
      the rung wall, attrs may carry ``compile_s``/``warm_s``;
  ``fault/verdict``   — end-state comparison against the clean run
      (``bit_identical=True/False``);
  ``straggler/trip``, ``scrub/sweep``, ``kernel/trace``.

:func:`lifecycles` folds a recorded event stream back into complete
inject -> detect -> rung -> repair -> verdict timelines.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Event", "Tracer", "TRACER",
    "span", "event", "stamp", "recovery",
    "subscribe", "unsubscribe", "enable", "enabled",
    "set_step", "current_step", "reset", "events", "dropped",
    "rung_timeline", "lifecycles", "percentile",
]


@dataclasses.dataclass
class Event:
    """One happening on the bus.

    ``ts_s`` is seconds since the tracer epoch (``perf_counter`` based,
    monotonic); ``dur_s`` is zero for instant events.  ``first`` marks
    the first occurrence of this name in the process — the
    compile-inclusive sample for jit-backed spans.
    """
    name: str
    kind: str                       # "span" | "instant"
    ts_s: float
    dur_s: float = 0.0
    step: Optional[int] = None
    first: bool = False
    ok: bool = True                 # False when the span exited via an exception
    tid: int = 0
    seq: int = 0
    parent: Optional[str] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _Span:
    """Context manager recording a span event on exit (even on raise)."""

    __slots__ = ("_tracer", "name", "step", "attrs", "_t0", "_first", "_parent")

    def __init__(self, tracer: "Tracer", name: str, step: Optional[int],
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.step = step
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._first = tr._mark_first(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        # Pop back to (and including) our own frame even if an inner span
        # leaked — ordering under exceptions stays consistent.
        while stack and stack.pop() != self.name:
            pass
        tr._record(Event(
            name=self.name, kind="span",
            ts_s=self._t0 - tr._epoch, dur_s=t1 - self._t0,
            step=self.step if self.step is not None else tr._step,
            first=self._first, ok=exc_type is None,
            parent=self._parent, attrs=self.attrs,
        ))
        return False  # never swallow


class Tracer:
    """Process-global event bus: bounded buffer + synchronous subscribers.

    Subscribers are notified on every event even while recording is
    disabled (the straggler detector rides the bus; switching the buffer
    off must not blind it).  The buffer is bounded; overflow increments
    :meth:`dropped` instead of growing without bound — CI's obs-smoke
    job asserts zero drops on its trace.
    """

    def __init__(self, max_events: int = 200_000):
        self.max_events = int(max_events)
        self._lock = threading.RLock()
        self._events: List[Event] = []
        self._dropped = 0
        self._subs: List[Callable[[Event], None]] = []
        self._seen: set = set()
        self._enabled = True
        self._step: Optional[int] = None
        self._seq = 0
        self._epoch = time.perf_counter()
        self._tls = threading.local()

    # -- span stack (per thread) -------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _mark_first(self, name: str) -> bool:
        with self._lock:
            if name in self._seen:
                return False
            self._seen.add(name)
            return True

    # -- recording ----------------------------------------------------
    def _record(self, ev: Event) -> None:
        with self._lock:
            if not self._enabled and not self._subs:
                return
            self._seq += 1
            ev.seq = self._seq
            ev.tid = threading.get_ident()
            if self._enabled:
                if len(self._events) < self.max_events:
                    self._events.append(ev)
                else:
                    self._dropped += 1
            subs = tuple(self._subs)
        for fn in subs:
            fn(ev)

    # -- public API ---------------------------------------------------
    def span(self, name: str, step: Optional[int] = None, **attrs) -> _Span:
        return _Span(self, name, step, attrs)

    def event(self, name: str, step: Optional[int] = None,
              dur_s: float = 0.0, **attrs) -> None:
        if not self._enabled and not self._subs:
            return
        first = self._mark_first(name)
        self._record(Event(
            name=name, kind="instant",
            ts_s=time.perf_counter() - self._epoch, dur_s=dur_s,
            step=step if step is not None else self._step,
            first=first, attrs=attrs,
        ))

    def recovery(self, rung: str, wall_s: float, step: Optional[int] = None,
                 compile_s: Optional[float] = None,
                 warm_s: Optional[float] = None, **attrs) -> None:
        """Record one rung of the recovery ladder.

        ``wall_s`` is the latency as lived (compile-inclusive if the rung
        had to trace); pass ``compile_s``/``warm_s`` when the producer
        measured the split itself — :func:`rung_timeline` prefers the
        explicit split over the first-occurrence heuristic.
        """
        if compile_s is not None:
            attrs["compile_s"] = float(compile_s)
        if warm_s is not None:
            attrs["warm_s"] = float(warm_s)
        if not self._enabled and not self._subs:
            return
        name = "recovery/" + rung
        first = self._mark_first(name)
        self._record(Event(
            name=name, kind="span",
            ts_s=time.perf_counter() - self._epoch, dur_s=float(wall_s),
            step=step if step is not None else self._step,
            first=first, attrs=attrs,
        ))

    def subscribe(self, fn: Callable[[Event], None]) -> Callable[[Event], None]:
        with self._lock:
            if fn not in self._subs:
                self._subs.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            try:
                self._subs.remove(fn)
            except ValueError:
                pass

    def enable(self, flag: bool = True) -> None:
        with self._lock:
            self._enabled = bool(flag)

    def enabled(self) -> bool:
        return self._enabled

    def set_step(self, step: Optional[int]) -> None:
        self._step = step

    def current_step(self) -> Optional[int]:
        return self._step

    def events(self) -> List[Event]:
        with self._lock:
            return list(self._events)

    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        """Clear the buffer, the drop count, the logical clock and the
        first-occurrence set (so a fresh run re-measures first-trace).
        Subscribers and the enabled flag survive a reset."""
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._seen.clear()
            self._step = None
            self._seq = 0
            self._epoch = time.perf_counter()


#: The process-global tracer every module-level helper delegates to.
TRACER = Tracer()

span = TRACER.span
event = TRACER.event
recovery = TRACER.recovery
subscribe = TRACER.subscribe
unsubscribe = TRACER.unsubscribe
enable = TRACER.enable
enabled = TRACER.enabled
set_step = TRACER.set_step
current_step = TRACER.current_step
reset = TRACER.reset
events = TRACER.events
dropped = TRACER.dropped


def stamp(name: str, **attrs) -> None:
    """Host-callback-safe instant event.

    Identical to :func:`event` but documented (and tested) as safe to
    invoke from a host callback thread: stdlib only, reentrant
    lock, no allocation of device values, never raises.
    """
    try:
        TRACER.event(name, **attrs)
    except Exception:
        pass


# ---------------------------------------------------------------------
# Timeline folds over a recorded event stream
# ---------------------------------------------------------------------

def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) — numpy-free."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def rung_timeline(evs: List[Event]) -> Dict[str, Dict[str, Any]]:
    """Per-rung MTTR stats with the compile/warm split.

    A sample lands in ``warm_s`` when the producer attached an explicit
    ``warm_s`` attr or the event is not the rung's first occurrence;
    first occurrences without an explicit split land in
    ``first_trace_s`` (compile-inclusive).  Explicit ``compile_s`` attrs
    aggregate into ``compile_s``.
    """
    per: Dict[str, Dict[str, Any]] = {}
    for e in evs:
        if not e.name.startswith("recovery/"):
            continue
        rung = e.name[len("recovery/"):]
        d = per.setdefault(rung, {"n": 0, "warm": [], "first_trace": [],
                                  "compile": []})
        d["n"] += 1
        warm = e.attrs.get("warm_s")
        comp = e.attrs.get("compile_s")
        if warm is not None:
            d["warm"].append(float(warm))
            if comp is not None:
                d["compile"].append(float(comp))
        elif e.first:
            d["first_trace"].append(e.dur_s)
        else:
            d["warm"].append(e.dur_s)
        if warm is None and comp is not None:
            d["compile"].append(float(comp))
    out: Dict[str, Dict[str, Any]] = {}
    for rung, d in per.items():
        warm, first, comp = d["warm"], d["first_trace"], d["compile"]
        out[rung] = {
            "n": d["n"],
            "warm": {
                "n": len(warm),
                "mean_s": sum(warm) / len(warm) if warm else None,
                "p50_s": percentile(warm, 50) if warm else None,
                "p95_s": percentile(warm, 95) if warm else None,
                "max_s": max(warm) if warm else None,
            },
            "first_trace": {
                "n": len(first),
                "mean_s": sum(first) / len(first) if first else None,
                "max_s": max(first) if first else None,
            },
            "compile_s": sum(comp) / len(comp) if comp else None,
        }
    return out


def lifecycles(evs: List[Event]) -> List[Dict[str, Any]]:
    """Fold the stream into inject -> detect -> rung -> repair -> verdict
    timelines.

    Pairing is by explicit ``fault_id`` attr when producers supplied one,
    else FIFO: each ``fault/detect`` attaches to the oldest open
    lifecycle without a detection, each ``recovery/*`` to the oldest
    detected-but-unrepaired one, each ``fault/verdict`` to the oldest
    without a verdict.  A lifecycle is ``complete`` once it has inject,
    detect and at least one rung.
    """
    open_: List[Dict[str, Any]] = []

    def _by_id(fid, want_missing: str) -> Optional[Dict[str, Any]]:
        for lc in open_:
            if fid is not None and lc.get("fault_id") != fid:
                continue
            if lc.get(want_missing) is None:
                return lc
        return None

    def _edict(e: Event) -> Dict[str, Any]:
        return {"ts_s": e.ts_s, "step": e.step, "dur_s": e.dur_s,
                **e.attrs}

    for e in evs:
        fid = e.attrs.get("fault_id")
        if e.name == "fault/inject":
            open_.append({"fault_id": fid, "inject": _edict(e),
                          "detect": None, "rungs": [], "verdict": None})
        elif e.name == "fault/detect":
            lc = _by_id(fid, "detect")
            if lc is None:        # detection without a recorded inject
                lc = {"fault_id": fid, "inject": None, "detect": None,
                      "rungs": [], "verdict": None}
                open_.append(lc)
            lc["detect"] = _edict(e)
        elif e.name.startswith("recovery/"):
            lc = next((c for c in open_
                       if (fid is None or c.get("fault_id") == fid)
                       and c["detect"] is not None and not c["rungs"]),
                      None)
            if lc is not None:
                lc["rungs"].append({"rung": e.name[len("recovery/"):],
                                    "first": e.first, **_edict(e)})
        elif e.name == "fault/verdict":
            lc = _by_id(fid, "verdict")
            if lc is not None:
                lc["verdict"] = _edict(e)

    out = []
    for lc in open_:
        inj, det = lc["inject"], lc["detect"]
        lc["complete"] = bool(inj and det and lc["rungs"])
        if inj and det:
            lc["detect_latency_s"] = max(0.0, det["ts_s"] - inj["ts_s"])
        if det and lc["rungs"]:
            lc["mttr_s"] = sum(r["dur_s"] for r in lc["rungs"])
        out.append(lc)
    return out
