"""Hierarchical tracing bus on the step / decode-step clock.

This is the repo's single telemetry seam: every producer (the elastic
trainer, the serving engines, the scheduler, the chaos campaign, the
kernel dispatchers) publishes **events** into one process-global
:class:`Tracer`, and every consumer (the chaos campaign's per-spec
collector, the straggler detector, the exporters in
:mod:`repro_torch.obs.export`) attaches through ``obs.subscribe(on_event)``.
The private stats structs that predate the bus (``EngineStats``,
``ElasticReport``, ``SchedStats``, campaign rows) keep their public APIs
but are views over the same happenings.  This module began as a copy of
the reference package's ``repro/obs/trace.py``; the port's bus adds the
no-op span, the shared epoch, span identity and the device clock.

Design constraints, in order:

  * **zero dependencies** — stdlib only; in particular no torch import.
    A device clock is a hook (:func:`set_device_clock`) that another
    module provides (``repro_torch.obs.cuda`` on a CUDA card).
  * **off means off** — with recording disabled and no subscribers,
    :func:`span` returns one shared no-op context manager (no stack, no
    lock, no clock read) and :func:`event`, :func:`recovery` and
    :func:`tally` return at their first branch.
  * **clocks** — every event carries a wall timestamp (``ts_s``, seconds
    of ``time.perf_counter`` since :func:`epoch`, so ``ts_s + epoch()``
    lies on the host's ``perf_counter`` clock, the clock a device trace
    is put on through a marker) *and* an optional logical ``step`` (train
    step or decode step).  Producers either pass ``step=`` explicitly or
    let the event inherit the tracer's current logical clock
    (:func:`set_step`).  A span opened with ``device=True`` is timed on
    the device as well, where a device clock is installed and recording
    is on: a marker on the device's stream at entry and at exit, read by
    :func:`resolve_device` into ``attrs["device_s"]`` once the device
    has passed both.
  * **identity** — each span gets a ``span_id`` on entry and records its
    parent's (``parent_id``) beside the parent's name, so the spans of
    one call group under its root.  Counts of the work a span does go
    into its attrs where the work happens (:meth:`_Span.set` on the span,
    :func:`tally` from code below a span that was opened with the count's
    key).
  * **first-trace separation** — the first recorded occurrence of each
    span name in the process is flagged ``first=True``.  Compile or
    kernel-build time rides the first occurrence (that is what
    "first-trace pollution" means), so :func:`rung_timeline` splits
    compile-inclusive from warm samples by this flag unless the producer
    measured the split itself and attached explicit ``compile_s`` /
    ``warm_s`` attrs (as ``ElasticReport`` and the campaign's warm
    re-measures do).

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
  ``straggler/trip``, ``scrub/sweep``, ``kernel/trace``;
  ``summa/*``, ``detect/locate_and_correct`` — the fault-tolerant SUMMA
      product's parts (``core/summa.py``, ``core/detect.py``), under one
      ``summa/abft_summa`` root a product.

:func:`lifecycles` folds a recorded event stream back into complete
inject -> detect -> rung -> repair -> verdict timelines.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Event", "Tracer", "TRACER",
    "span", "event", "recovery", "tally", "NO_SPAN",
    "subscribe", "unsubscribe", "enable", "enabled",
    "set_step", "current_step", "reset", "events", "dropped",
    "epoch", "set_device_clock", "resolve_device",
    "rung_timeline", "lifecycles", "percentile",
]


@dataclasses.dataclass
class Event:
    """One happening on the bus.

    ``ts_s`` is seconds since the tracer epoch (``perf_counter`` based,
    monotonic; ``ts_s + epoch()`` is the ``perf_counter`` reading);
    ``dur_s`` is zero for instant events.  ``first`` marks the first
    occurrence of this name in the process — the compile-inclusive
    sample for jit-backed spans.  ``span_id`` names a span (None for an
    instant); ``parent`` and ``parent_id`` name the span open around the
    event on its thread.
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
    span_id: Optional[int] = None
    parent_id: Optional[int] = None


class _NoSpan:
    """The span of a bus that records nothing: one shared instance, which
    does nothing on entry, exit or :meth:`set`."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


#: What :func:`span` returns while the bus records nothing.
NO_SPAN = _NoSpan()


class _Span:
    """Context manager recording a span event on exit (even on raise)."""

    __slots__ = ("_tracer", "name", "step", "attrs", "span_id", "_device",
                 "_t0", "_first", "_parent", "_parent_id", "_mark0")

    def __init__(self, tracer: "Tracer", name: str, step: Optional[int],
                 device: bool, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.step = step
        self._device = device
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add counts or facts found inside the span to its attrs."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        up = stack[-1] if stack else None
        self._parent = up.name if up is not None else None
        self._parent_id = up.span_id if up is not None else None
        self.span_id = next(tr._ids)
        stack.append(self)
        self._first = tr._mark_first(self.name)
        clock = tr._clock
        self._mark0 = ((clock, clock.mark()) if self._device
                       and clock is not None and tr._enabled else None)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        marks = None
        if self._mark0 is not None:
            clock, mark0 = self._mark0
            marks = (clock, mark0, clock.mark())
        stack = tr._stack()
        # Pop back to (and including) our own frame even if an inner span
        # leaked — ordering under exceptions stays consistent.
        while stack and stack.pop() is not self:
            pass
        tr._record(Event(
            name=self.name, kind="span",
            ts_s=self._t0 - tr._epoch, dur_s=t1 - self._t0,
            step=self.step if self.step is not None else tr._step,
            first=self._first, ok=exc_type is None,
            parent=self._parent, attrs=self.attrs,
            span_id=self.span_id, parent_id=self._parent_id,
        ), marks)
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
        self._ids = itertools.count(1)
        self._clock = None
        self._pending: List[tuple] = []   # (event, clock, mark, mark)

    # -- span stack (per thread) -------------------------------------
    def _stack(self) -> List[_Span]:
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
    def _record(self, ev: Event, marks: Optional[tuple] = None) -> None:
        with self._lock:
            if not self._enabled and not self._subs:
                return
            self._seq += 1
            ev.seq = self._seq
            ev.tid = threading.get_ident()
            if self._enabled:
                if len(self._events) < self.max_events:
                    self._events.append(ev)
                    if marks is not None:
                        self._pending.append((ev,) + marks)
                else:
                    self._dropped += 1
            subs = tuple(self._subs)
        for fn in subs:
            fn(ev)

    # -- public API ---------------------------------------------------
    def span(self, name: str, step: Optional[int] = None,
             device: bool = False, **attrs):
        """A span: ``with tracer.span(name, **attrs) as sp: ...``.
        ``device=True`` times it on the device too (module docstring).
        With recording off and no subscriber: :data:`NO_SPAN`."""
        if not self._enabled and not self._subs:
            return NO_SPAN
        return _Span(self, name, step, device, attrs)

    def event(self, name: str, step: Optional[int] = None,
              dur_s: float = 0.0, **attrs) -> None:
        if not self._enabled and not self._subs:
            return
        first = self._mark_first(name)
        stack = self._stack()
        up = stack[-1] if stack else None
        self._record(Event(
            name=name, kind="instant",
            ts_s=time.perf_counter() - self._epoch, dur_s=dur_s,
            step=step if step is not None else self._step,
            first=first, attrs=attrs,
            parent=up.name if up is not None else None,
            parent_id=up.span_id if up is not None else None,
        ))

    def tally(self, key: str, n: int = 1) -> None:
        """Add ``n`` to ``attrs[key]`` of the innermost span open on this
        thread that was opened with ``key`` (``obs.span(name, key=0)``): a
        count made where the work happens, below the code that asked for
        it.  Outside such a span, and while the bus records nothing, the
        count goes nowhere."""
        if not self._enabled and not self._subs:
            return
        for sp in reversed(getattr(self._tls, "stack", None) or ()):
            if key in sp.attrs:
                sp.attrs[key] += n
                return

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

    def epoch(self) -> float:
        """The ``time.perf_counter`` reading that ``ts_s = 0`` stands for."""
        return self._epoch

    def set_device_clock(self, clock) -> None:
        """Install (or, with None, remove) the device clock of
        ``device=True`` spans: an object with ``mark()``, which places a
        marker on the device's stream and returns it, and ``elapsed_s(a,
        b)``, the device seconds from marker ``a`` to marker ``b`` (it may
        wait for the device to pass ``b``)."""
        with self._lock:
            self._clock = clock

    def resolve_device(self) -> int:
        """Write the device seconds of every recorded ``device=True`` span
        not yet resolved into its ``attrs["device_s"]``; call after the
        device has passed them (a synchronize).  Returns how many."""
        with self._lock:
            pending, self._pending = self._pending, []
        for ev, clock, a, b in pending:
            ev.attrs["device_s"] = clock.elapsed_s(a, b)
        return len(pending)

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
        """Clear the buffer, the drop count, the logical clock, the
        first-occurrence set (so a fresh run re-measures first-trace) and
        the unresolved device spans, and restart the epoch.  Subscribers,
        the enabled flag and the device clock survive a reset."""
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._seen.clear()
            self._step = None
            self._seq = 0
            self._epoch = time.perf_counter()
            self._pending.clear()


#: The process-global tracer every module-level helper delegates to.
TRACER = Tracer()

span = TRACER.span
event = TRACER.event
recovery = TRACER.recovery
tally = TRACER.tally
subscribe = TRACER.subscribe
unsubscribe = TRACER.unsubscribe
enable = TRACER.enable
enabled = TRACER.enabled
set_step = TRACER.set_step
current_step = TRACER.current_step
reset = TRACER.reset
events = TRACER.events
dropped = TRACER.dropped
epoch = TRACER.epoch
set_device_clock = TRACER.set_device_clock
resolve_device = TRACER.resolve_device


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
