"""Process-global metrics registry: counters, gauges, histograms.

The numeric side of the obs bus.  Where :mod:`repro_torch.obs.trace` answers
"what happened, when, in what order", this module answers "how many and
how much" — detections, corrections, false alarms, residual magnitudes,
checksum-verify walls, queue depths, prefix-hit ratios, tokens/s — in a
shape :func:`repro_torch.obs.export.to_prometheus` can serialize straight into
the Prometheus text exposition format.

Zero dependencies, deterministic: instruments iterate in registration
order and label sets sort lexicographically, so two identical runs
produce byte-identical snapshots (``tests/test_obs.py`` asserts this).
Instruments are get-or-create — ``counter("x")`` from two modules
returns the same object; re-registering a name as a different type
raises.

Naming follows Prometheus conventions: ``repro_<noun>_total`` for
counters, ``_seconds`` suffix for time histograms.  The canonical
instrument names live with their producers (grep ``obs.counter`` /
``obs.histogram``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset",
    "DEFAULT_BUCKETS",
]

#: Default histogram buckets, in seconds — spans µs-scale checksum
#: verifies through multi-second elastic rebuilds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def _sorted(self, d: Dict[LabelKey, Any]) -> List[Tuple[LabelKey, Any]]:
        return sorted(d.items())


class Counter(_Instrument):
    """Monotone counter; ``inc()`` with optional labels."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counter can only increase: %r" % amount)
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return self._sorted(self._values)


class Gauge(_Instrument):
    """Point-in-time value; ``set()`` / ``inc()`` / ``dec()``."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return self._sorted(self._values)


class Histogram(_Instrument):
    """Cumulative-bucket histogram in the Prometheus style."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        # per label set: (per-bucket non-cumulative counts + inf, sum, n)
        self._values: Dict[LabelKey, List[Any]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._values[key] = st
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    idx = i
                    break
            st[0][idx] += 1
            st[1] += v
            st[2] += 1

    def snapshot_one(self, **labels) -> Optional[Dict[str, Any]]:
        st = self._values.get(_label_key(labels))
        if st is None:
            return None
        return self._render(st)

    def _render(self, st) -> Dict[str, Any]:
        cum, acc = [], 0
        for c in st[0]:
            acc += c
            cum.append(acc)
        return {"buckets": list(self.buckets), "cumulative": cum[:-1] + [acc],
                "sum": st[1], "count": st[2]}

    def samples(self) -> List[Tuple[LabelKey, Dict[str, Any]]]:
        with self._lock:
            return [(k, self._render(st)) for k, st in self._sorted(self._values)]


class Registry:
    """Ordered name -> instrument map with get-or-create semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: "OrderedDict[str, _Instrument]" = OrderedDict()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        "instrument %r already registered as %s, not %s"
                        % (name, inst.kind, cls.kind))
                return inst
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> "OrderedDict[str, Any]":
        """Deterministic plain-data dump (JSON-ready)."""
        out: "OrderedDict[str, Any]" = OrderedDict()
        for inst in self.instruments():
            out[inst.name] = {
                "kind": inst.kind,
                "help": inst.help,
                "samples": [
                    {"labels": dict(k), "value": v}
                    for k, v in inst.samples()
                ],
            }
        return out

    def reset(self) -> None:
        """Drop every instrument (fresh-run semantics for tests/CLIs)."""
        with self._lock:
            self._instruments.clear()


#: The process-global registry all module-level helpers delegate to.
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
