"""Exporters for recorded obs runs: JSONL, Prometheus text, Perfetto.

Three formats, three audiences:

  * :func:`to_jsonl` / :func:`read_jsonl` — the durable event log.  One
    JSON object per line, schema ``repro_torch.obs.event/v1``, loss-free
    round-trip of :class:`~repro_torch.obs.trace.Event`; the other two
    formats can be regenerated from it.
  * :func:`to_prometheus` — the metrics registry in the Prometheus text
    exposition format (``# HELP`` / ``# TYPE`` + samples; histograms as
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
    :func:`parse_prometheus` is the matching reader; the golden test
    round-trips through it.
  * :func:`to_perfetto` — Chrome ``trace_event`` JSON (the format both
    ``chrome://tracing`` and https://ui.perfetto.dev load): spans become
    complete events (``ph: "X"``, microsecond ``ts``/``dur``), instants
    become ``ph: "i"`` with thread scope, plus ``M`` metadata naming the
    process and threads.  :func:`validate_perfetto` checks a document
    against the schema subset we emit — the exporter golden test runs
    every recorded trace through it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs.trace import Event

__all__ = [
    "EVENT_SCHEMA", "event_dict",
    "to_jsonl", "write_jsonl", "read_jsonl",
    "to_prometheus", "parse_prometheus",
    "to_perfetto", "validate_perfetto",
]

EVENT_SCHEMA = "repro_torch.obs.event/v1"


def _jsonable(v: Any) -> Any:
    """Best-effort plain-data coercion for event attrs (numpy scalars,
    tuples, device arrays that leaked in as floats)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)
    except Exception:
        return repr(v)


def event_dict(e: Event) -> Dict[str, Any]:
    d = dataclasses.asdict(e)
    d["attrs"] = _jsonable(d["attrs"])
    return d


def to_jsonl(evs: Iterable[Event]) -> str:
    lines = [json.dumps({"schema": EVENT_SCHEMA})]
    lines += [json.dumps(event_dict(e), sort_keys=True) for e in evs]
    return "\n".join(lines) + "\n"


def write_jsonl(path: str, evs: Iterable[Event]) -> None:
    with open(path, "w") as f:
        f.write(to_jsonl(evs))


def read_jsonl(path: str) -> List[Event]:
    out: List[Event] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if i == 0 and "schema" in d and "name" not in d:
                if d["schema"] != EVENT_SCHEMA:
                    raise ValueError("unknown obs schema %r" % d["schema"])
                continue
            out.append(Event(**d))
    return out


# ---------------------------------------------------------------------
# Prometheus text exposition format
# ---------------------------------------------------------------------

def _fmt_labels(labels: Iterable, extra: Optional[Dict[str, str]] = None) -> str:
    parts = ['%s="%s"' % (k, v) for k, v in labels]
    if extra:
        parts += ['%s="%s"' % (k, v) for k, v in sorted(extra.items())]
    return "{%s}" % ",".join(parts) if parts else ""


def _fmt_num(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def to_prometheus(registry=None) -> str:
    """Render a :class:`~repro_torch.obs.metrics.Registry` (default: the global
    one) as Prometheus text format, deterministically ordered."""
    if registry is None:
        from repro_torch.obs import metrics
        registry = metrics.REGISTRY
    lines: List[str] = []
    for inst in registry.instruments():
        if inst.help:
            lines.append("# HELP %s %s" % (inst.name, inst.help))
        lines.append("# TYPE %s %s" % (inst.name, inst.kind))
        if inst.kind == "histogram":
            for key, snap in inst.samples():
                for le, cum in zip(snap["buckets"] + [float("inf")],
                                   snap["cumulative"]):
                    le_s = "+Inf" if le == float("inf") else _fmt_num(le)
                    lines.append("%s_bucket%s %s" % (
                        inst.name, _fmt_labels(key, {"le": le_s}),
                        _fmt_num(cum)))
                lines.append("%s_sum%s %s" % (
                    inst.name, _fmt_labels(key), _fmt_num(snap["sum"])))
                lines.append("%s_count%s %s" % (
                    inst.name, _fmt_labels(key), _fmt_num(snap["count"])))
        else:
            for key, v in inst.samples():
                lines.append("%s%s %s" % (inst.name, _fmt_labels(key),
                                          _fmt_num(v)))
    return "\n".join(lines) + "\n"


def _parse_labels(s: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    s = s.strip()
    if not s:
        return out
    for part in s.split(","):
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return out


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse the subset of the text format :func:`to_prometheus` emits.

    Returns ``{metric_name: {"type": ..., "help": ..., "samples":
    [{"name", "labels", "value"}, ...]}}`` where histogram ``_bucket`` /
    ``_sum`` / ``_count`` series fold under their base metric name.
    """
    out: Dict[str, Dict[str, Any]] = {}

    def base_of(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            stem = sample_name[:-len(suffix)] if sample_name.endswith(suffix) else None
            if stem and stem in out and out[stem]["type"] == "histogram":
                return stem
        return sample_name

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "", "samples": []})
            out[name]["help"] = help_
        elif line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "", "samples": []})
            out[name]["type"] = kind.strip()
        elif line.startswith("#"):
            continue
        else:
            if "{" in line:
                name = line[:line.index("{")]
                labels = _parse_labels(line[line.index("{") + 1:line.rindex("}")])
                value = float(line[line.rindex("}") + 1:].strip())
            else:
                name, _, v = line.rpartition(" ")
                labels, value = {}, float(v)
            base = base_of(name)
            out.setdefault(base, {"type": "untyped", "help": "", "samples": []})
            out[base]["samples"].append(
                {"name": name, "labels": labels, "value": value})
    return out


# ---------------------------------------------------------------------
# Chrome / Perfetto trace_event JSON
# ---------------------------------------------------------------------

_PID = 1  # single-process trace


def to_perfetto(evs: List[Event], process_name: str = "repro") -> Dict[str, Any]:
    """Render events as a ``trace_event`` JSON document.

    Spans map to complete events (``ph: "X"`` with ``ts``/``dur`` in
    microseconds); instants to ``ph: "i"`` thread-scoped.  Raw thread
    ids remap to small integers in first-seen order so the document is
    deterministic across runs.  The logical step rides in ``args.step``
    alongside the event attrs, as do ``span_id`` and ``parent_id``.
    """
    tids: Dict[int, int] = {}
    trace_events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    for e in evs:
        tid = tids.setdefault(e.tid, len(tids) + 1)
        args: Dict[str, Any] = {"seq": e.seq}
        if e.span_id is not None:
            args["span_id"] = e.span_id
        if e.parent_id is not None:
            args["parent_id"] = e.parent_id
        if e.step is not None:
            args["step"] = e.step
        if e.first:
            args["first_trace"] = True
        if not e.ok:
            args["error"] = True
        args.update(_jsonable(e.attrs))
        cat = e.name.split("/", 1)[0]
        rec: Dict[str, Any] = {
            "name": e.name, "cat": cat, "pid": _PID, "tid": tid,
            "ts": round(e.ts_s * 1e6, 3), "args": args,
        }
        if e.kind == "span":
            rec["ph"] = "X"
            rec["dur"] = round(max(e.dur_s, 0.0) * 1e6, 3)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        trace_events.append(rec)
    for raw, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        trace_events.append({
            "ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
            "args": {"name": "obs-%d" % tid},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"schema": EVENT_SCHEMA}}


def validate_perfetto(doc: Any) -> int:
    """Validate a document against the ``trace_event`` schema subset we
    emit; returns the number of non-metadata events.  Raises
    :class:`ValueError` on the first violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("perfetto doc must be an object with traceEvents")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    n = 0
    for i, e in enumerate(evs):
        where = "traceEvents[%d]" % i
        if not isinstance(e, dict):
            raise ValueError("%s: not an object" % where)
        ph = e.get("ph")
        if ph not in ("X", "i", "B", "E", "M"):
            raise ValueError("%s: unsupported ph %r" % (where, ph))
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError("%s: missing name" % where)
        if not isinstance(e.get("pid"), int) or not isinstance(e.get("tid"), int):
            raise ValueError("%s: pid/tid must be ints" % where)
        if ph == "M":
            if not isinstance(e.get("args"), dict):
                raise ValueError("%s: metadata needs args" % where)
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError("%s: ts must be a non-negative number" % where)
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError("%s: X event needs non-negative dur" % where)
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            raise ValueError("%s: i event needs scope s in t/p/g" % where)
        n += 1
    return n
