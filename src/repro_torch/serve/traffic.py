"""Traffic generation + SLO measurement for the serving engines.

The counterpart of the reference package's ``repro/serve/traffic.py``:
build a deterministic request **trace** — Zipf-distributed prompt/output
lengths, optional shared system prompt, optional priority classes, and
arrivals that are either **closed-loop** (everything queued up front; the
backlog drains as fast as the engine goes) or **open-loop** (Poisson
arrivals measured in DECODE-STEP units, so replaying the same trace against
a drilled engine injects faults into the *identical* workload — wall-clock
arrival jitter can't decorrelate the two runs) — then replay it and report
p50/p99 TTFT, throughput, and the engine's fault accounting.

`make_trace` draws from ``np.random.RandomState`` exactly as the reference
does, so both packages replay the same trace item for item.  `run_trace`
drives any `ServeEngine`-compatible engine; `compare` turns a clean + a
drilled report into the SLO-under-fault numbers (p99 TTFT degradation
while SDCs are corrected mid-decode).  The chaos campaign's ``traffic``
workload and ``launch/obs.py``'s recorder replay traces through the same
two functions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs

__all__ = ["TrafficConfig", "TraceItem", "make_trace", "run_trace",
           "TrafficReport", "compare"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 64
    vocab: int = 512
    arrival: str = "closed"        # "closed" | "open"
    rate_per_step: float = 0.5     # open loop: mean arrivals per decode step
    zipf_a: float = 1.8            # length-distribution exponent (heavy tail)
    prompt_min: int = 4
    prompt_max: int = 40
    out_min: int = 2
    out_max: int = 12
    shared_prefix_len: int = 0     # shared system-prompt tokens (prefix cache)
    n_priorities: int = 1          # >1: priorities drawn uniformly
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ("closed", "open"):
            raise ValueError(f"unknown arrival mode {self.arrival!r}")


@dataclasses.dataclass(frozen=True)
class TraceItem:
    rid: int
    prompt: tuple
    max_new: int
    priority: int
    arrive_step: int               # decode-step the request becomes visible


def _zipf_len(rng, a: float, lo: int, hi: int) -> int:
    """Zipf-tailed length in [lo, hi]: most requests short, a heavy tail
    of long ones — the realistic shape batch schedulers must survive."""
    return min(lo + int(rng.zipf(a)) - 1, hi)


def make_trace(cfg: TrafficConfig) -> List[TraceItem]:
    """Deterministic in ``cfg`` (seed included): the SAME trace replays
    byte-for-byte under clean and drilled engines."""
    rng = np.random.RandomState(cfg.seed)
    shared = rng.randint(0, cfg.vocab, cfg.shared_prefix_len).tolist() \
        if cfg.shared_prefix_len else []
    items = []
    step = 0.0
    for rid in range(cfg.n_requests):
        plen = _zipf_len(rng, cfg.zipf_a, cfg.prompt_min, cfg.prompt_max)
        plen = max(plen, cfg.shared_prefix_len + 1)  # >= 1 suffix token
        n_new = _zipf_len(rng, cfg.zipf_a, cfg.out_min, cfg.out_max)
        body = rng.randint(0, cfg.vocab, plen - len(shared)).tolist()
        pri = int(rng.randint(0, cfg.n_priorities)) \
            if cfg.n_priorities > 1 else 0
        if cfg.arrival == "open":
            step += rng.exponential(1.0 / cfg.rate_per_step)
        items.append(TraceItem(rid=rid, prompt=tuple(shared + body),
                               max_new=n_new, priority=pri,
                               arrive_step=int(step)))
    return items


@dataclasses.dataclass
class TrafficReport:
    n_requests: int = 0
    n_finished: int = 0
    n_rejected: int = 0
    wall_s: float = 0.0
    decode_steps: int = 0
    total_tokens: int = 0
    tok_per_s: float = 0.0
    p50_ttft_ms: float = 0.0
    p99_ttft_ms: float = 0.0
    mean_ttft_ms: float = 0.0
    detections: int = 0
    corrections: int = 0
    sdc_events: int = 0
    sdc_corrected: int = 0
    scrub_checks: int = 0
    scrub_repairs: int = 0
    prefix_hits: int = 0
    outputs: Dict[int, List[int]] = dataclasses.field(default_factory=dict)

    def asdict(self, with_outputs: bool = False) -> dict:
        d = dataclasses.asdict(self)
        if not with_outputs:
            d.pop("outputs")
        return d


def _percentile_ms(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) * 1e3 if xs else 0.0


def run_trace(engine, trace: List[TraceItem], *,
              on_step=None, max_steps: int = 200_000) -> TrafficReport:
    """Replay a trace to completion.  Open-loop arrivals are released when
    ``engine.stats.decode_steps`` reaches their ``arrive_step`` (the
    deterministic arrival clock); ``on_step`` chains a chaos hook."""
    from repro_torch.serve.engine import Request

    items = sorted(trace, key=lambda it: (it.arrive_step, it.rid))
    i = 0
    n = len(items)

    def _submit_due(eng):
        nonlocal i
        while i < n and items[i].arrive_step <= eng.stats.decode_steps:
            it = items[i]
            req = Request(rid=it.rid, prompt=list(it.prompt),
                          max_new_tokens=it.max_new)
            try:
                eng.submit(req, priority=it.priority)
            except TypeError:          # plain ServeEngine: no priorities
                eng.submit(req)
            i += 1

    def hook(eng, step):
        _submit_due(eng)
        if on_step is not None:
            on_step(eng, step)

    finished = []
    with obs.span("serve/run_trace", n_requests=n):
        t0 = time.perf_counter()
        while True:
            _submit_due(engine)
            finished += engine.run(max_steps=max_steps, on_step=hook)
            if i >= n:
                break
            # the engine drained before the next open-loop arrival was due:
            # idle time passes instantly, the arrival clock jumps forward
            engine.stats.decode_steps = max(engine.stats.decode_steps,
                                            items[i].arrive_step)
        wall = time.perf_counter() - t0

    s = engine.stats
    rejected = list(getattr(engine, "rejected", []))
    ttfts = [r.ttft_s for r in finished if r.ttft_s is not None]
    total_tokens = sum(len(r.output) for r in finished)
    kv = getattr(engine, "kv", None)
    return TrafficReport(
        n_requests=n,
        n_finished=len(finished),
        n_rejected=len(rejected),
        wall_s=wall,
        decode_steps=s.decode_steps,
        total_tokens=total_tokens,
        tok_per_s=total_tokens / wall if wall > 0 else 0.0,
        p50_ttft_ms=_percentile_ms(ttfts, 50),
        p99_ttft_ms=_percentile_ms(ttfts, 99),
        mean_ttft_ms=_percentile_ms(ttfts, 50) if not ttfts else
        float(np.mean(ttfts)) * 1e3,
        detections=s.detections,
        corrections=s.corrections,
        sdc_events=len(s.events),
        sdc_corrected=sum(1 for e in s.events if e.corrected),
        scrub_checks=s.scrub_checks,
        scrub_repairs=sum(1 for e in s.scrub_events if e.repaired),
        prefix_hits=kv.stats.prefix_hits if kv is not None else 0,
        outputs={r.rid: list(r.output) for r in finished},
    )


def compare(clean: TrafficReport, fault: TrafficReport, *,
            expected_faults: Optional[int] = None) -> dict:
    """The SLO-under-fault numbers: p99/p50 TTFT and throughput
    degradation of the drilled replay vs the clean run of the SAME trace,
    plus the zero-missed accounting (every injected fault must have been
    detected)."""
    def pct(a, b):
        return 100.0 * (a / b - 1.0) if b > 0 else 0.0

    injected = (fault.sdc_events + fault.scrub_repairs
                if expected_faults is None else expected_faults)
    detected = fault.detections
    return {
        "p50_ttft_degradation_pct": pct(fault.p50_ttft_ms,
                                        clean.p50_ttft_ms),
        "p99_ttft_degradation_pct": pct(fault.p99_ttft_ms,
                                        clean.p99_ttft_ms),
        "tok_per_s_degradation_pct": pct(clean.tok_per_s, fault.tok_per_s),
        "faults_injected": injected,
        "faults_detected": detected,
        "faults_corrected": fault.corrections,
        "faults_missed": max(injected - detected, 0),
        "token_streams_identical": clean.outputs == fault.outputs,
    }
