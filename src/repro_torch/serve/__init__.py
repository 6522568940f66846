"""Serving layer: the fault-tolerant continuous-batching engines
(`serve.engine`), the paged KV cache with per-page checksums
(`serve.paged_kv`), the SLO scheduler with admission control and aging
(`serve.scheduler`), and the deterministic load harness behind the
SLO-under-fault numbers (`serve.traffic`)."""
from repro_torch.serve.engine import (EngineStats, PagedServeEngine, Request,
                                      ScrubEvent, SDCEvent, ServeEngine)
from repro_torch.serve.paged_kv import PagedKVCache, PagedStats
from repro_torch.serve.scheduler import SchedPolicy, SchedStats, SLOScheduler
from repro_torch.serve.traffic import (TraceItem, TrafficConfig, TrafficReport,
                                       compare, make_trace, run_trace)

__all__ = [
    "Request", "ServeEngine", "PagedServeEngine", "EngineStats",
    "SDCEvent", "ScrubEvent",
    "PagedKVCache", "PagedStats",
    "SLOScheduler", "SchedPolicy", "SchedStats",
    "TrafficConfig", "TraceItem", "TrafficReport", "make_trace",
    "run_trace", "compare",
]
