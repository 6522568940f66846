"""SLO-aware request scheduling: admission control, priorities, aging.

The counterpart of the reference package's ``repro/serve/scheduler.py``,
pure Python and host-side like it.

`SLOScheduler` replaces the engine's plain FIFO deque when passed to
`PagedServeEngine(scheduler=...)`.  Three mechanisms, all host-side and
engine-agnostic:

  * **admission control** — `SchedPolicy.max_queue` bounds the queue;
    `submit()` returns False for a rejected request instead of letting an
    unbounded backlog destroy every queued request's TTFT (the engine
    records rejections in ``engine.rejected``).
  * **priority queues** — ``n_priorities`` classes, 0 highest.  With every
    request at the default priority the scheduler degenerates to exact
    FIFO (submission order breaks ties), so it drops into the engine
    without changing clean-path behavior.
  * **aging (the starvation bound)** — a request's *effective* priority is
    ``priority - floor(wait / age_boost_s)``: every ``age_boost_s`` of
    waiting raises it one class.  A request at class p therefore outranks
    every FRESH class-0 arrival once it has waited more than
    ``p * age_boost_s`` — `queue_age_bound_s` returns that bound + one
    boost quantum, and tests/test_torch_scheduler.py drives a
    priority-inversion flood against it with a fake clock.

The clock is injectable (``clock=``) so fairness properties are tested
deterministically; the default is `time.perf_counter`.

Chunked prefill lives in the ENGINE (`PagedServeEngine(chunk_prefill=C)`),
not here: the scheduler decides *which* request is admitted next, the
engine guarantees a running decode step is never delayed by more than one
chunk of prefill work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch import obs

__all__ = ["SchedPolicy", "SchedStats", "SLOScheduler"]


@dataclasses.dataclass(frozen=True)
class SchedPolicy:
    max_queue: int = 0          # queued-request bound; 0 = unbounded
    n_priorities: int = 3       # classes 0 (highest) .. n-1 (lowest)
    age_boost_s: float = 0.5    # wait per one-class priority boost
    default_priority: int = 0   # class for submit(priority=None)


@dataclasses.dataclass
class SchedStats:
    submitted: int = 0
    rejected: int = 0
    popped: int = 0
    max_wait_s: float = 0.0
    waits_s: List[float] = dataclasses.field(default_factory=list)

    def mean_wait_s(self) -> float:
        return sum(self.waits_s) / len(self.waits_s) if self.waits_s else 0.0


@dataclasses.dataclass
class _Entry:
    req: object
    priority: int
    t: float
    seq: int


class SLOScheduler:
    def __init__(self, policy: Optional[SchedPolicy] = None, *,
                 clock: Callable[[], float] = time.perf_counter):
        self.policy = policy or SchedPolicy()
        self.clock = clock
        self.stats = SchedStats()
        self._items: List[_Entry] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._items)

    def queue_age_bound_s(self, priority: Optional[int] = None) -> float:
        """Upper bound on how long a queued request of the given class can
        wait behind an unbounded stream of fresh higher-priority arrivals:
        after ``priority * age_boost_s`` its effective priority beats any
        fresh class-0 request, plus one boost quantum of slack for the
        discrete floor."""
        p = self._clamp(priority)
        return (p + 1) * self.policy.age_boost_s

    def _clamp(self, priority: Optional[int]) -> int:
        if priority is None:
            priority = self.policy.default_priority
        return max(0, min(int(priority), self.policy.n_priorities - 1))

    def submit(self, req, priority: Optional[int] = None) -> bool:
        """Queue ``req``; False = rejected by admission control."""
        self.stats.submitted += 1
        obs.counter("repro_sched_submitted_total",
                    "requests offered to the scheduler").inc()
        if self.policy.max_queue and len(self._items) >= self.policy.max_queue:
            self.stats.rejected += 1
            obs.counter("repro_sched_rejected_total",
                        "admission-control rejections").inc()
            obs.event("sched/reject", queue_depth=len(self._items))
            return False
        self._items.append(_Entry(req, self._clamp(priority),
                                  self.clock(), self._seq))
        self._seq += 1
        obs.gauge("repro_queue_depth",
                  "scheduler queue depth").set(len(self._items))
        return True

    def effective_priority(self, entry: _Entry, now: float) -> int:
        boost = (int((now - entry.t) / self.policy.age_boost_s)
                 if self.policy.age_boost_s > 0 else 0)
        return entry.priority - boost

    def peek(self):
        e = self._best()
        return e.req if e is not None else None

    def _best(self) -> Optional[_Entry]:
        if not self._items:
            return None
        now = self.clock()
        # O(n) scan keeps aging exact at pop time (a heap would freeze the
        # priority at push time); queues of thousands stay sub-ms
        return min(self._items,
                   key=lambda e: (self.effective_priority(e, now), e.seq))

    def pop(self):
        e = self._best()
        if e is None:
            return None
        self._items.remove(e)
        wait = self.clock() - e.t
        self.stats.popped += 1
        self.stats.waits_s.append(wait)
        self.stats.max_wait_s = max(self.stats.max_wait_s, wait)
        obs.counter("repro_sched_popped_total",
                    "requests admitted from the queue").inc()
        obs.histogram("repro_queue_wait_seconds",
                      "queue wait from submit to admission").observe(wait)
        obs.gauge("repro_queue_depth",
                  "scheduler queue depth").set(len(self._items))
        return e.req
