"""Deterministic synthetic-token data pipeline with background prefetch,
exact-resume semantics, and an elastic re-split of the global batch.

Real pretraining pipelines stream tokenized shards; on this substrate the
"shards" are seeded Zipf token streams (heavy-tailed like natural text) that
are (a) fully deterministic per (seed, step), so checkpoint resume replays
the identical stream with no stored cursor beyond the step counter, and
(b) generated in a background thread so host-side batch prep overlaps device
compute (the same overlap discipline a file-backed loader needs).

Elasticity: the GLOBAL batch is the unit of determinism — `split` only
records how many DP shards it is divided over, never what it contains.
`resplit()` therefore changes the division without touching the sample
order, which is what lets a pod-loss shrink (and the later re-grow) keep
the loss trajectory step-for-step comparable to an untouched run
(the reference's elastic runtime calls it on every generation switch).

A copy of the reference package's numpy-only ``repro/data/pipeline.py``:
the same (seed, step) gives the same batch, bit for bit, in both packages.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "DataPipeline", "synthetic_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2           # heavy-tailed token distribution
    prefetch: int = 2


# config fields whose drift between save and resume silently changes the
# stream or its shape; `prefetch` is a host-side knob and may differ
_RESUME_CRITICAL = ("vocab_size", "seq_len", "global_batch", "seed", "zipf_a")


def synthetic_batch(cfg: DataConfig, step: int):
    """Batch for `step`, deterministic in (seed, step): tokens + next-token
    labels.  Stateless -> resume == replay."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % 2**31)
    raw = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = (raw - 1) % cfg.vocab_size
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


class DataPipeline:
    """Background-prefetching iterator over `synthetic_batch`.

    `state_dict()/resume()` expose exact-resume state: the step cursor, the
    current DP split extent, and the full `DataConfig` — resume VALIDATES
    the saved config against the live one, so a silently edited seq_len /
    vocab / batch between save and restore fails loudly instead of
    training on a different stream.  The checkpoint manager stores this
    dict next to the train state.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0, split: int = 1):
        if split < 1 or cfg.global_batch % split != 0:
            raise ValueError(
                f"split {split} must divide global_batch {cfg.global_batch}")
        self.cfg = cfg
        self.split = split
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self._step = step + 1
        return batch

    def batch_at(self, step: int) -> dict:
        """The global batch for an arbitrary step (bypasses the prefetch
        queue).  Rollback/elastic paths use this: after a diskless rollback
        or a reshard, the runtime replays from `step` without caring where
        the prefetch cursor was."""
        return synthetic_batch(self.cfg, step)

    @property
    def local_batch(self) -> int:
        """Per-DP-shard rows under the current split."""
        return self.cfg.global_batch // self.split

    def resplit(self, new_split: int,
                at_step: Optional[int] = None) -> "DataPipeline":
        """Re-divide the SAME global batch over `new_split` DP shards.

        The sample stream is untouched — `synthetic_batch(cfg, step)` is
        global and deterministic, so shard k of the new split is rows
        ``[k*B/new_split, (k+1)*B/new_split)`` of exactly the batch every
        earlier topology saw.  Gradient noise scale per shard changes; the
        schedule (and the loss trajectory, up to reduction order) does not.
        Returns a NEW pipeline cursored at `at_step` (default: the current
        cursor — shrink paths pass their rollback step); this one is
        closed.
        """
        step = self._step if at_step is None else at_step
        self.close()
        return DataPipeline(self.cfg, start_step=step, split=new_split)

    def state_dict(self) -> dict:
        return {"step": self._step, "seed": self.cfg.seed,
                "split": self.split,
                "config": dataclasses.asdict(self.cfg)}

    @classmethod
    def resume(cls, cfg: DataConfig, state: dict) -> "DataPipeline":
        """Rebuild from `state_dict()` output, validating that the stream
        `cfg` describes is the one the state was saved against."""
        saved = state.get("config")
        if saved is not None:
            live = dataclasses.asdict(cfg)
            drift = {k: (saved[k], live[k]) for k in _RESUME_CRITICAL
                     if saved.get(k) != live[k]}
            if drift:
                raise ValueError(
                    "resume with a drifted DataConfig (saved != live): "
                    + ", ".join(f"{k}={s!r} vs {l!r}"
                                for k, (s, l) in sorted(drift.items())))
        elif state.get("seed") != cfg.seed:
            # legacy state dicts carried only the seed
            raise ValueError("resume with a different data seed")
        return cls(cfg, start_step=state["step"],
                   split=state.get("split", 1))

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
