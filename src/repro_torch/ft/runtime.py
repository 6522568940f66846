"""Fault-tolerant training runtime: the paper's recovery timeline (§3.3) as
a training-loop wrapper.

`FTRuntime` wraps the cheap rungs of the recovery ladder around a
caller-built step function: in-step ABFT (the checksums fused into the
protected projections, compiled into the step by `StepOptions.abft_mode`)
and the diskless rollback (a lost DP shard rebuilt from the checksums of
`ckpt.diskless`, bounded rollback to the last encode, no disk), with the
disk restore as the fallback when more than `f` shards are lost.

The DP axis is simulated on one device as ``p`` logical shards: the
stacked view of `stack_view` splits each leaf's leading axis by ``p``.  The
reference stacks each layout group's layers on axis 0; the port keeps
per-layer lists, so `stack_view` stacks them first and logical shard i of a
group of R layers holds layers ``i R/p .. (i+1) R/p - 1``, as in the
reference.

Counterpart of the reference package's ``repro/ft/runtime.py``; its
`ElasticRuntime` (pod loss, re-grow, straggler demotion, at-rest scrub)
comes with the elastic slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.ckpt.diskless import DisklessCheckpoint
from repro_torch.ft.failures import FailureInjector
from repro_torch.tree import tree_map

__all__ = ["FTPolicy", "FTRuntime", "stack_view", "unstack_view"]

_ELASTIC = "ElasticRuntime (distribution + elastic FT, see ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class FTPolicy:
    """Recovery-budget knobs for `FTRuntime`: `diskless_every` is the
    checksum-encode cadence (steps), `disk_every` the async disk-snapshot
    cadence (the fallback when more than `f` shards die at once), `f` the
    simultaneous failures the diskless encoding survives."""
    diskless_every: int = 10
    disk_every: int = 100
    f: int = 1


def _is_layer_list(node) -> bool:
    return isinstance(node, list) and bool(node) \
        and all(isinstance(e, dict) for e in node)


def _stack_layers(node):
    """Per-layer lists of dicts -> one dict of stacked [R, ...] leaves (the
    reference's layout); every other leaf is copied."""
    if _is_layer_list(node):
        return tree_map(lambda *xs: torch.stack(xs), node[0], *node[1:])
    if isinstance(node, dict):
        return {k: _stack_layers(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_stack_layers(x) for x in node)
    return node.clone() if isinstance(node, torch.Tensor) else node


def stack_view(state, p: int):
    """The state as ``p`` logical DP shards: per-layer lists stacked into
    the reference's ``[R, ...]`` leaves, then every floating leaf whose
    leading extent ``p`` divides viewed as ``[p, extent / p, ...]``.

    The per-layer lists cannot be stacked in place, so this is a copy of the
    state, made once: every tensor of the result is new, and a
    `DisklessCheckpoint` may keep it as its snapshot without another copy
    (``encode(..., owned=True)``, which `FTRuntime.maybe_checkpoint` does
    when handed a function that builds the view)."""
    def split(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                and x.shape[0] % p == 0 and x.is_floating_point():
            return x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:]))
        return x
    return tree_map(split, _stack_layers(state))


def unstack_view(stacked, like):
    """Inverse of `stack_view` against the port's state ``like``: stacked
    group leaves go back to per-layer lists (views of the stacked tensors),
    split leaves to ``like``'s shapes."""
    if _is_layer_list(like):
        n = len(like)
        return [tree_map(
            lambda s, l, r=r: s.reshape((n,) + tuple(l.shape))[r],
            stacked, like[r]) for r in range(n)]
    if isinstance(like, dict):
        return {k: unstack_view(stacked[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(unstack_view(s, l) for s, l in zip(stacked, like))
    if tuple(stacked.shape) != tuple(like.shape):
        return stacked.reshape(like.shape)
    return stacked


def _sync() -> None:
    """Wait for the card, so that a host wall covers the device work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _pub_rung(rung: str, wall_s: float, step: Optional[int] = None,
              **attrs) -> None:
    """Publish one recovery-ladder firing to the obs bus: the
    ``repro_recoveries_total{rung=...}`` counter and a ``recovery/<rung>``
    span carrying the measured wall."""
    obs.counter("repro_recoveries_total",
                "recovery-ladder rungs fired").inc(rung=rung)
    obs.recovery(rung, wall_s, step=step, **attrs)


class FTRuntime:
    """Wraps a step function with failure detection and recovery.

    ``timings`` holds host walls (device synchronized around each) of every
    diskless encode, disk save (the host copy; the write runs in the
    background) and recovery."""

    def __init__(self, p: int, policy: FTPolicy,
                 injector: Optional[FailureInjector] = None,
                 ckpt_manager=None, sdc_injector=None):
        if sdc_injector is not None:
            raise NotImplementedError(f"SDC drills come with {_ELASTIC}")
        self.p = p
        self.policy = policy
        # one FailureInjector or a sequence of them; every injector is
        # drained each step and same-step failures recover jointly
        if injector is None:
            self.injectors: Tuple[FailureInjector, ...] = ()
        elif isinstance(injector, FailureInjector):
            self.injectors = (injector,)
        else:
            self.injectors = tuple(injector)
        self.ckpt = ckpt_manager
        self.diskless = DisklessCheckpoint(p, policy.f)
        self.recoveries = {"diskless": 0, "disk": 0, "sdc": 0}
        self.timings = {"encode": [], "save": [], "recover": []}

    @property
    def injector(self) -> Optional[FailureInjector]:
        """The first of `injectors` (the single-injector view)."""
        return self.injectors[0] if self.injectors else None

    def _failed_shards(self, step: int) -> List[int]:
        """Drain every injector's events for `step`: the deduped joint
        failure set."""
        failed: List[int] = []
        for inj in self.injectors:
            while True:
                shard = inj.check(step)
                if shard is None:
                    break
                if shard not in failed:
                    failed.append(shard)
        return failed

    def maybe_checkpoint(self, step: int, state, aux=None):
        """Encode at the diskless cadence and save at the disk cadence.

        ``state`` is the stacked state, or a function of no arguments that
        builds it (`stack_view`): it is called only when a checkpoint is
        due, and the tree it returns becomes the diskless snapshot without
        a copy."""
        encode = step % self.policy.diskless_every == 0
        save = self.ckpt is not None and step % self.policy.disk_every == 0
        if not (encode or save):
            return
        owned = callable(state)
        if owned:
            state = state()
        if encode:
            _sync()
            t0 = time.perf_counter()
            self.diskless.encode(state, step, owned=owned)
            _sync()
            self.timings["encode"].append(time.perf_counter() - t0)
        if save:
            t0 = time.perf_counter()
            self.ckpt.save(step, state, aux=aux)
            self.timings["save"].append(time.perf_counter() - t0)

    def step(self, step_idx: int, state, run_step: Callable,
             run_step_sdc: Optional[Callable] = None):
        """Run one training step with failure check + recovery."""
        if run_step_sdc is not None:
            raise NotImplementedError(f"SDC drills come with {_ELASTIC}")
        failed = self._failed_shards(step_idx)
        if failed:
            for shard in failed:
                state = FailureInjector.damage(state, shard, self.p)
            state = self.recover(state, failed)
        return run_step(state)

    def recover(self, damaged_state, failed):
        """Diskless first (the paper's path), disk as the fallback."""
        if self.diskless.step is not None and len(failed) <= self.policy.f:
            self.recoveries["diskless"] += 1
            _sync()
            t0 = time.perf_counter()
            out = self.diskless.recover(damaged_state, failed)
            _sync()
            wall = time.perf_counter() - t0
            self.timings["recover"].append(wall)
            _pub_rung("diskless", wall, shards=len(failed))
            return out
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.recoveries["disk"] += 1
            latest = self.ckpt.latest_step()
            t0 = time.perf_counter()
            out = self.ckpt.restore(latest, damaged_state)
            _sync()
            wall = time.perf_counter() - t0
            self.timings["recover"].append(wall)
            _pub_rung("disk", wall, rollback_step=latest)
            return out
        raise RuntimeError(
            f"unrecoverable: {len(failed)} failures, capacity f="
            f"{self.policy.f}, no disk checkpoint")
