"""Fault-tolerant training runtimes: the paper's recovery timeline (§3.3)
as a training-loop wrapper.

The recovery ladder, cheapest rung first:

  1. **in-step ABFT**: silent corruption inside a step is detected,
     located and corrected by the checksums fused into the projections
     (`StepOptions.abft_mode`) and riding the gradient reduction
     (`StepOptions.abft_reduce`, `dist.collectives.abft_psum_tree`); the
     step completes with the repaired values;
  2. **diskless rollback**: a lost DP shard is rebuilt from the checksums
     of `ckpt.diskless`, a bounded rollback to the last encode, no disk;
     the disk restore is the fallback when more than `f` shards are lost.

`FTRuntime` wraps both rungs around a caller-built step function, with SDC
drills (`sdc_injector` / ``run_step(run_step_sdc=)``).  `ElasticRuntime`
owns the step on one device (mesh 1 x 1, DP extent 1): it builds the
eager step, the deterministic data stream, the cadenced diskless and disk
checkpoints, shard-loss recovery at ``p = 1`` and the at-rest scrub, which
re-encodes the live state on kernel #3 and rolls a DRAM flip back to the
snapshot.  Its pod paths (rung 3: `lose_pod`, `regrow`, `demote_pod`, the
straggler detector) come with port slice 13.

The DP axis is simulated on one device as ``p`` logical shards: the
stacked view of `stack_view` splits each leaf's leading axis by ``p``.  The
reference stacks each layout group's layers on axis 0; the port keeps
per-layer lists, so `stack_view` stacks them first and logical shard i of a
group of R layers holds layers ``i R/p .. (i+1) R/p - 1``, as in the
reference.

Counterpart of the reference package's ``repro/ft/runtime.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.chaos.faults import register_surface
from repro_torch.ckpt.diskless import DisklessCheckpoint
from repro_torch.ft.failures import FailureInjector, SDCInjector
from repro_torch.tree import stack_layers, tree_map, unstack_layers

__all__ = ["FTPolicy", "FTRuntime", "ElasticRuntime", "ScrubReport",
           "stack_view", "unstack_view"]

_POD_PATHS = ("port slice 13 (multi-process distribution and "
              "ElasticRuntime's pod paths)")

# at-rest scrub: upgrades the chaos.faults placeholders to protected.  The
# cadenced `ElasticRuntime.scrub` re-runs the diskless encode over the live
# stacked state and compares against the checksums held since the encode
# point: a DRAM flip in resident params or optimizer moments trips the
# residual and rolls back to the snapshot (rung "scrub:diskless").
register_surface(
    "state.params_at_rest", owner=__name__, protected=True,
    promise="tolerance",
    detector="checksum-on-write / verify-on-read: the scrub cadence "
             "recomputes the diskless encode of the live state (kernel #3 "
             "on the card) and compares leafwise against the held "
             "checksums (DisklessCheckpoint.verify); a trip restores the "
             "snapshot",
    kinds=("dram_params",),
    note="valid only at encode-point steps (state unchanged since encode); "
         "the serve-side params scrub lives in serve.engine")
register_surface(
    "state.opt_state_at_rest", owner=__name__, protected=True,
    promise="tolerance",
    detector="same scrub as params: the diskless encode covers the FULL "
             "stacked state, AdamW moments included, so an at-rest flip "
             "in the opt state trips the same leafwise residual",
    kinds=("dram_opt_state",),
    note="rollback restores the whole snapshot (params + opt + step)")


@dataclasses.dataclass(frozen=True)
class FTPolicy:
    """Recovery-budget knobs: `diskless_every` is the checksum-encode
    cadence (steps), `disk_every` the async disk-snapshot cadence (the
    fallback when more than `f` shards die at once), `f` the simultaneous
    failures the diskless encoding survives.  `scrub_every` is the at-rest
    scrub cadence (0 = off); a scrub fires only at encode points, so a
    useful cadence is a multiple of `diskless_every`.  The straggler
    fields are the reference's; the detector that reads them comes with
    port slice 13."""
    diskless_every: int = 10
    disk_every: int = 100
    f: int = 1
    slow_pod_threshold: float = 3.0
    straggler_alpha: float = 0.5
    straggler_warmup: int = 3
    scrub_every: int = 0


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
    return tree_map(split, stack_layers(state, clone=True))


def unstack_view(stacked, like):
    """Inverse of `stack_view` against the port's state ``like``: stacked
    group leaves go back to per-layer lists (views of the stacked tensors),
    split leaves to ``like``'s shapes."""
    return unstack_layers(stacked, like)


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
    background) and recovery; ``step_times`` the wall of every step run
    through `step`."""

    def __init__(self, p: int, policy: FTPolicy,
                 injector: Optional[FailureInjector] = None,
                 ckpt_manager=None,
                 sdc_injector: Optional[SDCInjector] = None):
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
        self.sdc_injector = sdc_injector
        self.ckpt = ckpt_manager
        self.diskless = DisklessCheckpoint(p, policy.f)
        self.recoveries = {"diskless": 0, "disk": 0, "sdc": 0}
        self.timings = {"encode": [], "save": [], "recover": []}
        self.step_times: List[float] = []

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
        """Run one training step with failure check + recovery.

        ``run_step_sdc(state, events)`` runs the step variant with an SDC
        injection into the protected reduction (`StepOptions.sdc_inject`
        with ``abft_reduce``): when the `sdc_injector`'s plan fires at this
        step the drilled variant runs instead of ``run_step`` and the
        checksums riding the gradient reduction repair it in flight
        (counted under ``recoveries["sdc"]``).  ``events`` is the fired
        ``(shard, delta)`` payload, or a tuple of payloads when the plan
        schedules several faults for one step."""
        t0 = time.perf_counter()
        failed = self._failed_shards(step_idx)
        if failed:
            for shard in failed:
                state = FailureInjector.damage(state, shard, self.p)
            state = self.recover(state, failed)
        # consume SDC events only when there is a handler to drive them:
        # otherwise they stay planned instead of silently vanishing
        sdc = (self.sdc_injector.check_all(step_idx)
               if self.sdc_injector is not None and run_step_sdc is not None
               else ())
        if sdc:
            self.recoveries["sdc"] += 1
            obs.event("fault/inject", step=step_idx,
                      surface="train.step/grad_reduce", kind="sdc_reduce",
                      n=len(sdc))
            out = run_step_sdc(state, sdc[0] if len(sdc) == 1 else sdc)
        else:
            out = run_step(state)
        self.step_times.append(time.perf_counter() - t0)
        return out

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


@dataclasses.dataclass(frozen=True)
class ScrubReport:
    """One at-rest scrub that tripped (clean scrubs return None)."""
    step: int                   # encode-point step the scrub verified
    leaf: str                   # first leaf whose checksum residual tripped
    residual: float             # worst relative residual observed
    wall_s: float               # verify + restore wall
    rolled_back: bool           # snapshot restore applied


def _dp_extent(mesh) -> int:
    """The DP extent of ``mesh`` (None, a shape tuple, or a dict of axis
    sizes); anything but one device raises."""
    if mesh is None:
        return 1
    sizes = list(mesh.values()) if isinstance(mesh, dict) else list(mesh)
    if any(int(v) != 1 for v in sizes):
        raise NotImplementedError(
            f"ElasticRuntime on mesh {mesh!r}: the port runs one device "
            f"(mesh 1 x 1); larger meshes come with {_POD_PATHS}")
    return 1


class ElasticRuntime(FTRuntime):
    """Owns the step on one device and runs rungs 1 and 2 around it.

    Unlike `FTRuntime`, which wraps a caller-built step, this runtime
    builds the eager step (`train.step.build_train_step`) and the
    deterministic data stream, and drives the cadenced checkpoints
    (`checkpoint`), the at-rest scrub (`scrub`) and shard-loss recovery
    (`maybe_shard_failure`).  ``mesh`` is None or a shape of all ones: the
    DP extent is 1, so the diskless encode and recovery run at ``p = 1``
    (the single logical shard is lost and rebuilt from its checksum).  The
    step runs on ``device`` (``"cuda"`` by default, which raises without a
    GPU)."""

    def __init__(self, cfg, shape, mesh=None, *, adamw=None, opts=None,
                 policy: Optional[FTPolicy] = None, data_cfg=None,
                 ckpt_manager=None, injector=None, sdc_injector=None,
                 device="cuda"):
        from repro_torch.data.pipeline import DataConfig, DataPipeline
        from repro_torch.launch.serve import resolve_device
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.step import StepOptions, build_train_step

        p = _dp_extent(mesh)
        self.device = resolve_device(str(device))
        self.cfg = cfg
        self.shape = shape
        self.adamw = adamw or AdamWConfig()
        self.opts = opts or StepOptions()
        self.mesh = mesh
        obs.event("train/build_step", arch=cfg.name,
                  mesh={"data": 1, "model": 1},
                  abft_mode=self.opts.abft_mode,
                  abft_reduce=self.opts.abft_reduce)
        t0 = time.perf_counter()
        self.step_fn = build_train_step(cfg, shape, self.adamw, self.opts)
        self.build_s = time.perf_counter() - t0
        super().__init__(p, policy or FTPolicy(), injector=injector,
                         ckpt_manager=ckpt_manager,
                         sdc_injector=sdc_injector)
        self.recoveries["elastic"] = 0
        self.recoveries["demote"] = 0
        self.data_cfg = data_cfg or DataConfig(
            cfg.vocab_size, shape.seq_len, shape.global_batch)
        self.pipe = DataPipeline(self.data_cfg)

    def init_state(self, seed: int = 0):
        """A fresh train state, params drawn from ``seed`` on the device."""
        from repro_torch.train.step import init_state
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_state(gen, self.cfg)

    # -- the step + cadence --------------------------------------------------

    def place_batch(self, step: int):
        """The deterministic global batch for `step`, on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipe.batch_at(step).items()}

    def train_step(self, step_idx: int, state):
        """Run step `step_idx`: ``(state, metrics)``."""
        batch = self.place_batch(step_idx)
        obs.set_step(step_idx)
        with obs.span("train/step", step=step_idx, gen=0):
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            _sync()
            wall = time.perf_counter() - t0
        self.step_times.append(wall)
        obs.counter("repro_train_steps_total", "elastic train steps").inc()
        return state, metrics

    def checkpoint(self, step: int, state):
        """Cadenced rung-2 state capture: diskless over the stacked view,
        disk over the state itself.  The saved data state carries this
        step as its cursor."""
        if step % self.policy.diskless_every == 0:
            _sync()
            t0 = time.perf_counter()
            self.diskless.encode(stack_view(state, self.p), step, owned=True)
            _sync()
            self.timings["encode"].append(time.perf_counter() - t0)
        if self.ckpt is not None and step % self.policy.disk_every == 0:
            self.ckpt.save(step, state, aux={
                "data_step": step,
                "data": dict(self.pipe.state_dict(), step=step),
                "gen": 0, "mesh": {"data": 1, "model": 1}})

    # -- at-rest scrub (state.params_at_rest / state.opt_state_at_rest) ------

    def scrub(self, step: int, state):
        """Cadenced at-rest integrity scrub: ``(state, report)``, with
        ``report=None`` when the scrub did not fire or found the state
        clean.

        Checksum-on-write / verify-on-read: it fires only at steps where
        the diskless encode was taken this step (``diskless.step ==
        step``), so the live state should be bit-identical to the
        encode-point state and any checksum residual is a DRAM flip, in
        params, optimizer moments or the step counter alike.  The verify
        re-encodes the live state (kernel #3 on the card).  A trip
        restores the snapshot through the rung-2 path and counts under
        ``recoveries["scrub"]``."""
        if not self.policy.scrub_every or step % self.policy.scrub_every:
            return state, None
        if self.diskless.step != step:
            return state, None
        t0 = time.perf_counter()
        stacked = stack_view(state, self.p)
        ok, leaf, resid = self.diskless.verify(stacked)
        if ok:
            return state, None
        self.recoveries["scrub"] = self.recoveries.get("scrub", 0) + 1
        obs.counter("repro_detections_total",
                    "checksum/invariant trips").inc(
            surface="state.at_rest")
        obs.event("fault/detect", step=step, surface="state.at_rest",
                  detector="diskless_verify", leaf=str(leaf))
        obs.histogram("repro_scrub_residual",
                      "at-rest scrub checksum residuals").observe(
            float(resid))
        state = unstack_view(self.diskless.recover(stacked, []), state)
        _sync()
        report = ScrubReport(step=step, leaf=leaf, residual=resid,
                             wall_s=time.perf_counter() - t0,
                             rolled_back=True)
        _pub_rung("scrub:diskless", report.wall_s, step=step,
                  leaf=str(leaf), residual=float(resid))
        return state, report

    # -- rung 2: shard loss ----------------------------------------------------

    def maybe_shard_failure(self, step: int, state):
        """Drive the `FailureInjector`(s) through rung 2: ``(state,
        rollback_step or None)``.  On a hit the state is the recovered
        encode-point state and the caller replays from `rollback_step`
        (the deterministic data stream makes the replay exact).  Every
        injector is drained for this step and concurrent losses recover
        jointly while they fit the capacity `f`; diskless first, the disk
        checkpoint of `checkpoint` as the fallback."""
        failed = self._failed_shards(step)
        if not failed:
            return state, None
        obs.event("fault/detect", step=step, surface="ft.runtime/shards",
                  detector="failure_signal", shards=len(failed))
        t0 = time.perf_counter()
        if self.diskless.step is not None and len(failed) <= self.policy.f:
            stacked = stack_view(state, self.p)
            for shard in failed:
                stacked = FailureInjector.damage(stacked, shard, self.p)
            self.recoveries["diskless"] += 1
            state = unstack_view(self.diskless.recover(stacked, failed),
                                 state)
            rollback = self.diskless.step
            rung = "diskless"
        elif self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.ckpt.wait()
            self.recoveries["disk"] += 1
            rollback = self.ckpt.latest_step()
            state = self.ckpt.restore(rollback, state)
            rung = "disk"
        else:
            raise RuntimeError(
                "shard loss with no diskless encode and no disk checkpoint")
        _sync()
        wall = time.perf_counter() - t0
        self.timings["recover"].append(wall)
        _pub_rung(rung, wall, step=step, shards=len(failed),
                  rollback_step=rollback)
        return state, rollback

    # -- rung 3: not on one device ----------------------------------------------

    def lose_pod(self, state, failed_pods: int = 1):
        raise NotImplementedError(f"lose_pod comes with {_POD_PATHS}")

    def regrow(self, state, mesh=None, at_step: Optional[int] = None):
        raise NotImplementedError(f"regrow comes with {_POD_PATHS}")

    def demote_pod(self, state, pod: int):
        raise NotImplementedError(f"demote_pod comes with {_POD_PATHS}")

    def close(self):
        self.pipe.close()
