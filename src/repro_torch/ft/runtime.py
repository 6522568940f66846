"""Fault-tolerant training runtimes: the paper's recovery timeline (§3.3)
as a training-loop wrapper, grown into an elastic runtime that survives
topology loss, not just shard loss.

The recovery ladder, cheapest rung first:

  1. **in-step ABFT**: silent corruption inside a step is detected,
     located and corrected by the checksums fused into the projections
     (`StepOptions.abft_mode`) and riding the gradient reduction
     (`StepOptions.abft_reduce`, `dist.collectives.abft_psum_tree`); the
     step completes with the repaired values;
  2. **diskless rollback**: a lost DP shard is rebuilt from the checksums
     of `ckpt.diskless`, a bounded rollback to the last encode, no disk;
     the disk restore is the fallback when more than `f` shards are lost;
  3. **elastic reshard**: a pod is gone.  Build the survivor mesh,
     re-place params and ZeRO-1 opt state through the mesh-agnostic
     `train.step.state_specs`, re-split the global batch
     (`data.pipeline.resplit`: sample order unchanged) and resume; the
     mirror operation re-grows when the pod returns.  Rung 3a reuses the
     surviving diskless state when the loss fits its capacity
     (`DisklessCheckpoint.reshard`, which re-encodes on kernel #3 at the
     survivor extent), rung 3b restores from disk
     (`ckpt.elastic.reshard_restore`).

`FTRuntime` wraps rungs 1-2 around a caller-built step function, with SDC
drills (`sdc_injector` / ``run_step(run_step_sdc=)``).  `ElasticRuntime`
owns the step: it builds and versions a `MeshGeneration` (logical mesh,
placement records, the eager step at the mesh's DP extent, data split)
and switches generations on `lose_pod` / `regrow` / `demote_pod`, logging
an `ElasticReport` (placement diff, bytes moved, reshard wall, build wall)
per switch.  The mesh is logical (`dist.sharding.Mesh`): one device runs
every DP shard of the step, and the diskless checkpoint encodes over
``p`` = the DP extent logical shards.  The step is eager, so nothing
compiles: ``compile_s`` is 0.0 and a generation fetched from the cache
(keyed on the mesh shape) reports ``reused``.

Straggler mitigation: `StragglerDetector` keeps a per-pod step-time EWMA
fed from the ``train/pod_walls`` events `train_step` publishes on the obs
bus; a persistently slow pod is demoted through the elastic path.

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
import weakref
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.chaos.faults import register_surface
from repro_torch.ckpt.diskless import DisklessCheckpoint
from repro_torch.ft.failures import FailureInjector, SDCInjector
from repro_torch.tree import stack_layers, tree_map, unstack_layers

__all__ = ["FTPolicy", "FTRuntime", "ElasticRuntime", "MeshGeneration",
           "ElasticReport", "ScrubReport", "StragglerDetector", "stack_view",
           "unstack_view"]

# the protection domain this module owns: TOPOLOGY faults, a pod that is
# gone (platform-signaled) or persistently slow (step-time EWMA straggler
# detector), handled by the rung-3 elastic shrink/re-grow ladder
register_surface(
    "ft.runtime/topology", owner=__name__, protected=True,
    promise="tolerance",
    detector="pod loss: platform failure signal; slow pod: per-pod "
             "step-time EWMA exceeding slow_pod_threshold x the median "
             "(StragglerDetector) — both demote through lose_pod()",
    kinds=("pod_loss", "slow_pod"),
    note="rung 3b (disk restore) resumes bit-identically; rung 3a "
         "(diskless checksum solve) is near-exact, hence the tolerance "
         "promise; demotion rolls back to the last checkpoint and replays "
         "deterministically")

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
    useful cadence is a multiple of `diskless_every`.
    `slow_pod_threshold` demotes a pod persistently slower than this
    multiple of the median step time (EWMA-smoothed: `straggler_alpha` is
    the smoothing factor, `straggler_warmup` the observations required
    before the detector may trip)."""
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
              compile_s: Optional[float] = None,
              warm_s: Optional[float] = None, **attrs) -> None:
    """Publish one recovery-ladder firing to the obs bus: the
    ``repro_recoveries_total{rung=...}`` counter and a ``recovery/<rung>``
    span carrying the measured wall (and the compile/warm split where the
    caller has it: the elastic rungs do)."""
    obs.counter("repro_recoveries_total",
                "recovery-ladder rungs fired").inc(rung=rung)
    obs.recovery(rung, wall_s, step=step, compile_s=compile_s,
                 warm_s=warm_s, **attrs)


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


# ---------------------------------------------------------------------------
# straggler detection: per-pod step-time EWMA
# ---------------------------------------------------------------------------


class StragglerDetector:
    """Per-pod step-time EWMA; trips when one pod's EWMA exceeds
    ``threshold`` x the median EWMA of the OTHER pods.

    Synchronous data parallelism runs each step at the slowest pod's
    pace, so per-pod walls come from a heartbeat (each pod's host callback
    reports its own step wall; `ElasticRuntime.train_step` synthesizes a
    uniform heartbeat when none is installed).  The EWMA smooths one-off
    hiccups away (only a persistently slow pod trips, and only after
    `warmup` observations) and the median baseline keeps a uniformly slow
    fleet from demoting itself."""

    def __init__(self, n_pods: int, threshold: float, *,
                 alpha: float = 0.5, warmup: int = 3):
        self.n_pods = n_pods
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma = [None] * n_pods
        self.observations = 0

    def observe(self, walls) -> Optional[int]:
        """Feed one step's per-pod walls; returns the pod to demote (the
        worst offender) or None.  Never trips with fewer than 2 pods."""
        if len(walls) != self.n_pods:
            raise ValueError(f"expected {self.n_pods} pod walls, got "
                             f"{len(walls)}")
        a = self.alpha
        self.ewma = [w if e is None else a * w + (1 - a) * e
                     for e, w in zip(self.ewma, walls)]
        self.observations += 1
        if self.n_pods < 2 or self.observations < self.warmup:
            return None
        worst = max(range(self.n_pods), key=lambda i: self.ewma[i])
        others = sorted(e for i, e in enumerate(self.ewma) if i != worst)
        median = others[len(others) // 2]
        if median > 0 and self.ewma[worst] > self.threshold * median:
            return worst
        return None


# ---------------------------------------------------------------------------
# elastic runtime: versioned mesh generations + the full ladder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshGeneration:
    """One versioned bundle: everything a topology needs to take a step.

    Built (or fetched from the generation cache) on every elastic
    transition; nothing outside the bundle depends on the mesh shape, so
    switching generations is the topology change."""
    gen: int                    # monotonically increasing generation id
    mesh: object                # dist.sharding.Mesh
    step_fn: Callable           # eager (state, batch) -> (state, metrics)
    in_shardings: Tuple         # (state shardings, batch shardings)
    out_shardings: Tuple
    state_shapes: dict          # meta-tensor tree of the state
    dp_extent: int              # product of the non-"model" axis sizes
    split: int                  # data-pipeline split (batch-dividing DP)
    build_s: float              # wall of build_train_step and the specs
    compile_s: float            # 0.0: the eager step compiles nothing
    reused: bool = False        # fetched from the generation cache


@dataclasses.dataclass(frozen=True)
class ScrubReport:
    """One at-rest scrub that tripped (clean scrubs return None)."""
    step: int                   # encode-point step the scrub verified
    leaf: str                   # first leaf whose checksum residual tripped
    residual: float             # worst relative residual observed
    wall_s: float               # verify + restore wall
    rolled_back: bool           # snapshot restore applied


@dataclasses.dataclass(frozen=True)
class ElasticReport:
    """What one elastic transition did and what it cost: the placement
    diff summary (`ckpt.elastic.plan_reshard`) plus measured walls."""
    kind: str                   # "shrink" | "regrow"
    gen_from: int
    gen_to: int
    mesh_from: dict
    mesh_to: dict
    restore_path: str           # "diskless" (rung 3a) | "disk" (3b) | "live"
    rollback_step: Optional[int]
    n_leaves: int
    n_respecced: int
    bytes_total: int
    bytes_respecced: int
    reshard_wall_s: float
    build_s: float
    compile_s: float
    reused_executable: bool

    def summary(self) -> dict:
        return dataclasses.asdict(self)


class ElasticRuntime(FTRuntime):
    """Owns mesh generations and executes the three-rung recovery ladder.

    Unlike `FTRuntime`, which wraps a caller-built step, this runtime
    builds the step per topology: construction builds generation 0 on
    `mesh` (None is 1 x 1; a shape tuple or a dict of axis sizes, or a
    `dist.sharding.Mesh`); `lose_pod` shrinks onto the survivor mesh (rung
    3) and `regrow` returns to the full mesh when the pod comes back.
    Rungs 1-2 ride along: rung 1 is built into every generation's step via
    `opts`, rung 2 is `maybe_shard_failure` (diskless first, at ``p`` =
    the DP extent).  Every step runs on ``device`` (``"cuda"`` by default,
    which raises without a GPU).

    Determinism contract (what the parity drills assert): the data stream
    is global and (seed, step)-deterministic, checkpoints hold global
    leaves, and the specs are mesh-agnostic functions of the state, so a
    drilled shrink resumes bit-identically to a survivor-mesh-from-scratch
    restore of the same checkpoint."""

    def __init__(self, cfg, shape, mesh=None, *, adamw=None, opts=None,
                 policy: Optional[FTPolicy] = None, data_cfg=None,
                 ckpt_manager=None, injector=None, sdc_injector=None,
                 device="cuda"):
        from repro_torch.data.pipeline import DataConfig, DataPipeline
        from repro_torch.dist.sharding import as_mesh
        from repro_torch.launch.serve import resolve_device
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.step import StepOptions, state_shapes

        self.device = resolve_device(str(device))
        self.cfg = cfg
        self.shape = shape
        self.adamw = adamw or AdamWConfig()
        self.opts = opts or StepOptions()
        self.full_mesh = as_mesh(mesh, self.device)
        self._next_gen = 0
        self._gen_cache = {}       # mesh-shape key -> MeshGeneration
        self.reports: List[ElasticReport] = []
        self._state_shapes = state_shapes(cfg)
        gen = self._build_generation(self.full_mesh)
        super().__init__(gen.dp_extent, policy or FTPolicy(),
                         injector=injector, ckpt_manager=ckpt_manager,
                         sdc_injector=sdc_injector)
        self.gen = gen
        self.recoveries["elastic"] = 0
        self.recoveries["demote"] = 0
        self.data_cfg = data_cfg or DataConfig(
            cfg.vocab_size, shape.seq_len, shape.global_batch)
        self.pipe = DataPipeline(self.data_cfg, split=gen.split)
        # straggler path: `pod_heartbeat(step, wall) -> per-pod walls` is
        # each pod's host callback reporting its own step time (drills
        # delay one pod's: chaos FaultSpec kind="slow_pod"); None means a
        # uniform heartbeat
        self.pod_heartbeat = None
        self._slow_pod = None
        self._straggler = self._fresh_straggler(gen.mesh)
        self._obs_id = id(self)
        self._obs_sub = None
        self._attach_straggler()

    @property
    def mesh(self):
        """The current generation's mesh."""
        return self.gen.mesh

    def _attach_straggler(self):
        """Attach the straggler detector through the bus: `train_step`
        publishes each step's per-pod walls as a ``train/pod_walls`` event
        and the detector consumes them via ``obs.subscribe``.  The
        subscription holds only a weakref to the runtime; a dropped runtime
        detaches itself on its next event."""
        wr = weakref.ref(self)

        def _feed(ev, _wr=wr):
            rt = _wr()
            if rt is None:
                obs.unsubscribe(_feed)
                return
            if (ev.name != "train/pod_walls"
                    or ev.attrs.get("runtime") != rt._obs_id):
                return
            slow = rt._straggler.observe(list(ev.attrs["walls"]))
            rt._slow_pod = slow
            if slow is not None:
                obs.counter("repro_straggler_trips_total",
                            "EWMA straggler detector trips").inc()
                obs.event("straggler/trip", step=ev.step, pod=slow,
                          ewma=list(rt._straggler.ewma))

        self._obs_sub = _feed
        obs.subscribe(_feed)

    # -- generation lifecycle ------------------------------------------------

    def _build_generation(self, mesh) -> MeshGeneration:
        """Build (or cache-fetch) the bundle for `mesh`.  The cache is keyed
        on the mesh shape: re-growing onto a topology seen before reuses
        its step."""
        from repro_torch.dist import sharding as shd
        from repro_torch.train.step import build_train_step, state_specs

        cached = self._gen_cache.get(mesh.key())
        if cached is not None:
            gen = dataclasses.replace(cached, gen=self._next_gen,
                                      compile_s=0.0, reused=True)
            self._next_gen += 1
            return gen
        obs.event("train/build_step", arch=self.cfg.name,
                  mesh={k: int(v) for k, v in mesh.shape.items()},
                  abft_mode=self.opts.abft_mode,
                  abft_reduce=self.opts.abft_reduce)
        t0 = time.perf_counter()
        step_fn = build_train_step(self.cfg, self.shape, self.adamw,
                                   self.opts, mesh=mesh)
        state_sh = shd.to_shardings(
            state_specs(self._state_shapes, mesh, self.opts, self.cfg),
            mesh)
        bspec = shd.batch_specs(mesh, self.shape.global_batch)
        batch_sh = {k: shd.NamedSharding(mesh, shd.P(*bspec, None))
                    for k in ("tokens", "labels")}
        metric_sh = {k: shd.NamedSharding(mesh, shd.P())
                     for k in ("grad_norm", "lr", "loss")}
        build_s = time.perf_counter() - t0
        gen = MeshGeneration(
            gen=self._next_gen, mesh=mesh, step_fn=step_fn,
            in_shardings=(state_sh, batch_sh),
            out_shardings=(state_sh, metric_sh),
            state_shapes=self._state_shapes, dp_extent=shd.dp_extent(mesh),
            split=step_fn.split, build_s=build_s, compile_s=0.0)
        self._next_gen += 1
        self._gen_cache[mesh.key()] = gen
        return gen

    def init_state(self, seed: int = 0):
        """A fresh train state, params drawn from ``seed`` on the device."""
        from repro_torch.train.step import init_state
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_state(gen, self.cfg)

    # -- the step + cadence --------------------------------------------------

    def place_batch(self, step: int):
        """The deterministic global batch for `step`, on the device (the
        same stream whatever the topology; the step splits it)."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipe.batch_at(step).items()}

    def _fresh_straggler(self, mesh) -> StragglerDetector:
        return StragglerDetector(
            mesh.shape.get("pod", 1), self.policy.slow_pod_threshold,
            alpha=self.policy.straggler_alpha,
            warmup=self.policy.straggler_warmup)

    def train_step(self, step_idx: int, state):
        """Run step `step_idx` under the current generation: ``(state,
        metrics)``.  Feeds the per-pod heartbeat to the straggler detector;
        poll `maybe_straggler()` after the step and demote via
        `demote_pod`."""
        batch = self.place_batch(step_idx)
        obs.set_step(step_idx)
        with obs.span("train/step", step=step_idx, gen=self.gen.gen):
            t0 = time.perf_counter()
            state, metrics = self.gen.step_fn(state, batch)
            _sync()
            wall = time.perf_counter() - t0
        self.step_times.append(wall)
        obs.counter("repro_train_steps_total", "elastic train steps").inc()
        n_pods = self._straggler.n_pods
        walls = (self.pod_heartbeat(step_idx, wall)
                 if self.pod_heartbeat is not None else [wall] * n_pods)
        # the straggler detector consumes this through obs.subscribe
        obs.event("train/pod_walls", step=step_idx, walls=list(walls),
                  runtime=self._obs_id)
        return state, metrics

    def maybe_straggler(self) -> Optional[int]:
        """The pod the EWMA detector wants demoted (None = all healthy)."""
        return self._slow_pod

    def demote_pod(self, state, pod: int):
        """Demote a persistently slow pod through the elastic rung: drop it
        and keep the batch.  `lose_pod` shrinks onto the survivor mesh as
        if the pod had died (rollback to the last checkpoint, reshard,
        replay).  `pod` is the detector's index (the survivor mesh shrinks
        the pod axis).  Returns ``(state, rollback_step, report)``."""
        state, rollback, report = self.lose_pod(state)
        self.recoveries["demote"] += 1
        self._slow_pod = None
        _pub_rung("demote:" + report.restore_path, report.reshard_wall_s,
                  compile_s=report.compile_s,
                  warm_s=report.reshard_wall_s, pod=pod)
        return state, rollback, report

    def checkpoint(self, step: int, state):
        """Cadenced rung-2/3 state capture: diskless over the stacked view
        (``p`` = the DP extent), disk over the state itself (the elastic
        restore needs global leaves).  The saved data state carries this
        step as its cursor."""
        if step % self.policy.diskless_every == 0:
            _sync()
            t0 = time.perf_counter()
            self.diskless.encode(stack_view(state, self.p), step, owned=True)
            _sync()
            self.timings["encode"].append(time.perf_counter() - t0)
        if self.ckpt is not None and step % self.policy.disk_every == 0:
            t0 = time.perf_counter()
            self.ckpt.save(step, state, aux={
                "data_step": step,
                "data": dict(self.pipe.state_dict(), step=step),
                "gen": self.gen.gen, "mesh": dict(self.gen.mesh.shape)})
            self.timings["save"].append(time.perf_counter() - t0)

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

    # -- rung 2: shard loss on an unchanged topology ---------------------------

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
            state = self.ckpt.restore(rollback, self.gen.state_shapes,
                                      sharding_tree=self.gen.in_shardings[0])
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

    # -- rung 3: topology change -----------------------------------------------

    def _switch(self, gen: MeshGeneration, at_step: Optional[int]):
        self.gen = gen
        self.p = gen.dp_extent
        self.pipe = self.pipe.resplit(gen.split, at_step=at_step)
        # pod count changed: stale EWMAs would misattribute; start fresh
        self._straggler = self._fresh_straggler(gen.mesh)
        self._slow_pod = None

    def _report(self, kind, old, gen, plan, path, rollback, wall):
        report = ElasticReport(
            kind=kind, gen_from=old.gen, gen_to=gen.gen,
            mesh_from=dict(old.mesh.shape), mesh_to=dict(gen.mesh.shape),
            restore_path=path, rollback_step=rollback,
            n_leaves=len(plan.leaves), n_respecced=plan.n_respecced,
            bytes_total=plan.bytes_total,
            bytes_respecced=plan.bytes_respecced,
            reshard_wall_s=wall, build_s=gen.build_s,
            compile_s=gen.compile_s, reused_executable=gen.reused)
        self.reports.append(report)
        return report

    def lose_pod(self, state, failed_pods: int = 1):
        """Rung 3: a pod is gone.  Shrink onto the survivor mesh.

        Returns ``(state_on_survivors, rollback_step, report)``.  Rung 3a
        when the dead pod's slice of the diskless stacking fits the
        checksum capacity `f` (the state survives in memory: the lost
        shards are solved and re-encoded at the survivor extent); rung 3b
        otherwise (the latest disk checkpoint through
        `ckpt.elastic.reshard_restore`)."""
        from repro_torch.ckpt.elastic import (plan_reshard, reshard_restore,
                                              reshard_state, survivor_mesh)

        old = self.gen
        new_mesh = survivor_mesh(failed_pods=failed_pods, mesh=old.mesh)
        gen = self._build_generation(new_mesh)
        plan = plan_reshard(old.state_shapes, old.mesh, new_mesh,
                            self.opts, self.cfg)
        lost_shards = self.p * failed_pods // old.mesh.shape["pod"]
        _sync()
        t0 = time.perf_counter()
        if self.diskless.step is not None and lost_shards <= self.policy.f:
            rollback = self.diskless.step
            failed = list(range(self.p - lost_shards, self.p))
            self.diskless = self.diskless.reshard(gen.dp_extent,
                                                  failed=failed)
            restored = unstack_view(self.diskless.snapshot(), state)
            state = reshard_state(restored, new_mesh, self.opts, self.cfg)
            path = "diskless"
        else:
            if self.ckpt is not None:
                self.ckpt.wait()          # flush the in-flight async save
            if self.ckpt is None or self.ckpt.latest_step() is None:
                raise RuntimeError(
                    f"pod loss beyond diskless capacity (lost {lost_shards} "
                    f"shards > f={self.policy.f}) and no disk checkpoint")
            rollback = self.ckpt.latest_step()
            state = reshard_restore(self.ckpt, rollback, old.state_shapes,
                                    new_mesh, self.opts, self.cfg)
            self.diskless = DisklessCheckpoint(gen.dp_extent, self.policy.f)
            path = "disk"
        _sync()
        wall = time.perf_counter() - t0
        self._switch(gen, at_step=rollback)
        self.recoveries["elastic"] += 1
        report = self._report("shrink", old, gen, plan, path, rollback, wall)
        _pub_rung("elastic:" + path, wall, compile_s=gen.compile_s,
                  warm_s=wall, gen_to=gen.gen, rollback_step=rollback,
                  reused=gen.reused)
        return state, rollback, report

    def regrow(self, state, mesh=None, at_step: Optional[int] = None):
        """The pod returns: spread the LIVE survivor state back over the
        full mesh (or `mesh`).  Nothing was lost, so no rollback; the
        diskless checkpoint is re-keyed across the grow (re-encoded on
        kernel #3 at the new extent) to keep its recovery point.  Pass
        `at_step` (the step about to run) so the re-split pipeline's
        cursor is the resumption point.  Returns ``(state, report)``."""
        from repro_torch.ckpt.elastic import plan_reshard, reshard_state
        from repro_torch.dist.sharding import as_mesh

        old = self.gen
        new_mesh = self.full_mesh if mesh is None \
            else as_mesh(mesh, self.device)
        gen = self._build_generation(new_mesh)
        plan = plan_reshard(old.state_shapes, old.mesh, new_mesh,
                            self.opts, self.cfg)
        _sync()
        t0 = time.perf_counter()
        state = reshard_state(state, new_mesh, self.opts, self.cfg)
        wall = time.perf_counter() - t0
        if self.diskless.step is not None:
            self.diskless = self.diskless.reshard(gen.dp_extent)
        else:
            self.diskless = DisklessCheckpoint(gen.dp_extent, self.policy.f)
        self._switch(gen, at_step=at_step)
        self.recoveries["elastic"] += 1
        report = self._report("regrow", old, gen, plan, "live", None, wall)
        _pub_rung("elastic:live", wall, compile_s=gen.compile_s,
                  warm_s=wall, gen_to=gen.gen, reused=gen.reused)
        return state, report

    def close(self):
        if self._obs_sub is not None:
            obs.unsubscribe(self._obs_sub)
            self._obs_sub = None
        self.pipe.close()
