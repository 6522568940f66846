"""Campaign runner: sweep a `FaultSpace` over the port's protection domains.

The counterpart of the reference package's ``repro/chaos/campaign.py``.
For every `FaultSpec` the runner builds the drill its kind calls for,
injects exactly that fault, and classifies what happened:

  * **corrected**   — the domain detected the fault AND the end state
    honors its promise against a clean golden run (bit-identity where
    promised, tolerance where the repair is a float solve),
  * **detected**    — seen but not (fully) repaired, e.g. a flip in the
    accumulate kernel's carried *checksum* state (repairing would corrupt
    healthy data, so the kernel only flags it),
  * **missed**      — the fault ran to completion with no detector firing,
  * **false_alarm** — a detector fired on a clean run,
  * **skipped**     — the spec needs a runtime the port has not brought up
    yet; the row names the slice it waits for.  A spec is never dropped.

The port runs the kernel and layer drills of the train workload on the
runner's device, at the reference's own drill sizes and from the same
``np.random.RandomState(spec.seed)`` draws:

  * carried-state flip (``checksum_state_flip``) and carried-data flip
    (``sdc_collective`` aimed at ``kernels.ops/acc_state``): two chained
    ``ops.abft_matmul_acc`` calls at 256³ in fp32, bf16 or int8 operands,
    on kernel #2 on a CUDA tensor;
  * flash state flip: ``flash_attention_checked`` with the drill's inject
    into ``acc`` or ``l`` at ``[2, 512, 64]``, on kernel #4 on a CUDA
    tensor;
  * layer invariants: the rmsnorm second-moment and embedding-gather
    checksum invariants of ``models/layers.py``.

The other handlers (``_run_train``: SDC in the protected reduction, DRAM
flips under the at-rest scrub, shard, pod and slow-pod faults through
``ElasticRuntime``; ``_run_serve``; ``_run_traffic``; ``_run_solver``;
``_run_episode``) raise `_Skip` naming the slice that brings their
runtime, and a workload whose golden run is not ported reports one
``skipped`` clean-sweep row.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.chaos.faults import (Episode, FaultSpace, FaultSpec,
                                      ensure_registered, flip_bit,
                                      get_surface)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TrainConfig", "FaultResult", "CampaignResult", "CampaignRunner",
           "classify", "episode_outcome"]

# the slices that bring the runtimes the skipped handlers need
_ELASTIC = ("the distribution + elastic-FT slice (ElasticRuntime, the "
            "protected step's abft_reduce and the at-rest scrub)")
_PAGED = "the paged-serving slice (PagedServeEngine)"
_SERVE_FT = ("the distribution + elastic-FT slice (the serving engine's "
             "mesh, abft_reduce, sdc and scrub_every options)")
_SOLVER = "the solver slice (RedundantSubspaceCG)"


# ---------------------------------------------------------------------------
# configs + result records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The train workload's drill settings.  The reference's workload
    sizes (arch, steps, batch, ...) come with the runtimes that read them;
    the kernel and layer drills read only the tolerance."""
    # end-state tolerance for "tolerance"-promise comparisons: float
    # repairs are near-exact, not bit-exact; the max|diff| is recorded
    tol: float = 1e-2


@dataclasses.dataclass
class FaultResult:
    """One classified campaign event (fault run or clean sweep)."""
    name: str
    workload: str
    kind: str                    # fault kind, or "clean_sweep"
    surface: str
    protected: bool
    promise: str
    outcome: str                 # corrected|detected|missed|false_alarm|
    #                              clean|skipped
    detected: bool
    corrected: bool
    rung: Optional[str]          # recovery rung that fired (None = none)
    recovery_latency_s: Optional[float]
    end_state: str               # bit_identical|within_tol|diverged|
    #                              not_compared
    max_abs_diff: Optional[float]
    wall_s: float
    spec: Optional[dict] = None  # the originating FaultSpec (None = sweep)
    note: str = ""
    episode: Optional[str] = None
    recovery_warm_s: Optional[float] = None
    recovery_compile_s: Optional[float] = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CampaignResult:
    space: str
    results: List[FaultResult]
    meta: dict

    def to_dict(self) -> dict:
        from repro_torch.chaos import report
        return report.campaign_dict(self)

    def markdown(self) -> str:
        from repro_torch.chaos import report
        return report.render_markdown(self)


# ---------------------------------------------------------------------------
# classification (pure)
# ---------------------------------------------------------------------------


def _end_ok(promise: str, end_state: str) -> bool:
    if promise == "bit_identity":
        return end_state == "bit_identical"
    if promise == "tolerance":
        return end_state in ("bit_identical", "within_tol")
    return False


def classify(*, injected: bool, detected: bool, corrected: bool,
             end_state: str, promise: str) -> str:
    """The outcome taxonomy, as a pure function of the observed signals:
    "corrected" only when the repair fired AND the end state honors the
    promise; a clean run is "clean" unless a detector fired."""
    if not injected:
        return "false_alarm" if detected else "clean"
    if not detected:
        return "missed"
    if corrected and _end_ok(promise, end_state):
        return "corrected"
    return "detected"


def episode_outcome(event_outcomes: Sequence[str], *, end_ok: bool,
                    false_alarms: int = 0) -> str:
    """Joint outcome of a multi-fault episode from its events' outcomes
    (events that never fired, "skipped", do not count)."""
    outs = [o for o in event_outcomes if o != "skipped"]
    if not outs:
        return "skipped"
    if any(o == "missed" for o in outs):
        return "missed"
    if false_alarms:
        return "false_alarm"
    if all(o in ("corrected", "absorbed") for o in outs) and end_ok:
        return "corrected"
    return "detected"


def _compare_trees(a, b, tol: float) -> Tuple[str, Optional[float]]:
    """Host-side leafwise comparison -> (end_state, max_abs_diff); diff is
    None when the divergence is unmeasurable (NaN/inf/integer)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise ValueError(f"trees differ in structure: {len(la)} vs "
                         f"{len(lb)} leaves")
    la, lb = [np.asarray(x) for x in la], [np.asarray(x) for x in lb]
    if all(np.array_equal(x, y, equal_nan=True) for x, y in zip(la, lb)):
        return "bit_identical", 0.0
    worst = 0.0
    for x, y in zip(la, lb):
        if not np.issubdtype(x.dtype, np.floating):
            if not np.array_equal(x, y):
                return "diverged", None     # structural/int divergence
            continue
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        if not np.all(np.isfinite(d)):
            return "diverged", None         # NaN/inf: unmeasurable distance
        worst = max(worst, float(np.max(d)) if d.size else 0.0)
    return ("within_tol" if worst <= tol else "diverged"), worst


def _host(tree):
    """A tree of tensors -> the same tree of numpy arrays on the host
    (bf16 widened to fp32, exactly)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)
    return tree_map(one, tree)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


class CampaignRunner:
    def __init__(self, space: FaultSpace, *,
                 train: Optional[TrainConfig] = None, verbose: bool = False, device="cuda"):
        from repro_torch.launch.serve import resolve_device
        ensure_registered()
        self.space = space
        self.train = train or TrainConfig()
        self.verbose = verbose
        self.device = resolve_device(str(device))

    def _log(self, msg: str):
        if self.verbose:
            print(f"[chaos] {msg}", flush=True)

    # -- public ---------------------------------------------------------------

    def run(self, workloads: Tuple[str, ...] = ("train", "serve", "solver")
            ) -> CampaignResult:
        t0 = time.time()
        results: List[FaultResult] = []
        bus_events: List[obs.Event] = []
        sub = obs.subscribe(bus_events.append)
        try:
            for spec in self.space:
                if spec.workload not in workloads:
                    continue
                self._log(f"spec {spec.name}")
                t1 = time.time()
                try:
                    res = self._run_spec(spec)
                except _Skip as sk:
                    res = self._skipped(spec, str(sk))
                res.wall_s = time.time() - t1
                self._log(f"  -> {res.outcome} (rung={res.rung}, "
                          f"end={res.end_state})")
                results.append(res)
            for ep in self.space.episodes:
                if ep.workload not in workloads:
                    continue
                self._log(f"episode {ep.name}")
                t1 = time.time()
                try:
                    rows = self._run_episode(ep)
                except _Skip as sk:
                    rows = [self._skipped_episode(ep, str(sk))]
                rows[-1].wall_s = time.time() - t1   # the episode-level row
                self._log(f"  -> {rows[-1].outcome} "
                          f"({len(rows) - 1} event(s))")
                results.extend(rows)
            results.extend(self._clean_rows(workloads))
        finally:
            obs.unsubscribe(sub)
        for res in results:
            if res.outcome == "false_alarm":
                obs.counter("repro_false_alarms_total",
                            "detector trips with no injected fault").inc()
            obs.event("chaos/classified", outcome=res.outcome,
                      spec=res.name, rung=res.rung)
        rungs = sorted({e.name[len("recovery/"):] for e in bus_events
                        if e.name.startswith("recovery/")})
        cuda = self.device.type == "cuda"
        meta = {
            "backend": self.device.type,
            "device_name": (torch.cuda.get_device_name(self.device)
                            if cuda else "cpu"),
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "train": dataclasses.asdict(self.train),
            "n_episodes": sum(1 for ep in self.space.episodes
                              if ep.workload in workloads),
            "wall_s": time.time() - t0,
            "obs_events": len(bus_events),
            "obs_rungs": rungs,
        }
        return CampaignResult(space=self.space.name, results=results,
                              meta=meta)

    # -- dispatch -------------------------------------------------------------

    def _run_spec(self, spec: FaultSpec) -> FaultResult:
        if spec.workload == "solver":
            return self._run_solver(spec)
        if spec.workload == "serve":
            return self._run_serve(spec)
        if spec.workload == "traffic":
            return self._run_traffic(spec)
        if spec.kind == "sdc_collective" and \
                spec.surface == "kernels.ops/acc_state":
            return self._run_kernel_data_flip(spec)
        if spec.kind == "checksum_state_flip":
            return self._run_kernel_state_flip(spec)
        if spec.kind == "flash_state_flip":
            return self._run_flash_state_flip(spec)
        if spec.kind in ("norm_corruption", "gather_corruption"):
            return self._run_layer_invariant(spec)
        return self._run_train(spec)

    def _skipped(self, spec: FaultSpec, why: str) -> FaultResult:
        s = get_surface(spec.surface)
        return FaultResult(
            name=spec.name, workload=spec.workload, kind=spec.kind,
            surface=spec.surface, protected=s.protected, promise=s.promise,
            outcome="skipped", detected=False, corrected=False, rung=None,
            recovery_latency_s=None, end_state="not_compared",
            max_abs_diff=None, wall_s=0.0, spec=spec.asdict(), note=why)

    def _result(self, spec: FaultSpec, *, detected, corrected, rung,
                latency, end_state, max_abs_diff, note="",
                warm_s=None, compile_s=None) -> FaultResult:
        s = get_surface(spec.surface)
        outcome = classify(injected=True, detected=detected,
                           corrected=corrected, end_state=end_state,
                           promise=s.promise)
        if rung is not None and latency is not None:
            obs.recovery(rung, latency, compile_s=compile_s, warm_s=warm_s,
                         spec=spec.name)
        return FaultResult(
            name=spec.name, workload=spec.workload, kind=spec.kind,
            surface=spec.surface, protected=s.protected, promise=s.promise,
            outcome=outcome, detected=detected, corrected=corrected,
            rung=rung, recovery_latency_s=latency, end_state=end_state,
            max_abs_diff=max_abs_diff, wall_s=0.0, spec=spec.asdict(),
            note=note, recovery_warm_s=warm_s, recovery_compile_s=compile_s)

    # -- runtimes the port has not brought up ---------------------------------

    def _run_train(self, spec: FaultSpec) -> FaultResult:
        raise _Skip(f"{spec.kind} under the train workload drills "
                    f"ElasticRuntime: comes with {_ELASTIC}")

    def _run_serve(self, spec: FaultSpec) -> FaultResult:
        raise _Skip(f"the serve drills need {_SERVE_FT}")

    def _run_traffic(self, spec: FaultSpec) -> FaultResult:
        raise _Skip(f"the traffic drills need {_PAGED}")

    def _run_solver(self, spec: FaultSpec) -> FaultResult:
        raise _Skip(f"the solver drills need {_SOLVER}")

    def _run_episode(self, ep: Episode) -> List[FaultResult]:
        raise _Skip(f"{ep.workload} episodes thread one live run of the "
                    f"workload's runtime: come with "
                    + {"train": _ELASTIC, "serve": _SERVE_FT,
                       "traffic": _PAGED}.get(ep.workload, _SOLVER))

    def _skipped_episode(self, ep: Episode, why: str) -> FaultResult:
        return FaultResult(
            name=f"episode:{ep.name}", workload=ep.workload, kind="episode",
            surface=f"episode/{ep.workload}", protected=True,
            promise="bit_identity" if ep.workload == "serve"
            else "tolerance",
            outcome="skipped", detected=False, corrected=False, rung=None,
            recovery_latency_s=None, end_state="not_compared",
            max_abs_diff=None, wall_s=0.0, spec=ep.asdict(), note=why,
            episode=ep.name)

    # -- kernel surface (train protection stack) ------------------------------

    def _kernel_drill_operands(self, spec: FaultSpec, rng, m, k, n):
        """(a1, a2, b1, b2, c0, out_dtype, tag) for the kernel-surface
        drills, from the reference's draws, honoring the spec's dtype
        variant ("" = fp32, "bf16", "int8")."""
        tag = spec.variant or "fp32"
        dev = self.device
        if tag == "int8":
            def mk(sh):
                return torch.from_numpy(
                    rng.randint(-4, 5, size=sh).astype(np.int8)).to(dev)
            a1, a2, b1, b2 = mk((m, k)), mk((m, k)), mk((k, n)), mk((k, n))
            return a1, a2, b1, b2, torch.zeros((m, n), dtype=torch.int32,
                                               device=dev), torch.int32, tag
        dt = torch.bfloat16 if tag == "bf16" else torch.float32

        def mk(sh):
            return torch.from_numpy(
                rng.standard_normal(sh).astype(np.float32)).to(dev, dt)
        a1, a2, b1, b2 = mk((m, k)), mk((m, k)), mk((k, n)), mk((k, n))
        return a1, a2, b1, b2, torch.zeros((m, n), dtype=torch.float32,
                                           device=dev), torch.float32, tag

    def _dtype_surface(self, spec: FaultSpec, result: FaultResult):
        """Suffix the RESULT surface with the dtype variant (the coverage
        matrix's dtype dimension); spec.surface stays registry-valid."""
        if spec.variant in ("bf16", "int8"):
            return dataclasses.replace(
                result, surface=f"{spec.surface}[{spec.variant}]")
        return result

    @staticmethod
    def _acc_plan(m, k, n):
        """The accumulate kernel's tiles for a drill of this size."""
        from repro_torch.kernels import ops
        plan = ops.pick_blocks(m, k, n, carry=True, require_exact=True)
        if plan is None:
            raise ValueError(f"no exact tiling for {(m, k, n)}")
        return plan

    def _run_kernel_state_flip(self, spec: FaultSpec) -> FaultResult:
        """Bit flip in the accumulate kernel's CARRIED CHECKSUM STATE
        between two chained calls.  The next call's verify prologue must
        see the residual (detected) but must NOT "repair": only one
        residual family trips, and rewriting data off a corrupted checksum
        would corrupt healthy values.  The flip hits the reference's
        element: it plans one 256 x 256 tile here and draws the column of
        that tile's plain-sum checksum row with ``randint(n)``.  The port's
        kernel tiles this shape 32 x 32, so it carries that column sum as
        m / 32 partials, and the flip lands on the first (rows 0-31)."""
        from repro_torch.kernels import ops

        rng = np.random.RandomState(spec.seed)
        m = n = k = 256
        plan = self._acc_plan(m, k, n)
        a1, a2, b1, b2, c0, out_dtype, tag = \
            self._kernel_drill_operands(spec, rng, m, k, n)
        st0 = ops.acc_state_zeros(plan, device=self.device)
        c1, st1, _ = ops.abft_matmul_acc(a1, b1, c0, st0, plan=plan,
                                         out_dtype=out_dtype)
        c2, _, _ = ops.abft_matmul_acc(a2, b2, c1, st1, plan=plan,
                                       out_dtype=out_dtype)
        ccol, crow = st1
        t_i, col = 0, int(rng.randint(n))
        flat = int(np.ravel_multi_index((t_i, 0, col), tuple(ccol.shape)))
        ccol_bad = flip_bit(ccol, flat, bit=spec.bit)
        c2f, _, stats = ops.abft_matmul_acc(a2, b2, c1, (ccol_bad, crow),
                                            plan=plan, out_dtype=out_dtype)
        detected = bool(stats[..., 0].any())
        repaired = bool(stats[..., 1].any())
        end_state, diff = _compare_trees(_host(c2f), _host(c2), 0.0)
        return self._dtype_surface(spec, self._result(
            spec, detected=detected, corrected=repaired, rung=None,
            latency=None, end_state=end_state, max_abs_diff=diff,
            note=f"[{tag}] flip in carried ccol tile {t_i} col {col}: one "
                 f"residual family trips -> detect-only by design (repair "
                 f"gate needs both); data must pass through untouched "
                 f"(repaired={repaired})"))

    def _run_kernel_data_flip(self, spec: FaultSpec) -> FaultResult:
        """SDC in the accumulate kernel's CARRIED DATA between two chained
        calls.  Both residual families trip in the next call's verify
        prologue, so the concentration-gated repair must locate the element
        and rewrite it from the carried plain-sum checksum: bit-exact on
        the int8 wire, within tolerance on the float paths."""
        from repro_torch.kernels import ops

        rng = np.random.RandomState(spec.seed)
        m = n = k = 256
        plan = self._acc_plan(m, k, n)
        a1, a2, b1, b2, c0, out_dtype, tag = \
            self._kernel_drill_operands(spec, rng, m, k, n)
        st0 = ops.acc_state_zeros(plan, device=self.device)
        c1, st1, _ = ops.abft_matmul_acc(a1, b1, c0, st0, plan=plan,
                                         out_dtype=out_dtype)
        c2, _, _ = ops.abft_matmul_acc(a2, b2, c1, st1, plan=plan,
                                       out_dtype=out_dtype)
        r_i = int(rng.randint(m))
        c_i = int(rng.randint(n))
        flat = int(np.ravel_multi_index((r_i, c_i), (m, n)))
        c1_bad = flip_bit(c1, flat, bit=spec.bit)
        _sync(self.device)
        t0 = time.perf_counter()
        c2f, _, stats = ops.abft_matmul_acc(a2, b2, c1_bad, st1, plan=plan,
                                            out_dtype=out_dtype)
        _sync(self.device)
        wall = time.perf_counter() - t0
        detected = bool(stats[..., 0].any())
        repaired = bool(stats[..., 1].any())
        warm = None
        if repaired:
            # the same repair once more, everything already built and
            # loaded: the second wall is the warm repair cost
            t0 = time.perf_counter()
            ops.abft_matmul_acc(a2, b2, c1_bad, st1, plan=plan,
                                out_dtype=out_dtype)
            _sync(self.device)
            warm = time.perf_counter() - t0
        tol = 0.0 if tag == "int8" else self.train.tol
        end_state, diff = _compare_trees(_host(c2f), _host(c2), tol)
        return self._dtype_surface(spec, self._result(
            spec, detected=detected, corrected=repaired,
            rung="kernel:masked_recompute" if repaired else None,
            latency=wall if repaired else None,
            warm_s=warm,
            compile_s=(max(wall - warm, 0.0)
                       if repaired and warm is not None else None),
            end_state=end_state, max_abs_diff=diff,
            note=f"[{tag}] bit {spec.bit} flip in carried data ({r_i},"
                 f"{c_i}): both residual families trip -> located and "
                 f"repaired from the plain-sum checksum "
                 f"(end_state={end_state})"))

    def _run_flash_state_flip(self, spec: FaultSpec) -> FaultResult:
        """Flip-sized delta into the flash kernel's running ``acc``
        accumulator (or the softmax rowsum ``l`` for variant="l")
        mid-sweep.  The epilogue's checksum residuals must flag the
        q-tile, and the detect-and-recompute path must patch it back to
        the clean output."""
        from repro_torch.kernels.flash_attention import (
            flash_attention_checked, flash_attention_cuda)

        rng = np.random.RandomState(spec.seed)
        bh, s, d = 2, 512, 64
        bq = bk = 128
        if spec.step >= s // bk:
            raise _Skip(f"inject KV step {spec.step} >= {s // bk} KV tiles")
        q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d))
                                    .astype(np.float32)).to(self.device)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        target = "l" if spec.variant == "l" else "acc"
        _sync(self.device)
        t0 = time.perf_counter()
        clean = flash_attention_cuda(q, k, v, scale=scale, causal=True,
                                     bq=bq, bk=bk)
        _sync(self.device)
        clean_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        o, rep = flash_attention_checked(
            q, k, v, scale=scale, causal=True, bq=bq, bk=bk,
            inject=(1, spec.step, spec.delta, target))
        _sync(self.device)
        drill_wall = time.perf_counter() - t0
        end_state, diff = _compare_trees(_host(o), _host(clean),
                                         self.train.tol)
        detected = not rep.ok
        corrected = rep.repaired > 0
        return self._result(
            spec, detected=detected, corrected=corrected,
            rung="flash:recompute_tile" if corrected else None,
            latency=max(drill_wall - clean_wall, 0.0) if detected else None,
            end_state=end_state, max_abs_diff=diff,
            note=f"delta {spec.delta:g} into {target} of tile (0,1) at KV "
                 f"step {spec.step}; residuals r_pv="
                 f"{rep.max_pv_residual:.2e} r_l={rep.max_rowsum_residual:.2e}"
                 f"; {len(rep.detected)} tile(s) flagged "
                 f"{list(rep.detected)}, {rep.repaired} recomputed dense")

    def _run_layer_invariant(self, spec: FaultSpec) -> FaultResult:
        """Corrupt the normalize / gather output and let the layer's own
        construction invariant (rmsnorm second moment, embedding checksum
        column) detect it; the repair is a recompute of the pure function
        from its (uncorrupted) inputs."""
        from repro_torch.models import layers

        rng = np.random.RandomState(spec.seed)
        dev = self.device
        if spec.kind == "norm_corruption":
            d = 64
            p = layers.rmsnorm_init(d, device=dev)
            x = torch.from_numpy(rng.standard_normal((4, 8, d))
                                 .astype(np.float32)).to(dev)
            clean = layers.rmsnorm_apply(p, x)
            bad, ok = layers.rmsnorm_apply(p, x, check=True,
                                           inject=spec.delta)
            _sync(dev)
            t0 = time.perf_counter()
            fixed, ok2 = (layers.rmsnorm_apply(p, x, check=True)
                          if not bool(ok) else (bad, ok))
            ok2 = bool(ok2)
            latency = time.perf_counter() - t0
            what = "rmsnorm second-moment"
        else:
            vocab, d = 128, 64
            gen = torch.Generator(device=dev).manual_seed(spec.seed)
            p = layers.embed_init(gen, vocab, d)
            tokens = torch.from_numpy(
                rng.randint(0, vocab, (4, 8)).astype(np.int64)).to(dev)
            clean = layers.embed_apply(p, tokens)
            bad, ok = layers.embed_apply(p, tokens, check=True,
                                         inject=spec.delta)
            _sync(dev)
            t0 = time.perf_counter()
            fixed, ok2 = (layers.embed_apply(p, tokens, check=True)
                          if not bool(ok) else (bad, ok))
            ok2 = bool(ok2)
            latency = time.perf_counter() - t0
            what = "embedding-gather checksum-column"
        detected = not bool(ok)
        corrected = detected and ok2
        end_state, diff = _compare_trees(_host(fixed), _host(clean), 0.0)
        return self._result(
            spec, detected=detected, corrected=corrected,
            rung="recompute" if corrected else None,
            latency=latency if detected else None,
            end_state=end_state, max_abs_diff=diff,
            note=f"delta {spec.delta:g} into the first output element; the "
                 f"{what} invariant {'tripped' if detected else 'missed'}; "
                 "recompute from uncorrupted inputs restores bit-identity")

    # -- clean sweeps ---------------------------------------------------------

    def _clean_rows(self, workloads) -> List[FaultResult]:
        """One clean-sweep row per workload.  Every workload's golden run
        needs a runtime the port has not brought up (the train golden is
        the protected ElasticRuntime loop), so each row is ``skipped``
        with the slice it waits for, never a golden it does not have."""
        sweeps = (
            ("train", "train:clean_sweep:1x1:protected",
             "dist.collectives/abft_psum", _ELASTIC),
            ("serve", "serve:clean_sweep:1x1",
             "serve.engine/logits_reduce", _SERVE_FT),
            ("solver", "solver:clean_sweep",
             "solvers.subspace_cg/correction_sum", _SOLVER),
            ("traffic", "traffic:clean_sweep:paged", "serve.paged_kv/pages",
             _PAGED),
        )
        return [FaultResult(
            name=name, workload=wl, kind="clean_sweep", surface=surface,
            protected=True, promise="none", outcome="skipped",
            detected=False, corrected=False, rung=None,
            recovery_latency_s=None, end_state="not_compared",
            max_abs_diff=None, wall_s=0.0,
            note=f"the {wl} golden run is not ported: comes with {why}")
            for wl, name, surface, why in sweeps if wl in workloads]


class _Skip(Exception):
    """A spec that cannot run in the port yet (reported, not dropped)."""

