"""Campaign runner: sweep a `FaultSpace` over the port's protection domains.

The counterpart of the reference package's ``repro/chaos/campaign.py``.
For every `FaultSpec` the runner builds the workload or drill its kind
calls for, injects exactly that fault, and classifies what happened:

  * **corrected**   — the domain detected the fault AND the end state
    honors its promise against a clean golden run (bit-identity where
    promised, tolerance where the repair is a float solve),
  * **detected**    — seen but not (fully) repaired, e.g. a flip in the
    accumulate kernel's carried *checksum* state (repairing would corrupt
    healthy data, so the kernel only flags it),
  * **missed**      — the fault ran to completion with no detector firing,
  * **false_alarm** — a detector fired on a clean run,
  * **skipped**     — the spec needs a runtime the port has not brought up
    yet, or more devices than one; the row says why.  A spec is never
    dropped.

Everything runs on the runner's device, one device, as the reference's
campaign runs on one device, from the same ``np.random.RandomState`` draws:

  * the train workload: an `ft.runtime.ElasticRuntime` loop (mesh 1 x 1)
    with SDC in the protected gradient reduction (``abft_reduce``), DRAM
    flips under the at-rest scrub (which re-encodes on kernel #3 on a CUDA
    tensor), and shard loss with diskless recovery at ``p = 1``;
  * the serve workload: a drilled `serve.engine.ServeEngine` (model extent
    1) with SDC in the verified unembed's reduction and KV-cache and params
    flips under its scrub;
  * multi-fault episodes of both, and the clean sweeps of every golden;
  * the kernel and layer drills: carried-state and carried-data flips on
    ``ops.abft_matmul_acc`` at 256³ (kernel #2 on a CUDA tensor), flash
    state flips on ``flash_attention_checked`` at ``[2, 512, 64]`` (kernel
    #4), and the rmsnorm and embedding-gather invariants of
    ``models/layers.py``.

Pod-loss and slow-pod faults need a pod mesh and the pod paths of port
slice 13; the solver workload comes with port slice 10 and the traffic
workload (``PagedServeEngine``) with port slice 9.  Their rows are
``skipped`` and name the slice.
"""
from __future__ import annotations

import dataclasses
import math
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.chaos.faults import (Episode, FailureInjector,
                                      FaultSpace, FaultSpec, SDCInjector,
                                      SDCPlan, ensure_registered, flip_bit,
                                      get_surface)
from repro_torch.tree import (keystr, stacked_leaves_with_path, tree_leaves,
                              tree_map, tree_replace)

__all__ = ["TrainConfig", "ServeConfig", "FaultResult", "CampaignResult",
           "CampaignRunner", "classify", "episode_outcome"]

# the slices that bring the runtimes the skipped handlers need
_ELASTIC = ("port slice 13 (multi-process distribution and "
            "ElasticRuntime's pod paths)")
_PAGED = "port slice 9 (paged serving: PagedServeEngine)"
_SOLVER = "port slice 10 (the subspace solver: RedundantSubspaceCG)"


# ---------------------------------------------------------------------------
# configs + result records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The train workload under drill (small on purpose: the campaign's
    job is coverage)."""
    arch: str = "qwen2-0.5b"
    steps: int = 6
    batch: int = 8
    seq: int = 16
    lr: float = 1e-3
    # end-state tolerance for "tolerance"-promise comparisons: float
    # repairs are near-exact, not bit-exact; the max|diff| is recorded
    tol: float = 1e-2
    pod_mesh: Tuple[int, ...] = (2, 2, 2)   # (pod, data, model) topology


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serve workload under drill."""
    arch: str = "qwen2-0.5b"
    slots: int = 4
    max_len: int = 48
    n_requests: int = 4
    prompt_len: int = 8
    max_new_tokens: int = 5
    mesh: Tuple[int, int] = (4, 2)          # (data, model) where the
    #                                         devices exist; else (1, 1)


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
                 train: Optional[TrainConfig] = None,
                 serve: Optional[ServeConfig] = None, verbose: bool = False,
                 device="cuda"):
        from repro_torch.launch.serve import resolve_device
        ensure_registered()
        self.space = space
        self.train = train or TrainConfig()
        self.serve = serve or ServeConfig()
        self.verbose = verbose
        self.device = resolve_device(str(device))
        self._train_golden: Dict[tuple, dict] = {}
        self._serve_golden: Dict[tuple, dict] = {}
        self._serve_eng = None        # the warmed drill-free engine, reused
        self._serve_scrub_eng = None  # ditto with the at-rest scrubber on
        self._tmp = tempfile.TemporaryDirectory(prefix="chaos-ckpt-")

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
            # every golden run doubles as a clean sweep: report it
            results.extend(self._clean_rows(workloads))
        finally:
            obs.unsubscribe(sub)
            # checkpoint dirs must not outlive the sweep; recreate so the
            # runner stays reusable
            self._serve_eng = None
            self._serve_scrub_eng = None
            self._tmp.cleanup()
            self._tmp = tempfile.TemporaryDirectory(prefix="chaos-ckpt-")
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
            "serve": dataclasses.asdict(self.serve),
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

    # -- workloads the port has not brought up --------------------------------

    def _run_traffic(self, spec: FaultSpec) -> FaultResult:
        raise _Skip(f"the traffic drills need {_PAGED}")

    def _run_solver(self, spec: FaultSpec) -> FaultResult:
        raise _Skip(f"the solver drills need {_SOLVER}")

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

    # -- train workload -------------------------------------------------------

    def _train_mesh(self, spec: FaultSpec):
        """(mesh_shape, axis_names, opts_tag) for one spec: every train
        fault the port drills runs on one device.  SDC and DRAM faults run
        under the fully protected step (deferred reduction + abft_reduce=
        "correct"); shard loss degrades to one device as the reference's
        does below a pod mesh (p = 1: the single logical shard is lost and
        rebuilt); pod faults need the pod mesh."""
        if spec.kind in ("pod_loss", "slow_pod"):
            raise _Skip(f"needs {math.prod(self.train.pod_mesh)} devices for "
                        f"pod mesh {self.train.pod_mesh}, have 1: the pod "
                        f"paths come with {_ELASTIC}")
        if spec.kind == "shard_loss":
            return (1, 1), ("data", "model"), "plain"
        return (1, 1), ("data", "model"), "protected"

    def _train_opts(self, tag: str):
        from repro_torch.train.step import StepOptions
        if tag == "protected":
            return StepOptions(remat=False, defer_grad_reduce=True,
                               abft_reduce="correct")
        return StepOptions(remat=False)

    def _train_runtime(self, mesh_shape, names, tag, *, policy=None,
                       injector=None, with_disk=False):
        from repro_torch.ckpt.disk import CheckpointManager
        from repro_torch.configs.base import ShapeConfig, smoke_config
        from repro_torch.ft.runtime import ElasticRuntime, FTPolicy
        from repro_torch.train.optimizer import AdamWConfig

        cfg = smoke_config(self.train.arch)
        shape = ShapeConfig("chaos", self.train.seq, self.train.batch,
                            "train")
        adamw = AdamWConfig(lr=self.train.lr,
                            total_steps=self.train.steps, warmup_steps=1)
        mgr = None
        if with_disk:
            d = tempfile.mkdtemp(dir=self._tmp.name)
            mgr = CheckpointManager(d, keep=self.train.steps + 1)
        return ElasticRuntime(
            cfg, shape, dict(zip(names, mesh_shape)), adamw=adamw,
            opts=self._train_opts(tag),
            policy=policy or FTPolicy(diskless_every=10 ** 6,
                                      disk_every=10 ** 6),
            ckpt_manager=mgr, injector=injector, device=self.device)

    def _scrub_policy(self):
        from repro_torch.ft.runtime import FTPolicy
        # encode + verify every step so any fire step is a scrub step (the
        # real cadence knob is FTPolicy.scrub_every; drills run it at 1)
        return FTPolicy(diskless_every=1, disk_every=10 ** 6,
                        scrub_every=1)

    def _drill_step(self, rt, events):
        """The runtime's step with ``events`` injected into its protected
        gradient reduction (`StepOptions.sdc_inject`)."""
        from repro_torch.train.step import build_train_step
        opts = dataclasses.replace(
            rt.opts, sdc_inject=events[0] if len(events) == 1
            else tuple(events))
        return build_train_step(rt.cfg, rt.shape, rt.adamw, opts)

    def _timed_step(self, fn, state, batch):
        """``fn(state, batch)`` with its wall (device synchronized)."""
        _sync(self.device)
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        _sync(self.device)
        return state, m, time.perf_counter() - t0

    def _golden_train(self, mesh_shape, names, tag, steps=None) -> dict:
        """Clean run for one (mesh, opts, horizon) configuration, cached.
        The "scrub" tag runs the at-rest scrubber's full cadence (encode +
        verify every step) so its clean sweep doubles as the false-alarm
        check for the DRAM detectors.  Episodes whose last event lands
        beyond the standard workload pass a longer ``steps`` horizon; each
        horizon is its own golden (and its own clean-sweep row)."""
        steps = self.train.steps if steps is None else steps
        key = (tuple(mesh_shape), tag, steps)
        if key in self._train_golden:
            return self._train_golden[key]
        self._log(f"golden train {mesh_shape} [{tag}] {steps} steps")
        scrub = tag == "scrub"
        rt = self._train_runtime(mesh_shape, names, tag,
                                 policy=self._scrub_policy() if scrub
                                 else None)
        try:
            state = rt.init_state(0)
            oks, walls, losses = [], [], []
            scrub_trips, scrub_walls = 0, []
            for i in range(steps):
                if scrub:
                    rt.checkpoint(i, state)
                    t0 = time.perf_counter()
                    state, rep = rt.scrub(i, state)
                    scrub_walls.append(time.perf_counter() - t0)
                    if rep is not None:
                        scrub_trips += 1
                state, m = rt.train_step(i, state)
                walls.append(rt.step_times[-1])
                losses.append(float(m["loss"]))
                if "abft_ok" in m:
                    oks.append(bool(m["abft_ok"]))
            g = {"final": _host(state), "losses": losses, "walls": walls,
                 "oks": oks,
                 "detections": sum(1 for o in oks if not o) + scrub_trips,
                 "scrub_trips": scrub_trips, "scrub_walls": scrub_walls,
                 "mesh_shape": tuple(mesh_shape), "tag": tag,
                 "steps": steps}
        finally:
            rt.close()
        self._train_golden[key] = g
        return g

    def _run_train(self, spec: FaultSpec) -> FaultResult:
        # a spec whose fire step lies beyond the workload never injects:
        # classifying it would fabricate a "missed".  slow_pod is exempt:
        # its injection is the per-step heartbeat delay, active from step 0
        if spec.kind != "slow_pod" and spec.step >= self.train.steps:
            raise _Skip(f"fire step {spec.step} >= workload steps "
                        f"{self.train.steps}: fault would never inject")
        if spec.kind in ("pod_loss", "slow_pod"):
            self._train_mesh(spec)      # raises _Skip: no pod mesh here
        handlers = {
            "sdc_collective": self._train_sdc,
            "dram_params": self._train_dram,
            "dram_opt_state": self._train_dram,
            "shard_loss": self._train_shard_loss,
        }
        return handlers[spec.kind](spec)

    def _train_sdc(self, spec: FaultSpec) -> FaultResult:
        """Bit-flip-sized delta into one protected gradient reduction of
        one step: the drilled step is a second step function (the
        injection is fixed when the step is built), as in the reference."""
        mesh_shape, names, tag = self._train_mesh(spec)
        golden = self._golden_train(mesh_shape, names, tag)
        rt = self._train_runtime(mesh_shape, names, tag)
        try:
            drill_fn = self._drill_step(rt, [(spec.shard, spec.delta)])
            state = rt.init_state(0)
            detected = False
            drill_wall = None
            for i in range(self.train.steps):
                if i == spec.step:
                    state, m, drill_wall = self._timed_step(
                        drill_fn, state, rt.place_batch(i))
                    detected = not bool(m["abft_ok"])
                else:
                    state, m = rt.train_step(i, state)
            end_state, diff = _compare_trees(_host(state), golden["final"],
                                             self.train.tol)
        finally:
            rt.close()
        clean_mean = sum(golden["walls"]) / len(golden["walls"])
        latency = (max(drill_wall - clean_mean, 0.0)
                   if (detected and drill_wall is not None) else None)
        return self._result(
            spec, detected=detected, corrected=detected, rung="abft_inflight"
            if detected else None, latency=latency, end_state=end_state,
            max_abs_diff=diff,
            # eager steps: nothing to compile, the latency is warm
            warm_s=latency, compile_s=0.0 if latency is not None else None,
            note="correction fused into the reduction; end state compared "
                 "against the clean golden run")

    def _train_dram(self, spec: FaultSpec) -> FaultResult:
        """Silent bit flip in resident state between steps.  The in-flight
        checksums cannot see it (they are computed from inputs at call
        time, so corrupted state checksums consistently): detection is the
        at-rest scrubber's job, checksum-on-write at the diskless encode,
        verify-on-read before the next step, snapshot rollback on a trip
        (`ft.runtime.ElasticRuntime.scrub`)."""
        mesh_shape, names, _ = self._train_mesh(spec)
        golden = self._golden_train(mesh_shape, names, "scrub")
        rt = self._train_runtime(mesh_shape, names, "scrub",
                                 policy=self._scrub_policy())
        group = "params" if spec.kind == "dram_params" else "opt"
        try:
            state = rt.init_state(0)
            detected = False
            latency = None
            leaf_name = None
            resid = None
            for i in range(self.train.steps):
                rt.checkpoint(i, state)
                if i == spec.step:
                    state, leaf_name = _flip_state_leaf(state, group, spec)
                state, rep = rt.scrub(i, state)
                if rep is not None and rep.rolled_back:
                    detected = True
                    latency = rep.wall_s
                    resid = rep.residual
                state, m = rt.train_step(i, state)
            end_state, diff = _compare_trees(_host(state), golden["final"],
                                             self.train.tol)
            warm = None
            if detected:
                # the same encode -> flip -> scrub rollback once more: the
                # second wall is the warm repair cost
                n = self.train.steps
                rt.checkpoint(n, state)
                state2, _ = _flip_state_leaf(state, group, spec)
                _, rep2 = rt.scrub(n, state2)
                if rep2 is not None and rep2.rolled_back:
                    warm = rep2.wall_s
        finally:
            rt.close()
        return self._result(
            spec, detected=detected, corrected=detected,
            warm_s=warm,
            compile_s=(max(latency - warm, 0.0)
                       if (latency is not None and warm is not None)
                       else None),
            rung="scrub:diskless" if detected else None, latency=latency,
            end_state=end_state, max_abs_diff=diff,
            note=f"bit {spec.bit} flipped in {group} leaf {leaf_name!r} at "
                 f"step {spec.step}; scrub residual "
                 f"{resid if resid is None else f'{resid:.2e}'} -> snapshot "
                 "rollback" if detected else
                 f"bit {spec.bit} flipped in {group} leaf {leaf_name!r} at "
                 f"step {spec.step}; scrubber never tripped")

    def _train_shard_loss(self, spec: FaultSpec) -> FaultResult:
        """Erasure of one DP shard (platform-signaled) -> rung-2 diskless
        recovery and a bounded-rollback replay."""
        from repro_torch.ft.runtime import FTPolicy

        mesh_shape, names, tag = self._train_mesh(spec)
        golden = self._golden_train(mesh_shape, names, tag)
        policy = FTPolicy(diskless_every=2, disk_every=10 ** 6, f=1)
        rt = self._train_runtime(mesh_shape, names, tag, policy=policy,
                                 injector=FailureInjector(
                                     spec.failure_plan()))
        if not 0 <= spec.shard < rt.p:
            rt.close()
            raise _Skip(f"shard {spec.shard} outside DP extent {rt.p}: a "
                        f"DP extent above 1 comes with {_ELASTIC}")
        try:
            state = rt.init_state(0)
            detected = False
            rung = None
            latency = None
            i = 0
            while i < self.train.steps:
                rt.checkpoint(i, state)
                t0 = time.perf_counter()
                state, rollback = rt.maybe_shard_failure(i, state)
                if rollback is not None:
                    latency = time.perf_counter() - t0
                    detected = True
                    rung = "diskless"
                    i = rollback   # deterministic pipeline replays exactly
                    continue
                state, _ = rt.train_step(i, state)
                i += 1
            end_state, diff = _compare_trees(_host(state), golden["final"],
                                             self.train.tol)
        finally:
            rt.close()
        return self._result(
            spec, detected=detected, corrected=detected, rung=rung,
            latency=latency, end_state=end_state, max_abs_diff=diff,
            note="detection is the platform's failure signal (simulated); "
                 "lost shard solved from the checksums, rollback bounded "
                 "by the encode cadence")

    # -- serve workload -------------------------------------------------------

    def _serve_mesh(self):
        """One device: the model extent is 1 (the reference's fallback
        below ``prod(ServeConfig.mesh)`` devices)."""
        return (1, 1)

    def _serve_prompts(self):
        from repro_torch.configs.base import smoke_config
        cfg = smoke_config(self.serve.arch)
        rs = np.random.RandomState(0)
        return cfg, [rs.randint(0, cfg.vocab_size,
                                self.serve.prompt_len).tolist()
                     for _ in range(self.serve.n_requests)]

    def _serve_engine(self, sdc=None, scrub: int = 0):
        from repro_torch.models import transformer as tf
        from repro_torch.serve.engine import ServeEngine

        cfg, prompts = self._serve_prompts()
        if sdc is None:
            # drill-free engines are identical across golden and DRAM
            # specs: build and warm once, reset() between runs; scrubbed
            # and unscrubbed engines are cached apart
            cached = self._serve_scrub_eng if scrub else self._serve_eng
            if cached is not None:
                cached.reset()
                return cached, prompts
        gen = torch.Generator(device=self.device).manual_seed(0)
        params = tf.init_params(gen, cfg)
        eng = ServeEngine(cfg, params, slots=self.serve.slots,
                          max_len=self.serve.max_len, abft_reduce="correct",
                          sdc=sdc, scrub_every=scrub)
        eng.warm(prompt_len=self.serve.prompt_len)
        if sdc is None:
            if scrub:
                self._serve_scrub_eng = eng
            else:
                self._serve_eng = eng
        return eng, prompts

    def _drive(self, eng, prompts, on_step=None):
        from repro_torch.serve.engine import Request
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p,
                               max_new_tokens=self.serve.max_new_tokens))
        fin = eng.run(on_step=on_step)
        return {r.rid: list(r.output) for r in fin}

    def _golden_serve(self, scrub: int = 0) -> dict:
        key = self._serve_mesh() + (("scrub",) if scrub else ())
        if key in self._serve_golden:
            return self._serve_golden[key]
        self._log(f"golden serve mesh {key}")
        eng, prompts = self._serve_engine(scrub=scrub)
        outputs = self._drive(eng, prompts)
        g = {"outputs": outputs, "stats": eng.stats.summary(),
             "detections": eng.stats.detections, "mesh": key}
        self._serve_golden[key] = g
        return g

    def _run_serve(self, spec: FaultSpec) -> FaultResult:
        golden = self._golden_serve()
        if spec.kind == "sdc_collective":
            m_ext = self._serve_mesh()[1]
            if not 0 <= spec.shard < m_ext:
                raise _Skip(f"shard {spec.shard} outside model extent "
                            f"{m_ext}: a model extent above 1 comes with "
                            f"{_ELASTIC}")
            eng, prompts = self._serve_engine(
                sdc=SDCInjector(spec.sdc_plan()))
            outputs = self._drive(eng, prompts)
            st = eng.stats
            if not st.events:
                raise _Skip(f"planned SDC at decode step {spec.step} never "
                            f"fired ({st.decode_steps} decode steps ran)")
            detected = st.detections > 0
            corrected = st.corrections > 0 and all(
                e.corrected for e in st.events)
            end_state = ("bit_identical" if outputs == golden["outputs"]
                         else "diverged")
            lat = st.recovery_latency_s() if detected else None
            return self._result(
                spec, detected=detected, corrected=corrected,
                rung="abft_inflight" if detected else None,
                latency=lat,
                # the engine is warmed before the drill, so the marginal
                # drill-step wall is already warm
                warm_s=lat, compile_s=0.0 if lat is not None else None,
                end_state=end_state,
                max_abs_diff=0.0 if end_state == "bit_identical" else None,
                note=f"{st.detections} detection(s) in "
                     f"{st.decode_steps} decode steps; located "
                     + ", ".join(f"(r{e.row},c{e.col})" for e in st.events))
        if spec.kind in ("dram_kv_cache", "dram_params"):
            golden = self._golden_serve(scrub=1)
            eng, prompts = self._serve_engine(scrub=1)
            fired = {}

            def on_step(engine, step):
                if step == spec.step and not fired:
                    fired["leaf"], fired["undo"] = _flip_engine_bit(engine,
                                                                    spec)

            try:
                outputs = self._drive(eng, prompts, on_step=on_step)
            finally:
                if "undo" in fired:
                    fired["undo"]()     # the engine is shared: put the
                    #                     pre-flip leaf back
            st = eng.stats
            if not fired:
                raise _Skip(f"flip step {spec.step} never reached "
                            f"({st.decode_steps} decode steps ran)")
            evs = st.scrub_events
            detected = bool(evs)
            corrected = detected and all(e.repaired for e in evs)
            rung = None
            if detected:
                rung = ("scrub:kv_repair" if evs[0].domain == "kv"
                        else "scrub:restore")
            end_state = ("bit_identical" if outputs == golden["outputs"]
                         else "diverged")
            latency = (sum(e.wall_s for e in evs) / len(evs)
                       if evs else None)
            warm = None
            if detected and corrected:
                # re-flip the same leaf and scrub again: the repair
                # rewrites the leaf back, so the shared engine stays clean
                _, undo2 = _flip_engine_bit(eng, spec)
                n0 = len(st.scrub_events)
                eng._scrub_check()
                evs2 = [e for e in st.scrub_events[n0:] if e.repaired]
                if evs2:
                    warm = sum(e.wall_s for e in evs2) / len(evs2)
                undo2()
            return self._result(
                spec, detected=detected, corrected=corrected, rung=rung,
                latency=latency,
                warm_s=warm,
                compile_s=(max(latency - warm, 0.0)
                           if latency is not None and warm is not None
                           else None),
                end_state=end_state,
                max_abs_diff=0.0 if end_state == "bit_identical" else None,
                note=f"bit {spec.bit} flipped in {fired.get('leaf')!r} at "
                     f"decode step {spec.step}; scrub "
                     + (", ".join(
                         f"{e.domain}:{e.leaf}"
                         + (f"[slot {e.slot}]" if e.slot >= 0 else "")
                         for e in evs) or "never tripped")
                     + f"; outputs "
                     f"{'unchanged' if end_state == 'bit_identical' else 'diverged'}")
        raise ValueError(f"unhandled serve kind {spec.kind!r}")

    # -- multi-fault episodes -------------------------------------------------

    def _run_episode(self, ep: Episode) -> List[FaultResult]:
        """Deliver every event of one episode into ONE live run and
        classify both the per-event recoveries and the joint end state.
        Returns the per-event rows followed by the episode-level row."""
        if ep.workload == "train":
            return self._episode_train(ep)
        if ep.workload == "serve":
            return self._episode_serve(ep)
        if ep.workload == "traffic":
            raise _Skip(f"traffic episodes need {_PAGED}")
        raise _Skip(f"solver episodes need {_SOLVER}")

    @staticmethod
    def _fresh_events(specs) -> List[dict]:
        return [dict(fired=False, detected=False, corrected=False,
                     absorbed=False, rung=None, latency=None, note="")
                for _ in specs]

    def _episode_event_row(self, ep: Episode, spec: FaultSpec, idx: int, *,
                           fired, detected, corrected, absorbed, rung,
                           latency, note) -> FaultResult:
        s = get_surface(spec.surface)
        if not fired:
            outcome = "skipped"
        elif absorbed:
            outcome = "absorbed"
        elif not detected:
            outcome = "missed"
        elif corrected:
            outcome = "corrected"
        else:
            outcome = "detected"
        return FaultResult(
            name=f"{ep.name}::e{idx}:{spec.kind}", workload=ep.workload,
            kind=spec.kind, surface=spec.surface, protected=s.protected,
            promise=s.promise, outcome=outcome, detected=detected,
            corrected=corrected, rung=rung, recovery_latency_s=latency,
            end_state="not_compared", max_abs_diff=None, wall_s=0.0,
            spec=spec.asdict(), note=note, episode=ep.name)

    def _episode_row(self, ep: Episode, event_rows, *, end_state, diff,
                     note="", false_alarms=0) -> FaultResult:
        promise = ("bit_identity" if ep.workload == "serve"
                   else "tolerance")
        outcome = episode_outcome([r.outcome for r in event_rows],
                                  end_ok=_end_ok(promise, end_state),
                                  false_alarms=false_alarms)
        rungs = sorted({r.rung for r in event_rows if r.rung})
        lats = [r.recovery_latency_s for r in event_rows
                if r.recovery_latency_s is not None]
        return FaultResult(
            name=f"episode:{ep.name}", workload=ep.workload, kind="episode",
            surface=f"episode/{ep.workload}", protected=True,
            promise=promise, outcome=outcome,
            detected=any(r.detected for r in event_rows),
            corrected=outcome == "corrected",
            rung="+".join(rungs) if rungs else None,
            recovery_latency_s=sum(lats) if lats else None,
            end_state=end_state, max_abs_diff=diff, wall_s=0.0,
            spec=ep.asdict(), note=note, episode=ep.name)

    def _episode_train(self, ep: Episode) -> List[FaultResult]:
        """All events through ONE live ElasticRuntime loop.  Per-step
        order: encode (clean) -> DRAM flips -> shard failures -> scrub ->
        (drilled) step.  A shard-loss recovery restores the step's
        pre-flip encode, so a DRAM flip landing in the same window is
        ABSORBED by the rollback: attributed to the episode, not reported
        as a miss."""
        from repro_torch.ft.runtime import FTPolicy

        specs = ep.resolved()
        kinds = {sp.kind for sp in specs}
        supported = {"sdc_collective", "dram_params", "dram_opt_state",
                     "shard_loss", "pod_loss"}
        if kinds - supported:
            raise _Skip(f"no train episode adapter for kinds "
                        f"{sorted(kinds - supported)}")
        if "pod_loss" in kinds:
            raise _Skip(f"needs {math.prod(self.train.pod_mesh)} devices "
                        f"for pod mesh {self.train.pod_mesh}, have 1: the "
                        f"pod paths come with {_ELASTIC}")
        needs_sdc = "sdc_collective" in kinds
        mesh_shape, names = (1, 1), ("data", "model")
        tag = "protected" if needs_sdc else "plain"
        horizon = max(self.train.steps, max(sp.step for sp in specs) + 2)
        golden = self._golden_train(mesh_shape, names, tag, steps=horizon)
        any_dram = bool(kinds & {"dram_params", "dram_opt_state"})
        policy = FTPolicy(diskless_every=1, disk_every=10 ** 6, f=1,
                          scrub_every=1)
        rt = self._train_runtime(mesh_shape, names, tag, policy=policy)
        ev = self._fresh_events(specs)
        false_alarms = 0
        by_step: Dict[str, Dict[int, List[int]]] = {"sdc": {}, "dram": {}}
        for j, sp in enumerate(specs):
            if sp.kind == "sdc_collective":
                by_step["sdc"].setdefault(sp.step, []).append(j)
            elif sp.kind in ("dram_params", "dram_opt_state"):
                by_step["dram"].setdefault(sp.step, []).append(j)
        try:
            rt.injectors = tuple(
                FailureInjector(dataclasses.replace(
                    sp, shard=sp.shard % rt.p).failure_plan())
                for sp in specs if sp.kind == "shard_loss")
            drill_fns = {
                step: self._drill_step(rt, [(specs[j].shard % rt.p,
                                             specs[j].delta) for j in js])
                for step, js in by_step["sdc"].items()}
            state = rt.init_state(0)
            pending_dram: List[int] = []
            i = 0
            spins = 0
            while i < horizon:
                spins += 1
                if spins > 8 * horizon:
                    raise RuntimeError("episode loop did not converge")
                # encode BEFORE this step's faults: the snapshot any
                # recovery restores is clean by construction
                rt.checkpoint(i, state)
                for j in by_step["dram"].get(i, []):
                    if ev[j]["fired"]:
                        continue
                    sp = specs[j]
                    group = ("params" if sp.kind == "dram_params"
                             else "opt")
                    state, leaf = _flip_state_leaf(state, group, sp)
                    ev[j]["fired"] = True
                    ev[j]["note"] = (f"bit {sp.bit} in {group} leaf "
                                     f"{leaf!r} at step {i}")
                    pending_dram.append(j)
                t1 = time.perf_counter()
                state, rollback = rt.maybe_shard_failure(i, state)
                if rollback is not None:
                    lat = time.perf_counter() - t1
                    for j, sp in enumerate(specs):
                        if (sp.kind == "shard_loss" and sp.step == i
                                and not ev[j]["fired"]):
                            ev[j].update(fired=True, detected=True,
                                         corrected=True, rung="diskless",
                                         latency=lat)
                    # the recovery restored this step's pre-flip encode:
                    # co-windowed flips were erased before any detector
                    # saw them — absorbed by the episode, not missed
                    for k in pending_dram:
                        ev[k].update(
                            absorbed=True,
                            note=ev[k]["note"] + "; absorbed by the "
                                                 "recovery rollback")
                    pending_dram = []
                    i = rollback
                    continue
                if any_dram:
                    state, srep = rt.scrub(i, state)
                    if srep is not None and srep.rolled_back:
                        if pending_dram:
                            for k in pending_dram:
                                ev[k].update(detected=True, corrected=True,
                                             rung="scrub:diskless",
                                             latency=srep.wall_s)
                            pending_dram = []
                        else:
                            false_alarms += 1
                sdc_js = [j for j in by_step["sdc"].get(i, [])
                          if not ev[j]["fired"]]
                if sdc_js:
                    state, m, lat = self._timed_step(
                        drill_fns[i], state, rt.place_batch(i))
                    det = not bool(m["abft_ok"])
                    clean_mean = sum(golden["walls"]) / len(golden["walls"])
                    for j in sdc_js:
                        ev[j].update(
                            fired=True, detected=det, corrected=det,
                            rung="abft_inflight" if det else None,
                            latency=max(lat - clean_mean, 0.0) if det
                            else None,
                            note=f"correction fused into reduction at "
                                 f"step {i}")
                else:
                    state, m = rt.train_step(i, state)
                    if "abft_ok" in m and not bool(m["abft_ok"]):
                        false_alarms += 1
                i += 1
            end_state, diff = _compare_trees(_host(state), golden["final"],
                                             self.train.tol)
        finally:
            rt.close()
        rows = [self._episode_event_row(
            ep, sp, j, fired=e["fired"], detected=e["detected"],
            corrected=e["corrected"], absorbed=e["absorbed"],
            rung=e["rung"], latency=e["latency"], note=e["note"])
            for j, (sp, e) in enumerate(zip(specs, ev))]
        rows.append(self._episode_row(
            ep, rows, end_state=end_state, diff=diff,
            false_alarms=false_alarms,
            note=f"{len(specs)} event(s) over {horizon} steps on "
                 f"{'x'.join(map(str, mesh_shape))} [{tag}]"))
        return rows

    def _episode_serve(self, ep: Episode) -> List[FaultResult]:
        """All events through ONE live decode: the SDC events ride a
        multi-event SDCPlan into the protected logits reduction, the DRAM
        events flip engine state between decode steps and must be caught
        by the at-rest scrubber; outputs must stay bit-identical to the
        scrubbed golden decode."""
        specs = ep.resolved()
        kinds = {sp.kind for sp in specs}
        supported = {"sdc_collective", "dram_kv_cache", "dram_params"}
        if kinds - supported:
            raise _Skip(f"no serve episode adapter for kinds "
                        f"{sorted(kinds - supported)}")
        golden = self._golden_serve(scrub=1)
        m_ext = self._serve_mesh()[1]
        sdc_js = [j for j, sp in enumerate(specs)
                  if sp.kind == "sdc_collective"]
        plan = SDCPlan(tuple((specs[j].step, specs[j].shard % m_ext,
                              specs[j].delta) for j in sdc_js)) \
            if sdc_js else None
        ev = self._fresh_events(specs)
        flips: List[tuple] = []

        def on_step(engine, step):
            for j, sp in enumerate(specs):
                if (sp.kind in ("dram_kv_cache", "dram_params")
                        and sp.step == step and not ev[j]["fired"]):
                    leaf, undo = _flip_engine_bit(engine, sp)
                    ev[j]["fired"] = True
                    ev[j]["note"] = (f"bit {sp.bit} in {leaf!r} at decode "
                                     f"step {step}")
                    flips.append((j, sp, undo))

        eng, prompts = self._serve_engine(
            sdc=SDCInjector(plan) if plan else None, scrub=1)
        try:
            outputs = self._drive(eng, prompts, on_step=on_step)
        finally:
            for _, sp, undo in flips:
                if sp.kind == "dram_params":
                    undo()      # shared engines: params must be restored
        st = eng.stats
        # SDC attribution: the injector fires plan events in step order,
        # which is also the specs' (offset-sorted) order
        for j, e in zip(sdc_js, st.events):
            ev[j].update(fired=True, detected=st.detections > 0,
                         corrected=bool(e.corrected),
                         rung="abft_inflight" if st.detections else None,
                         latency=st.recovery_latency_s(),
                         note=f"located (r{e.row},c{e.col})")
        # DRAM attribution: scrub events matched by domain in fire order
        by_domain = {"kv": [e for e in st.scrub_events
                            if e.domain == "kv"],
                     "params": [e for e in st.scrub_events
                                if e.domain != "kv"]}
        for j, sp, _ in flips:
            dom = "kv" if sp.kind == "dram_kv_cache" else "params"
            if by_domain[dom]:
                e = by_domain[dom].pop(0)
                ev[j].update(
                    detected=True, corrected=bool(e.repaired),
                    rung=("scrub:kv_repair" if dom == "kv"
                          else "scrub:restore"),
                    latency=e.wall_s,
                    note=ev[j]["note"] + f"; scrub {e.domain}:{e.leaf}")
        false_alarms = sum(len(v) for v in by_domain.values())
        for j, sp in enumerate(specs):
            if not ev[j]["fired"] and not ev[j]["note"]:
                ev[j]["note"] = (f"never fired: decode ran "
                                 f"{st.decode_steps} step(s)")
        end_state = ("bit_identical" if outputs == golden["outputs"]
                     else "diverged")
        rows = [self._episode_event_row(
            ep, sp, j, fired=e["fired"], detected=e["detected"],
            corrected=e["corrected"], absorbed=e["absorbed"],
            rung=e["rung"], latency=e["latency"], note=e["note"])
            for j, (sp, e) in enumerate(zip(specs, ev))]
        rows.append(self._episode_row(
            ep, rows, end_state=end_state,
            diff=0.0 if end_state == "bit_identical" else None,
            false_alarms=false_alarms,
            note=f"{len(specs)} event(s) over {st.decode_steps} decode "
                 f"steps; outputs "
                 f"{'bit-identical' if end_state == 'bit_identical' else 'diverged'}"))
        return rows

    # -- clean sweeps ---------------------------------------------------------

    def _clean_rows(self, workloads) -> List[FaultResult]:
        """Every golden run as a clean-sweep row; the solver and traffic
        workloads, whose goldens are not ported, as ``skipped`` rows
        naming their slice."""
        rows = []
        if "train" in workloads and not self._train_golden:
            # no train spec ran: still sweep the base protected config
            self._golden_train((1, 1), ("data", "model"), "protected")
        if "serve" in workloads and not self._serve_golden:
            self._golden_serve()
        for (shape, tag, steps), g in sorted(self._train_golden.items()):
            detected = g["detections"] > 0
            outcome = classify(injected=False, detected=detected,
                               corrected=False, end_state="bit_identical",
                               promise="none")
            sweep_surface = ("dist.collectives/abft_psum"
                             if tag == "protected" else
                             "state.params_at_rest" if tag == "scrub" else
                             "ft.runtime/topology" if len(shape) == 3
                             else "ckpt.diskless/shards")
            note = (f"{g['detections']} detection(s) over "
                    f"{steps} clean steps "
                    f"({len(g['oks'])} protected reductions observed)")
            if tag == "scrub":
                note = (f"{g['scrub_trips']} scrub trip(s) over "
                        f"{len(g['scrub_walls'])} clean at-rest scrubs "
                        f"(mean verify "
                        f"{1e3 * sum(g['scrub_walls']) / max(len(g['scrub_walls']), 1):.1f} ms, "
                        "off the step critical path)")
            name = f"train:clean_sweep:{'x'.join(map(str, shape))}:{tag}"
            if steps != self.train.steps:
                # episode horizons run their own goldens; keep the
                # standard sweeps' names stable for gate lists
                name += f":{steps}st"
            rows.append(FaultResult(
                name=name, workload="train", kind="clean_sweep",
                surface=sweep_surface, protected=True, promise="none",
                outcome=outcome, detected=detected, corrected=False,
                rung=None, recovery_latency_s=None,
                end_state="bit_identical", max_abs_diff=0.0,
                wall_s=sum(g["walls"]), note=note))
        for key, g in sorted(self._serve_golden.items(), key=str):
            detected = g["detections"] > 0
            outcome = classify(injected=False, detected=detected,
                               corrected=False, end_state="bit_identical",
                               promise="none")
            scrub = key[-1] == "scrub"
            note = (f"{g['detections']} detection(s) over "
                    f"{g['stats']['decode_steps']} clean decode steps")
            if scrub:
                note += (f", {g['stats']['scrub_checks']} at-rest scrubs "
                         f"(KV + params fingerprints)")
            rows.append(FaultResult(
                name=f"serve:clean_sweep:{'x'.join(map(str, key))}",
                workload="serve", kind="clean_sweep",
                surface=("serve.engine/kv_cache_at_rest" if scrub
                         else "serve.engine/logits_reduce"), protected=True,
                promise="none", outcome=outcome, detected=detected,
                corrected=False, rung=None, recovery_latency_s=None,
                end_state="bit_identical", max_abs_diff=0.0,
                wall_s=g["stats"]["decode_s"] + g["stats"]["prefill_s"],
                note=note))
        sweeps = (
            ("solver", "solver:clean_sweep",
             "solvers.subspace_cg/correction_sum", _SOLVER),
            ("traffic", "traffic:clean_sweep:paged", "serve.paged_kv/pages",
             _PAGED),
        )
        rows.extend(FaultResult(
            name=name, workload=wl, kind="clean_sweep", surface=surface,
            protected=True, promise="none", outcome="skipped",
            detected=False, corrected=False, rung=None,
            recovery_latency_s=None, end_state="not_compared",
            max_abs_diff=None, wall_s=0.0,
            note=f"the {wl} golden run is not ported: comes with {why}")
            for wl, name, surface, why in sweeps if wl in workloads)
        return rows

class _Skip(Exception):
    """A spec that cannot run in the port yet (reported, not dropped)."""


# ---------------------------------------------------------------------------
# DRAM flip helpers
# ---------------------------------------------------------------------------


def _flip_candidates(tree, *, min_ndim: int = 0):
    """Flippable leaves of a tree in the reference's layout (a layout
    group's layers stacked into one leaf): ``[(ref_path, parts)]`` of the
    float32 leaves of at least 64 elements and ``min_ndim`` dimensions,
    ``parts`` as `tree.stacked_leaves_with_path` gives them."""
    out = []
    for path, parts in stacked_leaves_with_path(tree):
        x = parts[0][1]
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
            continue
        stacked = parts[0][0] != path       # a layer list's leaf
        ndim = x.dim() + (1 if stacked else 0)
        if sum(t.numel() for _, t in parts) >= 64 and ndim >= min_ndim:
            out.append((path, parts))
    return out


def _replace_leaf(tree, path, value):
    """The tree with the leaf at the port's `path` swapped for `value`."""
    return tree_replace(tree, path, value)


def _flip_part(tree, parts, idx: int, bit: int):
    """Flip bit `bit` of element `idx` of the stacked leaf made of
    ``parts``: ``(tree, port_path, original_tensor)``."""
    per = parts[0][1].numel()
    r, inner = divmod(idx, per)
    path, x = parts[r]
    return _replace_leaf(tree, path, flip_bit(x, inner, bit=bit)), path, x


def _flip_state_leaf(state, group: str, spec: FaultSpec):
    """Flip one bit of one float32 leaf of state[group], leaf and element
    drawn from the spec's seed over the reference's stacked layout (so the
    same bit flips as there).  Returns (state, leaf_name)."""
    cands = _flip_candidates(state[group])
    if not cands:
        raise ValueError(f"no flippable float32 leaf in state[{group!r}]")
    rng = np.random.RandomState(spec.seed)
    path, parts = cands[int(rng.randint(len(cands)))]
    idx = int(rng.randint(sum(x.numel() for _, x in parts)))
    new_sub, _, _ = _flip_part(state[group], parts, idx, spec.bit)
    return dict(state, **{group: new_sub}), f"{group}{keystr(path)}[{idx}]"


def _flip_engine_bit(engine, spec: FaultSpec):
    """Flip one bit inside a live ServeEngine: a KV-cache leaf (an early,
    attended position of slot 0) or a params leaf (the embedding table /
    first float32 weight).  Returns ``(leaf_name, undo)``: ``undo`` puts
    the original leaf back, so a shared engine survives a params drill
    (the cache is cleared by ``reset()`` anyway)."""
    if spec.kind == "dram_kv_cache":
        cands = _flip_candidates(engine.cache, min_ndim=3)
        if not cands:
            raise ValueError("no float32 KV leaf to corrupt")
        path, parts = cands[0]
        leaf = parts[0][1]
        # slot 0, an early (already-attended) position: first leading-dim
        # entry, batch index 0, position 1, everything else 0
        pos = (0, 0, 1) + (0,) * (leaf.dim() - 3)
        idx = int(np.ravel_multi_index(pos, tuple(leaf.shape)))
        engine.cache, _, _ = _flip_part(engine.cache, parts, idx, spec.bit)
        return f"cache{keystr(path)}[{idx}]", lambda: None
    # dram_params: hit the embedding table (the gather surface) when
    # present, else the first sizable float32 weight
    cands = _flip_candidates(engine.params)
    if not cands:
        raise ValueError("no float32 param leaf to corrupt")
    embed = [(p, x) for p, x in cands if "embed" in keystr(p)]
    path, parts = (embed or cands)[0]
    rng = np.random.RandomState(spec.seed)
    idx = int(rng.randint(sum(x.numel() for _, x in parts)))
    engine.params, port_path, orig = _flip_part(engine.params, parts, idx,
                                                spec.bit)

    def undo():
        engine.params = _replace_leaf(engine.params, port_path, orig)

    return f"params{keystr(path)}[{idx}]", undo
