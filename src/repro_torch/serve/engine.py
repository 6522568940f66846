"""Fault-tolerant continuous-batching serving engine.

Slot scheduler on top of the model's decode path, as in the reference
package's ``repro/serve/engine.py`` (contiguous ``ServeEngine``):
  * fixed decode batch of `slots`; every engine step decodes ONE token for
    all occupied slots (per-slot positions — slots are never in lockstep),
  * a finished slot (max_new_tokens or EOS) retires immediately and a queued
    request is admitted: its prompt, padded to a power-of-two bucket, is
    prefilled as a single sequence and the resulting KV cache is scattered
    into the freed slot.  Where the config has a recurrent mixer (mamba,
    mLSTM, sLSTM) the prefill runs on exactly the prompt's tokens: a pad
    token would enter the recurrent state the slot decodes from.  (The
    reference pads these prompts too, so its recurrent configs decode from
    a state that has read the pad tokens.)  The port is eager, so the exact
    length costs no compile,
  * ``abft_mode="verify"`` carries checksum columns through every projection
    of prefill and decode; with ``abft_backend="cuda"`` (or "auto" on the
    GPU) they run the fused dual-checksum CUDA kernel.

Fault tolerance while serving, on one device.  ``mesh`` is a logical mesh
(`dist.sharding.Mesh`, an ``(R, M)`` shape or None): its ``model`` extent
is the number of feature slices the verified unembed reduces over, and the
param and cache specs it records (`infer_param_specs`, `cache_specs`) are
the reference's placements; every leaf stays whole on the device.  A
protected engine with no mesh runs on 1 x 1, as the reference's does:
  * ``abft_reduce="verify"|"correct"`` restructures the decode's final
    projection as the reference's row-parallel unembed: the partial logits
    of each feature slice are reduced through `dist.collectives.abft_psum`
    (checksums riding the reduction), then the bias and the final softcap;
  * ``sdc=SDCInjector(...)`` drills that reduction: at planned decode steps
    a delta corrupts one shard's contribution after its checksums are
    taken, and the engine detects, locates, corrects and records the event
    in `EngineStats`;
  * ``scrub_every=N`` verifies the KV cache (per-slot fingerprints, a
    tripped slot rebuilt from the slot-sum checksum) and the params
    (fingerprints, a tripped leaf restored from the held origin copy)
    every N decode steps; each scrub's fingerprints come to the host in
    one transfer.  Params fingerprints and `ScrubEvent.leaf` are keyed by
    the reference's key paths (a layout group's layers stacked into one
    leaf), so events read the same in both packages.

PyTorch runs eagerly, so there are no compiled programs to keep.  Params are
immutable while serving, so the engine prepares them once: with ABFT on,
every projection's encoded weight is stored under ``w_enc`` in the kernel's
operand dtype (``encode_weight`` is deterministic, so the numbers do not
change), and the tied unembedding gets an fp32 copy of the table under
``table_f32``.  Both keep per-call casts of the weights off the step, and
the scrub covers them as params leaves of their own.

`PagedServeEngine` serves from a paged KV cache (`serve.paged_kv`) with
page-granular checksums, prefix caching, chunked prefill and an optional
SLO scheduler (`serve.scheduler`); it takes ``mesh`` through its keywords
into the base class.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.chaos.faults import (SDCInjector, register_surface,
                                      scatter_delta)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft_gemm import encode_weight
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import abft_psum
from repro_torch.models import transformer as tf
from repro_torch.models.layers import softcap_fn
from repro_torch.train.step import StepOptions
from repro_torch.tree import (keystr, stacked_leaves_with_path, tree_get,
                              tree_leaves_with_path)

__all__ = ["Request", "ServeEngine", "PagedServeEngine", "EngineStats",
           "SDCEvent", "ScrubEvent"]

# the protection domains this module owns (chaos campaigns drill them)
register_surface(
    "serve.engine/logits_reduce", owner=__name__, protected=True,
    promise="bit_identity",
    detector="abft_psum checksums riding the row-parallel unembed's "
             "cross-shard reduction (detect/locate/correct in-flight, "
             "EngineStats records the event)",
    kinds=("sdc_collective",),
    note="promise is on the EMITTED TOKEN STREAM: correction is near-exact "
         "on logits and the argmax absorbs the residual ulps, so drilled "
         "outputs are bit-identical to clean")
register_surface(
    "serve.engine/kv_cache_at_rest", owner=__name__, protected=True,
    promise="tolerance",
    detector="per-slot fingerprints (fp32 sums over the non-slot axes) "
             "verified before every decode step, plus a slot-sum checksum "
             "array per cache leaf: a tripped slot is rebuilt by the "
             "erasure solve ksum - sum(other slots); armed after every "
             "legitimate cache mutation (decode, admission scatter)",
    kinds=("dram_kv_cache",),
    note="single-slot fault model (one checksum row, like f=1 diskless); "
         "enabled via ServeEngine(scrub_every=N).  The same cadence "
         "verifies the params fingerprints and restores a tripped leaf "
         "from the held origin copy (stand-in for a checkpoint re-fetch)")

@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # host-side latency timeline (filled by the engine)
    t_submit: float = 0.0
    t_first: float = 0.0     # first token available (prefill done)
    t_done: float = 0.0

    @property
    def ttft_s(self) -> Optional[float]:
        """Time-to-first-token: submit -> prefill's argmax token."""
        return (self.t_first - self.t_submit) if self.t_first else None

    @property
    def decode_tok_s(self) -> Optional[float]:
        """Decode throughput for this request (tokens after the first)."""
        n = len(self.output) - 1
        dt = self.t_done - self.t_first
        return n / dt if (n > 0 and dt > 0) else None


@dataclasses.dataclass
class SDCEvent:
    """One fired SDC drill: what was injected and what the engine saw."""
    step: int                 # engine decode step the fault fired at
    shard: int                # model-axis shard whose contribution corrupts
    delta: float              # additive corruption (bit-flip magnitude)
    detected: bool = False
    corrected: bool = False
    row: int = -1             # located grid row/col inside the reduced leaf
    col: int = -1
    wall_s: float = 0.0       # wall time of the drilled step
    recovery_s: float = 0.0   # wall_s minus the mean clean step time


@dataclasses.dataclass
class ScrubEvent:
    """One at-rest scrub trip: where the flip was found and what fixed it."""
    step: int                 # engine decode step the verify ran at
    domain: str               # "kv" | "params"
    leaf: str                 # keystr of the tripped leaf
    slot: int = -1            # KV slot rebuilt (-1 for params)
    page: int = -1            # physical page rebuilt (paged engine)
    repaired: bool = False
    wall_s: float = 0.0       # verify + repair wall


@dataclasses.dataclass
class EngineStats:
    """Per-engine step and FT accounting, reset by `ServeEngine.reset()`.

    detections/corrections count decode steps whose protected reduction
    reported an inconsistent / repaired checksum, and scrub trips; `events`
    holds the fired drills with their located coordinates and recovery
    latency, `scrub_events` the scrub trips.
    """
    decode_steps: int = 0
    prefills: int = 0
    detections: int = 0
    corrections: int = 0
    prefill_s: float = 0.0           # total wall time in prefill
    decode_s: float = 0.0            # total wall time in decode
    decode_step_s: List[float] = dataclasses.field(default_factory=list)
    drilled_step_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    tok_s: List[float] = dataclasses.field(default_factory=list)
    events: List[SDCEvent] = dataclasses.field(default_factory=list)
    scrub_checks: int = 0
    scrub_s: List[float] = dataclasses.field(default_factory=list)
    scrub_events: List[ScrubEvent] = dataclasses.field(default_factory=list)

    def clean_step_mean_s(self) -> float:
        xs = self.decode_step_s
        return sum(xs) / len(xs) if xs else 0.0

    def recovery_latency_s(self) -> float:
        """Mean extra wall time of detected-drill steps vs clean steps."""
        rs = [e.recovery_s for e in self.events if e.detected]
        return sum(rs) / len(rs) if rs else 0.0

    def summary(self) -> Dict[str, float]:
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0  # noqa: E731
        return {
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "detections": self.detections,
            "corrections": self.corrections,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "clean_step_ms": 1e3 * self.clean_step_mean_s(),
            "drilled_step_ms": 1e3 * mean(self.drilled_step_s),
            "recovery_latency_ms": 1e3 * self.recovery_latency_s(),
            "ttft_ms": 1e3 * mean(self.ttft_s),
            "tok_per_s": mean(self.tok_s),
            "scrub_checks": self.scrub_checks,
            "scrub_ms": 1e3 * mean(self.scrub_s),
            "scrub_repairs": sum(1 for e in self.scrub_events if e.repaired),
        }


def _tree_map(fn, *trees, path=()):
    """Map ``fn(path, *leaves)`` over nested dicts/lists of tensors."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in head}
    if isinstance(head, list):
        return [_tree_map(fn, *(t[i] for t in trees), path=path + (i,))
                for i in range(len(head))]
    return fn(path, *trees)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, abft_mode: str = "off",
                 abft_backend: str = "auto", mesh=None,
                 abft_reduce: str = "off", abft_f: int = 2,
                 sdc: Optional[SDCInjector] = None, scrub_every: int = 0,
                 kernel_dtype: str = "fp32"):
        if cfg.n_enc_layers:
            raise ValueError("engine serves decoder-only archs")
        if abft_reduce not in ("off", "verify", "correct"):
            raise ValueError(f"unknown abft_reduce {abft_reduce!r}")
        if sdc is not None and abft_reduce == "off":
            raise ValueError("sdc drills corrupt the protected logits "
                             "reduction — set abft_reduce to 'verify' or "
                             "'correct'")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.abft_reduce = abft_reduce
        self.abft_f = abft_f
        self.sdc = sdc
        self._protected = abft_reduce != "off"
        self._warming = False
        self.device = params["embed"]["table"].device
        if mesh is None and self._protected:
            # the protected reduction needs a model axis to reduce over; a
            # 1 x 1 mesh keeps one code path (a reduction over extent 1)
            mesh = (1, 1)
        self.mesh = shd.as_mesh(mesh, self.device) if mesh is not None \
            else None
        self.model_extent = 1 if self.mesh is None \
            else self.mesh.shape.get(shd.MODEL_AXIS, 1)
        if self._protected:
            m_ext = self.model_extent
            if shd.MODEL_AXIS not in self.mesh.axis_names:
                raise ValueError(
                    f"abft_reduce needs a '{shd.MODEL_AXIS}' mesh axis to "
                    f"reduce over (got axes {self.mesh.axis_names})")
            if cfg.d_model % m_ext:
                raise ValueError(
                    f"d_model={cfg.d_model} must divide over the model axis "
                    f"(extent {m_ext}) for the row-parallel verified unembed")
            if sdc is not None:
                # an out-of-range shard would inject nothing and the drill
                # would report detected=False
                bad = [e for e in sdc.plan.events if not 0 <= e[1] < m_ext]
                if bad:
                    raise ValueError(
                        f"SDC plan targets model-axis shards "
                        f"{sorted(e[1] for e in bad)} but the mesh's model "
                        f"extent is {m_ext}: the drill would inject nothing "
                        f"(shard must be in [0, {m_ext}))")
        # the reference's placements on the mesh, as records
        self.param_specs = self.cache_specs = None
        if self.mesh is not None:
            self.param_specs = shd.infer_param_specs(params, self.mesh, cfg)
            shapes = tf.init_cache(cfg, slots, max_len, device="meta")
            shapes = _tree_map(
                lambda p, x: torch.empty((x.shape[0], slots),
                                         dtype=torch.int64, device="meta")
                if p[-1] == "index" else x, shapes)
            self.cache_specs = shd.map_with_path(
                shd.cache_specs(self.mesh, slots, cfg), shapes)
        self.kernel_dtype = kernel_dtype
        self.abft = StepOptions(abft_mode=abft_mode,
                                abft_backend=abft_backend,
                                kernel_dtype=kernel_dtype).abft
        self.params = self._prepare(params)
        # recurrent state reads every token it is given: prefill exactly
        self._recurrent = tf.is_recurrent(cfg)

        self.active: List[Optional[Request]] = [None] * slots
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats()
        self.cache = self._fresh_cache()
        self.pos = torch.zeros((slots,), dtype=torch.int64, device=self.device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                  device=self.device)

        # at-rest scrub (serve.engine/kv_cache_at_rest and the serve side of
        # state.params_at_rest): `scrub_every` is the verify cadence in
        # decode steps; arming (checksum-on-write) follows every legitimate
        # cache mutation.  Params are immutable while serving, so they arm
        # once: fingerprints for detection plus an origin copy for repair
        # (the stand-in for a checkpoint re-fetch).
        self.scrub_every = scrub_every
        self._kv_sums = {}
        self._param_fp: Dict[str, float] = {}
        self._param_origin = None
        if scrub_every:
            keys, fps = self._fingerprints(self.params)
            self._param_fp = dict(zip(keys, fps.cpu().tolist()))
            self._param_origin = _clone_tree(self.params)
            self._arm_kv()

    # -- public ---------------------------------------------------------------
    def submit(self, req: Request):
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    @torch.no_grad()
    def run(self, max_steps: int = 10_000, on_step=None) -> List[Request]:
        """Drive until queue + slots drain; returns finished requests.

        ``on_step(engine, decode_step)``, called before each decode step
        with the engine itself, is the chaos-campaign hook: a drill mutates
        engine state (flips a KV-cache or weight bit) at a planned step."""
        finished: List[Request] = []
        for _ in range(max_steps):
            self._admit()
            if not any(self.active):
                if not self._pending():
                    break
                continue
            if on_step is not None:
                on_step(self, self.stats.decode_steps)
            self._step(finished)
        return finished

    def reset(self):
        """Clear serving state and stats; the prepared params are kept."""
        self.cache = self._fresh_cache()
        self.pos = torch.zeros((self.slots,), dtype=torch.int64,
                               device=self.device)
        self.tokens = torch.zeros((self.slots, 1), dtype=torch.int64,
                                  device=self.device)
        self.active = [None] * self.slots
        self.queue = deque()
        self.stats = EngineStats()
        if self.scrub_every:
            self._arm_kv()

    def warm(self, prompt_len: int = 8, decode_steps: int = 2):
        """Run one dummy request through prefill and `decode_steps` decode
        steps (kernel build, library start-up), then reset state and
        stats.  Drills, scrubs and re-arms are off while warming."""
        self._warming = True
        try:
            # +1: the prefill's argmax token is output[0], so
            # max_new_tokens = decode_steps + 1 yields exactly
            # `decode_steps` decode steps
            self.submit(Request(rid=-1, prompt=[0] * prompt_len,
                                max_new_tokens=max(decode_steps, 1) + 1))
            self.run()
        finally:
            self._warming = False
        self.reset()

    # -- internals --------------------------------------------------------------
    def _prepare(self, params):
        """Pre-encode every projection (ABFT on) into ``w_enc`` in the
        kernel's operand dtype, and cache the tied table in fp32."""
        abft = self.abft

        def encode(node):
            if isinstance(node, list):
                return [encode(v) for v in node]
            if not isinstance(node, dict):
                return node
            out = {k: encode(v) for k, v in node.items()}
            if "w" in node and torch.is_tensor(node["w"]) \
                    and "w_enc" not in node:
                w_enc = encode_weight(node["w"], abft)
                if abft.in_dtype != "int8":
                    w_enc = w_enc.to(abft.compute_dtype)
                out["w_enc"] = w_enc
            return out

        with torch.no_grad():
            prepared = encode(params) if abft is not None and abft.active \
                else dict(params)
            if "lm_head" not in params:
                prepared["embed"] = {**prepared["embed"],
                                     "table_f32":
                                         params["embed"]["table"].float()}
        return prepared

    def _fresh_cache(self):
        cache = tf.init_cache(self.cfg, self.slots, self.max_len,
                              device=self.device)
        # vector per-slot indices (init_cache makes one scalar per layer)
        return _tree_map(
            lambda p, x: torch.zeros((x.shape[0], self.slots),
                                     dtype=torch.int64, device=self.device)
            if p[-1] == "index" else x, cache)

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _prefill_len(self, n: int) -> int:
        """Tokens a prefill of ``n`` runs on: the bucket, or exactly ``n``
        where a recurrent state would read the padding."""
        return n if self._recurrent else self._bucket(n)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- at-rest scrub ---------------------------------------------------------
    @staticmethod
    def _fingerprints(tree):
        """``(keys, fps)``: one fp32 sum per floating leaf of the reference's
        layout (a layout group's layers summed together), keyed by keystr;
        ``fps`` is one tensor on the leaves' device."""
        keys, sums = [], []
        for path, parts in _ref_leaves(tree):
            keys.append(keystr(path))
            sums.append(torch.stack([x.float().sum()
                                     for _, x in parts]).sum())
        if not sums:
            return keys, torch.zeros((0,))
        return keys, torch.stack(sums)

    def _arm_kv(self):
        """Checksum-on-write for the KV cache: per-slot fingerprints
        (detect and locate the tripped slot) and a slot-sum checksum array
        (the erasure row that repairs it) per float cache leaf."""
        sums = {}
        for path, x in tree_leaves_with_path(self.cache):
            if _is_float(x) and x.dim() >= 2 and x.shape[1] == self.slots:
                x32 = x.float()
                fp = x32.sum(dim=tuple(range(2, x.dim())))
                sums[keystr(path)] = (path, fp, x32.sum(dim=1))
        self._kv_sums = sums

    def _scrub_check(self):
        """Verify-on-read: recompute the KV and params fingerprints against
        the armed values, all of them in one transfer to the host, and
        repair what tripped."""
        t0 = time.perf_counter()
        self.stats.scrub_checks += 1
        step = self.stats.decode_steps
        events: List[ScrubEvent] = []
        kv_bad, p_bad = self._scrub_flags()
        self._scrub_kv(step, events, kv_bad)
        self._scrub_params(step, events, p_bad)
        self._sync()
        wall = time.perf_counter() - t0
        self.stats.scrub_s.append(wall)
        obs.histogram("repro_checksum_verify_seconds",
                      "at-rest scrub verify+repair wall").observe(
            wall, domain="serve")
        if events:
            for e in events:
                e.wall_s = wall
            self.stats.detections += len(events)
            self.stats.corrections += sum(1 for e in events if e.repaired)
            self.stats.scrub_events.extend(events)
            det = obs.counter("repro_detections_total",
                              "checksum/invariant trips")
            rep = obs.counter("repro_scrub_repairs_total",
                              "at-rest scrub repairs")
            for e in events:
                rung = ("scrub:page_repair" if e.page >= 0 else
                        "scrub:kv_repair" if e.domain == "kv" else
                        "scrub:restore")
                det.inc(surface="serve.scrub/" + e.domain)
                obs.event("fault/detect", step=step,
                          surface="serve.scrub/" + e.domain,
                          detector="fingerprint", leaf=e.leaf,
                          slot=e.slot, page=e.page)
                if e.repaired:
                    rep.inc(domain=e.domain)
                    obs.recovery(rung, wall, step=step, leaf=e.leaf,
                                 slot=e.slot, page=e.page)

    def _scrub_flags(self):
        """The trip flags of one scrub, computed on the device and brought
        to the host together: ``(kv_bad, {params key: bool})``, ``kv_bad``
        as `_kv_bad` reads it.  A params leaf trips where its sum moved by
        more than 1e-4 of its armed sum (+1); NaN counts as tripped."""
        kv_parts = self._kv_flags()
        p_keys, p_fps = [], None
        if self._param_fp:
            p_keys, fps = self._fingerprints(self.params)
            armed = torch.tensor([self._param_fp[k] for k in p_keys],
                                 dtype=torch.float32, device=fps.device)
            p_fps = ~((fps - armed).abs() <= 1e-4 * (armed.abs() + 1.0))
        parts = [f.to(self.device) for f in kv_parts]
        if p_fps is not None:
            parts.append(p_fps.to(self.device))
        host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, bool)
        n_kv = sum(f.numel() for f in kv_parts)
        return self._kv_bad(host[:n_kv]), dict(zip(p_keys, host[n_kv:]))

    def _kv_flags(self) -> List[torch.Tensor]:
        """One ``[slots]`` bool per armed KV leaf: a slot trips where its
        fingerprint moved by more than 1e-4 of the leaf's largest armed
        fingerprint (+1); NaN counts as tripped."""
        flags = []
        for path, fp_a, _ in self._kv_sums.values():
            x = tree_get(self.cache, path)
            fp = x.float().sum(dim=tuple(range(2, x.dim())))
            thr = 1e-4 * (fp_a.abs().max() + 1.0)
            # ~(d <= thr) is True for NaN as well
            flags.append((~((fp - fp_a).abs() <= thr)).any(dim=0))
        return flags

    def _kv_bad(self, host):
        """``{kv key: [slots] bool}`` from the host copy of `_kv_flags`."""
        return {key: host[i * self.slots:(i + 1) * self.slots]
                for i, key in enumerate(self._kv_sums)}

    def _scrub_kv(self, step: int, events: List[ScrubEvent], kv_bad):
        """A tripped KV slot is rebuilt by the erasure solve ``ksum -
        sum(other slots)`` (single-slot fault model, like f=1 diskless)."""
        for key, bad in kv_bad.items():
            if not bad.any():
                continue
            path, _, ks_a = self._kv_sums[key]
            x = tree_get(self.cache, path)
            for s in np.flatnonzero(bad).tolist():
                # the erasure solve over the surviving slots only (zeroing
                # the bad slot keeps a NaN/inf flip out of the sum)
                x32 = x.float().clone()       # fp32 .float() is x itself
                x32[:, s] = 0.0
                x[:, s] = (ks_a - x32.sum(dim=1)).to(x.dtype)
                events.append(ScrubEvent(step=step, domain="kv", leaf=key,
                                         slot=s, repaired=True))

    def _scrub_params(self, step: int, events: List[ScrubEvent], p_bad):
        """A tripped params leaf is restored from the origin copy."""
        origin = dict(_ref_leaves(self._param_origin))
        for path, parts in _ref_leaves(self.params):
            key = keystr(path)
            if not p_bad.get(key, False):
                continue
            for (_, x), (_, o) in zip(parts, origin[path]):
                x.copy_(o)
            events.append(ScrubEvent(step=step, domain="params", leaf=key,
                                     repaired=True))

    # -- subclass hooks --------------------------------------------------------
    def _pending(self) -> bool:
        """Anything left to admit? (run()'s drain condition; the paged
        engine adds its scheduler queue and in-flight chunked prefill)"""
        return bool(self.queue)

    def _pre_decode(self):
        """Before each decode call (paged engine: materialize the dense
        working cache from the page pools)."""

    def _post_decode(self):
        """After the decode mutated the cache, before positions advance.
        Contiguous engine: whole-cache re-arm; the paged engine overrides
        this with per-page write-back and re-arm."""
        if self.scrub_every and not self._warming:
            self._arm_kv()  # re-arm: the decode mutated every live slot

    def _retire_slot(self, s: int):
        """A slot's request just finished (paged engine frees its
        pages)."""

    # -- admission -------------------------------------------------------------
    def _admit(self):
        admitted = False
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            t0 = time.perf_counter()
            plen = len(req.prompt)
            bucket = self._prefill_len(plen)
            prompt = torch.zeros((1, bucket), dtype=torch.int64,
                                 device=self.device)
            prompt[0, :plen] = torch.tensor(req.prompt, dtype=torch.int64)
            logits, small_cache = self._prefill_impl(self.params, prompt,
                                                     plen, bucket)
            self._scatter_slot(s, small_cache, plen)
            tok = int(torch.argmax(logits[0, plen - 1]))   # synchronizes
            t1 = time.perf_counter()
            req.output.append(tok)
            req.t_first = t1
            self.stats.prefills += 1
            self.stats.prefill_s += t1 - t0
            self.tokens[s, 0] = tok
            self.pos[s] = plen
            self.active[s] = req
            admitted = True
        if admitted and self.scrub_every and not self._warming:
            self._arm_kv()  # re-arm after the admission scatter

    def _prefill_impl(self, params, prompt, plen, bucket):
        cache = tf.init_cache(self.cfg, 1, self.max_len, device=self.device)
        logits, new_cache, _ = tf.forward(params, prompt, self.cfg,
                                          cache=cache, abft=self.abft)
        return logits, new_cache

    def _scatter_slot(self, s: int, small_cache, plen: int):
        def put(path, big, small):
            if path[-1] == "index":
                big[..., s] = plen
            else:
                # leading dims: [repeats, B(slots), ...] <- [repeats, 1, ...]
                big[:, s] = small[:, 0].to(big.dtype)
            return big

        self.cache = _tree_map(put, self.cache, small_cache)

    # -- decode ----------------------------------------------------------------
    def _decode_core(self, params, tokens, pos, cache, inject):
        """One decode step: ``(logits [B, V], cache, ok, info)``."""
        if not self._protected:
            logits, new_cache = tf.decode_step(params, tokens, pos, cache,
                                               self.cfg, abft=self.abft)
            return logits, new_cache, None, None
        hidden, new_cache = tf.decode_step(params, tokens, pos, cache,
                                           self.cfg, abft=self.abft,
                                           return_hidden=True)
        logits, ok, info = self._verified_unembed(params, hidden, inject)
        return logits, new_cache, ok, info

    def _verified_unembed(self, params, x, inject):
        """Row-parallel final projection with the cross-shard reduction
        checksum-verified (and drill-injectable) through `abft_psum`.

        x: [B, 1, D] post-final-norm hidden.  Each model shard computes the
        partial logits of its D/m feature slice, stacked on a leading shard
        axis; `abft_psum` reduces them with Huang-Abraham checksums riding
        the same reduction (detect; "correct" also repairs a single
        corrupted element).  The bias and the final softcap come after.
        """
        head = params.get("lm_head")
        m = self.model_extent
        if head is not None:
            w = head["w"].float()                              # [D, V]
        else:
            table = params["embed"].get("table_f32")
            if table is None:
                table = params["embed"]["table"].float()
            w = table.T                                        # [D, V]
        d = x.shape[-1]
        xs = x.float().reshape(x.shape[:-1] + (m, d // m))
        parts = torch.stack([xs[..., i, :] @ w[i * d // m:(i + 1) * d // m]
                             for i in range(m)])            # [m, B, 1, V]
        dvec = None
        if inject is not None:
            dvec = scatter_delta(m, inject[0], inject[1], device=x.device)
        y, ok, info = abft_psum(parts, 0, f=self.abft_f,
                                mode=self.abft_reduce, inject_local=dvec,
                                with_info=True)
        if head is not None and "b" in head:
            y = y + head["b"].float()
        y = softcap_fn(y, self.cfg.final_softcap)
        return y[:, -1], ok, info

    def _step(self, finished: List[Request]):
        if (self.scrub_every and not self._warming
                and self.stats.decode_steps % self.scrub_every == 0):
            self._scrub_check()
        self._pre_decode()
        t0 = time.perf_counter()
        ev: Optional[SDCEvent] = None
        if self.sdc is not None and not self._warming:
            fired = self.sdc.check(self.stats.decode_steps)
            if fired is not None:
                shard, delta = fired
                ev = SDCEvent(step=self.stats.decode_steps, shard=shard,
                              delta=delta)
        inject = (ev.shard, ev.delta) if ev is not None else None
        logits, self.cache, ok, info = self._decode_core(
            self.params, self.tokens, self.pos, self.cache, inject)
        next_tok = torch.argmax(logits, dim=-1)
        if self._protected:
            # the reduction's verdict rides the tokens' one transfer
            flags = torch.stack([~ok, info["corrected"]]).long()
            where = torch.stack([info["row"], info["col"]]).long()
            out = torch.cat([next_tok, flags, where])
        else:
            out = next_tok
        self._sync()
        wall = time.perf_counter() - t0
        host = out.tolist()
        toks = host[:self.slots]
        detected, corrected, row, col = (
            (bool(host[-4]), bool(host[-3]), host[-2], host[-1])
            if self._protected else (False, False, -1, -1))

        step = self.stats.decode_steps
        self.stats.decode_steps += 1
        self.stats.decode_s += wall
        if not self._warming:
            obs.counter("repro_decode_steps_total",
                        "engine decode steps").inc()
        if detected:
            self.stats.detections += 1
            if corrected:
                self.stats.corrections += 1
        if ev is not None:
            ev.detected = detected
            ev.corrected = corrected
            ev.row, ev.col = row, col
            ev.wall_s = wall
            base = self.stats.clean_step_mean_s()
            ev.recovery_s = max(wall - base, 0.0) if base else 0.0
            self.stats.drilled_step_s.append(wall)
            self.stats.events.append(ev)
            obs.event("fault/inject", step=step,
                      surface="serve.engine/logits_reduce",
                      kind="sdc_reduce", shard=ev.shard, delta=ev.delta)
        else:
            self.stats.decode_step_s.append(wall)
        if detected:
            obs.counter("repro_detections_total",
                        "checksum/invariant trips").inc(
                surface="serve.engine/logits_reduce")
            obs.event("fault/detect", step=step,
                      surface="serve.engine/logits_reduce",
                      detector="abft_psum", row=row, col=col)
            if corrected:
                obs.counter("repro_corrections_total",
                            "in-flight ABFT corrections").inc()
            rec = ev.recovery_s if ev is not None else wall
            obs.recovery("abft_inflight", rec, step=step, warm_s=rec,
                         compile_s=0.0, corrected=corrected)
        self._post_decode()

        self.pos = self.pos + torch.tensor(
            [1 if r is not None else 0 for r in self.active],
            dtype=torch.int64, device=self.device)
        self.tokens = next_tok[:, None]
        pos = self.pos.tolist()
        now = time.perf_counter()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = toks[s]
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos \
                    or pos[s] >= self.max_len - 1:
                req.done = True
                req.t_done = now
                if req.ttft_s is not None:
                    self.stats.ttft_s.append(req.ttft_s)
                    obs.histogram("repro_ttft_seconds",
                                  "time to first token").observe(req.ttft_s)
                if req.decode_tok_s is not None:
                    self.stats.tok_s.append(req.decode_tok_s)
                    obs.gauge("repro_tokens_per_s",
                              "per-request decode throughput").set(
                        req.decode_tok_s)
                obs.counter("repro_requests_total",
                            "retired serve requests").inc()
                finished.append(req)
                self._retire_slot(s)
                self.active[s] = None


class PagedServeEngine(ServeEngine):
    """`ServeEngine` on a paged/block KV cache (serve.paged_kv) with prefix
    caching, chunked prefill, and an optional SLO-aware scheduler.

    The page pools are the AUTHORITATIVE storage: every decode step gathers
    them into the fixed-shape dense cache the inherited decode consumes
    (`_pre_decode`, one ``index_select`` over the page table per leaf), and
    writes each slot's freshly decoded K/V back into its page afterwards
    (`_post_decode`, one indexed write and one checksum update per leaf for
    all slots) — re-arming exactly the pages it touched instead of the
    whole cache.  A retiring slot frees its pages (zero-at-free), and the
    at-rest scrub verifies/repairs at page granularity via the pool's
    erasure sum; the page flags ride the params flags' one transfer.

    Decode parity: with ``chunk_prefill=0`` and no prefix hit, admission
    runs the parent's prefill verbatim and the gathered dense cache differs
    from the contiguous engine's only at causally masked positions (zeros
    vs prefill pad garbage) — decode logits, and therefore the emitted
    token streams, are bit-identical.  Chunked and prefix-shared prefills
    change the prefill computation's shape, so their guarantee is on the
    argmax token stream, not logits bits.

    A suffix or chunk prefill is padded to ``min(_bucket(n), max_len -
    start)`` tokens, so it never writes past the cache.  (The reference
    pads to ``_bucket(n)``; where ``start + bucket > max_len`` its clamped
    cache write shifts the chunk's K/V, and its tokens leave the contiguous
    engine's.)

    Where the config has a recurrent mixer, a prefill or prefill chunk runs
    on exactly its ``n`` tokens, as the contiguous engine's prefill does.
    The recurrent state is not paged: it stays in the dense cache.  An
    admission's first chunk starts from the initial state, each later chunk
    continues from the state the one before left, and the decode steps
    that run between the chunks do not advance it.  Such a config shares
    no prefix, since no page holds the state at a prefix's end.  (The
    reference starts every multi-token chunk from the zero state, and lets
    the decode steps between chunks advance the slot's state.)

    ``scheduler``: an `SLOScheduler` (serve.scheduler) takes over queueing
    — `submit()` routes through its admission control (rejections land in
    ``self.rejected``) and `_admit` pops by aged effective priority.
    ``chunk_prefill=C``: prompts longer than C prefill C tokens per engine
    step, so a long prompt never delays a running decode step by more than
    one chunk's work; when no decode is active the chunks free-run
    back-to-back.
    """

    def __init__(self, cfg: ModelConfig, params, *, page_size: int = 8,
                 chunk_prefill: int = 0, prefix_cache: bool = True,
                 scheduler=None, max_prefixes: int = 16, **kw):
        self.page_size = page_size
        self.chunk_prefill = chunk_prefill
        self.prefix_cache = prefix_cache
        self.max_prefixes = max_prefixes
        self.scheduler = scheduler
        self.kv = None                    # built by _fresh_cache
        self._kv_paths: Dict[str, tuple] = {}
        self._state0: Dict[str, torch.Tensor] = {}
        self._held: list = []
        self.rejected: List[Request] = []
        self._prefilling: Optional[dict] = None
        super().__init__(cfg, params, **kw)

    # -- paged storage ---------------------------------------------------------
    def _fresh_cache(self):
        from repro_torch.serve.paged_kv import PagedKVCache
        dense = super()._fresh_cache()
        shapes, paths = {}, {}
        for path, x in tree_leaves_with_path(dense):
            # paged leaves: the attention K/V, [repeats, slots, max_len,
            # *tail]; a recurrent state (no max_len axis) stays dense-only
            if path[-1] in ("k", "v") and x.shape[2] == self.max_len:
                key = keystr(path)
                shapes[key] = (tuple(x.shape), x.dtype)
                paths[key] = path
        self._kv_paths = paths
        # a 1-slot initial state for every dense-only leaf: the first chunk
        # of an admission starts from it
        self._state0 = {
            keystr(path): x
            for path, x in tree_leaves_with_path(
                tf.init_cache(self.cfg, 1, 1, device=self.device))
            if path[-1] != "index" and keystr(path) not in paths}
        self.kv = PagedKVCache(shapes, slots=self.slots,
                               max_len=self.max_len,
                               page_size=self.page_size,
                               max_prefixes=self.max_prefixes,
                               device=self.device)
        return dense

    def _arm_kv(self):
        self.kv.arm_all()

    def _kv_flags(self) -> List[torch.Tensor]:
        return [self.kv.trip_flags().reshape(-1)]

    def _kv_bad(self, host):
        self.kv.stats.verifies += 1
        return self.kv.tripped(host)

    def _scrub_kv(self, step: int, events: List[ScrubEvent], kv_bad):
        for key, page in kv_bad:
            if self.kv.repair(key, page):
                events.append(ScrubEvent(step=step, domain="kv", leaf=key,
                                         page=page, repaired=True))

    def _pre_decode(self):
        for key, path in self._kv_paths.items():
            self.kv.gather(key, out=tree_get(self.cache, path))
        # a decode steps every slot's recurrent state: hold the state a
        # chunked prefill is carrying, so the decode cannot advance it
        self._held = []
        if self._prefilling is not None and self._recurrent:
            s = self._prefilling["slot"]
            self._held = [(x, s, x[:, s].clone())
                          for path, x in tree_leaves_with_path(self.cache)
                          if keystr(path) in self._state0]

    def _post_decode(self):
        for x, s, held in self._held:
            x[:, s] = held
        self._held = []
        # page-granular write-back + re-arm: ONE page per leaf per active
        # slot (the decode wrote exactly position pos[s])
        act = [s for s, r in enumerate(self.active) if r is not None]
        if not act:
            return
        pos = self.pos.tolist()
        at = [pos[s] for s in act]
        si = torch.tensor(act, dtype=torch.int64, device=self.device)
        pi = torch.tensor(at, dtype=torch.int64, device=self.device)
        self.kv.begin_mutation()
        for key, path in self._kv_paths.items():
            x = tree_get(self.cache, path)
            self.kv.write_tokens(key, act, at, x[:, si, pi])

    def _retire_slot(self, s: int):
        self.kv.free_slot(s)

    # -- queueing / admission --------------------------------------------------
    def submit(self, req: Request, priority: Optional[int] = None):
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        if self.scheduler is not None and not self._warming:
            if not self.scheduler.submit(req, priority=priority):
                req.done = True
                self.rejected.append(req)
            return
        self.queue.append(req)

    def reset(self):
        super().reset()          # rebuilds self.kv via _fresh_cache
        self.rejected = []
        self._prefilling = None

    def _pending(self) -> bool:
        return (bool(self.queue) or self._prefilling is not None
                or (self.scheduler is not None and len(self.scheduler) > 0))

    def _next_request(self) -> Optional[Request]:
        if self.scheduler is not None:
            req = self.scheduler.pop()
            if req is not None:
                return req
        return self.queue.popleft() if self.queue else None

    def _admit(self):
        if self._prefilling is not None:
            self._advance_prefill()
            if self._prefilling is not None:
                return          # one chunk per engine step under decode load
        while True:
            free = [s for s in range(self.slots) if self.active[s] is None]
            if not free:
                return
            req = self._next_request()
            if req is None:
                return
            self._start_admission(free[0], req)
            if self._prefilling is not None:
                self._advance_prefill()   # free-runs when no decode active
                if self._prefilling is not None:
                    return

    def _start_admission(self, s: int, req: Request):
        plen = len(req.prompt)
        need = min(plen + req.max_new_tokens, self.max_len)
        prompt = req.prompt if self._shares_prefix() else None
        start = self.kv.alloc_slot(s, need, prompt=prompt)
        if start or (self.chunk_prefill and plen > self.chunk_prefill):
            self._prefilling = {"slot": s, "req": req, "start": start}
            return
        # no prefix hit, no chunking: the parent's prefill verbatim —
        # bit-identical admission vs the contiguous engine
        t0 = time.perf_counter()
        bucket = self._prefill_len(plen)
        prompt_t = torch.zeros((1, bucket), dtype=torch.int64,
                               device=self.device)
        prompt_t[0, :plen] = torch.tensor(req.prompt, dtype=torch.int64)
        logits, small_cache = self._prefill_impl(self.params, prompt_t,
                                                 plen, bucket)
        self._scatter_slot(s, small_cache, plen)
        self._write_pages(s, small_cache, 0, plen)
        tok = int(torch.argmax(logits[0, plen - 1]))   # synchronizes
        self.stats.prefill_s += time.perf_counter() - t0
        self._finish_admission(s, req, tok, plen)

    def _finish_admission(self, s: int, req: Request, tok: int, plen: int):
        req.output.append(tok)
        req.t_first = time.perf_counter()
        self.stats.prefills += 1
        self.tokens[s, 0] = tok
        self.pos[s] = plen
        self.active[s] = req
        if self._shares_prefix():
            self.kv.register_prefix(s, req.prompt)

    def _shares_prefix(self) -> bool:
        return self.prefix_cache and not self._warming \
            and not self._recurrent

    def _write_pages(self, s: int, cache_tree, start: int, end: int):
        """Persist positions [start, end) of a 1-slot cache into pages."""
        if end <= start:
            return
        self.kv.begin_mutation()
        for key, path in self._kv_paths.items():
            x = tree_get(cache_tree, path)
            self.kv.write(key, s, start, x[:, 0, start:end])

    # -- chunked / prefix-shared prefill --------------------------------------
    def _slot_cache(self, s: int, start: int):
        """Dense 1-slot cache for a chunk: this slot's pages gathered,
        non-paged leaves sliced from the engine cache (the initial state
        for an admission's first chunk, at start 0), block indices set to
        the chunk's start position."""
        def one(path, x):
            key = keystr(path)
            if key in self._kv_paths:
                return self.kv.gather_slot(key, s)
            if path[-1] == "index":
                return torch.full((x.shape[0],), start, dtype=torch.int64,
                                  device=self.device)
            if start == 0 and key in self._state0:
                return self._state0[key].clone()
            if x.dim() >= 2 and x.shape[1] == self.slots:
                return x[:, s:s + 1]
            return x

        return _tree_map(one, self.cache)

    def _chunk_forward(self, tokens, start: int, cache):
        """Prefill ``tokens`` [1, bucket] at positions ``start + i`` into
        the 1-slot ``cache``: ``(logits, cache)``."""
        positions = start + torch.arange(tokens.shape[1],
                                         device=self.device)
        logits, new_cache, _ = tf.forward(self.params, tokens, self.cfg,
                                          positions=positions, cache=cache,
                                          abft=self.abft)
        return logits, new_cache

    def _advance_prefill(self):
        """Process chunks of the in-flight prefill: one chunk when any
        decode is running (the chunk budget is the most a decode step can
        be delayed), back-to-back when the engine is otherwise idle."""
        while self._prefilling is not None:
            pf = self._prefilling
            s, req, start = pf["slot"], pf["req"], pf["start"]
            plen = len(req.prompt)
            n = min(self.chunk_prefill or plen - start, plen - start)
            t0 = time.perf_counter()
            # never past the cache: the bucket stops at max_len
            bucket = min(self._prefill_len(n), self.max_len - start)
            toks = torch.zeros((1, bucket), dtype=torch.int64,
                               device=self.device)
            toks[0, :n] = torch.tensor(req.prompt[start:start + n],
                                       dtype=torch.int64)
            cache = self._slot_cache(s, start)
            logits, new_cache = self._chunk_forward(toks, start, cache)
            # carry the index (and any non-paged leaf) across chunks
            self._scatter_slot(s, new_cache, start + n)
            self._write_pages(s, new_cache, start, start + n)
            pf["start"] = start + n
            if pf["start"] >= plen:
                tok = int(torch.argmax(logits[0, n - 1]))   # synchronizes
                self.stats.prefill_s += time.perf_counter() - t0
                self._prefilling = None
                self._finish_admission(s, req, tok, plen)
                return
            self.stats.prefill_s += time.perf_counter() - t0
            if any(r is not None for r in self.active):
                return


def _clone_tree(tree):
    return _tree_map(lambda _p, x: x.clone() if torch.is_tensor(x) else x,
                     tree)


def _ref_leaves(tree):
    """The floating leaves of ``tree`` in the reference's layout:
    ``[(ref_path, [(port_path, tensor)])]`` (`tree.stacked_leaves_with_path`,
    floating leaves only)."""
    return [(path, parts) for path, parts in stacked_leaves_with_path(tree)
            if all(_is_float(x) for _, x in parts)]
