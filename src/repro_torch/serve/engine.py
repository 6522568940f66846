"""Continuous-batching serving engine with ABFT-verified projections.

Slot scheduler on top of the model's decode path, as in the reference
package's ``repro/serve/engine.py`` (contiguous ``ServeEngine``):
  * fixed decode batch of `slots`; every engine step decodes ONE token for
    all occupied slots (per-slot positions — slots are never in lockstep),
  * a finished slot (max_new_tokens or EOS) retires immediately and a queued
    request is admitted: its prompt, padded to a power-of-two bucket, is
    prefilled as a single sequence and the resulting KV cache is scattered
    into the freed slot,
  * ``abft_mode="verify"`` carries checksum columns through every projection
    of prefill and decode; with ``abft_backend="cuda"`` (or "auto" on the
    GPU) they run the fused dual-checksum CUDA kernel.

PyTorch runs eagerly, so there are no compiled programs to keep.  Params are
immutable while serving, so the engine prepares them once: with ABFT on,
every projection's encoded weight is stored under ``w_enc`` in the kernel's
operand dtype (``encode_weight`` is deterministic, so the numbers do not
change), and the tied unembedding gets an fp32 copy of the table under
``table_f32``.  Both keep per-call casts of the weights off the step.

Not ported yet: ``mesh`` sharding, the checksum-protected logits reduction
(``abft_reduce`` / ``sdc`` drills) and the at-rest scrub (``scrub_every``),
which need the dist and serving-FT slices, and ``PagedServeEngine``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.chaos.faults import register_surface
from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft_gemm import encode_weight
from repro_torch.models import transformer as tf
from repro_torch.train.step import StepOptions

__all__ = ["Request", "ServeEngine", "EngineStats"]

# the protection domains this module owns in the reference; the port has
# not brought them up yet, so both sit on the uncovered ledger
register_surface(
    "serve.engine/logits_reduce", owner=__name__, protected=False,
    kinds=("sdc_collective",),
    note="checksum-verified cross-shard logits reduction (abft_psum): "
         "comes with the dist slice")
register_surface(
    "serve.engine/kv_cache_at_rest", owner=__name__, protected=False,
    kinds=("dram_kv_cache",),
    note="per-slot KV fingerprints and erasure repair (scrub_every): comes "
         "with the serving-FT slice")


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
class EngineStats:
    """Per-engine step accounting, reset by `ServeEngine.reset()`."""
    decode_steps: int = 0
    prefills: int = 0
    prefill_s: float = 0.0           # total wall time in prefill
    decode_s: float = 0.0            # total wall time in decode
    decode_step_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    tok_s: List[float] = dataclasses.field(default_factory=list)

    def clean_step_mean_s(self) -> float:
        xs = self.decode_step_s
        return sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> Dict[str, float]:
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0  # noqa: E731
        return {
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "clean_step_ms": 1e3 * self.clean_step_mean_s(),
            "ttft_ms": 1e3 * mean(self.ttft_s),
            "tok_per_s": mean(self.tok_s),
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


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, abft_mode: str = "off",
                 abft_backend: str = "auto", mesh=None,
                 abft_reduce: str = "off", abft_f: int = 2, sdc=None,
                 scrub_every: int = 0, kernel_dtype: str = "fp32"):
        if cfg.n_enc_layers:
            raise ValueError("engine serves decoder-only archs")
        if mesh is not None:
            raise NotImplementedError("mesh sharding comes with the dist "
                                      "slice")
        if abft_reduce != "off" or sdc is not None:
            raise NotImplementedError("the checksum-protected logits "
                                      "reduction and its SDC drills come "
                                      "with the dist slice")
        if scrub_every:
            raise NotImplementedError("the at-rest KV/params scrub comes "
                                      "with the serving-FT slice")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.kernel_dtype = kernel_dtype
        self.abft = StepOptions(abft_mode=abft_mode,
                                abft_backend=abft_backend,
                                kernel_dtype=kernel_dtype).abft
        self.device = params["embed"]["table"].device
        self.params = self._prepare(params)

        self.active: List[Optional[Request]] = [None] * slots
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats()
        self.cache = self._fresh_cache()
        self.pos = torch.zeros((slots,), dtype=torch.int64, device=self.device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                  device=self.device)

    # -- public ---------------------------------------------------------------
    def submit(self, req: Request):
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    @torch.no_grad()
    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue + slots drain; returns finished requests."""
        finished: List[Request] = []
        for _ in range(max_steps):
            self._admit()
            if not any(self.active):
                if not self.queue:
                    break
                continue
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

    def warm(self, prompt_len: int = 8, decode_steps: int = 2):
        """Run one dummy request through prefill and `decode_steps` decode
        steps (kernel build, library start-up), then reset state and
        stats."""
        # +1: the prefill's argmax token is output[0], so max_new_tokens
        # = decode_steps + 1 yields exactly `decode_steps` decode steps
        self.submit(Request(rid=-1, prompt=[0] * prompt_len,
                            max_new_tokens=max(decode_steps, 1) + 1))
        self.run()
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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            t0 = time.perf_counter()
            plen = len(req.prompt)
            bucket = self._bucket(plen)
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

    # -- step ------------------------------------------------------------------
    def _step(self, finished: List[Request]):
        t0 = time.perf_counter()
        logits, self.cache = tf.decode_step(self.params, self.tokens,
                                            self.pos, self.cache, self.cfg,
                                            abft=self.abft)
        next_tok = torch.argmax(logits, dim=-1)
        self._sync()
        wall = time.perf_counter() - t0

        self.stats.decode_steps += 1
        self.stats.decode_s += wall
        self.stats.decode_step_s.append(wall)
        obs.counter("repro_decode_steps_total", "engine decode steps").inc()

        self.pos = self.pos + torch.tensor(
            [1 if r is not None else 0 for r in self.active],
            dtype=torch.int64, device=self.device)
        self.tokens = next_tok[:, None]
        toks = next_tok.tolist()
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
                self.active[s] = None
