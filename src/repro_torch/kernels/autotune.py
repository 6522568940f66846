"""Measured autotuner over the fused ABFT-GEMM tiling plans.

``ops.pick_blocks`` is a time model over the H100's published rates; models
drift from silicon, so this module closes the loop by MEASURING the top-K
model-ranked candidates once per (m, k, n, in_dtype, out_dtype, f, family,
device kind) key and persisting the winner, so that every later dispatch
gets the measured plan for free.

Layered resolution (highest wins), all read-only at dispatch time:

    built-in defaults  <  on-disk JSON cache  <  REPRO_TORCH_AUTOTUNE_PLAN env

* ``best_plan`` is the dispatch-side lookup: it NEVER measures; on a cold
  cache it falls back to the time model (``pick_blocks``), so a fresh
  checkout plans exactly as the model does.  The resolution is memoized on
  the plan key, the env values and the cache file's (path, mtime): every
  eager protected projection dispatches, so a warm call costs a dict
  lookup, not a JSON parse.  The env and the mtime are re-read at most
  every half second, at once after this process writes the cache, and on
  ``refresh()`` (the reference re-reads them on every call).
* ``autotune`` is the measuring entry: rank candidates with the model,
  time the top-K on the card (the model's choice is always candidate #0,
  so the measured winner beats or matches it by construction), persist
  the winner.  ``launch/autotune.py`` pre-warms the cache.
* A corrupt, truncated, foreign or unwritable cache file degrades to the
  model with a warning, never a crash.  A cached ``(bm, bn, bk)`` is taken
  only where it equals a candidate ``ops.rank_blocks`` yields for that
  shape, family and dtype (which also gives the plan its route and split
  count); anything else counts as malformed and falls through.

Measurement: on a CUDA device ``measure_plan`` times the kernel the key
names, kernel #1 (``ops._run_oneshot``) for the one-shot family and kernel
#2 for the accumulate family, with CUDA events around each call and the
L2 flushed before it, best of ``reps`` after a warm-up.  On a CPU tensor
it times the accumulate family's plan-sensitive twin (``backend="torch"``),
as the reference does off the TPU.

Env knobs:
    REPRO_TORCH_AUTOTUNE_CACHE    path of the JSON cache file
    REPRO_TORCH_AUTOTUNE_PLAN     JSON {key: [bm, bn, bk]} overriding all
    REPRO_TORCH_AUTOTUNE_DISABLE  "1" -> best_plan == pick_blocks

Counterpart of the reference package's ``repro/kernels/autotune.py``; its
cache (schema ``repro.kernels.autotune/v1``, TPU tiles) is not read here.
"""
from __future__ import annotations

import functools
import json
import os
import tempfile
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = ["autotune", "best_plan", "plan_key", "device_kind",
           "cache_path", "measure_plan", "stats", "reset_stats", "refresh",
           "SCHEMA", "CACHE_ENV", "PLAN_ENV", "DISABLE_ENV", "BUILTIN"]

SCHEMA = "repro_torch.kernels.autotune/v1"
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
PLAN_ENV = "REPRO_TORCH_AUTOTUNE_PLAN"
DISABLE_ENV = "REPRO_TORCH_AUTOTUNE_DISABLE"
DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "repro_torch", "autotune.json")

# Built-in defaults: the lowest layer, keys with a device field or "*".
# Empty: the reference's entries are TPU tiles no H100 route has, and a
# built-in winner would change the plans of a cold checkout.
BUILTIN: Dict[str, Tuple[int, int, int]] = {}

_stats = {"measurements": 0, "env_hits": 0, "cache_hits": 0,
          "builtin_hits": 0, "cost_model": 0}
_warned = set()
_memo: Dict[tuple, tuple] = {}      # resolution key -> (plan, source)
_memo_state = [None]                # (cache arg, state read, read at)


def stats() -> dict:
    """Counters since import or reset: a warm run records
    ``measurements == 0``."""
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    return f"cuda:{torch.cuda.get_device_name(index)}".replace(" ", "_")


def device_kind(device=None) -> str:
    """``cuda:<device name>`` (spaces to underscores) for a CUDA device,
    ``cpu:cpu`` for the CPU; None is the current CUDA device where there
    is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type}:{device.type}"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _cuda_kind(index)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def plan_key(m: int, k: int, n: int, *, in_dtype=torch.float32,
             out_dtype=None, f: int = ops.KERNEL_F, carry: bool = False,
             device: Optional[str] = None) -> str:
    """Cache key: ``{device}/{acc|one}/f{f}/{in}->{out}/{m}x{k}x{n}``.
    Input and output dtypes both count (their rates and stream widths
    differ), and the device kind (one cache file may serve several
    cards).  ``device`` is a `device_kind` string (the current device's
    by default)."""
    ind = _dtype_name(in_dtype)
    outd = _dtype_name(out_dtype) if out_dtype is not None else ind
    dev = device_kind() if device is None else device
    fam = "acc" if carry else "one"
    return f"{dev}/{fam}/f{f}/{ind}->{outd}/{m}x{k}x{n}"


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE


def _warn_once(tag: str, msg: str) -> None:
    if tag not in _warned:
        _warned.add(tag)
        warnings.warn(msg, stacklevel=3)


def _load_cache(path: Optional[str] = None) -> dict:
    """Plans dict from the cache file; {} (with a warning) when the file
    is truncated, corrupt or of another schema (the reference's included),
    {} silently when it is missing."""
    path = cache_path() if path is None else path
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {}
    except (json.JSONDecodeError, OSError, UnicodeDecodeError,
            ValueError) as e:
        _warn_once(path, f"autotune cache {path!r} unreadable ({e!r}); "
                         "falling back to the time model")
        return {}
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA \
            or not isinstance(doc.get("plans"), dict):
        _warn_once(path, f"autotune cache {path!r} has no {SCHEMA!r} plans "
                         "section; ignoring it")
        return {}
    return doc["plans"]


def _save_entry(key: str, entry: dict, path: Optional[str] = None) -> bool:
    """Merge one measured winner into the cache file (atomic rename).
    Unwritable locations degrade to False with a warning, never raise."""
    path = cache_path() if path is None else path
    plans = _load_cache(path)
    plans[key] = entry
    doc = {"schema": SCHEMA, "plans": plans}
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=".autotune-")
        with os.fdopen(fd, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        refresh()
        return True
    except OSError as e:
        _warn_once(path + ":write", f"autotune cache {path!r} unwritable "
                                    f"({e!r}); winner not persisted")
        return False


def _env_plans(raw: Optional[str]) -> dict:
    if not raw:
        return {}
    try:
        d = json.loads(raw)
        if not isinstance(d, dict):
            raise ValueError("not an object")
        return d
    except ValueError as e:
        _warn_once(PLAN_ENV, f"{PLAN_ENV} is not a JSON object ({e!r}); "
                             "ignoring the override")
        return {}


@functools.lru_cache(maxsize=4096)
def _candidates(m, k, n, in_dtype, out_bytes, f, carry, require_exact):
    """{(bm, bn, bk): plan} over ``ops.rank_blocks``' candidates."""
    return {(p.bm, p.bn, p.bk): p for p in ops.rank_blocks(
        m, k, n, in_dtype=in_dtype, out_bytes=out_bytes, f=f, carry=carry,
        require_exact=require_exact)}


def _plan_from_blocks(m, k, n, blocks, *, in_dtype, out_bytes, f, carry,
                      require_exact) -> Optional[ops.BlockPlan]:
    """The candidate plan with these (bm, bn, bk); None when the entry is
    malformed or names no candidate of this shape, family and dtype (which
    covers the caller's exactness contract)."""
    try:
        bm, bn, bk = (int(x) for x in blocks)
    except (TypeError, ValueError):
        return None
    return _candidates(m, k, n, in_dtype, out_bytes, f, carry,
                       require_exact).get((bm, bn, bk))


def _lookup(key: str, m, k, n, *, in_dtype, out_bytes, f, carry,
            require_exact, env, path: Optional[str] = None):
    """Layered read: env override > cache file > built-in defaults.
    Returns (plan, source) or (None, None)."""
    kw = dict(in_dtype=in_dtype, out_bytes=out_bytes, f=f, carry=carry,
              require_exact=require_exact)
    star_key = "*/" + key.split("/", 1)[1]
    for kk in (key, star_key):
        if kk in env:
            plan = _plan_from_blocks(m, k, n, env[kk], **kw)
            if plan is not None:
                return plan, "env"
    cached = _load_cache(path)
    if key in cached and isinstance(cached[key], dict):
        plan = _plan_from_blocks(m, k, n, cached[key].get("blocks"), **kw)
        if plan is not None:
            return plan, "cache"
    for kk in (key, star_key):
        if kk in BUILTIN:
            plan = _plan_from_blocks(m, k, n, BUILTIN[kk], **kw)
            if plan is not None:
                return plan, "builtin"
    return None, None


def _out_bytes(out_dtype) -> int:
    return out_dtype.itemsize if out_dtype is not None else 4


_RECHECK_S = 0.5   # how stale the env and the cache's mtime may be


def refresh() -> None:
    """Re-read the env knobs and the cache file at the next dispatch (a
    dispatch re-reads them by itself at most ``_RECHECK_S`` after the last
    read, and at once after this process writes the cache)."""
    _memo_state[0] = None


def _state(cache: Optional[str]):
    """What the resolution reads besides its key: the env override, the
    disable switch, the cache path and that file's mtime.  Re-read when
    ``cache`` changes, after `refresh` or a write of this process, and
    otherwise at most every ``_RECHECK_S`` seconds, so that a warm
    dispatch costs neither a system call nor an env read."""
    now = time.monotonic()
    last = _memo_state[0]
    if last is not None and last[0] is cache and now - last[2] < _RECHECK_S:
        return last[1]
    env = os.environ
    path = cache_path() if cache is None else cache
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    state = (env.get(PLAN_ENV), env.get(DISABLE_ENV) == "1", path, mtime)
    if last is None or last[1] != state:
        _memo.clear()
    _memo_state[0] = (cache, state, now)
    return state


def _resolve(state, m, k, n, in_dtype, out_dtype, f, carry, require_exact,
             device):
    """(plan, stats counter): the layered lookup, or the time model
    (counter "cost_model") where no layer holds a valid entry or the
    autotuner is disabled."""
    plan = source = None
    out_bytes = _out_bytes(out_dtype)
    if not state[1]:
        key = plan_key(m, k, n, in_dtype=in_dtype, out_dtype=out_dtype,
                       f=f, carry=carry, device=device_kind(device))
        plan, source = _lookup(key, m, k, n, in_dtype=in_dtype,
                               out_bytes=out_bytes, f=f, carry=carry,
                               require_exact=require_exact,
                               env=_env_plans(state[0]), path=state[2])
    if plan is None:
        return ops.pick_blocks(m, k, n, in_dtype=in_dtype,
                               out_bytes=out_bytes, f=f, carry=carry,
                               require_exact=require_exact), "cost_model"
    return plan, f"{source}_hits"


def best_plan(m: int, k: int, n: int, *, in_dtype=torch.float32,
              out_dtype=None, f: int = ops.KERNEL_F, carry: bool = False,
              require_exact: bool = False, device=None,
              cache: Optional[str] = None) -> Optional[ops.BlockPlan]:
    """Dispatch-side plan resolution: layered lookup, time-model fallback.

    NEVER measures: a cold cache costs one ``pick_blocks``, so a fresh
    checkout plans as the model does.  The resolution is memoized on the
    key and on what `_state` reads, so a repeat costs a dict lookup.
    ``device`` is the operands' device (its kind is part of the key).
    ``REPRO_TORCH_AUTOTUNE_DISABLE=1`` forces the model."""
    state = _state(cache)
    mkey = (m, k, n, in_dtype, out_dtype, f, carry, require_exact, device)
    hit = _memo.get(mkey)
    if hit is None:
        hit = _memo[mkey] = _resolve(state, *mkey)
    _stats[hit[1]] += 1
    return hit[0]


_last_operands: dict = {}          # the shape's operands while `autotune`
                                   # measures its candidates


def _operands(m, k, n, in_dtype, seed, device):
    key = (m, k, n, in_dtype, seed, device)
    if key in _last_operands:
        return _last_operands[key]
    _last_operands.clear()
    rng = np.random.RandomState(seed)
    if not in_dtype.is_floating_point:
        a = torch.from_numpy(rng.randint(-4, 5, size=(m, k)))
        b = torch.from_numpy(rng.randint(-4, 5, size=(k, n)))
    else:
        a = torch.from_numpy(rng.standard_normal((m, k)))
        b = torch.from_numpy(rng.standard_normal((k, n)))
    out = _last_operands[key] = (a.to(device=device, dtype=in_dtype),
                                 b.to(device=device, dtype=in_dtype))
    return out


def measure_plan(m: int, k: int, n: int, plan: ops.BlockPlan, *,
                 in_dtype=torch.float32, out_dtype=None, carry: bool = False,
                 reps: int = 2, seed: int = 0, device=None) -> float:
    """Seconds of one call under ``plan``, best of ``reps`` after a warm-up
    call.  On a CUDA device: the kernel of the family (kernel #1 for the
    one-shot family, kernel #2 for the accumulate family), CUDA events
    around each call, the L2 flushed before it.  On the CPU: the
    accumulate family's plan-sensitive PyTorch twin, host clock."""
    _stats["measurements"] += 1
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    integer = not in_dtype.is_floating_point
    if out_dtype is None:
        out_dtype = torch.int32 if integer else torch.float32
    a, b = _operands(m, k, n, in_dtype, seed, device)
    c0 = torch.zeros((m, n), dtype=out_dtype, device=device)
    st0 = ops.acc_state_zeros(plan, device=device)
    cuda = device.type == "cuda"
    if cuda and not carry:
        wm = ops.kernel_weights(m, device=device)
        wn = ops.kernel_weights(n, device=device).T.contiguous()

        def run():
            return ops._run_oneshot(plan, out_dtype, a, b, wm, wn)
    else:
        backend = "cuda" if cuda else "torch"

        def run():
            return ops.abft_matmul_acc(a, b, c0, st0, plan=plan,
                                       verify=carry, out_dtype=out_dtype,
                                       backend=backend)

    run()                       # warm caches (and the first launch)
    best = float("inf")
    if not cuda:
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=device)
    for _ in range(max(1, reps)):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) * 1e-3)
    return best


def autotune(m: int, k: int, n: int, *, in_dtype=torch.float32,
             out_dtype=None, f: int = ops.KERNEL_F, carry: bool = False,
             require_exact: bool = False, top_k: int = 4, reps: int = 2,
             cache: Optional[str] = None, write: bool = True, device=None):
    """Measure the top-K model-ranked plans for one shape and persist the
    winner.  Returns (plan, info dict).

    A warm cache (or env override) short-circuits with ZERO measurements.
    The model's plan is always measurement candidate #0, so the returned
    plan beats or matches it on every measured shape by construction."""
    out_bytes = _out_bytes(out_dtype)
    dev = device_kind(device)
    key = plan_key(m, k, n, in_dtype=in_dtype, out_dtype=out_dtype,
                   f=f, carry=carry, device=dev)
    info = {"key": key, "measured_us": {}, "model_blocks": None}
    plan, source = _lookup(
        key, m, k, n, in_dtype=in_dtype, out_bytes=out_bytes, f=f,
        carry=carry, require_exact=require_exact,
        env=_env_plans(os.environ.get(PLAN_ENV)), path=cache)
    if plan is not None:
        _stats[f"{source}_hits"] += 1
        info["source"] = source
        return plan, info
    ranked = ops.rank_blocks(m, k, n, in_dtype=in_dtype, out_bytes=out_bytes,
                             f=f, carry=carry, require_exact=require_exact)
    if not ranked:
        info["source"] = "none"
        return None, info
    cands = ranked[:max(1, top_k)]
    info["model_blocks"] = (cands[0].bm, cands[0].bn, cands[0].bk)
    best = None
    best_t = float("inf")
    for cand in cands:
        t = measure_plan(m, k, n, cand, in_dtype=in_dtype,
                         out_dtype=out_dtype, carry=carry, reps=reps,
                         device=device)
        info["measured_us"][f"{cand.bm}x{cand.bn}x{cand.bk}"] = t * 1e6
        if t < best_t:
            best, best_t = cand, t
    _last_operands.clear()
    info["source"] = "measured"
    info["best_us"] = best_t * 1e6
    info["route"] = best.route
    if write:
        entry = {"blocks": [best.bm, best.bn, best.bk],
                 "best_us": best_t * 1e6,
                 "model_blocks": list(info["model_blocks"]),
                 "route": best.route, "source": "measured"}
        info["persisted"] = _save_entry(key, entry, path=cache)
    return best, info
