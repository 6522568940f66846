"""The port's measured autotuner against the reference's behaviour: layered
resolution (env > cache > built-in > model), cold and warm paths, corrupt,
foreign and unwritable caches, dtype-keyed plans and the exactness
contract (the reference's ``tests/test_autotune.py``, case for case), the
structural plan accounting held to the reference's integers, the dispatch
sites resolving through ``best_plan``, and the pre-warm CLI.

On the CPU ``measure_plan`` times the accumulate family's PyTorch twin,
as the reference times its XLA twin off the TPU.  Every test gets its own
cache file; ``refresh()`` makes a dispatch re-read the env at once (a
dispatch re-reads it by itself at most every half second).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops

M = K = N = 256
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_cache(monkeypatch, tmp_path):
    """Every test gets its own cache file and clean counters and env."""
    monkeypatch.delenv(at.PLAN_ENV, raising=False)
    monkeypatch.delenv(at.DISABLE_ENV, raising=False)
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "autotune.json"))
    at.reset_stats()
    at._warned.clear()
    at.refresh()
    yield tmp_path
    at.refresh()


def _setenv(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    at.refresh()


def _blocks(plan):
    return (plan.bm, plan.bn, plan.bk)


def test_cold_miss_falls_back_to_cost_model():
    plan = at.best_plan(M, K, N, device=CPU)
    assert plan == ops.pick_blocks(M, K, N)
    st = at.stats()
    assert st["cost_model"] == 1
    assert st["measurements"] == 0          # best_plan NEVER measures
    assert st["cache_hits"] == 0


def test_autotune_measures_persists_and_warm_run_skips():
    plan, info = at.autotune(M, K, N, top_k=2, reps=1, device=CPU)
    assert plan is not None
    assert info["source"] == "measured"
    n_meas = at.stats()["measurements"]
    assert n_meas == 2                       # top_k candidates, once each
    assert info["persisted"]
    # the model's plan is candidate #0: the winner beats or matches it
    mb = "x".join(str(b) for b in info["model_blocks"])
    wb = "x".join(str(b) for b in _blocks(plan))
    assert info["measured_us"][wb] <= info["measured_us"][mb]
    assert info["model_blocks"] == _blocks(ops.pick_blocks(M, K, N))
    # warm: autotune() and best_plan() resolve from the cache, with ZERO
    # further measurements
    plan2, info2 = at.autotune(M, K, N, top_k=2, reps=1, device=CPU)
    assert info2["source"] == "cache"
    assert _blocks(plan2) == _blocks(plan)
    plan3 = at.best_plan(M, K, N, device=CPU)
    assert plan3 == plan2                    # the candidate, route and all
    st = at.stats()
    assert st["measurements"] == n_meas
    assert st["cache_hits"] == 2


@pytest.mark.parametrize("payload", [
    "{ not json",                                          # corrupt
    '{"schema": "repro_torch.kernels.autotune/v1", "pl',   # truncated
    '{"schema": "something/else", "plans": {}}',           # foreign schema
    '{"schema": "repro.kernels.autotune/v1", "plans": '    # the JAX
    '{"*/one/f2/float32->float32/256x256x256": '           # package's
    '{"blocks": [256, 256, 256]}}}',                       # cache
    '[1, 2, 3]',                                           # wrong shape
])
def test_corrupt_cache_ignored_with_warning(tmp_path, payload):
    (tmp_path / "autotune.json").write_text(payload)
    with pytest.warns(UserWarning, match="autotune cache"):
        plan = at.best_plan(M, K, N, device=CPU)
    assert plan == ops.pick_blocks(M, K, N)         # clean fallback
    assert at.stats()["measurements"] == 0


def test_env_override_wins_over_cache(monkeypatch):
    plan, _ = at.autotune(M, K, N, top_k=1, reps=1, device=CPU)
    other = ops.rank_blocks(M, K, N)[1]             # not the cached winner
    assert _blocks(other) != _blocks(plan)
    key = at.plan_key(M, K, N, device="cpu:cpu")
    _setenv(monkeypatch, at.PLAN_ENV, json.dumps({key: _blocks(other)}))
    got = at.best_plan(M, K, N, device=CPU)
    assert got == other
    assert at.stats()["env_hits"] >= 1
    # the device-wildcard form resolves too
    star = {"*/" + key.split("/", 1)[1]: list(_blocks(other))}
    _setenv(monkeypatch, at.PLAN_ENV, json.dumps(star))
    assert at.best_plan(M, K, N, device=CPU) == other
    # blocks no H100 route has (the reference's 128-multiples) are
    # malformed here: the cache's winner serves instead
    _setenv(monkeypatch, at.PLAN_ENV, json.dumps({key: [128, 128, 128]}))
    assert _blocks(at.best_plan(M, K, N, device=CPU)) == _blocks(plan)


def test_disable_env_forces_pure_cost_model(monkeypatch):
    at.autotune(M, K, N, top_k=1, reps=1, device=CPU)
    _setenv(monkeypatch, at.DISABLE_ENV, "1")
    at.reset_stats()
    plan = at.best_plan(M, K, N, device=CPU)
    assert plan == ops.pick_blocks(M, K, N)
    assert at.stats()["cache_hits"] == 0


def test_cache_key_includes_dtype():
    k32 = at.plan_key(M, K, N, in_dtype=torch.float32, device="cpu:cpu")
    kbf = at.plan_key(M, K, N, in_dtype=torch.bfloat16, device="cpu:cpu")
    k8 = at.plan_key(M, K, N, in_dtype=torch.int8, out_dtype=torch.int32,
                     device="cpu:cpu")
    assert len({k32, kbf, k8}) == 3
    # the reference's key for the same plan, device field aside
    from repro.kernels import autotune as jat
    assert k8.split("/", 1)[1] == jat.plan_key(
        M, K, N, in_dtype=jnp.int8, out_dtype=jnp.int32,
        device="x").split("/", 1)[1]
    # a bf16 winner must NOT serve fp32 lookups
    at.autotune(M, K, N, in_dtype=torch.bfloat16, top_k=1, reps=1,
                device=CPU)
    at.reset_stats()
    at.best_plan(M, K, N, in_dtype=torch.bfloat16, device=CPU)
    assert at.stats()["cache_hits"] == 1
    at.best_plan(M, K, N, in_dtype=torch.float32, device=CPU)
    assert at.stats()["cost_model"] == 1


def test_unwritable_cache_degrades_with_warning(tmp_path, monkeypatch):
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where a directory must go")
    _setenv(monkeypatch, at.CACHE_ENV, str(blocker / "autotune.json"))
    with pytest.warns(UserWarning, match="unwritable"):
        plan, info = at.autotune(M, K, N, top_k=1, reps=1, device=CPU)
    assert plan is not None                          # tuning still works
    assert info["persisted"] is False


def test_cached_entry_honors_require_exact():
    # persist a winner for a ragged shape whose tile pads it, then ask for
    # an exact plan: the cached entry must not satisfy the contract
    ragged = ops.pick_blocks(100, K, N)
    assert not ragged.exact
    key = at.plan_key(100, K, N, device="cpu:cpu")
    at._save_entry(key, {"blocks": list(_blocks(ragged))})
    assert at.best_plan(100, K, N, device=CPU) == ragged     # cache hit
    plan = at.best_plan(100, K, N, require_exact=True, device=CPU)
    assert plan is None                              # pick_blocks' verdict
    assert at.stats()["cache_hits"] == 1


def test_dispatch_is_memoized():
    """A warm dispatch reads neither the cache file nor the env again."""
    at.autotune(M, K, N, top_k=1, reps=1, device=CPU)
    calls = []
    real = at._load_cache
    at._load_cache = lambda path=None: calls.append(path) or real(path)
    try:
        plans = {at.best_plan(M, K, N, device=CPU) for _ in range(50)}
    finally:
        at._load_cache = real
    assert len(plans) == 1 and len(calls) <= 1
    assert at.stats()["cache_hits"] == 50


# ---------------------------------------------------------------------------
# plan accounting against the reference's structural integers
# ---------------------------------------------------------------------------

STRUCTURAL = ("gemm_bytes", "extra_hbm_rd_col", "extra_hbm_rd_row",
              "cs_wr_bytes", "carry_bytes", "unfused_extra_rd", "flops",
              "cs_flops", "total_bytes")


@pytest.mark.parametrize("shape", [(4, 896, 898), (1024, 896, 4866),
                                   (100, 900, 130), (3072, 3072, 3072)])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plan_accounting_structural_terms_equal_reference(shape, carry,
                                                          dtype):
    """For every candidate plan the port ranks, the reference's
    ``plan_accounting`` of the same (bm, bn, bk, pm, pk, pn) gives the
    same byte and FLOP integers; the time terms are the port's H100
    model (``t_total_s`` is what the ranking sorts on)."""
    m, k, n = shape
    out_bytes = 4
    cands = ops.rank_blocks(m, k, n, in_dtype=getattr(torch, dtype),
                            out_bytes=out_bytes, carry=carry)
    assert cands
    for p in cands:
        mine = ops.plan_accounting(p, in_dtype=getattr(torch, dtype),
                                   out_bytes=out_bytes, carry=carry)
        ref_plan = jops.BlockPlan(m=m, k=k, n=n, bm=p.bm, bn=p.bn, bk=p.bk,
                                  pm=p.pm, pk=p.pk, pn=p.pn, cost_bytes=0)
        ref = jops.plan_accounting(ref_plan, in_dtype=jnp.dtype(dtype),
                                   out_bytes=out_bytes, carry=carry)
        assert {t: mine[t] for t in STRUCTURAL} == \
            {t: int(ref[t]) for t in STRUCTURAL}, (p, mine, ref)
        assert mine["model_bytes"] == p.cost_bytes
    times = [ops.plan_accounting(p, in_dtype=getattr(torch, dtype),
                                 out_bytes=out_bytes,
                                 carry=carry)["t_total_s"] for p in cands]
    assert times == sorted(times)
    assert ops.tensor_rate(torch.bfloat16) == ops.TENSOR_FLOPS[
        torch.bfloat16]


# ---------------------------------------------------------------------------
# the dispatch sites
# ---------------------------------------------------------------------------


def test_dispatch_sites_resolve_through_best_plan(monkeypatch):
    """``ops.abft_matmul``, the protected projection and the SUMMA's
    local update ask ``best_plan`` (cold: the model's plans, as
    ``pick_blocks`` gave before), and a warmed cache serves them."""
    from repro_torch.core import abft_gemm as ag
    from repro_torch.core.summa import _resolve_local_update

    g = torch.Generator().manual_seed(0)
    a = torch.randn((64, 96), generator=g)
    b = torch.randn((96, 130), generator=g)
    at.reset_stats()
    ops.abft_matmul(a, b)
    assert at.stats()["cost_model"] == 1
    # the protected projection's plan (kernel path on the CPU via the
    # plain version: backend "cuda" takes the fused path)
    cfg = ag.ABFTConfig(mode="verify", backend="cuda")
    w_enc = ag.encode_weight(b[:, :128], cfg)
    at.reset_stats()
    ag._fused_forward(a, w_enc, cfg)
    assert at.stats()["cost_model"] == 1
    # the SUMMA's plan: exact tilings first, as pick_blocks before
    want = ops.pick_blocks(96, 96, 96, in_dtype=torch.float32, out_bytes=4,
                           carry=True, require_exact=True) \
        or ops.pick_blocks(96, 96, 96, in_dtype=torch.float32, out_bytes=4,
                           carry=True)
    assert _resolve_local_update("cuda", 96, 96, 96, torch.float32,
                                 CPU) == want
    # warmed: each gets the cached plan
    # (the projection's key is the product's: 64 x 96 x 130, fp32 out)
    at.autotune(64, 96, 130, out_dtype=torch.float32, top_k=2, reps=1,
                device=CPU)
    at.autotune(96, 96, 96, carry=True, require_exact=True, top_k=2,
                reps=1, device=CPU)
    at.reset_stats()
    ops.abft_matmul(a, b)
    _resolve_local_update("cuda", 96, 96, 96, torch.float32, CPU)
    ag._fused_forward(a, ag.encode_weight(b[:, :128], cfg), cfg)
    assert at.stats()["cache_hits"] == 3, at.stats()


# ---------------------------------------------------------------------------
# the pre-warm CLI
# ---------------------------------------------------------------------------


def _cli(module, tmp_path, tag):
    out = tmp_path / f"{tag}.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    argv = [sys.executable, "-m", module, "--shapes", "smoke", "--dtypes",
            "float32,int8", "--top-k", "2", "--reps", "1", "--cache",
            str(tmp_path / f"{tag}-cache.json"), "--json", str(out)]
    if module.startswith("repro_torch"):
        argv += ["--device", "cpu"]
    res = subprocess.run(argv, capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    return json.loads(out.read_text())


def test_cli_warms_then_measures_nothing(tmp_path):
    """Two invocations on one cache: the first measures, the second
    records ``measurements == 0``; the summary has the reference CLI's
    keys (each plan row its keys and more)."""
    first = _cli("repro_torch.launch.autotune", tmp_path, "p")
    second = _cli("repro_torch.launch.autotune", tmp_path, "p")
    ref = _cli("repro.launch.autotune", tmp_path, "r")
    assert first["measurements"] > 0
    assert second["measurements"] == 0
    assert second["cache_hits"] == len(second["plans"]) == 2
    assert set(first) == set(ref)
    assert all(set(r) >= set(ref["plans"][0]) for r in first["plans"])
    assert [r["key"].split("/", 1)[1] for r in first["plans"]] == \
        [r["key"].split("/", 1)[1] for r in ref["plans"]]
    assert first["device"] == "cpu:cpu"


@pytest.mark.gpu
def test_autotune_measures_the_kernels_on_the_card(tmp_path):
    """On the card the one-shot family times kernel #1 and the
    accumulate family kernel #2 (their launch counters move)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    from repro_torch.kernels import abft_matmul as kmm
    kmm.reset_counts()
    at.autotune(256, 256, 256, top_k=2, reps=2, device="cuda")
    assert kmm.launches > 0 and kmm.acc_launches == 0
    at.autotune(256, 256, 256, carry=True, require_exact=True, top_k=2,
                reps=2, device="cuda")
    assert kmm.acc_launches > 0
