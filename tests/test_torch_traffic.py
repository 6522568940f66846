"""Paged serving under traffic: the port's `serve.traffic`,
`PagedServeEngine` and contiguous `ServeEngine` against each other and
against the reference.

  * `make_trace` draws exactly the reference's trace, item for item;
  * `compare` gives the reference's accounting;
  * the port's paged engine (paged KV, chunked prefill, prefix cache, SLO
    scheduler, page scrub every step, protected logits reduction) emits
    the token streams of the port's contiguous engine on the same trace,
    clean and under two SDCs and two page flips, all corrected;
  * the port's paged engine and the reference's, on one trace with the
    reference's weights carried over by ``convert.params_from_jax``, emit
    the same token streams and keep the same page bookkeeping;
  * where the reference's prefix-shared prefill writes past the cache and
    diverges from its contiguous engine, the port's does not.

Smoke Qwen2-0.5B on the CPU.  The reference's protected engine runs on a
one-device mesh with ``Auto`` axes (on this jax its default mesh's
``Explicit`` axes reject the embedding gather).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serve.traffic as jtraffic
import repro_torch.serve.traffic as ttraffic
from repro.configs.base import smoke_config as jsmoke
from repro.ft.failures import SDCInjector as JSDCInjector
from repro.ft.failures import SDCPlan as JSDCPlan
from repro.models import transformer as jtf
from repro.serve.engine import PagedServeEngine as JPaged
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import SchedPolicy as JPolicy
from repro.serve.scheduler import SLOScheduler as JScheduler
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.ft.failures import SDCInjector, SDCPlan
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.serve.scheduler import SchedPolicy, SLOScheduler
from repro_torch.serve.traffic import (TrafficConfig, TrafficReport, compare,
                                       make_trace, run_trace)

ARCH = "qwen2-0.5b"
PAGE = 8


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def params():
    pj = jtf.init_params(jax.random.PRNGKey(0), jsmoke(ARCH))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), tsmoke(ARCH))


def paged(params, sdc=None, **kw):
    kw.setdefault("chunk_prefill", 2 * PAGE)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("scheduler", SLOScheduler(SchedPolicy(max_queue=64)))
    e = PagedServeEngine(tsmoke(ARCH), params[1], slots=3, max_len=64,
                         page_size=PAGE, scrub_every=1,
                         abft_reduce="correct", sdc=sdc, **kw)
    e.warm(prompt_len=8, decode_steps=2)
    e.reset()
    return e


def contiguous(params):
    e = ServeEngine(tsmoke(ARCH), params[1], slots=3, max_len=64)
    e.warm(prompt_len=8, decode_steps=2)
    e.reset()
    return e


def trace_cfg(mod=ttraffic, **kw):
    kw.setdefault("n_requests", 8)
    kw.setdefault("vocab", 512)
    kw.setdefault("arrival", "open")
    kw.setdefault("rate_per_step", 0.7)
    kw.setdefault("prompt_max", 24)
    kw.setdefault("out_max", 6)
    kw.setdefault("shared_prefix_len", 2 * PAGE)
    kw.setdefault("seed", 5)
    return mod.TrafficConfig(**kw)


# ---------------------------------------------------------------------------
# traces and reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"seed": 6}, {"arrival": "closed", "n_requests": 32},
    {"n_priorities": 3, "seed": 11, "prompt_min": 4},
    {"n_requests": 24, "vocab": 151936, "rate_per_step": 0.25,
     "prompt_min": 288, "prompt_max": 1536, "out_min": 8, "out_max": 64,
     "shared_prefix_len": 256, "seed": 9},
])
def test_make_trace_matches_reference_item_for_item(kw):
    got = make_trace(trace_cfg(ttraffic, **kw))
    want = jtraffic.make_trace(trace_cfg(jtraffic, **kw))
    assert [dataclasses.astuple(t) for t in got] == \
        [dataclasses.astuple(t) for t in want]
    assert dataclasses.asdict(trace_cfg(ttraffic, **kw)) == \
        dataclasses.asdict(trace_cfg(jtraffic, **kw))


def test_trace_determinism_and_bounds():
    a, b = make_trace(trace_cfg()), make_trace(trace_cfg())
    assert a == b and make_trace(trace_cfg(seed=6)) != a
    shared = a[0].prompt[:2 * PAGE]
    assert all(it.prompt[:2 * PAGE] == shared for it in a)
    cfg = trace_cfg(n_requests=32, prompt_min=4)
    tr = make_trace(cfg)
    arr = [it.arrive_step for it in tr]
    assert arr == sorted(arr) and arr[-1] > 0
    for it in tr:
        assert cfg.prompt_min <= len(it.prompt) <= cfg.prompt_max
        assert cfg.out_min <= it.max_new <= cfg.out_max
    with pytest.raises(ValueError):
        TrafficConfig(arrival="bursty")


@pytest.mark.parametrize("fault", [
    {"p99_ttft_ms": 30.0, "tok_per_s": 16.0, "detections": 3,
     "corrections": 3},
    {"outputs": {0: [1, 9], 1: [3]}, "detections": 1},
])
def test_compare_matches_reference(fault):
    base = dict(n_requests=2, n_finished=2, n_rejected=0, wall_s=1.0,
                decode_steps=10, total_tokens=20, tok_per_s=20.0,
                p50_ttft_ms=10.0, p99_ttft_ms=20.0, mean_ttft_ms=12.0,
                detections=0, corrections=0, sdc_events=0, sdc_corrected=0,
                scrub_checks=5, scrub_repairs=0, prefix_hits=0,
                outputs={0: [1, 2], 1: [3]})
    got = compare(TrafficReport(**base), TrafficReport(**{**base, **fault}),
                  expected_faults=3)
    want = jtraffic.compare(jtraffic.TrafficReport(**base),
                            jtraffic.TrafficReport(**{**base, **fault}),
                            expected_faults=3)
    assert got == want
    assert TrafficReport(**base).asdict() == \
        jtraffic.TrafficReport(**base).asdict()


# ---------------------------------------------------------------------------
# the port's paged engine against its contiguous engine
# ---------------------------------------------------------------------------


def test_paged_matches_contiguous_clean(params):
    tr = make_trace(trace_cfg())
    ref = run_trace(contiguous(params), tr)
    eng = paged(params)
    seen = []
    got = run_trace(eng, tr, on_step=lambda e, s: seen.append(s))
    assert got.n_finished == ref.n_finished == len(tr)
    assert got.outputs == ref.outputs
    assert got.prefix_hits > 0 and got.detections == 0
    assert got.scrub_checks == len(seen)     # one page scrub a decode step
    eng.kv.check_invariants()
    assert eng.kv.checksums_consistent()


def test_unchunked_paged_matches_chunked(params):
    tr = make_trace(trace_cfg(seed=11))
    a = run_trace(paged(params), tr)
    b = run_trace(paged(params, chunk_prefill=0, prefix_cache=False,
                        scheduler=None), tr)
    assert a.outputs == b.outputs


def test_paged_matches_contiguous_drilled(params):
    """Two mid-decode SDCs on the logits reduction and two page flips, at
    executed steps picked as the obs recorder picks them: all detected and
    corrected, token streams equal to the contiguous engine's."""
    tr = make_trace(trace_cfg(seed=7))
    ref = run_trace(contiguous(params), tr)
    seen = []
    clean = run_trace(paged(params), tr, on_step=lambda e, s: seen.append(s))
    assert clean.outputs == ref.outputs
    sdc_steps = (seen[len(seen) // 3], seen[len(seen) // 2])
    dram_steps = {seen[2 * len(seen) // 3], seen[(5 * len(seen)) // 6]}
    eng = paged(params, sdc=SDCInjector(
        SDCPlan(tuple((s, 0, 1e4) for s in sdc_steps))))
    fired = []

    def drill(e, step):
        if step in dram_steps and step not in fired:
            fired.append(step)
            key = next(iter(e.kv.pools))
            live = e.kv.live_pages()
            e.kv.corrupt_page(key, live[len(fired) % len(live)], bit=30)

    fault = run_trace(eng, tr, on_step=drill)
    assert len(fired) == len(dram_steps)
    assert fault.outputs == ref.outputs
    assert fault.sdc_events == len(sdc_steps) == fault.sdc_corrected
    assert fault.scrub_repairs == len(dram_steps)
    d = compare(clean, fault,
                expected_faults=len(sdc_steps) + len(dram_steps))
    assert d["faults_missed"] == 0 and d["token_streams_identical"]
    assert all(e.page >= 0 for e in eng.stats.scrub_events)
    eng.kv.check_invariants()
    assert eng.kv.checksums_consistent()


def test_rejection_under_tiny_queue(params):
    eng = paged(params, scheduler=SLOScheduler(SchedPolicy(max_queue=1)))
    tr = make_trace(trace_cfg(arrival="closed", n_requests=8))
    rep = run_trace(eng, tr)
    assert rep.n_rejected > 0
    assert rep.n_finished + rep.n_rejected == len(tr)
    assert rep.n_finished >= 1


# ---------------------------------------------------------------------------
# the port's paged engine against the reference's
# ---------------------------------------------------------------------------


def test_paged_engine_matches_reference(params):
    """One trace through both packages' paged engines (protected logits
    reduction, page scrub every step, chunked prefill, prefix cache, SLO
    scheduler) with the same weights, and an SDC at the same executed
    step: equal token streams, decode steps, detections, prefix hits and
    page bookkeeping, and the reference's pool keys."""
    tr_cfg = dict(seed=3, n_requests=10, rate_per_step=0.6)
    ttr = make_trace(trace_cfg(ttraffic, **tr_cfg))
    jtr = jtraffic.make_trace(trace_cfg(jtraffic, **tr_cfg))
    plan = ((6, 0, 1e4),)
    je = JPaged(jsmoke(ARCH), params[0], slots=3, max_len=64,
                page_size=PAGE, chunk_prefill=2 * PAGE, prefix_cache=True,
                scrub_every=1, abft_reduce="correct", mesh=_mesh(),
                sdc=JSDCInjector(JSDCPlan(plan)),
                scheduler=JScheduler(JPolicy(max_queue=64)))
    je.warm(prompt_len=8, decode_steps=2)
    je.reset()
    te = paged(params, sdc=SDCInjector(SDCPlan(plan)))
    assert list(te.kv.pools) == list(je.kv.pools)
    assert sorted(te.kv.pools) == sorted(je.kv.pools)
    want = jtraffic.run_trace(je, jtr)
    got = run_trace(te, ttr)
    assert got.outputs == want.outputs
    for k in ("n_finished", "n_rejected", "decode_steps", "total_tokens",
              "detections", "corrections", "sdc_events", "sdc_corrected",
              "scrub_checks", "scrub_repairs", "prefix_hits"):
        assert getattr(got, k) == getattr(want, k), k
    assert [(e.step, e.detected, e.corrected, e.row, e.col)
            for e in te.stats.events] == \
        [(e.step, e.detected, e.corrected, e.row, e.col)
         for e in je.stats.events]
    assert vars(te.kv.stats) == vars(je.kv.stats)
    np.testing.assert_array_equal(te.kv.table, je.kv.table)
    assert te.kv.free == je.kv.free


def test_prefix_hit_with_long_suffix_matches_contiguous_unlike_reference(
        params):
    """A prefix hit followed by an unchunked suffix whose bucket runs past
    the cache: request 1 shares request 0's 16-token page prefix and
    prefills 44 tokens from position 16, padded to a 64-token bucket.  The
    reference's clamped cache write shifts them and its paged engine leaves
    its contiguous engine's tokens; the port's bucket stops at max_len and
    its paged engine keeps its contiguous engine's tokens."""
    rs = np.random.RandomState(1)
    shared = rs.randint(0, 512, 17).tolist()
    prompts = [shared + rs.randint(0, 512, 3).tolist(),
               shared[:16] + rs.randint(0, 512, 44).tolist()]

    def drive(eng, req):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=list(p), max_new_tokens=3))
        return {r.rid: list(r.output) for r in eng.run()}

    kw = dict(slots=2, max_len=64)
    pkw = dict(page_size=PAGE, chunk_prefill=0, prefix_cache=True)
    jpaged = JPaged(jsmoke(ARCH), params[0], **kw, **pkw)
    j_out = drive(jpaged, JRequest)
    j_contig = drive(JEngine(jsmoke(ARCH), params[0], **kw), JRequest)
    tpaged = PagedServeEngine(tsmoke(ARCH), params[1], **kw, **pkw)
    t_out = drive(tpaged, Request)
    t_contig = drive(ServeEngine(tsmoke(ARCH), params[1], **kw), Request)
    assert jpaged.kv.stats.prefix_hits == tpaged.kv.stats.prefix_hits == 1
    assert j_contig == t_contig
    assert j_contig[1] == [260, 245, 392]
    assert j_out[1] == [97, 384, 201] != j_contig[1]     # the reference
    assert t_out == t_contig                             # the port


def test_idle_slot_past_the_cache_matches_reference(params):
    """Requests served one after another on two slots: the idle slot's
    cache index counts past max_len, and its decode write is dropped in
    both packages (the reference's out-of-bounds scatter drops it)."""
    def drive(eng, req):
        out = []
        for i in range(3):
            eng.submit(req(rid=i, prompt=[1, 2, 3], max_new_tokens=10))
            out += [list(r.output) for r in eng.run()]
        return out

    kw = dict(slots=2, max_len=16)
    want = drive(JEngine(jsmoke(ARCH), params[0], **kw), JRequest)
    assert drive(ServeEngine(tsmoke(ARCH), params[1], **kw), Request) == want
    assert drive(PagedServeEngine(tsmoke(ARCH), params[1], page_size=PAGE,
                                  **kw), Request) == want


@pytest.mark.gpu
def test_paged_matches_contiguous_on_the_card():
    """The port's paged engine on the card (kernel #1 on every protected
    projection) against its contiguous engine on the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py's phase 14 runs this on the H100)")
    from repro_torch.models import transformer as tf

    cfg = tsmoke(ARCH)
    p = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tr = make_trace(trace_cfg(seed=7))
    kw = dict(slots=3, max_len=64, abft_mode="verify", abft_backend="cuda")
    c = ServeEngine(cfg, p, **kw)
    e = PagedServeEngine(cfg, p, page_size=PAGE, chunk_prefill=0,
                         prefix_cache=False, scrub_every=1,
                         abft_reduce="correct", **kw)
    assert run_trace(e, tr).outputs == run_trace(c, tr).outputs
    assert all(t.is_cuda for t in e.kv.pools.values())
    assert e.kv._fp[next(iter(e.kv.pools))].is_cuda
