"""The port's SLO scheduler (``repro_torch.serve.scheduler``) against the
reference's, and the port's chunked prefill against its decode stream.

The reference's scheduler properties run on both packages under a fake
clock; a random submit/pop/tick sequence drives both packages' schedulers
with one injected clock and must give the same pop order and the same
stats.  The engine half drives the port's `PagedServeEngine` (smoke
Qwen2-0.5B on the CPU): a max-length prompt's chunked prefill advances at
most one chunk between two running decode steps, and chunking does not
change the emitted tokens.
"""
import numpy as np
import pytest
import torch

import repro.serve.scheduler as jsched
import repro_torch.serve.scheduler as tsched

MODS = {"reference": jsched, "port": tsched}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock():
    return FakeClock()


@pytest.fixture(params=sorted(MODS))
def mod(request):
    return MODS[request.param]


def sched(mod, clock, **kw):
    return mod.SLOScheduler(mod.SchedPolicy(**kw), clock=clock)


# ---------------------------------------------------------------------------
# the reference's scheduler properties, on both packages
# ---------------------------------------------------------------------------


def test_fifo_at_equal_priority(mod, clock):
    s = sched(mod, clock, n_priorities=3)
    for i in range(5):
        s.submit(i)
        clock.t += 0.2
    assert [s.pop() for _ in range(5)] == [0, 1, 2, 3, 4]
    assert len(s) == 0 and s.stats.popped == 5


def test_priority_classes_and_fifo_ties(mod, clock):
    s = sched(mod, clock, n_priorities=3, age_boost_s=100.0)
    for req, pri in (("low-a", 2), ("high-a", 0), ("mid", 1), ("high-b", 0),
                     ("low-b", 2)):
        s.submit(req, pri)
    assert [s.pop() for _ in range(5)] == \
        ["high-a", "high-b", "mid", "low-a", "low-b"]


def test_admission_control_bounds_queue(mod, clock):
    s = sched(mod, clock, max_queue=2)
    assert s.submit("a") and s.submit("b")
    assert not s.submit("c"), "max_queue must reject"
    assert s.stats.rejected == 1 and len(s) == 2
    s.pop()
    assert s.submit("c"), "a pop frees a queue slot"


def test_priority_clamping(mod, clock):
    s = sched(mod, clock, n_priorities=3)
    s.submit("over", 99)
    s.submit("under", -7)
    e_over, e_under = s._items
    assert e_over.priority == 2 and e_under.priority == 0


def test_aging_promotes_one_class_per_boost(mod, clock):
    s = sched(mod, clock, n_priorities=3, age_boost_s=1.0)
    s.submit("old-low", 2)
    e = s._items[0]
    assert s.effective_priority(e, clock()) == 2
    clock.t = 1.5
    assert s.effective_priority(e, clock()) == 1
    clock.t = 3.2
    assert s.effective_priority(e, clock()) == -1


def test_queue_age_bound_under_priority_inversion(mod, clock):
    boost, p = 0.5, 2
    s = sched(mod, clock, n_priorities=3, age_boost_s=boost)
    s.submit("victim", p)
    bound = s.queue_age_bound_s(p)
    assert bound == (p + 1) * boost
    popped_at = None
    for _ in range(100):                   # one fresh high-pri per tick
        s.submit(object(), 0)
        if s.pop() == "victim":
            popped_at = clock.t
            break
        clock.t += 0.1
    assert popped_at is not None, "victim starved"
    assert p * boost - 1e-9 <= popped_at <= bound


def test_stats_track_waits(mod, clock):
    s = sched(mod, clock)
    s.submit("a")
    clock.t = 2.0
    s.pop()
    assert s.stats.max_wait_s == pytest.approx(2.0)
    assert s.stats.mean_wait_s() == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# both packages under one injected clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pop_orders_and_stats_match_reference(seed):
    """A random stream of submits (random classes, a bounded queue), pops
    and clock ticks through both schedulers, one clock: the same
    admissions, the same pop order, equal stats."""
    rs = np.random.RandomState(seed)
    clock = FakeClock()
    pol = dict(max_queue=int(rs.randint(0, 6)), n_priorities=3,
               age_boost_s=float(rs.choice([0.0, 0.3, 1.0])))
    s = {k: sched(m, clock, **pol) for k, m in MODS.items()}
    seen = {k: [] for k in MODS}
    for rid in range(200):
        op = rs.randint(3)
        if op == 0:
            pri = int(rs.randint(-1, 5))
            for k in MODS:
                seen[k].append(("submit", s[k].submit(rid, pri)))
        elif op == 1:
            for k in MODS:
                seen[k].append(("pop", s[k].pop(), s[k].peek()))
        else:
            clock.t += float(rs.exponential(0.2))
    assert seen["port"] == seen["reference"]
    assert vars(s["port"].stats) == vars(s["reference"].stats)
    assert len(s["port"]) == len(s["reference"])


# ---------------------------------------------------------------------------
# the port's engine: chunked prefill cannot stall a running decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paged_engine():
    from repro_torch.configs.base import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import PagedServeEngine

    cfg = smoke_config("qwen2-0.5b")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    eng = PagedServeEngine(cfg, params, slots=2, max_len=64, page_size=8,
                           chunk_prefill=8, prefix_cache=False)
    eng.warm(prompt_len=8, decode_steps=2)
    eng.reset()
    return eng


def test_chunk_budget_bounds_decode_stall(paged_engine, rs):
    """While a decode is running, a max-length prompt's prefill advances at
    most ONE chunk per decode step."""
    from repro_torch.serve.engine import Request

    eng = paged_engine
    eng.reset()
    vocab, chunk = eng.cfg.vocab_size, eng.chunk_prefill
    eng.submit(Request(rid=0, prompt=rs.randint(0, vocab, 8).tolist(),
                       max_new_tokens=12))
    long_plen = eng.max_len - 9
    progress = []

    def on_step(e, step):
        if step == 2:
            e.submit(Request(rid=1,
                             prompt=rs.randint(0, vocab, long_plen).tolist(),
                             max_new_tokens=4))
        if e._prefilling is not None:
            progress.append((step, e._prefilling["start"]))

    fin = eng.run(on_step=on_step)
    assert len(fin) == 2 and all(r.done for r in fin)
    assert len(progress) >= 2, "prefill never overlapped running decode"
    steps = [s for s, _ in progress]
    assert steps == sorted(set(steps))
    deltas = np.diff([p for _, p in progress])
    assert (deltas <= chunk).all() and (deltas > 0).any()
    eng.kv.check_invariants()


def test_chunked_prefill_token_stream_matches_unchunked(paged_engine, rs):
    from repro_torch.serve.engine import Request

    eng = paged_engine
    vocab = eng.cfg.vocab_size
    prompts = [rs.randint(0, vocab, n).tolist() for n in (30, 9, 17)]

    def drive(chunk):
        eng.reset()
        old = eng.chunk_prefill
        eng.chunk_prefill = chunk
        try:
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=5))
            return {r.rid: list(r.output) for r in eng.run()}
        finally:
            eng.chunk_prefill = old

    assert drive(0) == drive(8)
