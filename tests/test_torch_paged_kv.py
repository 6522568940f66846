"""The port's paged KV cache (``repro_torch.serve.paged_kv``) against the
reference's (``repro.serve.paged_kv``).

The reference's property tests (conservation, refcounts, page-granular
re-arm, copy-on-write, corrupt -> verify -> exact repair, zero-at-free,
NaN trips, LRU eviction, gather) run once on each package.  Random
admit/decode/evict/free/corrupt traces then drive both packages' caches in
lockstep: the host bookkeeping (table, refcounts, free list, prefixes,
stats, re-arm ledger) must be equal exactly, the armed float64 checksums
(``page_fp``, ``esum``, on the device in the port) within 1e-12 relative,
``verify`` must trip the same pages, and a repaired page must equal its
pre-corruption contents bit for bit.  Integer-valued fp32 payloads keep the
float64 checksum chain exact.
"""
import numpy as np
import pytest
import torch

import repro.serve.paged_kv as jpaged
import repro_torch.serve.paged_kv as tpaged

SLOTS, MAX_LEN, PS = 3, 32, 8
PKGS = ("reference", "port")


def make_kv(pkg, extra_pages=0, max_prefixes=4):
    mod = jpaged if pkg == "reference" else tpaged
    return mod.PagedKVCache(
        {"k": ((2, SLOTS, MAX_LEN, 4), np.float32),
         "v": ((2, SLOTS, MAX_LEN, 4), np.float32)},
        slots=SLOTS, max_len=MAX_LEN, page_size=PS,
        extra_pages=extra_pages, max_prefixes=max_prefixes)


def fill(rs, n, lo=1, hi=8):
    """Integer-valued float payloads: the float64 checksum chain is exact,
    so repair roundtrips bit-for-bit."""
    return rs.randint(lo, hi, size=(2, n, 4)).astype(np.float32)


def page(kv, key, phys):
    return np.array(kv.pools[key][:, phys])


def set_nan(kv, key, phys):
    pool = kv.pools[key]
    if isinstance(pool, torch.Tensor):
        pool[0, phys, 0, 0] = float("nan")
    else:
        kv.pools[key] = pool.at[0, phys, 0, 0].set(np.nan)


def ok(kv):
    kv.check_invariants()
    assert kv.checksums_consistent()


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


# ---------------------------------------------------------------------------
# the reference's targeted invariants, on both packages
# ---------------------------------------------------------------------------


def test_alloc_write_free_conservation(pkg, rs):
    kv = make_kv(pkg)
    total_free = kv.n_free()
    start = kv.alloc_slot(0, 20)
    assert start == 0 and kv.n_free() == total_free - 3  # ceil(20/8) pages
    kv.write("k", 0, 0, fill(rs, 20))
    kv.write("v", 0, 0, fill(rs, 20))
    ok(kv)
    kv.free_slot(0)
    assert kv.n_free() == total_free
    ok(kv)   # freed pages are zeroed and checksum-consistent again


def test_single_page_write_dirties_exactly_one_checksum(pkg, rs):
    kv = make_kv(pkg)
    kv.alloc_slot(0, 12)
    kv.write("k", 0, 0, fill(rs, 10))
    kv.write("v", 0, 0, fill(rs, 10))
    fp_before = {key: kv.page_fp[key].copy() for key in kv.pools}

    kv.begin_mutation()
    kv.write_token("k", 0, 10, fill(rs, 1)[:, 0])
    assert len(kv.last_rearmed) == 1, (
        f"single-page write re-armed {kv.last_rearmed}")
    (leaf, phys), = kv.last_rearmed
    assert leaf == "k" and phys == kv.page_of(0, 10)
    for key in kv.pools:
        same = kv.page_fp[key] == fp_before[key]
        if key == leaf:
            assert not same[phys] and same[np.arange(len(same)) != phys].all()
        else:
            assert same.all()
    ok(kv)


def test_write_across_page_boundary_rearms_both_pages(pkg, rs):
    kv = make_kv(pkg)
    kv.alloc_slot(0, 16)
    kv.begin_mutation()
    kv.write("k", 0, PS - 2, fill(rs, 4))   # straddles pages 0 and 1
    pages = {p for _, p in kv.last_rearmed}
    assert len(kv.last_rearmed) == 2 and len(pages) == 2
    ok(kv)


def test_prefix_sharing_refcounts_and_no_foreign_sharing(pkg, rs):
    kv = make_kv(pkg)
    prompt = list(range(100, 100 + 2 * PS))
    start = kv.alloc_slot(0, len(prompt) + 4, prompt=prompt)
    assert start == 0 and kv.stats.prefix_misses == 1
    kv.write("k", 0, 0, fill(rs, len(prompt)))
    kv.write("v", 0, 0, fill(rs, len(prompt)))
    kv.register_prefix(0, prompt)
    assert kv.stats.prefix_insertions == 1
    ok(kv)
    start1 = kv.alloc_slot(1, len(prompt) + 4, prompt=prompt)
    assert start1 == PS and kv.stats.prefix_hits == 1
    shared = kv.page_of(1, 0)
    assert shared == kv.page_of(0, 0) and kv.refcount[shared] == 3
    ok(kv)
    kv.free_slot(0)
    kv.free_slot(1)
    assert kv.refcount[shared] == 1
    ok(kv)


def test_copy_on_write_unshares(pkg, rs):
    kv = make_kv(pkg)
    prompt = list(range(2 * PS))
    kv.alloc_slot(0, 2 * PS + 2, prompt=prompt)
    kv.write("k", 0, 0, fill(rs, 2 * PS))
    kv.write("v", 0, 0, fill(rs, 2 * PS))
    kv.register_prefix(0, prompt)
    kv.alloc_slot(1, 2 * PS + 2, prompt=prompt)
    shared = kv.page_of(1, 0)
    before = page(kv, "k", kv.page_of(0, 0))

    kv.write("k", 1, 0, fill(rs, 2))    # write INTO the shared page
    assert kv.stats.cow_copies == 1
    assert kv.page_of(1, 0) != shared, "write must unshare first"
    np.testing.assert_array_equal(page(kv, "k", kv.page_of(0, 0)), before)
    ok(kv)


def test_corrupt_verify_locates_repair_exact(pkg, rs):
    kv = make_kv(pkg)
    kv.alloc_slot(0, 24)
    kv.write("k", 0, 0, fill(rs, 24))
    kv.write("v", 0, 0, fill(rs, 24))
    target = kv.page_of(0, PS)
    golden = page(kv, "k", target)

    kv.corrupt_page("k", target, bit=30)
    assert kv.verify() == [("k", target)]
    assert kv.repair("k", target)
    np.testing.assert_array_equal(page(kv, "k", target), golden)
    ok(kv)


def test_corrupted_free_page_detected_and_rebuilt_to_zero(pkg, rs):
    kv = make_kv(pkg)
    kv.alloc_slot(0, 8)
    kv.write("k", 0, 0, fill(rs, 8))
    free_page = kv.free[0]
    kv.corrupt_page("k", free_page, bit=30)
    assert ("k", free_page) in kv.verify()
    kv.repair("k", free_page)
    assert not np.any(page(kv, "k", free_page))
    ok(kv)


def test_nan_poisoned_page_trips(pkg, rs):
    kv = make_kv(pkg)
    kv.alloc_slot(0, 8)
    kv.write("k", 0, 0, fill(rs, 8))
    phys = kv.page_of(0, 0)
    set_nan(kv, "k", phys)
    assert ("k", phys) in kv.verify(), "NaN must not compare as clean"


def test_pool_exhaustion_evicts_lru_prefix_then_raises(pkg, rs):
    kv = make_kv(pkg, max_prefixes=4)
    prompt = list(range(PS + 1))
    kv.alloc_slot(0, PS + 1, prompt=prompt)
    kv.write("k", 0, 0, fill(rs, PS + 1))
    kv.write("v", 0, 0, fill(rs, PS + 1))
    kv.register_prefix(0, prompt)
    kv.free_slot(0)
    held = kv.n_free()
    for s in range(SLOTS):
        kv.alloc_slot(s, MAX_LEN)
    assert kv.stats.prefix_evictions == 1 and not kv.prefixes
    assert kv.n_free() == 0 and held == SLOTS * (MAX_LEN // PS) - 1
    ok(kv)
    with pytest.raises(RuntimeError, match="exhausted"):
        kv._alloc()


def test_gather_matches_dense_layout(pkg, rs):
    kv = make_kv(pkg)
    start = kv.alloc_slot(1, 12)
    vals = fill(rs, 12)
    kv.write("k", 1, start, vals)
    dense = np.array(kv.gather("k"))
    assert dense.shape == (2, SLOTS, MAX_LEN, 4)
    np.testing.assert_array_equal(dense[:, 1, :12], vals)
    assert not dense[:, 0].any() and not dense[:, 2].any()
    assert not dense[:, 1, 12:].any()


# ---------------------------------------------------------------------------
# the reference's random-trace state machine, on both packages
# ---------------------------------------------------------------------------


OPS = ("admit", "decode", "decode", "decode", "free", "corrupt_scrub")


def _ops(seed, n=60):
    rs = np.random.RandomState(seed)
    return [(OPS[rs.randint(len(OPS))], int(rs.randint(1 << 30)),
             int(rs.randint(1 << 30))) for _ in range(n)], rs


def _step(kv, slot_pos, op, r1, r2, rs):
    """One op of the trace on ``kv``; returns what the op observed (the
    scrub's repairs) so two caches can be compared op by op."""
    if op == "admit":
        free = [s for s in range(SLOTS) if s not in slot_pos]
        if not free:
            return None
        s = free[r1 % len(free)]
        plen = 2 + r2 % (MAX_LEN - 6)
        prompt = [101 + (r1 + i) % 7 for i in range(plen)]
        start = kv.alloc_slot(s, min(plen + 4, MAX_LEN), prompt=prompt)
        for key in kv.pools:
            kv.write(key, s, start, fill(rs, plen - start))
        kv.register_prefix(s, prompt)
        slot_pos[s] = plen
    elif op == "decode":
        if not slot_pos:
            return None
        s = sorted(slot_pos)[r1 % len(slot_pos)]
        if slot_pos[s] >= MAX_LEN:
            return None
        kv.begin_mutation()
        for key in kv.pools:
            kv.write_token(key, s, slot_pos[s], fill(rs, 1)[:, 0])
        assert len(kv.last_rearmed) == len(kv.pools)
        slot_pos[s] += 1
    elif op == "free":
        if not slot_pos:
            return None
        s = sorted(slot_pos)[r1 % len(slot_pos)]
        kv.free_slot(s)
        del slot_pos[s]
    elif op == "corrupt_scrub":
        live = kv.live_pages()
        if not live:
            return None
        phys = live[r1 % len(live)]
        key = sorted(kv.pools)[r2 % len(kv.pools)]
        golden = page(kv, key, phys)
        kv.corrupt_page(key, phys, bit=30)
        repaired = [tuple(t) for t in kv.scrub()]
        assert (key, phys) in repaired
        np.testing.assert_array_equal(page(kv, key, phys), golden)
        return repaired
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_trace_invariants(pkg, seed):
    ops, rs = _ops(seed)
    kv = make_kv(pkg, extra_pages=2)
    slot_pos = {}
    for op in ops:
        _step(kv, slot_pos, *op, rs)
        kv.check_invariants()
        assert kv.checksums_consistent(), f"after op {op[0]}"
    for s in range(SLOTS):
        kv.free_slot(s)
    registry_held = len({p for ps in kv.prefixes.values() for p in ps})
    assert kv.n_free() == kv.n_pages - 1 - registry_held
    kv.check_invariants()


# ---------------------------------------------------------------------------
# both packages in lockstep
# ---------------------------------------------------------------------------


def _same_state(j, t):
    np.testing.assert_array_equal(t.table, j.table)
    np.testing.assert_array_equal(t.refcount, j.refcount)
    assert t.free == j.free
    assert list(t.prefixes.items()) == list(j.prefixes.items())
    assert vars(t.stats) == vars(j.stats)
    assert t.last_rearmed == j.last_rearmed
    for key in j.pools:
        np.testing.assert_array_equal(np.array(t.pools[key]),
                                      np.array(j.pools[key]))
        for got, want in ((t.page_fp[key], j.page_fp[key]),
                          (t.esum[key], j.esum[key])):
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_lockstep_traces_match_reference(seed):
    """The same trace on both packages: equal bookkeeping after every op,
    float64 checksums within 1e-12 relative, the same tripped and repaired
    pages, and repairs bit-exact."""
    ops, _ = _ops(seed, n=80)
    kvs = {p: make_kv(p, extra_pages=2) for p in PKGS}
    pos = {p: {} for p in PKGS}
    rss = {p: np.random.RandomState(seed + 100) for p in PKGS}
    for op in ops:
        seen = {p: _step(kvs[p], pos[p], *op, rss[p]) for p in PKGS}
        assert seen["port"] == seen["reference"], op
        _same_state(kvs["reference"], kvs["port"])
    # a corrupted page of each leaf in turn: verify trips the same pairs
    live = kvs["reference"].live_pages()
    assert live == kvs["port"].live_pages()
    for key in ("k", "v"):
        for p in PKGS:
            kvs[p].corrupt_page(key, live[-1], index=3, bit=29)
        assert kvs["port"].verify() == kvs["reference"].verify() == \
            [(key, live[-1])]
        for p in PKGS:
            kvs[p].repair(key, live[-1])
        _same_state(kvs["reference"], kvs["port"])


def test_write_tokens_batches_write_token(rs):
    """The engine's batched decode write-back: one call for several slots
    leaves the cache exactly as `write_token` slot by slot (pools, both
    checksums, table, stats and re-arm ledger)."""
    a, b = make_kv("port"), make_kv("port")
    for kv in (a, b):
        for s in range(SLOTS):
            kv.alloc_slot(s, 4 + s)
    heads = [3, 8, 5]                      # slot 1 crosses into a new page
    vals = rs.randint(1, 8, size=(2, SLOTS, 4)).astype(np.float32)
    for key in a.pools:
        for s in range(SLOTS):
            a.write_token(key, s, heads[s], vals[:, s])
        b.write_tokens(key, list(range(SLOTS)), heads, vals)
    np.testing.assert_array_equal(a.table, b.table)
    assert a.stats == b.stats and a.last_rearmed == b.last_rearmed
    for key in a.pools:
        assert torch.equal(a.pools[key], b.pools[key])
        np.testing.assert_array_equal(a.page_fp[key], b.page_fp[key])
        np.testing.assert_array_equal(a.esum[key], b.esum[key])
    ok(b)


def test_checksums_live_on_the_pools_device():
    kv = make_kv("port")
    for key in kv.pools:
        assert kv._fp[key].dtype == torch.float64
        assert kv._esum[key].dtype == torch.float64
        assert kv._fp[key].device == kv.pools[key].device
        assert isinstance(kv.page_fp[key], np.ndarray)


def test_surface_registered_protected_as_reference():
    from repro.chaos.faults import get_surface as jget
    from repro_torch.chaos.faults import get_surface as tget
    got, want = tget("serve.paged_kv/pages"), jget("serve.paged_kv/pages")
    assert got.protected and got.owner == "repro_torch.serve.paged_kv"
    assert (got.promise, got.detector, got.kinds, got.note) == \
        (want.promise, want.detector, want.kinds, want.note)


@pytest.mark.gpu
def test_lockstep_trace_on_the_card_matches_cpu():
    """The port's cache on the card against itself on the CPU: the same
    trace gives the same pools bit for bit and checksums within 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 14 runs the "
                    "paged cache on the H100)")
    ops, _ = _ops(7, n=80)
    kvs = {}
    for dev in ("cpu", "cuda"):
        kv = tpaged.PagedKVCache(
            {"k": ((2, SLOTS, MAX_LEN, 4), torch.float32)},
            slots=SLOTS, max_len=MAX_LEN, page_size=PS, extra_pages=2,
            max_prefixes=4, device=dev)
        rs, pos = np.random.RandomState(7), {}
        for op in ops:
            _step(kv, pos, *op, rs)
        kvs[dev] = kv
    assert torch.equal(kvs["cpu"].pools["k"], kvs["cuda"].pools["k"].cpu())
    np.testing.assert_allclose(kvs["cuda"].page_fp["k"],
                               kvs["cpu"].page_fp["k"], rtol=1e-12)
    assert kvs["cuda"].checksums_consistent()
