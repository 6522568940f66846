"""Paged (block) KV cache: fixed-size pages as the unified protection unit.

The counterpart of the reference package's ``repro/serve/paged_kv.py``.
vLLM-style memory layout for the serving engines: every float KV-cache
leaf gets a page pool ``[repeats, n_pages, page_size, *tail]`` and all
leaves share ONE host-side page table ``[slots, pages_per_slot]`` mapping
each slot's logical pages onto physical pages.  Physical page 0 is the
reserved immutable **zero page** — unallocated table entries point at it,
so a gathered dense cache is exactly zero beyond every slot's write head
(which the causal mask discards; see the decode-parity note below).

The page is the ABFT unit for serving memory:

  * **checksum-on-write, page granular** — every mutation re-arms exactly
    the pages it touched: a per-(leaf, page) float64 scalar fingerprint
    (detect + locate) and a per-leaf float64 *elementwise* page sum
    ``esum[r, o, *tail] = sum_p pool[r, p, o, *tail]`` (the erasure row
    that repairs).  The update is ``+= new - old``, O(segment).
  * **verify-on-read** — `verify()` recomputes page fingerprints and
    returns the tripped (leaf, page) pairs; NaN-poisoned pages (a bit-30
    flip near 1.0) compare as tripped, not silently equal.
  * **erasure repair** — `repair()` rebuilds a page as
    ``esum - sum(other live pages)`` in float64 (single-page fault model,
    the f=1 erasure code of the diskless family applied to serving DRAM).
  * **prefix caching** — full pages of a shared system prompt register in
    an LRU map keyed by the token prefix; a later request mapping the
    same prefix shares the physical pages (refcounted, copy-on-write on
    any attempted write into a shared page).

Where the data lives: the pools and the armed checksums (``page_fp``,
``esum``) are tensors on the pools' device; the table, refcounts, free
list, prefix registry, stats and ``last_rearmed`` are host numpy and
Python, exactly as in the reference.  No mutation reads the device back:
a write, a free or a copy updates the checksums with device arithmetic
(a freed page's contribution is subtracted whether or not it is zero;
subtracting zeros is exact), and `verify()` brings its trip flags to the
host in one transfer.  ``page_fp[key]`` and ``esum[key]`` read as numpy
copies (test hooks).

Freed pages are zeroed on the device and their contribution removed from
the checksums, so allocation is free (a fresh page is already zero and
already consistent) and the pool's free list + live refcounts conserve
the pool exactly.

Decode parity: the dense cache `gather()` materializes differs from the
contiguous engine's only at causally-masked positions (zeros here, prefill
pad garbage there); the decode attention masks them to exactly zero
weight, so the paged engine's decode logits are bit-identical to the
contiguous engine's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.chaos.faults import flip_bit, register_surface

__all__ = ["PagedKVCache", "PagedStats"]

register_surface(
    "serve.paged_kv/pages", owner=__name__, protected=True,
    promise="tolerance",
    detector="per-(leaf, page) float64 fingerprints verified on the scrub "
             "cadence; a tripped page is rebuilt from the elementwise "
             "float64 page sum (erasure solve over the live pages)",
    kinds=("dram_kv_cache",),
    note="the page is the unified scrub + DRAM-recovery + erasure-repair "
         "unit for serving memory (PagedServeEngine); single-page fault "
         "model per leaf, like f=1 diskless.  Checksums re-arm at page "
         "granularity on every write — a single-token decode write "
         "dirties exactly one page checksum per leaf")

_F64 = torch.float64


@dataclasses.dataclass
class PagedStats:
    """Counters for the allocator + checksum machinery (test hooks)."""
    allocs: int = 0
    frees: int = 0
    cow_copies: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_insertions: int = 0
    prefix_evictions: int = 0
    checksum_rearms: int = 0      # one per (leaf, page) checksum update
    verifies: int = 0
    repairs: int = 0


class _HostView:
    """``view[key]``: a numpy copy of a device tensor of ``store``."""

    def __init__(self, store: Dict[str, torch.Tensor]):
        self._store = store

    def __getitem__(self, key: str) -> np.ndarray:
        return self._store[key].detach().cpu().numpy()


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class PagedKVCache:
    """Engine-agnostic paged pool; see module docstring.

    ``leaf_shapes`` maps a leaf key (the engine uses the reference's keystr
    paths) to ``(dense_shape, dtype)`` where dense_shape is the contiguous
    layout ``[repeats, slots, max_len, *tail]`` the leaf would occupy;
    ``dtype`` is a torch or numpy dtype.  ``device`` places the pools and
    the armed checksums.
    """

    def __init__(self, leaf_shapes: Dict[str, Tuple[Sequence[int], object]],
                 *, slots: int, max_len: int, page_size: int,
                 extra_pages: int = 0, max_prefixes: int = 16,
                 device="cpu"):
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        # +1: physical page 0 is the reserved zero page
        self.n_pages = 1 + slots * self.pages_per_slot + extra_pages
        self.max_prefixes = max_prefixes
        self.device = torch.device(device)
        self.stats = PagedStats()

        self.pools: Dict[str, torch.Tensor] = {}
        self._tails: Dict[str, Tuple[int, ...]] = {}
        for key, (shape, dtype) in leaf_shapes.items():
            shape = tuple(shape)
            if len(shape) < 3 or shape[1] != slots or shape[2] != max_len:
                raise ValueError(
                    f"leaf {key!r}: expected [repeats, {slots}, {max_len}, "
                    f"*tail], got {shape}")
            repeats, tail = shape[0], shape[3:]
            self.pools[key] = torch.zeros(
                (repeats, self.n_pages, page_size) + tail,
                dtype=_torch_dtype(dtype), device=self.device)
            self._tails[key] = tail

        # ONE table shared by every leaf: logical -> physical page ids
        self.table = np.zeros((slots, self.pages_per_slot), np.int32)
        self.refcount = np.zeros((self.n_pages,), np.int32)
        self.free: List[int] = list(range(self.n_pages - 1, 0, -1))
        # prefix registry: token-tuple -> list of physical pages (LRU);
        # the registry holds its own reference on each page
        self.prefixes: "OrderedDict[tuple, List[int]]" = OrderedDict()

        # armed checksums on the pools' device: fp (per-page float64
        # scalar) + esum (per-leaf elementwise float64 page sum)
        self._fp: Dict[str, torch.Tensor] = {
            key: torch.zeros((self.n_pages,), dtype=_F64, device=self.device)
            for key in self.pools}
        self._esum: Dict[str, torch.Tensor] = {
            key: torch.zeros((p.shape[0], page_size) + self._tails[key],
                             dtype=_F64, device=self.device)
            for key, p in self.pools.items()}
        self.page_fp = _HostView(self._fp)
        self.esum = _HostView(self._esum)
        self.last_rearmed: List[Tuple[str, int]] = []

    # -- bookkeeping helpers ---------------------------------------------------
    def page_of(self, slot: int, pos: int) -> int:
        return int(self.table[slot, pos // self.page_size])

    def live_pages(self) -> List[int]:
        return (np.flatnonzero(self.refcount[1:] > 0) + 1).tolist()

    def n_free(self) -> int:
        return len(self.free)

    def _index(self, pages: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(pages), dtype=torch.int64,
                            device=self.device)

    @staticmethod
    def _page_sums(x: torch.Tensor) -> torch.Tensor:
        """float64 sum over every axis but 1 (pages, or tokens)."""
        return x.sum(dim=tuple(i for i in range(x.dim()) if i != 1),
                     dtype=_F64)

    def _alloc(self) -> int:
        """Pop a (zeroed, checksum-consistent) free page; when the free
        list is dry, evict unshared prefix-registry entries LRU-first —
        registry references are always droppable, so a pool sized
        ``slots * pages_per_slot`` can always serve every slot."""
        while not self.free and self.prefixes:
            key, pages = self.prefixes.popitem(last=False)
            self.stats.prefix_evictions += 1
            self._deref_many(pages)
        if not self.free:
            raise RuntimeError("page pool exhausted (no free or evictable "
                               "pages) — admission control must defer")
        phys = self.free.pop()
        self.refcount[phys] = 1
        self.stats.allocs += 1
        return phys

    def _deref_many(self, pages: Sequence[int]):
        """Drop one reference on each page; the pages that reach zero are
        zeroed and their contribution subtracted from the checksums in one
        device update per leaf.  Zero-at-free keeps "free page == zero page
        contents == zero checksum contribution": allocation needs no work
        and a corrupted free page is detectable (its fingerprint must stay
        0)."""
        dead = []
        for phys in pages:
            if phys == 0:
                continue  # the zero page is immortal
            self.refcount[phys] -= 1
            if self.refcount[phys] > 0:
                continue
            dead.append(phys)
            self.free.append(phys)
            self.stats.frees += 1
        if not dead:
            return
        idx = self._index(dead)
        for key, pool in self.pools.items():
            self._esum[key] -= pool.index_select(1, idx).sum(dim=1,
                                                              dtype=_F64)
            pool.index_fill_(1, idx, 0)
            self._fp[key].index_fill_(0, idx, 0.0)

    # -- slot lifecycle --------------------------------------------------------
    def _prefix_lookup(self, prompt: Sequence[int]) -> Tuple[tuple, List[int]]:
        """Longest registered full-page prefix of ``prompt`` that leaves at
        least one suffix token to prefill; ((), []) on miss."""
        plen = len(prompt)
        for k in range((plen - 1) // self.page_size, 0, -1):
            key = tuple(prompt[:k * self.page_size])
            pages = self.prefixes.get(key)
            if pages is not None:
                self.prefixes.move_to_end(key)
                return key, pages
        return (), []

    def alloc_slot(self, slot: int, need_len: int,
                   prompt: Optional[Sequence[int]] = None) -> int:
        """Map slot ``slot`` for a sequence of up to ``need_len`` tokens:
        shared prefix pages first (when ``prompt`` is given and hits the
        registry), fresh pages for the rest.  Returns the shared prefix
        length in tokens (0 on miss) — the caller prefills ``[shared, plen)``
        only."""
        if np.any(self.table[slot]):
            raise RuntimeError(f"slot {slot} still holds pages — free it "
                               "before re-admitting")
        shared: List[int] = []
        if prompt is not None:
            _, shared = self._prefix_lookup(prompt)
            if shared:
                self.stats.prefix_hits += 1
                obs.counter("repro_prefix_hits_total",
                            "prefix-cache page-share hits").inc()
            else:
                self.stats.prefix_misses += 1
                obs.counter("repro_prefix_misses_total",
                            "prefix-cache lookup misses").inc()
        need_len = min(need_len, self.max_len)
        n_logical = -(-need_len // self.page_size)  # ceil
        for i, phys in enumerate(shared[:n_logical]):
            self.table[slot, i] = phys
            self.refcount[phys] += 1
        for i in range(len(shared[:n_logical]), n_logical):
            self.table[slot, i] = self._alloc()
        return len(shared[:n_logical]) * self.page_size

    def free_slot(self, slot: int):
        pages = [int(p) for p in self.table[slot] if p]
        self.table[slot] = 0
        self._deref_many(pages)

    def register_prefix(self, slot: int, prompt: Sequence[int]):
        """After a slot's prompt is fully prefilled, publish its full pages
        under the token prefix (LRU, capped at ``max_prefixes``)."""
        k = (len(prompt) - 1) // self.page_size
        if k <= 0:
            return
        key = tuple(prompt[:k * self.page_size])
        if key in self.prefixes:
            self.prefixes.move_to_end(key)
            return
        pages = [int(self.table[slot, i]) for i in range(k)]
        if any(p == 0 for p in pages):
            return  # slot not actually filled that far
        for p in pages:
            self.refcount[p] += 1
        self.prefixes[key] = pages
        self.stats.prefix_insertions += 1
        while len(self.prefixes) > self.max_prefixes:
            _, old = self.prefixes.popitem(last=False)
            self.stats.prefix_evictions += 1
            self._deref_many(old)

    # -- writes (checksum-on-write, page granular) -----------------------------
    def _writable(self, slot: int, logical: int) -> int:
        """Physical page for a write: allocate on demand, copy-on-write when
        the mapped page is shared (prefix sharing never writes into shared
        pages in normal operation, but the write path stays safe)."""
        phys = int(self.table[slot, logical])
        if phys == 0:
            phys = self._alloc()
            self.table[slot, logical] = phys
            return phys
        if self.refcount[phys] > 1:
            new = self._alloc()
            for key, pool in self.pools.items():
                page = pool[:, phys]
                pool[:, new] = page
                self._esum[key] += page.to(_F64)
                self._fp[key][new] = page.sum(dtype=_F64)
                self.last_rearmed.append((key, new))
                self.stats.checksum_rearms += 1
            self.table[slot, logical] = new
            self._deref_many([phys])
            self.stats.cow_copies += 1
            return new
        return phys

    def _put(self, key: str, phys: Sequence[int], offs: Sequence[int],
             vals: torch.Tensor):
        """Write token ``i`` of ``vals`` ``[repeats, n, *tail]`` at offset
        ``offs[i]`` of page ``phys[i]`` (distinct cells) and move both
        checksums by ``new - old``: one indexed write and one update of
        each checksum for the whole batch."""
        pool = self.pools[key]
        ip, io = self._index(phys), self._index(offs)
        new = vals.to(device=pool.device, dtype=pool.dtype)
        old = pool[:, ip, io]
        pool[:, ip, io] = new
        delta = new.to(_F64) - old.to(_F64)
        self._fp[key].index_add_(0, ip, self._page_sums(delta))
        self._esum[key].index_add_(1, io, delta)

    def write(self, key: str, slot: int, start: int, vals):
        """Write ``vals`` ``[repeats, n, *tail]`` at positions
        ``[start, start + n)`` of ``slot``, re-arming exactly the touched
        pages' checksums.  The update is incremental and O(segment):
        ``+= new - old`` (``old`` is zero on the engine's write-once path —
        cells stay zero between free/zero cycles — but a copy-on-write
        overwrite of copied prefix content stays consistent too)."""
        vals = torch.as_tensor(vals)
        n = vals.shape[1]
        ps = self.page_size
        phys, offs = [], []
        pos = start
        while pos < start + n:
            logical, off = pos // ps, pos % ps
            seg_n = min(ps - off, start + n - pos)
            p = self._writable(slot, logical)
            phys += [p] * seg_n
            offs += range(off, off + seg_n)
            self.last_rearmed.append((key, p))
            self.stats.checksum_rearms += 1
            pos += seg_n
        if n:
            self._put(key, phys, offs, vals)

    def write_token(self, key: str, slot: int, pos: int, val):
        """One decode token: ``val`` ``[repeats, *tail]`` at ``pos``."""
        self.write(key, slot, pos, torch.as_tensor(val)[:, None])

    def write_tokens(self, key: str, slots: Sequence[int],
                     positions: Sequence[int], vals):
        """One decode token per slot in one device update: ``vals[:, i]``
        (``[repeats, len(slots), *tail]``) at ``positions[i]`` of
        ``slots[i]``; the same pages and re-arms as `write_token` slot by
        slot."""
        ps = self.page_size
        phys = []
        for s, p in zip(slots, positions):
            phys.append(self._writable(s, p // ps))
            self.last_rearmed.append((key, phys[-1]))
            self.stats.checksum_rearms += 1
        if phys:
            self._put(key, phys, [p % ps for p in positions],
                      torch.as_tensor(vals))

    def begin_mutation(self):
        """Reset the per-mutation re-arm ledger (test hook: asserts a
        single-page write dirties exactly one checksum per leaf)."""
        self.last_rearmed = []

    # -- reads -----------------------------------------------------------------
    def gather(self, key: str, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Dense ``[repeats, slots, max_len, *tail]`` view of every slot
        (zero beyond each write head — the zero page), written into
        ``out`` when given."""
        pool = self.pools[key]
        flat = self._index(self.table.reshape(-1).tolist())
        r, tail = pool.shape[0], tuple(pool.shape[3:])
        if out is None:
            dense = pool.index_select(1, flat)
        else:
            dense = torch.index_select(
                pool, 1, flat,
                out=out.view((r, flat.numel(), self.page_size) + tail))
        return dense.view((r, self.slots, self.max_len) + tail)

    def gather_slot(self, key: str, slot: int) -> torch.Tensor:
        pool = self.pools[key]
        flat = self._index(self.table[slot].tolist())
        dense = pool.index_select(1, flat)
        r, tail = pool.shape[0], tuple(pool.shape[3:])
        return dense.view((r, 1, self.max_len) + tail)

    # -- verify / repair (the scrub + DRAM-recovery unit) ----------------------
    def arm_all(self):
        """Full recompute of every checksum from the pools (init/reset)."""
        for key, pool in self.pools.items():
            self._fp[key] = self._page_sums(pool)
            self._esum[key] = pool.sum(dim=1, dtype=_F64)

    def trip_flags(self) -> torch.Tensor:
        """``[leaves, n_pages]`` bool on the device: a page trips where
        its recomputed fingerprint moved by more than 1e-6 of the leaf's
        largest armed fingerprint (+1); NaN counts as tripped; page 0 is
        immutable-zero by construction and never reported.  Every other
        page is checked — a corrupted FREE page (fingerprint must be 0)
        trips too, protecting zero-at-free."""
        flags = []
        for key, pool in self.pools.items():
            armed = self._fp[key]
            diff = (self._page_sums(pool) - armed).abs()
            # ~(d <= thr) is True for NaN as well
            flags.append(~(diff <= 1e-6 * (armed.abs().max() + 1.0)))
        if not flags:
            return torch.zeros((0, self.n_pages), dtype=torch.bool,
                               device=self.device)
        out = torch.stack(flags)
        out[:, 0] = False
        return out

    def tripped(self, flags) -> List[Tuple[str, int]]:
        """The (leaf, page) pairs of host ``trip_flags()`` output."""
        flags = np.asarray(flags).reshape(len(self.pools), self.n_pages)
        return [(key, int(p)) for key, row in zip(self.pools, flags)
                for p in np.flatnonzero(row)]

    def verify(self) -> List[Tuple[str, int]]:
        """Recompute page fingerprints; returns tripped (leaf, page) pairs
        (the flags come to the host in one transfer)."""
        self.stats.verifies += 1
        return self.tripped(self.trip_flags().cpu().numpy())

    def repair(self, key: str, phys: int) -> bool:
        """Erasure solve: rebuild page ``phys`` of leaf ``key`` as
        ``esum - sum(other live pages)`` in float64 (a corrupted free page
        rebuilds to zero: it contributes nothing to esum)."""
        pool = self.pools[key]
        others = [p for p in self.live_pages() if p != phys]
        recon = self._esum[key].clone()
        if others:
            recon -= pool.index_select(1, self._index(others)).sum(
                dim=1, dtype=_F64)
        pool[:, phys] = recon.to(pool.dtype)
        self._fp[key][phys] = recon.sum()
        self.last_rearmed.append((key, phys))
        self.stats.checksum_rearms += 1
        self.stats.repairs += 1
        obs.counter("repro_page_repairs_total",
                    "paged-KV erasure page rebuilds").inc()
        return True

    def scrub(self) -> List[Tuple[str, int]]:
        """verify + repair; returns the repaired (leaf, page) pairs."""
        repaired = []
        for key, phys in self.verify():
            if self.repair(key, phys):
                repaired.append((key, phys))
        return repaired

    # -- drills ----------------------------------------------------------------
    def corrupt_page(self, key: str, phys: int, index: int = 0,
                     bit: int = 30):
        """Fault-injection helper: flip one bit of page ``phys`` (float32
        pools; other dtypes get an additive 1e4 delta at ``index``)."""
        pool = self.pools[key]
        page = pool[:, phys]
        if page.dtype == torch.float32:
            page = flip_bit(page, index, bit)
        else:
            page = page.clone()
            page.view(-1)[index] += 1e4
        pool[:, phys] = page

    # -- invariants (property-test hooks) --------------------------------------
    def check_invariants(self):
        """Raises AssertionError on any broken pool invariant:
        conservation (free + live partition the pool exactly), refcount
        accounting (table refs + registry refs), no page shared by two
        slots unless it is a registry (prefix) page, zero-page integrity."""
        live = set(self.live_pages())
        free = set(self.free)
        assert not (live & free), f"pages both live and free: {live & free}"
        assert live | free == set(range(1, self.n_pages)), (
            "conservation broken: free + live must partition the pool "
            f"(missing {set(range(1, self.n_pages)) - live - free})")
        refs = np.zeros((self.n_pages,), np.int64)
        for phys in self.table.reshape(-1):
            if phys:
                refs[phys] += 1
        registry_pages = set()
        for pages in self.prefixes.values():
            for p in pages:
                refs[p] += 1
                registry_pages.add(p)
        assert np.array_equal(refs[1:], self.refcount[1:]), (
            f"refcount mismatch: counted {refs[1:].tolist()} "
            f"vs tracked {self.refcount[1:].tolist()}")
        owners: Dict[int, set] = {}
        for s in range(self.slots):
            for phys in self.table[s]:
                if phys:
                    owners.setdefault(int(phys), set()).add(s)
        for phys, ss in owners.items():
            assert len(ss) == 1 or phys in registry_pages, (
                f"page {phys} referenced by slots {sorted(ss)} without a "
                "prefix-registry entry (non-prefix sharing)")
        free_idx = self._index(sorted(free))
        for key, pool in self.pools.items():
            assert not bool(pool[:, 0].any()), \
                f"zero page of {key!r} was written"
            nonzero = pool.index_select(1, free_idx).flatten(2).any(dim=2) \
                .any(dim=0)
            bad = [p for p, nz in zip(sorted(free), nonzero.tolist()) if nz]
            assert not bad, f"free pages {bad} of {key!r} are not zero"

    def checksums_consistent(self, rtol: float = 1e-6) -> bool:
        """True when every armed checksum matches a recompute (every page
        re-armed after each mutation — the property tests' postcondition)."""
        if self.verify():
            return False
        for key, pool in self.pools.items():
            if not torch.allclose(pool.sum(dim=1, dtype=_F64),
                                  self._esum[key], rtol=rtol, atol=1e-8):
                return False
        return True
