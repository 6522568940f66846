"""The fault-tolerant SUMMA product as a user runs it (paper §2.2-§3):
encode the operands, multiply on the stacked process grid through kernel
#2 with any process loss or bit-flip the mix sends, check the encoded
product (locate and correct a flipped element), strip the checksums.

One product is timed from ``encode_operands`` to the stripped, checked C on
the host's clock with the device synchronized.  The window runs products
back to back, each on the next operand pair of a pool made in set-up, and
closes after the product that ends past ``--seconds``.  A sample of the
window's products, drawn from the seed and stratified by the fault each
faced, is kept and compared, once the window has closed, with the float64
product of the same operands.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.harness.trace import Phases
from portbench.harness.traffic import Fault, product_faults
from portbench.reference import gemm as ref

KEEP = 4          # products a run keeps for the comparison


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 log, control: bool = False):
        self.control = control
        if mix.get("loop") != "products":
            raise ValueError("ft_summa runs a products mix")
        self.c, self.mix, self.seed, self.dev, self.log = (config, mix, seed,
                                                           device, log)
        g, f, nb = config["grid"], config["f"], config["block"]
        self.g, self.f, self.nb = g, f, nb
        self.m = self.n = (g - f) * nb
        self.k = g * nb
        self.fault = product_faults(mix, g, f, seed)
        # the kept products, KEEP // (fault kinds) of each kind the mix
        # sends: kind -> [(product index, pool index, C)]
        kinds = sorted(k for k, w in mix.get("faults", {"none": 1}).items()
                       if w)
        self.slots = max(1, KEEP // len(kinds))
        self.kept = {k: [] for k in kinds}

    # -- set-up --
    def setup(self):
        t0 = time.perf_counter()
        import repro_torch.core as core
        self.core = core
        self.spec = core.make_spec(self.f, self.g - self.f, self.g - self.f,
                                   device=self.dev)
        self._sync()
        t1 = time.perf_counter()
        self.pool = ref.make_operands(self.m, self.k, self.n,
                                      self.mix.get("operand_pool", 2),
                                      self.seed, self.dev)
        self._sync()
        t2 = time.perf_counter()
        # every path the mix takes, once: a clean product, and where the mix
        # faults, a double loss and a flip in one product
        self._product(0, None, Phases())
        if set(self.kept) - {"none"}:
            self._product(0, Fault("kill2", 1, ((0, 1), (2, 3))), Phases())
            self._product(0, Fault("flip", 1, ((1, 0),), 1e3), Phases())
        self._sync()
        self.log(f"set-up parts: import and context {t1 - t0:.3f} s, "
                 f"operands {t2 - t1:.3f} s, "
                 f"warm-up {time.perf_counter() - t2:.3f} s")

    def _sync(self):
        if self.dev == "cuda":
            torch.cuda.synchronize()

    def _product(self, i: int, fault, span):
        core = self.core
        a, b = self.pool[i % len(self.pool)]
        if self.control:
            # the reference, one precision down, in the program's place
            return ref.product(a, b, lowp="tf32")
        failure = bitflip = None
        if fault is not None and fault.kind in ("kill", "kill2"):
            if len(fault.where) == 1:
                (r, c), = fault.where
                failure = core.FailureEvent(step=fault.step, row=r, col=c)
            else:
                failure = core.MultiFailureEvent(step=fault.step,
                                                 devices=fault.where)
        elif fault is not None and fault.kind == "flip":
            (r, c), = fault.where
            bitflip = core.BitflipEvent(step=fault.step, row=r, col=c,
                                        delta=fault.delta)
        with span("encode_operands"):
            a_enc, b_enc = core.encode_operands(a, b, self.spec)
        with span("abft_summa"):
            c_enc = core.abft_summa(a_enc, b_enc, self.g, spec=self.spec,
                                    failure=failure, bitflip=bitflip,
                                    local_update="auto")
        del a_enc, b_enc
        with span("locate_and_correct"):
            c_enc, _, _ = core.locate_and_correct(c_enc, self.spec)
        return core.strip(c_enc, self.f * self.nb, self.f * self.nb)

    # -- the window --
    def window(self, seconds: float, phases) -> dict:
        pick = random.Random(self.seed)
        times, kinds, seen = [], [], {}
        self._sync()
        t_start = time.perf_counter()
        t = t_start
        i = 0
        while t - t_start < seconds:
            fault = self.fault(i)
            t0 = time.perf_counter()
            c = self._product(i, fault, phases)
            with phases("synchronize"):
                self._sync()
            t = time.perf_counter()
            times.append(t - t0)
            kinds.append(fault.kind)
            # a uniform sample of each fault kind's products (reservoir)
            seen[fault.kind] = seen.get(fault.kind, 0) + 1
            kept = self.kept[fault.kind]
            if len(kept) < self.slots:
                kept.append((i, i % len(self.pool), c))
            else:
                j = pick.randrange(seen[fault.kind])
                if j < self.slots:
                    kept[j] = (i, i % len(self.pool), c)
            del c
            i += 1
        return dict(kind="products", window_s=t - t_start, t_start=t_start,
                    t_end=t, product_s=times, faults=kinds,
                    data_flops=2.0 * self.m * self.n * self.k,
                    grid=self.g, f=self.f, block=self.nb,
                    attempted=i, failed=0)

    def release(self):
        """Free the program's state; the kept products stay."""
        self.pool = None
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison --
    def check(self) -> list:
        """[(name, value, limit)]: the worst relative error of a kept
        product against the float64 product of its operands."""
        worst = 0.0
        kept = [(kind, *x) for kind, xs in self.kept.items() for x in xs]
        pools = sorted({p for _, _, p, _ in kept})
        ops = ref.make_operands(self.m, self.k, self.n, max(pools) + 1,
                                self.seed, self.dev)
        for p in pools:
            want = ref.product(*ops[p])
            for kind, i, q, c in kept:
                if q == p:
                    err = ref.max_rel_err(c, want)
                    self.log(f"product {i} ({kind}, operands {p}): max rel "
                             f"err {err:.6g}")
                    worst = max(worst, err)
            del want
        return [("max_rel_err", worst, self.c["limits"]["max_rel_err"])]

