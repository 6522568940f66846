"""The one traffic generator: every mix is a JSON file of parameters that
these functions read.

Every seed gets the same work in another order, so that two seeds differ by
the order of the work and not by its amount: each block of products holds
the same faults, and the seed decides their order, the step at which each
comes and where.  What a mix may set (``"loop": "products"``):

  faults        {kind: weight} over none, kill, kill2, flip: each block of
                sum(weights) products holds each kind that many times, in
                an order drawn from the seed
  flip_exp_min, flip_exp_max   a flip adds 10^e, e uniform in the range
  operand_pool  operand pairs made in set-up, used in turn
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Fault", "product_faults", "rng"]


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A generator from the run's seed (any size) and a salt."""
    return np.random.default_rng([abs(int(seed)) % 2 ** 64, *salt])


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str                                 # none | kill | kill2 | flip
    step: int = 0
    where: Tuple[Tuple[int, int], ...] = ()   # (row, col) of each process
    delta: float = 0.0


_KINDS = ("none", "kill", "kill2", "flip")


def product_faults(mix: dict, grid: int, f: int, seed: int):
    """``fault(i)``: what product i of a run faces.  A kill erases one
    process of the grid; kill2 two, on distinct rows and columns (what f = 1
    recovers); a flip adds to one element of a data block's partial sum.
    Each at a SUMMA step drawn from the seed, as launch/stress.py draws
    them."""
    weights = mix.get("faults", {"none": 1})
    bad = set(weights) - set(_KINDS)
    if bad:
        raise ValueError(f"unknown fault kinds {sorted(bad)}")
    block = [k for k in _KINDS for _ in range(int(weights.get(k, 0)))]
    lo, hi = mix.get("flip_exp_min", 2), mix.get("flip_exp_max", 5)

    def fault(i: int) -> Optional[Fault]:
        kind = rng(seed, 2, i // len(block)).permutation(block)[
            i % len(block)]
        r = rng(seed, 3, i)
        step = int(r.integers(0, grid))
        if kind == "kill":
            return Fault("kill", step, ((int(r.integers(0, grid)),
                                         int(r.integers(0, grid))),))
        if kind == "kill2":
            rows = r.choice(grid, 2, replace=False)
            cols = r.choice(grid, 2, replace=False)
            return Fault("kill2", step, ((int(rows[0]), int(cols[0])),
                                         (int(rows[1]), int(cols[1]))))
        if kind == "flip":
            pr = grid - f
            return Fault("flip", step, ((int(r.integers(0, pr)),
                                         int(r.integers(0, pr))),),
                         float(10 ** int(r.integers(lo, hi + 1))))
        return Fault("none")

    return fault
