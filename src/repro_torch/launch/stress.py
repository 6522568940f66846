"""The paper's §4.3 stress test: a loop of encode -> multiply -> random kill
-> residual check, on the ABFT SUMMA of ``core.summa``.

"During the execution, a process killer is activated.  This process killer
kills randomly in time and in the location any process in the application.
Our application has successfully returned from tens of such failures."

Each iteration the killer strikes a random process of the grid at a random
SUMMA step (sometimes two at once, sometimes a bit-flip instead), and every
result must pass the paper's residual check
||Cx - A(Bx)|| / (n eps ||C||_F ||x||) < 100.  A, B and the events are drawn
from ``np.random.RandomState(0)`` in the order of the reference package's
``examples/abft_stress.py``, so iteration i faces the same kill or flip
there and here.  It runs on the GPU unless ``--device cpu`` is given; with
no GPU it raises rather than falling back.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stress --grid 4 --block 512 \
      --iters 8
  PYTHONPATH=src python -m repro_torch.launch.stress --device cpu --iters 3
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.core as core
from repro_torch.launch.serve import resolve_device

THRESHOLD = 100.0


def residual_check(c, a, b, x) -> float:
    """||Cx - A(Bx)|| / (n eps ||C||_F ||x||), n = rows of C."""
    n = c.shape[0]
    eps = np.finfo(np.float32).eps
    lhs = torch.linalg.norm(c @ x - a @ (b @ x))
    scale = n * eps * torch.linalg.norm(c) * torch.linalg.norm(x)
    return float(lhs / scale)


def run(*, grid: int = 4, block: int = 32, iters: int = 20,
        device: str = "cuda", local_update: str = "auto",
        verbose: bool = True) -> dict:
    """The stress loop; returns counts and every iteration's residual.
    Raises AssertionError on the first residual at or over THRESHOLD."""
    dev = resolve_device(device)
    g, nb = grid, block
    pr = g - 1
    n = pr * nb
    spec = core.make_spec(1, pr, pr, device=dev)
    rs = np.random.RandomState(0)

    def draw(shape):
        return torch.from_numpy(rs.standard_normal(shape)).float().to(dev)

    failures = flips = 0
    residuals = []
    for it in range(iters):
        # fresh data each loop (paper: initialize, checkpoint, multiply, check)
        a = draw((n, g * nb))
        b = draw((g * nb, n))
        a_enc, b_enc = core.encode_operands(a, b, spec)

        # the process killer: random in time and location — occasionally it
        # takes out SEVERAL processes in the same instant
        kind = rs.randint(4)
        failure = bitflip = None
        if kind == 0:
            failure = core.FailureEvent(step=int(rs.randint(0, g)),
                                        row=int(rs.randint(0, g)),
                                        col=int(rs.randint(0, g)))
            failures += 1
        elif kind == 1:
            # two simultaneous losses on distinct rows+cols (f=1 capacity)
            r1, r2 = rs.choice(g, 2, replace=False)
            c1, c2 = rs.choice(g, 2, replace=False)
            failure = core.MultiFailureEvent(
                step=int(rs.randint(0, g)),
                devices=((int(r1), int(c1)), (int(r2), int(c2))))
            failure.check(1)
            failures += 2
        elif kind == 2:
            bitflip = core.BitflipEvent(step=int(rs.randint(0, g)),
                                        row=int(rs.randint(0, pr)),
                                        col=int(rs.randint(0, pr)),
                                        delta=float(10 ** rs.randint(2, 6)))
            flips += 1
        c_enc = core.abft_summa(a_enc, b_enc, g, spec=spec, failure=failure,
                                bitflip=bitflip, local_update=local_update)
        if bitflip is not None:
            c_enc, _, _ = core.locate_and_correct(c_enc, spec)
        c = core.strip(c_enc, nb, nb)
        x = draw((n,))
        r = residual_check(c, a, b, x)
        residuals.append(r)
        status = "kill" if failure else ("flip" if bitflip else "clean")
        assert r < THRESHOLD, f"iteration {it} failed residual check: {r}"
        if verbose:
            print(f"iter {it:3d} [{status:5s}] residual = {r:8.3f}  OK",
                  flush=True)
    if verbose:
        print(f"\nsurvived {failures} process kills and {flips} bit-flips; "
              f"all {iters} residual checks passed on {dev}")
    return dict(failures=failures, flips=flips, residuals=residuals,
                device=str(dev))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--grid", type=int, default=4)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local-update", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="rank-kb update (auto = the CUDA kernel on the GPU)")
    args = ap.parse_args(argv)
    run(grid=args.grid, block=args.block, iters=args.iters,
        device=args.device, local_update=args.local_update)


if __name__ == "__main__":
    main()
