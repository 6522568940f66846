"""Plain matrix product: the benchmark's reference for the fault-tolerant
SUMMA.

The operands come from ``make_operands`` (the harness hands the same to the
program); the product is taken in float64 and compared with what the
program returned, row block by row block, so that it fits beside the kept
products.  ``lowp="tf32"`` is the control: operands rounded to TF32 and an
exact float32 product, the precision one TF32 tensor-core pass has.

Imports nothing of the program.
"""
from __future__ import annotations

import torch

__all__ = ["make_operands", "product", "max_rel_err", "tf32_round"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits (to nearest, ties away from
    zero, as the tensor cores' conversion does)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@torch.no_grad()
def make_operands(m: int, k: int, n: int, count: int, seed: int, device):
    """``count`` pairs (A [m, k], B [k, n]) of N(0, 1) float32 from
    ``seed``, drawn on ``device`` in one generator call each."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn((m, k), generator=gen, device=device),
             torch.randn((k, n), generator=gen, device=device))
            for _ in range(count)]


@torch.no_grad()
def product(a: torch.Tensor, b: torch.Tensor, lowp=None) -> torch.Tensor:
    """A @ B: float64 for the reference, or the control in float32."""
    if lowp == "tf32":
        return tf32_round(a) @ tf32_round(b)
    if lowp is not None:
        raise ValueError(f"unknown lowp {lowp!r}")
    return a.double() @ b.double()


@torch.no_grad()
def max_rel_err(got: torch.Tensor, ref: torch.Tensor,
                rows: int = 2048) -> float:
    """max |got - ref| / max |ref|, in float64, a block of rows at a time.
    A shape that differs, or a value that is not finite, reads inf."""
    if tuple(got.shape) != tuple(ref.shape):
        return float("inf")
    worst = 0.0
    for r0 in range(0, ref.shape[0], rows):
        d = float((got[r0:r0 + rows].double()
                   - ref[r0:r0 + rows]).abs().max())
        if not d < float("inf"):          # inf or nan
            return float("inf")
        worst = max(worst, d)
    scale = float(ref.abs().max())
    return worst / scale if scale > 0 else worst
