"""GF(2^8) Reed-Solomon erasure coding — the paper's bit-exact alternative.

§2.1: "Checksums are traditionally performed in Galois Field arithmetic ...
Galois Field always guarantees bit-by-bit accuracy."  §4.1: "an option is to
perform Galois Field encoding (although this rules out ABFT)."

The raw bytes of the shards are encoded with a Cauchy matrix over GF(256)
(log/antilog tables, generator 2, modulus 0x11D); any f erased shards are
recovered bit-exactly by solving the f x f system in the field.  Unlike the
floating-point encoding it commutes with nothing, so no on-the-fly ABFT:
the trade-off the paper states.

The counterpart of the reference package's ``repro/core/galois.py``, on
tensors.  The byte work runs on the shards' device: a product by the
constant ``c`` is a gather through row ``c`` of a 256 x 256 product table
built there from the log/antilog tables, with int32 indices over chunks of
the bytes, and the sums are XORs.  The Cauchy matrix and the f x f solve
are small tables on the host.  Field arithmetic is exact, so the bytes equal
the reference's whatever the order of the operations.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["gf_encode", "gf_recover", "cauchy_matrix", "GF"]

# bytes per gather: bounds the int32 index temporary at 256 MB
_CHUNK = 1 << 26


class _GF256:
    """GF(2^8) arithmetic with log/antilog tables (modulus
    x^8+x^4+x^3+x^2+1)."""

    def __init__(self, modulus: int = 0x11D):
        exp = np.zeros(512, np.uint8)
        log = np.zeros(256, np.int64)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= modulus
        exp[255:510] = exp[:255]  # wraparound for sum-of-logs
        self.exp = torch.from_numpy(exp)
        self.log = torch.from_numpy(log)
        self._products: Dict[torch.device, torch.Tensor] = {}

    def products(self, device) -> torch.Tensor:
        """The [256, 256] uint8 product table on ``device`` (built there
        from the log/antilog tables once)."""
        device = torch.device(device)
        t = self._products.get(device)
        if t is None:
            exp, log = self.exp.to(device), self.log.to(device)
            t = exp[(log[:, None] + log[None, :]) % 255]
            t[0, :] = 0
            t[:, 0] = 0
            self._products[device] = t
        return t

    def mul(self, a, b) -> torch.Tensor:
        """Elementwise product of two byte tensors (broadcasting)."""
        a = torch.as_tensor(a, dtype=torch.uint8)
        b = torch.as_tensor(b, dtype=torch.uint8, device=a.device)
        return self.products(a.device)[a.long(), b.long()]

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("GF(256) inverse of 0")
        return int(self.exp[255 - int(self.log[a])])

    def matvec(self, m: torch.Tensor, rows: Sequence[torch.Tensor]
               ) -> torch.Tensor:
        """[f, p] host coefficients x p rows of n bytes -> [f, n] over
        GF(256) (xor-accumulate), on the rows' device."""
        n = rows[0].numel()
        dev = rows[0].device
        table = self.products(dev)
        coef = m.tolist()
        out = torch.zeros((len(coef), n), dtype=torch.uint8, device=dev)
        for s in range(0, n, _CHUNK):
            e = min(n, s + _CHUNK)
            for i, row in enumerate(rows):
                idx = row[s:e].to(torch.int32)
                for j, cj in enumerate(coef):
                    if cj[i]:
                        out[j, s:e] ^= torch.index_select(table[cj[i]], 0,
                                                          idx)
        return out

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[r, t] x [t, c] small host tables over GF(256)."""
        prod = self.mul(a[:, :, None], b[None, :, :])
        out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.uint8)
        for t in range(a.shape[1]):
            out ^= prod[:, t]
        return out

    def solve(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Gaussian elimination over GF(256) on small host tables:
        a [n, n], b [n, m] -> x [n, m]."""
        n = a.shape[0]
        a = torch.as_tensor(a, dtype=torch.uint8).clone()
        b = torch.as_tensor(b, dtype=torch.uint8).clone()
        for col in range(n):
            piv = next((r for r in range(col, n) if a[r, col]), None)
            if piv is None:
                raise np.linalg.LinAlgError("singular GF(256) system")
            if piv != col:
                a[[col, piv]] = a[[piv, col]]
                b[[col, piv]] = b[[piv, col]]
            inv = self.inv(int(a[col, col]))
            a[col] = self.mul(a[col], inv)
            b[col] = self.mul(b[col], inv)
            for r in range(n):
                if r != col and a[r, col]:
                    f = int(a[r, col])
                    a[r] ^= self.mul(f, a[col])
                    b[r] ^= self.mul(f, b[col])
        return b


GF = _GF256()


def cauchy_matrix(f: int, p: int) -> torch.Tensor:
    """Cauchy matrix over GF(256) as a host uint8 table: every square
    submatrix nonsingular, the field-exact analogue of the paper's 'any
    f x f submatrix nonsingular'."""
    if f + p > 256:
        raise ValueError("GF(256) Cauchy supports f + p <= 256 shards")
    m = torch.zeros((f, p), dtype=torch.uint8)
    for j in range(f):                     # rows 0..f-1
        for i in range(p):                 # cols f..f+p-1, disjoint
            m[j, i] = GF.inv(j ^ (f + i))
    return m


def _as_bytes(shards: torch.Tensor) -> torch.Tensor:
    p = shards.shape[0]
    return shards.contiguous().view(torch.uint8).reshape(p, -1)


def _from_bytes(data: torch.Tensor, dtype, shape) -> torch.Tensor:
    return data.view(dtype).reshape(shape)


def gf_encode(shards: torch.Tensor, f: int) -> torch.Tensor:
    """Encode [p, ...] shards -> [f, ...] checksum shards (bit-exact)."""
    p = shards.shape[0]
    data = _as_bytes(shards)
    enc = GF.matvec(cauchy_matrix(f, p), list(data))
    return _from_bytes(enc, shards.dtype, (f,) + tuple(shards.shape[1:]))


def gf_recover(shards: torch.Tensor, checksums: torch.Tensor,
               failed: Sequence[int]) -> torch.Tensor:
    """Rebuild ``failed`` shard indices bit-exactly from GF(256) checksums.

    With k = len(failed) and S = m[:k, failed] the k x k Cauchy minor, the
    lost rows are S^-1 (y[:k] + m[:k, ok] x_ok): one host product gives the
    coefficients of y[:k] and of each surviving row, and one pass over the
    bytes applies them."""
    failed: List[int] = list(failed)
    p = shards.shape[0]
    f = checksums.shape[0]
    if len(failed) > f:
        raise ValueError(f"{len(failed)} failures > capacity f={f}")
    data = _as_bytes(shards)
    out = data.clone()
    if failed:
        k = len(failed)
        m = cauchy_matrix(f, p)
        ok = [i for i in range(p) if i not in failed]
        s_inv = GF.solve(m[:k][:, failed], torch.eye(k, dtype=torch.uint8))
        coef = torch.cat([GF.matmul(s_inv, m[:k][:, ok]), s_inv], dim=1)
        enc = _as_bytes(checksums)
        solved = GF.matvec(coef, [data[i] for i in ok] + list(enc[:k]))
        out[failed] = solved
    return _from_bytes(out, shards.dtype, shards.shape)
