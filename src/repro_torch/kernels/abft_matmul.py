"""Fused dual-checksum ABFT matmul: the Hopper CUDA kernel, its wrapper and
its plain PyTorch version.

``abft_matmul_cuda`` computes the one-shot ``C = A @ B`` together with the
per-tile partials of both Huang-Abraham checksum directions, taken of the
ROUNDED stored tile:

  * ``ccol [ceil(m/bm), f, n]``: ``ccol[i] = W_m[:, tile_i] @ C[tile_i, :]``
  * ``crow [ceil(n/bn), m, f]``: ``crow[j] = C[:, tile_j] @ W_n[tile_j, :]``

Summing either over axis 0 gives the full ``W_m @ C`` and ``C @ W_n``.  For
shapes that divide the tile this is the layout of the reference kernel
``repro/kernels/abft_matmul.py::abft_matmul_pallas``; ragged edges are
masked in the kernel rather than zero-padded in memory, which gives the
same numbers (zero rows and columns checksum to zero).

The kernel lives in ``csrc/abft_matmul.cu`` (see its header for what bounds
it and what the simple design leaves out).  On a CUDA tensor the wrapper
launches it or raises; on a CPU tensor, and only there, it runs
``abft_matmul_plain``, the same function in plain PyTorch.  ``launches``
counts kernel launches and ``plain_calls`` counts plain-version calls.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["abft_matmul_cuda", "abft_matmul_plain", "reset_counts",
           "TILES_M", "TILES_N", "KT", "F_MAX"]

TILES_M = (16, 32, 64, 128)      # CTA tile rows the kernel is built for
TILES_N = (32, 64, 128)          # CTA tile columns the kernel is built for
KT = 16                          # k columns staged per shared-memory slab
F_MAX = 4                        # most checksum rows per direction

_IN_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

launches = 0                     # kernel launches by abft_matmul_cuda
plain_calls = 0                  # calls of abft_matmul_plain


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _check(a, b, wm, wn, bm, bn, bk, out_dtype):
    """Validate one call; returns the resolved output dtype."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    f = wm.shape[0]
    if k != k2:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if tuple(wm.shape) != (f, m) or tuple(wn.shape) != (n, f):
        raise ValueError(f"wm {tuple(wm.shape)} / wn {tuple(wn.shape)} do "
                         f"not match ({f}, {m}) / ({n}, {f})")
    if not 1 <= f <= F_MAX:
        raise ValueError(f"f={f} checksum rows: the kernel takes 1..{F_MAX}")
    if a.dtype != b.dtype or a.dtype not in _IN_KIND:
        raise TypeError(f"operands must share a dtype in fp32/bf16/int8, got "
                        f"{a.dtype} and {b.dtype}")
    if wm.dtype != torch.float32 or wn.dtype != torch.float32:
        raise TypeError("checksum weights must be fp32")
    integer = a.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.int32 if integer else a.dtype
    if integer != (out_dtype == torch.int32) or out_dtype not in _OUT_KIND:
        raise TypeError(f"{a.dtype} operands cannot produce {out_dtype}: int8 "
                        "accumulates into int32, fp32/bf16 into fp32 or bf16")
    if bm not in TILES_M or bn not in TILES_N:
        raise ValueError(f"tile ({bm}, {bn}) not built: bm in {TILES_M}, "
                         f"bn in {TILES_N}")
    if bk % KT:
        raise ValueError(f"bk={bk} must be a multiple of {KT}")
    return out_dtype


def abft_matmul_plain(a, b, wm, wn, *, bm: int = 128, bn: int = 128,
                      bk: int = KT, out_dtype=None):
    """Plain PyTorch version of the kernel: same arguments, same outputs.

    fp32 and bf16 operands multiply in fp32; int8 operands multiply
    exactly (float64 holds every int8 dot product of any served width) and
    land in int32.  The partials are reduced from the rounded output.
    """
    global plain_calls
    out_dtype = _check(a, b, wm, wn, bm, bn, bk, out_dtype)
    plain_calls += 1
    m, n, f = a.shape[0], b.shape[1], wm.shape[0]
    mt, nt = _cdiv(m, bm), _cdiv(n, bn)
    pm, pn = mt * bm, nt * bn
    if a.dtype == torch.int8:
        c = torch.matmul(a.double(), b.double()).to(torch.int32)
    else:
        c = torch.matmul(a.float(), b.float()).to(out_dtype)
    rounded = F.pad(c.float(), (0, pn - n, 0, pm - m))
    wm_p = F.pad(wm, (0, pm - m))
    wn_p = F.pad(wn, (0, 0, 0, pn - n))
    ccol = torch.einsum("fib,ibn->ifn", wm_p.reshape(f, mt, bm),
                        rounded.reshape(mt, bm, pn))[..., :n]
    crow = torch.einsum("mjb,jbf->jmf", rounded.reshape(pm, nt, bn),
                        wn_p.reshape(nt, bn, f))[:, :m]
    return c, ccol.contiguous(), crow.contiguous()


_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        fn = build.load("abft_matmul").abft_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def abft_matmul_cuda(a, b, wm, wn, *, bm: int = 128, bn: int = 128,
                     bk: int = KT, out_dtype=None):
    """One-shot C = A @ B with fused dual checksum partials.

    a: [m, k], b: [k, n] (fp32, bf16 or int8); wm: [f, m], wn: [n, f] fp32.
    Returns (c [m, n] in out_dtype (int32 for int8), ccol [ceil(m/bm), f, n]
    fp32, crow [ceil(n/bn), m, f] fp32).  ``bk`` is the plan's k block; the
    kernel stages k in slabs of ``KT`` and needs only that ``bk`` is a
    multiple of it.  CUDA tensors launch the kernel on the current stream;
    CPU tensors run ``abft_matmul_plain``.
    """
    global launches
    if a.device.type == "cpu":
        return abft_matmul_plain(a, b, wm, wn, bm=bm, bn=bn, bk=bk,
                                 out_dtype=out_dtype)
    out_dtype = _check(a, b, wm, wn, bm, bn, bk, out_dtype)
    if a.device.type != "cuda":
        raise RuntimeError(f"abft_matmul_cuda runs on CUDA (or the plain "
                           f"version on CPU), got {a.device}")
    for name, t in (("a", a), ("b", b), ("wm", wm), ("wn", wn)):
        if t.device != a.device:
            raise RuntimeError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = a.shape
    n, f = b.shape[1], wm.shape[0]
    dev = a.device
    c = torch.empty((m, n), dtype=out_dtype, device=dev)
    ccol = torch.empty((_cdiv(m, bm), f, n), dtype=torch.float32, device=dev)
    crow = torch.empty((_cdiv(n, bn), m, f), dtype=torch.float32, device=dev)
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), wm.data_ptr(), wn.data_ptr(),
            c.data_ptr(), ccol.data_ptr(), crow.data_ptr(), m, k, n, f, bm, bn,
            _IN_KIND[a.dtype], _OUT_KIND[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"abft_matmul kernel launch failed: code {rc} "
                           f"(m={m}, k={k}, n={n}, f={f}, tile=({bm}, {bn}), "
                           f"{a.dtype} -> {out_dtype})")
    launches += 1
    return c, ccol, crow
