"""Fused dual-checksum ABFT matmul: the Hopper CUDA kernels, their wrappers
and their plain PyTorch versions.

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

``abft_matmul_acc_cuda`` is the accumulate step ``C_out = C_in + A @ B``
with the carried per-tile state ``(ccol, crow)`` in the same layout, a fused
verify/correct prologue that repairs a single corrupted element of each C_in
tile before accumulating, and per-tile ``stats [ceil(m/bm), ceil(n/bn),
STATS_WIDTH]``; the counterpart of ``abft_matmul_acc_pallas``.

The kernels live in ``csrc/abft_matmul.cu`` and ``csrc/abft_matmul_acc.cu``;
both run ``abft_mma.cuh``'s ring mainloop on their tensor-core tiles and
end in ``abft_tile.cuh``'s epilogue (see their headers for what bounds
them).  The tile picks the route, and ``route_of`` is the one place that
says which: ``MMA_TILES`` run tensor-core tiles (3xTF32 for fp32 operands)
behind a cp.async ring in both kernels, for prefill, training and the
SUMMA step; kernel #1's tiles of ``SPLITK_TILES_M`` rows stream B in
``split_count`` k slices into an fp32 workspace and sum them in split
order, for decode (the split policy, ``split_rows`` and ``split_count``,
lives here alone); kernel #2's other tiles run on CUDA cores.  On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor, and only
there, it runs its plain version (``abft_matmul_plain``,
``abft_matmul_acc_plain``).  ``launches`` / ``acc_launches`` count wrapper
calls that launched a kernel (a split-k call is two kernels and counts
once), ``plain_calls`` / ``acc_plain_calls`` plain-version calls;
``last_route`` / ``last_acc_route`` say how the last call of each kernel
ran.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["abft_matmul_cuda", "abft_matmul_plain", "abft_matmul_acc_cuda",
           "abft_matmul_acc_plain", "reset_counts", "route_of", "split_count",
           "split_rows", "sm_count",
           "TILES_M", "TILES_N", "MMA_TILES", "MMA_SLAB", "SPLITK_TILES_M",
           "KT", "F_MAX",
           "STATS_WIDTH"]

TILES_M = (16, 32, 64, 128)      # CTA tile rows of kernel #2 (and the plain
TILES_N = (32, 64, 128)          # versions); columns
MMA_TILES = ((128, 128), (128, 64))   # both kernels' tensor-core tiles
MMA_SLAB = 256                   # bytes of k a ring stage of those tiles
                                 # takes from a row of A (abft_mma.cuh)
SPLITK_TILES_M = (16, 32)        # kernel #1's split-k tile rows (bn: TILES_N)
# The split-k policy: decided here and passed to the launcher, which has
# SPLIT_COLS and SPLIT_KMAX compiled in and refuses a slice over
# SPLIT_KMAX or a row block outside SPLIT_ROWS (code -5); it derives none.
SPLIT_COLS = 128                 # columns of B a split-k CTA streams
SPLIT_KMAX = 256                 # most k rows in one split
SPLIT_KMIN = 64                  # fewest k rows in one split, where k allows
SPLIT_ROWS = (4, 8, 16, 32)      # rows of A a split-k CTA holds
KT = 16                          # k columns staged per shared-memory slab
F_MAX = 4                        # most checksum rows per direction

# stats vector per C tile (accumulate kernel):
#   0: detected (residual over threshold)      1: corrected (single-elt fix)
#   2: global row of the fix                   3: global col of the fix
#   4: residual magnitude (col direction)      5: residual magnitude (row dir)
#   6: detection threshold (col direction)     7: |C_in| scale used for tol
STATS_WIDTH = 8

_IN_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

launches = 0                     # kernel launches by abft_matmul_cuda
plain_calls = 0                  # calls of abft_matmul_plain
acc_launches = 0                 # kernel launches by abft_matmul_acc_cuda
acc_plain_calls = 0              # calls of abft_matmul_acc_plain
last_route: dict = {}            # route, copy widths and splits of the last
                                 # kernel #1 launch
last_acc_route: dict = {}        # route, tile and copy widths of the last
                                 # kernel #2 launch
launch_hooks: list = []          # fn(op, tensors read, tensors written)
                                 # after each launch of either kernel
                                 # (launch.hlo_accounting counts them)


def reset_counts() -> None:
    global launches, plain_calls, acc_launches, acc_plain_calls
    launches = plain_calls = acc_launches = acc_plain_calls = 0


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def route_of(bm: int, bn: int, *, carry: bool = False) -> Optional[str]:
    """The route a tile runs, or None for a tile that is not built.  Kernel
    #1: "mma" (tensor-core tiles) or "splitk" (k split for decode).  Kernel
    #2 (``carry``): "mma" for ``MMA_TILES``, "cuda_core" for every other
    tile of ``TILES_M`` x ``TILES_N``.  The launchers check the route they
    ran against this."""
    if (bm, bn) in MMA_TILES:
        return "mma"
    if carry:
        return "cuda_core" if bm in TILES_M and bn in TILES_N else None
    if bm in SPLITK_TILES_M and bn in TILES_N:
        return "splitk"
    return None


def split_rows(m: int) -> int:
    """Rows of A a split-k CTA holds: the fewest of ``SPLIT_ROWS`` that
    cover m, else the most (the grid then walks m in blocks of it)."""
    return next((r for r in SPLIT_ROWS if r >= m), SPLIT_ROWS[-1])


def split_count(m: int, k: int, n: int, sms: int) -> int:
    """k slices of a split-k call on a card of ``sms`` SMs: enough CTAs for
    two on each SM (a CTA streams ``SPLIT_COLS`` columns of B for
    ``split_rows(m)`` rows of A) but no slice under ``SPLIT_KMIN`` k rows
    (a narrow B has too few bytes to spread), at most ``SPLIT_KMAX`` k
    rows a slice, and no empty slice."""
    blocks = _cdiv(n, SPLIT_COLS) * _cdiv(m, split_rows(m))
    most = _cdiv(k, SPLIT_KMAX)
    s = min(max(_cdiv(2 * sms, blocks), most), max(most, k // SPLIT_KMIN))
    return _cdiv(k, _cdiv(k, s))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check_oneshot(a, b, wm, wn, bm, bn, bk, out_dtype):
    """``_check`` for kernel #1 and its plain version, which take the same
    tiles: those with a route (``route_of``)."""
    out_dtype = _check(a, b, wm, wn, bm, bn, bk, out_dtype)
    if route_of(bm, bn) is None:
        raise ValueError(f"tile ({bm}, {bn}) not built for kernel #1: "
                         f"{MMA_TILES} or bm in {SPLITK_TILES_M}")
    return out_dtype


def abft_matmul_plain(a, b, wm, wn, *, bm: int = 128, bn: int = 128,
                      bk: int = KT, out_dtype=None):
    """Plain PyTorch version of the kernel: same arguments, same outputs.

    fp32 and bf16 operands multiply in fp32; int8 operands multiply
    exactly (float64 holds every int8 dot product of any served width) and
    land in int32.  The partials are reduced from the rounded output.
    """
    global plain_calls
    out_dtype = _check_oneshot(a, b, wm, wn, bm, bn, bk, out_dtype)
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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def abft_matmul_cuda(a, b, wm, wn, *, bm: int = 128, bn: int = 128,
                     bk: int = KT, out_dtype=None,
                     splits: Optional[int] = None):
    """One-shot C = A @ B with fused dual checksum partials.

    a: [m, k], b: [k, n] (fp32, bf16 or int8); wm: [f, m], wn: [n, f] fp32.
    Returns (c [m, n] in out_dtype (int32 for int8), ccol [ceil(m/bm), f, n]
    fp32, crow [ceil(n/bn), m, f] fp32).  ``bk`` is the plan's k block and
    needs only be a multiple of ``KT``.  CUDA tensors launch the kernel on
    the current stream, on the route of the tile (``route_of``); a split-k
    tile cuts k into ``splits`` slices (the plan's; by default
    ``split_count`` on this card) and allocates its ``[splits, m, n]``
    workspace.  CPU tensors run ``abft_matmul_plain``.
    """
    global launches, last_route
    if a.device.type == "cpu":
        return abft_matmul_plain(a, b, wm, wn, bm=bm, bn=bn, bk=bk,
                                 out_dtype=out_dtype)
    out_dtype = _check_oneshot(a, b, wm, wn, bm, bn, bk, out_dtype)
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
    route, rows, ws = route_of(bm, bn), 0, None
    if route == "splitk":
        if splits is None:
            splits = split_count(m, k, n, sm_count(dev.index))
        rows = split_rows(m)
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    elif splits not in (None, 1):
        raise ValueError(f"tile ({bm}, {bn}) runs tensor-core tiles, not "
                         f"{splits} k splits")
    info = (ctypes.c_int * 4)()
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), wm.data_ptr(), wn.data_ptr(),
            c.data_ptr(), ccol.data_ptr(), crow.data_ptr(),
            None if ws is None else ws.data_ptr(), m, k, n, f, bm, bn,
            splits or 1, rows, _IN_KIND[a.dtype], _OUT_KIND[out_dtype], info,
            stream)
    if rc != 0:
        raise RuntimeError(f"abft_matmul kernel launch failed: code {rc} "
                           f"(m={m}, k={k}, n={n}, f={f}, tile=({bm}, {bn}), "
                           f"splits={splits}, {a.dtype} -> {out_dtype})")
    launches += 1
    for hook in launch_hooks:
        hook("abft_matmul", (a, b, wm, wn), (c, ccol, crow))
    last_route = dict(route=route, copy_a=info[1], copy_b=info[2],
                      splits=info[3])
    return c, ccol, crow


# ---------------------------------------------------------------------------
# Accumulate step with the carried checksum state
# ---------------------------------------------------------------------------


def _check_acc(a, b, c_in, ccol_in, crow_in, wm, wn, bm, bn, bk, out_dtype):
    """Validate one accumulate call; returns the output dtype, which is
    C_in's (the kernel reads C_in in the type it writes C_out)."""
    out_dtype = c_in.dtype if out_dtype is None else out_dtype
    _check(a, b, wm, wn, bm, bn, bk, out_dtype)
    m, n, f = a.shape[0], b.shape[1], wm.shape[0]
    if tuple(c_in.shape) != (m, n) or c_in.dtype != out_dtype:
        raise ValueError(f"c_in {tuple(c_in.shape)} {c_in.dtype} must be "
                         f"({m}, {n}) {out_dtype}")
    want = ((_cdiv(m, bm), f, n), (_cdiv(n, bn), m, f))
    for name, t, shape in (("ccol_in", ccol_in, want[0]),
                           ("crow_in", crow_in, want[1])):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be "
                             f"{shape} float32 (the state of a ({bm}, {bn}) "
                             "tiling)")
    return out_dtype


def abft_matmul_acc_plain(a, b, c_in, ccol_in, crow_in, wm, wn, *,
                          bm: int = 128, bn: int = 128, bk: int = KT,
                          verify: bool = True, tol_factor: float = 64.0,
                          eps_c: Optional[float] = None, out_dtype=None):
    """Plain PyTorch version of the accumulate kernel: same arguments, same
    outputs, always new tensors.  The verify/correct math is
    ``ops._tile_verify_correct``, then the product is added (int8 operands
    exactly, in int32), the tile rounded to the output type and its state
    taken with ``ops.tile_checksums``."""
    global acc_plain_calls
    out_dtype = _check_acc(a, b, c_in, ccol_in, crow_in, wm, wn, bm, bn, bk,
                           out_dtype)
    acc_plain_calls += 1
    from repro_torch.kernels import ops   # ops imports this module
    return ops._acc_twin(a, b, c_in, (ccol_in, crow_in), wm, wn, bm, bn,
                         verify=verify, tol_factor=tol_factor, eps_c=eps_c,
                         out_dtype=out_dtype)


_ACC_FN = None


def _acc_launcher():
    global _ACC_FN
    if _ACC_FN is None:
        from repro_torch.kernels import build
        fn = build.load("abft_matmul_acc").abft_matmul_acc_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 \
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _ACC_FN = fn
    return _ACC_FN


def abft_matmul_acc_cuda(a, b, c_in, ccol_in, crow_in, wm, wn, *,
                         bm: int = 128, bn: int = 128, bk: int = KT,
                         verify: bool = True, tol_factor: float = 64.0,
                         eps_c: Optional[float] = None, out_dtype=None,
                         out=None):
    """Accumulate step C_out = C_in + A @ B with the carried state.

    a: [m, k], b: [k, n] (fp32, bf16 or int8); c_in: [m, n] in the output
    type (fp32 or bf16, int32 for int8); ccol_in [ceil(m/bm), f, n] and
    crow_in [ceil(n/bn), m, f] fp32, the state a previous call (or kernel
    #1) wrote under the same tiling.  With ``verify`` each C_in tile is
    checked against its state and a single corrupted element repaired
    before the accumulation, at ``tol = tol_factor * b * eps_c * mean|tile|``
    (``eps_c`` defaults to fp32's).  ``out = (c_out, ccol_out, crow_out)``
    names the tensors to write, which may be the inputs themselves (each
    CTA reads its tiles before it writes them); by default they are new.
    Returns (c_out, ccol_out, crow_out, stats [ceil(m/bm), ceil(n/bn),
    STATS_WIDTH] fp32).  CUDA tensors launch the kernel on the current
    stream, on the tile's route (``route_of(bm, bn, carry=True)``, checked
    against what the launcher ran; ``last_acc_route`` records it with the
    copy widths); CPU tensors run ``abft_matmul_acc_plain`` (which returns
    new tensors and copies them into ``out`` when given).
    """
    global acc_launches, last_acc_route
    if a.device.type == "cpu":
        res = abft_matmul_acc_plain(
            a, b, c_in, ccol_in, crow_in, wm, wn, bm=bm, bn=bn, bk=bk,
            verify=verify, tol_factor=tol_factor, eps_c=eps_c,
            out_dtype=out_dtype)
        if out is None:
            return res
        for dst, src in zip(out, res[:3]):
            dst.copy_(src)
        return (*out, res[3])
    out_dtype = _check_acc(a, b, c_in, ccol_in, crow_in, wm, wn, bm, bn, bk,
                           out_dtype)
    if a.device.type != "cuda":
        raise RuntimeError(f"abft_matmul_acc_cuda runs on CUDA (or the plain "
                           f"version on CPU), got {a.device}")
    m, k = a.shape
    n, f = b.shape[1], wm.shape[0]
    dev = a.device
    if out is None:
        out = (torch.empty_like(c_in), torch.empty_like(ccol_in),
               torch.empty_like(crow_in))
    for src, dst in zip((c_in, ccol_in, crow_in), out):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"out tensor {tuple(dst.shape)} {dst.dtype} does "
                             f"not match {tuple(src.shape)} {src.dtype}")
    named = (("a", a), ("b", b), ("wm", wm), ("wn", wn), ("c_in", c_in),
             ("ccol_in", ccol_in), ("crow_in", crow_in), ("c_out", out[0]),
             ("ccol_out", out[1]), ("crow_out", out[2]))
    for name, t in named:
        if t.device != dev:
            raise RuntimeError(f"{name} is on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    stats = torch.empty((_cdiv(m, bm), _cdiv(n, bn), STATS_WIDTH),
                        dtype=torch.float32, device=dev)
    eps = float(torch.finfo(torch.float32).eps) if eps_c is None else eps_c
    fn = _acc_launcher()
    info = (ctypes.c_int * 4)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), wm.data_ptr(), wn.data_ptr(),
            c_in.data_ptr(), ccol_in.data_ptr(), crow_in.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            stats.data_ptr(), m, k, n, f, bm, bn, _IN_KIND[a.dtype],
            _OUT_KIND[out_dtype], int(bool(verify)),
            tol_factor * bm * eps, tol_factor * bn * eps, info, stream)
    if rc != 0:
        raise RuntimeError(f"abft_matmul_acc kernel launch failed: code {rc} "
                           f"(m={m}, k={k}, n={n}, f={f}, tile=({bm}, {bn}), "
                           f"{a.dtype} -> {out_dtype})")
    acc_launches += 1
    for hook in launch_hooks:
        hook("abft_matmul_acc", (a, b, wm, wn, c_in, ccol_in, crow_in),
             (*out, stats))
    route = "mma" if info[0] == 1 else "cuda_core"
    if route != route_of(bm, bn, carry=True):
        raise RuntimeError(f"abft_matmul_acc ran tile ({bm}, {bn}) on "
                           f"{route}, planned {route_of(bm, bn, carry=True)}")
    last_acc_route = dict(route=route, tile=(bm, bn), copy_a=info[1],
                          copy_b=info[2])
    return (*out, stats)
