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

``abft_matmul_grouped_cuda`` (kernel #1g, ``csrc/abft_matmul_grouped.cu``)
runs kernel #1's tensor-core tiles over a ragged batch of products, one a
mixture-of-experts layer's expert: rows sorted by expert, the expert
offsets on the device, the stacked weights and their checksum columns as
two tensors, and each row's residual partials reduced in the epilogue.

``abft_matmul_acc_cuda`` is the accumulate step ``C_out = C_in + A @ B``
with the carried per-tile state ``(ccol, crow)`` in the same layout, a fused
verify/correct prologue that repairs a single corrupted element of each C_in
tile before accumulating, and per-tile ``stats [ceil(m/bm), ceil(n/bn),
STATS_WIDTH]``; the counterpart of ``abft_matmul_acc_pallas``.

The kernels live in ``csrc/abft_matmul.cu`` and ``csrc/abft_matmul_acc.cu``;
both end in ``abft_tile.cuh``'s epilogue (see their headers for what bounds
them).  The tile picks the route, and ``route_of`` is the one place that
says which: ``MMA_TILES`` run tensor-core tiles (3xTF32 for fp32 operands),
for prefill, training and the SUMMA step.  Kernel #1's, and kernel #2's
for bf16 and int8 operands, run ``abft_mma.cuh``'s cp.async ring; kernel
#2's for fp32 operands run ``abft_wgmma.cuh``'s TMA ring and wgmma over
the operands' 3xTF32 planes (``tf32_planes``: ``csrc/tf32_split.cu``, made
once per SUMMA panel by the caller, or by the wrapper when none are
given).  Kernel #1's tiles of ``SPLITK_TILES_M`` rows stream B in
``split_count`` k slices into an fp32 workspace and sum them in split
order, for decode (the split policy, ``split_rows`` and ``split_count``,
lives here alone); kernel #2's other tiles run on CUDA cores.  On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor, and only
there, it runs its plain version (``abft_matmul_plain``,
``abft_matmul_acc_plain``).  ``launches`` / ``acc_launches`` count wrapper
calls that launched a kernel (a split-k call is two kernels and counts
once), ``plain_calls`` / ``acc_plain_calls`` plain-version calls;
``last_route`` / ``last_acc_route`` say how the last call of each kernel
ran.  ``grouped_launches`` / ``grouped_plain_calls`` count kernel #1g's,
``acc_wgmma_launches`` the kernel #2 launches that ran the wgmma mainloop,
``acc_split_launches`` / ``acc_split_plain_calls`` the split's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["abft_matmul_cuda", "abft_matmul_plain", "abft_matmul_acc_cuda",
           "abft_matmul_acc_plain", "abft_matmul_grouped_cuda",
           "TF32Planes", "tf32_planes", "tf32_split_cuda",
           "tf32_split_plain", "reads_planes",
           "abft_matmul_grouped_plain", "reset_counts", "route_of", "split_count",
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
grouped_launches = 0             # kernel launches by abft_matmul_grouped_cuda
grouped_plain_calls = 0          # calls of abft_matmul_grouped_plain
acc_wgmma_launches = 0           # of acc_launches, those on the wgmma mainloop
acc_split_launches = 0           # kernel launches by tf32_split_cuda
acc_split_plain_calls = 0        # calls of tf32_split_plain
last_route: dict = {}            # route, copy widths and splits of the last
                                 # kernel #1 launch
last_acc_route: dict = {}        # route, tile, copy widths and mainloop of
                                 # the last kernel #2 launch
launch_hooks: list = []          # fn(op, tensors read, tensors written)
                                 # after each launch of either kernel
                                 # (launch.hlo_accounting counts them)


def reset_counts() -> None:
    global launches, plain_calls, acc_launches, acc_plain_calls
    global grouped_launches, grouped_plain_calls, acc_wgmma_launches
    global acc_split_launches, acc_split_plain_calls
    launches = plain_calls = acc_launches = acc_plain_calls = 0
    grouped_launches = grouped_plain_calls = acc_wgmma_launches = 0
    acc_split_launches = acc_split_plain_calls = 0


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


def reads_planes(bm: int, bn: int, dtype) -> bool:
    """Whether kernel #2 on tile (bm, bn) with ``dtype`` operands reads
    their 3xTF32 planes (``tf32_planes``) instead of A and B: fp32 on its
    tensor-core tiles, the wgmma mainloop."""
    return dtype == torch.float32 and route_of(bm, bn, carry=True) == "mma"


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
# 3xTF32 operand planes of kernel #2's fp32 tensor-core route
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32, nearest with ties away from zero, on the bits:
    ``abft_mma.cuh::tf32_rna``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _check_split(x: torch.Tensor) -> None:
    if x.dim() not in (2, 3) or x.dtype != torch.float32:
        raise ValueError(f"the split takes fp32 [rows, cols] or [batch, rows, "
                         f"cols], got {x.dtype} {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError("the split reads rows of contiguous elements")


def tf32_split_plain(x: torch.Tensor, *, transpose: bool = False):
    """Plain PyTorch version of ``csrc/tf32_split.cu``: x [..., r, c] fp32
    -> (hi, lo), hi = x rounded to TF32 and lo = (x - hi) rounded the same
    way, bit for bit ``abft_mma.cuh::split_tf32`` for finite x (an inf or
    NaN x makes lo a NaN here and -0.0 or a NaN on the card, whose NaN
    differs from the host's; hi is the same); [..., r, ld] as x lies, or
    [..., c, ld] transposed, ld the inner extent rounded up to 4, the
    padding 0.  New contiguous tensors."""
    global acc_split_plain_calls
    _check_split(x)
    acc_split_plain_calls += 1
    if transpose:
        x = x.transpose(-1, -2)
    x = x.contiguous()
    hi = _tf32(x)
    lo = _tf32(x - hi)
    pad = -x.shape[-1] % 4
    return F.pad(hi, (0, pad)), F.pad(lo, (0, pad))


_SPLIT_FN = None


def _split_launcher():
    global _SPLIT_FN
    if _SPLIT_FN is None:
        from repro_torch.kernels import build
        fn = build.load("tf32_split").tf32_split_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SPLIT_FN = fn
    return _SPLIT_FN


def tf32_split_cuda(x: torch.Tensor, *, transpose: bool = False):
    """``tf32_split_plain``'s planes by the split kernel on a CUDA tensor
    (one launch, on the current stream; each block of a [batch, r, c] x
    contiguous in its rows, the batch at any stride); the plain version on
    a CPU tensor."""
    global acc_split_launches
    if x.device.type == "cpu":
        return tf32_split_plain(x, transpose=transpose)
    _check_split(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"tf32_split_cuda runs on CUDA (or the plain "
                           f"version on CPU), got {x.device}")
    batch = x.shape[0] if x.dim() == 3 else 1
    rows, cols = x.shape[-2:]
    inner = rows if transpose else cols
    ld = -(-inner // 4) * 4
    shape = x.shape[:-2] + ((cols, ld) if transpose else (rows, ld))
    hi = torch.empty(shape, dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    rc = _split_launcher()(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), batch, rows, cols,
        x.stride(0) if x.dim() == 3 else 0, x.stride(-2), ld, int(transpose),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32_split kernel launch failed: code {rc} "
                           f"({tuple(x.shape)}, transpose={transpose})")
    acc_split_launches += 1
    return hi, lo


_MAPS_FN = None


def _maps_encoder():
    global _MAPS_FN
    if _MAPS_FN is None:
        from repro_torch.kernels import build
        fn = build.load("abft_matmul_acc").abft_acc_plane_maps
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _MAPS_FN = fn
    return _MAPS_FN


class TF32Planes:
    """The 3xTF32 planes of a batch of A blocks and a batch of B blocks, as
    kernel #2's fp32 tensor-core route reads them: ``a_hi``, ``a_lo`` [P, m,
    ldk] as A lies, ``b_hi``, ``b_lo`` [Q, n, ldk] with B transposed, ldk =
    k rounded up to 4 (the padding 0).  ``at(i, j)`` names the pair one
    launch multiplies, A's block i by B's block j (0, 0 unless named); on a
    CUDA device the planes' TMA maps are encoded once for each tile width
    and shared by every pair."""

    __slots__ = ("a_hi", "a_lo", "b_hi", "b_lo", "k", "i", "j", "_maps")

    def __init__(self, a_hi, a_lo, b_hi, b_lo, k: int, i: int = 0,
                 j: int = 0, maps: Optional[dict] = None):
        self.a_hi, self.a_lo, self.b_hi, self.b_lo = a_hi, a_lo, b_hi, b_lo
        self.k, self.i, self.j = k, i, j
        self._maps = {} if maps is None else maps

    @property
    def m(self) -> int:
        return self.a_hi.shape[1]

    @property
    def n(self) -> int:
        return self.b_hi.shape[1]

    def at(self, i: int, j: int) -> "TF32Planes":
        return TF32Planes(self.a_hi, self.a_lo, self.b_hi, self.b_lo, self.k,
                          i, j, self._maps)

    def maps(self, bn: int):
        """The four TMA maps for tiles of 128 x ``bn`` (a host buffer the
        launcher copies into the kernel's parameters), encoded on first
        use."""
        buf = self._maps.get(bn)
        if buf is None:
            buf = (ctypes.c_ubyte * 512)()
            rc = _maps_encoder()(
                self.a_hi.data_ptr(), self.a_lo.data_ptr(),
                self.b_hi.data_ptr(), self.b_lo.data_ptr(),
                self.a_hi.shape[0], self.m, self.b_hi.shape[0], self.n,
                self.k, self.a_hi.shape[2], bn, buf)
            if rc != 0:
                raise RuntimeError(f"abft_acc_plane_maps failed: code {rc} "
                                   f"(m={self.m}, k={self.k}, n={self.n}, "
                                   f"bn={bn})")
            self._maps[bn] = buf
        return buf


def tf32_planes(a: torch.Tensor, b: torch.Tensor) -> TF32Planes:
    """The planes kernel #2's fp32 tensor-core route reads of a [P, m, k]
    (or [m, k], a batch of one) as it lies and b [Q, k, n] (or [k, n])
    transposed.  Two launches of the split kernel on a CUDA tensor, its
    plain version on a CPU one."""
    a_hi, a_lo = tf32_split_cuda(a)
    b_hi, b_lo = tf32_split_cuda(b, transpose=True)
    if a_hi.dim() == 2:
        a_hi, a_lo = a_hi.unsqueeze(0), a_lo.unsqueeze(0)
    if b_hi.dim() == 2:
        b_hi, b_lo = b_hi.unsqueeze(0), b_lo.unsqueeze(0)
    return TF32Planes(a_hi, a_lo, b_hi, b_lo, a.shape[-1])


def _check_planes(planes: TF32Planes, m: int, k: int, n: int,
                  device) -> None:
    """The planes of a kernel #2 call's A (m x k) and B (k x n): their
    shapes hold by construction (``tf32_planes``), so this checks only
    which product and pair they name."""
    if not isinstance(planes, TF32Planes):
        raise ValueError("planes are made by tf32_planes")
    if (planes.m, planes.k, planes.n) != (m, k, n) \
            or planes.a_hi.device != device:
        raise ValueError(f"planes of {planes.m} x {planes.k} x {planes.n} "
                         f"on {planes.a_hi.device} for a product of "
                         f"{m} x {k} x {n} on {device}")
    if not (0 <= planes.i < planes.a_hi.shape[0]
            and 0 <= planes.j < planes.b_hi.shape[0]):
        raise ValueError(f"no pair ({planes.i}, {planes.j}) in planes of "
                         f"{planes.a_hi.shape[0]} x {planes.b_hi.shape[0]} "
                         "blocks")


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
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _ACC_FN = fn
    return _ACC_FN


def abft_matmul_acc_cuda(a, b, c_in, ccol_in, crow_in, wm, wn, *,
                         bm: int = 128, bn: int = 128, bk: int = KT,
                         verify: bool = True, tol_factor: float = 64.0,
                         eps_c: Optional[float] = None, out_dtype=None,
                         out=None, planes=None):
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
    copy widths and the mainloop); CPU tensors run ``abft_matmul_acc_plain``
    (which returns new tensors and copies them into ``out`` when given).
    fp32 operands on the tensor-core tiles (``reads_planes``) are read from
    their 3xTF32 planes, ``planes = tf32_planes(a, b)``, or for blocks i
    and j of batched planes ``tf32_planes(a_blocks, b_blocks).at(i, j)`` (a
    caller that multiplies one panel many times splits it, and encodes its
    maps, once); without them the wrapper makes them.  The plain version
    computes from a and b and takes no planes.
    """
    global acc_launches, last_acc_route, acc_wgmma_launches
    if planes is not None:        # checked once, the same on every device
        _check_planes(planes, a.shape[0], a.shape[1], b.shape[1], a.device)
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
    route = route_of(bm, bn, carry=True)
    wgmma = reads_planes(bm, bn, a.dtype)
    maps, ba, bb = None, 0, 0
    if wgmma:
        if planes is None:
            planes = tf32_planes(a, b)
        maps, ba, bb = planes.maps(bn), planes.i, planes.j
    fn = _acc_launcher()
    info = (ctypes.c_int * 4)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), wm.data_ptr(), wn.data_ptr(),
            c_in.data_ptr(), ccol_in.data_ptr(), crow_in.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            stats.data_ptr(), m, k, n, f, bm, bn, _IN_KIND[a.dtype],
            _OUT_KIND[out_dtype], int(bool(verify)),
            tol_factor * bm * eps, tol_factor * bn * eps, maps, ba, bb,
            info, stream)
    if rc != 0:
        raise RuntimeError(f"abft_matmul_acc kernel launch failed: code {rc} "
                           f"(m={m}, k={k}, n={n}, f={f}, tile=({bm}, {bn}), "
                           f"{a.dtype} -> {out_dtype})")
    acc_launches += 1
    for hook in launch_hooks:
        hook("abft_matmul_acc", (a, b, wm, wn, c_in, ccol_in, crow_in),
             (*out, stats))
    ran = "mma" if info[0] == 1 else "cuda_core"
    mainloop = ("cuda_core", "ring", "wgmma")[info[3]]
    if ran != route or (mainloop == "wgmma") != wgmma:
        raise RuntimeError(f"abft_matmul_acc ran tile ({bm}, {bn}) on {ran} "
                           f"({mainloop}), planned {route}"
                           + (" (wgmma)" if wgmma else ""))
    acc_wgmma_launches += wgmma
    last_acc_route = dict(route=ran, tile=(bm, bn), copy_a=info[1],
                          copy_b=info[2], mainloop=mainloop)
    return (*out, stats)


# ---------------------------------------------------------------------------
# Grouped one-shot products (kernel #1g)
# ---------------------------------------------------------------------------

GROUPED_TILES = ((128, 128), (128, 64))   # kernel #1g's tiles (bm, bn)


def grouped_tile(n: int):
    """Kernel #1g's tile for n output columns: 128 x 128, or 128 x 64
    where 64 divides n and 128 does not (fewer masked columns)."""
    return (128, 64) if n % 128 and n % 64 == 0 else (128, 128)


def _check_grouped(x, w, w_cs, offsets, wn, bm, bn):
    if x.dim() != 2 or w.dim() != 3 or w_cs.dim() != 3:
        raise ValueError(f"x [rows, k], w [E, k, n], w_cs [E, k, f]: got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(w_cs.shape)}")
    rows, k = x.shape
    e, k2, n = w.shape
    f = w_cs.shape[-1]
    if k2 != k or tuple(w_cs.shape[:2]) != (e, k):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and w_cs "
                         f"{tuple(w_cs.shape)} do not agree")
    if tuple(offsets.shape) != (e + 1,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be int64 [{e + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if tuple(wn.shape) != (n + f, f) or wn.dtype != torch.float32:
        raise ValueError(f"wn must be float32 ({n + f}, {f}), got "
                         f"{wn.dtype} {tuple(wn.shape)}")
    if not 1 <= f <= F_MAX:
        raise ValueError(f"f={f} checksum columns: the kernel takes "
                         f"1..{F_MAX}")
    if (bm, bn) not in GROUPED_TILES:
        raise ValueError(f"tile ({bm}, {bn}) not built for kernel #1g: "
                         f"{GROUPED_TILES}")
    return rows, k, n, e, f


def abft_matmul_grouped_plain(x, w, w_cs, offsets, wn, *, bm: int = 128,
                              bn: int = 128):
    """Plain PyTorch version of kernel #1g: same arguments, same outputs.
    Expert by expert over the host's copy of ``offsets``; the row partials
    of each tile column are reduced from the rounded outputs."""
    global grouped_plain_calls
    rows, k, n, e, f = _check_grouped(x, w, w_cs, offsets, wn, bm, bn)
    grouped_plain_calls += 1
    y = torch.zeros((rows, n), dtype=torch.float32, device=x.device)
    ycs = torch.zeros((rows, f), dtype=torch.float32, device=x.device)
    bounds = offsets.tolist()
    for i in range(e):
        a, b = bounds[i], bounds[i + 1]
        if b > a:
            y[a:b] = torch.matmul(x[a:b].float(), w[i].float())
            ycs[a:b] = torch.matmul(x[a:b].float(), w_cs[i].float())
    nt = _cdiv(n, bn)
    crow = torch.empty((nt + 1, rows, f), dtype=torch.float32,
                       device=x.device)
    for j in range(nt):
        crow[j] = torch.matmul(y[:, j * bn:(j + 1) * bn],
                               wn[j * bn:min((j + 1) * bn, n)])
    crow[nt] = torch.matmul(ycs, wn[n:])
    return y, ycs, crow


_GROUPED_FN = None


def _grouped_launcher():
    global _GROUPED_FN
    if _GROUPED_FN is None:
        from repro_torch.kernels import build
        fn = build.load("abft_matmul_grouped").abft_matmul_grouped_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _GROUPED_FN = fn
    return _GROUPED_FN


def abft_matmul_grouped_cuda(x, w, w_cs, offsets, wn, *, bm: int = 128,
                             bn: int = 128):
    """Kernel #1g: for each expert e, ``Y[o_e:o_e+1] = X[o_e:o_e+1] @
    W[e]`` and ``Ycs[...] = X[...] @ W_cs[e]``, with the row partials of
    ``[Y, Ycs] @ wn``.

    x: [rows, k], rows sorted by expert; w: [E, k, n]; w_cs: [E, k, f];
    offsets: [E + 1] int64 on x's device, expert e owning rows
    ``offsets[e]`` to ``offsets[e + 1]``; wn: [n + f, f] fp32.  Returns
    (y [rows, n], ycs [rows, f], crow [ceil(n / bn) + 1, rows, f]), fp32;
    crow summed over axis 0 is ``[Y, Ycs] @ wn``.  A CUDA tensor launches
    the kernel (fp32 operands, 3xTF32) without reading the offsets on the
    host: the grid is sized by the bound ``ceil(rows / bm) + E`` on the
    (expert, m-tile) slots.  A CPU tensor runs
    ``abft_matmul_grouped_plain``."""
    global grouped_launches
    if x.device.type == "cpu":
        return abft_matmul_grouped_plain(x, w, w_cs, offsets, wn, bm=bm,
                                         bn=bn)
    rows, k, n, e, f = _check_grouped(x, w, w_cs, offsets, wn, bm, bn)
    if x.device.type != "cuda":
        raise RuntimeError(f"abft_matmul_grouped_cuda runs on CUDA (or the "
                           f"plain version on CPU), got {x.device}")
    for name, t in (("x", x), ("w", w), ("w_cs", w_cs), ("offsets", offsets),
                    ("wn", wn)):
        if t.device != x.device:
            raise RuntimeError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("w", w), ("w_cs", w_cs)):
        if t.dtype != torch.float32:
            raise TypeError(f"kernel #1g takes float32 operands; {name} is "
                            f"{t.dtype}")
    dev = x.device
    nt = _cdiv(n, bn)
    y = torch.empty((rows, n), dtype=torch.float32, device=dev)
    ycs = torch.empty((rows, f), dtype=torch.float32, device=dev)
    crow = torch.empty((nt + 1, rows, f), dtype=torch.float32, device=dev)
    info = (ctypes.c_int * 3)()
    rc = _grouped_launcher()(
        x.data_ptr(), w.data_ptr(), w_cs.data_ptr(), offsets.data_ptr(),
        wn.data_ptr(), y.data_ptr(), ycs.data_ptr(), crow.data_ptr(), rows,
        k, n, f, e, _cdiv(rows, bm) + e, bm, bn, info,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"abft_matmul_grouped kernel launch failed: code "
                           f"{rc} (rows={rows}, k={k}, n={n}, f={f}, E={e}, "
                           f"tile=({bm}, {bn}))")
    grouped_launches += 1
    for hook in launch_hooks:
        hook("abft_matmul_grouped", (x, w, w_cs, offsets, wn),
             (y, ycs, crow))
    return y, ycs, crow
