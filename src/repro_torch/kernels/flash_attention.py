"""Flash-attention forward with an in-kernel ABFT checksum: the Hopper CUDA
kernel, its wrapper and its plain PyTorch version.

The counterpart of the reference kernel
``repro/kernels/flash_attention.py::_flash_call`` (reached there through
``flash_attention_pallas`` and ``flash_attention_checked``).  Layout is
``[BH, S, D]`` with batch and heads folded and, for GQA, the KV heads
already repeated.  Scores are fp32 (``q k^T * scale``, then
``softcap * tanh(s / softcap)`` when a softcap is set); the mask is
positional, top-left aligned (``q_pos`` the global row, ``k_pos`` the
global key): causal ``q_pos >= k_pos`` and a two-sided window
``|q_pos - k_pos| < window``; the online softmax carries ``(m, l, acc)``
in fp32 with ``NEG_INF = -1e30`` and an explicit mask on ``p``, and the
output ``acc / max(l, 1e-30)`` is stored in ``q.dtype``.

The checked variant also carries the V-column checksum
``cs <- cs * corr + p @ (sum_d v)`` and a second row sum
``l2 <- l2 * corr + p @ 1`` beside the state, and emits per q-tile of
``bq`` rows ``r_pv = max_rows |sum_d o - cs/l| / (|cs/l| + 1)`` and
``r_l = max_rows |l2/l - 1|``, both 0 on rows with no live key.  A row
is live when its duplicate row sum ``l2`` is positive, not ``l``, which
is the state a fault hits: a NaN or non-positive ``l`` on a live row
gives ``r_l = inf``.  (The reference gates on ``l > 0`` and so misses an
``l`` fault that makes ``l`` NaN or negative; the port departs from it
there.)  ``flash_attention_checked`` reads the residuals, treats NaN as a
trip, and recomputes only the flagged (bh, q-tile) tiles densely.

``inject=(qi, kk, delta, target)`` is the chaos drill's hook: ``delta`` is
added to ``acc[row qi*bq, col 0]`` (target "acc") or ``l[row qi*bq]``
(target "l") of bh 0 once keys ``[0, (kk+1)*bk)`` are folded into that
row's state, whether or not that chunk holds a key the row may see.

The kernel is ``csrc/flash_attention.cu``: QK^T and P.V on tensor cores
(3xTF32 for fp32, bf16 with P split into hi + lo), K and V through a
cp.async ring, the checksums riding P.V as an extra column tile of V; its
header says what bounds it and what the design leaves.  Its tiling is its
own (``tile_of``: 64 or 128 rows a CTA, 16 to 64 keys a chunk by type and
head dim): ``bq`` and ``bk`` fix only the stats' granularity and the inject's
coordinates, and the reference's ``sq % bq == 0 and sk % bk == 0``
contract is kept.  The reference's ``interpret`` and ``pipeline`` flags and
the 128-lane padding of its stats are TPU details: the port's stats are
``[BH, Sq // bq, 2]``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor, and only there, it runs ``flash_attention_plain``.  ``launches``
counts kernel launches and ``plain_calls`` plain-version calls;
``last_route`` says how the last launch ran (route, tile, copy widths).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.chaos.faults import register_surface

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_attention_checked", "FlashCheckReport", "FLASH_CHECK_TOL",
           "NEG_INF", "reset_counts", "tile_of"]

NEG_INF = -1e30
FLASH_CHECK_TOL = 1e-3
HEAD_DIMS = (64, 128, 256)       # head widths the kernel is built for
_KIND = {torch.float32: 0, torch.bfloat16: 1}
_TARGET = {None: 0, "acc": 1, "l": 2}

launches = 0                     # kernel launches by flash_attention_cuda
plain_calls = 0                  # calls of flash_attention_plain
last_route: dict = {}            # route, tile and copy widths of the last
                                 # kernel launch

register_surface(
    "kernels.flash_attention", owner=__name__, protected=True,
    promise="tolerance",
    detector="in-kernel V-column checksum reduced from the kernel's acc "
             "state (r_pv epilogue residual) plus the post-"
             "normalization softmax rowsum==1 invariant carried as a "
             "second row sum of p (r_l residual); trip triggers "
             "dense recomputation of only the flagged q-tile",
    kinds=("flash_state_flip",),
    note="m flips are self-cancelling in o = acc/l and intentionally "
         "outside the envelope")


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def tile_of(d: int, dtype) -> Tuple[int, int]:
    """The kernel's (rows a CTA, keys a chunk) for head dim ``d`` and
    operand type ``dtype`` (``Cfg::BR``, ``Cfg::BC`` in the kernel): 16 rows
    a warp, 8 warps for fp32 at D = 64 and bf16 at D = 256, else 4; fp32 64
    keys at D = 64, 32 at 128, 16 at 256; bf16 64 keys, 32 at D = 256."""
    f32 = torch.empty((), dtype=dtype).element_size() == 4
    warps = 8 if (f32 and d == 64) or (not f32 and d == 256) else 4
    keys = ({64: 64, 128: 32}.get(d, 16) if f32
            else (64 if d <= 128 else 32))
    return 16 * warps, keys


def _check(q, k, v, bq: int, bk: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be [BH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k and v must be [{bh}, Sk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    sk = k.shape[1]
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"sq % bq and sk % bk must be 0: sq={sq}, bq={bq}, "
                         f"sk={sk}, bk={bk}")
    if q.dtype not in _KIND or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def _check_inject(inject, sq: int, sk: int, bq: int, bk: int):
    if inject is None:
        return None
    qi, kk, delta, target = inject
    if target not in ("acc", "l"):
        raise ValueError(f"inject target must be 'acc' or 'l', got "
                         f"{target!r}")
    if not (0 <= qi < sq // bq and 0 <= kk < sk // bk):
        raise ValueError(f"inject tile ({qi}, {kk}) outside the "
                         f"{sq // bq} x {sk // bk} grid")
    return int(qi), int(kk), float(delta), target


def _mask(q_pos, k_pos, causal: bool, window):
    """Positional mask [len(q_pos), len(k_pos)] (the kernel's semantics)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        # two-sided band: a one-sided bound would admit far-future keys
        mask &= (q_pos - k_pos) < window
        mask &= (k_pos - q_pos) < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True, window=None,
                          softcap=None, bq: int = 256, bk: int = 256,
                          checksum: bool = False, inject=None):
    """Plain PyTorch version of the kernel: the reference ``_kernel``'s
    online-softmax recurrence over ``bk`` chunks of keys, every chunk
    visited in order (masked or not), vectorised over BH and rows, inject
    included.  Returns ``o`` or, with ``checksum=True``, ``(o, stats)``
    with stats ``[BH, Sq // bq, 2]`` fp32 = (r_pv, r_l) per q-tile."""
    global plain_calls
    _check(q, k, v, bq, bk)
    bh, sq, d = q.shape
    sk = k.shape[1]
    inject = _check_inject(inject, sq, sk, bq, bk)
    plain_calls += 1
    dev = q.device
    q32 = q.float()
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    cs = torch.zeros_like(l)
    l2 = torch.zeros_like(l)
    q_pos = torch.arange(sq, device=dev)[:, None]
    for kk in range(sk // bk):
        kc = k[:, kk * bk:(kk + 1) * bk].float()
        vc = v[:, kk * bk:(kk + 1) * bk].float()
        s = torch.matmul(q32, kc.transpose(1, 2)) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = kk * bk + torch.arange(bk, device=dev)[None, :]
        mask = _mask(q_pos, k_pos, causal, window)
        sm = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(sm, dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(sm - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        m = m_new
        acc = acc * corr + torch.matmul(p, vc)
        if checksum:
            vsum = torch.sum(vc, dim=-1, keepdim=True)          # [bh, bk, 1]
            cs = cs * corr + torch.matmul(p, vsum)
            l2 = l2 * corr + torch.matmul(
                p, torch.ones((bk, 1), dtype=torch.float32, device=dev))
        if inject is not None and inject[1] == kk:
            row, delta, target = inject[0] * bq, inject[2], inject[3]
            if target == "l":
                l[0, row, 0] += delta
            else:
                acc[0, row, 0] += delta
    l_safe = torch.maximum(l, torch.tensor(1e-30, device=dev))
    o = acc / l_safe
    out = o.to(q.dtype)
    if not checksum:
        return out
    live = l2 > 0.0                       # l itself may be the fault
    want = cs / l_safe
    r_pv = torch.where(live, torch.abs(torch.sum(o, dim=-1, keepdim=True)
                                       - want) / (torch.abs(want) + 1.0),
                       0.0)
    r_l = torch.where(live, torch.where(l > 0.0,
                                        torch.abs(l2 / l_safe - 1.0),
                                        torch.inf), 0.0)
    rows = torch.cat([r_pv, r_l], dim=-1)                        # [bh, sq, 2]
    return out, torch.amax(rows.view(bh, sq // bq, bq, 2), dim=2)


_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_float, ctypes.POINTER(ctypes.c_int),
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True, window=None,
                         softcap=None, bq: int = 256, bk: int = 256,
                         checksum: bool = False, inject=None):
    """q [BH, Sq, D], k and v [BH, Sk, D] (fp32 or bf16) -> o [BH, Sq, D]
    in q.dtype, or ``(o, stats)`` with ``checksum=True``.  CUDA tensors
    launch the kernel on the current stream; CPU tensors run
    ``flash_attention_plain``."""
    global launches, last_route
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap, bq=bq,
                                     bk=bk, checksum=checksum, inject=inject)
    _check(q, k, v, bq, bk)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_cuda runs on CUDA (or the plain "
                           f"version on CPU), got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise RuntimeError(f"q on {q.device}, k on {k.device}, v on "
                           f"{v.device}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    inject = _check_inject(inject, sq, sk, bq, bk)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    rows = (torch.empty((bh, sq, 2), dtype=torch.float32, device=q.device)
            if checksum else None)
    if bh * sq:
        qi, kk, delta, target = inject if inject is not None \
            else (0, 0, 0.0, None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        info = (ctypes.c_int * 6)()
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            rows.data_ptr() if checksum else None, bh, sq, sk, d,
            _KIND[q.dtype], int(checksum), float(scale), int(causal),
            int(window is not None),
            int(window) if window is not None else 0,
            float(softcap) if softcap else 0.0, _TARGET[target],
            qi * bq, (kk + 1) * bk, delta, info, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: code "
                               f"{rc} (BH={bh}, sq={sq}, sk={sk}, d={d}, "
                               f"{q.dtype})")
        launches += 1
        tile = (info[1], info[2])
        if info[0] != 1 or tile != tile_of(d, q.dtype):
            raise RuntimeError(f"flash_attention ran route {info[0]} tile "
                               f"{tile}, planned mma {tile_of(d, q.dtype)}")
        last_route = dict(route="mma", tile=tile, copy_q=info[3],
                          copy_k=info[4], copy_v=info[5])
    if not checksum:
        return o
    # torch.amax keeps a NaN row residual (fmaxf would drop it)
    return o, torch.amax(rows.view(bh, sq // bq, bq, 2), dim=2)


@dataclasses.dataclass(frozen=True)
class FlashCheckReport:
    ok: bool                              # no residual tripped
    detected: Tuple[Tuple[int, int], ...]  # flagged (bh, q-tile) tiles
    repaired: int                         # tiles recomputed dense
    max_pv_residual: float
    max_rowsum_residual: float


def _dense_tile(q, k, v, q0, scale, causal, window, softcap):
    """Dense oracle for one q-tile (kernel mask semantics, fp32), in plain
    PyTorch on the tensors' device."""
    s = torch.matmul(q.float(), k.float().T) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = q0 + torch.arange(q.shape[0], device=q.device)[:, None]
    kp = torch.arange(k.shape[0], device=q.device)[None, :]
    mask = _mask(qp, kp, causal, window)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    return torch.matmul(p, v.float()) / torch.clamp_min(l, 1e-30)


def flash_attention_checked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float,
    causal: bool = True,
    window=None,
    softcap=None,
    bq: int = 256,
    bk: int = 256,
    tol: float = FLASH_CHECK_TOL,
    inject: Optional[Tuple[int, int, float, str]] = None,
):
    """Checksummed flash attention: ``(o, FlashCheckReport)``.

    Runs the kernel with the cs/l2 checksum recurrence live; any q-tile
    whose epilogue residual exceeds ``tol`` (NaN counts as a trip) is
    recomputed against the dense per-tile oracle and patched in place.
    ``inject`` is the chaos drill hook (see the module docstring).
    """
    o, stats = flash_attention_cuda(
        q, k, v, scale=scale, causal=causal, window=window, softcap=softcap,
        bq=bq, bk=bk, checksum=True, inject=inject)
    st = stats.cpu()
    # a NaN-contaminated tile must read as tripped, not compare false
    st = torch.where(torch.isnan(st), torch.inf, st)
    r_pv, r_l = st[..., 0], st[..., 1]
    bad = torch.nonzero((r_pv > tol) | (r_l > tol))
    detected = tuple((int(b), int(i)) for b, i in bad.tolist())
    for b, i in detected:
        fixed = _dense_tile(q[b, i * bq:(i + 1) * bq], k[b], v[b], i * bq,
                            scale, causal, window, softcap)
        o[b, i * bq:(i + 1) * bq] = fixed.to(o.dtype)
    report = FlashCheckReport(
        ok=not detected, detected=detected, repaired=len(detected),
        max_pv_residual=float(r_pv.max()),
        max_rowsum_residual=float(r_l.max()))
    return o, report
