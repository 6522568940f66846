"""ABFT-protected matmul for model layers (Huang-Abraham per layer).

This is the "fault-tolerant BLAS" the paper argues should encapsulate all the
fault tolerance of a dense-LA stack (§1), applied to the matmuls of an LM:

    W_F = [W, W @ w_r]          (f checksum columns; encoded once)
    Y_F = X @ W_F               (checksum columns ride along: +f/n FLOPs)
    verify:  Y_F[..., -f:] =?= Y_F[..., :-f] @ w_r    (O(m n f) vs O(m n k))
    correct: single corrupted element located by (row = argmax residual rows,
             col via a second weighted checksum), fixed by the residual.

Modes (``ABFTConfig.mode``):
    off      — plain matmul
    checksum — carry checksums, don't verify
    verify   — carry + verify; returns an `ok` flag alongside
    correct  — carry + verify + correct single bit-flips in the output

Backend: with ``backend="cuda"`` (or "auto" on a CUDA tensor) the matmul AND
the verification residual run in one fused kernel (`kernels.ops`): the
kernel's row-checksum epilogue is fed ``W_n = [w_r; -I]`` so it reduces
``Y @ w_r - Y_cs`` — the §4.3 residual — directly from the accumulator.
That deletes the separate ``Y @ w_r`` verify product and its full extra read
of Y.  ``backend="ref"`` (and "auto" on CPU) keeps the plain PyTorch path.
With ``backend="cuda"`` on a CPU tensor the kernel's plain version runs,
which is how the CPU tests drive this dispatch.

Counterpart of the reference package's ``repro/core/abft_gemm.py``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.checksum import checkpoint_matrix

__all__ = ["ABFTConfig", "encode_weight", "abft_matmul", "verify_output",
           "correct_output"]


# Kernel compute dtypes the layer path accepts.  Checksum ACCUMULATION is
# always fp32 (int8 products route through an exact integer GEMM first) —
# only the A/B operand stream narrows.
_KERNEL_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


@dataclasses.dataclass(frozen=True)
class ABFTConfig:
    mode: str = "off"          # off | checksum | verify | correct
    f: int = 2                 # number of checksum columns (2 => locate 2D)
    tol_factor: float = 256.0  # residual threshold multiplier
    seed: int = 17
    backend: str = "auto"      # auto | cuda | ref (fused-kernel dispatch)
    in_dtype: str = "fp32"     # fp32 | bf16 | int8 — GEMM operand dtype

    @property
    def active(self) -> bool:
        return self.mode != "off"

    @property
    def compute_dtype(self):
        try:
            return _KERNEL_DTYPES[self.in_dtype]
        except KeyError:
            raise ValueError(
                f"in_dtype={self.in_dtype!r} not in {sorted(_KERNEL_DTYPES)}"
            ) from None


def _detection_eps(cfg: ABFTConfig) -> float:
    """Residual-test eps for the configured operand dtype: bf16 operands
    quantize the encoded checksum columns of ``w_enc`` to bf16, so eps
    widens to bf16's; fp32 and int8 keep fp32 eps."""
    dt = cfg.compute_dtype
    eps32 = float(torch.finfo(torch.float32).eps)
    if dt.is_floating_point:
        return max(float(torch.finfo(dt).eps), eps32)
    return eps32


@functools.lru_cache(maxsize=512)
def _weights_cached(n: int, f: int, seed: int, device: str) -> torch.Tensor:
    return checkpoint_matrix(f, n, seed=seed, device=device).T.contiguous()


def _weights(n: int, f: int, seed: int, device=None) -> torch.Tensor:
    """Element-granularity encoding weights w_r: [n, f] fp32 (row 0 = plain
    sum).  Cached per device: callers must not write into it."""
    return _weights_cached(n, f, seed, str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=512)
def _residual_weights(n: int, f: int, seed: int, device: str) -> torch.Tensor:
    """``[w_r; -I]``: [n + f, f] — fed to the kernel's row epilogue, it
    reduces the §4.3 residual ``Y @ w_r - Y_cs``."""
    wr = _weights_cached(n, f, seed, device)
    eye = torch.eye(f, dtype=torch.float32, device=device)
    return torch.cat([wr, -eye], dim=0).contiguous()


def encode_weight(w: torch.Tensor, cfg: ABFTConfig) -> torch.Tensor:
    """Append f checksum columns to a [k, n] weight matrix -> [k, n + f]."""
    n = w.shape[-1]
    wr = _weights(n, cfg.f, cfg.seed, w.device)
    cs = torch.matmul(w.float(), wr).to(w.dtype)
    return torch.cat([w, cs], dim=-1)


def _fused_forward(x: torch.Tensor, w_enc: torch.Tensor, cfg: ABFTConfig):
    """Fused-kernel forward: (y_f fp32, residual fp32 [..., f]) or None.

    Dispatches through `kernels.ops.abft_matmul` with the row-checksum
    weights set to ``[w_r; -I]``, so the kernel epilogue reduces the §4.3
    verification residual from the accumulator — no separate verify
    product, no extra read of Y.  The plan is ``autotune.best_plan``'s (a
    measured winner when the cache holds one, the time model's otherwise).
    The reference drops to the plain path when the plan pads more than 25 %;
    this kernel masks ragged edges instead of padding, so every shape
    (decode's m = slots included) takes it.
    """
    from repro_torch.kernels import autotune as ktune
    from repro_torch.kernels import ops as kops  # lazy, as in the reference

    if not (cfg.backend == "cuda" or (cfg.backend == "auto" and x.is_cuda)):
        return None
    lead = x.shape[:-1]
    k = x.shape[-1]
    m = 1
    for d in lead:
        m *= d
    n_enc = w_enc.shape[-1]
    n = n_enc - cfg.f
    plan = ktune.best_plan(m, k, n_enc, in_dtype=x.dtype,
                           out_dtype=torch.float32, f=cfg.f, device=x.device)
    wn_res = _residual_weights(n, cfg.f, cfg.seed, str(x.device))
    wm = kops.kernel_weights(m, cfg.f, device=x.device)
    y_f, _cs_col, res = kops.abft_matmul(
        x.reshape(m, k), w_enc, wm=wm, wn=wn_res, out_dtype=torch.float32,
        plan=plan)
    return y_f.reshape(*lead, n_enc), res.reshape(*lead, cfg.f)


def _int8_forward(x: torch.Tensor, w_enc: torch.Tensor, cfg: ABFTConfig):
    """Dynamically-quantized int8 forward: (y_f fp32, residual fp32).

    Checksum columns of magnitude ~sqrt(n)*127*|w_q| cannot live in int8,
    so the int8 path splits the encoded matrix: the DATA block is quantized
    to int8 and multiplied exactly, while the checksum product re-encodes
    in fp32 from the *quantized* weights — cs_q = w_q @ w_r,
    y_cs = x_q @ cs_q — a different association order than
    (x_q @ w_q) @ w_r, so a fault in the main GEMM still breaks the
    consistency relation.
    """
    n = w_enc.shape[-1] - cfg.f
    w = w_enc[..., :n].float()
    x32 = x.float()
    sx = 127.0 / (torch.max(torch.abs(x32)) + 1e-30)
    sw = 127.0 / (torch.max(torch.abs(w)) + 1e-30)
    xq = torch.clamp(torch.round(x32 * sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(w * sw), -127, 127).to(torch.int8)
    # exact integer product: float64 holds every int8 dot product, and its
    # rounding to fp32 matches the reference's int32 -> fp32
    yq = torch.matmul(xq.double(), wq.double()).float()
    wr = _weights(n, cfg.f, cfg.seed, x.device)             # [n, f]
    cs_q = torch.matmul(wq.float(), wr)                     # [k, f]
    ycs_q = torch.matmul(xq.float(), cs_q)                  # [..., f]
    residual_q = torch.matmul(yq, wr) - ycs_q
    inv = 1.0 / (sx * sw)
    y_f = torch.cat([yq, ycs_q], dim=-1) * inv
    return y_f, residual_q * inv


def abft_matmul(
    x: torch.Tensor, w_enc: torch.Tensor, cfg: ABFTConfig,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Y = X @ W with fault-tolerance per cfg.mode.

    w_enc must be `encode_weight(w, cfg)` when cfg.active, else plain w.
    Returns (y, ok) where ok is None unless mode in {verify, correct}.
    cfg.in_dtype narrows the GEMM operand stream (bf16 casts both
    operands, int8 dynamically quantizes); checksums stay fp32 throughout
    and the residual test widens eps to match (`_detection_eps`).
    """
    if not cfg.active:
        return torch.matmul(x.float(), w_enc.float()).to(x.dtype), None
    if cfg.in_dtype == "int8":
        y_f, residual = _int8_forward(x, w_enc, cfg)
    else:
        cdt = cfg.compute_dtype
        x_c = x.to(cdt)
        w_c = w_enc.to(cdt)
        fused = _fused_forward(x_c, w_c, cfg)
        if fused is None:
            y_f = torch.matmul(x_c.float(), w_c.float())
            residual = None
        else:
            y_f, residual = fused
    y, y_cs = y_f[..., : -cfg.f], y_f[..., -cfg.f:]
    if cfg.mode == "checksum":
        return y.to(x.dtype), None
    if residual is None:
        ok, residual = verify_output(y, y_cs, cfg)
    else:
        ok = _residual_ok(y, residual, cfg)
    if cfg.mode == "verify":
        return y.to(x.dtype), ok
    y = correct_output(y, y_cs, residual, cfg)
    return y.to(x.dtype), ok


def _residual_ok(y: torch.Tensor, residual: torch.Tensor, cfg: ABFTConfig):
    """The §4.3 acceptance test: max |residual| <= tol * n * eps * |Y|,
    with eps keyed on the configured OPERAND dtype and a mean-|.| scale
    (robust to a single corrupted element)."""
    n = y.shape[-1]
    eps = _detection_eps(cfg)
    scale = torch.mean(torch.abs(y.float())) + 1e-30
    tol = cfg.tol_factor * n * eps * scale
    return torch.max(torch.abs(residual)) <= tol


def verify_output(y: torch.Tensor, y_cs: torch.Tensor, cfg: ABFTConfig):
    """Check Y @ w_r == carried checksums, with the paper's residual scaling
    tau ~ tol * n * eps * |Y|  (§4.3 residual checking)."""
    n = y.shape[-1]
    wr = _weights(n, cfg.f, cfg.seed, y.device)
    recomputed = torch.matmul(y.float(), wr)
    residual = recomputed - y_cs.float()   # [..., f]
    return _residual_ok(y, residual, cfg), residual


def correct_output(y, y_cs, residual, cfg: ABFTConfig):
    """Correct a single corrupted element of Y.

    Row: argmax over the leading (flattened) axes of |residual[..., 0]|.
    Column: the ratio residual[r,1]/residual[r,0] equals w_r[col,1]/w_r[col,0]
    for the corrupted column (needs f >= 2); we pick the column whose weight
    ratio matches, then subtract residual[r,0] / w_r[col,0].
    """
    if cfg.f < 2:
        raise ValueError("correct mode needs f >= 2 checksum columns")
    n = y.shape[-1]
    wr = _weights(n, cfg.f, cfg.seed, y.device)      # [n, f]
    y32 = y.float()
    flat_y = y32.reshape(-1, n)
    flat_res = residual.reshape(-1, cfg.f)
    r = torch.argmax(torch.abs(flat_res[:, 0]))
    ratio = flat_res[r, 1] / (flat_res[r, 0] + 1e-30)
    col = torch.argmin(torch.abs(wr[:, 1] / wr[:, 0] - ratio))
    delta = flat_res[r, 0] / wr[col, 0]
    fixed = flat_y.clone()
    fixed[r, col] -= delta
    # one iterative-refinement pass: the first residual was computed with
    # the (huge) corrupted value in the sum, so it carries |delta|*eps of
    # cancellation error; re-deriving it from the repaired row leaves only
    # O(n eps |y|) error on the corrected element
    flat_cs = y_cs.reshape(-1, cfg.f).float()
    res_r = torch.matmul(fixed[r], wr) - flat_cs[r]
    fixed[r, col] -= res_r[0] / wr[col, 0]
    eps = _detection_eps(cfg)
    # mean-|.| scale (as in _residual_ok): bf16 checksum-quantization noise
    # must not trip a phantom "repair" of a healthy element
    scale = torch.mean(torch.abs(y32)) + 1e-30
    tol = cfg.tol_factor * n * eps * scale
    use_fixed = torch.max(torch.abs(flat_res)) > tol
    out = torch.where(use_fixed, fixed, flat_y)
    return out.reshape(y.shape)
