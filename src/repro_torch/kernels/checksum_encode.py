"""Weighted-checksum encoder: the Hopper CUDA kernel of the diskless
checkpoint, its wrapper and its plain PyTorch version.

``checksum_encode_cuda(x, a)`` computes ``Y[j] = sum_i A[j, i] * X[i]`` for
stacked shards ``x [p, m, n]`` (fp32 or bf16) and a checkpoint matrix
``a [f, p]``: the paper's §2.1 encode, summed in fp32 over p in order and
rounded once to ``x.dtype``.  It is the counterpart of the reference kernel
``repro/kernels/checksum_encode.py::checksum_encode_pallas``; the kernel is
``csrc/checksum_encode.cu`` (see its header for what bounds it and what the
simple design leaves out), and it takes any m and n.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor, and only there, it runs ``checksum_encode_plain``.  ``launches``
counts kernel launches and ``plain_calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.abft_matmul import sm_count

__all__ = ["checksum_encode_cuda", "checksum_encode_plain", "reset_counts",
           "MAX_FP"]

MAX_FP = 12288                   # most f * p the kernel takes (A in smem)
_KIND = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                     # kernel launches by checksum_encode_cuda
plain_calls = 0                  # calls of checksum_encode_plain


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def _check(x: torch.Tensor, a: torch.Tensor) -> None:
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"x must be [p, m, n] and a [f, p], got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    f, p = a.shape
    if x.shape[0] != p:
        raise ValueError(f"checkpoint matrix is {tuple(a.shape)}, shards "
                         f"have p={x.shape[0]}")
    if not 1 <= f * p <= MAX_FP:
        raise ValueError(f"f * p = {f * p}: the kernel takes 1..{MAX_FP}")
    if x.dtype not in _KIND:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")


def checksum_encode_plain(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arguments, same output
    (an fp32 matrix product over p, rounded once to ``x.dtype``)."""
    global plain_calls
    _check(x, a)
    plain_calls += 1
    p = x.shape[0]
    y = torch.matmul(a, x.reshape(p, -1).float())
    return y.reshape((a.shape[0],) + tuple(x.shape[1:])).to(x.dtype)


_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        fn = build.load("checksum_encode").checksum_encode_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def checksum_encode_cuda(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x: [p, m, n] (fp32 or bf16), a: [f, p] fp32 -> y: [f, m, n] in
    x.dtype.  CUDA tensors launch the kernel on the current stream; CPU
    tensors run ``checksum_encode_plain``."""
    global launches
    if x.device.type == "cpu":
        return checksum_encode_plain(x, a)
    _check(x, a)
    if x.device.type != "cuda":
        raise RuntimeError(f"checksum_encode_cuda runs on CUDA (or the plain "
                           f"version on CPU), got {x.device}")
    if a.device != x.device:
        raise RuntimeError(f"a is on {a.device}, x on {x.device}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("x and a must be contiguous")
    p, m, n = x.shape
    f = a.shape[0]
    y = torch.empty((f, m, n), dtype=x.dtype, device=x.device)
    if m * n == 0:
        return y
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(x.data_ptr(), a.data_ptr(), y.data_ptr(), p, f, m * n,
                     _KIND[x.dtype], sm_count(dev.index or 0), stream)
    if rc != 0:
        raise RuntimeError(f"checksum_encode kernel launch failed: code {rc} "
                           f"(p={p}, f={f}, m={m}, n={n}, {x.dtype})")
    launches += 1
    return y
