"""The bus's device clock on a CUDA card: CUDA events on the current
stream.

    from repro_torch import obs
    from repro_torch.obs import cuda as obs_cuda

    obs_cuda.install()              # device=True spans now mark the stream
    with obs.span("summa/scrub", device=True):
        ...
    torch.cuda.synchronize()
    obs.resolve_device()            # attrs["device_s"] of each such span
    obs_cuda.uninstall()

No profiler is needed.  A marker is a ``torch.cuda.Event(enable_timing=
True)`` recorded on the current stream of the current device, so a span's
device time is the stream's time from the work issued before its entry
to the work issued before its exit: the device's idle time between is
inside it.  Kept apart from ``repro_torch.obs`` so that the bus imports
no torch.
"""
from __future__ import annotations

import torch

from repro_torch.obs import trace

__all__ = ["CudaClock", "install", "uninstall"]


class CudaClock:
    """``mark()`` and ``elapsed_s(a, b)`` on CUDA events."""

    def mark(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def elapsed_s(self, a: torch.cuda.Event, b: torch.cuda.Event) -> float:
        b.synchronize()
        return a.elapsed_time(b) / 1e3


def install(tracer: trace.Tracer = trace.TRACER) -> CudaClock:
    """Install a :class:`CudaClock` on ``tracer`` (the global bus by
    default) and return it; raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("obs.cuda.install needs a CUDA card")
    clock = CudaClock()
    tracer.set_device_clock(clock)
    return clock


def uninstall(tracer: trace.Tracer = trace.TRACER) -> None:
    """Remove the device clock; spans already marked still resolve."""
    tracer.set_device_clock(None)
