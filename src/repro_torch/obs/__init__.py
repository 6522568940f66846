"""``repro_torch.obs`` — the FT telemetry bus of the PyTorch port.

A copy of the reference package's stdlib-only bus (``repro/obs``), kept
here so that the port imports nothing of the reference.  One
process-global seam for traces (:mod:`repro_torch.obs.trace`), metrics
(:mod:`repro_torch.obs.metrics`) and exporters
(:mod:`repro_torch.obs.export`):

    from repro_torch import obs

    with obs.span("serve/decode_step", step=i):
        ...                                   # hierarchical, exception-safe
    with obs.span("summa/update", device=True) as sp:
        ...                                   # timed on the device too
        sp.set(launches=n)                    # (obs.cuda.install() first)
    obs.resolve_device()                      # after a synchronize
    obs.event("kernel/trace", op="abft_matmul", backend="cuda")
    obs.counter("repro_decode_steps_total").inc()
    obs.subscribe(on_event)
"""
from repro_torch.obs.trace import (            # noqa: F401
    Event, Tracer, TRACER,
    span, event, recovery, tally, NO_SPAN,
    subscribe, unsubscribe, enable, enabled,
    set_step, current_step, reset, events, dropped,
    epoch, set_device_clock, resolve_device,
    rung_timeline, lifecycles, percentile,
)
from repro_torch.obs.metrics import (          # noqa: F401
    Counter, Gauge, Histogram, Registry, REGISTRY,
    counter, gauge, histogram, snapshot,
)
from repro_torch.obs import export             # noqa: F401

__all__ = [
    "Event", "Tracer", "TRACER",
    "span", "event", "recovery", "tally", "NO_SPAN",
    "subscribe", "unsubscribe", "enable", "enabled",
    "set_step", "current_step", "reset", "events", "dropped",
    "epoch", "set_device_clock", "resolve_device",
    "rung_timeline", "lifecycles", "percentile",
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot",
    "export", "reset_all",
]


def reset_all() -> None:
    """Fresh-run semantics: clear the trace buffer AND the metrics
    registry (subscribers and the enabled flag survive)."""
    from repro_torch.obs import metrics
    reset()
    metrics.reset()
