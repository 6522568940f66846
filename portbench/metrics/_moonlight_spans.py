"""The dropless MoE's and the latent attention's spans (models/moe.py,
models/attention.py), as their readers read them: the spans recorded in
the window (the record's ``spans``, from harness/spans.py::window_spans)
that start within each timed step, their device times summed."""
from __future__ import annotations

from typing import Optional, Sequence

from portbench.harness.stats import median


def device_ms_per_step(record: dict, names: Sequence[str]) -> Optional[float]:
    """Median over the window's steps of the summed device time, in ms, of
    the spans called one of ``names``; None where no such span has a device
    time."""
    spans = [s for s in record.get("spans") or () if s.name in names
             and "device_s" in s.attrs]
    if not spans or not record.get("step_bounds"):
        return None
    per = [1e3 * sum(s.attrs["device_s"] for s in spans if t0 <= s.start < t1)
           for t0, t1 in record["step_bounds"]]
    return median(per)
