"""The fault-tolerant SUMMA's spans (``core/summa.py``), as its readers
read them: one ``summa/abft_summa`` root a product groups the rest by
``parent_id``.  The spans come from ``harness/spans.py::window_spans``."""
from __future__ import annotations

from typing import Dict, List, Optional

from portbench.harness.spans import Span
from portbench.harness.stats import median

ROOT = "summa/abft_summa"


def products(spans: List[Span]) -> Dict[int, List[Span]]:
    """Root span id -> the spans under that product's root (itself
    included)."""
    by_id = {s.span_id: s for s in spans}
    out: Dict[int, List[Span]] = {}
    for s in spans:
        top = s
        while top.name != ROOT and top.parent_id in by_id:
            top = by_id[top.parent_id]
        if top.name == ROOT:
            out.setdefault(top.span_id, []).append(s)
    return out


def launch_us(spans: List[Span]) -> Optional[float]:
    """Host microseconds a kernel #2 launch: the summed length of the
    ``summa/update`` spans over the launches they count."""
    ups = [s for s in spans if s.name == "summa/update"]
    n = sum(s.attrs.get("launches", 0) for s in ups)
    if not n:
        return None
    return 1e6 * sum(s.end - s.start for s in ups) / n


def device_ms_per_product(spans: List[Span], name: str,
                          faults=None) -> Optional[float]:
    """Median over the window's products (those whose root's ``fault`` is
    in ``faults``, where given) of the summed device time of their spans
    called ``name``, in ms; products without such a span count 0.  None
    where no such span has a device time."""
    per = []
    for members in products(spans).values():
        root = next(s for s in members if s.name == ROOT)
        if faults is not None and root.attrs.get("fault") not in faults:
            continue
        hit = [s.attrs["device_s"] for s in members
               if s.name == name and "device_s" in s.attrs]
        per.append((bool(hit), 1e3 * sum(hit)))
    if not any(h for h, _ in per):
        return None
    return median([ms for _, ms in per])
