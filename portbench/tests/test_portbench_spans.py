"""The program's spans as the harness reads them (harness/spans.py) and
the SUMMA's readings of them (metrics/_summa_spans.py): the readings on
synthetic spans, None against a program without them, idle
gaps named by the innermost program span, and a CPU run that reports
kernel2_launch_us."""
import sys
import threading
import types

import pytest

from portbench.harness import spans as hs
from portbench.metrics import _summa_spans as ss
from portbench.harness.trace import DeviceTrace, Phases
from portbench.tests.helpers import make_tree, run_cell

TID = threading.main_thread().ident


def S(start, end, name, sid, parent=None, **attrs):
    return hs.Span(start, end, name, sid, parent, TID, attrs)


def product(t, sid, fault, rebuild_ms=None, scrub_ms=2.0):
    """One product's spans from host time ``t``: two updates of 64
    launches, a scrub, and a rebuild where ``rebuild_ms`` is given."""
    out = [S(t, t + 1.0, "summa/abft_summa", sid, fault=fault),
           S(t + 0.1, t + 0.2, "summa/update", sid + 1, sid, launches=64),
           S(t + 0.3, t + 0.4, "summa/update", sid + 2, sid, launches=64),
           S(t + 0.8, t + 0.9, "summa/scrub", sid + 3, sid,
             device_s=scrub_ms / 1e3)]
    if rebuild_ms is not None:
        out += [S(t + 0.5, t + 0.6, "recovery/summa_rebuild", sid + 4, sid),
                S(t + 0.5, t + 0.55, "summa/recover_line", sid + 5, sid + 4,
                  device_s=rebuild_ms / 2e3),
                S(t + 0.55, t + 0.6, "summa/recover_line", sid + 6, sid + 4,
                  device_s=rebuild_ms / 2e3)]
    return out


def test_readings_on_synthetic_spans():
    spans = (product(0.0, 10, "none", scrub_ms=2.0)
             + product(1.0, 20, "kill", rebuild_ms=4.0, scrub_ms=3.0)
             + product(2.0, 30, "kill2", rebuild_ms=6.0, scrub_ms=5.0)
             + product(3.0, 40, "flip", scrub_ms=4.0))
    assert sorted(len(v) for v in ss.products(spans).values()) == \
        [4, 4, 7, 7]
    # 8 updates of 0.1 s over 512 launches
    assert ss.launch_us(spans) == pytest.approx(0.8e6 / 512)
    assert ss.device_ms_per_product(spans, "summa/scrub") == \
        pytest.approx(3.5)
    assert ss.device_ms_per_product(spans, "summa/recover_line",
                                    faults=("kill", "kill2")) == \
        pytest.approx(5.0)
    assert ss.device_ms_per_product(spans, "summa/rederive_state") is None
    no_launch = [s for s in spans if s.name != "summa/update"]
    assert ss.launch_us(no_launch) is None


def test_none_against_a_program_without_the_spans(monkeypatch):
    # the parent's bus: no shared epoch
    monkeypatch.setitem(sys.modules, "repro_torch.obs",
                        types.SimpleNamespace(events=lambda: []))
    assert hs.window_spans(0.0, 1e9) is None
    from portbench.run import load_reader
    ctx = types.SimpleNamespace(record=dict(kind="products", t_start=0.0,
                                            t_end=1e9, product_s=[1.0]))
    assert load_reader("kernel2_launch_us")(ctx) is None


def test_window_spans_reads_the_bus_on_the_host_clock():
    import time
    from repro_torch import obs

    class Clock:
        def mark(self):
            return time.perf_counter()

        def elapsed_s(self, a, b):
            return b - a

    was = obs.enabled()
    obs.reset()
    obs.enable(True)
    obs.set_device_clock(Clock())
    try:
        with obs.span("before"):
            pass
        t0 = time.perf_counter()
        with obs.span("summa/abft_summa", device=True, fault="none"):
            with obs.span("summa/update") as sp:
                sp.set(launches=4)
        t1 = time.perf_counter()
        got = hs.window_spans(t0, t1)
        assert hs.window_spans(t1, t1 + 1.0) is None
    finally:
        obs.set_device_clock(None)
        obs.enable(was)
        obs.reset()
    assert [s.name for s in got] == ["summa/abft_summa", "summa/update"]
    root, up = got
    assert t0 <= root.start <= up.start <= up.end <= root.end <= t1
    assert up.parent_id == root.span_id and up.tid == TID
    assert 0 < root.attrs["device_s"] <= t1 - t0
    assert ss.launch_us(got) == pytest.approx(1e6 * (up.end - up.start) / 4)


def test_idle_gaps_name_the_innermost_program_span():
    trace = DeviceTrace(None)
    trace.t0, trace.t1 = 0.0, 10.0
    # busy [0, 1], [2, 3], [3.5, 8], [9, 10]: gaps 1-2, 3-3.5, 8-9
    trace.events = [(0.0, 1.0, "k"), (2.0, 3.0, "k"), (3.5, 8.0, "k"),
                    (9.0, 10.0, "k")]
    phases = Phases()
    phases.spans = [(0.0, 8.5, "abft_summa"), (8.5, 10.0, "synchronize")]
    phases._starts = [0.0, 8.5]
    spans = [S(0.5, 8.2, "summa/abft_summa", 1),
             S(1.0, 1.8, "summa/step", 2, 1),
             S(1.2, 1.7, "summa/update", 3, 2),
             S(2.9, 4.0, "summa/scrub", 4, 1),
             # another thread's span is not the issuing thread's
             hs.Span(8.0, 9.5, "other", 5, None, TID + 1, {})]
    got = dict(hs.idle_by_span(trace, phases, spans))
    assert got == pytest.approx({"abft_summa>summa/update": 1.0,
                                 "abft_summa>summa/scrub": 0.5,
                                 "synchronize": 1.0})
    # without program spans, the harness's labels alone
    assert dict(hs.idle_by_span(trace, phases, None)) == pytest.approx(
        dict(trace.idle_gaps(phases)))


FORCE_KERNEL = """
import repro_torch.core as _core
_run = _core.abft_summa
def _on_kernel(*a, **k):
    k["local_update"] = "cuda"     # kernel #2's plain version on the CPU
    return _run(*a, **k)
_core.abft_summa = _on_kernel
"""


def test_a_traced_cpu_run_reports_kernel2_launch_us(tmp_path):
    rc, out, err = run_cell(make_tree(tmp_path), "summa-g8-nloc3000.clean",
                            seconds=0.5, extra=("--trace", "1"),
                            patch=FORCE_KERNEL)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True
    m = out["metrics"]["kernel2_launch_us"]
    assert m["unit"] == "us" and m["value"] > 0
