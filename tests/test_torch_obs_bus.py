"""The port's telemetry bus (``repro_torch.obs``): off means off, span
identity, the shared epoch, the device-clock hook and the JSONL schema."""
import json
import time

import pytest

from repro_torch import obs
from repro_torch.obs import export


@pytest.fixture
def bus():
    """The global bus, reset and recording; restored after the test."""
    was = obs.enabled()
    obs.reset()
    obs.enable(True)
    yield obs
    obs.set_device_clock(None)
    obs.enable(was)
    obs.reset()


def test_disabled_span_is_the_shared_no_op(bus):
    bus.enable(False)
    sp = bus.span("x", device=True, a=1)
    assert sp is bus.NO_SPAN and bus.span("y") is sp
    with sp as inner:
        inner.set(n=3)                 # a no-op, not shared state
        bus.tally("host_reads")
        bus.event("fault/inject")
    assert bus.events() == [] and not hasattr(sp, "attrs")
    assert bus.TRACER._stack() == []
    # a subscriber keeps the bus live though recording is off
    seen = []
    bus.subscribe(seen.append)
    try:
        with bus.span("z"):
            pass
    finally:
        bus.unsubscribe(seen.append)
    assert [e.name for e in seen] == ["z"] and bus.events() == []


def test_span_ids_nest(bus):
    with bus.span("a") as a:
        bus.tally("reads")             # no span asked for it: dropped
        with bus.span("b", reads=0) as b:
            with bus.span("c"):
                bus.event("i")
                bus.tally("reads")     # into b, which asked for it
            bus.tally("reads", 2)
        with bus.span("d"):
            pass
    ev = {e.name: e for e in bus.events()}
    assert ev["a"].parent is None and ev["a"].parent_id is None
    assert ev["a"].span_id == a.span_id and ev["b"].span_id == b.span_id
    assert (ev["b"].parent, ev["b"].parent_id) == ("a", a.span_id)
    assert (ev["c"].parent, ev["c"].parent_id) == ("b", b.span_id)
    assert (ev["d"].parent, ev["d"].parent_id) == ("a", a.span_id)
    assert ev["i"].span_id is None and ev["i"].parent == "c"
    assert ev["i"].parent_id == ev["c"].span_id
    assert ev["b"].attrs == {"reads": 3}
    assert ev["a"].attrs == {} and ev["c"].attrs == {}
    assert len({e.span_id for e in bus.events() if e.kind == "span"}) == 4


def test_epoch_plus_ts_is_perf_counter(bus):
    t0 = time.perf_counter()
    with bus.span("a"):
        time.sleep(0.002)
    t1 = time.perf_counter()
    e, = bus.events()
    assert t0 <= bus.epoch() + e.ts_s <= bus.epoch() + e.ts_s + e.dur_s <= t1


class FakeClock:
    """A device clock whose markers are counter values, 0.5 ms apart."""

    def __init__(self):
        self.n = 0
        self.waited = []

    def mark(self):
        self.n += 1
        return self.n

    def elapsed_s(self, a, b):
        self.waited.append(b)
        return (b - a) * 5e-4


def test_device_hook_fills_device_s(bus):
    with bus.span("untimed", device=True):    # no clock installed yet
        pass
    clock = FakeClock()
    bus.set_device_clock(clock)
    assert bus.TRACER._clock is clock
    with bus.span("outer", device=True):
        with bus.span("inner", device=True):
            pass
        with bus.span("host_only"):
            pass
    bus.enable(False)
    with bus.span("off", device=True):        # off: no marker
        pass
    assert clock.n == 4
    assert bus.resolve_device() == 2 and bus.resolve_device() == 0
    ev = {e.name: e for e in bus.events()}
    assert ev["inner"].attrs["device_s"] == pytest.approx(5e-4)
    assert ev["outer"].attrs["device_s"] == pytest.approx(1.5e-3)
    assert "device_s" not in ev["untimed"].attrs
    assert "device_s" not in ev["host_only"].attrs
    assert sorted(clock.waited) == [3, 4]


def test_jsonl_round_trips_the_new_fields(bus, tmp_path):
    bus.set_device_clock(FakeClock())
    with bus.span("a", device=True):
        with bus.span("b", k=1):
            bus.event("i", x=2)
    bus.resolve_device()
    evs = bus.events()
    path = tmp_path / "t.jsonl"
    export.write_jsonl(str(path), evs)
    back = export.read_jsonl(str(path))
    assert back == evs
    i, b, a = back
    assert (a.span_id, b.parent_id, i.parent_id) == (a.span_id, a.span_id,
                                                     b.span_id)
    assert a.span_id is not None and b.span_id is not None
    assert a.parent_id is None and i.span_id is None
    assert a.attrs["device_s"] == pytest.approx(5e-4)
    doc = export.to_perfetto(back)
    assert export.validate_perfetto(doc) == 3
    assert doc["traceEvents"][2]["args"]["parent_id"] == a.span_id
    # a line written before span identity existed still loads
    old = dict(export.event_dict(evs[1]))
    del old["span_id"], old["parent_id"]
    path.write_text(json.dumps({"schema": export.EVENT_SCHEMA}) + "\n"
                    + json.dumps(old) + "\n")
    e, = export.read_jsonl(str(path))
    assert e.name == "b" and e.span_id is None and e.parent_id is None


def test_the_bus_imports_no_torch():
    import ast
    import pathlib
    src = pathlib.Path(obs.__file__).parent
    for name in ("trace.py", "export.py", "metrics.py", "__init__.py"):
        tree = ast.parse((src / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert not {m for m in mods if m.split(".")[0] == "torch"}, name


def test_the_cuda_clock_needs_a_card(bus):
    import torch
    from repro_torch.obs import cuda as obs_cuda
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card test below runs instead")
    with pytest.raises(RuntimeError, match="CUDA card"):
        obs_cuda.install()
    assert bus.TRACER._clock is None


@pytest.mark.gpu
def test_the_cuda_clock_times_a_span_on_the_card(bus):
    import torch
    from repro_torch.obs import cuda as obs_cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the clock is CUDA events")
    obs_cuda.install()
    x = torch.randn(4096, 4096, device="cuda")
    x = x @ x / 64.0                         # cuBLAS set up outside the span
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with bus.span("mm", device=True):
        for _ in range(8):
            x = x @ x / 64.0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    obs_cuda.uninstall()
    assert bus.resolve_device() == 1
    e, = bus.events()
    assert 0.0 < e.attrs["device_s"] <= wall
    assert e.dur_s < e.attrs["device_s"]     # the host only issued the work
