"""The spans of the port's fault-tolerant SUMMA (``core/summa.py``,
``core/detect.py``) at grid 4 on the CPU, through the plain version of
kernel #2: one root a product, the counts where the work happens, the
rebuild folded by ``rung_timeline``, and nothing recorded with the bus
off."""
import pytest
import torch

import repro_torch.core as core
from repro_torch import obs
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ops as kops

G, F, NB = 4, 1, 16


@pytest.fixture
def bus():
    was = obs.enabled()
    obs.reset()
    obs.enable(True)
    yield obs
    obs.enable(was)
    obs.reset()


def _operands():
    spec = core.make_spec(F, G - F, G - F, device="cpu")
    gen = torch.Generator().manual_seed(7)
    a = torch.randn((G - F) * NB, G * NB, generator=gen)
    b = torch.randn(G * NB, (G - F) * NB, generator=gen)
    return spec, a, b


def _product(spec, a, b, **fault):
    a_enc, b_enc = core.encode_operands(a, b, spec)
    c = core.abft_summa(a_enc, b_enc, G, spec=spec, local_update="cuda",
                        **fault)
    return core.locate_and_correct(c, spec)[0]


def _tree(evs):
    spans = [e for e in evs if e.kind == "span"]
    by_id = {e.span_id: e for e in spans}

    def root_of(e):
        while e.parent_id in by_id:
            e = by_id[e.parent_id]
        return e
    return by_id, root_of


def test_a_product_records_its_parts_under_one_root(bus):
    spec, a, b = _operands()
    n0 = kmm.acc_launches + kmm.acc_plain_calls
    _product(spec, a, b)
    launched = kmm.acc_launches + kmm.acc_plain_calls - n0
    evs = bus.events()
    by_id, root_of = _tree(evs)
    roots = [e for e in evs if e.name == "summa/abft_summa"]
    assert len(roots) == 1
    root = roots[0]
    assert root.attrs == dict(grid=G, f=F, block=NB, dtype="float32",
                              fault="none", tile=root.attrs["tile"])
    assert len(root.attrs["tile"]) == 2
    under = [e for e in by_id.values() if root_of(e) is root]
    names = sorted(e.name for e in under)
    assert names == sorted(
        ["summa/abft_summa", "summa/plan", "summa/scrub"]
        + ["summa/layout"] * 3 + ["summa/step", "summa/panel",
                                  "summa/update"] * G)
    # the encode and the check are products' siblings, not children
    assert [e.name for e in evs if e.kind == "span" and e.parent is None] \
        == ["summa/encode_operands", "summa/abft_summa",
            "detect/locate_and_correct"]
    ups = [e for e in under if e.name == "summa/update"]
    assert [e.attrs["launches"] for e in ups] == [G * G] * G
    assert sum(e.attrs["launches"] for e in ups) == launched == G ** 3
    for e in under:
        if e.name in ("summa/panel", "summa/update"):
            assert by_id[e.parent_id].name == "summa/step"
    assert sorted(by_id[e.parent_id].attrs["k"] for e in ups) == \
        list(range(G))
    scrub, = [e for e in under if e.name == "summa/scrub"]
    assert scrub.attrs == dict(blocks=G * G, host_reads=0)
    for e in under:
        if e.name in ("summa/plan", "summa/layout"):
            assert e.attrs == {} and e.parent_id == root.span_id
    check = next(e for e in evs if e.name == "detect/locate_and_correct")
    assert check.attrs == dict(host_reads=2)
    enc = next(e for e in evs if e.name == "summa/encode_operands")
    assert enc.attrs == dict(host_reads=0)


def test_a_loss_gives_one_rebuild_with_its_children(bus):
    spec, a, b = _operands()
    _product(spec, a, b, failure=core.FailureEvent(step=2, row=1, col=0))
    evs = bus.events()
    by_id, _ = _tree(evs)
    root = next(e for e in evs if e.name == "summa/abft_summa")
    assert root.attrs["fault"] == "kill"
    inject, = [e for e in evs if e.name == "fault/inject"]
    assert inject.parent_id == root.span_id
    assert inject.attrs == dict(surface="core.summa", kind="kill",
                                processes=[[1, 0]], summa_step=2)
    rebuild, = [e for e in evs if e.name == "recovery/summa_rebuild"]
    assert rebuild.parent_id == root.span_id
    assert rebuild.attrs == dict(kind="kill", processes=[[1, 0]],
                                 summa_step=2)
    kids = [e for e in by_id.values() if e.parent_id == rebuild.span_id]
    lines = [e for e in kids if e.name == "summa/recover_line"]
    assert sorted((e.attrs["operand"], e.attrs["lines"]) for e in lines) \
        == [("A", [1]), ("B", [0]), ("C", [1])]
    rederive, = [e for e in kids if e.name == "summa/rederive_state"]
    assert rederive.attrs == dict(blocks=G * G)
    tl = obs.rung_timeline(evs)
    assert list(tl) == ["summa_rebuild"] and tl["summa_rebuild"]["n"] == 1


def test_two_losses_and_a_flip_are_named(bus):
    spec, a, b = _operands()
    want = _product(spec, a, b)
    got2 = _product(spec, a, b, failure=core.MultiFailureEvent(
        step=1, devices=((0, 1), (2, 3))))
    got_f = _product(spec, a, b, bitflip=core.BitflipEvent(
        step=3, row=1, col=2, delta=1e3))
    for got in (got2, got_f):
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    evs = bus.events()
    assert [e.attrs["fault"] for e in evs if e.name == "summa/abft_summa"] \
        == ["none", "kill2", "flip"]
    assert [(e.attrs["kind"], e.attrs["summa_step"]) for e in evs
            if e.name == "fault/inject"] == [("kill2", 1), ("flip", 3)]
    # two lines of A and C (columns 1 and 3), two of B (rows 0 and 2)
    assert sum(e.name == "summa/recover_line" for e in evs) == 6
    assert obs.rung_timeline(evs)["summa_rebuild"]["n"] == 1


def test_with_the_bus_off_a_product_records_nothing(bus):
    spec, a, b = _operands()
    want = _product(spec, a, b, failure=core.FailureEvent(step=1, row=0,
                                                          col=2))
    obs.reset()
    obs.enable(False)
    got = _product(spec, a, b, failure=core.FailureEvent(step=1, row=0,
                                                         col=2))
    assert obs.events() == [] and obs.TRACER._stack() == []
    assert torch.equal(got, want)          # tracing changes no value


def test_counts_stay_in_the_spans_that_ask_for_them(bus):
    spec, a, b = _operands()
    with obs.span("train/step") as outer:
        _product(spec, a, b)
    assert outer.attrs == {}
    scrub = next(e for e in obs.events() if e.name == "summa/scrub")
    assert scrub.attrs["host_reads"] == 0
    check = next(e for e in obs.events()
                 if e.name == "detect/locate_and_correct")
    assert check.attrs["host_reads"] == 2


# what reads a device value back to the host from Python
_HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
               "__index__")


def _scrub_reading_nothing(monkeypatch, calls, guard):
    """Wrap the scrub's ``correct_from_state`` so that ``guard`` holds only
    while the scrub runs, and count its calls."""
    inner = kops.correct_from_state

    def scrub(*args, **kw):
        calls.append(args[0].shape)
        with guard():
            return inner(*args, **kw)
    monkeypatch.setattr(kops, "correct_from_state", scrub)


def test_a_last_step_flip_is_repaired_by_one_scrub_call_reading_nothing(
        bus, monkeypatch):
    """A flip after the last SUMMA step has no next launch to catch it:
    one scrub call over all G^2 blocks repairs it, and no host read runs
    inside it (each of them raises there)."""
    import contextlib

    @contextlib.contextmanager
    def no_host_reads():
        def refuse(self, *a, **kw):
            raise AssertionError("a host read inside the scrub")
        with monkeypatch.context() as mp:
            for name in _HOST_READS:
                mp.setattr(torch.Tensor, name, refuse)
            yield

    spec, a, b = _operands()
    want = _product(spec, a, b)
    calls = []
    _scrub_reading_nothing(monkeypatch, calls, no_host_reads)
    got = _product(spec, a, b, bitflip=core.BitflipEvent(
        step=G, row=2, col=1, delta=-3e3))
    assert calls == [torch.Size([G, G, NB, NB])]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    scrub = next(e for e in bus.events() if e.name == "summa/scrub")
    assert scrub.attrs == dict(blocks=G * G, host_reads=0)


@pytest.mark.gpu
def test_the_scrub_does_not_synchronize_on_card(monkeypatch):
    """On the card, a fused product with a last-step flip: the scrub runs
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    synchronizing call, and the product comes back repaired."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode")
    import contextlib

    @contextlib.contextmanager
    def no_sync():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    torch.backends.cuda.matmul.allow_tf32 = False
    spec, a, b = _operands()
    spec = core.make_spec(F, G - F, G - F, device="cuda")
    a, b = a.cuda(), b.cuda()
    want = _product(spec, a, b)
    calls = []
    _scrub_reading_nothing(monkeypatch, calls, no_sync)
    got = _product(spec, a, b, bitflip=core.BitflipEvent(
        step=G, row=1, col=2, delta=5e3))
    torch.cuda.synchronize()
    assert calls == [torch.Size([G, G, NB, NB])]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
