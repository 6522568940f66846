"""The FLOP and byte counts behind the roofline and mfu shares, against
hand counts, the readers against hand-worked records, and the kernel-name
patterns against the kernels' names."""
import re
import types

import pytest

from portbench.harness.stats import gemm_work, roofline_share
from portbench.tests.helpers import BENCH

def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "r_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gemm_work_by_hand():
    # C[2, 4] = A[2, 3] @ B[3, 4]: 2*3*4 multiply-adds; 6 + 12 inputs, 8 out
    assert gemm_work(2, 3, 4, 4, 4) == (48.0, (6 + 12) * 4 + 8 * 4)
    # accumulating: C read and written
    assert gemm_work(2, 3, 4, 2, 4, acc=True) == (48.0,
                                                  18 * 2 + 2 * 8 * 4)
    fl, by = gemm_work(3000, 3000, 3000, 4, 4, acc=True)
    assert fl == 2 * 3000 ** 3 and by == 4 * 4 * 3000 ** 2


class _Trace:
    def __init__(self, events):
        self.events = events

    def seconds_matching(self, pattern):
        hits = [b - a for a, b, n in self.events if re.search(pattern, n)]
        return sum(hits) if hits else None


def _ctx(record, events=None, kind="NVIDIA H100 80GB HBM3"):
    import json
    return types.SimpleNamespace(
        record=record, trace=None if events is None else _Trace(events),
        device_kind=kind,
        peaks=json.loads((BENCH / "peaks.json").read_text()))


def test_roofline_share_takes_the_larger_bound():
    ctx = _ctx({}, [(0.0, 2.0, "void mma_kernel<float>(...)")])
    # compute-bound: 495e12 FLOPs at 495 TFLOP/s is 1 s of the 2 s spent
    assert roofline_share(ctx, 495e12, 1.0, "mma_kernel",
                          "tf32_flops_per_s") == pytest.approx(50.0)
    # bandwidth-bound: 3.35e12 bytes is 1 s
    assert roofline_share(ctx, 1.0, 3.35e12, "mma_kernel",
                          "tf32_flops_per_s") == pytest.approx(50.0)
    assert roofline_share(ctx, 1.0, 1.0, "nothing_ran",
                          "tf32_flops_per_s") is None
    assert roofline_share(_ctx({}, [(0, 1, "mma_kernel")], kind="cpu"),
                          1.0, 1.0, "mma_kernel", "tf32_flops_per_s") is None


def test_kernel_name_patterns():
    k2 = _reader("kernel2_roofline").PATTERN
    names = {
        "void acc_mma_kernel<float, 128, 128, 32>(float const*)": True,
        "void abft_matmul_acc_kernel<float, float, 32, 32>(...)": True,
        "void mma_kernel<float, 128, 64, 32, 3>(float const*, float*)": False,
        "void splitk_partial<float>(float const*)": False,
        "void checksum_encode_kernel<float>(float const*)": False,
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32": False,
        "void my_acc_mma_kernel2<float>()": False,
    }
    for name, hit in names.items():
        assert bool(re.search(k2, name)) == hit, name


def test_kernel2_work_is_g_cubed_rank_kb_updates():
    rec = dict(kind="products", product_s=[1.0, 1.0], block=3000, grid=8)
    spent = 2 * 512 * 1e-3
    ctx = _ctx(rec, [(0.0, spent, "void acc_mma_kernel<float>()")])
    least = 2 * 3000 ** 3 / 495e12           # compute-bound at 3000^3
    assert _reader("kernel2_roofline").read(ctx) == pytest.approx(
        100 * 2 * 512 * least / spent)


def _products(times, kinds=None):
    return dict(kind="products", product_s=times, window_s=sum(times),
                faults=kinds or ["none"] * len(times),
                data_flops=2.0 * 21000 * 24000 * 21000)


def test_product_rate_and_mfu_by_hand():
    rec = _products([0.8, 0.9, 1.0])
    want = 3 * 2 * 21000 * 24000 * 21000 / 2.7 / 1e12
    assert _reader("ft_gemm_tflops").read(_ctx(rec)) == pytest.approx(want)
    assert _reader("mfu.summa").read(_ctx(rec)) == pytest.approx(
        100 * want * 1e12 / 495e12)
    assert _reader("mfu.summa").read(_ctx(rec, kind="cpu")) is None
    assert _reader("ft_gemm_tflops").read(_ctx(_products([]))) is None


def test_recovery_extra_is_a_difference_of_medians():
    rec = _products([1.0, 1.2, 0.9, 1.5, 1.1, 0.8],
                    ["none", "kill", "none", "kill2", "flip", "none"])
    # faulted: median of 1.2, 1.5, 1.1 is 1.2; clean: of 1.0, 0.9, 0.8, 0.9
    got = _reader("recovery_extra_ms").read(_ctx(rec))
    assert got == pytest.approx(300.0)
    assert _reader("recovery_extra_ms").read(_ctx(_products([1.0]))) is None


def test_every_metric_in_the_benchmark_has_a_reader():
    import json
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(_reader(m["name"]), "read"), m["name"]


def test_trace_readings_from_device_events():
    from portbench.harness.trace import DeviceTrace, Phases
    t = DeviceTrace(None)
    t.t0, t.t1 = 0.0, 10.0
    t.events = [(1.0, 2.0, "void mma_kernel<float>()"), (1.5, 3.0, "copy"),
                (5.0, 6.0, "void acc_mma_kernel<float>()")]
    phases = Phases()
    with phases("abft_summa"):
        pass
    phases.spans = [(0.0, 4.0, "abft_summa"), (4.0, 10.0, "synchronize")]
    phases._starts = [0.0, 4.0]
    assert t.busy_s() == pytest.approx(3.0)
    assert t.seconds_matching(_reader("kernel2_roofline").PATTERN) == 1.0
    assert t.top_ops(1) == [["copy", 1.5]]
    # idle gaps, each named by the span at its middle: 0-1 under the
    # product; 3-5 (middle 4) and 6-10 under the synchronize
    assert t.idle_gaps(phases) == [["synchronize", pytest.approx(6.0)],
                                   ["abft_summa", pytest.approx(1.0)]]
