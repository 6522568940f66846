"""Kernel #2's launch path (kernels/ops.py::abft_matmul_acc,
kernels/abft_matmul.py::abft_matmul_acc_cuda): the host's time in the
program's ``summa/update`` spans of the window, each of which issues one
SUMMA step's G^2 launches, over the launches they count, in us a launch.
Read from the program's bus (harness/spans.py); None where the program
records no such span.  Read under the profiler, whose cost a launch is
part of the reading."""
from portbench.harness.spans import window_spans
from portbench.metrics._summa_spans import launch_us


def read(ctx):
    r = ctx.record
    if r.get("kind") != "products":
        return None
    spans = window_spans(r["t_start"], r["t_end"])
    return None if spans is None else launch_us(spans)
