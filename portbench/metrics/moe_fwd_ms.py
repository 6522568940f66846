"""The dropless MoE layers' forward, in device ms a step: the program's
``moe/route``, ``moe/experts`` (kernel #1g's three grouped checked products
and their checks), ``moe/shared`` and ``moe/combine`` spans of every MoE
layer, timed by CUDA events on the device's stream (obs.cuda); the median
over the window's steps.  None where the program records no such span."""
from portbench.metrics._moonlight_spans import device_ms_per_step

NAMES = ("moe/route", "moe/experts", "moe/shared", "moe/combine")


def read(ctx):
    if ctx.record.get("kind") != "products":
        return None
    return device_ms_per_step(ctx.record, NAMES)
