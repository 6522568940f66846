"""The share of the traced window in which no operation ran on the device,
in %, leaving out the intervals the run's clock stopped (``paused``: the
compared step's params copied to the host)."""
from portbench.metrics._device import idle_share


def read(ctx):
    t, r = ctx.trace, ctx.record
    if t is None or not t.events or r.get("kind") != "products":
        return None
    cut = [(max(a, t.t0), min(b, t.t1)) for a, b in r.get("paused", ())]
    cut = [(a, b) for a, b in cut if b > a]
    if not cut:
        return idle_share(ctx)
    window = t.window_s - sum(b - a for a, b in cut)
    busy = 0.0
    for a, b in t.busy_intervals():
        busy += b - a
        for c0, c1 in cut:
            busy -= max(0.0, min(b, c1) - max(a, c0))
    return 100.0 * (1.0 - busy / window) if window > 0 else None
