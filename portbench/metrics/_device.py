"""The device's idle share, shared by the device_idle readers: the share
of the traced window in which no operation ran on the device, in %."""


def idle_share(ctx):
    t = ctx.trace
    if t is None or not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
