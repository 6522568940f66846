"""The share of the traced window in which no operation ran on the
device, in % (see _device.py)."""
from portbench.metrics._device import idle_share


def read(ctx):
    return idle_share(ctx)
