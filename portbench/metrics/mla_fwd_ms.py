"""The latent attention's forward, in device ms a step: the program's
``attn/mla`` spans of every layer (its four checked projections, the
latent's norm, RoPE and the chunked attention), timed by CUDA events on
the device's stream (obs.cuda); the median over the window's steps.  None
where the program records no such span."""
from portbench.metrics._moonlight_spans import device_ms_per_step


def read(ctx):
    if ctx.record.get("kind") != "products":
        return None
    return device_ms_per_step(ctx.record, ("attn/mla",))
