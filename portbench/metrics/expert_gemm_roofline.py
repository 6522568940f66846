"""Kernel #1g (kernels/csrc/abft_matmul_grouped.cu) against its roofline.
Work: every step of the traced window runs, in each MoE layer, the routed
experts' gate, up and down products of the T k rows (fp32 operands; each
product's rows of X, every expert's weights and Y counted once,
metrics/_moonlight_work.py).  Least time: the larger of the FLOPs over the
TF32 peak and the bytes over the bandwidth; over the device time of the
kernel's launches in the trace."""
from portbench.harness.stats import roofline_share
from portbench.metrics._moonlight_work import expert_work

PATTERN = r"(?<![A-Za-z0-9_])grouped_mma_kernel(?![A-Za-z0-9_])"


def read(ctx):
    r = ctx.record
    if r.get("kind") != "products" or not r["product_s"] \
            or "n_routed_experts" not in ctx.config:
        return None
    fl, by = expert_work(ctx.config, ctx.mix)
    n = len(r["product_s"])
    return roofline_share(ctx, n * fl, n * by, PATTERN, "tf32_flops_per_s")
