"""The training step's share of the TF32 peak: the model FLOPs of the
window's steps (6 N T for the active weights and causal attention's
score and value products, metrics/_moonlight_work.py) over the window, over
the published peak, in %.  At five layers the output head is 14 % of the
checked FLOPs, more than in the whole model."""
from portbench.harness.stats import peak


def read(ctx):
    r = ctx.record
    pk = peak(ctx, "tf32_flops_per_s")
    if r.get("kind") != "products" or "model_flops" not in r \
            or not r["product_s"] or pk is None:
        return None
    return 100.0 * len(r["product_s"]) * r["model_flops"] / r["window_s"] / pk
