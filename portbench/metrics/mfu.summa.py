"""The whole product's share of the TF32 peak: ft_gemm_tflops over the
published peak, in %."""
from portbench.harness.stats import peak


def read(ctx):
    r = ctx.record
    pk = peak(ctx, "tf32_flops_per_s")
    if r.get("kind") != "products" or not r["product_s"] or pk is None:
        return None
    return 100.0 * len(r["product_s"]) * r["data_flops"] / r["window_s"] / pk
