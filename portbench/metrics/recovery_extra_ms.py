"""What a fault adds to a product: the median time of the window's
faulted products (a loss, two losses or a flip) minus the median of its
clean ones, on the harness's clock (device synchronized)."""
from portbench.harness.stats import median


def read(ctx):
    r = ctx.record
    if r.get("kind") != "products":
        return None
    bad = [t for t, k in zip(r["product_s"], r["faults"]) if k != "none"]
    good = [t for t, k in zip(r["product_s"], r["faults"]) if k == "none"]
    if not bad or not good:
        return None
    return 1e3 * (median(bad) - median(good))
