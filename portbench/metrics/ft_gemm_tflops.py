"""The data product's FLOPs (2 M N K of the unencoded A and B) of every
checked product of the window, over the window, in TFLOP/s."""


def read(ctx):
    r = ctx.record
    if r.get("kind") != "products" or not r["product_s"]:
        return None
    return len(r["product_s"]) * r["data_flops"] / r["window_s"] / 1e12
