"""Kernel #2 (kernels/csrc/abft_matmul_acc.cu, both routes) against its
roofline.  Work: every product of the traced window makes G^3 rank-kb
updates C[mb, nb] += A[mb, kb] @ B[kb, nb] of the encoded blocks (fp32
operands, C read and written).  Least time: the larger of the FLOPs over
the TF32 peak and the bytes over the bandwidth; over the device time of
the kernel's launches in the trace."""
from portbench.harness.stats import gemm_work, roofline_share

PATTERN = r"(?<![A-Za-z0-9_])(abft_matmul_acc_kernel|acc_mma_kernel)" \
          r"(?![A-Za-z0-9_])"


def read(ctx):
    r = ctx.record
    if r.get("kind") != "products" or not r["product_s"]:
        return None
    nb, g = r["block"], r["grid"]
    fl, by = gemm_work(nb, nb, nb, 4, 4, acc=True)
    n = len(r["product_s"]) * g ** 3
    return roofline_share(ctx, n * fl, n * by, PATTERN, "tf32_flops_per_s")
