"""Kernels #1 and #2 at their main-path shapes, two checkouts in turns on
one card.

Each run is a fresh process in one checkout that builds
``abft_matmul.cu`` and ``abft_matmul_acc.cu``, then times eager calls with
the 50 MB L2 flushed (``chip_smoke.time_ms``):

  * kernel #2, the SUMMA step C_out = C_in + A @ B at 3000^3 (the
    benchmark's blocks, fp32) and 3072^3 on its planned tile (fp32, bf16,
    int8), C_in and the state from a first call, with ``torch.addmm`` on
    the same inputs as the yardstick (fp32 also with verify off); where a
    checkout splits fp32 operands into 3xTF32 planes (``tf32_planes``),
    the kernel is timed on planes split once and the split beside it, and
    each fp32 row records the mainloop that ran and the split's launches;
    fp32 also in place and back to back, as the SUMMA launches it (device
    time of 10 launches between two events, no flush);
  * kernel #1 at the SUMMA step's shape (the same product without the
    prologue);
  * both at k = 32, one ring stage: a tile's fixed cost (prologue,
    epilogue, the ring's fill) alone;
  * kernel #1 at the training shapes (m = 2048; fp32) and a prefill shape
    (m = 1024, bf16), with ``torch.matmul``.

Every case is also held against its plain version (|err| within
chip_smoke.py's RTOL, int8 exact, else inf), so a broken build shows.
The runs go in the order base, this, this, base (``--rounds`` times the
middle pair) and print one JSON line each with the card's name and power
limit, and the registers and spills ptxas reports for the tensor-core
kernels.  Needs one CUDA card:

    git archive <commit> | tar -x -C build/ab_base
    python3 tools/torch_gemm_ab.py --base build/ab_base \\
        --out build/gemm_ab.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUN = r"""
import json, sys
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels import build
if sys.argv[1] == "build":
    build.compile_all([s for s in ("abft_matmul", "abft_matmul_acc",
                                   "tf32_split") if s in build.SOURCES])
    # ptxas on the tensor-core kernels: registers and spills
    lines = []
    for entry in build.BUILD_LOG.values():
        log = entry["log"].splitlines()
        for i, ln in enumerate(log):
            if "Compiling entry" in ln and "mma_kernel" in ln:
                lines.append(ln.split("'")[1][-60:] + " | "
                             + " ".join(x.strip() for x in log[i + 2:i + 4]))
    print("PTXAS " + json.dumps(lines))
    sys.exit(0)
import chip_smoke as cs
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ops

g = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
reps = 10
out = {}

def rnd(shape, dt):
    if dt == torch.int8:
        return torch.randint(-8, 9, shape, generator=g, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=g, device="cuda").to(dt)

def err(x, ref, exact):
    if exact:
        return 0.0 if torch.equal(x, ref) else float("inf")
    x, ref = x.double(), ref.double()
    ok = cs.within(x, ref, float(ref.abs().max()))
    return float((x - ref).abs().max()) if ok else float("inf")

def back_to_back_ms(fn, n=10):
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n

for m, k, n, name in ((3000, 3000, 3000, "float32"),
                      (3072, 3072, 3072, "float32"),
                      (3072, 3072, 3072, "bfloat16"),
                      (3072, 3072, 3072, "int8"), (3072, 32, 3072, "float32")):
    dt = getattr(torch, name)
    pk = dict(in_dtype=dt, out_bytes=4, carry=True)
    plan = (ops.pick_blocks(m, k, n, require_exact=True, **pk)
            or ops.pick_blocks(m, k, n, **pk))
    kw = dict(bm=plan.bm, bn=plan.bn, eps_c=ops.detection_eps(torch.float32))
    wm = ops.kernel_weights(m, device="cuda")
    wn = ops.kernel_weights(n, device="cuda").T.contiguous()
    ot = torch.int32 if dt == torch.int8 else torch.float32
    c0 = torch.zeros((m, n), dtype=ot, device="cuda")
    st0 = cs.acc_zero_state(torch, m, n, plan.bm, plan.bn)
    a0, b0 = rnd((m, k), dt), rnd((k, n), dt)
    a, b = rnd((m, k), dt), rnd((k, n), dt)
    c1, ccol1, crow1, _ = kmm.abft_matmul_acc_cuda(a0, b0, c0, *st0, wm, wn,
                                                   **kw)
    got = kmm.abft_matmul_acc_cuda(a, b, c1, ccol1, crow1, wm, wn, **kw)
    want = kmm.abft_matmul_acc_plain(a, b, c1, ccol1, crow1, wm, wn, **kw)
    row = dict(tile=[plan.bm, plan.bn], route=plan.route,
               mainloop=kmm.last_acc_route.get(
                   "mainloop", "ring" if plan.route == "mma" else "cuda_core"),
               err=err(got[0], want[0], dt == torch.int8),
               clean_residual=float(got[3][..., 4:6].abs().max()))
    split = hasattr(kmm, "tf32_planes") and row["mainloop"] == "wgmma"
    if split:
        s0 = kmm.acc_split_launches
        kw["planes"] = kmm.tf32_planes(a, b)
        row["split_launches"] = kmm.acc_split_launches - s0
        row["split_ms"] = cs.time_ms(torch, lambda: kmm.tf32_planes(a, b),
                                     reps, flush)
    row["ms"] = cs.time_ms(torch, lambda: kmm.abft_matmul_acc_cuda(
        a, b, c1, ccol1, crow1, wm, wn, **kw), reps, flush)
    if dt == torch.float32 and k > 32:
        ins = (c1.clone(), ccol1.clone(), crow1.clone())
        row["in_place_back_to_back_ms"] = back_to_back_ms(
            lambda: kmm.abft_matmul_acc_cuda(a, b, *ins, wm, wn, out=ins,
                                             **kw))
    if dt != torch.int8:
        c1l = c1.to(dt)
        row["addmm_ms"] = cs.time_ms(torch, lambda: torch.addmm(c1l, a, b),
                                     reps, flush)
    if k > 32 and dt == torch.float32:
        # the same step with verify off: what the prologue's checks cost
        row["noverify_ms"] = cs.time_ms(
            torch, lambda: kmm.abft_matmul_acc_cuda(
                a, b, c1, ccol1, crow1, wm, wn, verify=False, **kw),
            reps, flush)
    out[f"acc {m}x{k}x{n} {name}"] = row
    del a0, b0, a, b, c0, c1, got, want

from repro_torch.core.abft_gemm import _residual_weights
for m, k, n, name in ((3072, 3072, 3072, "float32"),
                      (3072, 32, 3072, "float32"),
                      (2048, 896, 4866, "float32"),
                      (2048, 4864, 898, "float32"),
                      (1024, 896, 4866, "bfloat16")):
    dt = getattr(torch, name)
    a = torch.randn((m, k), generator=g, device="cuda").to(dt)
    b = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(dt)
    wm = ops.kernel_weights(m, device="cuda")
    wn = _residual_weights(n - 2, 2, 17, "cuda:0")
    plan = ops.pick_blocks(m, k, n, in_dtype=dt, out_bytes=4, f=2)
    kw = dict(bm=plan.bm, bn=plan.bn, bk=plan.bk, out_dtype=torch.float32)
    c = kmm.abft_matmul_cuda(a, b, wm, wn, **kw)[0]
    cp = kmm.abft_matmul_plain(a, b, wm, wn, **kw)[0]
    row = dict(tile=[plan.bm, plan.bn], route=plan.route,
               err=err(c, cp, False))
    row["ms"] = cs.time_ms(
        torch, lambda: kmm.abft_matmul_cuda(a, b, wm, wn, **kw), reps, flush)
    row["matmul_ms"] = cs.time_ms(torch, lambda: torch.matmul(a, b), reps,
                                  flush)
    out[f"oneshot {m}x{k}x{n} {name}"] = row
print("AB " + json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the middle pair of runs of this checkout")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    base = pathlib.Path(args.base).resolve()
    order = ([("base", base)] + [("this", ROOT)] * (2 * args.rounds)
             + [("base", base)])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # both builds at once, one process a checkout; a checkout that does
    # not build or run is reported and the other goes on
    procs = {str(tree): subprocess.Popen(
        [sys.executable, "-c", RUN, "build"], cwd=tree,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tree in (base, ROOT)}
    failed, ptxas = {}, {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            failed[key] = f"build failed:\n{err[-3000:]}"
        for ln in out.splitlines():
            if ln.startswith("PTXAS "):
                ptxas[key] = json.loads(ln[6:])
    runs = []
    for label, tree in order:
        key = str(tree)
        row = dict(run=label, card=smi, ptxas=ptxas.get(key, []))
        if key not in failed:
            try:
                proc = subprocess.run([sys.executable, "-c", RUN, "time"],
                                      cwd=tree, capture_output=True,
                                      text=True, timeout=600)
            except subprocess.TimeoutExpired as exc:
                proc = subprocess.CompletedProcess(exc.cmd, -9, "",
                                                   "timed out after 600 s")
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("AB ")]
            if proc.returncode == 0 and lines:
                row["cases"] = json.loads(lines[-1][3:])
            else:
                failed[key] = f"run failed ({proc.returncode}):\n" \
                              f"{proc.stderr[-3000:]}"
        if key in failed:
            row["error"] = failed[key]
        runs.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(runs, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
