"""Kernel #4 (the checked flash-attention forward) at its main shapes, two
checkouts in turns on one card.

Each run is a fresh process in one checkout that builds
``flash_attention.cu``, then times eager calls with the 50 MB L2 flushed
(``chip_smoke.time_ms``):

  * Qwen2-0.5B's attention, 4 x 14 heads, S 4096, D 64, causal, in fp32 and
    bf16, plain and checked, with ``scaled_dot_product_attention`` in the
    same dtype as the yardstick (PyTorch's own kernels, used nowhere in the
    port);
  * Gemma2-2B's local attention, 2 x 8 heads, S 8192, D 256, window 4096,
    softcap 50, bf16, checked.

Every case is also held against its plain version (``chip_smoke.
flash_close``: |err| if within, else inf), so a broken build shows, and
records the route and tile the wrapper reports (where the checkout has
them).  The runs go in the order base, this, this, base (``--rounds``
times the middle pair) and print one JSON line each with the card's name
and power limit, and the registers and spills ptxas reports for each
instantiation of the kernel.  Needs one CUDA card:

    git archive <commit> | tar -x -C build/ab_base
    python3 tools/torch_flash_ab.py --base build/ab_base \\
        --out build/flash_ab.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUN = r"""
import json, re, sys
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels import build
if sys.argv[1] == "build":
    build.compile_all(("flash_attention",))
    # ptxas on each instantiation: registers and spills
    lines = []
    log = build.BUILD_LOG["flash_attention"]["log"].splitlines()
    for i, ln in enumerate(log):
        if "Compiling entry" in ln and "flash_kernel" in ln:
            args = re.search(r"flash_kernelI(.*?)EEv", ln)
            info = [x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            lines.append((args.group(1) if args else ln[-40:]) + " | "
                         + "; ".join(info))
    print("PTXAS " + json.dumps(lines))
    sys.exit(0)
import torch.nn.functional as tnf
import chip_smoke as cs
from repro_torch.kernels import flash_attention as kfa

g = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
reps = 10
out = {}
for what, bh, s, d, name, window, softcap, checked in (
        ("qwen2-0.5b", 56, 4096, 64, "float32", None, None, False),
        ("qwen2-0.5b", 56, 4096, 64, "float32", None, None, True),
        ("qwen2-0.5b", 56, 4096, 64, "bfloat16", None, None, False),
        ("qwen2-0.5b", 56, 4096, 64, "bfloat16", None, None, True),
        ("gemma2-2b local", 16, 8192, 256, "bfloat16", 4096, 50.0, True)):
    dt = getattr(torch, name)
    q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda").to(dt)
               for _ in range(3))
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap,
              bq=256, bk=256, checksum=checked)
    got = kfa.flash_attention_cuda(q, k, v, **kw)
    route = dict(getattr(kfa, "last_route", {}))
    want = kfa.flash_attention_plain(q, k, v, **kw)
    o, po = (got[0], want[0]) if checked else (got, want)
    ok = bool(torch.isfinite(o).all()) and cs.flash_close(torch, o, po, name)
    row = dict(err=float((o.double() - po.double()).abs().max()) if ok
               else float("inf"), route=route.get("route"),
               tile=list(route["tile"]) if "tile" in route else None)
    del got, want, o, po
    row["ms"] = cs.time_ms(torch, lambda: kfa.flash_attention_cuda(
        q, k, v, **kw), reps, flush)
    if window is None and not checked:
        # on [1, BH, S, D]: SDPA's fused kernels take 4-D inputs
        row["sdpa_ms"] = cs.time_ms(
            torch, lambda: tnf.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                scale=d ** -0.5), reps, flush)
    out[f"{what} {name}" + (" checked" if checked else "")] = row
    del q, k, v
    torch.cuda.empty_cache()
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
