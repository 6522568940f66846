"""The chunked FA-2 attention (``models/attention.py::_sdpa_flash``) at
Moonlight-16B-A3B's latent-attention shape, two checkouts in turns on one
card.

One process loads both checkouts' ``models/attention.py`` (each by its
path; what they import comes from this checkout's package) and times, on
q [1, 8192, 16, 1, 192], k [1, 8192, 16, 192], v [1, 8192, 16, 128] in
fp32, causal, chunks of 512:

  * the forward alone (inputs that need no gradient), and
  * the forward and the backward (``o.backward(do)``),

each the median of ``--reps`` calls timed by CUDA events, in the order
base, this, this, base (``--rounds`` times).  A checkout whose
``_sdpa_flash`` takes ``aligned`` gets True, as the layers give it where
they build the positions themselves.  It also prints how far
this checkout's o, dq, dk and dv lie from the base's (largest difference
over the base's largest magnitude), the peak memory of each side's forward
and backward, and the card's name and power limit.  Needs one CUDA card:

    git archive <commit> | tar -x -C build/ab_base
    python3 tools/torch_mla_chunks_ab.py --base build/ab_base \\
        --out build/mla_chunks_ab.json
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = {
        "base": _load(args.base / "src/repro_torch/models/attention.py",
                      "base_attention"),
        "this": _load(ROOT / "src/repro_torch/models/attention.py",
                      "this_attention")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    s, h, dqk, dv = 8192, 16, 192, 128
    q = torch.randn(1, s, h, 1, dqk, generator=gen, device="cuda")
    k = torch.randn(1, s, h, dqk, generator=gen, device="cuda")
    v = torch.randn(1, s, h, dv, generator=gen, device="cuda")
    do = torch.randn(1, s, h, 1, dv, generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda")

    def call(side, grad):
        fn = mods[side]._sdpa_flash
        kw = dict(scale=dqk ** -0.5, softcap=None, q_pos=pos, k_pos=pos,
                  causal=True, window=None, kc=512)
        if "aligned" in inspect.signature(fn).parameters:
            kw["aligned"] = True
        live = [x.detach().requires_grad_(grad) for x in (q, k, v)]
        o = fn(*live, **kw)
        if grad:
            o.backward(do)
        return o, [x.grad for x in live]

    def timed(side, grad):
        ms = []
        for _ in range(args.reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call(side, grad)
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        return statistics.median(ms)

    outs, peak = {}, {}
    for side in mods:                    # warm, and the numbers compared
        torch.cuda.reset_peak_memory_stats()
        o, grads = call(side, True)
        torch.cuda.synchronize()
        peak[side] = torch.cuda.max_memory_allocated() / 1e9
        outs[side] = [o.detach()] + grads
    rel = {name: float((a - b).abs().max() / b.abs().max())
           for name, a, b in zip(("o", "dq", "dk", "dv"), outs["this"],
                                 outs["base"])}
    del outs
    rows = []
    for r in range(args.rounds):
        for side in ("base", "this", "this", "base"):
            rows.append(dict(round=r, side=side,
                             fwd_ms=timed(side, False),
                             fwd_bwd_ms=timed(side, True)))
            print(json.dumps(rows[-1]), flush=True)
    summary = {
        side: {key: statistics.median(x[key] for x in rows
                                      if x["side"] == side)
               for key in ("fwd_ms", "fwd_bwd_ms")} for side in mods}
    result = dict(card=_card(), shape=[1, s, h, dqk, dv], kc=512,
                  rel_this_vs_base=rel, peak_gb=peak, median=summary,
                  rows=rows)
    print(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
