"""The port's serving decode step and training step, two checkouts in turns.

Runs the same serving and training work in a checkout given with
``--base`` and in this one, in the order base, this, this, base, each in
a fresh process on the same card: Qwen2-0.5B at full width, 8 requests
(chip_smoke.py's phase-5 prompt lengths, 32 tokens each, 4 slots, ABFT
verify, fp32 kernel operands), then 12 training steps at batch 16 x seq
128 with ABFT verify and a diskless encode every 5 steps.  Prints one
JSON line per run: the mean decode step and time to first token (the
engine's own stats) and the median training step wall (steps 1-11).
Each checkout builds its own kernels at first use.  Needs one CUDA card:

    git archive <commit> | tar -x -C build/ab_base
    python3 tools/torch_step_ab.py --base build/ab_base --out build/step_ab.json
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
import numpy as np
import torch
sys.path.insert(0, "src")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.launch import train
from repro_torch.launch.serve import run as serve
rs = np.random.RandomState(0)
lens = rs.randint(16, 1001, size=8)
lens[rs.randint(8)] = 1000
_, eng = serve("qwen2-0.5b", smoke=False, requests=8, slots=4,
               prompt_lens=lens.tolist(), gen=32, abft_mode="verify",
               kernel_dtype="fp32", device="cuda", verbose=False)
s = eng.stats.summary()
del eng
torch.cuda.empty_cache()
res = train.run("qwen2-0.5b", smoke=False, steps=12, batch=16, seq=128,
                abft_mode="verify", diskless_every=5, log_every=100,
                device="cuda")
w = sorted(res.step_walls[1:])
print("AB " + json.dumps(dict(decode_step_ms=s["clean_step_ms"],
                              ttft_ms=s["ttft_ms"],
                              train_median_s=w[len(w) // 2])))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other checkout")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    base = pathlib.Path(args.base).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    runs = []
    for label, tree in (("base", base), ("this", ROOT), ("this", ROOT),
                        ("base", base)):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{label} run in {tree} failed "
                               f"({proc.returncode}):\n{proc.stderr[-3000:]}")
        row = dict(tree=label, card=smi, **json.loads(lines[-1][3:]))
        runs.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
