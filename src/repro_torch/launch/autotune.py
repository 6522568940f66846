"""Autotune-cache pre-warm CLI: measure ABFT-GEMM tilings once, persist.

Runs the measured autotuner (``kernels.autotune``) over a shape x dtype
grid of the one-shot family (kernel #1) and persists the winners to the
cache, so that later runs (serving engines, training, the SUMMA) resolve
plans with ZERO measurements.  The warm/cold split is observable:
``--json`` reports the measurement counter, and a second (warm)
invocation measures nothing.  Plans are keyed by
``{device}/{acc|one}/f{f}/{in_dtype}->{out_dtype}/{m}x{k}x{n}``, so a
cache warmed on one card kind never serves another.

Usage:
  # warm the default cache (~/.cache/repro_torch/autotune.json)
  PYTHONPATH=src python -m repro_torch.launch.autotune --shapes bench

  # the smoke set into an explicit cache, machine-readable summary
  PYTHONPATH=src python -m repro_torch.launch.autotune --shapes smoke \\
      --cache /tmp/at.json --json /tmp/warm.json

  # custom shapes and dtypes
  PYTHONPATH=src python -m repro_torch.launch.autotune \\
      --shape 1024x896x898 --shape 4x4864x898 --dtypes float32,bfloat16

It runs on the card (``--device cuda``, the default); ``--device cpu``
times the accumulate family's PyTorch twin instead.

Counterpart of the reference package's ``repro/launch/autotune.py``.
"""
from __future__ import annotations

import argparse
import json
import sys

SHAPE_SETS = {
    "smoke": [(256, 256, 256)],
    "bench": [(256, 256, 256), (256, 512, 384), (512, 512, 512),
              (1024, 1024, 1024)],
}
DTYPES = ("float32", "bfloat16", "int8")


def _parse_shape(s: str):
    try:
        m, k, n = (int(p) for p in s.lower().split("x"))
        return m, k, n
    except ValueError:
        raise SystemExit(f"bad --shape {s!r}: want MxKxN, e.g. 512x512x512")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="pre-warm the ABFT-GEMM autotune cache")
    ap.add_argument("--shapes", choices=sorted(SHAPE_SETS), default=None,
                    help="named shape set")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="MxKxN", help="explicit shape (repeatable)")
    ap.add_argument("--dtypes", default="float32,bfloat16,int8",
                    help="comma-separated input dtypes")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: REPRO_TORCH_AUTOTUNE_CACHE "
                         "or ~/.cache/repro_torch/autotune.json)")
    ap.add_argument("--top-k", type=int, default=4,
                    help="measured candidates per shape (model plan incl.)")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed repetitions per candidate (best-of)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write a machine-readable warm summary")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import autotune as at
    from repro_torch.launch.serve import resolve_device

    device = resolve_device(args.device)
    shapes = [_parse_shape(s) for s in args.shape]
    if args.shapes:
        shapes += SHAPE_SETS[args.shapes]
    if not shapes:
        shapes = SHAPE_SETS["smoke"]
    dtypes = [d.strip() for d in args.dtypes.split(",") if d.strip()]
    for d in dtypes:
        if d not in DTYPES:
            raise SystemExit(f"unknown dtype {d!r}: pick from {DTYPES}")

    at.reset_stats()
    rows = []
    for (m, k, n) in shapes:
        for d in dtypes:
            in_dtype = getattr(torch, d)
            out_dtype = torch.int32 if d == "int8" else torch.float32
            plan, info = at.autotune(
                m, k, n, in_dtype=in_dtype, out_dtype=out_dtype,
                top_k=args.top_k, reps=args.reps, cache=args.cache,
                device=device)
            blocks = f"{plan.bm}x{plan.bn}x{plan.bk}"
            mb = info["model_blocks"]
            model_us = info["measured_us"].get(
                f"{mb[0]}x{mb[1]}x{mb[2]}") if mb else None
            rows.append(dict(key=info["key"], source=info["source"],
                             blocks=blocks, route=plan.route,
                             best_us=info.get("best_us"),
                             model_us=model_us,
                             measured_us=info["measured_us"],
                             persisted=info.get("persisted", False)))
            print(f"{info['key']}: {info['source']} -> {blocks} "
                  f"({plan.route})"
                  + (f" ({info['best_us']:.0f}us)"
                     if info.get("best_us") is not None else ""))

    st = at.stats()
    summary = dict(device=at.device_kind(device),
                   cache=str(args.cache or at.cache_path()),
                   measurements=st["measurements"],
                   cache_hits=st["cache_hits"], plans=rows)
    print(f"measurements={st['measurements']} cache_hits={st['cache_hits']} "
          f"cache={summary['cache']}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
