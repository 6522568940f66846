"""Fault-campaign CLI: sweep a declarative FaultSpace, emit the coverage
matrix.

The campaign runs every spec and every multi-fault episode of the chosen
space against live workloads (an `ElasticRuntime` train loop and a drilled
`ServeEngine` on one device, and the kernel and layer drills), classifies
each event as detected / corrected / absorbed / missed / false-alarm, and
writes the machine-readable artifact (``--json``) plus a rendered markdown
matrix on stdout.  It runs on the GPU unless ``--device cpu`` is given;
with no GPU it raises rather than falling back.  Specs and episodes that
need more than one device (pod faults) or a runtime the port has not
brought up yet (solver, traffic) are reported as ``skipped`` rows naming
the slice they wait for.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.chaos --space default \\
      --workload both --json chaos.json
  PYTHONPATH=src python -m repro_torch.launch.chaos --device cpu \\
      --space smoke --workload train

  # re-run a recorded campaign exactly (same kinds, targets, seeds)
  PYTHONPATH=src python -m repro_torch.launch.chaos --replay CAMPAIGN.json

``--check`` exits non-zero when any fault went missed, a clean sweep
raised a false alarm, a spec or episode was skipped, an episode's joint
outcome fell short of ``corrected``, or the uncovered-surface ledger is
not empty: the reference's gate, unchanged.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.chaos.campaign import CampaignRunner, TrainConfig
from repro_torch.chaos.faults import Episode, FaultSpace, FaultSpec

WORKLOAD_SETS = {
    "train": ("train",),
    "serve": ("serve",),
    "solver": ("solver",),
    "traffic": ("traffic",),
    "both": ("train", "serve"),
    # "all" stays {train, serve, solver}, as in the reference: traffic runs
    # against its own space
    "all": ("train", "serve", "solver"),
}


def space_from_artifact(d: dict) -> FaultSpace:
    """Rebuild the FaultSpace a campaign artifact recorded (the
    ``--replay`` path): standalone specs through `FaultSpec.from_dict`,
    episodes (skipped ones included) through `Episode.from_dict`;
    per-event episode rows ride their episode and clean sweeps carry no
    spec."""
    specs, eps, seen = [], [], set()
    for ev in d["events"]:
        if ev.get("spec") is None or ev.get("kind") == "clean_sweep":
            continue
        if ev.get("kind") == "episode":
            eps.append(Episode.from_dict(ev["spec"]))
        elif ev.get("episode"):
            continue
        else:
            sp = FaultSpec.from_dict(ev["spec"])
            if sp.name not in seen:
                seen.add(sp.name)
                specs.append(sp)
    return FaultSpace(f"replay:{d.get('space', '?')}", tuple(specs),
                      episodes=tuple(eps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--space", default="default",
                    choices=("default", "smoke", "cartesian",
                             "episodes-default", "episodes-smoke",
                             "traffic-smoke"),
                    help="which FaultSpace to sweep")
    ap.add_argument("--replay", metavar="CAMPAIGN.json", default=None,
                    help="re-run the exact specs + episodes a previous "
                         "campaign artifact recorded (overrides --space)")
    ap.add_argument("--workload", default="all",
                    choices=sorted(WORKLOAD_SETS))
    ap.add_argument("--sample", type=int, default=None, metavar="N",
                    help="seeded without-replacement subsample of the space")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for --sample")
    ap.add_argument("--steps", type=int, default=None,
                    help="override train workload steps")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable campaign artifact")
    ap.add_argument("--markdown", metavar="PATH", default=None,
                    help="also write the rendered matrix to a file")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on ANY missed fault / false alarms / a "
                         "non-empty uncovered ledger / skipped specs or "
                         "episodes / episodes short of corrected")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the drills run: cuda (the default; raises "
                         "without a GPU) or cpu")
    args = ap.parse_args(argv)

    if args.replay:
        with open(args.replay) as fh:
            space = space_from_artifact(json.load(fh))
    else:
        space = {
            "default": FaultSpace.default,
            "smoke": FaultSpace.smoke,
            "cartesian": FaultSpace.cartesian,
            "episodes-default": FaultSpace.episodes_default,
            "episodes-smoke": FaultSpace.episodes_smoke,
            "traffic-smoke": FaultSpace.traffic_smoke,
        }[args.space]()
    if args.sample is not None:
        space = space.sample(args.sample, seed=args.seed)
    workloads = WORKLOAD_SETS[args.workload]
    train = TrainConfig() if args.steps is None else TrainConfig(
        steps=args.steps)
    runner = CampaignRunner(space, train=train, verbose=not args.quiet,
                            device=args.device)
    res = runner.run(workloads)
    md = res.markdown()
    print(md)
    if args.markdown:
        with open(args.markdown, "w") as fh:
            fh.write(md)
    d = res.to_dict()
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(d, fh, indent=1, sort_keys=False)
        print(f"[chaos] artifact -> {args.json}", file=sys.stderr)

    summ = d["summary"]
    eps = d["episodes"]
    bad = []
    if summ["missed_anywhere"]:
        bad.append(f"missed faults: {summ['missed_anywhere']}")
    if summ["false_alarms"]:
        bad.append(f"false alarms: {summ['false_alarms']}")
    if d["uncovered_surfaces"]:
        bad.append("uncovered-surface ledger is no longer empty: "
                   + str([r["surface"] for r in d["uncovered_surfaces"]]))
    if eps["not_corrected"]:
        bad.append("episodes short of corrected: "
                   + str(eps["not_corrected"]))
    if args.check and summ["by_outcome"].get("skipped"):
        bad.append(f"{summ['by_outcome']['skipped']} event(s) skipped "
                   "(need more devices?)")
    if bad:
        print("[chaos] GATE FAILED: " + "; ".join(bad), file=sys.stderr)
        if args.check:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
