"""Telemetry-bus CLI: record a drilled serving run, render recorded runs.

The counterpart of the reference package's ``repro/launch/obs.py``.
``record`` drives the traffic drill (the SAME open-loop Zipf trace
replayed clean and under four faults — two mid-decode SDCs on the logits
reduction, two page-granular DRAM flips in the paged KV pools) with the
``repro_torch.obs`` bus enabled, folds the event stream into full fault
lifecycles (inject -> detect -> rung -> repair -> bit-identity verdict)
and the per-rung MTTR timeline with the compile/warm split, measures the
bus's own overhead (obs on vs off over replays of the clean trace,
switched interval by interval between decode steps), and
writes the artifact (the schema of the reference's ``OBS_PR10.json``)
plus optional JSONL / Perfetto / Prometheus views.  It runs on the GPU
unless ``--device cpu`` is given; with no GPU it raises rather than
falling back:

  PYTHONPATH=src python -m repro_torch.launch.obs record --json obs.json \\
      --perfetto obs_trace.json --check
  PYTHONPATH=src python -m repro_torch.launch.obs record --device cpu

``render`` regenerates the exporter views from a recorded run — either a
raw event JSONL (``--jsonl`` from record) or a record artifact (re-emits
its embedded Perfetto document):

  PYTHONPATH=src python -m repro_torch.launch.obs render obs_events.jsonl \\
      --perfetto trace.json

Load the Perfetto JSON at https://ui.perfetto.dev (or chrome://tracing).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from repro_torch import obs

SCHEMA = "repro.obs.pr10/v1"

#: record --check bound on the bus's own cost: obs on vs off over the
#: identical clean trace (intervals switched in turns, see `_overhead`).
OVERHEAD_BUDGET_PCT = 2.0


# ---------------------------------------------------------------------
# record
# ---------------------------------------------------------------------

def _build_engine(cfg, params, n_open, sdc=None):
    from repro_torch.serve.engine import PagedServeEngine
    from repro_torch.serve.scheduler import SchedPolicy, SLOScheduler

    page_size = 8
    eng = PagedServeEngine(
        cfg, params, slots=4, max_len=64, page_size=page_size,
        chunk_prefill=2 * page_size, prefix_cache=True,
        scrub_every=1, abft_reduce="correct", sdc=sdc,
        scheduler=SLOScheduler(SchedPolicy(max_queue=4 * n_open)))
    eng.warm(prompt_len=8, decode_steps=2)
    eng.reset()
    return eng


def _overhead(build, trace, repeats: int = 16) -> dict:
    """The bus's cost on the identical clean replay, over ``repeats``
    replays.  A replay is cut at its decode steps (`run_trace`'s
    ``on_step``) into intervals: its head up to the first step, one
    interval a step (the step and the next admission), and its tail after
    the last step.  The bus is switched off, on, on, off, ... interval by
    interval, and every other replay takes the opposite settings, so each
    interval of the trace is timed as often on as off.  The overhead is
    the summed on intervals over the summed off intervals: every
    interval's cost counts, as in a whole replay, and intervals a few
    milliseconds apart see the same host, so its drift cancels.  Whole
    replays of this trace swing by 10 % and more from one to the next on a
    shared host, which puts the reference's min-of-3 replays off, then 3
    on, far outside a 2 % budget either way (-12 % and +43 % on one H100
    host for the same code).  The median ratio of adjacent on/off pairs
    rides along as a diagnostic."""
    from repro_torch.serve.traffic import run_trace

    on_s = off_s = 0.0
    ratios = []
    for rep in range(repeats):
        obs.reset_all()
        obs.enable(False)
        shift = 2 * (rep % 2)

        def setting(j, shift=shift):
            return (j + shift) % 4 in (1, 2)

        eng = build()
        marks = [time.perf_counter()]

        def switch(eng, step):
            marks.append(time.perf_counter())
            obs.enable(setting(len(marks) - 1))

        obs.enable(setting(0))
        run_trace(eng, trace, on_step=switch)
        marks.append(time.perf_counter())
        spans = [(t1 - t0, setting(j))
                 for j, (t0, t1) in enumerate(zip(marks, marks[1:]))]
        for d, flag in spans:
            if flag:
                on_s += d
            else:
                off_s += d
        for (da, fa), (db, _) in zip(spans[0::2], spans[1::2]):
            ratios.append(da / db if fa else db / da)
    obs.enable(False)
    obs.reset_all()
    return {
        "method": "replays cut at their decode steps, the bus switched in "
                  "pairs of intervals and reversed every other replay; "
                  "summed on over summed off",
        "repeats": repeats,
        "pairs": len(ratios),
        "obs_on_s": on_s,
        "obs_off_s": off_s,
        "overhead_pct": 100.0 * (on_s / off_s - 1.0),
        "median_pair_pct": 100.0 * (statistics.median(ratios) - 1.0),
        "budget_pct": OVERHEAD_BUDGET_PCT,
    }


def record(n_open: int = 24, device: str = "cuda") -> dict:
    """The drilled traffic run with the bus on -> the artifact, on
    ``device`` with seeded random smoke-size weights."""
    import torch
    from repro_torch.configs.base import smoke_config
    from repro_torch.ft.failures import SDCInjector, SDCPlan
    from repro_torch.launch.serve import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.serve.traffic import (TrafficConfig, compare,
                                           make_trace, run_trace)

    dev = resolve_device(device)
    cfg = smoke_config("qwen2-0.5b")
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    trace_cfg = TrafficConfig(
        n_requests=n_open, vocab=cfg.vocab_size, arrival="open",
        rate_per_step=0.6, prompt_max=24, out_max=8,
        shared_prefix_len=16, seed=9)
    trace = make_trace(trace_cfg)
    build = lambda sdc=None: _build_engine(cfg, params, n_open, sdc=sdc)

    # clean replay: golden token streams + the executed-step schedule
    # (open-loop idle gaps fast-forward the clock, so fault steps are
    # drawn from steps that actually run)
    obs.enable(False)
    seen = []
    rep_clean = run_trace(build(), trace,
                          on_step=lambda e, s: seen.append(s))
    assert len(seen) > 8, "trace too short to schedule the drill"
    sdc_steps = (seen[len(seen) // 3], seen[len(seen) // 2])
    dram_steps = [seen[2 * len(seen) // 3], seen[(5 * len(seen)) // 6]]

    overhead = _overhead(build, trace)

    # --- the drilled replay, recorded ---------------------------------
    obs.reset_all()
    obs.enable(True)
    injected = {"count": 0}

    def dram_hook(eng, step):
        if step in dram_steps and injected["count"] < len(dram_steps):
            live = eng.kv.live_pages()
            if not live:
                return
            key = next(iter(eng.kv.pools))
            phys = live[injected["count"] % len(live)]
            eng.kv.corrupt_page(key, phys)
            obs.event("fault/inject", step=step,
                      surface="serve.paged_kv/page", kind="dram_page",
                      leaf=key, page=phys)
            injected["count"] += 1

    sdc = SDCInjector(SDCPlan(tuple((s, 0, 1e4) for s in sdc_steps)))
    rep_fault = run_trace(build(sdc=sdc), trace, on_step=dram_hook)
    identical = rep_clean.outputs == rep_fault.outputs
    # close each lifecycle with the end-state verdict (FIFO pairing:
    # oldest lifecycle without a verdict takes the next one)
    for _ in range(len(sdc_steps) + injected["count"]):
        obs.event("fault/verdict",
                  verdict="bit_identical" if identical else "diverged")

    evs = obs.events()
    obs.enable(False)
    lcs = obs.lifecycles(evs)
    complete = [lc for lc in lcs if lc["complete"]]
    slo = compare(rep_clean, rep_fault,
                  expected_faults=len(sdc_steps) + injected["count"])
    perfetto = obs.export.to_perfetto(evs)
    return {
        "schema": SCHEMA,
        "config": {"traffic": vars(trace_cfg).copy(),
                   "sdc_steps": list(sdc_steps),
                   "dram_steps": list(dram_steps),
                   "backend": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else dev.type)},
        "n_events": len(evs),
        "dropped_events": obs.dropped(),
        "n_lifecycles": len(lcs),
        "n_complete_lifecycles": len(complete),
        "lifecycles": lcs,
        "rung_timeline": obs.rung_timeline(evs),
        "slo_under_fault": slo,
        "overhead": overhead,
        "metrics_prometheus": obs.export.to_prometheus(),
        "perfetto": perfetto,
        "_events": evs,          # stripped before json.dump; JSONL source
    }


def check(r: dict) -> None:
    """The obs-smoke gate over a record() artifact."""
    tl = r["rung_timeline"]
    assert r["dropped_events"] == 0, \
        f"{r['dropped_events']} events dropped (buffer too small?)"
    assert r["n_complete_lifecycles"] >= 4, \
        f"only {r['n_complete_lifecycles']} complete fault lifecycles"
    assert tl, "empty rung timeline"
    assert any(v["warm"]["n"] for v in tl.values()), \
        "no warm recovery samples in the rung timeline"
    assert r["slo_under_fault"]["faults_missed"] == 0, \
        f"missed faults: {r['slo_under_fault']}"
    assert r["slo_under_fault"]["token_streams_identical"], \
        "drilled token streams diverged from the clean replay"
    for lc in r["lifecycles"]:
        if lc["complete"]:
            assert lc["verdict"] is not None and \
                lc["verdict"]["verdict"] == "bit_identical", \
                f"lifecycle verdict not bit_identical: {lc}"
    obs.export.validate_perfetto(r["perfetto"])
    ov = r["overhead"]
    assert ov["overhead_pct"] < ov["budget_pct"], \
        f"obs overhead {ov['overhead_pct']:.2f}% over " \
        f"{ov['budget_pct']:.1f}% budget"
    print(f"obs gate OK: {r['n_complete_lifecycles']} lifecycles, "
          f"{len(tl)} rungs, 0 dropped, "
          f"overhead {ov['overhead_pct']:+.2f}%")


# ---------------------------------------------------------------------
# render
# ---------------------------------------------------------------------

def _load_events(path: str):
    """Events from a record() JSONL or a record() artifact."""
    if path.endswith(".jsonl"):
        return obs.export.read_jsonl(path), None
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA:
        raise SystemExit(f"{path}: not a {SCHEMA} artifact "
                         f"(schema={doc.get('schema')!r})")
    return None, doc


def _summary(evs, doc) -> str:
    if doc is not None:
        tl, lcs = doc["rung_timeline"], doc["lifecycles"]
        n = doc["n_events"]
    else:
        tl, lcs = obs.rung_timeline(evs), obs.lifecycles(evs)
        n = len(evs)
    lines = [f"{n} events, {sum(1 for c in lcs if c['complete'])}/"
             f"{len(lcs)} complete fault lifecycles", "",
             "| rung | n | warm mean | warm p95 | first-trace mean | "
             "compile |", "|---|---|---|---|---|---|"]

    def ms(x):
        return f"{x * 1e3:.2f}ms" if x is not None else "—"

    for rung in sorted(tl):
        d = tl[rung]
        lines.append(
            f"| {rung} | {d['n']} | {ms(d['warm']['mean_s'])} | "
            f"{ms(d['warm']['p95_s'])} | "
            f"{ms(d['first_trace']['mean_s'])} | {ms(d['compile_s'])} |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_rec = sub.add_parser("record", help="drilled traffic run, bus on")
    p_rec.add_argument("--json", metavar="PATH", default=None,
                       help="write the artifact (OBS_PR10.json's schema)")
    p_rec.add_argument("--jsonl", metavar="PATH", default=None,
                       help="write the raw event log (render input)")
    p_rec.add_argument("--perfetto", metavar="PATH", default=None,
                       help="write the Chrome/Perfetto trace JSON")
    p_rec.add_argument("--prom", metavar="PATH", default=None,
                       help="write the Prometheus text snapshot")
    p_rec.add_argument("--requests", type=int, default=24)
    p_rec.add_argument("--check", action="store_true",
                       help="gate: >=4 lifecycles, 0 dropped, overhead")
    p_rec.add_argument("--device", default="cuda",
                       help="where the drill runs: cuda (the default; "
                            "raises without a GPU) or cpu")

    p_ren = sub.add_parser("render", help="views from a recorded run")
    p_ren.add_argument("input", help="event JSONL or a record() artifact")
    p_ren.add_argument("--perfetto", metavar="PATH", default=None)
    p_ren.add_argument("--prom", metavar="PATH", default=None,
                       help="artifact input only: re-emit its snapshot")
    args = parser.parse_args(argv)

    if args.cmd == "record":
        r = record(n_open=args.requests, device=args.device)
        evs = r.pop("_events")
        if args.jsonl:
            obs.export.write_jsonl(args.jsonl, evs)
            print(f"wrote {args.jsonl}")
        if args.perfetto:
            with open(args.perfetto, "w") as fh:
                json.dump(r["perfetto"], fh)
            print(f"wrote {args.perfetto}")
        if args.prom:
            with open(args.prom, "w") as fh:
                fh.write(r["metrics_prometheus"])
            print(f"wrote {args.prom}")
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(r, fh, indent=1, sort_keys=True)
            print(f"wrote {args.json}")
        print(_summary(evs, r))
        if args.check:
            check(r)
        return

    evs, doc = _load_events(args.input)
    if args.perfetto:
        pf = doc["perfetto"] if doc is not None else \
            obs.export.to_perfetto(evs)
        obs.export.validate_perfetto(pf)
        with open(args.perfetto, "w") as fh:
            json.dump(pf, fh)
        print(f"wrote {args.perfetto}")
    if args.prom:
        if doc is None:
            raise SystemExit("--prom needs a record() artifact input (a "
                             "raw event log carries no metrics snapshot)")
        with open(args.prom, "w") as fh:
            fh.write(doc["metrics_prometheus"])
        print(f"wrote {args.prom}")
    print(_summary(evs, doc))


if __name__ == "__main__":
    sys.exit(main())
