"""Where a cell's time goes inside the port's fault-tolerant SUMMA: the
program's own spans (``repro_torch.obs``) over a benchmark window, timed on
the device as well as on the host, joined to the device trace.

    python3 tools/summa_spans.py --workload summa-g8-nloc3000.kill-flip \
        --seed 4200000123 --seconds 20 --overhead 8 --out spans.json

Runs the cell as ``portbench/run.py`` does (its configuration, mix, seed
and ``System``, set-up and warm-up included), then one window with the bus
recording, the CUDA clock installed (``repro_torch.obs.cuda``) and the
device traced (``portbench/harness/trace.py``).  It reports:

  * the device's idle time by the harness's label and the innermost
    program span open on the host at each gap's middle
    (``portbench/harness/spans.py::idle_by_span``), and the share of the
    idle time inside ``abft_summa`` that no span below the root names;
  * per span name: count a product, host and device time a product, over
    all products and by the fault each faced, with the idle time inside
    each kind's spans;
  * the readings ``kernel2_launch_us`` (host time of the ``summa/update``
    spans over their launches), ``summa_scrub_ms`` (median device time of
    a product's scrub), ``summa_recover_line_ms`` and
    ``summa_rederive_ms`` (median over products that lost processes of
    their summed device time), beside the run's ``recovery_extra_ms``;
  * the check of the device clock against the profiler: the summed
    device time of the ``summa/update`` spans against kernel #2's device
    time in the trace and the idle time put inside those spans;
  * with ``--overhead N``: N blocks of four untraced products, each block
    the cell's first product (``System.window`` over a window that closes
    after one product: the same operands and fault every time) with the
    bus off, off again (the method's noise), on with the host clock alone,
    and on with the device clock, in an order that turns from block to
    block; the summed time of each setting over the off setting's; and the
    host's cost of one bus call.

Needs one CUDA card.  Prints one JSON line and writes it to ``--out``.
The traced window repeats what ``portbench/run.py --trace 1`` cannot read
yet (the device clock, idle gaps named by program spans); it goes once the
benchmark itself installs the device clock, and the ``--overhead`` mode
stays.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]

SETTINGS = ("off", "off2", "host", "device")
ONE_PRODUCT = 1e-9    # a window this short closes after its first product


def log(msg: str):
    print(f"[summa_spans] {msg}", file=sys.stderr, flush=True)


def cell_files(workload: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return config, mix


def set_bus(obs, obs_cuda, setting: str):
    obs.enable(not setting.startswith("off"))
    if setting == "device":
        obs_cuda.install()
    else:
        obs_cuda.uninstall()


def by_name(spans, n_products: int) -> dict:
    """Per span name: count, host seconds and device seconds (where
    timed), each a product."""
    out = {}
    for s in spans:
        d = out.setdefault(s.name, dict(n=0, host_ms=0.0, device_ms=None))
        d["n"] += 1
        d["host_ms"] += 1e3 * (s.end - s.start)
        if "device_s" in s.attrs:
            d["device_ms"] = (d["device_ms"] or 0.0) + 1e3 * s.attrs[
                "device_s"]
    for d in out.values():
        for k in ("n", "host_ms", "device_ms"):
            if d[k] is not None:
                d[k] /= n_products
    return out


def traced_window(torch, run, seconds: float, obs, obs_cuda) -> dict:
    from portbench.harness import spans as hs
    from portbench.harness.trace import DeviceTrace, Phases
    from portbench.metrics import _summa_spans as ss
    from portbench.run import load_reader

    obs.reset()
    set_bus(obs, obs_cuda, "device")
    phases = Phases()
    trace = DeviceTrace(torch)
    trace.start()
    record = run.window(seconds, phases)
    trace.stop()
    torch.cuda.synchronize()
    set_bus(obs, obs_cuda, "off")
    spans = hs.window_spans(record["t_start"], record["t_end"]) or []
    n = len(record["product_s"])
    gaps = hs.idle_by_span(trace, phases, spans, k=40)
    inside = sum(v for lab, v in gaps if lab.split(">")[0] == "abft_summa")
    root_own = sum(v for lab, v in gaps
                   if lab in ("abft_summa", "abft_summa>summa/abft_summa"))
    ups = [s for s in spans if s.name == "summa/update"]
    up_dev = sum(s.attrs.get("device_s", 0.0) for s in ups)
    k2_pattern = r"(?<![A-Za-z0-9_])(abft_matmul_acc_kernel|acc_mma_kernel)" \
                 r"(?![A-Za-z0-9_])"
    k2 = trace.seconds_matching(k2_pattern) or 0.0
    up_idle = sum(v for lab, v in gaps if lab.endswith(">summa/update"))
    loss = ("kill", "kill2")
    ctx = types.SimpleNamespace(record=record)
    groups = {}
    for members in ss.products(spans).values():
        root = next(s for s in members if s.name == ss.ROOT)
        groups.setdefault(root.attrs.get("fault"), []).append(
            (root, members))
    per_fault = {}
    for fault, prods in sorted(groups.items()):
        flat = [s for _, members in prods for s in members]
        per_fault[fault] = dict(
            n=len(prods),
            root_host_ms=statistics.median(
                1e3 * (r.end - r.start) for r, _ in prods),
            root_device_ms=statistics.median(
                1e3 * r.attrs.get("device_s", float("nan"))
                for r, _ in prods),
            spans=by_name(flat, len(prods)),
            idle_ms={lab: 1e3 * v / len(prods) for lab, v in
                     hs.idle_by_span(trace, phases, flat, k=40)
                     if ">" in lab})
    return dict(
        products=n, window_s=trace.window_s, busy_s=trace.busy_s(),
        idle_s=trace.window_s - trace.busy_s(),
        idle_pct=100.0 * (1.0 - trace.busy_s() / trace.window_s),
        idle_gaps=gaps, idle_in_abft_summa_s=inside,
        idle_on_root_own_s=root_own,
        idle_on_root_own_pct=100.0 * root_own / inside if inside else None,
        readings=dict(
            kernel2_launch_us=ss.launch_us(spans),
            summa_scrub_ms=ss.device_ms_per_product(spans, "summa/scrub"),
            summa_recover_line_ms=ss.device_ms_per_product(
                spans, "summa/recover_line", faults=loss),
            summa_rederive_ms=ss.device_ms_per_product(
                spans, "summa/rederive_state", faults=loss),
            recovery_extra_ms=load_reader("recovery_extra_ms")(ctx)),
        clock_check=dict(
            update_device_s=up_dev, kernel2_trace_s=k2,
            idle_in_update_s=up_idle,
            holds=k2 * 0.98 <= up_dev <= (k2 + up_idle) * 1.02),
        per_fault=per_fault,
        spans=by_name(spans, n),
        host_reads_per_product=sum(s.attrs.get("host_reads", 0)
                                   for s in spans) / max(n, 1),
        top_ops=trace.top_ops(12),
        dropped=obs.dropped())


def overhead(torch, run, blocks: int, obs, obs_cuda) -> dict:
    """Blocks of four products, one a setting (``off`` twice: the second,
    ``off2``, gives the method's own noise), each the cell's first product
    timed by ``System.window``, the order turning through the four
    rotations of the settings and their reverses from block to block."""
    from portbench.harness.trace import Phases

    rot = [SETTINGS[i:] + SETTINGS[:i] for i in range(len(SETTINGS))]
    orders = rot + [o[::-1] for o in rot]
    total = {k: 0.0 for k in SETTINGS}
    ratios = {k: [] for k in SETTINGS[1:]}
    for j in range(blocks):
        t = {}
        for setting in orders[j % len(orders)]:
            set_bus(obs, obs_cuda, setting)
            record = run.window(ONE_PRODUCT, Phases())
            t[setting], = record["product_s"]
        set_bus(obs, obs_cuda, "off")
        obs.resolve_device()
        obs.reset()
        for k in SETTINGS:
            total[k] += t[k]
        for k in SETTINGS[1:]:
            ratios[k].append(t[k] / t["off"])
    return dict(
        blocks=blocks, seconds=total,
        overhead_pct={k: 100.0 * (total[k] / total["off"] - 1.0)
                      for k in SETTINGS[1:]},
        pair_quartiles_pct={k: [100.0 * (q - 1.0) for q in
                                statistics.quantiles(v, n=4)]
                            for k, v in ratios.items()})


def bus_call_us(obs, obs_cuda, n: int = 20000) -> dict:
    """Host microseconds of one bus call, averaged over ``n``: an empty
    span off, on and on with a device-timed span, and a tally on."""
    out = {}
    for setting, device in (("off", False), ("host", False),
                            ("device", True)):
        set_bus(obs, obs_cuda, setting)
        obs.reset()
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("probe", device=device):
                pass
        out[f"span_{setting}"] = 1e6 * (time.perf_counter() - t0) / n
    set_bus(obs, obs_cuda, "host")
    with obs.span("probe"):
        t0 = time.perf_counter()
        for _ in range(n):
            obs.tally("host_reads")
        out["tally_host"] = 1e6 * (time.perf_counter() - t0) / n
    set_bus(obs, obs_cuda, "off")
    obs.resolve_device()
    obs.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--overhead", type=int, default=0,
                    help="blocks of four products (off, off again, host "
                    "clock, device clock) for the cost of tracing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    from repro_torch import obs
    from repro_torch.obs import cuda as obs_cuda
    from portbench.run import power_limit
    from portbench.systems.ft_summa import System

    config, mix = cell_files(args.workload)
    run = System(config, mix, args.seed, "cuda", log)
    run.setup()
    out = dict(workload=args.workload, seed=args.seed, block=config["block"],
               card=power_limit())
    out["traced"] = traced_window(torch, run, args.seconds, obs, obs_cuda)
    if args.overhead:
        out["overhead"] = overhead(torch, run, args.overhead, obs, obs_cuda)
        out["bus_call_us"] = bus_call_us(obs, obs_cuda)
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
