"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by the names in BENCHMARK.json: the cell's
configuration is its ``file``, the traffic mix is
``portbench/traffic/<traffic>.json``, each metric is read by
``portbench/metrics/<name>.py`` and the system the configuration names
(its ``system`` key) is driven by ``portbench/systems/<system>.py``.  This
file holds no code of its own for any cell.

A run: check for the cards the cell asks for, set up (load or build the
kernels, make the inputs on the device from the seed, warm the cell's
shapes), measure for ``--seconds`` (with ``--trace 1`` under the device
profiler), read the peak memory, free the program's state, compare what
the window produced with the plain reference, make sure no JAX module was
loaded, and print the result as the last line of standard output, the
compared numbers beside their limits as the last lines of standard error.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.

``--device cpu`` (tests only) skips the look for a card and runs the rest
on the CPU; ``--control`` puts the reference, one precision down, in the
program's place (the control that the limits are set against).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_loaded() -> list:
    """Top-level names, compared whole, of loaded JAX modules or of the JAX
    package (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, kind: str, cell: str) -> list:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def device_info(torch, device: str, chips: int) -> dict:
    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips,
                memory_peak_bytes=max(torch.cuda.max_memory_allocated(i)
                                      for i in range(chips)))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--control", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        log(f"the program (src/repro_torch) is not in {ROOT}")
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    # every build and kernel cache inside the checkout, at a fixed path
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    log(f"torch imported at {time.perf_counter() - T_PROCESS:.3f} s")
    if args.device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            log(f"needs {cell['chips']} CUDA card(s); found {found}")
            return 3
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # one process, one host thread for PyTorch's CPU ops: the host
        # issues the work, and a pool of spinning threads only contends
        torch.set_num_threads(1)
    from portbench.harness.trace import DeviceTrace, Phases

    system = importlib.import_module(f"portbench.systems.{config['system']}")
    run = system.System(config, mix, args.seed, args.device, log,
                        control=args.control)
    run.setup()
    setup_s = time.perf_counter() - T_PROCESS
    log(f"set-up {setup_s:.3f} s; {power_limit()}")

    phases = Phases()
    trace = DeviceTrace(torch) if args.trace and args.device == "cuda" \
        else None
    if trace is not None:
        trace.start()
    record = run.window(args.seconds, phases)
    if trace is not None:
        trace.stop()
    if args.device == "cuda":
        torch.cuda.synchronize()
    device = device_info(torch, args.device, cell["chips"])
    run.release()

    ctx = types.SimpleNamespace(
        record=record, config=config, mix=mix, cell=cell, trace=trace,
        setup_s=setup_s, device_kind=device["kind"],
        peaks=json.loads((HERE / "peaks.json").read_text()))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, kind, cell["name"]):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    checks = run.check()
    log(f"comparison with the reference: "
        f"{time.perf_counter() - t_check:.3f} s")
    # last, so that what the readers and the reference load counts too
    bad = forbidden_loaded()
    if bad:
        log(f"modules of JAX or of the JAX package were loaded: {bad}")
        return 4
    correct = all(v <= lim for _, v, lim in checks)
    out = dict(correct=correct, attempted=record["attempted"],
               failed=record["failed"], metrics=metrics, device=device)
    if trace is not None:
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        out["breakdown"] = dict(device_ops=trace.top_ops(10),
                                idle_gaps=trace.idle_gaps(phases, 10))
    # a value past any float (nothing compared, a NaN) is printed as a string
    out["checks"] = {n: {"value": v if v < float("inf") else str(v),
                         "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
