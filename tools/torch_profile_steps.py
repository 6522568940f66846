"""Where the port's training step and serving run spend their device time.

Traces the device's activity (``torch.profiler`` with CUDA activity only:
recording every host op as well slows the host, which these paths are
bound by, about threefold) over three training steps of Qwen2-0.5B at
full width (batch 16 x seq 128, ABFT verify, remat, fp32 kernel operands:
the step phase 9 of chip_smoke.py times), after three warm-up steps and
three timed without the trace, and over a serving run of 8 requests
(chip_smoke.py's phase-5 prompt lengths, 32 tokens each, 4 slots, ABFT
verify) from the end of its warm-up.  For each it prints one JSON line:
the wall, the union of the device's kernel and copy intervals (busy) and
the idle share of the wall, the device time by group (kernel #1 to #4,
library GEMMs, copies, everything else) and the kernels that take the
most, with their launch counts.  It then times the host's issue of one call
at a decode shape (4 x 896 x 4866, fp32): kernel #1's wrapper, the
dispatcher ``ops.abft_matmul`` that the model calls, and ``torch.matmul``.
``--families`` instead profiles a served config at its published width
and depth in bf16 (``--arch``, one that fits the card: Qwen3-30B-A3B by
default): the device over a serving run of 4 requests from the end of its
warm-up, then two decode steps with host activity too: the host ops that
take the most self time, and the synchronizing calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, device-to-host
copies).  Needs one CUDA card:

    python3 tools/torch_profile_steps.py --out build/profile_steps.json
    python3 tools/torch_profile_steps.py --families \
        --arch qwen3-moe-30b-a3b --out build/profile_families.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _whole(*names):
    """A kernel's name, matched whole as ``portbench/harness/trace.py``'s
    readers match it: ``mma_kernel`` (kernel #1) is not the tail of
    ``acc_mma_kernel`` (kernel #2)."""
    return re.compile(r"(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])"
                      % "|".join(names))


GROUPS = (                       # (group, pattern searched in a kernel's name)
    ("kernel1_abft_matmul", _whole("mma_kernel", "splitk_partial",
                                   "splitk_epilogue")),
    ("kernel2_abft_matmul_acc", _whole("abft_matmul_acc_kernel",
                                       "acc_mma_kernel")),
    ("kernel3_checksum_encode", _whole("checksum_encode_kernel")),
    ("kernel4_flash", _whole("flash_kernel")),
    # library kernels and copies by parts of their names
    ("library_gemm", re.compile("gemm|cutlass|xmma|cublas", re.I)),
    ("copies", re.compile("memcpy|memset", re.I)),
)


def group_of(name: str) -> str:
    for group, rx in GROUPS:
        if rx.search(name):
            return group
    return "other"


def summarize(torch, prof, wall_s: float, per: int) -> dict:
    """Device intervals of a trace: busy union, idle share, ms by group
    and the top kernels, each divided by ``per`` (steps or runs)."""
    from torch.autograd import DeviceType
    spans, by_group, by_name, calls = [], {}, {}, {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        if t1 <= t0:
            continue
        spans.append((t0, t1))
        ms = (t1 - t0) / 1e3
        by_group[group_of(ev.name)] = by_group.get(group_of(ev.name), 0) + ms
        by_name[ev.name] = by_name.get(ev.name, 0) + ms
        calls[ev.name] = calls.get(ev.name, 0) + 1
    spans.sort()
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    busy_ms = busy / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        wall_ms=1e3 * wall_s / per, device_busy_ms=busy_ms / per,
        # no device event means the trace saw no device time, not an idle
        # card
        idle_share=1 - busy_ms / (1e3 * wall_s) if spans else None,
        device_events=len(spans),
        group_ms={g: v / per for g, v in sorted(by_group.items())},
        top_kernels=[dict(name=n[:120], ms=v / per, launches=calls[n] / per,
                          us_each=1e3 * v / calls[n]) for n, v in top])


def profile_train(torch, steps: int = 3, warm: int = 3) -> dict:
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (StepOptions, build_train_step,
                                        init_state)
    cfg = get_config("qwen2-0.5b")
    step_fn = build_train_step(
        cfg, ShapeConfig("cli", 128, 16, "train"),
        AdamWConfig(lr=3e-4, total_steps=warm + 2 * steps, warmup_steps=1),
        StepOptions(abft_mode="verify", remat=True))
    state = init_state(torch.Generator(device="cuda").manual_seed(0), cfg)
    pipe = DataPipeline(DataConfig(cfg.vocab_size, 128, 16, seed=0))
    try:
        for i in range(warm):
            state, metrics = step_fn(state, pipe.batch_at(i))
            float(metrics["loss"])
        torch.cuda.synchronize()

        def timed(i):
            nonlocal state
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pipe.batch_at(i))
            float(metrics["loss"])          # the step ends on the host
            return time.perf_counter() - t0

        untraced = [timed(i) for i in range(warm, warm + steps)]
        with _trace(torch) as prof:
            walls = [timed(i) for i in range(warm + steps, warm + 2 * steps)]
    finally:
        pipe.close()
    out = summarize(torch, prof, sum(walls), steps)
    out.update(step_walls_s=walls, untraced_step_walls_s=untraced)
    return out


def _trace(torch):
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def profile_serve(torch) -> dict:
    import numpy as np
    from repro_torch.launch.serve import run as serve
    rs = np.random.RandomState(0)
    lens = rs.randint(16, 1001, size=8)
    lens[rs.randint(8)] = 1000
    prof = _trace(torch)
    t = {}

    def start(_engine):
        torch.cuda.synchronize()
        prof.start()
        t["t0"] = time.perf_counter()

    def run(on_warm=None):
        _, eng = serve("qwen2-0.5b", smoke=False, requests=8, slots=4,
                       prompt_lens=lens.tolist(), gen=32, abft_mode="verify",
                       kernel_dtype="fp32", device="cuda", on_warm=on_warm,
                       verbose=False)
        torch.cuda.synchronize()
        return eng.stats.summary()

    untraced = run()
    stats = run(start)
    wall = time.perf_counter() - t["t0"]
    prof.stop()
    out = summarize(torch, prof, wall, 1)
    out.update(decode_step_ms=stats["clean_step_ms"],
               ttft_ms=stats["ttft_ms"],
               untraced_decode_step_ms=untraced["clean_step_ms"],
               untraced_ttft_ms=untraced["ttft_ms"])
    return out


def host_issue(torch) -> dict:
    """Host microseconds to issue one call at a decode shape (no sync in
    the loop: the device runs each call faster than the host issues it)."""
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = 4, 896, 4866
    a = torch.randn((m, k), generator=g, device="cuda")
    b = torch.randn((k, n), generator=g, device="cuda")
    wm = ops.kernel_weights(m, device="cuda")
    wn = ops.kernel_weights(n, device="cuda").T.contiguous()
    plan = ops.pick_blocks(m, k, n)
    calls = {
        "kernel1_wrapper": lambda: kmm.abft_matmul_cuda(
            a, b, wm, wn, bm=plan.bm, bn=plan.bn, bk=plan.bk,
            splits=plan.splits),
        "ops_abft_matmul": lambda: ops.abft_matmul(a, b, wm=wm, wn=wn),
        "torch_matmul": lambda: torch.matmul(a, b),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        reps = 300
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[name] = dict(issue_us=1e6 * (t1 - t0) / reps,
                         until_done_us=1e6 * (t2 - t0) / reps)
    return out


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy", "cudaEventSynchronize")


def profile_families(torch, arch: str) -> dict:
    from repro_torch.launch.serve import run as serve
    from repro_torch.serve.engine import Request
    prof = _trace(torch)
    t = {}

    def start(_engine):
        torch.cuda.synchronize()
        prof.start()
        t["t0"] = time.perf_counter()

    lens = [37, 77, 100, 123]
    _, eng = serve(arch, smoke=False, requests=4, slots=4, prompt_lens=lens,
                   gen=8, abft_mode="verify", kernel_dtype="bf16",
                   device="cuda", on_warm=start, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t["t0"]
    prof.stop()
    stats = eng.stats.summary()
    out = summarize(torch, prof, wall, 1)
    out.update(arch=arch, layers=eng.cfg.n_layers,
               decode_step_ms=stats["clean_step_ms"],
               prefill_ms=1e3 * stats["prefill_s"] / max(stats["prefills"],
                                                          1))
    # two decode steps with the host's ops recorded as well
    eng.reset()
    for i, n in enumerate(lens):
        eng.submit(Request(rid=i, prompt=[1] * n, max_new_tokens=8))
    eng._admit()
    eng._step([])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as hp:
        t0 = time.perf_counter()
        for _ in range(2):
            eng._step([])
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
    rows = sorted(hp.key_averages(), key=lambda e: -e.self_cpu_time_total)
    out["traced_steps_ms"] = 1e3 * host_wall / 2
    out["host_top"] = [dict(name=e.key, calls=e.count // 2,
                            self_cpu_ms=e.self_cpu_time_total / 2e3)
                       for e in rows[:25]]
    out["syncs"] = {e.key: e.count // 2 for e in rows
                    if any(e.key.startswith(c) for c in SYNC_CALLS)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--families", action="store_true",
                    help="profile a served config (--arch) instead")
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(card=smi)
    jobs = (("host_issue", host_issue), ("train", profile_train),
            ("serve", profile_serve))
    if args.families:
        jobs = (("families", lambda t: profile_families(t, args.arch)),)
    for name, fn in jobs:
        res[name] = fn(torch)
        print(json.dumps({name: res[name]}), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
