"""Fault-tolerant training entry point: the training CLI of the port.

Trains an LM with seeded random weights on the deterministic synthetic
data stream, with AdamW, microbatching, per-block activation checkpointing
at full width, ABFT-protected projections (``--abft``: on the GPU kernel
#1, with its gradient), diskless checkpoints of the whole train state over
``p = 4`` logical shards (the encode is kernel #3 on the GPU), disk
checkpoints with resume, and failure injection with diskless recovery (the
paper's stress test as a flag).  It runs on the GPU unless ``--device cpu``
is given; with no GPU it raises rather than falling back.  ``--smoke`` (the
default) trains the reduced config; ``--full`` trains the model at its
published width.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 12 --batch 8 --seq 32 --inject-failures 1 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 30 \
      --abft verify --inject-failures 2
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.ckpt.disk import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.ft.runtime import (FTPolicy, FTRuntime, stack_view,
                                    unstack_view)
from repro_torch.launch.serve import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import StepOptions, build_train_step, init_state

__all__ = ["TrainResult", "run", "main"]

P_LOGICAL = 4   # logical DP shards the state is checksummed over


@dataclasses.dataclass
class TrainResult:
    """What a run leaves: the loss of every step run (replays included),
    the step index of each, the final state, the FT runtime (its
    ``recoveries``, ``timings`` and diskless checkpoint) and the host wall
    of every train step (device synchronized)."""
    losses: List[float]
    steps: List[int]
    state: dict
    ft: FTRuntime
    step_walls: List[float]
    resumed_from: Optional[int] = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, smoke: bool = True, steps: int = 100, batch: int = 16,
        seq: int = 128, microbatches: int = 1, abft_mode: str = "off",
        inject_failures: int = 0, ckpt_dir: Optional[str] = None,
        resume: bool = False, log_every: int = 10, lr: float = 3e-4,
        seed: int = 0, diskless_every: int = 10,
        total_steps: Optional[int] = None,
        device: str = "cuda") -> TrainResult:
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeConfig("cli", seq, batch, "train")
    opts = StepOptions(microbatches=microbatches, abft_mode=abft_mode,
                       remat=not smoke)
    total = total_steps or steps   # schedule horizon (resume consistency)
    adamw = AdamWConfig(lr=lr, total_steps=total,
                        warmup_steps=max(total // 20, 1))
    step_fn = build_train_step(cfg, shape, adamw, opts)
    state = init_state(torch.Generator(device=dev).manual_seed(seed), cfg)

    data_cfg = DataConfig(cfg.vocab_size, seq, batch, seed=seed)
    start_step = 0
    resumed_from = None
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and manager and manager.latest_step() is not None:
        latest = manager.latest_step()
        state = manager.restore(latest, state)
        start_step = int(manager.aux(latest).get("data_step", latest))
        resumed_from = latest
        print(f"[train] resumed from step {latest}")
    pipe = DataPipeline(data_cfg, start_step=start_step)

    # the FT runtime over a p-way logical shard view of the state (the DP
    # stacking is simulated on one device with p = 4 logical shards)
    p = P_LOGICAL
    ft = FTRuntime(p, FTPolicy(diskless_every=diskless_every,
                               disk_every=max(steps // 4, 25)),
                   injector=FailureInjector(FailurePlan.random(
                       inject_failures, steps, p, seed))
                   if inject_failures else None,
                   ckpt_manager=manager)

    losses: List[float] = []
    ran: List[int] = []
    walls: List[float] = []
    t0 = time.time()
    i = start_step
    try:
        while i < steps:
            # diskless / disk checkpoint cadence over the stacked view,
            # built only when one is due
            ft.maybe_checkpoint(i, lambda: stack_view(state, p),
                                aux={"data_step": i})

            failed = ft.injector.check(i) if ft.injector else None
            if failed is not None:
                stacked = FailureInjector.damage(stack_view(state, p),
                                                 failed, p)
                stacked = ft.recover(stacked, [failed])
                state = unstack_view(stacked, state)
                rollback = ft.diskless.step if ft.diskless.step is not None \
                    else i
                print(f"[train] step {i}: shard {failed} lost; diskless "
                      f"recovery -> rollback to step {rollback}")
                i = rollback   # the deterministic data stream replays exactly

            _sync(dev)
            ts = time.perf_counter()
            state, metrics = step_fn(state, pipe.batch_at(i))
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - ts)
            ran.append(i)
            if i % log_every == 0:
                print(f"[train] step {i:5d} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({(time.time() - t0) / len(ran):.2f}s/step)")
            i += 1
    finally:
        pipe.close()
    if manager:
        manager.save(steps, state, aux={"data_step": steps}, blocking=True)
    if losses:
        print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
              f"recoveries={ft.recoveries}")
    return TrainResult(losses=losses, steps=ran, state=state, ft=ft,
                       step_walls=walls, resumed_from=resumed_from)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="train the model at its published width")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--abft", default="off",
                    choices=["off", "checksum", "verify", "correct"])
    ap.add_argument("--inject-failures", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    # the reference's pod-loss drill flags: the elastic runtime is not
    # ported yet
    ap.add_argument("--kill-pod-at-step", type=int, default=None)
    ap.add_argument("--regrow-at-step", type=int, default=None)
    ap.add_argument("--drill-mesh", default=None)
    ap.add_argument("--drill-json", default=None)
    args = ap.parse_args(argv)
    drill = {"--kill-pod-at-step": args.kill_pod_at_step,
             "--regrow-at-step": args.regrow_at_step,
             "--drill-mesh": args.drill_mesh,
             "--drill-json": args.drill_json}
    given = [k for k, v in drill.items() if v is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: the pod-loss drill (ElasticRuntime) comes "
            "with the distribution + elastic-FT slice of ROADMAP.md")
    run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, microbatches=args.microbatches, abft_mode=args.abft,
        inject_failures=args.inject_failures, ckpt_dir=args.ckpt_dir,
        resume=args.resume, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
