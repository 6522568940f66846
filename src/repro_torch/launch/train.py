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
published width.  ``--arch`` takes every config of the registry, the
port's own (``moonlight-16b-a3b``) included: the MoE configs add their
load-balance loss, weighed by ``--aux-weight`` (Moonlight's sequence-wise
balance loss takes an assumed 1e-4), and Whisper and the vision config
get seeded frame or image embeddings with every batch (their stubbed
front ends' output, drawn from ``--seed`` and the step, so a replay after a
recovery sees the same inputs).

The pod-loss drill (`run_elastic_drill`, ``--kill-pod-at-step``) drives
`ft.runtime.ElasticRuntime` end to end on a logical (pod, data, model)
mesh: shrink onto the survivor mesh at step N (rung 3a through the
diskless checkpoint when the lost shards fit its capacity, else rung 3b
from disk), resume, re-grow at step M, then check step-for-step loss
parity against a survivor-mesh runtime rebuilt from scratch that restores
the same checkpoint.  Every diskless encode runs at p = the DP extent
(kernel #3 on the GPU).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 12 --batch 8 --seq 32 --inject-failures 1 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --drill-mesh 2x2x2 --kill-pod-at-step 3 --regrow-at-step 8 \
      --steps 10 --batch 8 --seq 32 --drill-json drill.json
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 30 \
      --abft verify --inject-failures 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch jamba-1.5-large-398b --steps 4 --batch 4 --seq 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.ckpt.disk import CheckpointManager
from repro_torch.configs.base import (ModelConfig, ShapeConfig, get_config,
                                      list_configs, list_port_configs,
                                      smoke_config)
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.ft.runtime import (ElasticRuntime, FTPolicy, FTRuntime,
                                    stack_view, unstack_view)
from repro_torch.launch.serve import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import StepOptions, build_train_step, init_state

__all__ = ["TrainResult", "run", "run_elastic_drill", "main"]

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


def stub_inputs(cfg: ModelConfig, batch: int, step: int, seed: int,
                device) -> dict:
    """The stubbed front ends' output for one batch: Whisper's frame
    embeddings ``[batch, n_frames, d_model]``, the vision config's image
    embeddings ``[batch, n_img_tokens, d_model]`` (normal, from ``seed``
    and ``step``); nothing for a text-only config."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    for key, n in (("frames", cfg.n_frames if cfg.n_enc_layers else 0),
                   ("img_emb", cfg.n_img_tokens)):
        if n:
            out[key] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                   device=device).to(dt)
    return out


def run(arch: str, *, smoke: bool = True, steps: int = 100, batch: int = 16,
        seq: int = 128, microbatches: int = 1, abft_mode: str = "off",
        inject_failures: int = 0, ckpt_dir: Optional[str] = None,
        resume: bool = False, log_every: int = 10, lr: float = 3e-4,
        seed: int = 0, diskless_every: int = 10,
        total_steps: Optional[int] = None,
        aux_weight: float = StepOptions.aux_weight,
        device: str = "cuda") -> TrainResult:
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeConfig("cli", seq, batch, "train")
    opts = StepOptions(microbatches=microbatches, abft_mode=abft_mode,
                       remat=not smoke, aux_weight=aux_weight)
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
            state, metrics = step_fn(state, {
                **pipe.batch_at(i),
                **stub_inputs(cfg, batch, i, seed, dev)})
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


# ---------------------------------------------------------------------------
# pod-loss drill: shrink -> resume -> re-grow, with a parity reference
# ---------------------------------------------------------------------------


def _link_or_copy(src, dst):
    """A hard link of ``src`` at ``dst``, or a copy where the file system
    has none."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(iv[a.element_size()]), b.view(iv[b.element_size()])
    return bool(torch.equal(a, b))


def _params_parity(a, b):
    """(bit for bit equal, max |a - b|) over two trees' leaves."""
    from repro_torch.tree import tree_leaves
    equal, worst = True, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y.to(x.device)
        equal = equal and x.dtype == y.dtype and _bitwise_equal(x, y)
        if x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return equal, worst


def run_elastic_drill(arch: str = "qwen2-0.5b", *, steps: int = 10,
                      kill_pod_at: int = 4, regrow_at: Optional[int] = None,
                      batch: int = 8, seq: int = 32, mesh_shape=(2, 2, 2),
                      lr: float = 1e-3, seed: int = 0,
                      ckpt_dir: Optional[str] = None,
                      diskless_every: int = 1, disk_every: int = 1,
                      f: int = 1, keep: Optional[int] = None,
                      verbose: bool = True, smoke: bool = True,
                      dtype: Optional[str] = None,
                      device: str = "cuda") -> dict:
    """Drive `ElasticRuntime` through the pod-loss drill.

    Timeline: train on the full ``(pod, data, model)`` logical mesh; at
    step `kill_pod_at` a pod dies -> rung 3 shrinks onto the survivor mesh
    (rollback to the latest checkpoint, re-place params and ZeRO-1 opt
    state, re-split the batch) and replays forward; at `regrow_at` the pod
    returns -> re-grow onto the full mesh, no rollback.

    Afterwards a reference run builds the survivor mesh from scratch,
    restores the pre-kill disk checkpoint at the rollback step and replays
    the post-shrink window: the drilled run must match it step for step
    (bit-identical restored params, equal losses).  Returns a
    JSON-serializable report with the reference's keys: losses of both
    runs, the parity result and the elastic transitions' costs.

    ``smoke=False`` trains the config at its published width; ``f`` is the
    diskless capacity (rung 3a needs the lost pod's shards to fit it);
    ``keep`` bounds the disk checkpoints kept (default: every one; the
    rollback step's is copied aside for the reference at the kill);
    ``dtype`` overrides the config's parameter dtype."""
    if kill_pod_at < 1:
        raise ValueError("need at least one checkpointed step before the "
                         "kill")
    from repro_torch.ckpt.elastic import reshard_restore
    from repro_torch.dist.sharding import Mesh

    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    shape = ShapeConfig("drill", seq, batch, "train")
    adamw = AdamWConfig(lr=lr, total_steps=steps,
                        warmup_steps=max(steps // 10, 1))
    opts = StepOptions(remat=False if smoke else True)
    policy = FTPolicy(diskless_every=diskless_every, disk_every=disk_every,
                      f=f)
    tmp = None
    if ckpt_dir is None:
        tmp = tempfile.TemporaryDirectory()
        ckpt_dir = tmp.name
    try:
        mesh = Mesh(tuple(mesh_shape), ("pod", "data", "model"), dev)
        rt = ElasticRuntime(cfg, shape, mesh, adamw=adamw, opts=opts,
                            policy=policy, device=dev,
                            ckpt_manager=CheckpointManager(
                                ckpt_dir, keep=keep or steps + 1))
        state = rt.init_state(seed)
        losses = {}
        killed = regrown = False
        rollback = None
        shrink_rep = regrow_rep = None
        post_shrink = None
        _sync(dev)
        t_start = time.perf_counter()
        i = 0
        while i < steps:
            if not killed and i == kill_pod_at:
                rt.ckpt.wait()       # the async save for step i-1 must land
                state, rollback, shrink_rep = rt.lose_pod(state)
                killed = True
                # keep the PRE-KILL rollback checkpoint apart: the replay
                # re-saves the same steps, and the parity reference must
                # restore bits the drilled run cannot have rewritten.  A
                # save writes new files and renames them over the old
                # directory, never in place, so hard links hold the old
                # bits without copying them
                src = Path(ckpt_dir) / f"step_{rollback}"
                if not src.exists():
                    raise RuntimeError(
                        f"no disk checkpoint at rollback step {rollback} "
                        "for the parity reference (set disk_every=1)")
                shutil.copytree(src, Path(ckpt_dir) / "ref"
                                / f"step_{rollback}", dirs_exist_ok=True,
                                copy_function=_link_or_copy)
                if verbose:
                    print(f"[drill] step {i}: pod lost -> "
                          f"{shrink_rep.mesh_to} via "
                          f"{shrink_rep.restore_path}, rollback to "
                          f"{rollback}, reshard "
                          f"{shrink_rep.reshard_wall_s * 1e3:.0f}ms, build "
                          f"{shrink_rep.build_s:.2f}s")
                # the restored params: the steps return new tensors, so
                # these stay as restored for the parity check
                post_shrink = state["params"]
                i = rollback          # the deterministic stream replays
                continue
            if killed and not regrown and regrow_at is not None \
                    and i == regrow_at:
                state, regrow_rep = rt.regrow(state, at_step=i)
                regrown = True
                if verbose:
                    print(f"[drill] step {i}: pod returned -> "
                          f"{regrow_rep.mesh_to} (reshard "
                          f"{regrow_rep.reshard_wall_s * 1e3:.0f}ms, step "
                          f"{'reused' if regrow_rep.reused_executable else 'rebuilt'})")
            rt.checkpoint(i, state)
            state, m = rt.train_step(i, state)
            losses[i] = float(m["loss"])
            if verbose and i % max(steps // 10, 1) == 0:
                print(f"[drill] step {i:4d} loss={losses[i]:.4f} "
                      f"mesh={dict(rt.gen.mesh.shape)}")
            i += 1
        drill_wall = time.perf_counter() - t_start
        rt.ckpt.wait()
        recoveries = dict(rt.recoveries)
        step_walls = {"steps": list(rt.step_times),
                      "encode": list(rt.timings["encode"]),
                      "save": list(rt.timings["save"])}
        rt.close()
        del state, rt

        # ---- reference: survivor mesh FROM SCRATCH, restored at the same
        # step from the pre-kill checkpoint
        parity_end = regrow_at if regrown else steps
        ref_losses = {}
        params_bitwise_equal = params_max_abs_diff = None
        if killed:
            ref_mesh = Mesh(tuple(shrink_rep.mesh_to.values()),
                            tuple(shrink_rep.mesh_to.keys()), dev)
            ref_rt = ElasticRuntime(cfg, shape, ref_mesh, adamw=adamw,
                                    opts=opts, policy=policy, device=dev)
            manager = CheckpointManager(str(Path(ckpt_dir) / "ref"))
            ref_state = reshard_restore(manager, rollback,
                                        ref_rt.gen.state_shapes, ref_mesh,
                                        opts, cfg)
            if post_shrink is not None:
                # rung 3a restores through the checksum SOLVE (float
                # arithmetic): near-exact, not bit-exact; quantified
                params_bitwise_equal, params_max_abs_diff = _params_parity(
                    post_shrink, ref_state["params"])
                post_shrink = None
            for j in range(rollback, parity_end):
                ref_state, m = ref_rt.train_step(j, ref_state)
                ref_losses[j] = float(m["loss"])
            ref_rt.close()
            del ref_state
    finally:
        if tmp is not None:
            tmp.cleanup()

    window = [k for k in sorted(ref_losses) if k in losses]
    diffs = [abs(losses[k] - ref_losses[k]) for k in window]
    max_diff = max(diffs) if diffs else None
    report = {
        "arch": arch, "mesh": list(mesh_shape),
        "survivor_mesh": shrink_rep.mesh_to if shrink_rep else None,
        "steps": steps, "kill_pod_at": kill_pod_at, "regrow_at": regrow_at,
        "rollback_step": rollback,
        "losses": {str(k): v for k, v in sorted(losses.items())},
        "ref_losses": {str(k): v for k, v in sorted(ref_losses.items())},
        "parity": {
            "window": [rollback, parity_end] if killed else None,
            "steps_compared": len(window),
            "max_abs_loss_diff": max_diff,
            "loss_parity": (max_diff is not None and max_diff == 0.0),
            "params_bitwise_equal": params_bitwise_equal,
            "params_max_abs_diff": params_max_abs_diff,
        },
        "shrink": shrink_rep.summary() if shrink_rep else None,
        "regrow": regrow_rep.summary() if regrow_rep else None,
        "recoveries": recoveries,
        "drill_wall_s": drill_wall,
        "walls": step_walls,
    }
    if verbose:
        p = report["parity"]
        print(f"[drill] parity over steps {p['window']}: "
              f"{p['steps_compared']} compared, "
              f"max |dloss|={p['max_abs_loss_diff']}, "
              f"params bit-identical={p['params_bitwise_equal']}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=list_configs() + list_port_configs())
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
    ap.add_argument("--aux-weight", type=float,
                    default=StepOptions.aux_weight,
                    help="the MoE load-balance loss's weight")
    ap.add_argument("--device", default="cuda")
    # the pod-loss drill (ElasticRuntime end to end)
    ap.add_argument("--kill-pod-at-step", type=int, default=None,
                    help="run the pod-loss drill: lose a pod at this step")
    ap.add_argument("--regrow-at-step", type=int, default=None,
                    help="re-grow onto the full mesh at this step")
    ap.add_argument("--drill-mesh", default="2x2x2",
                    help="logical drill mesh PxDxM")
    ap.add_argument("--drill-json", default=None,
                    help="write the drill report JSON here")
    args = ap.parse_args(argv)
    if args.kill_pod_at_step is not None:
        mesh_shape = tuple(int(x) for x in args.drill_mesh.split("x"))
        report = run_elastic_drill(
            args.arch, steps=args.steps, kill_pod_at=args.kill_pod_at_step,
            regrow_at=args.regrow_at_step, batch=args.batch, seq=args.seq,
            mesh_shape=mesh_shape, lr=args.lr, ckpt_dir=args.ckpt_dir,
            smoke=args.smoke, device=args.device)
        if args.drill_json:
            with open(args.drill_json, "w") as fh:
                json.dump(report, fh, indent=1)
            print(f"[drill] report -> {args.drill_json}")
        return report
    run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, microbatches=args.microbatches, abft_mode=args.abft,
        inject_failures=args.inject_failures, ckpt_dir=args.ckpt_dir,
        resume=args.resume, lr=args.lr, aux_weight=args.aux_weight,
        device=args.device)


if __name__ == "__main__":
    main()
