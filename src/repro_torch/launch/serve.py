"""Serving driver: the fault-tolerant continuous-batching engine as a CLI.

Drives `serve.ServeEngine` — slot-scheduled prefill + decode with
ABFT-verified projections (``--abft verify``) on the fused dual-checksum
CUDA kernel, a checksum-protected decode-path logits reduction
(``--reduce verify|correct``) and SDC drills that corrupt that reduction
mid-flight (``--drill-step/shard/delta``).  It runs on the GPU unless
``--device cpu`` is given; with no GPU it raises rather than falling back.
``--smoke`` (the default) serves the reduced config; ``--no-smoke`` serves
the model at its published width.
``--arch`` takes every decoder-only config of the registry (dense, MoE,
hybrid Mamba/attention and xLSTM); Whisper and the vision config need
encoder frames or image embeddings, which the engine does not feed, and
raise as the reference's ``run`` does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke --abft verify
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --no-smoke --abft verify --kernel-dtype bf16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --requests 3 --slots 2 --gen 4 --abft verify --backend cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --reduce correct \
      --drill-step 3 --drill-shard 0 --drill-delta 1e4
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (ModelConfig, get_config,
                                      list_configs, smoke_config)
from repro_torch.dist.sharding import Mesh
from repro_torch.ft.failures import SDCInjector, SDCPlan
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine


def resolve_device(device: str = "cuda") -> torch.device:
    """The device to run on; asking for CUDA without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; "
                           "pass device='cpu' to run on the CPU")
    return dev


def decoder_only(name: str) -> bool:
    cfg = get_config(name)
    return not (cfg.n_enc_layers or cfg.n_img_tokens)


def cut_layers(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` cut to its first ``layers`` blocks in layout order (a period
    cut short becomes a group of one repeat of its first blocks)."""
    out, left = [], layers
    for pattern, repeats in cfg.layout:
        if left <= 0:
            break
        full = min(repeats, left // len(pattern))
        if full:
            out.append((pattern, full))
            left -= full * len(pattern)
        if full < repeats and 0 < left < len(pattern):
            out.append((pattern[:left], 1))
            left = 0
    return dataclasses.replace(cfg, layout=tuple(out),
                               n_layers=sum(len(p) * r for p, r in out))


def run(arch: str, *, smoke: bool = True, requests: int = 6, slots: int = 2,
        prompt_len: int = 8, prompt_lens: Optional[Sequence[int]] = None,
        gen: int = 16, abft_mode: str = "off", abft_backend: str = "auto",
        kernel_dtype: str = "fp32", abft_reduce: str = "off",
        mesh_shape: Optional[tuple] = None,
        drill: Optional[SDCPlan] = None, scrub_every: int = 0,
        dtype: Optional[str] = None, layers: Optional[int] = None,
        seed: int = 0, device: str = "cuda",
        on_warm: Optional[Callable[[ServeEngine], None]] = None,
        on_step: Optional[Callable[[ServeEngine, int], None]] = None,
        verbose: bool = True):
    """Build a (possibly drilled) engine with seeded random weights, serve
    `requests` requests, return ``(finished_requests, engine)``.

    ``prompt_lens`` gives each request its own prompt length (default:
    ``prompt_len`` for all); ``mesh_shape`` is a logical ``(data, model)``
    mesh whose model extent the verified unembed reduces over; ``drill`` is the SDC plan fired into the
    protected reduction (needs ``abft_reduce``); ``dtype`` overrides the
    config's parameter dtype; ``layers`` cuts the model to its first
    ``layers`` blocks (`cut_layers`); ``on_warm(engine)`` runs after the warm-up
    and before the first request is submitted, ``on_step(engine, step)``
    before every decode step (`ServeEngine.run`).
    """
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if layers is not None:
        cfg = cut_layers(cfg, layers)
    if cfg.n_enc_layers or cfg.n_img_tokens:
        raise ValueError(f"{arch} needs encoder frames / image embeddings, "
                         "which the engine does not feed")
    lens = list(prompt_lens) if prompt_lens is not None \
        else [prompt_len] * requests
    if len(lens) != requests:
        raise ValueError(f"{len(lens)} prompt lengths for {requests} requests")
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    params = tf.init_params(gen_t, cfg)
    engine = ServeEngine(cfg, params, slots=slots,
                         max_len=max(lens) + gen + 8, abft_mode=abft_mode,
                         abft_backend=abft_backend, kernel_dtype=kernel_dtype,
                         abft_reduce=abft_reduce, scrub_every=scrub_every,
                         mesh=(Mesh(tuple(mesh_shape), ("data", "model"),
                                    dev) if mesh_shape is not None
                               else None),
                         sdc=SDCInjector(drill) if drill is not None
                         else None)
    engine.warm(prompt_len=lens[0])
    if on_warm is not None:
        on_warm(engine)
    rs = np.random.RandomState(seed)
    for i, plen in enumerate(lens):
        engine.submit(Request(
            rid=i, prompt=rs.randint(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=gen))
    finished = engine.run(on_step=on_step)
    if verbose:
        s = engine.stats.summary()
        print(f"[serve] {arch} on {dev}: {len(finished)} requests, "
              f"{s['decode_steps']} decode steps "
              f"(prefill {s['prefill_s']*1e3:.1f}ms, "
              f"decode {s['decode_s']*1e3:.1f}ms), "
              f"ttft {s['ttft_ms']:.1f}ms, {s['tok_per_s']:.1f} tok/s/seq")
        if abft_reduce != "off":
            print(f"[serve] protected reduce: detections={s['detections']} "
                  f"corrections={s['corrections']} "
                  f"recovery_latency={s['recovery_latency_ms']:.2f}ms")
        for ev in engine.stats.events:
            print(f"[serve] SDC drill @step {ev.step}: shard {ev.shard} "
                  f"delta {ev.delta:+.3g} -> detected={ev.detected} "
                  f"corrected={ev.corrected} located=({ev.row},{ev.col})")
        if scrub_every:
            print(f"[serve] at-rest scrub: {s['scrub_checks']} checks, "
                  f"{s['scrub_repairs']} repairs, "
                  f"{s['scrub_ms']:.2f}ms per check")
        sample = finished[0].output[:16] if finished else []
        print(f"[serve] sample generation ids[0,:16]: {sample}")
    return finished, engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=[n for n in list_configs() if decoder_only(n)],
                    help="a decoder-only config of the registry")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default); --no-smoke serves the "
                         "published width")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--abft", default="off",
                    choices=["off", "checksum", "verify", "correct"])
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "ref"],
                    help="protected-projection backend (auto = the CUDA "
                         "kernel on the GPU)")
    ap.add_argument("--kernel-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"])
    ap.add_argument("--reduce", default="off",
                    choices=["off", "verify", "correct"],
                    help="checksum-protect the decode-path logits reduction")
    ap.add_argument("--mesh", default=None, metavar="RxM",
                    help="logical (data=R, model=M) mesh, e.g. 4x2")
    ap.add_argument("--drill-step", type=int, default=None,
                    help="engine decode step to fire an SDC drill at")
    ap.add_argument("--drill-shard", type=int, default=0,
                    help="model-axis shard whose contribution corrupts")
    ap.add_argument("--drill-delta", type=float, default=1e4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(v) for v in args.mesh.split("x"))
                  if args.mesh else None)
    drill = None
    if args.drill_step is not None:
        if args.reduce == "off":
            ap.error("--drill-step needs --reduce verify|correct")
        drill = SDCPlan(((args.drill_step, args.drill_shard,
                          args.drill_delta),))
    return run(args.arch, smoke=args.smoke, requests=args.requests,
               slots=args.slots, prompt_len=args.prompt_len, gen=args.gen,
               abft_mode=args.abft, abft_backend=args.backend,
               kernel_dtype=args.kernel_dtype, abft_reduce=args.reduce,
               mesh_shape=mesh_shape, drill=drill, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
