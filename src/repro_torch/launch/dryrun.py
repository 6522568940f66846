"""Dry run: plan every (arch x shape x mesh) cell without a byte of the
model.

Each cell's step is built by the step builders (`train.step`) over meta
tensors (shape and type, no storage: ``state_shapes``, ``init_cache`` and
``make_inputs`` on the ``"meta"`` device) on the logical production mesh
(`launch.mesh.make_production_mesh`: 16 x 16, or 2 x 16 x 16), and run
once under the dispatch accountant (`launch.hlo_accounting.account`).
The record says per device:

  * ``memory.argument_bytes`` / ``output_bytes`` / ``alias_bytes``: each
    leaf's bytes over the extents of the mesh axes its spec names (exact
    for the specs; the state and the cache are donated, as in the
    reference, so they alias their outputs);
  * ``memory.temp_bytes``: the peak of the bytes allocated during the step
    and alive at once, less what the step hands back, split evenly over
    the devices (an estimate: one device runs every DP shard of the
    logical mesh one after another);
  * ``flops_per_device``: the step's dot and convolution FLOPs, divided
    by the device count (the SPMD partitioner's even split);
    ``bytes_accessed_per_device`` likewise (a proxy);
  * ``collective_bytes_per_device``: the per-device payloads of the
    reductions the port stands for (its stacked-axis reductions); the
    model-axis collectives an SPMD partitioner would add are not in it;
  * ``grad_wire`` (train cells): `dist.collectives.ef_wire_bytes`.

``exact`` and ``estimates`` in the record name which figures are which.
No ``XLA_FLAGS``: nothing here compiles.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --meshes pod1,pod2 --out /tmp/dryrun

Counterpart of the reference package's ``repro/launch/dryrun.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import (SHAPES, get_config, list_configs,
                                      valid_cells)
from repro_torch.launch.hlo_accounting import account
from repro_torch.launch.mesh import make_production_mesh

__all__ = ["dryrun_cell", "spec_bytes", "main"]


def spec_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree`` laid out by ``specs`` (a tree of
    `NamedSharding` or `PartitionSpec` records, leaf for leaf): each
    leaf's bytes over the extents of the axes its spec names, rounded up
    (a dim the extents do not divide keeps its ragged shard)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(tree)
    spec_leaves = tree_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} "
                         "specs")
    total = 0
    for x, sp in zip(leaves, spec_leaves):
        sp = getattr(sp, "spec", sp)
        shape = list(x.shape)
        for d, entry in enumerate(sp):
            shape[d] = -(-shape[d] // shd._entry_extent(mesh, entry))
        total += math.prod(shape) * x.element_size()
    return total


def _meta_mesh(mesh):
    from repro_torch.dist.sharding import Mesh
    return Mesh(tuple(mesh.shape.values()), mesh.axis_names, "meta")


def dryrun_cell(arch: str, shape_name, mesh, *, opts=None, verbose=True,
                extra_tag="", cfg_overrides=None):
    """Build one cell's step on meta tensors and account it; returns the
    record.  ``shape_name`` is a name of `configs.base.SHAPES` or a
    `ShapeConfig` (a cell cut to size)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import ef_wire_bytes
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import (StepOptions, _input_specs,
                                        build_prefill_step, build_serve_step,
                                        build_train_step, make_inputs,
                                        state_shapes, state_specs)
    from repro_torch.tree import stack_layers

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if opts is None:
        opts = StepOptions()
    if shape.kind == "train" and opts.microbatches == 1:
        # grad-accumulate so per-microbatch activations fit, as the
        # reference's dry run
        opts = dataclasses.replace(opts, microbatches=8)
    mesh = _meta_mesh(mesh)
    n_dev = math.prod(mesh.shape.values())
    t0 = time.time()
    inputs = make_inputs(cfg, shape)
    grad_wire = None
    if shape.kind == "train":
        fn = build_train_step(cfg, shape, opts=opts, mesh=mesh)
        state = state_shapes(cfg, opts, mesh)
        sspecs = state_specs(state, mesh, opts, cfg)
        ispecs = _input_specs(cfg, shape, mesh)
        # the specs are in the reference's stacked layout; the state is
        # donated, and the metrics are three scalars
        alias_b = spec_bytes(stack_layers(state), sspecs, mesh)
        args_b = alias_b + spec_bytes(inputs, ispecs, mesh)
        out_b = alias_b + 3 * 4
        t_build = time.time() - t0
        acct = account(fn, state, inputs)
        grad_wire = ef_wire_bytes(state["params"], shd.dp_extent(mesh))
    else:
        build = build_prefill_step if shape.kind == "prefill" \
            else build_serve_step
        fn, in_sh, out_sh = build(cfg, mesh, shape, opts)
        params = state_shapes(cfg)["params"]
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device="meta")
        p_b = spec_bytes(stack_layers(params), in_sh[0], mesh)
        c_b = spec_bytes(cache, in_sh[2], mesh)
        args_b = p_b + spec_bytes(inputs, in_sh[1], mesh) + c_b
        logits = torch.empty((shape.global_batch, cfg.vocab_size),
                             dtype=torch.float32, device="meta")
        out_b = spec_bytes([logits], [out_sh[0]], mesh) + c_b
        alias_b = c_b
        t_build = time.time() - t0
        acct = account(fn, params, inputs, cache)
    t_acct = time.time() - t0 - t_build
    temp_global = max(0, acct["peak_bytes"] - acct["live_end_bytes"])
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": dict(mesh.shape),
        "devices": n_dev,
        "tag": extra_tag,
        "flops_per_device": acct["flops"] / n_dev,
        "bytes_accessed_per_device": acct["bytes"] / n_dev,
        "collective_bytes_per_device": acct["collective_bytes"],
        "step_flops": acct["flops"],
        "memory": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": temp_global / n_dev,
            "alias_bytes": alias_b,
            "peak_allocated_bytes": acct["peak_bytes"],
        },
        "exact": ["memory.argument_bytes", "memory.output_bytes",
                  "memory.alias_bytes", "step_flops", "grad_wire"],
        "estimates": {
            "flops_per_device": "step FLOPs split evenly over the devices",
            "bytes_accessed_per_device": "each op's operands and outputs, "
                                         "split evenly (a proxy)",
            "memory.temp_bytes": "peak of the bytes allocated during the "
                                 "step on one device running every DP "
                                 "shard, less those handed back, split "
                                 "evenly",
            "collective_bytes_per_device": "the stacked-axis reductions "
                                           "only",
        },
        "build_s": round(t_build, 2),
        "account_s": round(t_acct, 2),
    }
    if grad_wire is not None:
        record["grad_wire"] = grad_wire
    if verbose:
        mem = record["memory"]
        peak = mem["argument_bytes"] + mem["temp_bytes"] \
            + mem["output_bytes"] - mem["alias_bytes"]
        coll = sum(acct["collective_bytes"].values())
        print(f"[dryrun] {arch} x {shape.name} x "
              f"{tuple(mesh.shape.values())} OK  "
              f"flops/dev={record['flops_per_device']:.3e} "
              f"mem/dev={peak / 2 ** 30:.2f}GiB coll={coll / 2 ** 20:.1f}MiB "
              f"(build {t_build:.1f}s account {t_acct:.1f}s)")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description="plan every cell on meta "
                                             "tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every valid cell (of --arch if given)")
    ap.add_argument("--meshes", default="pod1",
                    help="comma list: pod1 (16x16) and/or pod2 (2x16x16)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--abft", default="off",
                    help="ABFT mode for the protected variant "
                         "(off|checksum|verify)")
    args = ap.parse_args(argv)

    from repro_torch.train.step import StepOptions

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = [(t, make_production_mesh(multi_pod=(t == "pod2"),
                                       device="meta"))
              for t in args.meshes.split(",")]
    if args.all:
        archs = [args.arch] if args.arch else list_configs()
        cells = [(a, s) for a in archs for s in valid_cells(a)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    opts = StepOptions(abft_mode=args.abft)
    failures = []
    for mesh_tag, mesh in meshes:
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{mesh_tag}" + (
                f"__abft-{args.abft}" if args.abft != "off" else "")
            path = outdir / f"{tag}.json"
            try:
                rec = dryrun_cell(arch, shape, mesh, opts=opts,
                                  extra_tag=mesh_tag)
                path.write_text(json.dumps(rec, indent=1))
            except Exception as e:  # noqa: BLE001 - every cell reports
                failures.append((tag, repr(e)))
                print(f"[dryrun] {tag} FAILED: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} cells planned OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
