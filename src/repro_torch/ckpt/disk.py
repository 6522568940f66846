"""Disk checkpointing: async, atomic, keep-k.

Layout per step:
    <dir>/step_<n>.tmp/ ... -> atomic rename -> <dir>/step_<n>/
        manifest.json          tree spec (shape + dtype per leaf), the dtypes
                               in leaf order, aux state
        arrays.npz             flat leaves (key = leaf index, tree order)

numpy has no bfloat16, so a bf16 leaf is stored as its raw 16-bit patterns
(int16) with ``bfloat16`` named in the manifest, and restored bit-exactly.
Host copies are made on the caller's thread (cheap next to a train step);
the write runs on a background thread, so the device never waits on disk.
An error of that thread is raised by the next ``wait``/``save``.

Restore takes a ``sharding_tree`` (`dist.sharding.to_shardings` records)
to place every leaf on its mesh's device: the stored leaves are global, so the same checkpoint
restores onto any logical mesh (`ckpt.elastic.reshard_restore`).

Counterpart of the reference package's ``repro/ckpt/disk.py``.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CheckpointManager"]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a, order="C"))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, aux: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot `state` (+ small `aux` dict, e.g. the data cursor)."""
        self.wait()
        host = [_to_host(x) for x in tree_leaves(state)]
        spec = tree_map(lambda x: [list(x.shape), _dtype_name(x)], state)
        dtypes = [_dtype_name(x) for x in tree_leaves(state)]

        def write():
            try:
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz",
                         **{f"leaf_{i}": a for i, a in enumerate(host)})
                (tmp / "manifest.json").write_text(json.dumps(
                    {"step": step, "aux": aux or {}, "spec": spec,
                     "dtypes": dtypes}))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except Exception as e:   # re-raised by wait()
                self._error = e

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self):
        """Join the pending save; raise its error, if it had one."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, sharding_tree=None):
        """Restore into the structure of `like` (a tree of tensors; meta
        tensors do).  Each leaf comes back in `like`'s dtype, on the like
        leaf's device (the CPU for a meta tensor), or with
        ``sharding_tree`` on the device of its sharding's mesh."""
        self.wait()
        place = None
        if sharding_tree is not None:
            # a logical mesh places every leaf whole on its one device
            devices = {s.device for s in tree_leaves(sharding_tree)}
            if len(devices) != 1:
                raise ValueError(f"sharding_tree spans devices {devices}: "
                                 "a restore places onto one mesh")
            place = devices.pop()
        path = self.dir / f"step_{step}"
        if not path.exists():
            raise FileNotFoundError(
                f"no checkpoint at step {step} under {self.dir} "
                f"(have {self.steps()})")
        leaves = tree_leaves(like)
        dtypes = json.loads((path / "manifest.json").read_text())["dtypes"]
        with np.load(path / "arrays.npz") as data:
            if len(data.files) != len(leaves):
                raise ValueError(
                    f"checkpoint step {step} holds {len(data.files)} leaves "
                    f"but the restore target has {len(leaves)}: the saved "
                    "state tree and `like` disagree structurally")
            out = []
            for i, ref in enumerate(leaves):
                a = data[f"leaf_{i}"]
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"checkpoint step {step} leaf {i}: saved shape "
                        f"{tuple(a.shape)} vs expected {tuple(ref.shape)}")
                if place is not None:
                    dev = place
                else:
                    dev = "cpu" if ref.device.type == "meta" else ref.device
                out.append(_from_host(a, dtypes[i]).to(device=dev,
                                                       dtype=ref.dtype))
        return tree_unflatten(like, out)

    def aux(self, step: int) -> dict:
        path = self.dir / f"step_{step}" / "manifest.json"
        return json.loads(path.read_text())["aux"]

