"""Logical mesh construction (single-pod 16 x 16, multi-pod 2 x 16 x 16).

A mesh here is a shape over named axes placed on one torch device
(`dist.sharding.Mesh`): building one touches no device and enumerates
none, so the production meshes build on one card or on the CPU alike.

Counterpart of the reference package's ``repro/launch/mesh.py``.
"""
from __future__ import annotations

from repro_torch.dist.sharding import Mesh

__all__ = ["make_production_mesh", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """Arbitrary mesh (tests, elastic re-meshing after failures)."""
    return Mesh(tuple(shape), tuple(axes), device)
