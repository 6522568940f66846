"""PyTorch / CUDA port of the ABFT system, beside the JAX reference package.

The module layout mirrors ``src/repro/``: ``configs``, ``core``
(checksum algebra, layer ABFT GEMM), ``kernels`` (hand-written Hopper
kernels, their plain PyTorch versions, dispatchers), ``models``, ``serve``,
``launch``, ``obs`` and the surface registry in ``chaos.faults``.  It
imports torch, numpy and the standard library, and nothing of the
reference package.  Entry points run on CUDA unless given
``device="cpu"``.
"""
