"""Step options.

Only the part of the reference package's ``repro/train/step.py`` that the
serving engine reads: the ABFT fields of ``StepOptions`` and its ``.abft``
property.  The train / prefill / serve step builders come with the
protected-LM slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.abft_gemm import ABFTConfig

__all__ = ["StepOptions"]


@dataclasses.dataclass(frozen=True)
class StepOptions:
    abft_mode: str = "off"         # off | checksum | verify | correct
    abft_f: int = 2
    # matmul-ABFT backend: "cuda" routes the protected projections through
    # the fused dual-checksum kernel (kernels.ops), "ref" keeps the plain
    # PyTorch path, "auto" takes the kernel on CUDA tensors.
    abft_backend: str = "auto"
    # operand dtype for the ABFT-protected projections: "fp32" | "bf16" |
    # "int8".  Narrows only the GEMM A/B stream; checksums stay fp32 with
    # dtype-aware detection eps (core.abft_gemm).
    kernel_dtype: str = "fp32"

    @property
    def abft(self) -> Optional[ABFTConfig]:
        if self.abft_mode == "off":
            return None
        return ABFTConfig(mode=self.abft_mode, f=self.abft_f,
                          backend=self.abft_backend,
                          in_dtype=self.kernel_dtype)
