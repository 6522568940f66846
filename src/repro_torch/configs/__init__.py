"""Architecture configs + registry (the port registers the configs whose
layer kinds it can run; the reference package holds the full catalog)."""
import importlib

_MODULES = ["qwen2_0_5b"]


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


from repro_torch.configs.base import (  # noqa: E402
    ModelConfig, ShapeConfig, SHAPES, get_config, list_configs, valid_cells,
)
