"""Architecture configs (one module per assigned arch) + registry."""
import importlib

_MODULES = [
    "kimi_k2_1t_a32b", "qwen3_moe_30b_a3b", "whisper_large_v3", "qwen2_0_5b",
    "gemma2_2b", "granite_34b", "gemma3_4b", "jamba_1_5_large_398b",
    "xlstm_350m", "llama_3_2_vision_11b",
]
# architectures the port adds (`base.register_port`)
_PORT_MODULES = ["moonlight_16b_a3b"]


def load_all():
    for m in _MODULES + _PORT_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


from repro_torch.configs.base import (  # noqa: E402
    DeepSeekV3Config, ModelConfig, ShapeConfig, SHAPES, get_config,
    list_configs, list_port_configs, valid_cells,
)
