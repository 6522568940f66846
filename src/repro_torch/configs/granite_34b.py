"""Granite-34B-code — llama-arch MQA [arXiv:2405.04324; hf].

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def granite_34b() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        n_layers=88,
        vocab_size=49152,
        layout=(((("attn", "dense"),), 88),),
        tie_embeddings=True,
        supports_long_context=False,
    )
