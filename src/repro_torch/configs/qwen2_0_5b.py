"""Qwen2-0.5B — GQA with QKV bias [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        n_layers=24,
        vocab_size=151936,
        layout=(((("attn", "dense"),), 24),),
        qkv_bias=True,
        tie_embeddings=True,
        supports_long_context=False,
    )
