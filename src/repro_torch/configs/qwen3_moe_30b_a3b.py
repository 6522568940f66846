"""Qwen3-30B-A3B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen3_moe_30b_a3b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        n_layers=48,
        vocab_size=151936,
        layout=(((("attn", "moe"),), 48),),
        n_experts=128,
        top_k=8,
        moe_dff=768,
        head_dim=128,
        tie_embeddings=False,
        supports_long_context=False,
    )
