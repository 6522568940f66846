"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8.  Pure full attention -> long_500k skipped
(DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig, register


@register
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        n_layers=61,
        vocab_size=163840,
        layout=(((("attn", "moe"),), 61),),
        n_experts=384,
        top_k=8,
        moe_dff=2048,
        tie_embeddings=False,
        supports_long_context=False,
        notes="paper-table config; all layers MoE per assignment",
    )
