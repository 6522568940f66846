"""Jamba-1.5-Large 398B — Mamba+attn 1:7, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
alternating blocks, attention at position 3 of each 8-block period (1:7).
SSM-dominant -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def jamba_1_5_large_398b() -> ModelConfig:
    period = tuple(
        ("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "dense")
        for i in range(8)
    )
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        n_layers=72,
        vocab_size=65536,
        layout=((period, 9),),
        n_experts=16,
        top_k=2,
        moe_dff=24576,
        d_state=16,
        d_conv=4,
        mamba_expand=2,
        tie_embeddings=False,
        supports_long_context=True,
    )
