"""Gemma2-2B — local/global alternating, logit softcaps [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
window 4096, attn softcap 50, final softcap 30, GeGLU, embed scaling.
Sliding-window dominant -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_ff=9216,
        n_layers=26,
        vocab_size=256000,
        layout=(((("attn_local", "dense"), ("attn", "dense")), 13),),
        head_dim=256,
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="gelu",
        embed_scale=True,
        tie_embeddings=True,
        supports_long_context=True,
    )
