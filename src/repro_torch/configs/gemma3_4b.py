"""Gemma3-4B — 5:1 local:global, 128k ctx [hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
window 1024.  Layout: 5 periods of (5 local + 1 global) + 4 trailing locals.
Sliding-window dominant -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def gemma3_4b() -> ModelConfig:
    period = tuple([("attn_local", "dense")] * 5 + [("attn", "dense")])
    tail = tuple([("attn_local", "dense")] * 4)
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_ff=10240,
        n_layers=34,
        vocab_size=262144,
        layout=((period, 5), (tail, 1)),
        head_dim=256,
        window=1024,
        activation="gelu",
        embed_scale=True,
        tie_embeddings=True,
        supports_long_context=True,
    )
