"""Llama-3.2-11B-Vision — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th block is
cross-attention to precomputed image-patch embeddings (vision frontend STUB:
input_specs provides [B, 1024, d_model] patch embeddings).
"""
from repro_torch.configs.base import ModelConfig, register


@register
def llama_3_2_vision_11b() -> ModelConfig:
    period = tuple([("attn", "dense")] * 4 + [("cross", "dense")])
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        n_layers=40,
        vocab_size=128256,
        layout=((period, 8),),
        n_img_tokens=1024,
        tie_embeddings=False,
        supports_long_context=False,
        notes="vision frontend stubbed: patch embeddings arrive precomputed",
    )
