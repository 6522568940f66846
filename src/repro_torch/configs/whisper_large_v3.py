"""Whisper large-v3 — enc-dec audio [arXiv:2212.04356; unverified].

32L (enc) + 32L (dec), d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
Conv frontend is a STUB: input_specs provides precomputed frame embeddings
[B, 1500, d_model].  GeLU MLPs, learned positions elided (backbone only).
Decode runs over the decoder with cached cross K/V; long_500k skipped
(full attention; decoder context is bounded by design).
"""
from repro_torch.configs.base import ModelConfig, register


@register
def whisper_large_v3() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        n_layers=32,
        vocab_size=51866,
        layout=(((("dec", "dense"),), 32),),
        n_enc_layers=32,
        n_frames=1500,
        activation="gelu",
        tie_embeddings=False,
        supports_long_context=False,
        notes="modality frontend stubbed: frames arrive pre-embedded",
    )
