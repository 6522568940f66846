"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (recurrent blocks carry their own projections)
vocab=50304.  Alternating mlstm/slstm periods.  O(1) state -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        n_layers=24,
        vocab_size=50304,
        layout=(((("mlstm", "none"), ("slstm", "none")), 12),),
        tie_embeddings=True,
        supports_long_context=True,
    )
