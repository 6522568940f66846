"""Moonlight-16B-A3B — DeepSeek-V3's block at width 2048
[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3].

27L d_model=2048 16H, latent attention without q-LoRA (kv_lora_rank 512,
qk_nope 128, qk_rope 64, v 128, rope_theta 50000); the first layer dense
(intermediate 11264), then 26 MoE layers: 64 routed experts of width 1408,
top-6 by sigmoid score plus a selection bias (noaux_tc), the chosen scores
normalised and scaled by 2.446, and 2 shared experts; vocab 163840, untied
embeddings, RMSNorm eps 1e-5, context 8192.  Equations: DeepSeek-V2
(arXiv:2405.04434) §2.1 and DeepSeek-V3 (arXiv:2412.19437) §2.1.

Assumed (the config does not give it): the selection bias moves by
gamma = 0.001 a step (DeepSeek-V3 §2.1.2 names it and gives no value for
this model).  The sequence-wise balance loss's weight alpha is the train
step's ``StepOptions.aux_weight``; the benchmark's cell assumes 1e-4.
"""
from repro_torch.configs.base import DeepSeekV3Config, register_port


@register_port
def moonlight_16b_a3b() -> DeepSeekV3Config:
    return DeepSeekV3Config(
        name="moonlight-16b-a3b",
        family="moe",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=11264,
        n_layers=27,
        vocab_size=163840,
        layout=(((("mla", "dense"),), 1), ((("mla", "moe"),), 26)),
        n_experts=64,
        top_k=6,
        moe_dff=1408,
        rope_theta=50000.0,
        dtype="float32",
        norm_eps=1e-5,
        tie_embeddings=False,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        routed_scale=2.446,
        n_shared_experts=2,
        bias_update_rate=1e-3,
        notes="port-only; dtype float32 (kernel #1 in 3xTF32) in place of "
              "the published bf16",
    )
