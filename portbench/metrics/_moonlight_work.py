"""The work of a Moonlight-16B-A3B training step (DeepSeek-V3's block), from
the configuration's published keys, as the readers count it.

Per token, the checked products (every forward projection the program
verifies) hold: in each layer the latent attention's four projections
(``W_q`` D -> H (d_nope + d_rope), ``W_kv_a`` D -> r + d_rope, ``W_kv_b``
r -> H (d_nope + d_v), ``W_o`` H d_v -> D); the dense layers' SwiGLU of
width I; in each MoE layer the k chosen experts' SwiGLU of width F and the
shared experts' one of width n_shared F; the output head D -> V.  The
router (unprotected, in fp32) and the norms are not checked products but
count among the active parameters of the model FLOPs.
"""
from __future__ import annotations

__all__ = ["checked_params", "active_params", "checked_fwd_flops",
           "model_flops", "expert_work", "tokens_a_step"]


def _layers(c: dict):
    """(dense layers, MoE layers)."""
    dense = min(int(c["first_k_dense_replace"]), int(c["num_hidden_layers"]))
    return dense, int(c["num_hidden_layers"]) - dense


def _attn_params(c: dict) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    r = c["kv_lora_rank"]
    return (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
            + h * dv * d)


def checked_params(c: dict) -> int:
    """Weights of the checked products a token goes through."""
    d, dense, moe = c["hidden_size"], *_layers(c)
    f = c["moe_intermediate_size"]
    routed = c["num_experts_per_tok"] * 3 * d * f
    shared = 3 * d * c["n_shared_experts"] * f
    return ((dense + moe) * _attn_params(c)
            + dense * 3 * d * c["intermediate_size"]
            + moe * (routed + shared) + d * c["vocab_size"])


def active_params(c: dict) -> int:
    """The N of 6 N T: the checked products' weights, the routers and the
    norms (the embedding table not)."""
    d, dense, moe = c["hidden_size"], *_layers(c)
    norms = (dense + moe) * (2 * d + c["kv_lora_rank"]) + d
    return checked_params(c) + moe * d * c["n_routed_experts"] + norms


def tokens_a_step(mix: dict) -> int:
    return int(mix["sequences"]) * int(mix["seq_len"])


def checked_fwd_flops(c: dict, mix: dict) -> float:
    """2 N_checked T: the forward FLOPs of the unencoded operands of every
    checked product of a step."""
    return 2.0 * checked_params(c) * tokens_a_step(mix)


def model_flops(c: dict, mix: dict) -> float:
    """A step's model FLOPs: 6 N T for the weights, and causal attention's
    3 S^2 H (d_qk + d_v) a sequence and layer (forward and backward, half
    the score matrix)."""
    s, h = int(mix["seq_len"]), c["num_attention_heads"]
    dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = 3.0 * s * s * h * (dqk + c["v_head_dim"]) * int(mix["sequences"])
    return 6.0 * active_params(c) * tokens_a_step(mix) \
        + attn * int(c["num_hidden_layers"])


def expert_work(c: dict, mix: dict):
    """(FLOPs, bytes) of a step's routed-expert products, forward: in each
    MoE layer the gate, up and down products of the T k rows, each reading
    its rows of X and every expert's weights once and writing Y once, in
    fp32."""
    _, moe = _layers(c)
    rows = tokens_a_step(mix) * c["num_experts_per_tok"]
    d, f, e = c["hidden_size"], c["moe_intermediate_size"], \
        c["n_routed_experts"]
    flops = 3 * 2.0 * rows * d * f
    nbytes = 4.0 * (2 * (rows * d + e * d * f + rows * f)      # gate, up
                    + (rows * f + e * f * d + rows * d))       # down
    return moe * flops, moe * nbytes
