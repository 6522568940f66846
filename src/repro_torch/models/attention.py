"""Attention: GQA/MQA, global + sliding-window, softcap, KV cache.

Two compute paths, one semantic (plain PyTorch that mirrors the reference
package's ``repro/models/attention.py`` math, which is jnp there as well):
  * dense  — masked einsum, for short sequences and every decode step
  * flash  — chunked online-softmax loop over KV chunks, O(S) memory, for
             long train and prefill sequences; its backward is FA-2's
             (`_Flash`): the scores are recomputed one KV chunk at a time
             from the saved log-sum-exp, so no S x S array is stored

Both support GQA (n_kv <= n_heads), causal + window masks and logit
softcapping.  Cross attention (``cross_kv``: keys and values projected from
encoder states or image embeddings) takes the dense path, unmasked.  Cache writes go IN PLACE into the cache tensors the caller
passes (the engine owns its cache, so this saves a copy of it per layer and
step); the returned cache holds the same tensors and a new index.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import (linear_apply, linear_init, rope,
                                       softcap_fn)

NEG_INF = -1e30


class AttnSpec(NamedTuple):
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    softcap: Optional[float] = None
    window: Optional[int] = None     # sliding window (None = global)
    rope_theta: float = 10000.0
    use_rope: bool = True
    kc: int = 512                    # flash KV chunk length


def attn_init(gen: torch.Generator, s: AttnSpec, dtype=torch.float32):
    return {
        "wq": linear_init(gen, s.d_model, s.n_heads * s.head_dim,
                          bias=s.qkv_bias, dtype=dtype),
        "wk": linear_init(gen, s.d_model, s.n_kv * s.head_dim,
                          bias=s.qkv_bias, dtype=dtype),
        "wv": linear_init(gen, s.d_model, s.n_kv * s.head_dim,
                          bias=s.qkv_bias, dtype=dtype),
        "wo": linear_init(gen, s.n_heads * s.head_dim, s.d_model,
                          dtype=dtype),
    }


def _split_heads(x, n, d):
    return x.reshape(x.shape[:-1] + (n, d))


def _mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """Boolean mask, True = attend.  q_pos: [Sq] -> [Sq, Sk] shared mask;
    q_pos: [B, Sq] (continuous batching: per-slot positions) -> [B, Sq, Sk]."""
    qp = q_pos[..., :, None]
    kp = k_pos[None, :] if q_pos.dim() == 1 else k_pos[None, None, :]
    shape = torch.broadcast_shapes(qp.shape, kp.shape)
    m = torch.ones(shape, dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= qp >= kp
    if window is not None:
        # two-sided band: bounding only qp - kp would let a non-causal
        # window attend to arbitrarily-far future keys
        m &= qp - kp < window
        m &= kp - qp < window
    return m


def _sdpa_dense(q, k, v, *, scale, softcap, mask):
    """q: [B,Sq,G,g,D]; k,v: [B,Sk,G,D]; mask [Sq,Sk] or [B,Sq,Sk].
    Returns o: [B,Sq,G,g,D] fp32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    s = softcap_fn(s, softcap)
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())


def _flash_fwd_impl(q, k, v, q_pos, k_pos, *, scale, softcap, causal,
                    window, kc):
    """FlashAttention-2 forward: chunked online softmax over K/V.

    q: [B,Sq,KV,g,D]; k,v: [B,Sk,KV,D].  Returns o: [B,Sq,KV,g,D] in
    q.dtype and the per-row log-sum-exp [B,KV,g,Sq].
    """
    b, sq, g_kv, g, d = q.shape
    sk = k.shape[1]
    kc = min(kc, sk)
    q32 = q.float()
    m = torch.full((b, g_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, g_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g_kv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, kc):
        # a ragged last chunk is just shorter.  (The reference pads it with
        # zero keys at position -1e9, which the causal test qp >= kp lets
        # through, so its chunked path is wrong when sk % kc != 0.)
        k_c, v_c = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
        s = _chunk_scores(q32, k_c, q_pos, k_pos[c0:c0 + kc], scale=scale,
                          softcap=softcap, causal=causal, window=window)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v_c.float())
        m = m_new
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o.to(q.dtype), lse


def _chunk_scores(q32, k_c, q_pos, kp_c, *, scale, softcap, causal,
                  window):
    """One KV chunk's masked scores [B,KV,g,Sq,kc] (masked = NEG_INF)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k_c.float()) * scale
    s = softcap_fn(s, softcap)
    msk = _mask(q_pos, kp_c, causal=causal, window=window)
    return torch.where(msk[None, None, None], s, NEG_INF)


class _Flash(torch.autograd.Function):
    """FlashAttention-2 as an autograd function: the forward is
    `_flash_fwd_impl`, which keeps only the per-row log-sum-exp; the
    backward is the reference's ``_flash_bwd`` (``jax.custom_vjp`` there):
    per KV chunk, recompute the scores, ``p = exp(s - lse)``, ``dV = p^T
    dO``, ``dS = p (dO V^T - delta)`` with ``delta = sum(dO * O)``, the
    softcap's derivative ``1 - (s / cap)^2`` taken only where the score is
    not masked (a masked score is -1e30: its square would overflow and
    0 * inf give NaN), then ``dQ += dS K``, ``dK = dS^T Q``.  A ragged last
    chunk is taken as it is, unpadded, as the forward takes it."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, softcap, causal, window,
                kc):
        o, lse = _flash_fwd_impl(q, k, v, q_pos, k_pos, scale=scale,
                                 softcap=softcap, causal=causal,
                                 window=window, kc=kc)
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos)
        ctx.static = (scale, softcap, causal, window, min(kc, k.shape[1]))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
        scale, softcap, causal, window, kc = ctx.static
        q32 = q.float()
        do32 = do.float().permute(0, 2, 3, 1, 4)            # [B,KV,g,Sq,D]
        delta = torch.sum(do32 * o.float().permute(0, 2, 3, 1, 4), dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        for c0 in range(0, k.shape[1], kc):
            k_c, v_c = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
            s = _chunk_scores(q32, k_c, q_pos, k_pos[c0:c0 + kc],
                              scale=scale, softcap=softcap, causal=causal,
                              window=window)
            p = torch.exp(s - lse[..., None])               # [B,KV,g,Sq,kc]
            dv[:, c0:c0 + kc] = torch.einsum("bhgqk,bhgqd->bkhd", p, do32)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do32, v_c.float())
            ds = p * (dp - delta[..., None])
            if softcap:
                sc = torch.where(s > NEG_INF / 2, s, 0.0)
                ds = ds * (1.0 - torch.square(sc / softcap))
            ds = ds * scale
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, k_c.float())
            dk[:, c0:c0 + kc] = torch.einsum("bhgqk,bqhgd->bkhd", ds, q32)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def _sdpa_flash(q, k, v, *, scale, softcap, q_pos, k_pos, causal, window,
                kc: int = 512):
    """Chunked online-softmax attention with the FA-2 backward (`_Flash`).
    q: [B,Sq,KV,g,D]; k,v: [B,Sk,KV,D]; q_pos [Sq]; returns o
    [B,Sq,KV,g,D] in q.dtype."""
    return _Flash.apply(q, k, v, q_pos, k_pos, scale, softcap, causal,
                        window, kc)


def attn_apply(
    p,
    x,
    s: AttnSpec,
    *,
    positions: torch.Tensor,         # [Sq] or [B, Sq] global positions
    causal: bool = True,
    cache: Optional[dict] = None,    # {"k","v": [B, Smax, n_kv, D], "index"}
    cross_kv: Optional[torch.Tensor] = None,  # [B, Skv, d_model] encoder
    abft=None,
    flash_threshold: int = 1024,
):
    """Returns (y, new_cache).  Modes:
       - train/prefill: cache None -> full self-attention over x
       - prefill w/ cache: scalar cache["index"], Sq tokens written there
       - decode: Sq == 1, per-slot [B] cache["index"], one token per slot
       - cross: cross_kv set (no rope, no cache, no mask; the dense path)
    """
    b, sq, _ = x.shape
    q = _split_heads(linear_apply(p["wq"], x, abft), s.n_heads, s.head_dim)
    kv_src = cross_kv if cross_kv is not None else x
    k = _split_heads(linear_apply(p["wk"], kv_src, abft), s.n_kv, s.head_dim)
    v = _split_heads(linear_apply(p["wv"], kv_src, abft), s.n_kv, s.head_dim)

    if s.use_rope and cross_kv is None:
        pos_b = positions[None] if positions.dim() == 1 else positions
        q = rope(q, pos_b, s.rope_theta)
        k = rope(k, pos_b, s.rope_theta)

    new_cache = None
    if cache is not None:
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        if idx.dim() == 0:
            cols = idx + torch.arange(sq, device=idx.device)
            ck[:, cols] = k.to(ck.dtype)
            cv[:, cols] = v.to(cv.dtype)
        else:
            # continuous batching: per-slot write positions (sq == 1).  An
            # idle slot's index keeps counting past the cache; its write is
            # dropped, as the reference's out-of-bounds scatter drops it
            rows = torch.arange(b, device=idx.device)
            keep = (idx < ck.shape[1])[:, None, None]
            at = idx.clamp(max=ck.shape[1] - 1)
            ck[rows, at] = torch.where(keep, k[:, 0].to(ck.dtype),
                                       ck[rows, at])
            cv[rows, at] = torch.where(keep, v[:, 0].to(cv.dtype),
                                       cv[rows, at])
        new_cache = {"k": ck, "v": cv, "index": idx + sq}
        k, v = ck, cv
        k_pos = torch.arange(ck.shape[1], device=x.device)
        # positions beyond the write head are masked out by causality
    else:
        k_pos = positions if cross_kv is None else \
            torch.arange(k.shape[1], device=x.device)

    g = s.n_heads // s.n_kv
    qh = q.reshape(b, sq, s.n_kv, g, s.head_dim)
    scale = s.head_dim ** -0.5
    use_causal = causal and cross_kv is None
    window = s.window if cross_kv is None else None

    sk = k.shape[1]
    if sq == 1 or sk <= flash_threshold or cross_kv is not None:
        mask = _mask(positions, k_pos, causal=use_causal, window=window)
        o = _sdpa_dense(qh, k, v, scale=scale, softcap=s.softcap, mask=mask)
    else:
        o = _sdpa_flash(qh, k, v, scale=scale, softcap=s.softcap,
                        q_pos=positions, k_pos=k_pos, causal=use_causal,
                        window=window, kc=s.kc)
    o = o.reshape(b, sq, s.n_heads * s.head_dim).to(x.dtype)
    y = linear_apply(p["wo"], o, abft)
    return y, new_cache


def make_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device=None):
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "index": torch.zeros((), dtype=torch.int64, device=device),
    }
