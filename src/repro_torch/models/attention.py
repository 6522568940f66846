"""Attention: GQA/MQA, global + sliding-window, softcap, KV cache.

Two compute paths, one semantic (plain PyTorch that mirrors the reference
package's ``repro/models/attention.py`` math, which is jnp there as well):
  * dense  — masked einsum, for short sequences and every decode step
  * flash  — chunked online-softmax loop over KV chunks, O(S) memory, for
             long train and prefill sequences; its backward is FA-2's
             (`_Flash`): the scores are recomputed one KV chunk at a time
             from the saved log-sum-exp, so no S x S array is stored

Both support GQA (n_kv <= n_heads), causal + window masks, logit
softcapping, and a value head dim other than the query/key one (latent
attention's 128 against 192).  Cross attention (``cross_kv``: keys and
values projected from encoder states or image embeddings) takes the dense
path, unmasked.  Cache writes go IN PLACE into the cache tensors the caller
passes (the engine owns its cache, so this saves a copy of it per layer and
step); the returned cache holds the same tensors and a new index.

`mla_apply` is DeepSeek-V2's multi-head latent attention without a query
LoRA (arXiv:2405.04434 §2.1), for training and prefill without a cache:
queries from ``wq``; keys and values from a shared latent (``wkv_a`` to
``kv_lora_rank`` + the RoPE key dims, the latent RMS-normed, ``wkv_b`` up
to each head's no-RoPE key and value); RoPE on the query's and the one
shared key's RoPE dims; softmax scale ``(d_nope + d_rope)^-0.5``.  Every
projection goes through `linear_apply`, so each is a checked product
under ABFT.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.models.layers import (linear_apply, linear_init,
                                       rmsnorm_apply, rmsnorm_init, rope,
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


def _chunk_rows(sq, sk, kc, aligned, *, causal, window):
    """The work of each KV chunk: ``(c0, n, r0, r1, masked)`` for the chunk's
    keys ``[c0, c0 + n)``, the query rows ``[r0, r1)`` that see at least one
    of them, and the spans of those rows where a score can be masked (the
    rows between the spans see every key of the chunk).

    ``aligned``: the host knows that ``q_pos = p0 + arange(sq)`` and
    ``k_pos = p0 + arange(sk)`` from one ``p0``, with ``sk >= sq``.  Row i
    then sees key j iff ``lo <= i - j <= hi``, the band that causality and
    the two-sided window leave, so each chunk is seen by one contiguous
    range of rows, and each row sees at least its own key.  Not aligned,
    every chunk takes every row, masked whole.
    """
    chunks = [(c0, min(kc, sk - c0)) for c0 in range(0, sk, kc)]
    if not aligned:
        return [(c0, n, 0, sq, ((0, sq),)) for c0, n in chunks]
    far = sq + sk                        # beyond any difference of positions
    lo = 0 if causal else (1 - window if window is not None else -far)
    hi = window - 1 if window is not None else far
    out = []
    for c0, n in chunks:
        r0, r1 = max(0, c0 + lo), min(sq, c0 + n + hi)
        f0, f1 = max(r0, c0 + n - 1 + lo), min(r1, c0 + hi + 1)  # see all n
        spans = ((r0, r1),) if f0 >= f1 else ((r0, f0), (f1, r1))
        out.append((c0, n, r0, r1, tuple((a, b) for a, b in spans if b > a)))
    return out


def _count_rows(rows, sq, direction):
    """``repro_flash_chunk_rows_total``: the query rows of a call's chunks,
    computed and skipped, summed over the chunks."""
    done = sum(max(0, r1 - r0) for _, _, r0, r1, _ in rows)
    c = obs.counter("repro_flash_chunk_rows_total",
                    "query rows x KV chunks of the chunked attention, "
                    "computed or skipped")
    c.inc(done, kind="computed", direction=direction)
    c.inc(len(rows) * sq - done, kind="skipped", direction=direction)


def _rows_layout(x, g_kv):
    """fp32 ``x`` [B, S, KV, ...] as a batch of matrices, one a (batch, KV
    head): ``[B*KV, S*g, D]`` for q [B,S,KV,g,D] (a query's g heads on
    adjacent rows, so that a range of queries is a range of rows), ``[B*KV,
    S, D]`` for k and v [B,S,KV,D]."""
    x = x.float().transpose(1, 2)
    return x.reshape(x.shape[0] * g_kv, -1, x.shape[-1])


def _flash_fwd_impl(q, k, v, q_pos, k_pos, *, scale, softcap, causal,
                    window, kc, aligned=False):
    """FlashAttention-2 forward: chunked online softmax over K/V.

    q: [B,Sq,KV,g,D]; k: [B,Sk,KV,D]; v: [B,Sk,KV,Dv].  Returns o:
    [B,Sq,KV,g,Dv] in q.dtype and the per-row log-sum-exp [B,KV,g,Sq].

    Each chunk updates only the rows that see one of its keys
    (`_chunk_rows`; ``aligned`` as there).  The softmax state is held for
    the rows from the current chunk's first such row to its last; a row is
    finished once no later chunk reaches it; it is updated out of place,
    so that autograd can differentiate the loop.  The all-chunks loop adds
    exactly zero to the rows left out (their running max is finite, so
    ``exp(-1e30 - m)`` is 0 and the correction 1; a row that has seen no
    key yet has its state wiped by a correction of 0 at its first key),
    so both give the same o and lse.
    """
    b, sq, g_kv, g, _ = q.shape
    d = v.shape[-1]
    rows = _chunk_rows(sq, k.shape[1], kc, aligned, causal=causal,
                       window=window)
    _count_rows(rows, sq, "fwd")
    q2, k2, v2 = (_rows_layout(x, g_kv) for x in (q, k, v))
    nb = q2.shape[0]
    m = q2.new_full((nb, 0), NEG_INF)
    l = q2.new_zeros((nb, 0))
    acc = q2.new_zeros((nb, 0, d))
    first = last = 0                     # the state's rows: [first, last)
    o_parts, lse_parts = [], []

    def open_to(r1):                     # rows that have seen no key yet
        nonlocal m, l, acc, last
        if r1 > last:
            new = (r1 - last) * g
            m = torch.cat([m, m.new_full((nb, new), NEG_INF)], dim=1)
            l = torch.cat([l, l.new_zeros((nb, new))], dim=1)
            acc = torch.cat([acc, acc.new_zeros((nb, new, d))], dim=1)
            last = r1

    def finish_to(r0):                   # rows no later chunk reaches
        nonlocal m, l, acc, first
        if r0 > first:
            done = (r0 - first) * g
            l_done = torch.clamp(l[:, :done], min=1e-30)
            o_parts.append(acc[:, :done] / l_done[..., None])
            lse_parts.append(m[:, :done] + torch.log(l_done))
            m, l, acc = m[:, done:], l[:, done:], acc[:, done:]
            first = r0

    for c0, n, r0, r1, masked in rows:
        # a ragged last chunk is just shorter.  (The reference pads it with
        # zero keys at position -1e9, which the causal test qp >= kp lets
        # through, so its chunked path is wrong when sk % kc != 0.)
        if r1 <= r0:
            continue
        open_to(r1)
        finish_to(r0)
        s = _chunk_scores(q2[:, r0 * g:r1 * g], k2[:, c0:c0 + n], q_pos,
                          k_pos[c0:c0 + n], r0, masked, g, scale=scale,
                          softcap=softcap, causal=causal, window=window)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.bmm(p, v2[:, c0:c0 + n])
        m = m_new
    open_to(sq)
    finish_to(sq)
    o = torch.cat(o_parts, dim=1).view(b, g_kv, sq, g, d)
    lse = torch.cat(lse_parts, dim=1).view(b, g_kv, sq, g)
    return o.transpose(1, 2).to(q.dtype), lse.transpose(2, 3)


def _chunk_scores(q_rows, k_c, q_pos, kp_c, r0, masked, g, *, scale,
                  softcap, causal, window):
    """One KV chunk's scores ``[B*KV, rows*g, n]`` for query rows from
    ``r0`` on (`_rows_layout`), masked (NEG_INF) in the row spans
    ``masked`` only: the other rows see every key of the chunk.  The
    softmax scale is the product's alpha."""
    s = torch.baddbmm(q_rows.new_zeros(()), q_rows, k_c.transpose(1, 2),
                      beta=0, alpha=scale)
    s = softcap_fn(s, softcap)
    for a, b in masked:
        msk = _mask(q_pos[a:b], kp_c, causal=causal, window=window)
        s[:, (a - r0) * g:(b - r0) * g].view(
            s.shape[0], b - a, g, -1).masked_fill_(~msk[:, None], NEG_INF)
    return s


class _Flash(torch.autograd.Function):
    """FlashAttention-2 as an autograd function: the forward is
    `_flash_fwd_impl`, which keeps only the per-row log-sum-exp; the
    backward is the reference's ``_flash_bwd`` (``jax.custom_vjp`` there):
    per KV chunk, recompute the scores, ``p = exp(s - lse)``, ``dV = p^T
    dO``, ``dS = p (dO V^T - delta)`` with ``delta = sum(dO * O)``, the
    softcap's derivative ``1 - (s / cap)^2`` taken only where the score is
    not masked (a masked score is -1e30: its square would overflow and
    0 * inf give NaN), then ``dQ += dS K``, ``dK = dS^T Q`` (the softmax
    scale as those products' alpha).  A ragged last chunk is taken as it is,
    unpadded, as the forward takes it.  Each chunk takes the rows the
    forward took (`_chunk_rows`): on the others p is exactly 0, and so is
    all they would add."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, softcap, causal, window,
                kc, aligned):
        o, lse = _flash_fwd_impl(q, k, v, q_pos, k_pos, scale=scale,
                                 softcap=softcap, causal=causal,
                                 window=window, kc=kc, aligned=aligned)
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos)
        ctx.static = (scale, softcap, causal, window, kc, aligned)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
        scale, softcap, causal, window, kc, aligned = ctx.static
        b, sq, g_kv, g, _ = q.shape
        rows = _chunk_rows(sq, k.shape[1], kc, aligned, causal=causal,
                           window=window)
        _count_rows(rows, sq, "bwd")
        q2, k2, v2, do2 = (_rows_layout(x, g_kv) for x in (q, k, v, do))
        delta = torch.sum(do.float() * o.float(), dim=-1).transpose(1, 2) \
            .reshape(do2.shape[:2])
        lse2 = lse.transpose(2, 3).reshape(delta.shape)
        dq, dk, dv = (torch.zeros_like(x) for x in (q2, k2, v2))
        for c0, n, r0, r1, masked in rows:
            if r1 <= r0:
                continue
            rs, ks = slice(r0 * g, r1 * g), slice(c0, c0 + n)
            s = _chunk_scores(q2[:, rs], k2[:, ks], q_pos, k_pos[ks], r0,
                              masked, g, scale=scale, softcap=softcap,
                              causal=causal, window=window)
            p = torch.exp(s - lse2[:, rs, None])       # [B*KV, rows*g, n]
            dv[:, ks].baddbmm_(p.transpose(1, 2), do2[:, rs], beta=0)
            ds = torch.bmm(do2[:, rs], v2[:, ks].transpose(1, 2))
            ds = ds.sub_(delta[:, rs, None]).mul_(p)
            if softcap:
                sc = torch.where(s > NEG_INF / 2, s, 0.0)
                ds = ds.mul_(1.0 - torch.square(sc / softcap))
            dq[:, rs].baddbmm_(ds, k2[:, ks], alpha=scale)
            dk[:, ks].baddbmm_(ds.transpose(1, 2), q2[:, rs], beta=0,
                               alpha=scale)

        def back(x, like):               # [B*KV, S*g, D] -> like's layout
            return x.view(b, g_kv, like.shape[1], *like.shape[3:]) \
                .transpose(1, 2).to(like.dtype)
        return (back(dq, q), back(dk, k), back(dv, v), None, None, None,
                None, None, None, None, None)


def _sdpa_flash(q, k, v, *, scale, softcap, q_pos, k_pos, causal, window,
                kc: int = 512, aligned: bool = False):
    """Chunked online-softmax attention with the FA-2 backward (`_Flash`).
    q: [B,Sq,KV,g,D]; k: [B,Sk,KV,D]; v: [B,Sk,KV,Dv]; q_pos [Sq]; returns
    o [B,Sq,KV,g,Dv] in q.dtype.  ``aligned``: the host knows the positions
    to be ``p0 + arange(Sq)`` and ``p0 + arange(Sk)`` from one ``p0``; each
    chunk then takes only the query rows that see it (`_chunk_rows`), and
    otherwise every row."""
    return _Flash.apply(q, k, v, q_pos, k_pos, scale, softcap, causal,
                        window, kc, aligned)


def attn_apply(
    p,
    x,
    s: AttnSpec,
    *,
    positions: Optional[torch.Tensor] = None,  # [Sq] or [B, Sq]
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
    ``positions`` None is ``arange(Sq)``, built here: the host then knows
    them, and the chunked path skips the query rows that cannot see a KV
    chunk.
    """
    b, sq, _ = x.shape
    aligned = positions is None          # queries and keys from position 0
    if aligned:
        positions = torch.arange(sq, device=x.device)
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
                        window=window, kc=s.kc, aligned=aligned)
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


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2 §2.1, no query LoRA)
# ---------------------------------------------------------------------------


class MLASpec(NamedTuple):
    d_model: int
    n_heads: int
    kv_lora_rank: int
    qk_nope: int                     # each head's key/query dims without RoPE
    qk_rope: int                     # ... with RoPE (one key shared by heads)
    v_dim: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    kc: int = 512                    # flash KV chunk length


def mla_init(gen: torch.Generator, s: MLASpec, dtype=torch.float32):
    h, dqk = s.n_heads, s.qk_nope + s.qk_rope
    return {
        "wq": linear_init(gen, s.d_model, h * dqk, dtype=dtype),
        "wkv_a": linear_init(gen, s.d_model, s.kv_lora_rank + s.qk_rope,
                             dtype=dtype),
        "kv_norm": rmsnorm_init(s.kv_lora_rank, dtype, gen.device),
        "wkv_b": linear_init(gen, s.kv_lora_rank,
                             h * (s.qk_nope + s.v_dim), dtype=dtype),
        "wo": linear_init(gen, h * s.v_dim, s.d_model, dtype=dtype),
    }


def mla_apply(p, x, s: MLASpec, *, positions: Optional[torch.Tensor] = None,
              abft=None, layer: Optional[int] = None,
              flash_threshold: int = 1024):
    """Causal latent attention over x [B, S, D] (train and prefill, no
    cache) -> y [B, S, D].  Dense attention up to ``flash_threshold``
    keys, the chunked FA-2 path (value dim ``v_dim``) beyond; its chunks
    skip the rows that cannot see them where ``positions`` is None
    (``arange(S)``, built here)."""
    b, sq, _ = x.shape
    aligned = positions is None
    if aligned:
        positions = torch.arange(sq, device=x.device)
    h, dqk = s.n_heads, s.qk_nope + s.qk_rope
    with obs.span("attn/mla", device=True, layer=layer, tokens=b * sq):
        q = linear_apply(p["wq"], x, abft).reshape(b, sq, h, dqk)
        kv_a = linear_apply(p["wkv_a"], x, abft)
        c_kv = rmsnorm_apply(p["kv_norm"], kv_a[..., :s.kv_lora_rank],
                             s.norm_eps)
        k_pe = kv_a[..., s.kv_lora_rank:].reshape(b, sq, 1, s.qk_rope)
        kv = linear_apply(p["wkv_b"], c_kv, abft).reshape(
            b, sq, h, s.qk_nope + s.v_dim)
        pos_b = positions[None] if positions.dim() == 1 else positions
        q_pe = rope(q[..., s.qk_nope:], pos_b, s.rope_theta)
        k_pe = rope(k_pe, pos_b, s.rope_theta).expand(b, sq, h, s.qk_rope)
        q = torch.cat([q[..., :s.qk_nope], q_pe], dim=-1)
        k = torch.cat([kv[..., :s.qk_nope], k_pe], dim=-1)
        v = kv[..., s.qk_nope:]
        qh = q.reshape(b, sq, h, 1, dqk)
        scale = dqk ** -0.5
        if sq <= flash_threshold:
            mask = _mask(positions, positions, causal=True, window=None)
            o = _sdpa_dense(qh, k, v, scale=scale, softcap=None, mask=mask)
        else:
            o = _sdpa_flash(qh, k, v.contiguous(), scale=scale,
                            softcap=None, q_pos=positions, k_pos=positions,
                            causal=True, window=None, kc=s.kc,
                            aligned=aligned)
        o = o.reshape(b, sq, h * s.v_dim).to(x.dtype)
        return linear_apply(p["wo"], o, abft)
