"""The oracle of the chunked FA-2 attention's tests: the all-chunks loop
that ran every KV chunk over every query row before each chunk took only
the rows that can see it, copied verbatim (forward, scores and FA-2
backward) from ``repro_torch/models/attention.py``.  Plain PyTorch, no
JAX, so that the tests on a card import it too."""
import torch

from repro_torch.models.attention import NEG_INF, _mask
from repro_torch.models.layers import softcap_fn


def oracle_fwd(q, k, v, q_pos, k_pos, *, scale, softcap, causal,
               window, kc):
    b, sq, g_kv, g, _ = q.shape
    d = v.shape[-1]
    sk = k.shape[1]
    kc = min(kc, sk)
    q32 = q.float()
    m = torch.full((b, g_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, g_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g_kv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, kc):
        k_c, v_c = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
        s = oracle_scores(q32, k_c, q_pos, k_pos[c0:c0 + kc], scale=scale,
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


def oracle_scores(q32, k_c, q_pos, kp_c, *, scale, softcap, causal,
                  window):
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k_c.float()) * scale
    s = softcap_fn(s, softcap)
    msk = _mask(q_pos, kp_c, causal=causal, window=window)
    return torch.where(msk[None, None, None], s, NEG_INF)


def oracle_bwd(do, q, k, v, o, lse, q_pos, k_pos, *, scale, softcap,
               causal, window, kc):
    kc = min(kc, k.shape[1])
    q32 = q.float()
    do32 = do.float().permute(0, 2, 3, 1, 4)            # [B,KV,g,Sq,D]
    delta = torch.sum(do32 * o.float().permute(0, 2, 3, 1, 4), dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for c0 in range(0, k.shape[1], kc):
        k_c, v_c = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
        s = oracle_scores(q32, k_c, q_pos, k_pos[c0:c0 + kc],
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
    return dq, dk, dv
