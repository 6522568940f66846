"""Layered LM over period-group layouts (see configs.base.ModelConfig).

Counterpart of the reference package's ``repro/models/transformer.py``: one
implementation serves all ten configs, and the port's own (Moonlight's
latent attention and DeepSeek-V3 MoE) —
  * mixers: GQA attention (global/local/bidir/cross/dec), latent attention
    (``mla``: training and prefill, no cache), mamba, m/sLSTM;
  * FFN: dense SwiGLU/GeGLU or sort-dispatch MoE (its aux loss summed over
    the layers);
  * the Whisper encoder over precomputed frame embeddings and the vision
    stub's image embeddings, both as the cross-attention source;
  * modes: train/prefill forward, single-token decode with typed caches.

The reference scans stacked params with ``lax.scan``; here
``params["groups"][gi]`` is a list of per-layer param dicts and the forward
is a Python loop over it; Whisper's encoder is a group of one,
``params["encoder"][0]``, so the tree helpers stack it as they stack a
layout group.  The cache keeps the
reference layout — per layout group and pattern slot, each leaf stacked
``[repeats, B, ...]``: ``{"k","v": [.., max_len, n_kv, D], "index"}`` for
attention (``dec`` adds the cross K/V ``ck``/``cv``), ``{"h","conv"}`` for
mamba, ``{"c","n"}`` / ``{"c","n","m"}`` for m/sLSTM — and each layer
writes its slice in place (attention K/V at the write head, a recurrent
state whole); the ``index`` leaves are rebuilt per call.

ABFT protection threads through every projection via `abft`
(core.abft_gemm.ABFTConfig); `None`/mode "off" is the baseline path.  As in
the reference, the MoE router, mamba's ``x_proj``, the xLSTM gates and the
decode-time cross attention over the cached K/V run unprotected.
``loss_fn`` is the training loss; with ``remat`` each block is an
activation checkpoint (``torch.utils.checkpoint``, non-reentrant), the
counterpart of the reference's ``jax.checkpoint`` of its layer scan body
with nothing saved: the block's forward, its protected projections
included, runs again in the backward.  ``remat="dots"`` saves the outputs
of the unbatched matmuls (``aten.mm`` / ``aten.addmm``) and recomputes the
rest, as the reference's ``dots_with_no_batch_dims_saveable`` policy does;
what is recomputed changes, the result does not.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import DeepSeekV3Config, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (
    embed_apply, embed_init, linear_apply, linear_init, mlp_apply, mlp_init,
    rmsnorm_apply, rmsnorm_init, softcap_fn, unembed_apply,
)

_ATTN = ("attn", "attn_local", "attn_bidir")
_NO_LATENT_CACHE = ("latent attention has no cache in the port (a latent "
                    "paged cache would serve it): it runs in training and "
                    "in a prefill without a cache only")
RECURRENT = ("mamba", "mlstm", "slstm")


def _attn_spec(cfg: ModelConfig, kind: str) -> attn.AttnSpec:
    return attn.AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        softcap=cfg.attn_softcap,
        window=cfg.window if kind == "attn_local" else None,
        rope_theta=cfg.rope_theta,
        use_rope=kind not in ("cross",),
        kc=cfg.flash_kc,
    )


def _mamba_spec(cfg: ModelConfig) -> mb.MambaSpec:
    return mb.MambaSpec(cfg.d_model, cfg.d_state, cfg.d_conv, cfg.mamba_expand)


def _xlstm_spec(cfg: ModelConfig) -> xl.XLSTMSpec:
    return xl.XLSTMSpec(cfg.d_model, cfg.n_heads)


def _moe_spec(cfg: ModelConfig):
    if isinstance(cfg, DeepSeekV3Config):
        return moe_mod.DroplessMoESpec(
            cfg.d_model, cfg.moe_dff or cfg.d_ff, cfg.n_experts, cfg.top_k,
            routed_scale=cfg.routed_scale, n_shared=cfg.n_shared_experts)
    return moe_mod.MoESpec(cfg.d_model, cfg.moe_dff or cfg.d_ff,
                           cfg.n_experts, cfg.top_k, cfg.capacity_factor,
                           cfg.moe_groups)


def _mla_spec(cfg: ModelConfig) -> attn.MLASpec:
    return attn.MLASpec(cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                        cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim, cfg.rope_theta, cfg.norm_eps,
                        cfg.flash_kc)


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def is_recurrent(cfg: ModelConfig) -> bool:
    """Does any block carry a recurrent state (mamba, mLSTM, sLSTM)?  Its
    prefill must then see exactly the prompt: a pad token would enter the
    state."""
    return any(mixer in RECURRENT
               for pattern, _ in cfg.layout for mixer, _ in pattern)


# ---------------------------------------------------------------------------
# Block init / cache / apply
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg: ModelConfig, mixer: str,
                ffn: str):
    dt, dev = _dtype(cfg), gen.device
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dt, dev)}
    if mixer in _ATTN or mixer == "cross":
        p["attn"] = attn.attn_init(gen, _attn_spec(cfg, mixer), dt)
    elif mixer == "mla":
        p["attn"] = attn.mla_init(gen, _mla_spec(cfg), dt)
    elif mixer == "dec":
        p["attn"] = attn.attn_init(gen, _attn_spec(cfg, "attn"), dt)
        p["cross"] = attn.attn_init(gen, _attn_spec(cfg, "cross"), dt)
        p["norm_c"] = rmsnorm_init(cfg.d_model, dt, dev)
    elif mixer == "mamba":
        p["mamba"] = mb.mamba_init(gen, _mamba_spec(cfg), dt)
    elif mixer == "mlstm":
        p["mlstm"] = xl.mlstm_init(gen, _xlstm_spec(cfg), dt)
    elif mixer == "slstm":
        p["slstm"] = xl.slstm_init(gen, _xlstm_spec(cfg), dt)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt)
    elif ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["moe"] = moe_mod.moe_init(gen, _moe_spec(cfg), dt)
    elif ffn != "none":
        raise ValueError(f"unknown ffn {ffn!r}")
    return p


def _block_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                 device=None):
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    if mixer in ("attn", "attn_local", "dec"):
        c = attn.make_cache(batch, max_len, cfg.n_kv_heads, hd, dt, device)
        if mixer == "dec":
            # cross K/V computed once at prefill, reused each decode step
            shape = (batch, cfg.n_frames, cfg.n_kv_heads, hd)
            c["ck"] = torch.zeros(shape, dtype=dt, device=device)
            c["cv"] = torch.zeros(shape, dtype=dt, device=device)
        return c
    if mixer == "mla":
        raise NotImplementedError(_NO_LATENT_CACHE)
    if mixer == "mamba":
        return mb.mamba_init_state(_mamba_spec(cfg), batch, dt, device)
    if mixer == "mlstm":
        return xl.mlstm_init_state(_xlstm_spec(cfg), batch, device)
    if mixer == "slstm":
        return xl.slstm_init_state(_xlstm_spec(cfg), batch, device)
    # bidir / cross: stateless
    return {"_empty": torch.zeros((batch,), dtype=torch.int8, device=device)}


def _block_apply(p, x, cfg: ModelConfig, mixer: str, ffn: str, *,
                 positions, cache=None, cross_src=None, abft=None,
                 invariants: bool = False, layer=None, moe_load=None):
    """Returns (x, new_cache, aux_loss, inv_ok).

    ``invariants=True`` runs each rmsnorm through its second-moment
    construction check; ``inv_ok`` is the AND of every check.  ``layer``
    (the block's index) names the latent attention's and the dropless
    MoE's spans; ``moe_load`` collects the experts the dropless MoE's
    tokens chose.  ``positions`` None is ``arange(S)``, which the
    attention layers build themselves (`attention.attn_apply`).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ok = torch.ones((), dtype=torch.bool, device=x.device)

    def norm(pn, xx):
        if invariants:
            return rmsnorm_apply(pn, xx, cfg.norm_eps, check=True)
        return rmsnorm_apply(pn, xx, cfg.norm_eps), ok

    h, ok1 = norm(p["norm1"], x)
    ok = ok & ok1
    new_cache = cache
    if mixer in _ATTN:
        y, new_cache = attn.attn_apply(
            p["attn"], h, _attn_spec(cfg, mixer), positions=positions,
            causal=(mixer != "attn_bidir"), cache=cache, abft=abft)
    elif mixer == "mla":
        if cache is not None:
            raise NotImplementedError(_NO_LATENT_CACHE)
        y = attn.mla_apply(p["attn"], h, _mla_spec(cfg), positions=positions,
                           abft=abft, layer=layer)
    elif mixer == "cross":
        y, _ = attn.attn_apply(p["attn"], h, _attn_spec(cfg, mixer),
                               positions=positions, causal=False,
                               cross_kv=cross_src, abft=abft)
    elif mixer == "dec":
        y, self_cache = attn.attn_apply(
            p["attn"], h, _attn_spec(cfg, "attn"), positions=positions,
            causal=True,
            cache={k: cache[k] for k in ("k", "v", "index")}
            if cache is not None else None, abft=abft)
        if cache is not None:
            new_cache = {**cache, **self_cache}
        x = x + y
        hc, okc = norm(p["norm_c"], x)
        ok = ok & okc
        cspec = _attn_spec(cfg, "cross")
        if cross_src is not None:
            y, _ = attn.attn_apply(p["cross"], hc, cspec, positions=positions,
                                   causal=False, cross_kv=cross_src,
                                   abft=abft)
            if cache is not None:  # stash the cross K/V for decode
                k = linear_apply(p["cross"]["wk"], cross_src, abft)
                v = linear_apply(p["cross"]["wv"], cross_src, abft)
                new_cache["ck"].copy_(k.reshape(k.shape[0], -1, cspec.n_kv,
                                                cspec.head_dim))
                new_cache["cv"].copy_(v.reshape(v.shape[0], -1, cspec.n_kv,
                                                cspec.head_dim))
        else:  # decode: attend over the cached cross K/V
            y = _cross_from_cache(p["cross"], hc, cspec, cache)
    elif mixer == "mamba":
        spec = _mamba_spec(cfg)
        if cache is None:
            y = mb.mamba_apply(p["mamba"], h, spec, abft=abft)
        elif h.shape[1] == 1:
            y, new_cache = mb.mamba_decode_step(p["mamba"], h, cache, spec,
                                                abft)
        else:  # prefill from the cached state; emit the state for decode
            y, new_cache = mb.mamba_apply(p["mamba"], h, spec, abft=abft,
                                          return_state=True, state=cache)
    elif mixer == "mlstm":
        spec = _xlstm_spec(cfg)
        if cache is None:
            y = xl.mlstm_apply(p["mlstm"], h, spec, abft=abft)
        elif h.shape[1] == 1:
            y, new_cache = xl.mlstm_decode_step(p["mlstm"], h, cache, spec,
                                                abft)
        else:
            y, new_cache = xl.mlstm_apply(p["mlstm"], h, spec, abft=abft,
                                          return_state=True, state=cache)
    elif mixer == "slstm":
        spec = _xlstm_spec(cfg)
        if cache is None:
            y = xl.slstm_apply(p["slstm"], h, spec, abft=abft)
        elif h.shape[1] == 1:
            y, new_cache = xl.slstm_decode_step(p["slstm"], h, cache, spec,
                                                abft)
        else:
            y, new_cache = xl.slstm_apply(p["slstm"], h, spec, abft=abft,
                                          return_state=True, state=cache)
    else:
        raise ValueError(mixer)
    x = x + y
    if ffn in ("dense", "moe"):
        h2, ok2 = norm(p["norm2"], x)
        ok = ok & ok2
        if ffn == "dense":
            y2 = mlp_apply(p["mlp"], h2, activation=cfg.activation, abft=abft)
        else:
            y2, aux = moe_mod.moe_apply(p["moe"], h2, _moe_spec(cfg), abft,
                                        layer=layer, load=moe_load)
        x = x + y2
    return x, new_cache, aux, ok


def _cross_from_cache(p_cross, h, spec: attn.AttnSpec, cache):
    """Decode-time cross attention over the cached encoder K/V (unprotected,
    as in the reference)."""
    b, sq, _ = h.shape
    q = linear_apply(p_cross["wq"], h).reshape(b, sq, spec.n_heads,
                                               spec.head_dim)
    k, v = cache["ck"], cache["cv"]
    g = spec.n_heads // spec.n_kv
    qh = q.reshape(b, sq, spec.n_kv, g, spec.head_dim)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=h.device)
    o = attn._sdpa_dense(qh, k, v, scale=spec.head_dim ** -0.5,
                         softcap=spec.softcap, mask=mask)
    o = o.reshape(b, sq, spec.n_heads * spec.head_dim).to(h.dtype)
    return linear_apply(p_cross["wo"], o)


# ---------------------------------------------------------------------------
# Model init / forward / decode
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random params from ``gen``, placed on ``gen.device``: ``groups[gi]``
    is a list of ``repeats`` dicts ``{"b{bi}": block params}``, and
    ``encoder`` (Whisper) one such group: ``[[n_enc_layers block
    params]]``."""
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype=dt)
    if cfg.n_enc_layers:  # whisper encoder over the frame embeddings
        params["encoder"] = [[_block_init(gen, cfg, "attn_bidir", "dense")
                              for _ in range(cfg.n_enc_layers)]]
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dt, gen.device)
    params["groups"] = [
        [{f"b{bi}": _block_init(gen, cfg, mixer, ffn)
          for bi, (mixer, ffn) in enumerate(pattern)}
         for _ in range(repeats)]
        for pattern, repeats in cfg.layout]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    groups = []
    for pattern, repeats in cfg.layout:
        slots = {}
        for bi, (mixer, _ffn) in enumerate(pattern):
            one = _block_cache(cfg, mixer, batch, max_len, device)
            slots[f"b{bi}"] = {
                name: x[None].repeat((repeats,) + (1,) * x.dim())
                for name, x in one.items()}
        groups.append(slots)
    return {"groups": groups}


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saved(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_kw(remat) -> dict:
    """``torch.utils.checkpoint`` arguments for a remat policy: True (save
    nothing) or "dots" (save the unbatched matmuls' outputs)."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        import functools
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saved)
    return kw


def _run_groups(params, x, cfg: ModelConfig, *, positions, cache, abft,
                cross_src=None, invariants: bool = False, remat=False,
                moe_load=None):
    """Loop over every layout group; returns (x, new_cache, aux, inv_ok).

    Attention K/V (and a ``dec`` block's cross K/V) are written in place
    into the stacked cache; a recurrent block's new state is copied into
    its layer's slice; the per-layer cache indices are gathered into a
    fresh ``index`` leaf per pattern slot.  ``remat`` (training, no cache)
    checkpoints each block: True saves nothing, "dots" the unbatched
    matmuls' outputs.
    """
    new_groups = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ok_total = torch.ones((), dtype=torch.bool, device=x.device)
    li = -1                              # the block's index in the stack
    for gi, (pattern, _repeats) in enumerate(cfg.layout):
        gcache = cache["groups"][gi] if cache is not None else None
        new_index = {f"b{bi}": [] for bi in range(len(pattern))}
        for r, layer in enumerate(params["groups"][gi]):
            for bi, (mixer, ffn) in enumerate(pattern):
                key = f"b{bi}"
                li += 1
                c_in = None
                if gcache is not None:
                    c_in = {name: leaf[r] for name, leaf in gcache[key].items()}
                if remat and c_in is None:
                    def body(h, lp, src, mixer=mixer, ffn=ffn, li=li):
                        out = _block_apply(lp, h, cfg, mixer, ffn,
                                           positions=positions,
                                           cross_src=src, abft=abft,
                                           invariants=invariants,
                                           layer=li, moe_load=moe_load)
                        return out[0], out[2], out[3]
                    # the blocks draw no random numbers: no RNG state to keep
                    x, aux, ok_b = torch.utils.checkpoint.checkpoint(
                        body, x, layer[key], cross_src,
                        **_checkpoint_kw(remat))
                    c_out = None
                else:
                    x, c_out, aux, ok_b = _block_apply(
                        layer[key], x, cfg, mixer, ffn, positions=positions,
                        cache=c_in, cross_src=cross_src, abft=abft,
                        invariants=invariants, layer=li, moe_load=moe_load)
                aux_total = aux_total + aux
                ok_total = ok_total & ok_b
                if c_out is None:
                    continue
                for name, new in c_out.items():
                    if name == "index":
                        new_index[key].append(new)
                    elif new is not c_in[name]:
                        c_in[name].copy_(new)
        if gcache is not None:
            new_groups.append({
                key: ({**gcache[key], "index": torch.stack(new_index[key])}
                      if new_index[key] else gcache[key])
                for key in gcache})
    new_cache = {"groups": new_groups} if cache is not None else None
    return x, new_cache, aux_total, ok_total


def _encode_frames(params, frames, cfg: ModelConfig):
    """Whisper encoder over precomputed frame embeddings (conv stub).  As in
    the reference, the encoder's projections run unprotected."""
    x = frames
    for layer in params["encoder"][0]:
        x = _block_apply(layer, x, cfg, "attn_bidir", "dense",
                         positions=None)[0]
    return rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg: ModelConfig, *, positions=None, cache=None,
            frames=None, img_emb=None, abft=None, return_hidden: bool = False,
            invariants: bool = False, remat=False, moe_load=None):
    """Train/prefill forward. tokens: [B,S] -> logits [B,S,V] fp32.

    frames: [B, n_frames, d_model] (whisper stub input);
    img_emb: [B, n_img_tokens, d_model] (vlm stub input).
    return_hidden: skip the unembedding and return the post-final-norm
    hidden state [B,S,D] instead of logits.
    invariants: run the embedding-gather and rmsnorm construction checks
    and return a 4-tuple (..., inv_ok).
    remat: checkpoint each block (training without a cache); True saves
    nothing, "dots" the unbatched matmuls' outputs.
    moe_load: a dict that gets, for each dropless MoE block's index, the
    experts each token chose ([B*S, k] on the device).
    The tied unembedding reads ``params["embed"]["table_f32"]`` when
    present (an fp32 copy the serving engine caches once) instead of
    casting the table on every call; the numbers are the same.
    ``positions`` None is ``arange(S)``; the attention layers build it, and
    their chunked path then skips the rows that cannot see a KV chunk.
    """
    if invariants:
        x, ok_embed = embed_apply(params["embed"], tokens, check=True)
    else:
        x = embed_apply(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    cross_src = None
    if cfg.n_enc_layers and frames is not None:
        cross_src = _encode_frames(params, frames, cfg)
    elif img_emb is not None:
        cross_src = img_emb
    x, new_cache, aux, ok_run = _run_groups(params, x, cfg,
                                            positions=positions, cache=cache,
                                            cross_src=cross_src, abft=abft,
                                            invariants=invariants,
                                            remat=remat, moe_load=moe_load)
    if invariants:
        x, ok_fn = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                                 check=True)
        inv_ok = ok_embed & ok_run & ok_fn
    else:
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        out = x
    else:
        head = params.get("lm_head")
        if head is None:
            table32 = params["embed"].get("table_f32")
            if table32 is None:
                table32 = params["embed"]["table"].float()
            out = softcap_fn(torch.matmul(x.float(), table32.T),
                             cfg.final_softcap)
        else:
            out = unembed_apply(head, x, softcap=cfg.final_softcap, abft=abft)
    return (out, new_cache, aux, inv_ok) if invariants else \
        (out, new_cache, aux)


def decode_step(params, token, pos, cache, cfg: ModelConfig, *,
                img_emb=None, abft=None, return_hidden: bool = False):
    """One-token decode. token: [B,1]; pos: scalar (lockstep batch) or
    [B] vector (continuous batching: per-slot positions).
    return_hidden: return the post-final-norm hidden [B,1,D] instead of
    logits [B,V]."""
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    out, new_cache, _ = forward(params, token, cfg, positions=positions,
                                cache=cache, img_emb=img_emb, abft=abft,
                                return_hidden=return_hidden)
    if return_hidden:
        return out, new_cache
    return out[:, -1], new_cache


def loss_fn(params, tokens, labels, cfg: ModelConfig, *, frames=None,
            img_emb=None, abft=None, remat=False, aux_weight: float = 0.01,
            invariants: bool = False, moe_load=None):
    """Scalar LM loss (mean next-token NLL + ``aux_weight`` x aux, the MoE
    load-balance loss summed over the layers); with ``invariants=True``
    returns ``(loss, inv_ok)``.  ``moe_load`` as in `forward`."""
    out = forward(params, tokens, cfg, frames=frames, img_emb=img_emb,
                  abft=abft, remat=remat, invariants=invariants,
                  moe_load=moe_load)
    logits, aux = out[0], out[2]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(nll) + aux_weight * aux
    return (loss, out[3]) if invariants else loss


def param_count(params) -> int:
    """Elements over every leaf of a param tree (tensors or meta
    tensors)."""
    from repro_torch.tree import tree_leaves
    return sum(x.numel() for x in tree_leaves(params))


def is_buffer(path) -> bool:
    """Is the param at ``path`` a buffer the train step sets itself rather
    than a weight it trains: the dropless MoE's selection bias
    (``[..., "moe", "bias"]``)."""
    keys = [k for k in path if isinstance(k, str)]
    return keys[-2:] == ["moe", "bias"]


def active_param_count(cfg: ModelConfig, params=None) -> int:
    """N for MODEL_FLOPS: non-embedding params, routed experts scaled by
    k/E (shared experts count whole), buffers (`is_buffer`) not at all.

    Counted over the reference's stacked leaves (`tree.stack_layers`), so
    that the per-leaf rounding of the expert share is the reference's;
    ``params`` None counts the config's shapes on the meta device."""
    from repro_torch.dist.sharding import map_with_path, stacked_shapes
    if params is None:
        from repro_torch.train.step import state_shapes
        params = state_shapes(cfg)["params"]
    sizes = []

    def visit(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        size = leaf.numel()
        if "table" in keys or is_buffer(path):
            size = 0
        elif keys[-1:] in (["gate"], ["up"], ["down"]) \
                and keys[-2:-1] == ["moe"]:
            size = int(size * cfg.top_k / max(cfg.n_experts, 1))
        sizes.append(size)
        return leaf

    map_with_path(visit, stacked_shapes(params))
    return sum(sizes)
