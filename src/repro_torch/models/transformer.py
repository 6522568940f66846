"""Layered LM over period-group layouts (see configs.base.ModelConfig).

Counterpart of the reference package's ``repro/models/transformer.py`` for
the layer kinds the port runs so far: ``attn`` / ``attn_local`` /
``attn_bidir`` mixers with a ``dense`` SwiGLU/GeGLU FFN.  The reference
scans stacked params with ``lax.scan``; here ``params["groups"][gi]`` is a
list of per-layer param dicts and the forward is a Python loop over it.
The KV cache keeps the reference layout — per layout group and pattern slot
``{"k","v": [repeats, B, max_len, n_kv, D], "index": [repeats] or
[repeats, B]}`` — and each layer writes its slice in place.

ABFT protection threads through every projection via `abft`
(core.abft_gemm.ABFTConfig); `None`/mode "off" is the baseline path.
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

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_apply, embed_init, linear_init, mlp_apply, mlp_init, rmsnorm_apply,
    rmsnorm_init, softcap_fn, unembed_apply,
)

_ATTN = ("attn", "attn_local", "attn_bidir")
_LATER = ("the protected-LM slice brings the other mixers (cross, dec, "
          "mamba, mlstm, slstm), MoE and the encoder-decoder and vision "
          "stubs")


def _unsupported(what: str):
    return NotImplementedError(f"{what} is not ported yet: {_LATER}")


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
        use_rope=True,
        kc=cfg.flash_kc,
    )


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Block init / cache / apply
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg: ModelConfig, mixer: str,
                ffn: str):
    dt = _dtype(cfg)
    if mixer not in _ATTN:
        raise _unsupported(f"mixer {mixer!r}")
    p: Dict[str, Any] = {
        "norm1": rmsnorm_init(cfg.d_model, dt, gen.device),
        "attn": attn.attn_init(gen, _attn_spec(cfg, mixer), dt),
    }
    if ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, gen.device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt)
    elif ffn != "none":
        raise _unsupported(f"ffn {ffn!r}")
    return p


def _block_apply(p, x, cfg: ModelConfig, mixer: str, ffn: str, *,
                 positions, cache=None, abft=None, invariants: bool = False):
    """Returns (x, new_cache, aux_loss, inv_ok).

    ``invariants=True`` runs each rmsnorm through its second-moment
    construction check; ``inv_ok`` is the AND of every check.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ok = torch.ones((), dtype=torch.bool, device=x.device)

    def norm(pn, xx):
        if invariants:
            return rmsnorm_apply(pn, xx, cfg.norm_eps, check=True)
        return rmsnorm_apply(pn, xx, cfg.norm_eps), ok

    if mixer not in _ATTN:
        raise _unsupported(f"mixer {mixer!r}")
    h, ok1 = norm(p["norm1"], x)
    ok = ok & ok1
    y, new_cache = attn.attn_apply(
        p["attn"], h, _attn_spec(cfg, mixer), positions=positions,
        causal=(mixer != "attn_bidir"), cache=cache, abft=abft)
    x = x + y
    if ffn == "dense":
        h2, ok2 = norm(p["norm2"], x)
        ok = ok & ok2
        x = x + mlp_apply(p["mlp"], h2, activation=cfg.activation, abft=abft)
    elif ffn != "none":
        raise _unsupported(f"ffn {ffn!r}")
    return x, new_cache, aux, ok


# ---------------------------------------------------------------------------
# Model init / forward / decode
# ---------------------------------------------------------------------------


def _check_supported(cfg: ModelConfig):
    if cfg.n_enc_layers or cfg.n_img_tokens:
        raise _unsupported(f"{cfg.name}'s encoder / image inputs")


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random params from ``gen``, placed on ``gen.device``: ``groups[gi]``
    is a list of ``repeats`` dicts ``{"b{bi}": block params}``."""
    _check_supported(cfg)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype=dt)
    params["groups"] = [
        [{f"b{bi}": _block_init(gen, cfg, mixer, ffn)
          for bi, (mixer, ffn) in enumerate(pattern)}
         for _ in range(repeats)]
        for pattern, repeats in cfg.layout]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    groups = []
    for pattern, repeats in cfg.layout:
        slots = {}
        for bi, (mixer, _ffn) in enumerate(pattern):
            if mixer not in ("attn", "attn_local"):
                raise _unsupported(f"a decode cache for mixer {mixer!r}")
            shape = (repeats, batch, max_len, cfg.n_kv_heads, hd)
            slots[f"b{bi}"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "index": torch.zeros((repeats,), dtype=torch.int64,
                                     device=device),
            }
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
                invariants: bool = False, remat=False):
    """Loop over every layout group; returns (x, new_cache, aux, inv_ok).

    K/V are written in place into the stacked cache; the per-layer cache
    indices are gathered into a fresh ``index`` leaf per pattern slot.
    ``remat`` (training, no cache) checkpoints each block: True saves
    nothing, "dots" the unbatched matmuls' outputs.
    """
    new_groups = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ok_total = torch.ones((), dtype=torch.bool, device=x.device)
    for gi, (pattern, _repeats) in enumerate(cfg.layout):
        gcache = cache["groups"][gi] if cache is not None else None
        new_index = {f"b{bi}": [] for bi in range(len(pattern))}
        for r, layer in enumerate(params["groups"][gi]):
            for bi, (mixer, ffn) in enumerate(pattern):
                key = f"b{bi}"
                c_in = None
                if gcache is not None:
                    c_in = {name: leaf[r] for name, leaf in gcache[key].items()}
                if remat and c_in is None:
                    def body(h, lp, mixer=mixer, ffn=ffn):
                        out = _block_apply(lp, h, cfg, mixer, ffn,
                                           positions=positions, abft=abft,
                                           invariants=invariants)
                        return out[0], out[2], out[3]
                    # the blocks draw no random numbers: no RNG state to keep
                    x, aux, ok_b = torch.utils.checkpoint.checkpoint(
                        body, x, layer[key], **_checkpoint_kw(remat))
                    c_out = None
                else:
                    x, c_out, aux, ok_b = _block_apply(
                        layer[key], x, cfg, mixer, ffn, positions=positions,
                        cache=c_in, abft=abft, invariants=invariants)
                aux_total = aux_total + aux
                ok_total = ok_total & ok_b
                if c_out is not None:
                    new_index[key].append(c_out["index"])
        if gcache is not None:
            new_groups.append({
                key: {**gcache[key], "index": torch.stack(new_index[key])}
                for key in gcache})
    new_cache = {"groups": new_groups} if cache is not None else None
    return x, new_cache, aux_total, ok_total


def forward(params, tokens, cfg: ModelConfig, *, positions=None, cache=None,
            abft=None, return_hidden: bool = False, invariants: bool = False,
            remat=False):
    """Train/prefill forward. tokens: [B,S] -> logits [B,S,V] fp32.

    return_hidden: skip the unembedding and return the post-final-norm
    hidden state [B,S,D] instead of logits.
    invariants: run the embedding-gather and rmsnorm construction checks
    and return a 4-tuple (..., inv_ok).
    remat: checkpoint each block (training without a cache); True saves
    nothing, "dots" the unbatched matmuls' outputs.
    The tied unembedding reads ``params["embed"]["table_f32"]`` when
    present (an fp32 copy the serving engine caches once) instead of
    casting the table on every call; the numbers are the same.
    """
    _check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    if invariants:
        x, ok_embed = embed_apply(params["embed"], tokens, check=True)
    else:
        x = embed_apply(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x, new_cache, aux, ok_run = _run_groups(params, x, cfg,
                                            positions=positions, cache=cache,
                                            abft=abft, invariants=invariants,
                                            remat=remat)
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


def decode_step(params, token, pos, cache, cfg: ModelConfig, *, abft=None,
                return_hidden: bool = False):
    """One-token decode. token: [B,1]; pos: scalar (lockstep batch) or
    [B] vector (continuous batching: per-slot positions).
    return_hidden: return the post-final-norm hidden [B,1,D] instead of
    logits [B,V]."""
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    out, new_cache, _ = forward(params, token, cfg, positions=positions,
                                cache=cache, abft=abft,
                                return_hidden=return_hidden)
    if return_hidden:
        return out, new_cache
    return out[:, -1], new_cache


def loss_fn(params, tokens, labels, cfg: ModelConfig, *, abft=None,
            remat=False, aux_weight: float = 0.01,
            invariants: bool = False):
    """Scalar LM loss (mean next-token NLL + ``aux_weight`` x aux); with
    ``invariants=True`` returns ``(loss, inv_ok)``."""
    out = forward(params, tokens, cfg, abft=abft, remat=remat,
                  invariants=invariants)
    logits, aux = out[0], out[2]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(nll) + aux_weight * aux
    return (loss, out[3]) if invariants else loss
