"""The port's model layers, attention and LM against the JAX reference, on
the same numpy inputs and (via ``repro_torch.convert``) the same params.
Everything runs in fp32 here, where the point is the algorithm; the
tolerance is the fp32 one of tests/test_abft_gemm.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke
from repro.core.abft_gemm import ABFTConfig as JCfg
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.core.abft_gemm import ABFTConfig as TCfg
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from torch_port_helpers import assert_close

ABFT = {"off": (None, None),
        "verify": (JCfg(mode="verify", backend="pallas"),
                   TCfg(mode="verify", backend="cuda"))}


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(rs, *shape):
    x = rs.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("check", [False, True])
def test_rmsnorm_matches_reference(rs, check):
    xj, xt = _x(rs, 2, 5, 64)
    sj, st = _x(rs, 64)
    out_j = jl.rmsnorm_apply({"scale": sj}, xj, 1e-6, check=check)
    out_t = tl.rmsnorm_apply({"scale": st}, xt, 1e-6, check=check)
    if check:
        assert bool(out_t[1]) and bool(out_j[1])
        _, bad = tl.rmsnorm_apply({"scale": st}, xt, check=True, inject=0.5)
        assert not bool(bad)
        out_j, out_t = out_j[0], out_t[0]
    assert_close(out_t, out_j)


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_matches_reference(rs, per_slot):
    xj, xt = _x(rs, 2, 7, 4, 16)
    pos = (rs.randint(0, 3000, size=(2, 7)) if per_slot
           else np.arange(7) + 1000)
    out_j = jl.rope(xj, jnp.asarray(pos), 10000.0)
    out_t = tl.rope(xt, torch.from_numpy(pos), 10000.0)
    assert_close(out_t, out_j)


@pytest.mark.parametrize("abft", ["off", "verify"])
def test_mlp_matches_reference(rs, abft):
    pj = jl.mlp_init(jax.random.PRNGKey(0), 64, 128)
    pt = _tree_to_torch(pj)
    xj, xt = _x(rs, 2, 5, 64)
    cj, ct = ABFT[abft]
    assert_close(tl.mlp_apply(pt, xt, abft=ct), jl.mlp_apply(pj, xj, abft=cj))


def test_embed_check_matches_reference(rs):
    tj, tt = _x(rs, 50, 64)
    toks = rs.randint(0, 50, size=(2, 6))
    yj, okj = jl.embed_apply({"table": tj}, jnp.asarray(toks), check=True)
    yt, okt = tl.embed_apply({"table": tt}, torch.from_numpy(toks),
                             check=True)
    assert bool(okt) and bool(okj)
    assert_close(yt, yj)
    _, bad = tl.embed_apply({"table": tt}, torch.from_numpy(toks),
                            check=True, inject=1.0)
    assert not bool(bad)


def _spec_pair(**kw):
    base = dict(d_model=64, n_heads=4, n_kv=2, head_dim=16, qkv_bias=True)
    base.update(kw)
    return jattn.AttnSpec(**base), tattn.AttnSpec(**base)


@pytest.mark.parametrize("abft", ["off", "verify"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_dense_matches_reference(rs, abft, window):
    sj, st = _spec_pair(window=window)
    pj = jattn.attn_init(jax.random.PRNGKey(1), sj)
    pt = _tree_to_torch(pj)
    xj, xt = _x(rs, 2, 12, 64)
    cj, ct = ABFT[abft]
    yj, _ = jattn.attn_apply(pj, xj, sj, positions=jnp.arange(12), abft=cj)
    yt, _ = tattn.attn_apply(pt, xt, st, positions=torch.arange(12), abft=ct)
    assert_close(yt, yj)


def test_attention_prefill_chunked_path_matches_reference(rs):
    """Prefill into a cache longer than flash_threshold takes the chunked
    online-softmax path on both sides (sk = 1536 = 3 chunks of 512): the
    port with the positions passed (every chunk over every row) and with
    none (built from 0, each chunk over the rows that can see it)."""
    sj, st = _spec_pair(kc=512)
    pj = jattn.attn_init(jax.random.PRNGKey(2), sj)
    pt = _tree_to_torch(pj)
    sq, max_len = 40, 1536
    xj, xt = _x(rs, 1, sq, 64)
    cache_j = jattn.make_cache(1, max_len, 2, 16, jnp.float32)
    yj, nj = jattn.attn_apply(pj, xj, sj, positions=jnp.arange(sq),
                              cache=cache_j)
    for positions in (torch.arange(sq), None):
        cache_t = tattn.make_cache(1, max_len, 2, 16, torch.float32)
        yt, nt = tattn.attn_apply(pt, xt, st, positions=positions,
                                  cache=cache_t)
        assert_close(yt, yj)
        assert_close(nt["k"], nj["k"])
        assert int(nt["index"]) == int(nj["index"]) == sq


@pytest.mark.parametrize("sk,kc", [(48, 16), (40, 16), (1100, 512)])
def test_chunked_softmax_matches_dense(rs, sk, kc):
    """The port's chunked path, on both routes (every chunk over every row,
    and each over the rows that see it), equals dense attention, also when
    the last chunk is ragged (sk % kc != 0).  The reference's chunked path
    pads that chunk with keys at position -1e9, which its causal test lets
    through, so it is held here only where sk % kc == 0."""
    b, g_kv, g, d = 1, 2, 2, 8
    q = rs.standard_normal((b, sk, g_kv, g, d)).astype(np.float32)
    k = rs.standard_normal((b, sk, g_kv, d)).astype(np.float32)
    v = rs.standard_normal((b, sk, g_kv, d)).astype(np.float32)
    pos = np.arange(sk)
    mask = jattn._mask(jnp.asarray(pos), jnp.asarray(pos), causal=True,
                       window=None)
    dense = jattn._sdpa_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=d ** -0.5, softcap=None, mask=mask)
    if sk % kc == 0:
        oj = jattn._sdpa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=d ** -0.5, softcap=None,
                               q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                               causal=True, window=None, kc=kc)
    for aligned in (False, True):
        ot, _ = tattn._flash_fwd_impl(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pos), torch.from_numpy(pos), scale=d ** -0.5,
            softcap=None, causal=True, window=None, kc=kc, aligned=aligned)
        assert_close(ot, dense)
        if sk % kc == 0:
            assert_close(ot, oj)


def _lm_pair(seed=0):
    cj, ct = jsmoke("qwen2-0.5b"), tsmoke("qwen2-0.5b")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    pj = jtf.init_params(jax.random.PRNGKey(seed), cj)
    pj_np = jax.tree.map(np.asarray, pj)
    return cj, ct, pj, params_from_jax(pj_np, ct)


@pytest.mark.parametrize("abft", ["off", "verify"])
def test_forward_and_decode_match_reference(rs, abft):
    """Smoke qwen2 (fp32): prefill into a cache, then two decode steps with
    per-slot positions, logits within the fp32 tolerance."""
    cfg_j, cfg_t, pj, pt = _lm_pair()
    aj, at = ABFT[abft]
    toks = rs.randint(0, cfg_j.vocab_size, size=(2, 9))
    cache_j = jtf.init_cache(cfg_j, 2, 32)
    cache_t = ttf.init_cache(cfg_t, 2, 32)
    before = kmm.plain_calls
    lj, cache_j, _ = jtf.forward(pj, jnp.asarray(toks), cfg_j, cache=cache_j,
                                 abft=aj)
    lt, cache_t, _ = ttf.forward(pt, torch.from_numpy(toks), cfg_t,
                                 cache=cache_t, abft=at)
    assert_close(lt, lj)
    n_layers = sum(r * len(p) for p, r in cfg_t.layout)
    if abft == "verify":
        assert kmm.plain_calls - before == 7 * n_layers
    pos = np.array([9, 9])
    tok = np.argmax(np.asarray(lj)[:, -1], axis=-1)[:, None]
    for _ in range(2):
        dj, cache_j = jtf.decode_step(pj, jnp.asarray(tok), jnp.asarray(pos),
                                      cache_j, cfg_j, abft=aj)
        dt, cache_t = ttf.decode_step(pt, torch.from_numpy(tok),
                                      torch.from_numpy(pos), cache_t, cfg_t,
                                      abft=at)
        assert_close(dt, dj)
        tok = np.argmax(np.asarray(dj), axis=-1)[:, None]
        assert np.array_equal(tok[:, 0], dt.argmax(-1).numpy())
        pos = pos + 1


def test_invariants_and_unsupported_kinds(rs):
    cfg_j, cfg_t, pj, pt = _lm_pair(seed=3)
    toks = rs.randint(0, cfg_t.vocab_size, size=(1, 6))
    lj, _, _, okj = jtf.forward(pj, jnp.asarray(toks), cfg_j, invariants=True)
    lt, _, _, okt = ttf.forward(pt, torch.from_numpy(toks), cfg_t,
                                invariants=True)
    assert bool(okt) and bool(okj)
    assert_close(lt, lj)
    # a Mamba block builds and runs (every layer kind of the reference is
    # ported; tests/test_torch_lm_families.py holds them to it)
    cfg_m = cfg_t.scaled(layout=((((("mamba", "dense"),), 1),)))
    pm = ttf.init_params(torch.Generator().manual_seed(0), cfg_m)
    assert sorted(pm["groups"][0][0]["b0"]) == ["mamba", "mlp", "norm1",
                                                "norm2"]
    lm, _, _, okm = ttf.forward(pm, torch.from_numpy(toks), cfg_m,
                                invariants=True)
    assert bool(okm) and lm.shape == (1, 6, cfg_m.vocab_size)
    assert bool(torch.isfinite(lm).all())


def _rows_skipped():
    return tattn.obs.counter("repro_flash_chunk_rows_total").value(
        kind="skipped", direction="fwd")


def test_forward_over_flash_threshold_matches_reference(rs):
    """Smoke qwen2 (fp32) at 1536 tokens, 3 chunks of 512 past the
    1024-key flash threshold: the port's forward, which builds the
    positions itself and so skips the rows a chunk cannot reach, gives
    the reference's logits."""
    cfg_j, cfg_t, pj, pt = _lm_pair(seed=4)
    toks = rs.randint(0, cfg_j.vocab_size, size=(1, 1536))
    lj, _, _ = jtf.forward(pj, jnp.asarray(toks), cfg_j)
    before = _rows_skipped()
    lt, _, _ = ttf.forward(pt, torch.from_numpy(toks), cfg_t)
    assert _rows_skipped() > before
    assert_close(lt, lj)


@pytest.mark.parametrize("layer", ["attn", "attn-window-softcap",
                                   "attn-fresh-cache", "mla", "forward"])
def test_host_known_positions_skip_rows_unknown_take_every_chunk(rs, layer):
    """On the chunked path a layer that builds the positions itself
    (``positions`` None, as `forward` leaves them when its caller gives
    none) skips the query rows that cannot see a chunk; given the
    positions (a caller's, or a prefill at a device index) every chunk
    takes every row.  The outputs agree to fp32 rounding.  Layers: 70
    tokens over chunks of 16 (flash_threshold 16), a prefill into a fresh
    cache of 96, and the model at 1040 tokens."""
    sq = 1040 if layer == "forward" else 70
    pos = torch.arange(sq)
    if layer == "forward":
        cfg = tsmoke("qwen2-0.5b")
        params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
        toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, sq)))

        def run(known):
            return ttf.forward(params, toks, cfg,
                               positions=None if known else pos)[0]
    elif layer == "mla":
        spec = tattn.MLASpec(d_model=64, n_heads=2, kv_lora_rank=16,
                             qk_nope=8, qk_rope=4, v_dim=8, kc=16)
        p = tattn.mla_init(torch.Generator().manual_seed(0), spec)
        x = _x(rs, 1, sq, 64)[1]

        def run(known):
            return tattn.mla_apply(p, x, spec,
                                   positions=None if known else pos,
                                   flash_threshold=16)
    else:
        kw = dict(window=24, softcap=30.0) if layer == "attn-window-softcap" \
            else {}
        sj, spec = _spec_pair(kc=16, **kw)
        p = _tree_to_torch(jattn.attn_init(jax.random.PRNGKey(3), sj))
        x = _x(rs, 2, sq, 64)[1]

        def run(known):
            cache = tattn.make_cache(2, 96, 2, 16, torch.float32) \
                if layer == "attn-fresh-cache" else None
            return tattn.attn_apply(p, x, spec,
                                    positions=None if known else pos,
                                    cache=cache, flash_threshold=16)[0]
    before = _rows_skipped()
    every = run(False)
    assert _rows_skipped() == before
    skipping = run(True)
    assert _rows_skipped() > before
    assert_close(skipping, every, rtol=2e-6)
