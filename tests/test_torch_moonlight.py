"""Moonlight-16B-A3B in the port against its plain float32 reference
(``portbench/reference/moonlight.py``), at the config's smoke size on
seeded random weights: a dense layer and two MoE layers of 8 experts top-2,
a small latent attention whose value dim differs from its query/key dim.

Held: the forward logits, the loss and every parameter's gradient; one
train step's update of every tensor, the selection bias's included;
latent attention's chunked path against its dense path, forward and
backward; a batch that overloads one expert drops nothing; the grouped
checked product against per-expert ``abft_matmul``, with one flipped
element in each row located and repaired; Qwen3-30B-A3B's smoke MoE output
bit for bit as before the dropless path came; the registry and the shapes
at the published widths."""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.reference import moonlight as ref
from repro.configs import list_configs as jlist
from repro_torch import obs
from repro_torch.configs import base as cbase
from repro_torch.core import abft_gemm as ag
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ops as kops
from repro_torch.launch.serve import cut_layers
from repro_torch.models import attention as attn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import (StepOptions, build_train_step,
                                    init_state, state_shapes)
from repro_torch.tree import tree_leaves_with_path, tree_map

ARCH = "moonlight-16b-a3b"
CFG = cbase.smoke_config(ARCH)
# ABFT "correct" on the kernels' plain versions (backend "cuda" on a CPU
# tensor), as the train step takes it on the card
ABFT = ag.ABFTConfig(mode="correct", backend="cuda")
# fp32 sums in another order (and the checked products' plain versions)
# agree with the reference to a few ulps of the largest term
RTOL = 2e-5
# the sequence-wise balance loss's weight (alpha), as the benchmark's cell
# assumes it and hands it to the step (StepOptions.aux_weight)
ALPHA = 1e-4


def ref_cfg(cfg):
    """The reference's configuration (published key names) of ``cfg``."""
    return dict(
        hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        n_routed_experts=cfg.n_experts, num_experts_per_tok=cfg.top_k,
        moe_intermediate_size=cfg.moe_dff,
        n_shared_experts=cfg.n_shared_experts,
        routed_scaling_factor=cfg.routed_scale, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps, aux_loss_alpha=ALPHA,
        bias_update_speed=cfg.bias_update_rate)


def _state(seed=0, bias=0.05):
    state = init_state(torch.Generator().manual_seed(seed), CFG)
    # a selection bias that matters: drawn, not zero
    g = torch.Generator().manual_seed(seed + 1)
    for layer in ref.layers(state["params"]):
        if "moe" in layer:
            layer["moe"]["bias"] = bias * torch.randn(CFG.n_experts,
                                                      generator=g)
    return state


def _batch(seed=2, b=2, s=24):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, CFG.vocab_size, (b, s + 1), generator=g)
    return x[:, :-1], x[:, 1:]


def _close(got, want, rtol=RTOL):
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=rtol * scale + 1e-30)


def test_forward_loss_and_every_gradient_match_the_reference():
    params = _state()["params"]
    tokens, labels = _batch()
    logits, _, aux = tf.forward(params, tokens, CFG, abft=ABFT)
    loss = tf.loss_fn(params, tokens, labels, CFG, abft=ABFT,
                      aux_weight=ALPHA)
    rp = tree_map(lambda t: t.clone().requires_grad_(t.is_floating_point()),
                  params)
    want_logits, want_aux, _ = ref.forward(rp, tokens, ref_cfg(CFG))
    want_loss, _ = ref.loss(rp, tokens, labels, ref_cfg(CFG))
    _close(logits, want_logits)
    _close(aux, want_aux)
    _close(loss, want_loss)
    assert float(aux) > 0
    # every gradient, through the checked products' VJPs
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    got = torch.autograd.grad(
        tf.loss_fn(live, tokens, labels, CFG, abft=ABFT,
                   aux_weight=ALPHA),
        [t for path, t in tree_leaves_with_path(live)
         if not tf.is_buffer(path)])
    want_loss.backward()
    wants = [t.grad for path, t in tree_leaves_with_path(rp)
             if not tf.is_buffer(path)]
    assert len(got) == len(wants) > 30
    for (path, _), g, w in zip(
            [pl for pl in tree_leaves_with_path(rp)
             if not tf.is_buffer(pl[0])], got, wants):
        assert w is not None, path
        _close(g, w, rtol=1e-4)


def test_a_train_step_updates_every_tensor_as_the_reference():
    """One step of the port's train step (ABFT correct, every forward
    projection checked, the experts' on the grouped product): the loss and
    the new value of every tensor, the selection bias moved by its load,
    against the reference's AdamW step from the same state and batch."""
    state = _state(seed=3)
    tokens, labels = _batch(seed=4)
    adamw = AdamWConfig(warmup_steps=2, total_steps=20)
    opts = StepOptions(abft_mode="correct", abft_backend="cuda", remat=False,
                       aux_weight=ALPHA)
    step = build_train_step(CFG, cbase.ShapeConfig("t", 24, 2, "train"),
                            adamw, opts)
    kmm.reset_counts()
    before = tree_map(lambda t: t.clone(), state)
    new, metrics = step(state, {"tokens": tokens, "labels": labels})
    # every routed expert's product on the grouped path: 3 a MoE layer
    n_moe = sum(r for pattern, r in CFG.layout if pattern[0][1] == "moe")
    assert kmm.grouped_plain_calls == 3 * n_moe
    rp = tree_map(lambda t: t.clone().requires_grad_(t.is_floating_point()),
                  before["params"])
    chosen = []
    want_loss, loads = ref.loss(rp, tokens, labels, ref_cfg(CFG),
                                chosen=chosen)
    want_loss.backward()
    _close(metrics["loss"], want_loss)
    # the experts the step's tokens chose, as the reference chose them
    picked = step.moe_chosen
    assert len(picked) == n_moe == len(chosen)
    for li, want in zip(sorted(picked), chosen):
        assert torch.equal(picked[li], want)
    grads = [(path, t.grad) for path, t in tree_leaves_with_path(rp)
             if not tf.is_buffer(path)]
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for _, g in grads)))
    _close(metrics["grad_norm"], torch.tensor(gnorm))
    hp = dataclasses.asdict(adamw)
    moe_layers = [layer for layer in ref.layers(before["params"])
                  if "moe" in layer]
    got = dict(tree_leaves_with_path(new["params"]))
    got_m = dict(tree_leaves_with_path(new["opt"]["m"]))
    got_v = dict(tree_leaves_with_path(new["opt"]["v"]))
    m_old = dict(tree_leaves_with_path(before["opt"]["m"]))
    v_old = dict(tree_leaves_with_path(before["opt"]["v"]))
    for path, g in grads:
        p_old = dict(tree_leaves_with_path(before["params"]))[path]
        want, m_want, v_want = ref.adamw_step(p_old, g, m_old[path],
                                              v_old[path], 1, gnorm, hp)
        _close(got_m[path], m_want, rtol=1e-4)
        _close(got_v[path], v_want, rtol=1e-4)
        # by the update's norm: Adam's first step g / (|g| + eps) turns on
        # rounding where a gradient element is near zero
        d_want = (want - p_old).double()
        err = (got[path] - p_old).double() - d_want
        assert float(err.norm() / d_want.norm()) < 1e-4, path
    for layer, load, new_layer in zip(
            moe_layers, loads,
            [x for x in ref.layers(new["params"]) if "moe" in x]):
        want = ref.bias_step(layer["moe"]["bias"], load[:-1], ref_cfg(CFG))
        assert torch.equal(new_layer["moe"]["bias"], want)


@pytest.mark.parametrize("s,kc", [(40, 16), (64, 64)])
def test_latent_attention_chunked_path_matches_dense(s, kc):
    """The chunked FA-2 path with a value dim (16) other than the query/key
    dim (24), a ragged last chunk included, against the dense path:
    output and every gradient."""
    spec = tf._mla_spec(CFG)._replace(kc=kc)
    assert spec.v_dim != spec.qk_nope + spec.qk_rope
    p = attn.mla_init(torch.Generator().manual_seed(5), spec)
    x = torch.randn(2, s, CFG.d_model, generator=torch.Generator()
                    .manual_seed(6))
    pos = torch.arange(s)
    outs = []
    for threshold in (1 << 20, 8):              # dense, then chunked
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xl = x.detach().requires_grad_(True)
        y = attn.mla_apply(live, xl, spec, positions=pos,
                           flash_threshold=threshold)
        grads = torch.autograd.grad((y * torch.cos(y)).sum(),
                                    [xl] + [t for _, t in
                                            tree_leaves_with_path(live)])
        outs.append((y, grads))
    (y0, g0), (y1, g1) = outs
    _close(y1, y0)
    for a, b in zip(g1, g0):
        _close(a, b, rtol=1e-4)


def test_an_overloaded_expert_drops_nothing():
    """A selection bias that sends every token to expert 0: it takes T rows
    against a share of T k / E (four times it here), and the layer's output
    is the reference's, which drops nothing by construction."""
    spec = tf._moe_spec(CFG)
    p = tmoe.moe_init(torch.Generator().manual_seed(7), spec)
    p["bias"][0] = 10.0
    x = torch.randn(2, 16, CFG.d_model,
                    generator=torch.Generator().manual_seed(8))
    load = {}
    routed = obs.counter("repro_moe_routed_rows_total")
    before = routed.value(layer=1)
    y, aux = tmoe.moe_apply(p, x, spec, ABFT, layer=1, load=load)
    n = x.shape[0] * x.shape[1]
    rows = torch.bincount(load[1].reshape(-1), minlength=spec.n_experts)
    assert int(rows[0]) == n > 1.25 * n * spec.top_k / spec.n_experts
    assert int(rows.sum()) == n * spec.top_k
    assert routed.value(layer=1) - before == n * spec.top_k
    assert obs.counter("repro_moe_dropped_rows_total").total() == 0
    rcfg = ref_cfg(CFG)
    want, _, want_load, _ = ref._moe(p, x, rcfg)
    assert torch.equal(want_load[:-1], rows)
    _close(y, want)


@pytest.mark.parametrize("bias,choice,taken", [
    ([0.3, 0.2, 0.2, 0.0], [0, 2], True),    # a tie at k / k+1: taken
    ([0.3, 0.2, 0.2, 0.0], [0, 3], False),   # outside the top k+1: not
    ([0.3, 0.2, 0.1, 0.0], [0, 2], False),   # separated: not
])
def test_the_reference_takes_a_programs_choice_only_at_near_ties(
        bias, choice, taken):
    """Equal scores (a zero router), so the selection bias alone ranks the
    experts: the reference takes the program's choice where its k-th and
    (k+1)-th selection scores lie within TIE_GAP and the choice lies within
    its top k + 1, and its own choice otherwise."""
    p = {"router": {"w": torch.zeros(8, 4)}, "bias": torch.tensor(bias)}
    cfg = dict(num_experts_per_tok=2, routed_scaling_factor=1.0)
    _, own, _, ties = ref._route(p, torch.randn(1, 8), cfg)
    _, got, _, _ = ref._route(p, torch.randn(1, 8), cfg,
                              torch.tensor([choice]))
    assert int(ties) == (bias[1] == bias[2])
    want = choice if taken else own[0].tolist()
    assert sorted(got[0].tolist()) == sorted(want)


def _sorted_rows(e=4, rows=(5, 0, 9, 3), k=24, n=40, seed=9):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(sum(rows), k, generator=g)
    w = torch.randn(e, k, n, generator=g) * k ** -0.5
    offsets = torch.tensor([0] + list(np.cumsum(rows)), dtype=torch.int64)
    return x, w, offsets


def test_grouped_product_matches_per_expert_abft_matmul():
    x, w, offsets = _sorted_rows()
    y, ok = ag.abft_matmul_grouped(x, w, kops.ExpertGroups(offsets), ABFT)
    assert bool(ok)
    b = offsets.tolist()
    for e in range(w.shape[0]):
        if b[e + 1] > b[e]:
            want, ok_e = ag.abft_matmul(x[b[e]:b[e + 1]],
                                        ag.encode_weight(w[e], ABFT), ABFT)
            assert bool(ok_e)
            _close(y[b[e]:b[e + 1]], want, rtol=1e-6)


@pytest.mark.parametrize("every", [1, 2])
def test_grouped_product_repairs_one_flip_in_each_row(monkeypatch, every):
    """A flip of 1e3 in one element of a row of the product (every row, or
    every other row), made where the kernel holds its tile, before the
    epilogue reduces the row partials: each tripped row is located and
    repaired, and a row with no flip leaves bit for bit."""
    x, w, offsets = _sorted_rows()
    clean, _ = ag.abft_matmul_grouped(x, w, kops.ExpertGroups(offsets), ABFT)
    plain = kmm.abft_matmul_grouped_plain
    cols = torch.randint(0, w.shape[-1], (x.shape[0],),
                         generator=torch.Generator().manual_seed(10))
    flipped = torch.arange(x.shape[0]) % every == 0

    def faulty(x, w, w_cs, offsets, wn, *, bm, bn):
        y, ycs, _ = plain(x, w, w_cs, offsets, wn, bm=bm, bn=bn)
        y = y.clone()
        rows = torch.nonzero(flipped)[:, 0]
        y[rows, cols[rows]] += 1e3
        n = y.shape[1]
        nt = -(-n // bn)
        crow = torch.stack(
            [y[:, j * bn:(j + 1) * bn] @ wn[j * bn:min((j + 1) * bn, n)]
             for j in range(nt)] + [ycs @ wn[n:]])
        return y, ycs, crow

    monkeypatch.setattr(kmm, "abft_matmul_grouped_plain", faulty)
    groups = kops.ExpertGroups(offsets)
    got, ok = ag.abft_matmul_grouped(x, w, groups, ABFT)
    assert not bool(ok)
    assert int(groups.trips) == int(flipped.sum())
    _close(got, clean, rtol=1e-5)
    assert torch.equal(got[~flipped], clean[~flipped])
    verify = dataclasses.replace(ABFT, mode="verify")
    bad, ok = ag.abft_matmul_grouped(x, w, kops.ExpertGroups(offsets),
                                     verify)
    assert not bool(ok) and float((bad - clean).abs().max()) > 100


def _qwen3_moe_before(p, x, s):
    """The port's MoE forward as it stood before the dropless path, kept
    as the oracle: a copy of its capacity-buffer dispatch."""
    b, t, d = x.shape
    n_tok = b * t
    g = s.groups if n_tok % max(s.groups, 1) == 0 else 1
    tg = n_tok // g
    xg = x.reshape(g, tg, d)
    logits = torch.matmul(xg.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, s.top_k, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=1)
    one_hot_tops = F.one_hot(top_e, s.n_experts).float()
    ce = torch.mean(torch.sum(one_hot_tops, dim=2), dim=1) / s.top_k
    aux = s.n_experts * torch.mean(torch.sum(me * ce, dim=-1))
    n = tg * s.top_k
    flat_e = top_e.reshape(g, n)
    flat_w = top_w.reshape(g, n)
    tok_of = (torch.arange(n) // s.top_k)[None].expand(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    sorted_tok = torch.gather(tok_of, -1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(s.n_experts).expand(g, s.n_experts)
        .contiguous(), side="left")
    rank = torch.arange(n)[None] - torch.gather(starts, -1, sorted_e)
    capacity = n if n <= 4096 else max(
        math.ceil(n / s.n_experts * s.capacity_factor), s.top_k)
    keep = rank < capacity
    n_rows = g * s.n_experts * capacity
    gi = torch.arange(g)[:, None]
    row = torch.where(keep, (gi * s.n_experts + sorted_e) * capacity + rank,
                      n_rows)
    src = torch.gather(xg, 1, sorted_tok[..., None].expand(g, n, d))
    buf = torch.zeros((n_rows + 1, d), dtype=x.dtype)
    buf.index_copy_(0, row.reshape(-1), src.reshape(-1, d))
    buf = buf[:n_rows].reshape(g, s.n_experts, capacity, d)
    gate = torch.einsum("gecd,edf->gecf", buf, p["gate"].to(x.dtype))
    up = torch.einsum("gecd,edf->gecf", buf, p["up"].to(x.dtype))
    out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up,
                       p["down"].to(x.dtype))
    w_sorted = torch.gather(flat_w, -1, order)
    gathered = (out.reshape(n_rows, d)[torch.where(keep, row, 0)]
                * keep[..., None].to(x.dtype))
    y_sorted = gathered * w_sorted[..., None].to(x.dtype)
    y_slots = torch.empty_like(y_sorted).scatter(
        1, order[..., None].expand(g, n, d), y_sorted)
    return y_slots.reshape(g, tg, s.top_k, d).sum(dim=2).reshape(b, t, d), aux


@pytest.mark.parametrize("tokens", [16, 2100])
def test_qwen3_smoke_moe_is_bit_for_bit_as_before(tokens):
    """Qwen3-30B-A3B keeps the capacity-buffer path: its smoke MoE layer
    gives the same bits as before, dropless floor (16 tokens) and
    capacity drops (2100 tokens, 4200 assignments) alike."""
    cfg = cbase.smoke_config("qwen3-moe-30b-a3b")
    spec = tf._moe_spec(cfg)
    assert isinstance(spec, tmoe.MoESpec)
    p = tmoe.moe_init(torch.Generator().manual_seed(11), spec)
    assert set(p) == {"router", "gate", "up", "down"}
    x = torch.randn(2, tokens // 2, cfg.d_model,
                    generator=torch.Generator().manual_seed(12))
    y, aux = tmoe.moe_apply(p, x, spec, ABFT)
    want, want_aux = _qwen3_moe_before(p, x, spec)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)


def test_registry_keeps_the_reference_ten_and_adds_moonlight():
    assert cbase.list_configs() == sorted(jlist())
    assert cbase.list_port_configs() == [ARCH]
    full = cbase.get_config(ARCH)
    assert full.n_layers == sum(len(p) * r for p, r in full.layout) == 27
    cut = cut_layers(full, 5)
    assert [(p[0], r) for p, r in cut.layout] == [(("mla", "dense"), 1),
                                                  (("mla", "moe"), 4)]
    assert (CFG.n_experts, CFG.top_k, CFG.n_layers) == (8, 2, 3)
    with pytest.raises(NotImplementedError, match="latent"):
        tf.init_cache(CFG, 1, 8)


def test_published_widths_count_16b_and_the_cut_2_557b():
    """The whole model at its published widths holds 15.96 B parameters
    (the "16B"); the one-chip cut (the dense layer, 4 MoE layers, a fifth
    of the vocabulary) 2.557 B, and 482.5 M of them (the router
    included, the embedding table not) work on each token."""
    full = cbase.get_config(ARCH)
    n_full = tf.param_count(state_shapes(full)["params"])
    assert 15.9e9 < n_full < 16.0e9
    cut = dataclasses.replace(cut_layers(full, 5), vocab_size=32768)
    assert abs(tf.param_count(state_shapes(cut)["params"]) - 2.557e9) < 1e6
    assert abs(tf.active_param_count(cut) - 482.5e6) < 0.1e6
