"""The port's LM on every config of the registry against the JAX reference:
the same smoke params (carried over by ``repro_torch.convert``) and the same
numpy inputs give the same forward logits and MoE aux loss with ABFT off
and verify, decode reproduces the forward, and one train step's loss and
gradient norms match the reference's ``loss_fn``.  The Whisper config
takes seeded frame embeddings, the vision config seeded image
embeddings."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_configs as jlist
from repro.configs.base import smoke_config as jsmoke
from repro.core.abft_gemm import ABFTConfig as JCfg
from repro.models import transformer as jtf
from repro_torch.configs import list_configs
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.core.abft_gemm import ABFTConfig as TCfg
from repro_torch.models import transformer as ttf
from repro_torch.tree import stack_layers, tree_leaves, tree_unflatten
from torch_port_helpers import assert_close

ARCHS = list_configs()
ABFT = {"off": (None, None),
        "verify": (JCfg(mode="verify", backend="pallas"),
                   TCfg(mode="verify", backend="cuda"))}


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _pair(arch, seed=0):
    cj, ct = jsmoke(arch), tsmoke(arch)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    pj = jtf.init_params(jax.random.PRNGKey(seed), cj)
    return cj, ct, pj, params_from_jax(jax.tree.map(np.asarray, pj), ct)


def _inputs(cfg, rs, b, s):
    """tokens and the cross-attention source of the config, as numpy."""
    toks = rs.randint(0, cfg.vocab_size, size=(b, s))
    kw = {}
    if cfg.n_enc_layers:
        kw["frames"] = rs.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        kw["img_emb"] = rs.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return toks, kw


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def test_registry_matches_reference():
    assert list_configs() == jlist() and len(ARCHS) == 10


@pytest.mark.parametrize("abft", ["off", "verify"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(rs, arch, abft):
    cj, ct, pj, pt = _pair(arch)
    aj, at = ABFT[abft]
    toks, kw = _inputs(cj, rs, 2, 10)
    lj, _, auxj = jtf.forward(pj, jnp.asarray(toks), cj, abft=aj, **_j(kw))
    lt, _, auxt = ttf.forward(pt, torch.from_numpy(toks), ct, abft=at,
                              **_t(kw))
    assert_close(lt, lj)
    assert_close(auxt, auxj)
    if ct.n_experts:
        assert float(auxt) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's tests/test_decode_consistency.py on the port: a
    prefill of 8 tokens into the cache, then 4 decode steps, each within
    2e-3 x scale of the full forward (and of the reference's decode)."""
    cj, ct, pj, pt = _pair(arch)
    rs = np.random.RandomState(1)
    b, s, sp = 2, 12, 8
    toks, kw = _inputs(ct, rs, b, s)
    dec_kw = {"img_emb": kw["img_emb"]} if "img_emb" in kw else {}
    tt = torch.from_numpy(toks)
    full, _, _ = ttf.forward(pt, tt, ct, **_t(kw))
    cache = ttf.init_cache(ct, b, s)
    pre, cache, _ = ttf.forward(pt, tt[:, :sp], ct, cache=cache, **_t(kw))
    scale = float(full.abs().max()) + 1.0
    errs = [float((pre[:, -1] - full[:, sp - 1]).abs().max())]
    cj_cache = jtf.init_cache(cj, b, s)
    _, cj_cache, _ = jtf.forward(pj, jnp.asarray(toks[:, :sp]), cj,
                                 cache=cj_cache, **_j(kw))
    for i in range(sp, s):
        logit, cache = ttf.decode_step(pt, tt[:, i:i + 1], torch.tensor(i),
                                       cache, ct, **_t(dec_kw))
        errs.append(float((logit - full[:, i]).abs().max()))
        lj, cj_cache = jtf.decode_step(pj, jnp.asarray(toks[:, i:i + 1]),
                                       jnp.asarray(i), cj_cache, cj,
                                       **_j(dec_kw))
        assert_close(logit, lj)
    assert max(errs) < 2e-3 * scale, f"{arch}: {errs}"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(arch):
    """One loss_fn value and gradient (remat on, as the train step runs
    it): the loss within 1e-4 relative, every stacked leaf's gradient norm
    within 1e-4 relative (plus 1e-4 of the largest norm), all finite."""
    cj, ct, pj, pt = _pair(arch, seed=2)
    rs = np.random.RandomState(2)
    toks, kw = _inputs(ct, rs, 2, 8)
    labels = rs.randint(0, ct.vocab_size, size=(2, 8))

    def lj_fn(p):
        return jtf.loss_fn(p, jnp.asarray(toks), jnp.asarray(labels), cj,
                           remat=True, **_j(kw))

    loss_j, g_j = jax.value_and_grad(lj_fn)(pj)
    leaves = tree_leaves(pt)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss_t = ttf.loss_fn(tree_unflatten(pt, live), torch.from_numpy(toks),
                         torch.from_numpy(labels), ct, remat=True, **_t(kw))
    grads = torch.autograd.grad(loss_t, live)
    loss_t = float(loss_t.detach())
    assert abs(loss_t - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    g_t = stack_layers(tree_unflatten(pt, list(grads)))
    nt = np.array([float(torch.linalg.vector_norm(g.double()))
                   for g in tree_leaves(g_t)])
    nj = np.array([float(np.linalg.norm(np.asarray(g, np.float64)))
                   for g in jax.tree.leaves(g_j)])
    assert nt.shape == nj.shape
    assert np.all(np.isfinite(nt))
    np.testing.assert_allclose(nt, nj, rtol=1e-4, atol=1e-4 * nj.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_every_config(arch):
    """launch/train.py --arch at smoke size on the CPU: 3 steps through an
    injected shard loss and its diskless recovery, finite losses (Whisper
    and the vision config with their seeded stub inputs)."""
    from repro_torch.launch import train as ttrain
    res = ttrain.run(arch, steps=3, batch=4, seq=16, inject_failures=1,
                     device="cpu", log_every=100)
    assert res.ft.recoveries["diskless"] == 1
    assert len(res.losses) >= 3 and np.all(np.isfinite(res.losses))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_every_decoder_only_config(arch):
    """launch/serve.py --arch: every decoder-only config serves at smoke
    size on the CPU (ABFT verify on the kernel backend's plain version);
    Whisper and the vision config raise, as the reference's run does."""
    from repro_torch.launch import serve as tserve
    cfg = tsmoke(arch)
    if cfg.n_enc_layers or cfg.n_img_tokens:
        with pytest.raises(ValueError, match="frames / image"):
            tserve.run(arch, device="cpu", verbose=False)
        return
    finished, _ = tserve.run(arch, requests=3, slots=2,
                             prompt_lens=[5, 9, 3], gen=3,
                             abft_mode="verify", abft_backend="cuda",
                             device="cpu", verbose=False)
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert all(len(r.output) == 3 for r in finished)


def test_cut_layers_keeps_the_first_blocks():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_layers
    jamba = get_config("jamba-1.5-large-398b")
    period = jamba.layout[0][0]
    assert cut_layers(jamba, 4).layout == ((period[:4], 1),)
    assert cut_layers(jamba, 12).layout == ((period, 1), (period[:4], 1))
    qwen3 = cut_layers(get_config("qwen3-moe-30b-a3b"), 24)
    assert qwen3.layout == (((("attn", "moe"),), 24),) and \
        qwen3.n_layers == 24
