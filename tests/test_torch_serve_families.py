"""Serving the MoE, hybrid and recurrent families on the port's engines.

  * smoke Qwen3-30B-A3B (MoE, attention only): the port's contiguous and
    paged engines emit the reference engine's token streams;
  * smoke xLSTM-350M and Jamba-1.5-Large (recurrent state): the port's
    engines, contiguous and paged, chunked or not, emit the tokens of
    greedy decoding by the full forward for prompts whose lengths are not
    powers of two.  The reference pads each prompt to a power-of-two
    bucket, and its recurrent state reads the pad tokens: its engine
    leaves the full forward's tokens, the port's does not.

Weights come from the reference's ``init_params`` through
``convert.params_from_jax``; prompts from ``np.random.RandomState``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

RECURRENT = ["xlstm-350m", "jamba-1.5-large-398b"]
PROMPT_LENS = (5, 11, 13)


def _params(arch, seed=0):
    pj = jtf.init_params(jax.random.PRNGKey(seed), jsmoke(arch))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), tsmoke(arch))


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).tolist() for n in lens]


def _drive(eng, req_cls, prompts, gen):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=list(p), max_new_tokens=gen))
    return {r.rid: list(r.output) for r in eng.run()}


def _greedy(forward, prompt, gen):
    """Greedy decoding by the full forward over the growing sequence."""
    seq = list(prompt)
    for _ in range(gen):
        seq.append(int(np.argmax(np.asarray(forward(seq))[0, -1])))
    return seq[len(prompt):]


def _port_forward(params, cfg):
    def fwd(seq):
        with torch.no_grad():
            return ttf.forward(params, torch.tensor([seq]), cfg)[0].numpy()
    return fwd


ENGINES = {
    "contiguous": lambda cfg, p: ServeEngine(cfg, p, slots=2, max_len=32),
    "paged": lambda cfg, p: PagedServeEngine(cfg, p, slots=2, max_len=32,
                                             page_size=4),
    "paged-chunked": lambda cfg, p: PagedServeEngine(
        cfg, p, slots=2, max_len=32, page_size=4, chunk_prefill=4),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_moe_engines_match_reference(engine):
    """Smoke Qwen3-30B-A3B, 2 slots, 3 requests (an admission after a
    retirement): the reference engine's token streams."""
    arch = "qwen3-moe-30b-a3b"
    pj, pt = _params(arch, 1)
    prompts = _prompts(512)
    want = _drive(JEngine(jsmoke(arch), pj, slots=2, max_len=32), JRequest,
                  prompts, 4)
    got = _drive(ENGINES[engine](tsmoke(arch), pt), Request, prompts, 4)
    assert got == want


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engines_emit_full_forward_tokens(arch, engine):
    """Prompts of 5, 11 and 13 tokens on 2 slots, 4 new tokens each: every
    request's tokens are greedy full-forward decoding's, whether the
    prefill runs whole or in chunks of 4 and whether the slot served
    another request before."""
    _, pt = _params(arch)
    cfg = tsmoke(arch)
    prompts = _prompts(cfg.vocab_size)
    got = _drive(ENGINES[engine](cfg, pt), Request, prompts, 4)
    fwd = _port_forward(pt, cfg)
    assert got == {i: _greedy(fwd, p, 4) for i, p in enumerate(prompts)}


# the reference engine, its full forward and the port on one 5-token
# prompt (ServeEngine(slots=1, max_len=32), params from PRNGKey(0), prompt
# RandomState(1).randint(0, vocab, 5), 4 new tokens)
UNLIKE = {
    "xlstm-350m": ([349, 310, 506, 363], [349, 462, 256, 462]),
    "jamba-1.5-large-398b": ([255, 338, 156, 40], [255, 101, 97, 39]),
}


@pytest.mark.parametrize("arch", sorted(UNLIKE))
def test_recurrent_prefill_matches_full_forward_unlike_reference(arch):
    """The reference pads the 5-token prompt to an 8-token bucket; its
    recurrent state reads the 3 pad tokens and its engine leaves the full
    forward's tokens.  The port prefills exactly the prompt."""
    pj, pt = _params(arch)
    cfg_j, cfg_t = jsmoke(arch), tsmoke(arch)
    prompt = np.random.RandomState(1).randint(0, cfg_t.vocab_size,
                                              5).tolist()
    ref_engine, full = UNLIKE[arch]
    j_out = _drive(JEngine(cfg_j, pj, slots=1, max_len=32), JRequest,
                   [prompt], 4)[0]
    j_full = _greedy(lambda seq: jtf.forward(pj, jnp.asarray([seq]),
                                             cfg_j)[0], prompt, 4)
    assert j_out == ref_engine != j_full == full
    for make in ENGINES.values():
        eng = make(cfg_t, pt)
        assert _drive(eng, Request, [prompt], 4)[0] == full


@pytest.mark.parametrize("arch", RECURRENT)
def test_scrub_repairs_a_recurrent_state_flip(arch):
    """The contiguous engine's at-rest scrub covers the recurrent state as
    it covers K/V (a float leaf with a slot axis, as in the reference): a
    corrupted element of an active slot's state is detected before the
    next decode step, rebuilt from the slot-sum checksum, and the tokens
    equal the clean run's."""
    _, pt = _params(arch)
    cfg = tsmoke(arch)
    prompts = _prompts(cfg.vocab_size, lens=(5, 11))
    key = "c" if arch == "xlstm-350m" else "h"

    def serve(on_step=None):
        eng = ServeEngine(cfg, pt, slots=2, max_len=32, scrub_every=1)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=5))
        out = {r.rid: list(r.output) for r in eng.run(on_step=on_step)}
        return out, eng

    def flip(eng, step):
        if step == 2:
            eng.cache["groups"][0]["b0"][key][0, 1].view(-1)[3] += 1e3

    clean, _ = serve()
    got, eng = serve(flip)
    assert got == clean
    ev = [(e.domain, e.leaf, e.slot, e.repaired)
          for e in eng.stats.scrub_events]
    assert ev == [("kv", f"['groups'][0]['b0']['{key}']", 1, True)]
