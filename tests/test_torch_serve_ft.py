"""The port's fault-tolerant serving engine against the JAX reference: the
verified unembed (``abft_reduce``), its SDC drills, the at-rest KV and
params scrub, and the serving CLI's drill flags.

Smoke Qwen2-0.5B (d 64, 2 layers, vocab 512) in fp32, the reference's
params carried over with ``convert.params_from_jax``.  The reference's
engine runs on a one-device mesh with ``Auto`` axes (on this jax its
default mesh's ``Explicit`` axes reject the embedding gather).  Token
streams, detection and correction counts, located ``(row, col)`` and scrub
events ``(step, domain, leaf, slot)`` must be equal; a repaired logit
differs from the clean one by the rounding of the subtracted residual, and
the argmax absorbs it, so the token streams are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.chaos import campaign as jcampaign
from repro.chaos.faults import FaultSpec as JSpec
from repro.configs.base import smoke_config as jsmoke
from repro.ft.failures import SDCInjector as JSDCInjector
from repro.ft.failures import SDCPlan as JSDCPlan
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.chaos import campaign as tcampaign
from repro_torch.chaos.faults import FaultSpec
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.ft.failures import SDCInjector, SDCPlan
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import EngineStats, Request, ServeEngine

ARCH = "qwen2-0.5b"
SLOTS, MAX_LEN, N_REQ, PLEN, GEN = 4, 48, 4, 8, 5


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def params():
    pj = jtf.init_params(jax.random.PRNGKey(0), jsmoke(ARCH))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), tsmoke(ARCH))


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, tsmoke(ARCH).vocab_size, PLEN).tolist()
            for _ in range(N_REQ)]


def _drive(eng, req_cls, on_step=None):
    for i, p in enumerate(_prompts()):
        eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=GEN))
    return {r.rid: list(r.output) for r in eng.run(on_step=on_step)}


def _engines(params, sdc=None, scrub=0):
    pj, pt = params
    ej = JEngine(jsmoke(ARCH), pj, slots=SLOTS, max_len=MAX_LEN,
                 mesh=_mesh(), abft_reduce="correct",
                 sdc=JSDCInjector(JSDCPlan(sdc)) if sdc else None,
                 scrub_every=scrub)
    et = ServeEngine(tsmoke(ARCH), pt, slots=SLOTS, max_len=MAX_LEN,
                     abft_reduce="correct",
                     sdc=SDCInjector(SDCPlan(sdc)) if sdc else None,
                     scrub_every=scrub)
    return ej, et


def _events(stats):
    return ([(e.step, e.shard, e.delta, e.detected, e.corrected, e.row,
              e.col) for e in stats.events],
            [(e.step, e.domain, e.leaf, e.slot, e.repaired)
             for e in stats.scrub_events])


@pytest.mark.parametrize("sdc", [None, ((1, 0, 1e4),),
                                 ((0, 0, -3e4), (2, 0, 1e3))])
def test_protected_engine_matches_reference(params, sdc):
    ej, et = _engines(params, sdc=sdc)
    oj, ot = _drive(ej, JRequest), _drive(et, Request)
    assert ot == oj
    assert (et.stats.detections, et.stats.corrections) == \
        (ej.stats.detections, ej.stats.corrections) == \
        ((len(sdc),) * 2 if sdc else (0, 0))
    assert _events(et.stats) == _events(ej.stats)
    assert et.stats.decode_steps == ej.stats.decode_steps
    if sdc is None:
        # the verified unembed computes the unprotected engine's tokens
        plain = ServeEngine(tsmoke(ARCH), params[1], slots=SLOTS,
                            max_len=MAX_LEN)
        assert _drive(plain, Request) == ot


@pytest.mark.parametrize("kind,step", [("dram_kv_cache", 2),
                                       ("dram_params", 0),
                                       ("dram_params", 3)])
def test_scrubbed_engine_matches_reference(params, kind, step):
    """A flip drawn by each package's `_flip_engine_bit` (the same bit of
    the same leaf) is found by the scrub at the same step, in the same
    leaf and slot, and repaired: the tokens stay the clean ones."""
    ej, et = _engines(params, scrub=1)
    spec_j = JSpec(kind=kind, workload="serve", step=step, bit=30)
    spec_t = FaultSpec(kind=kind, workload="serve", step=step, bit=30)
    names = {}

    def flipper(mod, spec, key):
        def on_step(engine, s):
            if s == spec.step and key not in names:
                names[key] = mod._flip_engine_bit(engine, spec)[0]
        return on_step

    oj = _drive(ej, JRequest, flipper(jcampaign, spec_j, "j"))
    ot = _drive(et, Request, flipper(tcampaign, spec_t, "t"))
    assert names["t"] == names["j"]
    assert ot == oj
    assert _events(et.stats) == _events(ej.stats)
    assert len(et.stats.scrub_events) == 1
    assert et.stats.scrub_events[0].repaired
    assert et.stats.scrub_checks == ej.stats.scrub_checks == \
        et.stats.decode_steps
    clean = ServeEngine(tsmoke(ARCH), params[1], slots=SLOTS,
                        max_len=MAX_LEN)
    assert _drive(clean, Request) == ot


def test_scrub_flags_come_to_the_host_in_one_transfer(params, monkeypatch):
    """One scrub: every KV slot flag and params flag in one tensor."""
    _, et = _engines(params, scrub=1)
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    kv, par = et._scrub_flags()
    assert len(calls) == 1
    assert set(kv) == {"['groups'][0]['b0']['k']", "['groups'][0]['b0']['v']"}
    assert "['groups'][0]['b0']['attn']['wq']['w']" in par
    assert "['embed']['table_f32']" in par
    assert not any(par.values()) and not any(b.any() for b in kv.values())


def test_engine_checks_match_reference(params):
    pj, pt = params
    for kw, err in ((dict(abft_reduce="fix"), "unknown abft_reduce"),
                    (dict(sdc=((1, 0, 1.0),)), "set abft_reduce"),
                    (dict(abft_reduce="verify", sdc=((1, 1, 1.0),)),
                     "model extent is 1")):
        sdc = kw.pop("sdc", None)
        with pytest.raises(ValueError, match=err.split()[0]):
            JEngine(jsmoke(ARCH), pj, mesh=_mesh(),
                    sdc=JSDCInjector(JSDCPlan(sdc)) if sdc else None, **kw)
        with pytest.raises(ValueError, match=err):
            ServeEngine(tsmoke(ARCH), pt,
                        sdc=SDCInjector(SDCPlan(sdc)) if sdc else None,
                        **kw)
    with pytest.raises(NotImplementedError, match="slice 13"):
        ServeEngine(tsmoke(ARCH), pt, mesh=(1, 2))


def test_stats_summary_keys_match_reference():
    from repro.serve.engine import EngineStats as JStats
    got = EngineStats().summary()
    want = JStats().summary()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"scrub_ms"}


def test_cli_drill_on_cpu(capsys):
    finished, eng = tserve.main(["--device", "cpu", "--reduce", "correct",
                                 "--drill-step", "1", "--requests", "3",
                                 "--gen", "4"])
    out = capsys.readouterr().out
    assert "protected reduce: detections=1 corrections=1" in out
    assert "SDC drill @step 1: shard 0 delta +1e+04 -> detected=True " \
           "corrected=True located=(" in out
    clean, _ = tserve.run("qwen2-0.5b", requests=3, gen=4, device="cpu",
                          abft_reduce="correct", verbose=False)
    assert [r.output for r in finished] == [r.output for r in clean]
    assert len(eng.stats.events) == 1
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--drill-step", "1"])
