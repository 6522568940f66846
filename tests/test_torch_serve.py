"""The port's serving engine against the JAX reference engine, the port's
serving CLI, and the port's import isolation."""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Request, ServeEngine

PROMPT_LENS = (3, 11, 20)      # buckets 8, 16, 32: three prefill shapes


def test_engine_token_streams_match_reference(monkeypatch):
    """slots=2, 3 requests (admission after a retirement), ABFT verify on
    the kernel backend on both sides: identical token streams and step
    counts; every protected projection of the port took the kernel
    dispatch (its plain version, on this CPU)."""
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    cfg_j, cfg_t = jsmoke("qwen2-0.5b"), tsmoke("qwen2-0.5b")
    params_j = jtf.init_params(jax.random.PRNGKey(5), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg_t.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    gen = [4, 6, 5]

    ej = JEngine(cfg_j, params_j, slots=2, max_len=40, abft_mode="verify",
                 abft_backend="pallas")
    for i, p in enumerate(prompts):
        ej.submit(JRequest(rid=i, prompt=p, max_new_tokens=gen[i]))
    out_j = {r.rid: r.output for r in ej.run()}

    et = ServeEngine(cfg_t, params_t, slots=2, max_len=40,
                     abft_mode="verify", abft_backend="cuda")
    before = kmm.plain_calls
    for i, p in enumerate(prompts):
        et.submit(Request(rid=i, prompt=p, max_new_tokens=gen[i]))
    out_t = {r.rid: r.output for r in et.run()}

    assert out_t == out_j
    assert [len(out_t[i]) for i in range(3)] == gen
    assert et.stats.prefills == ej.stats.prefills == 3
    assert et.stats.decode_steps == ej.stats.decode_steps
    n_layers = sum(r * len(p) for p, r in cfg_t.layout)
    assert kmm.plain_calls - before == \
        7 * n_layers * (et.stats.prefills + et.stats.decode_steps)
    assert kmm.launches == 0


def test_engine_reset_and_unported_options():
    cfg = tsmoke("qwen2-0.5b")
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, slots=2, max_len=24, abft_mode="verify")
    # pre-encoded once, into the engine's own copy of the param tree
    wq = eng.params["groups"][0][0]["b0"]["attn"]["wq"]
    assert wq["w_enc"].shape == (cfg.d_model, cfg.d_model + 2)
    assert "w_enc" not in params["groups"][0][0]["b0"]["attn"]["wq"]
    eng.warm(prompt_len=4)
    assert eng.stats.prefills == eng.stats.decode_steps == 0
    assert eng.cache["groups"][0]["b0"]["index"].shape == (2, 2)
    # abft_reduce, sdc, scrub_every (tests/test_torch_serve_ft.py) and the
    # mesh (tests/test_torch_serve_mesh.py) are ported; a mesh that is not
    # a shape, a dict or a Mesh is refused
    with pytest.raises(TypeError):
        ServeEngine(cfg, params, mesh=object())


def test_cli_reaches_published_width(monkeypatch):
    """--no-smoke reaches run(smoke=False); --smoke stays the default."""
    seen = []
    monkeypatch.setattr(tserve, "run",
                        lambda arch, **kw: seen.append(kw["smoke"]))
    tserve.main(["--no-smoke", "--abft", "verify"])
    tserve.main([])
    assert seen == [False, True]


def test_cli_serves_on_cpu(capsys):
    finished, engine = tserve.run("qwen2-0.5b", requests=3, slots=2,
                                  prompt_lens=[3, 9, 5], gen=3,
                                  abft_mode="verify", abft_backend="cuda",
                                  device="cpu")
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert all(len(r.output) == 3 for r in finished)
    assert engine.max_len == 9 + 3 + 8
    assert "[serve] qwen2-0.5b on cpu: 3 requests" in capsys.readouterr().out


@pytest.mark.gpu
def test_default_backend_serves_on_the_kernel_on_card():
    """On a CUDA card the default ABFT backend ("auto") runs every
    protected projection, decode's m = slots included, on the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py serves on the default backend)")
    counts = {}
    finished, engine = tserve.run(
        "qwen2-0.5b", requests=3, slots=2, prompt_lens=[3, 9, 5], gen=3,
        abft_mode="verify", device="cuda",
        on_warm=lambda e: counts.update(l=kmm.launches, p=kmm.plain_calls))
    torch.cuda.synchronize()
    st = engine.stats
    n_layers = sum(r * len(p) for p, r in engine.cfg.layout)
    assert len(finished) == 3
    assert kmm.launches - counts["l"] == \
        7 * n_layers * (st.prefills + st.decode_steps)
    assert kmm.plain_calls == counts["p"]


def test_serve_without_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run("qwen2-0.5b", requests=1, gen=2)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'repro') or "
        "k.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.core.' + m for m in ('encoding', 'detect', "
        "'recovery', 'summa')} | {'repro_torch.launch.stress', "
        "'repro_torch.launch.train', 'repro_torch.kernels.checksum_encode', "
        "'repro_torch.ckpt.diskless', 'repro_torch.ckpt.disk', "
        "'repro_torch.ft.runtime', 'repro_torch.data.pipeline', "
        "'repro_torch.train.optimizer', 'repro_torch.tree', "
        "'repro_torch.serve.paged_kv', 'repro_torch.serve.scheduler', "
        "'repro_torch.serve.traffic', 'repro_torch.launch.obs'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert int(out.stdout.strip()) >= 35
