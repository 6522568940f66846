"""The port's packages export what the reference's export.

For every name that a reference package's ``__init__`` imports or lists in
``__all__``, and that the port has in the counterpart module, the port's
package exports it too; the names it lacks are exactly the ones
``ROADMAP.md`` lists as not ported.  A fresh process imports all of them
without importing ``jax`` or ``repro``.  ``StepOptions()`` equals the
reference's field by field, and its ``zero1`` and ``remat_policy`` run at
DP extent 1 and above, as do ``grad_compression``, ``zero2`` and
``fsdp``.
"""
import ast
import dataclasses
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.train.step import StepOptions as JOpts
from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.train.step import StepOptions, build_train_step, init_state
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("core", "chaos", "ft", "train", "models", "kernels", "solvers",
            "configs", "dist", "ckpt")

# the reference's exports the port has no counterpart of yet, with the
# slice that brings each
NOT_PORTED = {
    "ft": set(),
    "dist": set(),
    "train": set(),
    "models": set(),
    # the Pallas entry points; the port's are the *_cuda names below
    "kernels": {"abft_matmul_pallas", "abft_matmul_acc_pallas",
                "checksum_encode_pallas"},
}
KERNEL_COUNTERPARTS = ("abft_matmul_cuda", "abft_matmul_acc_cuda",
                       "checksum_encode_cuda")


def reference_exports(pkg: str):
    """{name: reference module it comes from} for the names the reference
    package's ``__init__`` imports or lists in ``__all__``."""
    path = ROOT / "src" / "repro" / pkg / "__init__.py"
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                name = a.asname or a.name
                mod = node.module
                if mod == f"repro.{pkg}" or mod == "repro":
                    mod = f"{mod}.{a.name}"     # a submodule
                out[name] = mod
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            for elt in node.value.elts:
                out.setdefault(elt.value, f"repro.{pkg}")
    return out


def _port_has(ref_module: str, name: str) -> bool:
    mod = "repro_torch" + ref_module[len("repro"):]
    if mod.endswith("." + name):
        mod = mod[:-len(name) - 1]
    try:
        m = importlib.import_module(mod)
    except ImportError:
        return False
    return hasattr(m, name)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_every_ported_reference_name(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = set()
    for name, ref_mod in reference_exports(pkg).items():
        if _port_has(ref_mod, name) or hasattr(port, name):
            assert getattr(port, name) is not None, name
        else:
            missing.add(name)
    assert missing == NOT_PORTED.get(pkg, set())
    for name in getattr(port, "__all__", ()):
        assert hasattr(port, name), name
    if pkg == "kernels":
        for name in KERNEL_COUNTERPARTS:
            assert callable(getattr(port, name))
        assert not any(n.endswith("_pallas") for n in dir(port))


def test_the_exports_import_without_jax():
    names = {pkg: sorted(set(reference_exports(pkg))
                         - NOT_PORTED.get(pkg, set()))
             for pkg in PACKAGES}
    names["kernels"] += list(KERNEL_COUNTERPARTS)
    code = "\n".join(
        [f"from repro_torch.{pkg} import {', '.join(ns)}"
         for pkg, ns in names.items()]
        # the pod paths' modules (dist, ckpt are in PACKAGES)
        + ["import repro_torch.launch.mesh, repro_torch.launch.train",
           # the tuning and cost-accounting entry points
           "import repro_torch.launch.autotune, repro_torch.launch.dryrun, "
           "repro_torch.launch.hlo_accounting, repro_torch.kernels.autotune",
           "import sys",
           "bad = [m for m in sys.modules if m == 'jax' or "
           "m.startswith(('jax.', 'repro.')) or m == 'repro']",
           "assert not bad, bad",
           "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_every_config_imports_without_jax():
    """The registry holds the reference's ten configs, each the same
    dataclass, and loading them imports neither jax nor the reference."""
    from repro.configs import get_config as jget
    from repro.configs import list_configs as jlist
    from repro_torch.configs import get_config, list_configs
    assert list_configs() == jlist()
    for name in jlist():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget(name))
    code = ("from repro_torch.configs import list_configs, get_config\n"
            "import sys\n"
            "names = list_configs()\n"
            "assert len(names) == 10, names\n"
            "[get_config(n) for n in names]\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n"
            "print(' '.join(names))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == jlist()


def test_step_options_default_as_the_reference():
    mine = {f.name: f.default for f in dataclasses.fields(StepOptions)}
    ref = {f.name: f.default for f in dataclasses.fields(JOpts)}
    assert mine == ref
    assert StepOptions().zero1 is True
    assert StepOptions().remat_policy == "nothing"
    for remat, policy in [(True, "nothing"), (True, "dots"),
                          (False, "dots")]:
        assert StepOptions(remat=remat, remat_policy=policy).remat_arg == \
            JOpts(remat=remat, remat_policy=policy).remat_arg
    with pytest.raises(ValueError, match="remat_policy"):
        build_train_step(smoke_config("qwen2-0.5b"), SHAPE,
                         opts=StepOptions(remat_policy="everything"))


SHAPE = ShapeConfig("t", 16, 4, "train")


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("abft", ["off", "verify"])
def test_zero1_and_remat_policy_run_at_dp_extent_one(abft):
    """zero1 is the identity at DP extent 1, and "dots" changes what the
    backward recomputes (the unbatched matmuls are saved), never the
    result: two steps give the same state bit for bit."""
    cfg = smoke_config("qwen2-0.5b")
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (4, 16)),
             "labels": rs.randint(0, cfg.vocab_size, (4, 16))}
    states, matmuls = {}, {}
    for key, kw in [("plain", dict(remat=False, zero1=False)),
                    ("nothing", dict(remat=True, zero1=True)),
                    ("dots", dict(remat=True, zero1=True,
                                  remat_policy="dots"))]:
        st = init_state(torch.Generator().manual_seed(0), cfg)
        fn = build_train_step(cfg, SHAPE,
                              opts=StepOptions(abft_mode=abft, **kw))
        with _CountMatmuls() as count:
            st, _ = fn(st, batch)
        st, _ = fn(st, batch)
        states[key] = tree_leaves(st)
        matmuls[key] = count.n
    for key in ("nothing", "dots"):
        assert all(torch.equal(a, b) for a, b in
                   zip(states[key], states["plain"])), key
    # remat recomputes the blocks' matmuls; "dots" saves them
    assert matmuls["nothing"] > matmuls["plain"] == matmuls["dots"]


def test_dp_extent_above_one_still_raises():
    """A DP extent above one runs (it raised before the pod paths were
    ported): ElasticRuntime on (2, 1) builds a step at DP 2 whose zero1
    layout its specs record; and the options that raised until the tuning
    slice (int8_ef, zero2, fsdp) now build and take a step there, each
    with a finite loss, the compressed one carrying its residual."""
    from repro_torch.ft.runtime import ElasticRuntime
    rt = ElasticRuntime(smoke_config("qwen2-0.5b"), SHAPE, (2, 1),
                        opts=StepOptions(zero1=True, remat=False),
                        device="cpu")
    try:
        assert (rt.p, rt.gen.split) == (2, 2)
        specs = tree_leaves(rt.gen.in_shardings[0])
        assert any("'data'" in str(s.spec) for s in specs)
        state, m = rt.train_step(0, rt.init_state(0))
        assert np.isfinite(float(m["loss"]))
    finally:
        rt.close()
    for opts in (StepOptions(zero2=True, defer_grad_reduce=True, remat=False),
                 StepOptions(fsdp=True, remat=False),
                 StepOptions(grad_compression="int8_ef",
                             defer_grad_reduce=True, remat=False)):
        rt = ElasticRuntime(smoke_config("qwen2-0.5b"), SHAPE, (2, 1),
                            opts=opts, device="cpu")
        try:
            state = rt.init_state(0)
            state, m = rt.train_step(0, state)
            assert np.isfinite(float(m["loss"]))
            assert ("ef_residual" in state) == (opts.grad_compression
                                                != "none")
        finally:
            rt.close()
    # the reference's residual rides its deferred region only
    with pytest.raises(ValueError, match="defer_grad_reduce"):
        build_train_step(smoke_config("qwen2-0.5b"), SHAPE,
                         opts=StepOptions(grad_compression="int8_ef"))
