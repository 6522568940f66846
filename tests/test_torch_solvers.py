"""The port's redundant-subspace CG solver (``repro_torch.solvers``) held
against the reference's (``repro.solvers``) on the CPU.

``tests/test_solvers.py``'s cases run on both packages (the port with
``device="cpu"``).  Then the same drills go through both: the iterates
agree to ``X_RTOL`` of the largest |x| (the operator and right-hand side
are the same, but ``b = A x_true``, the block inverses and the norms round
in another order in torch than in numpy's BLAS/LAPACK), and every
non-float field of the report (iterations, trips by kind and iteration,
failovers, reweights, dead subspaces) is equal.
"""
import json
import math

import numpy as np
import pytest
import torch

import repro.chaos.faults as jfaults
import repro.solvers as jsolvers
import repro_torch.chaos.faults as tfaults
import repro_torch.solvers as tsolvers
from repro_torch.launch import chaos as cli
from torch_port_helpers import to_np

# cross-package agreement of the converged iterates, relative to max |x|:
# both stop at ||b - A x|| <= 1e-10 ||b||, and their rounding differs by a
# few float64 ulps an operation (measured: 3e-14 at n = 96)
X_RTOL = 1e-10


class Pkg:
    """One package's solver API, so one test body runs on both."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.m = tsolvers if port else jsolvers
        self.faults = tfaults if port else jfaults
        self.kw = {"device": "cpu"} if port else {}

    def cfg(self, **kw):
        return self.m.SolverConfig(**kw)

    def solver(self, **kw):
        return self.m.RedundantSubspaceCG(self.cfg(**kw), **self.kw)

    def poisson(self, n, seed):
        return self.m.poisson_1d(n, seed=seed, **self.kw)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return Pkg(request.param)


def _clean(pkg, **kw):
    s = pkg.solver(**kw)
    s.run()
    return s


def _absmax_index(s) -> int:
    return int(np.argmax(np.abs(to_np(s.x))))


def _flip_bit_for(s, idx) -> int:
    """The campaign's detectability rule: flip the top exponent bit when
    the value is small (-> huge), the next one down otherwise."""
    return 62 if abs(float(s.x[idx])) < 2.0 else 61


# -- tests/test_solvers.py on both packages -----------------------------------


def test_clean_solve_converges_with_zero_trips(pkg):
    s = _clean(pkg)
    rep = s.report()
    assert rep.converged
    assert rep.residual_norm <= rep.rtol * s.bnorm
    assert rep.trips == () and rep.failovers == () and rep.reweights == ()
    assert rep.dead_subspaces == ()
    a, b = pkg.poisson(pkg.cfg().n, pkg.cfg().seed)
    assert float(np.max(np.abs(to_np(a @ s.x - b)))) < 1e-8


def test_wraparound_cover_is_exactly_double(pkg):
    assert np.all(to_np(pkg.solver().coverage()) == 2.0)


def test_anti_placement_pod_loss_is_pure_failover(pkg):
    golden = _clean(pkg)
    s = pkg.solver(placement="anti")
    for _ in range(3):
        s.iterate()
    out = s.lose_pod(1)
    assert out["dead_subspaces"] == []
    assert all(r == "solver:failover" for r in out["rungs"]) and out["rungs"]
    rep = s.run()
    assert rep.converged and rep.reweights == ()
    assert s.error_vs(golden) == 0.0
    assert rep.iterations == golden.report().iterations


def test_paired_placement_pod_loss_reweights_and_converges_through(pkg):
    golden = _clean(pkg)
    s = pkg.solver(placement="paired")
    for _ in range(3):
        s.iterate()
    out = s.lose_pod(1)
    assert out["dead_subspaces"]
    assert "solver:reweight" in out["rungs"]
    rep = s.run()
    assert rep.converged
    assert rep.dead_subspaces == tuple(out["dead_subspaces"])
    assert s.error_vs(golden) < 1e-6
    assert rep.iterations >= golden.report().iterations


def test_sdc_repaired_from_sister_replica_bit_identical(pkg):
    golden = _clean(pkg)
    s = pkg.solver()
    for _ in range(4):
        s.iterate()
    s.inject_correction_sdc(subspace=3, replica=0, index=2, delta=1e4)
    rep = s.run()
    assert [t.kind for t in rep.trips] == ["replica_repair"]
    assert "subspace 3" in rep.trips[0].detail
    assert rep.converged
    assert s.error_vs(golden) == 0.0


def test_sdc_on_lone_survivor_recomputed_locally(pkg):
    s = pkg.solver()
    for _ in range(2):
        s.iterate()
    s.lose_worker(3, 1)
    s.inject_correction_sdc(subspace=3, replica=0, index=1, delta=1e4)
    rep = s.run()
    assert "local_recompute" in [t.kind for t in rep.trips]
    assert rep.failovers == ("s3r1",)
    assert rep.converged


def test_iterate_dram_flip_trips_guard_and_converges_through(pkg):
    golden = _clean(pkg)
    s = pkg.solver()
    for _ in range(6):
        s.iterate()
    idx = _absmax_index(s)
    s.corrupt_iterate(idx, bit=_flip_bit_for(s, idx))
    rep = s.run()
    assert "guard_restart" in [t.kind for t in rep.trips]
    assert rep.converged
    assert s.error_vs(golden) < 1e-6


def test_mid_iteration_subspace_death_completes_the_iteration(pkg):
    s = pkg.solver()
    for _ in range(3):
        s.iterate()
    s.lose_worker(5, 0, mid_iteration=True)
    s.lose_worker(5, 1, mid_iteration=True)
    s.iterate()
    assert s.dead_subspaces() == [5]
    rep = s.run()
    assert rep.converged
    assert "solver:reweight" in rep.rungs


def test_corruption_landing_in_a_topology_restart_window_is_logged(pkg):
    s = pkg.solver(placement="paired")
    for _ in range(3):
        s.iterate()
    s.lose_pod(1)
    assert s.p is None
    s.x[4] = np.inf
    s.iterate()
    trips = [t for t in s.trips if t.kind == "guard_restart"]
    assert trips and "sanitized 1 corrupt" in trips[0].detail
    assert s.run().converged


def test_clean_topology_restart_logs_nothing(pkg):
    s = pkg.solver(placement="paired")
    for _ in range(3):
        s.iterate()
    s.lose_pod(1)
    trips_before = len(s.trips)
    s.iterate()
    assert len(s.trips) == trips_before


def test_revive_pod_restores_cover_and_weights(pkg):
    s = pkg.solver(placement="paired")
    for _ in range(2):
        s.iterate()
    s.lose_pod(0)
    assert s.dead_subspaces()
    revived = s.revive_pod(0)
    assert revived and s.dead_subspaces() == []
    assert np.all(to_np(s.coverage()) == 2.0)
    assert s.run().converged


def test_cover_void_is_unrecoverable_and_says_so(pkg):
    s = pkg.solver()
    for rep in range(2):
        s.lose_worker(0, rep)
    with pytest.raises(RuntimeError, match="unrecoverable"):
        for rep in range(2):
            s.lose_worker(1, rep)


def test_solver_surfaces_registered_protected_tolerance(pkg):
    for name, kinds in (
            ("solvers.subspace_cg/correction_sum", ("sdc_collective",)),
            ("solvers.subspace_cg/iterate_at_rest", ("dram_params",)),
            ("solvers.subspace_cg/subspaces", ("shard_loss", "pod_loss"))):
        surf = pkg.faults.get_surface(name)
        assert surf.protected and surf.promise == "tolerance"
        assert surf.kinds == kinds
        assert surf.detector
        ref = jfaults.get_surface(name)
        assert (surf.detector, surf.note) == (ref.detector, ref.note)


def test_config_validation(pkg):
    with pytest.raises(ValueError, match="divide"):
        pkg.cfg(n=97)
    with pytest.raises(ValueError, match="placement"):
        pkg.cfg(placement="chaotic")


# -- the port against the reference ------------------------------------------


def _drill_sdc(s):
    for _ in range(4):
        s.iterate()
    s.inject_correction_sdc(subspace=3, replica=0, index=2, delta=1e4)


def _drill_lone_survivor(s):
    for _ in range(2):
        s.iterate()
    s.lose_worker(3, 1)
    s.inject_correction_sdc(subspace=3, replica=0, index=1, delta=1e4)


def _drill_flip(s):
    for _ in range(6):
        s.iterate()
    idx = _absmax_index(s)
    s.corrupt_iterate(idx, bit=_flip_bit_for(s, idx))


def _drill_pod(s):
    for _ in range(3):
        s.iterate()
    s.lose_pod(1)


def _drill_mid_iteration(s):
    for _ in range(3):
        s.iterate()
    s.lose_worker(5, 0, mid_iteration=True)
    s.lose_worker(5, 1, mid_iteration=True)


def _drill_revive(s):
    _drill_pod(s)
    for _ in range(3):
        s.iterate()
    s.revive_pod(1)


def _drill_all(s):
    """phase 15's drill at n = 96: an SDC in subspace 3 replica 0 at
    iteration 2, a flip of argmax |x| at iteration 3, pod 1 lost."""
    for _ in range(2):
        s.iterate()
    s.inject_correction_sdc(3, 0, index=1, delta=1e3)
    s.iterate()
    idx = _absmax_index(s)
    s.corrupt_iterate(idx, bit=_flip_bit_for(s, idx))
    s.lose_pod(1)


DRILLS = {
    "clean": ({}, lambda s: None),
    "sdc": ({}, _drill_sdc),
    "lone_survivor": ({}, _drill_lone_survivor),
    "flip": ({}, _drill_flip),
    "pod_anti": ({"placement": "anti"}, _drill_pod),
    "pod_paired": ({"placement": "paired"}, _drill_pod),
    "mid_iteration": ({}, _drill_mid_iteration),
    "revive_paired": ({"placement": "paired"}, _drill_revive),
    "all": ({}, _drill_all),
}


def _report_fields(rep):
    return dict(converged=rep.converged, iterations=rep.iterations,
                trips=[(t.kind, t.iteration) for t in rep.trips],
                failovers=rep.failovers, reweights=rep.reweights,
                dead=rep.dead_subspaces, rungs=rep.rungs)


@pytest.mark.parametrize("drill", list(DRILLS))
def test_drilled_solve_matches_reference(drill):
    kw, fn = DRILLS[drill]
    solves = {}
    for name in ("ref", "port"):
        s = Pkg(name).solver(**kw)
        fn(s)
        solves[name] = (s, s.run())
    (js, jrep), (ts, trep) = solves["ref"], solves["port"]
    assert _report_fields(trep) == _report_fields(jrep)
    assert [t.detail for t in trep.trips if t.kind != "guard_restart"] == \
        [t.detail for t in jrep.trips if t.kind != "guard_restart"]
    assert trep.converged
    assert ts.x.dtype == torch.float64 and ts.x.device.type == "cpu"
    jx = np.asarray(js.x)
    assert float(np.max(np.abs(to_np(ts.x) - jx))) <= \
        X_RTOL * float(np.max(np.abs(jx)))
    assert math.isclose(trep.residual_norm, jrep.residual_norm,
                        rel_tol=1e-3)


@pytest.mark.parametrize("bit", [0, 52, 61, 62, 63, 127])
def test_corrupt_iterate_flips_the_same_bit(bit):
    """The port flips in place through the int64 view; bit 63 (the sign,
    and 127 % 64) needs the mask -2^63 there."""
    vals = {}
    for name in ("ref", "port"):
        s = Pkg(name).solver()
        for _ in range(2):
            s.iterate()
        before = to_np(s.x).copy()
        vals[name] = (s.corrupt_iterate(7, bit=bit), before, to_np(s.x))
    (jv, jb, jx), (tv, tb, tx) = vals["ref"], vals["port"]
    want = (tb.view(np.uint64)[7] ^ np.uint64(1 << (bit % 64)))
    assert np.array_equal(tx.view(np.uint64)[7:8], np.array([want]))
    assert np.array_equal(np.delete(tx, 7), np.delete(tb, 7))
    assert tv == float(tx[7])
    # the reference flips the same bit of its own (nearly equal) iterate
    assert np.signbit(jv) == np.signbit(tv)
    if bit % 64 == 63:
        assert tv == -tb[7]


def test_solver_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsolvers.RedundantSubspaceCG()
    s = tsolvers.RedundantSubspaceCG(device="cpu")
    assert s.device.type == "cpu" and s.a.device.type == "cpu"
    # the operator, its blocks and inverses, and the solve vectors
    n, blk = s.cfg.n, 2 * s.cfg.n // s.cfg.n_subspaces
    assert s.nbytes() >= 8 * (n * n + 2 * s.cfg.n_subspaces * blk * blk)


def test_solver_campaign_ledger_holds_only_the_pod_surface(tmp_path):
    """The solver workload through the CLI: the reference's 29 rows are
    held in tests/test_torch_chaos.py; here the uncovered ledger is empty
    (the pod surface, the last one, is protected by `ft.runtime` since its
    pod paths were ported), so no solver surface is uncovered either."""
    out = tmp_path / "solver.json"
    assert cli.main(["--device", "cpu", "--space", "default", "--workload",
                     "solver", "--json", str(out), "--quiet"]) == 0
    d = json.loads(out.read_text())
    assert [s["surface"] for s in d["uncovered_surfaces"]] == []
    assert d["summary"]["by_outcome"] == {
        "corrected": 28, "absorbed": 0, "detected": 0, "missed": 0,
        "false_alarm": 0, "clean": 1, "skipped": 0}
    assert d["meta"]["solver"] == {
        "n": 96, "n_subspaces": 12, "replicas": 2, "pods": 3,
        "placement": "anti", "rtol": 1e-10, "max_iters": 500,
        "guard_factor": 10.0, "local_tol": 1e-8, "seed": 0}
    assert cli.main(["--device", "cpu", "--space", "default", "--workload",
                     "solver", "--check", "--quiet"]) == 0
