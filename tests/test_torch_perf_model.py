"""The port's copy of the paper's α-β-γ model (``repro_torch.core.
model_perf``): ``tests/test_perf_model.py``'s cases on both packages, and
every function giving the reference's float, exactly, for the same
inputs."""
import pytest

import repro.core.model_perf as jmp
import repro_torch.core.model_perf as tmp

PAPER_TABLE1_MODEL = {
    64: (3.09, 2.49, 2.40),
    81: (3.09, 2.55, 2.46),
    100: (3.10, 2.60, 2.52),
    121: (3.10, 2.65, 2.53),
    256: (3.12, 2.79, 2.63),
    484: (3.13, 2.88, 2.74),
}
PAPER_TABLE2_OVERHEAD = {64: 129.2, 121: 118.3, 484: 109.4}


@pytest.fixture(params=["ref", "port"])
def mp(request):
    return jmp if request.param == "ref" else tmp


def test_reproduces_table1_model_values(mp):
    rows = mp.weak_scaling_table(3000, [8, 9, 10, 11, 16, 22])
    for p, pblas, abft0, abft1 in rows:
        ref = PAPER_TABLE1_MODEL[p]
        assert abs(pblas / ref[0] - 1) < 0.035, (p, pblas, ref[0])
        assert abs(abft0 / ref[1] - 1) < 0.05, (p, abft0, ref[1])
        assert abs(abft1 / ref[2] - 1) < 0.06, (p, abft1, ref[2])


def test_reproduces_table2_overhead_trend(mp):
    rows = {p: (pb, a0) for p, pb, a0, _ in mp.weak_scaling_table(
        3000, [8, 11, 22])}
    overheads = {p: 100 * pb / a0 for p, (pb, a0) in rows.items()}
    for p, ref in PAPER_TABLE2_OVERHEAD.items():
        assert abs(overheads[p] - ref) < 4.0, (p, overheads[p], ref)
    assert overheads[64] > overheads[121] > overheads[484]


def test_headline_claim_1_4_tflops_484_procs(mp):
    t0 = mp.abft_pdgemm_time(3000, 484, mp.JACQUARD)
    t1 = t0 + mp.abft_failure_overhead(3000, 484, mp.JACQUARD)
    n_data = 21 * 3000
    total_tflops = mp.gflops_per_proc(n_data, 484, t1) * 484 / 1000
    assert 1.25 < total_tflops < 1.45
    t_pblas = mp.pdgemm_time(22 * 3000, 484, mp.JACQUARD)
    overhead0 = mp.gflops_per_proc(22 * 3000, 484, t_pblas) / \
        mp.gflops_per_proc(n_data, 484,
                           mp.abft_pdgemm_time(3000, 484, mp.JACQUARD))
    assert overhead0 - 1 < 0.12


def test_abft_efficiency_increases_with_p(mp):
    rows = mp.weak_scaling_table(3000, [8, 12, 16, 20, 22])
    eff = [a0 / pb for _, pb, a0, _ in rows]
    assert all(b > a for a, b in zip(eff, eff[1:]))


def test_strong_scaling_overhead_governed_by_p_not_n(mp):
    for q in (8, 16):
        p = q * q
        ov = []
        for nloc in (1000, 2000, 4000):
            n = q * nloc
            t_p = mp.pdgemm_time(n, p, mp.JACQUARD)
            t_a = mp.abft_pdgemm_time(nloc, p, mp.JACQUARD)
            ov.append(mp.gflops_per_proc(n, p, t_p)
                      / mp.gflops_per_proc((q - 1) * nloc, p, t_a))
        assert max(ov) - min(ov) < 0.04
    t8 = mp.weak_scaling_table(3000, [8])[0]
    t22 = mp.weak_scaling_table(3000, [22])[0]
    assert (t8[1] / t8[2]) > (t22[1] / t22[2]) + 0.1


MACHINES = [jmp.JACQUARD, jmp.Machine(gamma=1e-12, beta=2.5e-10,
                                      alpha=1e-6, name="h")]


@pytest.mark.parametrize("m", MACHINES, ids=lambda m: m.name)
@pytest.mark.parametrize("nb", [32, 64])
def test_every_function_gives_the_reference_float(m, nb):
    tm = tmp.Machine(**vars(m))
    assert tm == tmp.Machine(m.gamma, m.beta, m.alpha, m.name)
    assert vars(tmp.JACQUARD) == vars(jmp.JACQUARD)
    for q in (2, 8, 11, 22):
        p = q * q
        for nloc in (1000, 3000):
            assert tmp.pdgemm_time(q * nloc, p, tm, nb) == \
                jmp.pdgemm_time(q * nloc, p, m, nb)
            assert tmp.abft_pdgemm_time(nloc, p, tm, nb) == \
                jmp.abft_pdgemm_time(nloc, p, m, nb)
            assert tmp.abft_failure_overhead(nloc, p, tm, nb) == \
                jmp.abft_failure_overhead(nloc, p, m, nb)
            assert tmp.abft_failure_overhead(
                nloc, p, tm, nb, t_restart_base=0.1,
                t_restart_per_proc=0.0) == jmp.abft_failure_overhead(
                nloc, p, m, nb, t_restart_base=0.1, t_restart_per_proc=0.0)
            assert tmp.gflops_per_proc(nloc, p, 0.37) == \
                jmp.gflops_per_proc(nloc, p, 0.37)
    assert tmp.weak_scaling_table(3000, range(8, 23), tm, nb) == \
        jmp.weak_scaling_table(3000, range(8, 23), m, nb)
    assert tmp.__all__ == jmp.__all__
