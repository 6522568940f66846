"""The port's layer-level ABFT matmul against the JAX reference: the cases
of tests/test_abft_gemm.py, with the same numpy inputs through both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft_gemm as jg
from repro_torch.core import abft_gemm as tg
from repro_torch.kernels import abft_matmul as kmm
from torch_port_helpers import assert_close

# the reference's "pallas" backend is the port's "cuda" backend
_BACKEND = {"ref": ("ref", "ref"), "kernel": ("pallas", "cuda")}


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _cfgs(backend="ref", **kw):
    jb, tb = _BACKEND[backend]
    return jg.ABFTConfig(backend=jb, **kw), tg.ABFTConfig(backend=tb, **kw)


def _pair(rs, *shape):
    x = rs.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("mode", ["off", "checksum", "verify", "correct"])
def test_modes_match_reference(rs, mode, backend):
    cj, ct = _cfgs(backend, mode=mode, f=2)
    Wj, Wt = _pair(rs, 256, 384)
    Xj, Xt = _pair(rs, 2, 64, 256)
    yj, okj = jg.abft_matmul(Xj, jg.encode_weight(Wj, cj) if cj.active
                             else Wj, cj)
    yt, okt = tg.abft_matmul(Xt, tg.encode_weight(Wt, ct) if ct.active
                             else Wt, ct)
    assert_close(yt, yj)
    assert_close(yt, Xt @ Wt)
    if mode in ("verify", "correct"):
        assert bool(okt) and bool(okj)
    else:
        assert okt is None and okj is None


def test_encode_weight_matches_reference(rs):
    cj, ct = _cfgs(mode="verify")
    Wj, Wt = _pair(rs, 64, 96)
    assert_close(tg.encode_weight(Wt, ct), jg.encode_weight(Wj, cj))
    np.testing.assert_array_equal(
        tg._weights(96, 2, 17).numpy(),
        np.asarray(jg._weights(96, 2, 17, jnp.float32)))


@pytest.mark.parametrize("r,c,d", [(0, 0, 100.0), (7, 47, -3e3),
                                   (3, 20, 1e5)])
def test_flip_detect_and_correct_like_reference(rs, r, c, d):
    """Same corrupted output through both: both flag it, repair the same
    element, and land on the clean product."""
    cj, ct = _cfgs(mode="correct", f=2)
    Wj, Wt = _pair(rs, 32, 48)
    Xj, Xt = _pair(rs, 8, 32)
    yf = np.asarray(Xj @ jg.encode_weight(Wj, cj))
    y, ycs = yf[:, :-2].copy(), yf[:, -2:].copy()
    y[r, c] += d
    okj, resj = jg.verify_output(jnp.asarray(y), jnp.asarray(ycs), cj)
    okt, rest = tg.verify_output(torch.from_numpy(y), torch.from_numpy(ycs),
                                 ct)
    assert not bool(okj) and not bool(okt)
    fixj = np.asarray(jg.correct_output(jnp.asarray(y), jnp.asarray(ycs),
                                        resj, cj))
    fixt = tg.correct_output(torch.from_numpy(y), torch.from_numpy(ycs),
                             rest, ct).numpy()
    clean = np.asarray(Xj @ Wj)
    tol = max(1e-3, abs(d) * 1e-7)
    np.testing.assert_allclose(fixt, clean, rtol=1e-4, atol=tol)
    np.testing.assert_allclose(fixt, fixj, rtol=1e-4, atol=tol)
    moved = np.argwhere(np.abs(fixt - y) > tol)
    assert moved.tolist() == [[r, c]]


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_checksum_column_corruption_detected_like_reference(rs, backend):
    cj, ct = _cfgs(backend, mode="verify", f=2)
    Wj, Wt = _pair(rs, 256, 384)
    Xj, Xt = _pair(rs, 128, 256)
    w_bad_j = jg.encode_weight(Wj, cj).at[100, 384].add(50.0)
    w_bad_t = tg.encode_weight(Wt, ct)
    w_bad_t[100, 384] += 50.0
    _, okj = jg.abft_matmul(Xj, w_bad_j, cj)
    _, okt = tg.abft_matmul(Xt, w_bad_t, ct)
    assert not bool(okj) and not bool(okt)


def test_kernel_backend_takes_the_kernel_dispatch(rs):
    """backend="cuda" reaches the kernel wrapper (its plain version on a
    CPU tensor); backend="ref" and "auto" on CPU do not."""
    Wt = torch.from_numpy(rs.standard_normal((64, 96)).astype(np.float32))
    Xt = torch.from_numpy(rs.standard_normal((8, 64)).astype(np.float32))
    for backend, calls in (("cuda", 1), ("ref", 0), ("auto", 0)):
        cfg = tg.ABFTConfig(mode="verify", backend=backend)
        before = kmm.plain_calls
        tg.abft_matmul(Xt, tg.encode_weight(Wt, cfg), cfg)
        assert kmm.plain_calls - before == calls, backend


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("m,k,n", [(8, 32, 48), (64, 256, 384),
                                   (128, 512, 256), (16, 128, 640)])
def test_clean_bf16_never_false_alarms(rs, backend, m, k, n):
    cj, ct = _cfgs(backend, mode="verify", f=2, in_dtype="bf16")
    Wj, Wt = _pair(rs, k, n)
    Xj, Xt = _pair(rs, m, k)
    yj, okj = jg.abft_matmul(Xj, jg.encode_weight(Wj, cj), cj)
    yt, okt = tg.abft_matmul(Xt, tg.encode_weight(Wt, ct), ct)
    assert bool(okt) and bool(okj), (m, k, n, backend)
    # both multiply the same bf16 operands in fp32; only the sum order
    # differs
    assert_close(yt, yj)


def test_bf16_flip_detected_and_corrected_like_reference(rs):
    cj, ct = _cfgs(mode="verify", f=2, in_dtype="bf16")
    Wj, Wt = _pair(rs, 64, 96)
    Xj, Xt = _pair(rs, 8, 64)
    yf = np.asarray(jnp.dot(Xj.astype(jnp.bfloat16),
                            jg.encode_weight(Wj, cj).astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32))
    y, ycs = yf[:, :-2].copy(), yf[:, -2:].copy()
    okt, _ = tg.verify_output(torch.from_numpy(y), torch.from_numpy(ycs), ct)
    assert bool(okt)
    y_bad = y.copy()
    y_bad[3, 40] += 4e4
    okt, rest = tg.verify_output(torch.from_numpy(y_bad),
                                 torch.from_numpy(ycs), ct)
    okj, resj = jg.verify_output(jnp.asarray(y_bad), jnp.asarray(ycs), cj)
    assert not bool(okt) and not bool(okj)
    fixt = tg.correct_output(torch.from_numpy(y_bad), torch.from_numpy(ycs),
                             rest, ct).numpy()
    fixj = np.asarray(jg.correct_output(jnp.asarray(y_bad), jnp.asarray(ycs),
                                        resj, cj))
    assert float(np.max(np.abs(fixt - y))) < 1.0
    np.testing.assert_allclose(fixt, fixj, rtol=1e-5, atol=1e-3)


def test_int8_forward_matches_reference(rs):
    cj, ct = _cfgs(mode="verify", f=2, in_dtype="int8")
    Wj, Wt = _pair(rs, 64, 96)
    Xj, Xt = _pair(rs, 8, 64)
    yfj, resj = jg._int8_forward(Xj, jg.encode_weight(Wj, cj), cj)
    yft, rest = tg._int8_forward(Xt, tg.encode_weight(Wt, ct), ct)
    assert_close(yft, yfj)
    assert bool(tg._residual_ok(yft[:, :-2], rest, ct))
    yt, okt = tg.abft_matmul(Xt, tg.encode_weight(Wt, ct), ct)
    assert bool(okt)
    assert_close(yt, jg.abft_matmul(Xj, jg.encode_weight(Wj, cj), cj)[0])


def test_int8_flip_detected_and_corrected_like_reference(rs):
    cj, ct = _cfgs(mode="correct", f=2, in_dtype="int8")
    Wj, Wt = _pair(rs, 64, 96)
    Xj, Xt = _pair(rs, 8, 64)
    yft, _ = tg._int8_forward(Xt, tg.encode_weight(Wt, ct), ct)
    y, ycs = yft[:, :-2].clone(), yft[:, -2:].clone()
    y_bad = y.clone()
    y_bad[5, 17] += 3e3
    okt, rest = tg.verify_output(y_bad, ycs, ct)
    assert not bool(tg._residual_ok(y_bad, rest, ct)) and not bool(okt)
    fixt = tg.correct_output(y_bad, ycs, rest, ct)
    np.testing.assert_allclose(fixt.numpy(), y.numpy(), rtol=1e-3, atol=1e-2)
    _, resj = jg.verify_output(jnp.asarray(y_bad.numpy()),
                               jnp.asarray(ycs.numpy()), cj)
    fixj = jg.correct_output(jnp.asarray(y_bad.numpy()),
                             jnp.asarray(ycs.numpy()), resj, cj)
    np.testing.assert_allclose(fixt.numpy(), np.asarray(fixj), rtol=1e-5,
                               atol=1e-3)


def test_step_options_thread_kernel_dtype():
    from repro_torch.train.step import StepOptions
    opts = StepOptions(abft_mode="verify", kernel_dtype="bf16")
    assert opts.abft.in_dtype == "bf16"
    assert opts.abft.compute_dtype == torch.bfloat16
    assert StepOptions(abft_mode="verify").abft.in_dtype == "fp32"
    assert StepOptions().abft is None
    with pytest.raises(ValueError):
        tg.ABFTConfig(mode="verify", in_dtype="fp8").compute_dtype
