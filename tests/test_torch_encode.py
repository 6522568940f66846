"""Kernel #3, the diskless-checkpoint encode, against the JAX reference.

On this CPU the port's wrapper runs the kernel's plain PyTorch version (it
takes it only for CPU tensors); the reference runs its Pallas kernel in
interpret mode, or its einsum oracle where the Pallas kernel does not take
the shape.  The CUDA kernel itself is held against the plain version on the
card by the ``gpu``-marked test at the end and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.checksum import checkpoint_matrix as jmatrix
from repro.kernels import ref as jref
from repro.kernels.checksum_encode import checksum_encode_pallas
from repro_torch import obs
from repro_torch.core.checksum import checkpoint_matrix
from repro_torch.kernels import checksum_encode as kenc
from repro_torch.kernels import ops, ref
from torch_port_helpers import to_np, to_torch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference test's tolerances (tests/test_kernels.py): fp32 sums in
# another order; bf16 outputs may round one bf16 ulp apart
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ENCODERS = {"plain": kenc.checksum_encode_plain,
            "wrapper": kenc.checksum_encode_cuda,
            "dispatcher": ops.checksum_encode}


def _inputs(rs, p, f, m, n, dtype):
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(rs.standard_normal((p, m, n)), jdt)
    return x, jmatrix(f, p), to_torch(x, tdt), checkpoint_matrix(f, p)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("fn", sorted(ENCODERS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p,f,m,n", [(4, 1, 128, 128), (8, 2, 256, 128),
                                     (16, 3, 128, 384)])
def test_encode_matches_pallas_kernel(rs, p, f, m, n, dtype, fn):
    """The reference kernel test's cases and tolerances, against the Pallas
    kernel (interpret mode) and its oracle."""
    xj, aj, xt, at = _inputs(rs, p, f, m, n, dtype)
    got = ENCODERS[fn](xt, at)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (f, m, n)
    _close(got, checksum_encode_pallas(xj, aj, bm=128, bn=128,
                                       interpret=True), dtype)
    _close(got, jref.checksum_encode_ref(xj, aj), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p,f,m,n", [(4, 1, 74, 130),
                                     (4, 1, 6, 4358), (4, 1, 1, 224),
                                     (16, 3, 200, 131), (3, 2, 5, 7),
                                     (5, 5, 1, 1)])
def test_ragged_shapes_match_reference(rs, p, f, m, n, dtype):
    """m and n need not be multiples of 128: the port encodes every shape
    (the reference's einsum oracle is the reference here, since its Pallas
    kernel takes only multiples of its block)."""
    xj, aj, xt, at = _inputs(rs, p, f, m, n, dtype)
    got = ops.checksum_encode(xt, at)
    _close(got, jref.checksum_encode_ref(xj, aj), dtype)
    # the plain version is the port's oracle up to the sum order
    _close(got, ref.checksum_encode_ref(xt, at), dtype)


def test_checksum_verify_ref_matches_reference(rs):
    c = rs.standard_normal((48, 24)).astype(np.float32)
    colsum = c.sum(axis=0) + rs.standard_normal(24).astype(np.float32) * 1e-3
    got = ref.checksum_verify_ref(torch.from_numpy(c), torch.from_numpy(colsum))
    want = jref.checksum_verify_ref(jnp.asarray(c), jnp.asarray(colsum))
    # the column sums cancel: both are within 48 eps32 of their terms
    atol = 4 * 48 * 2.0 ** -24 * float(np.abs(c).sum(axis=0).max())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=atol)


def test_bf16_rounds_once_to_nearest_even():
    """The checksum is summed in fp32 and rounded once, to nearest even:
    1 + 2^-9 + 2^-9 = 1 + 2^-8 is a tie between the bf16 values 1 and
    1 + 2^-7 and rounds to 1."""
    x = torch.tensor([1.0, 2.0 ** -9, 2.0 ** -9], dtype=torch.float32)
    xt = x.reshape(3, 1, 1)
    a = torch.ones((1, 3))
    y32 = kenc.checksum_encode_plain(xt, a)
    assert float(y32) == 1.0 + 2.0 ** -8
    # the same sum from bf16 shards (2^-9 is exact in bf16)
    y16 = kenc.checksum_encode_plain(xt.to(torch.bfloat16), a)
    assert y16.dtype == torch.bfloat16 and float(y16) == 1.0


def test_dispatcher_counts_plain_calls_and_publishes_once(rs):
    """A CPU tensor takes the plain version (counted as such, never as a
    launch), and each new shape is published once."""
    traces = obs.counter("repro_kernel_traces_total")
    before = traces.value(op="checksum_encode", backend="plain")
    launches, plain = kenc.launches, kenc.plain_calls
    x = torch.from_numpy(rs.standard_normal((4, 3, 11)).astype(np.float32))
    a = checkpoint_matrix(2, 4)
    for _ in range(3):
        ops.checksum_encode(x, a)
    assert (kenc.launches, kenc.plain_calls) == (launches, plain + 3)
    assert traces.value(op="checksum_encode", backend="plain") <= before + 1


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x = torch.zeros((4, 2, 3))
    a = torch.ones((1, 4))
    with pytest.raises(TypeError):
        kenc.checksum_encode_cuda(x.half(), a)
    with pytest.raises(TypeError):
        kenc.checksum_encode_cuda(x.to(torch.int32), a)
    with pytest.raises(TypeError):
        kenc.checksum_encode_cuda(x, a.double())
    with pytest.raises(ValueError):
        kenc.checksum_encode_cuda(x, torch.ones((1, 3)))
    with pytest.raises(ValueError):
        kenc.checksum_encode_cuda(x[0], a)
    with pytest.raises(ValueError):
        kenc.checksum_encode_cuda(torch.zeros((4096, 1, 1)),
                                  torch.ones((4, 4096)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py runs this comparison on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for p, f, m, n in [(4, 1, 37984, 896), (4, 1, 6, 4358), (4, 1, 1, 224),
                       (16, 3, 200, 131), (8, 6, 33, 17)]:
        x = torch.randn((p, m, n), generator=g, device="cuda").to(dtype)
        a = checkpoint_matrix(f, p, device="cuda")
        launches = kenc.launches
        got = kenc.checksum_encode_cuda(x, a)
        want = kenc.checksum_encode_plain(x, a)
        torch.cuda.synchronize()
        assert kenc.launches == launches + 1
        # any sum order is within p eps32 of the terms' magnitudes; a bf16
        # output may then round one bf16 ulp (2^-7 of the value) apart
        terms = torch.matmul(a.abs(), x.reshape(p, -1).float().abs())
        tol = 4 * p * 2.0 ** -24 * terms.reshape(want.shape)
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * want.float().abs()
        assert bool(((got.float() - want.float()).abs() <= tol).all())
