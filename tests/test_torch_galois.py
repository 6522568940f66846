"""The port's GF(2^8) Reed-Solomon coding (``repro_torch.core.galois``)
held against the reference's (``repro.core.galois``): the same shards give
the same checksum bytes and the same recovered bytes, bit for bit.  Field
arithmetic is exact, so the port's gathers through a product table and
its solve-by-inverse give the reference's bytes whatever their order."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import galois as jg
from repro_torch.core import galois as tg


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.ascontiguousarray(x).view(np.uint8)


def _both(shards: np.ndarray, f: int, failed, fill=0):
    """Encode and recover ``shards`` in both packages; the failed shards
    are overwritten with ``fill`` before the recovery."""
    jenc = jg.gf_encode(shards, f)
    tenc = tg.gf_encode(torch.from_numpy(shards), f)
    damaged = shards.copy()
    damaged[failed] = fill
    jrec = jg.gf_recover(damaged, jenc, failed)
    trec = tg.gf_recover(torch.from_numpy(damaged), tenc, failed)
    return jenc, tenc, jrec, trec


def test_field_axioms():
    a = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(tg.GF.mul(a, 1), a)
    assert torch.equal(tg.GF.mul(a, 0), torch.zeros(256, dtype=torch.uint8))
    for x in range(1, 256):
        assert int(tg.GF.mul(x, tg.GF.inv(x))) == 1
        assert tg.GF.inv(x) == jg.GF.inv(x)
    # the whole product table is the reference's
    an = np.arange(256, dtype=np.uint8)
    assert np.array_equal(tg.GF.products("cpu").numpy(),
                          jg.GF.mul(an[:, None], an[None, :]))
    with pytest.raises(ZeroDivisionError):
        tg.GF.inv(0)


def test_cauchy_submatrices_nonsingular():
    m = tg.cauchy_matrix(3, 8)
    assert np.array_equal(m.numpy(), jg.cauchy_matrix(3, 8))
    for r in [(0, 1), (0, 2), (1, 2)]:
        for c in [(0, 5), (2, 7), (3, 4)]:
            sub = m[list(r)][:, list(c)]
            x = tg.GF.solve(sub, torch.eye(2, dtype=torch.uint8))
            assert np.array_equal(
                x.numpy(), jg.GF.solve(sub.numpy(), np.eye(2, dtype=np.uint8)))
            assert torch.equal(tg.GF.matmul(sub, x),
                               torch.eye(2, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tg.cauchy_matrix(128, 129)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8,
                                   np.float64])
@pytest.mark.parametrize("f,p,failed", [(1, 4, [2]), (2, 8, [0, 7]),
                                        (3, 6, [1, 3, 5]), (3, 6, [4]),
                                        (2, 4, [])])
def test_bit_exact_recovery_matches_reference(rs, dtype, f, p, failed):
    if np.issubdtype(dtype, np.floating):
        shards = rs.standard_normal((p, 16, 8)).astype(dtype)
    else:
        shards = rs.randint(0, 200, (p, 16, 8)).astype(dtype)
    jenc, tenc, jrec, trec = _both(shards, f, failed)
    assert tenc.dtype == torch.from_numpy(jenc).dtype
    assert tuple(tenc.shape) == jenc.shape == (f, 16, 8)
    assert np.array_equal(_bytes(tenc), _bytes(jenc))
    assert np.array_equal(_bytes(trec), _bytes(jrec))
    assert np.array_equal(_bytes(trec), _bytes(shards))


def test_float_special_values_exact(rs):
    shards = rs.standard_normal((4, 8)).astype(np.float32)
    shards[1, 3] = np.inf
    shards[2, 5] = np.nan
    jenc, tenc, jrec, trec = _both(shards, 2, [1, 2])
    assert np.array_equal(_bytes(tenc), _bytes(jenc))
    assert np.array_equal(_bytes(trec), _bytes(shards))
    # NaN in the failed shards does not reach the recovered bytes
    _, _, _, trec = _both(shards, 2, [1, 2], fill=np.nan)
    assert np.array_equal(_bytes(trec), _bytes(shards))


def test_one_dimensional_shards_and_bf16():
    """Shards of one element each, and a dtype numpy has not: the byte
    view covers both."""
    x = torch.tensor([1.5, -2.0, 3.25, 7.0], dtype=torch.float32)
    enc = tg.gf_encode(x, 1)
    assert enc.shape == (1,)
    assert np.array_equal(_bytes(enc),
                          _bytes(jg.gf_encode(x.numpy(), 1)))
    assert torch.equal(tg.gf_recover(x, enc, [3]), x)
    xb = torch.randn(5, 6, generator=torch.Generator().manual_seed(0)
                     ).to(torch.bfloat16)
    encb = tg.gf_encode(xb, 2)
    assert encb.dtype == torch.bfloat16
    ref = jg.gf_encode(xb.view(torch.int16).numpy(), 2)
    assert np.array_equal(_bytes(encb.view(torch.int16)), _bytes(ref))
    got = tg.gf_recover(xb, encb, [0, 4])
    assert torch.equal(got.view(torch.int16), xb.view(torch.int16))


def test_chunked_gather_is_the_same(monkeypatch, rs):
    """Bytes cut into chunks (the bound on the index temporary) give the
    same checksums as one pass."""
    shards = rs.randint(0, 256, (5, 1000)).astype(np.uint8)
    whole = tg.gf_encode(torch.from_numpy(shards), 3)
    monkeypatch.setattr(tg, "_CHUNK", 64)
    assert torch.equal(tg.gf_encode(torch.from_numpy(shards), 3), whole)
    assert np.array_equal(whole.numpy(), jg.gf_encode(shards, 3))


@settings(max_examples=20, deadline=None)
@given(p=st.integers(3, 12), f=st.integers(1, 3), seed=st.integers(0, 2**16))
def test_recovery_property(p, f, seed):
    rng = np.random.RandomState(seed)
    f = min(f, p - 1)
    shards = rng.randint(0, 255, (p, 32)).astype(np.uint8)
    failed = sorted(rng.choice(p, size=f, replace=False).tolist())
    jenc, tenc, jrec, trec = _both(shards, f, failed, fill=123)
    assert np.array_equal(tenc.numpy(), jenc)
    assert np.array_equal(trec.numpy(), jrec)
    assert np.array_equal(trec.numpy(), shards)


def test_capacity_exceeded(rs):
    shards = torch.from_numpy(rs.standard_normal((4, 8)).astype(np.float32))
    enc = tg.gf_encode(shards, 1)
    with pytest.raises(ValueError):
        tg.gf_recover(shards, enc, [0, 1])
