"""The port's FTContext (``repro_torch.core.context``) held against the
reference's (``repro.core.context``), the paper's ABFT-BLAS framework
lifecycle (§4.1): the same seeded trees registered in each of the three
modes give the same checksums (bit for bit for ``gf256`` and ``xor``,
within fp32 rounding for ``floating_point``), the same recovered values,
and the same capacity and mode errors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.context import FTContext as JContext
from repro_torch.core.context import FTContext
from repro_torch.tree import tree_leaves
from torch_port_helpers import assert_close, to_np


def _np_tree(rs, p=4):
    return {"a": rs.standard_normal((p, 8)).astype(np.float32),
            "b": {"c": rs.standard_normal((p, 4, 2)).astype(np.float32)}}


def _jtree(t):
    return {"a": jnp.asarray(t["a"]), "b": {"c": jnp.asarray(t["b"]["c"])}}


def _ttree(t):
    return {"a": torch.from_numpy(t["a"].copy()),
            "b": {"c": torch.from_numpy(t["b"]["c"].copy())}}


def _leaves(tree):
    return [to_np(x) for x in tree_leaves(
        {"a": tree["a"], "b": {"c": tree["b"]["c"]}})]


def _same_bits(x, y):
    return np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                          np.ascontiguousarray(y).view(np.uint8))


CASES = [("floating_point", 1, [2], None), ("floating_point", 2, [0, 3], None),
         ("gf256", 1, [2], None), ("gf256", 1, [2], 0.0),
         ("gf256", 2, [1, 3], None), ("xor", 1, [2], None),
         ("xor", 1, [0], 5.0)]


@pytest.mark.parametrize("mode,f,failed,corrupt_to", CASES)
def test_register_fail_recover_matches_reference(rs, mode, f, failed,
                                                 corrupt_to):
    tree = _np_tree(rs)
    jctx, tctx = JContext(4, f=f), FTContext(4, f=f)
    assert np.array_equal(to_np(tctx.a), np.asarray(jctx.a))
    jctx.register("state", _jtree(tree), mode=mode)
    tctx.register("state", _ttree(tree), mode=mode)
    # the checksums
    for jy, ty in zip(_leaves(jctx._reg["state"].checksums),
                      _leaves(tctx._reg["state"].checksums)):
        assert ty.dtype == jy.dtype and ty.shape == jy.shape
        if mode == "floating_point":
            assert_close(ty, jy)
        else:
            assert _same_bits(ty, jy)
    # NaN poison for gf256 in the reference's tests is replaced by 0.0
    # (its recover zeroes the failed shards either way)
    jctx.fail(failed, corrupt_to=0.0 if mode == "gf256" else corrupt_to)
    tctx.fail(failed, corrupt_to=corrupt_to)
    for x, want in zip(_leaves(tctx.get("state")), _leaves(tree)):
        ok = [i for i in range(4) if i not in failed]
        assert _same_bits(x[ok], want[ok])
        fill = np.nan if corrupt_to is None else corrupt_to
        assert np.array_equal(x[failed], np.full_like(x[failed], fill),
                              equal_nan=True)
    jctx.recover(failed)
    tctx.recover(failed)
    for got, ref, want in zip(_leaves(tctx.get("state")),
                              _leaves(jctx.get("state")), _leaves(tree)):
        assert got.dtype == np.float32
        if mode == "floating_point":
            assert_close(got, ref)
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            assert _same_bits(got, ref) and _same_bits(got, want)


def test_registered_tensors_are_not_written(rs):
    tree = _ttree(_np_tree(rs))
    before = [x.clone() for x in tree_leaves(tree)]
    ctx = FTContext(4, f=1)
    ctx.register("s", tree, mode="xor")
    ctx.fail([1])
    ctx.recover([1])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(tree), before))


def test_gf256_multi_failure_bit_exact(rs):
    p = 6
    tree = _np_tree(rs, p)
    ctx = FTContext(p, f=2)
    ctx.register("s", _ttree(tree), mode="gf256")
    ctx.fail([1, 4])
    ctx.recover([1, 4])
    assert _same_bits(to_np(ctx.get("s")["a"]), tree["a"])


def test_update_reencodes(rs):
    tree = _np_tree(rs)
    tree2 = {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}}
    jctx, tctx = JContext(4, f=1), FTContext(4, f=1)
    jctx.register("s", _jtree(tree))
    tctx.register("s", _ttree(tree))
    jctx.update("s", _jtree(tree2))
    tctx.update("s", _ttree(tree2))
    for ctx in (jctx, tctx):
        ctx.fail([0])
        ctx.recover([0])
    np.testing.assert_allclose(to_np(tctx.get("s")["a"]), tree2["a"],
                               atol=1e-5)
    assert_close(to_np(tctx.get("s")["a"]), to_np(jctx.get("s")["a"]))


@pytest.mark.parametrize("make", [JContext, FTContext])
def test_capacity_guard(rs, make):
    tree = _np_tree(rs)
    ctx = make(4, f=1)
    ctx.register("s", _jtree(tree) if make is JContext else _ttree(tree))
    with pytest.raises(ValueError, match="exceed encoding capacity"):
        ctx.recover([0, 1])


@pytest.mark.parametrize("make", [JContext, FTContext])
def test_invalid_modes(rs, make):
    tree = _np_tree(rs)
    tree = _jtree(tree) if make is JContext else _ttree(tree)
    ctx = make(4, f=2)
    with pytest.raises(ValueError, match="f=1 only"):
        ctx.register("s", tree, mode="xor")
    with pytest.raises(ValueError, match="unknown encoding mode"):
        ctx.register("s", tree, mode="rot13")
    with pytest.raises(ValueError, match="need f < p"):
        make(4, f=4)


def test_xor_needs_32_bit_words():
    ctx = FTContext(4, f=1)
    with pytest.raises(TypeError, match="32-bit"):
        ctx.register("s", {"a": torch.zeros(4, 3, dtype=torch.float64)},
                     mode="xor")
