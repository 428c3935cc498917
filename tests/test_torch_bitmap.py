"""The port's plain-PyTorch bitmap algebra (pilosa_tpu_torch/ops/bitmap.py)
against pilosa_tpu/ops/bitmap.py on the same random words: exact equality.

Words are made with numpy from a seed; the port sees them as int32, the
reference as uint32, and results compare as unsigned integers.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitmap as ref
from pilosa_tpu_torch.ops import bitmap as ob

W = 1024


def words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


SHAPES = [(W,), (3, W), (2, 5, W)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["b_and", "b_or", "b_xor", "b_andnot", "b_not"])
def test_elementwise(name, shape):
    rng = np.random.default_rng(1)
    a, b = words(rng, *shape), words(rng, *shape)
    got = getattr(ob, name)(t(a), t(b)).numpy().view(np.uint32)
    want = np.asarray(getattr(ref, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_popcounts(shape):
    rng = np.random.default_rng(2)
    a, b = words(rng, *shape), words(rng, *shape)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert int(ob.popcount(t(a))) == int(ref.popcount(ja))
    np.testing.assert_array_equal(
        ob.popcount_rows(t(a)).numpy(), np.asarray(ref.popcount_rows(ja)).astype(np.int64)
    )
    assert int(ob.count_and(t(a), t(b))) == int(ref.count_and(ja, jb))
    assert int(ob.count_andnot(t(a), t(b))) == int(ref.count_andnot(ja, jb))
    np.testing.assert_array_equal(
        ob.count_and_rows(t(a), t(b)).numpy(),
        np.asarray(ref.count_and_rows(ja, jb)).astype(np.int64),
    )


def test_popcount_words_edge_values():
    vals = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555, 0xAAAAAAAA], np.uint32)
    got = ob.popcount_words(t(vals)).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in vals]


def test_popcount_wraps_mod_2_32():
    # 2^27 all-ones words would be 2^32 bits; a smaller stand-in for the
    # same arithmetic: the all-axes count keeps only the low 32 bits
    a = np.full(1 << 20, 0xFFFFFFFF, np.uint32)
    assert int(ob.popcount(t(a))) == (32 << 20) & 0xFFFFFFFF
    assert int(ob.popcount(t(a))) == int(ref.popcount(jnp.asarray(a)))


@pytest.mark.parametrize("name", ["union_reduce", "intersect_reduce", "xor_reduce"])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_reduces(name, k):
    rng = np.random.default_rng(3)
    stack = words(rng, k, W)
    got = getattr(ob, name)(t(stack)).numpy().view(np.uint32)
    want = np.asarray(getattr(ref, name)(jnp.asarray(stack)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "start,stop", [(0, 0), (0, 1), (3, 37), (31, 33), (32, 64), (100, 5000), (0, W * 32), (W * 32 - 5, W * 32)]
)
def test_range_mask_and_count(start, stop):
    rng = np.random.default_rng(4)
    a = words(rng, 2, W)
    got = ob.range_mask_words(start, stop, W * 32).numpy().view(np.uint32)
    want = np.asarray(ref.range_mask_words(start, stop, W * 32))
    np.testing.assert_array_equal(got, want)
    assert int(ob.count_range(t(a), start, stop)) == int(ref.count_range(jnp.asarray(a), start, stop))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, W * 32 - 1, W * 32])
@pytest.mark.parametrize("shape", [(W,), (3, W)])
def test_shift_bits(n, shape):
    rng = np.random.default_rng(5)
    a = words(rng, *shape)
    got_s, got_o = ob.shift_bits(t(a), n)
    want_s, want_o = ref.shift_bits(jnp.asarray(a), n)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), np.asarray(want_s))
    np.testing.assert_array_equal(got_o.numpy().view(np.uint32), np.asarray(want_o))


def test_shift_bits_out_of_range():
    with pytest.raises(ValueError):
        ob.shift_bits(torch.zeros(W, dtype=torch.int32), W * 32 + 1)


def test_any_set():
    z = np.zeros((2, W), np.uint32)
    assert not bool(ob.any_set(t(z))) and not bool(ref.any_set(jnp.asarray(z)))
    z[1, 7] = 4
    assert bool(ob.any_set(t(z))) and bool(ref.any_set(jnp.asarray(z)))


def test_pack_unpack_positions():
    rng = np.random.default_rng(6)
    pos = np.unique(rng.integers(0, W * 32, 500))
    np.testing.assert_array_equal(ob.pack_positions(pos, W * 32), ref.pack_positions(pos, W * 32))
    packed = ob.pack_positions(pos, W * 32)
    np.testing.assert_array_equal(ob.unpack_positions(packed), ref.unpack_positions(packed))
    with pytest.raises(ValueError):
        ob.pack_positions([W * 32], W * 32)


def test_host_round_trip():
    rng = np.random.default_rng(7)
    a = words(rng, 3, W)
    np.testing.assert_array_equal(ob.to_host(ob.from_host(a, "cpu")), a)
