"""Row-mode plan evaluation: the port's plan_rows (its plain twin on the
CPU here) against pilosa_tpu's `_eval_jit(plan, "row", ...)`, which fuses
`ops/bitmap.py` `shift_bits` into the tree, on the same numpy inputs.

Random trees of and/or/xor/andnot with Shift nodes (n from 1 to a whole
shard, predecessor tables with gaps and -1s) at small S and W go through
the port's plan evaluation (`exec/plan.py` `_rows`: one plan_rows call per
root, one more per Shift over a subtree) and through the reference's jit;
result words must be identical and each row's count must be the
popcount of its words. The wrapper's checks and the twin's contract
(a fresh result, shifted leaves) are tested directly. The test marked
`cuda` holds the kernel to its twin on the card; it skips where there is
no CUDA device.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pilosa_tpu.exec.plan as jplan
from pilosa_tpu.ops import bitmap as jb
from pilosa_tpu_torch.exec import plan as tplan
from pilosa_tpu_torch.ops import kernels as K

W = 64  # words per row: shifts of up to 2048 bits


def words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def random_tree(rng, depth, n_leaves, s, w=W):
    """A tree spec over leaf slots 0..n_leaves-1 and S = s stack rows of w
    words, built into either package's plan nodes by `build`."""
    if depth == 0:
        return ("leaf", int(rng.integers(n_leaves)))
    if rng.random() < 0.35:
        n = int(rng.choice([1, 5, 31, 32, 33, w * 32 - 1, w * 32]))
        prev = rng.integers(-1, s, s)
        prev[rng.random(s) < 0.3] = -1
        return ("shift", random_tree(rng, depth - 1, n_leaves, s, w), n, tuple(int(p) for p in prev))
    op = str(rng.choice(["and", "or", "xor", "andnot"]))
    return (op, tuple(random_tree(rng, depth - 1, n_leaves, s, w) for _ in range(int(rng.integers(2, 4)))))


def build(spec, mod):
    if spec[0] == "leaf":
        return mod.PLeaf(spec[1])
    if spec[0] == "zero":
        return mod.PZero()
    if spec[0] == "shift":
        return mod.PShift(build(spec[1], mod), spec[2], spec[3])
    return mod.PNary(spec[0], tuple(build(c, mod) for c in spec[1]))


def popcounts(a: np.ndarray) -> np.ndarray:
    return np.unpackbits(a.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int64)


@pytest.mark.parametrize("s", [1, 5, 13])
@pytest.mark.parametrize("seed", range(4))
def test_plan_rows_matches_eval_jit(s, seed):
    rng = np.random.default_rng(1000 + 10 * seed + s)
    n_leaves = 4
    ops = [words(rng, s, W) for _ in range(n_leaves)]
    # sparse rows too, so shifted bits land next to zeros
    ops[3] &= words(rng, s, W) & words(rng, s, W) & words(rng, s, W)
    tops = [t(o) for o in ops]
    jops = tuple(jnp.asarray(o) for o in ops)
    for _ in range(5):
        spec = random_tree(rng, 3, n_leaves, s)
        if spec[0] != "shift":
            spec = ("shift", spec, int(rng.choice([1, 33, W * 32])), tuple(range(-1, s - 1)))
        want = np.asarray(jplan._eval_jit(build(spec, jplan), "row", jops, ()))
        got, counts = tplan._rows(build(spec, tplan), tops, {})
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(counts.numpy(), popcounts(want))


@pytest.mark.parametrize("n", [1, 31, 32, 33, W * 32 - 1, W * 32])
def test_shifted_leaf_matches_shift_bits(n):
    """One shifted leaf: each row is shift_bits' shifted row ORed with its
    predecessor's overflow (none for -1), the reference's carry."""
    rng = np.random.default_rng(n)
    s = 6
    a = words(rng, s, W)
    prev = (3, -1, 0, 0, 5, -1)
    shifted, overflow = (np.asarray(x) for x in jb.shift_bits(jnp.asarray(a), n))
    want = shifted.copy()
    for i, p in enumerate(prev):
        if p >= 0:
            want[i] |= overflow[p]
    got, counts = K.plan_rows([t(a)], [(n, prev)], [0])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(counts.numpy(), popcounts(want))


def test_plan_rows_result_is_fresh_and_counted():
    """A one-leaf program still returns a new tensor (the caller may keep
    it after the operand's pins are released), and n = 0 is no shift."""
    rng = np.random.default_rng(5)
    a = t(words(rng, 3, W))
    out, counts = K.plan_rows([a], [None], [0])
    assert out is not a and out.data_ptr() != a.data_ptr() and torch.equal(out, a)
    assert counts.tolist() == popcounts(a.numpy().view(np.uint32)).tolist()
    out, _ = K.plan_rows([a], [(0, (1, 2, -1))], [0])
    assert torch.equal(out, a)
    out, counts = tplan._rows(tplan.PZero(), [a], {})
    assert not out.any() and counts.tolist() == [0, 0, 0]


def test_plan_rows_checks_its_inputs():
    rng = np.random.default_rng(6)
    a, b = t(words(rng, 3, W)), t(words(rng, 3, W + 1))
    with pytest.raises(ValueError, match="out of range"):
        K.plan_rows([a], [(W * 32 + 1, (0, 1, 2))], [0])
    with pytest.raises(ValueError, match="out of range"):
        K.plan_rows([a], [(-1, (0, 1, 2))], [0])
    with pytest.raises(ValueError, match="predecessor table"):
        K.plan_rows([a], [(3, (0, 1))], [0])
    with pytest.raises(ValueError, match="predecessor table"):
        K.plan_rows([a], [(3, (0, 1, 3))], [0])
    with pytest.raises(ValueError, match="leaf shape"):
        K.plan_rows([a, b], [None, None], [0, 1, K.BINOPS["or"]])
    with pytest.raises(ValueError, match="shifts for"):
        K.plan_rows([a], [], [0])
    with pytest.raises(ValueError, match="leaf 1 of 1"):
        K.plan_rows([a], [None], [0, 1, K.BINOPS["and"]])


def test_count_mode_shift_goes_through_plan_rows(monkeypatch):
    """plan_count takes a Shift as the plan_rows result of that Shift:
    one plan_rows call for a Shift over a leaf, two for one over a
    subtree; a Shift root is counted by its own plan_rows call, with no
    plan_count; counts equal the reference's."""
    rng = np.random.default_rng(7)
    s = 4
    ops = [words(rng, s, W) for _ in range(3)]
    calls = []
    real_rows, real_count = K.plan_rows, K.plan_count
    monkeypatch.setattr(K, "plan_rows", lambda *a: calls.append("rows") or real_rows(*a))
    monkeypatch.setattr(K, "plan_count", lambda *a: calls.append("count") or real_count(*a))
    prev = (-1, 0, 1, 2)
    for spec, n_rows, n_count in [
        (("and", (("shift", ("leaf", 0), 1, prev), ("leaf", 1))), 1, 1),
        (("or", (("shift", ("xor", (("leaf", 0), ("leaf", 2))), 33, prev), ("leaf", 1))), 2, 1),
        (("shift", ("leaf", 2), 31, prev), 1, 0),
        (("shift", ("or", (("leaf", 0), ("leaf", 1), ("leaf", 2))), 64, (-1, 0, -1, 2)), 2, 0),
    ]:
        calls.clear()
        want = np.asarray(jplan._eval_jit(build(spec, jplan), "count", tuple(jnp.asarray(o) for o in ops), ()))
        got = tplan._root_counts(build(spec, tplan), [t(o) for o in ops], s)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert (calls.count("rows"), calls.count("count")) == (n_rows, n_count), spec


@pytest.mark.cuda
def test_cuda_plan_rows_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(8)
    for s, w in ((1, 32768), (13, 1025), (3, 4)):
        ops = [words(rng, s, w) for _ in range(3)]
        for _ in range(6):
            spec = random_tree(rng, 3, 3, s, w)
            root = build(spec, tplan)
            got = tplan._rows(root, [t(o).cuda() for o in ops], {})
            want = tplan._rows(root, [t(o) for o in ops], {})
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
