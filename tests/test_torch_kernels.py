"""The port's kernel functions (pilosa_tpu_torch/ops/kernels.py)
against the JAX functions they replace, on the same numpy inputs: exact
equality.

On CPU tensors each kernel function runs its plain-PyTorch twin, so the
differential tests below hold the twins to:

- count2 / popcount / rows_counts: pilosa_tpu/ops/pallas_kernels.py,
  called directly (interpret mode off-TPU);
- plan_count: pilosa_tpu/exec/plan.py `_eval_jit(..., "count", ...)`;
- gather_tally: pilosa_tpu/ops/bitmap.py `gather_tally_sorted`.

The tests marked `cuda` hold the CUDA kernels to their twins on the card;
they skip where there is no CUDA device or no nvcc.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pilosa_tpu.exec.plan as jplan
import pilosa_tpu.ops.pallas_kernels as pk
from pilosa_tpu.ops import bitmap as jb
from pilosa_tpu_torch.exec import plan as tplan
from pilosa_tpu_torch.ops import kernels as K

W = 1024


def words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---------------------------------------------------------------------------
# twins against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(W,), (3, W), (7, 131), (2, 5, 256)])
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_count2_matches_pallas(shape, op):
    rng = np.random.default_rng(10)
    a, b = words(rng, *shape), words(rng, *shape)
    want = {"and": pk.count_and, "or": pk.count_or, "xor": pk.count_xor, "andnot": pk.count_andnot}[op](a, b)
    assert int(K.count2(t(a), t(b), op)) == int(want)


@pytest.mark.parametrize("shape", [(1,), (W,), (7, 131), (3, 4, W)])
def test_popcount_matches_pallas(shape):
    rng = np.random.default_rng(11)
    a = words(rng, *shape)
    assert int(K.popcount(t(a))) == int(pk.popcount(a))


# segment widths: mixed, and few distinct shapes, so the interpret-mode
# reference compiles each once
SEG_WIDTHS = [0, 1, 131, W, W + 1]
PALLAS_COUNT2 = {
    "and": pk.count_and,
    "or": pk.count_or,
    "xor": pk.count_xor,
    "andnot": pk.count_andnot,
}


def pallas_count(op, a, b):
    """The Pallas count of one segment; the kernels take no empty array,
    and an empty segment counts 0."""
    if a.size == 0:
        return 0
    return int(pk.popcount(a)) if op == "none" else int(PALLAS_COUNT2[op](a, b))


@pytest.mark.parametrize("n_seg", [0, 1, 3, 37])
@pytest.mark.parametrize("op", ["none", "and", "or", "xor", "andnot"])
def test_count2_segments_matches_pallas(n_seg, op):
    """One count2_segments call over segments of mixed widths, every other
    one a [1:] view (4 bytes past its buffer, not 16-byte aligned), equals
    the Pallas popcount / count_<op> called per segment."""
    rng = np.random.default_rng(20 + n_seg)
    ws = rng.choice(SEG_WIDTHS, n_seg)
    bufs = [(words(rng, w + 1), words(rng, w + 1)) for w in ws]
    a_np = [a[1:] if i % 2 else a[:-1] for i, (a, _) in enumerate(bufs)]
    b_np = [b[1:] if i % 2 else b[:-1] for i, (_, b) in enumerate(bufs)]
    a_t = [t(a)[1:] if i % 2 else t(a)[:-1] for i, (a, _) in enumerate(bufs)]
    b_t = [t(b)[1:] if i % 2 else t(b)[:-1] for i, (_, b) in enumerate(bufs)]
    got = K.count2_segments(a_t, None if op == "none" else b_t, op)
    assert got.dtype == torch.int64 and got.shape == (n_seg,)
    assert got.tolist() == [pallas_count(op, a, b) for a, b in zip(a_np, b_np)]


def test_count2_wraps_mod_2_32(monkeypatch):
    """count2 and popcount are count2_segments' one-segment case, reduced
    mod 2^32 as the Pallas kernels' int32 accumulators are; the segment
    count itself stays exact. (A real 2^32-bit operand is 512 MiB; the
    chip check and the cuda test below count one.)"""
    exact = torch.tensor([2**32 + 123], dtype=torch.int64)
    monkeypatch.setattr(K, "count2_segments_plain", lambda a_list, b_list, op: exact.clone())
    a = torch.zeros(4, dtype=torch.int32)
    assert K.count2_segments([a], None, "none").tolist() == [2**32 + 123]
    assert int(K.popcount(a)) == 123
    assert int(K.count2(a, a, "xor")) == 123
    assert int(K.count2_plain(a, a, "and")) == 123


@pytest.mark.parametrize("rows", [1, 8, 13])
def test_rows_counts_matches_pallas(rows):
    rng = np.random.default_rng(12)
    stack, filt = words(rng, rows, W), words(rng, W)
    np.testing.assert_array_equal(
        K.rows_counts(t(stack)).numpy(), np.asarray(pk.popcount_rows(stack)).astype(np.int32)
    )
    np.testing.assert_array_equal(
        K.rows_counts(t(stack), t(filt)).numpy(),
        np.asarray(pk.count_and_rows(stack, filt)).astype(np.int32),
    )


def test_rows_counts_per_shard_filter():
    """A filter of S rows: row r meets filter row r % S (the TopN dense
    tally's [R, S, W] x [S, W] shape, held to the reference
    groupby._counts_cross)."""
    from pilosa_tpu.exec import groupby as jgb

    rng = np.random.default_rng(13)
    r, s = 3, 5
    planes, src = words(rng, r, s, W), words(rng, s, W)
    got = K.rows_counts(t(planes.reshape(r * s, W)), t(src)).numpy().reshape(r, s)
    want = np.asarray(jgb._counts_cross(jnp.asarray(src)[None], jnp.asarray(planes)))[0]
    np.testing.assert_array_equal(got, want.astype(np.int32))


OPS = ["and", "or", "xor", "andnot"]


def random_tree(rng, depth, n_leaves):
    """A nested tuple spec: ("leaf", i) | ("zero",) | (op, children)."""
    if depth == 0 or rng.random() < 0.2:
        if rng.random() < 0.15:
            return ("zero",)
        return ("leaf", int(rng.integers(n_leaves)))
    op = OPS[int(rng.integers(4))]
    return (op, tuple(random_tree(rng, depth - 1, n_leaves) for _ in range(int(rng.integers(2, 4)))))


def build(spec, mod):
    if spec[0] == "leaf":
        return mod.PLeaf(spec[1])
    if spec[0] == "zero":
        return mod.PZero()
    return mod.PNary(spec[0], tuple(build(c, mod) for c in spec[1]))


@pytest.mark.parametrize("seed", range(6))
def test_plan_count_matches_eval_jit(seed):
    rng = np.random.default_rng(100 + seed)
    s, n_leaves = 5, 4
    ops = [words(rng, s, W) for _ in range(n_leaves)]
    tops = [t(o) for o in ops]
    jops = tuple(jnp.asarray(o) for o in ops)
    for _ in range(4):
        spec = random_tree(rng, 3, n_leaves)
        leaves, _, prog = tplan._compile(build(spec, tplan), tops, {})
        want = np.asarray(jplan._eval_jit(build(spec, jplan), "count", jops, ()))
        if not leaves:
            assert not want.any()
            continue
        np.testing.assert_array_equal(K.plan_count(leaves, prog, s).numpy(), want.astype(np.int64))
        # a prefix of the shard axis (Shift predecessors excluded)
        np.testing.assert_array_equal(
            K.plan_count(leaves, prog, s - 2).numpy(), want[: s - 2].astype(np.int64)
        )


def test_check_program_limits():
    K.check_program(2, [0, 1, K.BINOPS["and"]])
    for n_leaves, prog in [
        (1, [0, 0]),  # two values left
        (1, [K.BINOPS["or"]]),  # operator without operands
        (1, [1]),  # leaf out of range
        (1, []),
        (1, [0] * (K.MAX_STACK + 1) + [K.BINOPS["or"]] * K.MAX_STACK),
    ]:
        with pytest.raises(ValueError):
            K.check_program(n_leaves, prog)


def max_depth(prog):
    depth = top = 0
    for ins in prog:
        depth += 1 if ins >= K.PUSH_ZERO else -1
        top = max(top, depth)
    return top


def nested(depth, n_leaves, rng):
    """A spec nesting `depth` levels: each level is an n-ary node over a
    leaf and the next level, in a random operator and child position."""
    spec = ("leaf", 0)
    for d in range(depth):
        kids = [spec, ("leaf", int(rng.integers(n_leaves)))]
        if rng.random() < 0.5:
            kids.reverse()
        spec = (OPS[d % 4], tuple(kids))
    return spec


@pytest.mark.parametrize(
    "shape",
    ["union40", "xor40", "andnot40", "andnot_head_last", "nested40", "balanced64"],
)
def test_plan_count_wide_and_deep_matches_eval_jit(shape):
    """Trees wider than 32 leaves and nested 40 deep compile to one
    program (no leaf or length limit, a stack of log2 depth) whose count
    equals the reference's."""
    rng = np.random.default_rng(400)
    s, n_leaves = 3, 64
    ops = [words(rng, s, W) for _ in range(n_leaves)]
    leaf = lambda i: ("leaf", i)  # noqa: E731
    spec = {
        "union40": ("or", tuple(leaf(i) for i in range(40))),
        "xor40": ("xor", tuple(leaf(i) for i in range(40))),
        "andnot40": ("andnot", tuple(leaf(i) for i in range(40))),
        # the head is the shallowest child: it comes last, against the
        # union of the subtracted subtrees
        "andnot_head_last": (
            "andnot",
            (leaf(0), ("or", (leaf(1), ("and", (leaf(2), leaf(3))))), ("xor", (leaf(4), leaf(5)))),
        ),
        "nested40": nested(40, n_leaves, rng),
        "balanced64": (
            "or",
            tuple(("and", (("xor", (leaf(4 * i), leaf(4 * i + 1))), ("andnot", (leaf(4 * i + 2), leaf(4 * i + 3))))) for i in range(16)),
        ),
    }[shape]
    leaves, _, prog = tplan._compile(build(spec, tplan), [t(o) for o in ops], {})
    assert max_depth(prog) <= 7
    if shape == "andnot_head_last":
        assert K.BINOPS["rev_andnot"] in prog
    want = np.asarray(jplan._eval_jit(build(spec, jplan), "count", tuple(jnp.asarray(o) for o in ops), ()))
    np.testing.assert_array_equal(K.plan_count(leaves, prog, s).numpy(), want.astype(np.int64))


def run_micro(codes, pushes, slots, leaves):
    """The plan_count kernel's evaluation of a micro program, in numpy:
    the top in a variable, at most `slots` entries below it, leaf values
    taken in push order."""
    fns = [np.bitwise_and, np.bitwise_or, np.bitwise_xor, lambda a, b: a & ~b, lambda a, b: b & ~a]
    staged = iter(pushes)
    zero = np.zeros_like(leaves[0])
    top, stack = None, []
    for pc, c in enumerate(codes):
        kind, op = c >> 3, c & 7
        if kind == K.MICRO_KINDS["stack_op"]:
            top = fns[op](stack.pop(), top)
            continue
        v = leaves[next(staged)] if kind in (K.MICRO_KINDS["push"], K.MICRO_KINDS["leaf_op"]) else zero
        if kind in (K.MICRO_KINDS["leaf_op"], K.MICRO_KINDS["zero_op"]):
            top = fns[op](top, v)
        else:
            if pc > 0:
                stack.append(top)
                assert len(stack) <= slots
            top = v
    assert next(staged, None) is None and not stack
    return top


@pytest.mark.parametrize("seed", range(4))
def test_plan_micro_program_matches_postfix(seed):
    """The micro program plan_count runs (pushes folded into the operators
    that follow them) gives the postfix program's words on random,
    wide, nested and hand-built programs, within its stack slots."""
    rng = np.random.default_rng(500 + seed)
    n_leaves = 48
    ops = [words(rng, 2, 64) for _ in range(n_leaves)]
    specs = [random_tree(rng, 4, 6) for _ in range(12)]
    specs += [("or", tuple(("leaf", i) for i in range(48))), nested(40, n_leaves, rng), ("andnot", (("leaf", 0), ("zero",)))]
    programs = [tplan._compile(build(spec, tplan), [t(o) for o in ops], {})[::2] for spec in specs]
    b = K.BINOPS
    programs += [
        (ops[:1], [K.PUSH_ZERO]),
        (ops[:1], [0]),
        (ops[: K.MAX_STACK], list(range(K.MAX_STACK)) + [b["or"]] * (K.MAX_STACK - 1)),
    ]
    for leaves, prog in programs:
        if not leaves:
            continue
        leaves = [np.asarray(x) for x in leaves]
        codes, pushes, slots = K.plan_micro_program(prog)
        assert sum(c >> 3 in (K.MICRO_KINDS["push"], K.MICRO_KINDS["leaf_op"]) for c in codes) == len(pushes)
        assert 0 <= slots < K.MAX_STACK
        want = K.plan_count_plain([torch.from_numpy(x.view(np.int32)) for x in leaves], prog, 2)
        got = run_micro(codes, pushes, slots, [x.view(np.uint32) for x in leaves])
        assert [int(np.unpackbits(r.view(np.uint8)).sum()) for r in got] == want.tolist()


def gather_case(case):
    """(src, idx, mask, starts, ends) numpy inputs of gather_tally: a seed
    (random lengths, every fourth segment empty) or a named layout."""
    if isinstance(case, int):
        rng = np.random.default_rng(200 + case)
        src = words(rng, 4, W)
        lens = rng.integers(0, 40, 24)
        lens[::4] = 0  # empty segments
        idx = rng.integers(0, src.size, int(lens.sum())).astype(np.int32)
    elif case == "shard_major":
        # the executor's layout: per shard j, 8 row segments (j * 8 + k) of
        # sorted distinct words, drawn from one small pool so rows share words
        rng = np.random.default_rng(210)
        src = words(rng, 4, W)
        idx_parts, lens = [], []
        for j in range(4):
            pool = rng.choice(W, 64, replace=False)
            for _ in range(8):
                ws = np.sort(rng.choice(pool, int(rng.integers(0, 48)), replace=False))
                idx_parts.append(j * W + ws)
                lens.append(len(ws))
        idx = np.concatenate(idx_parts).astype(np.int32)
        lens = np.array(lens)
    elif case == "zipf":
        # power-law lengths, one segment of 10^5 entries among short ones
        rng = np.random.default_rng(211)
        src = words(rng, 4, W)
        lens = np.minimum(rng.zipf(1.4, 300), 4000)
        lens[17] = 100_000
        idx = rng.integers(0, src.size, int(lens.sum())).astype(np.int32)
    elif case == "all_empty":
        # entries that no segment covers
        rng = np.random.default_rng(212)
        src = words(rng, 4, W)
        lens = np.zeros(40, np.int64)
        idx = rng.integers(0, src.size, 300).astype(np.int32)
    else:  # "last_word": entries on src's last word, in the last segment
        rng = np.random.default_rng(213)
        src = words(rng, 4, W)
        lens = np.array([3, 0, 5, 260, 9])
        idx = rng.integers(0, src.size, int(lens.sum())).astype(np.int32)
        idx[-9:] = src.size - 1
        idx[0] = src.size - 1
    mask = words(rng, len(idx))
    ends = np.cumsum(lens).astype(np.int32)
    starts = (ends - lens).astype(np.int32)
    return src, idx, mask, starts, ends


GATHER_CASES = [0, 1, 2, "shard_major", "zipf", "all_empty", "last_word"]


@pytest.mark.parametrize("seed", GATHER_CASES)
def test_gather_tally_matches_gather_tally_sorted(seed):
    src, idx, mask, starts, ends = gather_case(seed)
    got = K.gather_tally(t(src), t(idx), t(mask), t(starts), t(ends)).numpy()
    want = np.asarray(jb.gather_tally_sorted(src, idx, mask, starts, ends))
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_wrappers_reject_bad_inputs():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        K.popcount(a.to(torch.int64))
    with pytest.raises(ValueError):
        K.count2(a, torch.zeros(4, dtype=torch.int32), "and")
    with pytest.raises(ValueError):
        K.count2(a, None, "and")
    with pytest.raises(ValueError):
        K.rows_counts(torch.zeros((2, 8), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError):
        K.rows_counts(torch.zeros((2, 8), dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
    seg = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        K.count2_segments([seg, torch.zeros(8, dtype=torch.int32, device="meta")], None, "none")
    with pytest.raises(ValueError, match="different devices"):
        K.count2_segments([seg], [torch.zeros(8, dtype=torch.int32, device="meta")], "and")
    with pytest.raises(TypeError):
        K.count2_segments([seg, seg.to(torch.int64)], None, "none")
    with pytest.raises(ValueError, match="shapes differ"):
        K.count2_segments([seg, seg], [seg, seg[:4]], "and")
    with pytest.raises(ValueError):
        K.count2_segments([seg, seg], [seg], "and")
    with pytest.raises(ValueError):
        K.count2_segments([seg], [seg], "none")
    with pytest.raises(ValueError):
        K.count2_segments([seg], None, "and")
    with pytest.raises(ValueError):
        K.count2_segments([seg], None, "nand")
    with pytest.raises(ValueError, match="contiguous"):
        K.count2_segments([seg, torch.zeros((2, 8), dtype=torch.int32)[:, ::2]], None, "none")


# ---------------------------------------------------------------------------
# kernels on the card against their twins
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        K._nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_twins(cuda_device):
    rng = np.random.default_rng(300)
    dev = cuda_device
    for shape in [(1,), (1001,), (3, 32768)]:
        a, b = words(rng, *shape), words(rng, *shape)
        for op in ["and", "or", "xor", "andnot"]:
            assert int(K.count2(t(a).to(dev), t(b).to(dev), op)) == int(K.count2(t(a), t(b), op))
        assert int(K.popcount(t(a).to(dev))) == int(K.popcount(t(a)))
    stack, filt = words(rng, 13, 32768), words(rng, 13, 32768)
    for f in (None, t(filt[0]), t(filt)):
        got = K.rows_counts(t(stack).to(dev), None if f is None else f.to(dev)).cpu()
        assert torch.equal(got, K.rows_counts(t(stack), f))
    # count2 over segment lists: widths across the 4096-word tile edge,
    # starts 0-3 words past a 16-byte boundary, one launch per call
    ws = [0, 1, 5, 4095, 4096, 4097, 32768, 3]
    bufs = [t(words(rng, w + 3)).to(dev) for w in ws] + [t(words(rng, w + 3)).to(dev) for w in ws]
    segs = [buf[k % 4 : k % 4 + w] for k, (buf, w) in enumerate(zip(bufs, ws + ws))]
    for op in ["none", "and", "or", "xor", "andnot"]:
        a_l, b_l = segs[: len(ws)], None if op == "none" else segs[len(ws) :]
        before = K.LAUNCHES["count2"]
        got = K.count2_segments(a_l, b_l, op).cpu()
        assert K.LAUNCHES["count2"] == before + 1
        want = K.count2_segments([x.cpu() for x in a_l], None if b_l is None else [x.cpu() for x in b_l], op)
        assert torch.equal(got, want)
    # 2^32 bits: count2/popcount wrap to 0, a segment count is exact
    ones = torch.full((1 << 27,), -1, dtype=torch.int32, device=dev)
    assert int(K.popcount(ones)) == 0 and int(K.count2(ones, ones, "and")) == 0
    assert K.count2_segments([ones, ones[:5]], None, "none").tolist() == [1 << 32, 160]
    del ones
    ops = [t(words(rng, 5, 32768)) for _ in range(48)]
    specs = [random_tree(np.random.default_rng(seed), 3, 3) for seed in range(8)]
    specs += [("or", tuple(("leaf", i) for i in range(48))), nested(40, 48, rng)]
    for spec in specs:
        leaves, _, prog = tplan._compile(build(spec, tplan), ops, {})
        if leaves:
            got = K.plan_count([x.to(dev) for x in leaves], prog, 5).cpu()
            assert torch.equal(got, K.plan_count(leaves, prog, 5))
    # plan_count at the edges of its tiles (256 uint4 of a row): W not a
    # multiple of the tile, S = 1, one leaf, a program of PUSH_ZERO alone
    for s, w in [(5, 1000), (1, 32768), (3, 32772), (2, 4)]:
        lv = [t(words(rng, s, w)) for _ in range(2)]
        for prog in ([0], [K.PUSH_ZERO], [0, 1, K.BINOPS["rev_andnot"]]):
            got = K.plan_count([x.to(dev) for x in lv], prog, s).cpu()
            assert torch.equal(got, K.plan_count(lv, prog, s))
    # gather_tally on every CPU case (one launch each), and once on [1:]
    # views of idx and mask (not 16-byte aligned)
    for case in GATHER_CASES:
        args = [t(x) for x in gather_case(case)]
        before = K.LAUNCHES["gather_tally"]
        got = K.gather_tally(*[x.to(dev) for x in args]).cpu()
        assert K.LAUNCHES["gather_tally"] == before + 1
        assert torch.equal(got, K.gather_tally(*args))
    src, idx, mask, starts, ends = [t(x) for x in gather_case(0)]
    idx, mask, starts, ends = idx[1:], mask[1:], starts.clamp(max=len(idx) - 1), ends.clamp(max=len(idx) - 1)
    got = K.gather_tally(*[x.to(dev) for x in (src, idx, mask, starts, ends)]).cpu()
    assert torch.equal(got, K.gather_tally(src, idx.contiguous(), mask.contiguous(), starts, ends))
