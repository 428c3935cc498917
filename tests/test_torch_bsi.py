"""The port's int (BSI) fields against pilosa_tpu's: exact equality
(tolerance 0) on inputs made with numpy from a seed.

- The three BSI kernel functions' twins (pilosa_tpu_torch/ops/kernels.py,
  which run on CPU tensors here) against the JAX functions they replace:
  bsi_sum against the Pallas `sum_counts` (interpret mode off-TPU) and
  `ops.bsi.sum_counts_stacked`; bsi_min_max + decode against
  `min_max_stream` + `decode_min_max`; bsi_range in both modes against
  `range_*_unsigned` and `range_stream_single`.
- An executor differential at 4 shards: the same int-field ingest through
  both packages (import_values, PQL Set/Clear of values, bit-depth growth,
  a field absent from some shards), then every query of chip_smoke.py's
  BSI phase, the empty-field and empty-filter cases, NEQ and between
  straddles, and the error cases.

The test marked `cuda` holds the CUDA kernels to their twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pilosa_tpu.ops.bsi as jbsi
import pilosa_tpu.ops.pallas_kernels as pk
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.executor import ExecError as JExecError
from pilosa_tpu_torch import ExecError as TExecError
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

DEPTHS = [1, 7, 8, 20, 31, 32]
S, W = 3, 512


def words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def operands(seed: int, depth: int, s: int = S, w: int = W):
    """planes [D, S, W] and exists/sign/filter [S, W], uint32."""
    rng = np.random.default_rng(seed)
    return words(rng, depth, s, w), words(rng, s, w), words(rng, s, w), words(rng, s, w)


def values_of(planes, exists, sign, mask):
    """Every considered column's signed magnitude (the numpy oracle)."""
    bits = lambda x: np.unpackbits(x.view(np.uint8), bitorder="little").astype(bool)  # noqa: E731
    m = bits(mask & exists)
    mag = np.zeros(m.size, np.int64)
    for d in range(planes.shape[0]):
        mag |= bits(planes[d]).astype(np.int64) << d
    neg = bits(sign) if sign is not None else np.zeros(m.size, bool)
    return np.where(neg, -mag, mag)[m]


# ---------------------------------------------------------------------------
# bsi_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("filtered", [True, False], ids=["filter", "nofilter"])
def test_bsi_sum_matches_sum_counts(depth, signed, filtered):
    planes, exists, sign, filt = operands(100 + depth, depth)
    sign_j = sign if signed else np.zeros_like(sign)
    filt_j = filt if filtered else np.full_like(filt, 0xFFFFFFFF)
    got = K.bsi_sum(t(planes), t(exists), t(sign) if signed else None, t(filt) if filtered else None)
    assert got.dtype == torch.int64 and got.shape == (1 + 2 * depth,)
    # the Pallas kernel over the flattened words (one [D, S * W] tally)
    c, pos, neg = pk.sum_counts(
        planes.reshape(depth, -1), exists.reshape(-1), sign_j.reshape(-1), filt_j.reshape(-1), depth
    )
    want = [int(c)] + [int(x) for x in np.asarray(pos)] + [int(x) for x in np.asarray(neg)]
    assert got.tolist() == want
    # and the per-shard XLA tally
    stacked = np.asarray(jbsi.sum_counts_stacked(planes, exists, sign_j, filt_j, depth))
    np.testing.assert_array_equal(
        tbsi.sum_counts_stacked(t(planes), t(exists), t(sign) if signed else None, t(filt) if filtered else None).numpy(),
        stacked.astype(np.int64),
    )
    count, total = tbsi.combine_sum(got)
    vals = values_of(planes, exists, sign if signed else None, filt_j)
    assert (count, total) == (len(vals), int(vals.sum()))


# ---------------------------------------------------------------------------
# bsi_min_max
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_bsi_min_max_matches_min_max_stream(depth, signed, is_min):
    planes, exists, sign, filt = operands(200 + depth, depth)
    # sparse masks, so the extreme is attained by a handful of columns
    rng = np.random.default_rng(depth)
    for _ in range(3):
        exists &= words(rng, S, W)
    for filtered in (True, False):
        got = K.bsi_min_max(
            t(planes), t(exists), t(sign) if signed else None, t(filt) if filtered else None, is_min
        )
        dec = tbsi.decode_min_max(got.tolist(), depth, is_min, signed)
        vals = values_of(planes, exists, sign if signed else None, filt if filtered else exists)
        best = int(vals.min() if is_min else vals.max())
        assert dec == (best, int((vals == best).sum()), True)
        if depth + signed <= 32:  # the reference's uint32 key
            host = np.asarray(
                jbsi.min_max_stream(
                    (planes,), (exists,), (sign,) if signed else None,
                    (filt,) if filtered else None, is_min, signed,
                )
            )
            assert dec == jbsi.decode_min_max(host, depth, is_min, signed)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_bsi_min_max_empty_mask(signed):
    planes, exists, sign, filt = operands(7, 8)
    zero = np.zeros_like(exists)
    for is_min in (True, False):
        got = K.bsi_min_max(t(planes), t(zero), t(sign) if signed else None, None, is_min)
        assert got.tolist() == [0, 0, 0]
        assert tbsi.decode_min_max(got.tolist(), 8, is_min, signed) == (0, 0, False)
        got = K.bsi_min_max(t(planes), t(exists), t(sign) if signed else None, t(zero), is_min)
        assert tbsi.decode_min_max(got.tolist(), 8, is_min, signed) == (0, 0, False)


# ---------------------------------------------------------------------------
# bsi_range
# ---------------------------------------------------------------------------


def edge_preds(depth, rng):
    top = (1 << depth) - 1
    picks = [0, 1, top, top - 1, int(rng.integers(0, top + 1))]
    return sorted({p for p in picks if 0 <= p <= top})


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["eq", "lt", "gt", "between"])
def test_bsi_range_matches_range_unsigned(depth, kind):
    planes, exists, sign, _ = operands(300 + depth, depth)
    rng = np.random.default_rng(depth)
    jfn = {
        "eq": lambda m, p, ae, p1: jbsi.range_eq_unsigned(m, planes, jnp.uint32(p), depth),
        "lt": lambda m, p, ae, p1: jbsi.range_lt_unsigned(m, planes, jnp.uint32(p), depth, ae),
        "gt": lambda m, p, ae, p1: jbsi.range_gt_unsigned(m, planes, jnp.uint32(p), depth, ae),
        "between": lambda m, p, ae, p1: jbsi.range_between_unsigned(
            m, planes, jnp.uint32(p), jnp.uint32(p1), depth
        ),
    }[kind]
    masks = {"consider": exists, "pos": exists & ~sign, "neg": exists & sign}
    preds = edge_preds(depth, rng)
    for sel, mask in masks.items():
        for allow_eq in ((False,) if kind in ("eq", "between") else (False, True)):
            for p0 in preds:
                p1 = max(p0, preds[-1]) if kind == "between" else 0
                want = np.asarray(jfn(mask, p0, allow_eq, p1))
                args = (t(planes), t(exists), t(sign), sel, kind, allow_eq, p0, p1)
                rows = K.bsi_range(*args, "rows")
                np.testing.assert_array_equal(rows.numpy().view(np.uint32), want)
                counts = K.bsi_range(*args, "count")
                np.testing.assert_array_equal(
                    counts.numpy(), np.bitwise_count(want).sum(axis=-1, dtype=np.int64)
                )
    # an unsigned field: no sign row, sel "consider" only
    p0 = preds[len(preds) // 2]
    want = np.asarray(jfn(exists, p0, True, preds[-1]))
    got = K.bsi_range(t(planes), t(exists), None, "consider", kind, True, p0, preds[-1], "rows")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_strict_lt_zero_is_empty():
    """pilosa_tpu's deliberate correction of strict `< 0` holds in the
    twin too."""
    planes, exists, _, _ = operands(9, 5)
    got = K.bsi_range(t(planes), t(exists), None, "consider", "lt", False, 0, 0, "count")
    assert got.tolist() == [0] * S


@pytest.mark.parametrize("depth", [7, 20, 32])
def test_bsi_range_counts_match_range_stream_single(depth):
    """A decomposition's job set: per-job count-mode ladders plus the
    plain mask terms against the reference's one-dispatch term pairs."""
    planes, exists, sign, _ = operands(400 + depth, depth)
    rng = np.random.default_rng(depth)
    top = (1 << depth) - 1
    jobs = (
        ("lt", "pos", True), ("lt", "neg", True), ("gt", "pos", False),
        ("eq", "neg", False), ("between", "pos", False), ("lt", "consider", False),
    )
    preds = [int(x) for x in rng.integers(0, top + 1, 7)]
    preds[-3:-1] = sorted(preds[-3:-1])
    extras = ("consider", "pos", "neg")
    host = np.asarray(
        jbsi.range_stream_single(
            (planes,), (exists,), (sign,), None, tuple(jnp.uint32(p) for p in preds), jobs, extras
        )
    )
    want = [jbsi.pair_value(host, 2 * i) for i in range(len(jobs) + len(extras))]
    got, off = [], 0
    for kind, sel, allow_eq in jobs:
        n = 2 if kind == "between" else 1
        p = preds[off : off + n] + [0]
        off += n
        got.append(int(K.bsi_range(t(planes), t(exists), t(sign), sel, kind, allow_eq, p[0], p[1], "count").sum()))
    for sel in extras:
        got.append(int(K.popcount(tbsi.job_mask(t(exists), t(sign), None, sel))))
    assert got == want


def test_bsi_wrappers_reject_bad_inputs():
    planes = torch.zeros((3, 2, 8), dtype=torch.int32)
    row = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.bsi_sum(planes, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.bsi_sum(torch.zeros((33, 2, 8), dtype=torch.int32), row)
    with pytest.raises(TypeError):
        K.bsi_min_max(planes, row.to(torch.int64), None, None, True)
    with pytest.raises(ValueError):
        K.bsi_range(planes, row, None, "pos", "lt", False, 3)
    with pytest.raises(ValueError):
        K.bsi_range(planes, row, row, "pos", "lt", False, 1 << 32)
    with pytest.raises(ValueError):
        K.bsi_range(planes, row, row, "pos", "ne", False, 3)


# ---------------------------------------------------------------------------
# executor differential
# ---------------------------------------------------------------------------

N_SHARDS = 4


def ingest(holder, FO, seed: int):
    """The same int-field ingest for either package. Returns the PQL
    write results."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i", track_existence=True)
    f = idx.create_field("f")
    g = idx.create_field("g")
    amount = idx.create_field("amount", FO(type="int", min=-1_000_000, max=1_000_000))
    age = idx.create_field("age", FO(type="int", min=0, max=120))
    grow = idx.create_field("grow", FO(type="int", min=-5000, max=5000, bit_depth=3))
    idx.create_field("empty", FO(type="int", min=-10, max=10))
    all_cols = []
    for s in range(N_SHARDS):
        cols = rng.choice(SHARD_WIDTH, 3000, replace=False).astype(np.uint64) + np.uint64(s * SHARD_WIDTH)
        all_cols.append(cols)
        if s != 2:  # amount is absent from shard 2
            vals = rng.integers(-1_000_000, 1_000_001, len(cols))
            vals[:40] = 12345
            vals[40:60] = 0
            vals[60:70] = -1_000_000
            amount.import_values(cols, vals)
        age.import_values(cols[:2000], rng.integers(0, 121, 2000))
        if s < 2:  # 3-bit values, then depth growth from shard 2 on
            grow.import_values(cols[:500], rng.integers(-7, 8, 500))
        f.import_bits(np.full(1000, 1, np.uint64), cols[::3])
        g.import_bits(np.zeros(1500, np.uint64), cols[1::2])
    idx.track_columns(np.concatenate(all_cols))
    c0, c1 = (int(x) for x in all_cols[0][:2])
    c3 = int(all_cols[3][5])
    writes = [
        f"Set({c0}, amount=-700000)",  # below -2^19: the sign and top plane change
        f"Set({c0}, amount=-700000)",
        f"Clear({c1}, amount=0)",
        f"Clear({c1}, amount=0)",
        f"Set({2 * SHARD_WIDTH + 7}, amount=999999)",  # amount's first bit in shard 2
        f"Set({3 * SHARD_WIDTH + 9}, grow=4000)",  # depth 3 -> 12
        f"Set({c3}, grow=-3)",
        f"Set({c3}, age=42)",
        f"Clear({c3}, grow=0)",
    ]
    ex = (JExecutor if FO is JFieldOptions else TExecutor)(holder)
    return [r for w in writes for r in ex.execute("i", w)], all_cols


def norm(result):
    if isinstance(result, (JRow, TRow)):
        return ("row", [int(c) for c in result.columns()])
    if hasattr(result, "value") and hasattr(result, "count"):
        return ("valcount", result.value, result.count)
    return result


QUERIES = [
    "Sum(field=amount)",
    "Sum(Row(f=1), field=amount)",
    "Sum(field=amount, filter=Row(age > 65))",
    "Min(field=amount)",
    "Max(field=amount)",
    "Max(Row(g=0), field=age)",
    "Count(Row(amount > 500000))",
    "Count(Row(amount <= -250000))",
    "Count(Row(amount == 12345))",
    "Count(Row(amount != 0))",
    "Count(Row(-1000 <= amount <= 1000))",
    "Count(Row(amount != null))",
    "Count(Intersect(Row(age >= 18), Row(f=1)))",
    "Count(Union(Row(age < 13), Row(age > 65)))",
    "Row(age == 42)",
    # empty field, empty filter, no match
    "Sum(field=empty)",
    "Min(field=empty)",
    "Max(field=empty, filter=Row(f=1))",
    "Sum(Row(f=99), field=amount)",
    "Min(field=amount, filter=Row(f=99))",
    "Count(Row(empty > 3))",
    "Row(empty != null)",
    # straddles and edges
    "Count(Row(-5 <= amount <= 700000))",
    "Count(Row(-300000 <= amount <= -100))",
    "Count(Row(amount != -12))",
    "Count(Row(amount != 12345))",
    "Count(Row(amount < 0))",
    "Count(Row(amount > 0))",
    "Count(Row(amount >= 0))",
    "Count(Row(amount <= 0))",
    "Count(Row(amount < -1000000))",
    "Count(Row(amount > 1000000))",
    "Count(Row(amount >= -1000000))",
    "Count(Row(amount == -1000000))",
    "Count(Row(amount != 5000000))",
    "Count(Row(-9000000 <= amount <= 9000000))",
    "Count(Row(3000000 <= amount <= 9000000))",
    "Count(Row(age < 0))",
    "Count(Row(age <= 0))",
    "Count(Row(age != -3))",
    "Count(Row(age > 500))",
    "Count(Not(Row(amount > 0)))",
    "Count(Difference(Row(age >= 0), Row(amount < 100)))",
    "Row(amount < -999000)",
    "Xor(Row(age > 100), Row(amount > 990000))",
    "Count(Row(age > 60)) Count(Row(amount < 3)) Count(Row(f=1))",
    # the grown field: shards 0 and 1 lack the planes above bit 2
    "Sum(field=grow)",
    "Min(field=grow)",
    "Max(field=grow)",
    "Count(Row(grow > 2))",
    "Count(Row(grow < -5))",
    "Row(grow == 4000)",
    "Min(Row(f=1), field=age)",
    "Sum(field=age, filter=Intersect(Row(f=1), Row(amount < 0)))",
]


@pytest.fixture(scope="module")
def both():
    ref, port = JHolder(None).open(), THolder(device="cpu")
    ref_writes, cols = ingest(ref, JFieldOptions, seed=21)
    port_writes, _ = ingest(port, TFieldOptions, seed=21)
    assert port_writes == ref_writes
    return JExecutor(ref), TExecutor(port), cols


@pytest.mark.parametrize("shards", [None, [1, 3], [2]], ids=["all", "1,3", "2"])
def test_bsi_queries_match_reference(both, shards):
    ref_ex, port_ex, _ = both
    for pql in QUERIES:
        want = [norm(r) for r in ref_ex.execute("i", pql, shards=shards)]
        got = [norm(r) for r in port_ex.execute("i", pql, shards=shards)]
        assert got == want, f"{pql} shards={shards}"


def test_bsi_field_options_and_values_match_reference(both):
    ref_ex, port_ex, cols = both
    for name in ("amount", "age", "grow", "empty"):
        jo = ref_ex.holder.index("i").field(name).options
        to = port_ex.holder.index("i").field(name).options
        assert (to.min, to.max, to.base, to.bit_depth) == (jo.min, jo.max, jo.base, jo.bit_depth)
    sample = np.concatenate([c[:80] for c in cols] + [np.array([3 * SHARD_WIDTH + 9, 17], np.uint64)])
    for name in ("amount", "age", "grow", "empty"):
        jf = ref_ex.holder.index("i").field(name)
        tf = port_ex.holder.index("i").field(name)
        assert [tf.value(int(c)) for c in sample] == [jf.value(int(c)) for c in sample], name


def test_grown_planes_read_as_zero(both):
    """After growth shards 0 and 1 never wrote planes 3.., which
    plane_stack stages as zero words."""
    _, port_ex, _ = both
    f = port_ex.holder.index("i").field("grow")
    assert f.options.bit_depth == 12
    v = f.view(f.bsi_view_name())
    planes = v.plane_stack(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + 12), (0, 1, 3))
    assert planes.shape == (12, 3, SHARD_WIDTH // 32)
    assert not planes[3:, :2].any()
    assert planes[3:, 2].any()


ERRORS = [
    "Sum(field=f)",
    "Min(field=nope)",
    "Count(Row(f > 5))",
    "Row(amount > 5, f=1)",
    "Count(Row(amount == 'x'))",
]


@pytest.mark.parametrize("pql", ERRORS)
def test_bsi_errors_match_reference(both, pql):
    ref_ex, port_ex, _ = both
    with pytest.raises(JExecError):
        ref_ex.execute("i", pql)
    with pytest.raises(TExecError):
        port_ex.execute("i", pql)


def test_bsi_value_errors_match_reference():
    for FO, H, E in ((JFieldOptions, JHolder, JExecutor), (TFieldOptions, THolder, TExecutor)):
        h = H(None).open() if H is JHolder else H(device="cpu")
        idx = h.create_index("i")
        idx.create_field("age", FO(type="int", min=0, max=120))
        with pytest.raises(ValueError):
            E(h).execute("i", "Set(1, age=121)")
        with pytest.raises(ValueError):
            idx.field("age").import_values(np.array([1], np.uint64), np.array([-1]))
        with pytest.raises(ValueError, match="32"):
            idx.create_field("wide", FO(type="int", min=-(2**33), max=0))


def test_unported_bsi_shapes_raise(both):
    """The reference sends these to its per-shard loop; the port raises.
    MinRow and MaxRow, ported since, give the reference's answers."""
    ref_ex, port_ex, _ = both
    for pql in [
        "Sum(field=amount, filter=Shift(Row(f=1), n=1))",
        "Min(Shift(Row(f=1), n=2), field=age)",
    ]:
        with pytest.raises(TExecError, match="not yet ported"):
            port_ex.execute("i", pql)
    for pql in ["MinRow(field=f)", "MaxRow(field=f)", "MinRow(field=amount)"]:
        assert port_ex.execute("i", pql) == ref_ex.execute("i", pql), pql
    h = THolder(device="cpu")
    idx = h.create_index("i")
    idx.create_field("deep", TFieldOptions(type="int", min=-(2**32) + 1, max=0))
    idx.field("deep").set_value(5, -(2**32) + 1)
    with pytest.raises(TExecError, match="not yet ported"):
        TExecutor(h).execute("i", "Max(field=deep)")
    assert TExecutor(h).execute("i", "Count(Row(deep < -4294967290))") == [1]


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
def test_cuda_bsi_kernels_match_twins(cuda_device):
    dev = cuda_device
    for depth in (1, 9, 32):
        for w in (32768, 1001):
            planes, exists, sign, filt = (t(x) for x in operands(500 + depth, depth, 5, w))
            on = lambda x: None if x is None else x.to(dev)  # noqa: E731
            for sg in (sign, None):
                for ft in (filt, None):
                    got = K.bsi_sum(on(planes), on(exists), on(sg), on(ft)).cpu()
                    assert torch.equal(got, K.bsi_sum(planes, exists, sg, ft))
                    for is_min in (True, False):
                        got = K.bsi_min_max(on(planes), on(exists), on(sg), on(ft), is_min).cpu()
                        assert torch.equal(got, K.bsi_min_max(planes, exists, sg, ft, is_min))
                for kind in ("eq", "lt", "gt", "between"):
                    for mode in ("rows", "count"):
                        args = (sg, "pos" if sg is not None else "consider", kind, True, 3, (1 << depth) - 1, mode)
                        got = K.bsi_range(on(planes), on(exists), on(args[0]), *args[1:]).cpu()
                        assert torch.equal(got, K.bsi_range(planes, exists, *args))
