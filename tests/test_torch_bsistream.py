"""Plane-slab streaming of BSI aggregates and condition Counts: the port
(pilosa_tpu_torch/exec/bsistream.py) against pilosa_tpu on the CPU.

The same data go into both packages over 16 shards (tests/
torch_bsi_cases.py: set fields f and g and the signed field `deep`, 32
bits deep) plus an unsigned field `u` (10 planes) and a signed field `s`
(12 planes). With both packages' `bsistream.configure(slab_planes=...)`
at each of 1, 3, 6, 16 and 64:

- Sum, Min and Max (plain, filtered, with a Shift in the filter, with a
  non-call `filter=`) and every decomposition shape of Count(Row(cond))
  (lt, lte, gt, gte, eq and neq on either sign, betweens on either side
  of 0 and straddling it, `!= null`, saturated and out-of-range
  predicates) give the reference's answers exactly;
- where both packages stream (the reference declines a Shift or non-call
  filter and Min/Max/Sum of a signed field 32 bits deep), each query's
  `slabs` and `slab_bytes` equal the reference's: no query holds more
  than min(depth, slab) planes at once;
- under a budget that halves the shard axis at slab 3, both take two
  chunks and count the same slabs; an import_values between queries
  patches the resident slab entries and the answers follow it.

Also: chained slab steps (the kernels' twins, through the ops/kernels.py
wrappers) over random splits equal the whole-stack twins, and the
`--bsi-slab-planes` / `[bsi] slab-planes` / PILOSA_TPU_BSI_SLAB_PLANES
knob reaches `bsistream.slab_planes()` through the port's server.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import numpy as np
import pytest
import torch

from pilosa_tpu.core.devcache import DEVICE_CACHE as JDEVCACHE
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.resultcache import RESULT_CACHE as JRC
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import bsistream as jbs
from pilosa_tpu.hbm import residency as jres
from pilosa_tpu.parallel import mesh as pmesh
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.cli.config import Config
from pilosa_tpu_torch.cli.main import main as tmain
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.exec import bsistream as tbs
from pilosa_tpu_torch.hbm import residency as tres
from pilosa_tpu_torch.ops import bsi as obsi
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.server import NodeServer
from pilosa_tpu_torch.server import node as tnode
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW
from torch_bsi_cases import N_SHARDS, TOP, ingest, values

SLABS = [1, 3, 6, 16, 64]
U = (0, 1000)  # unsigned: 10 planes, no sign row
SG = (-3000, 3000)  # signed: 12 planes

# aggregates both packages stream (every shard has bits of f rows 1 and 2)
AGGS = [
    "Sum(field=u)", "Min(field=u)", "Max(Row(f=1), field=u)",
    "Sum(Row(f=2), field=s)", "Min(field=s)", "Max(field=s)", "Min(Row(f=1), field=s)",
]
# aggregates only the port streams: Shift filters, non-call filters, and
# the signed field 32 bits deep
AGGS_PORT = [
    "Sum(Shift(Row(g=0), n=1), field=u)",
    "Max(field=u, filter=Shift(Union(Row(f=1), Row(g=0)), n=2))",
    "Min(Shift(Row(f=1), n=1), field=s)",
    "Sum(field=u, filter=5)",
    "Min(field=s, filter=3)",
    "Sum(field=deep) Min(field=deep) Max(Row(f=1), field=deep)",
]


# Count(Row(cond)) over every decomposition shape of the signed field s
# (the predicate on either side of 0, on 0 and at the range's ends), some
# of u's and deep's; then the shapes with no ladder job (!= null, a
# strict < 0, saturated, out of range), which stage no plane
COUNTS = [
    f"Count(Row({c}))"
    for c in (
        "s < -1000", "s < 77", "s <= -1", "s <= 500", "s > -7", "s > 1200", "s > 0", "s >= -900",
        "s >= 0", "s == -12", "s == 44", "s == 0", "s != 4", "s != -4", "-5 <= s <= 900", "10 <= s <= 2000",
        "-2000 <= s <= -3", "s == 3000", "s > -3000",
        "u < 500", "u >= 501", "u == 200", "u != 143", "50 <= u <= 900",
        f"deep < {-TOP + 1}", f"deep > {TOP - 1}", f"-5 <= deep <= {2**32 - 9}", "deep == 0",
    )
]
COUNTS_NO_JOB = [
    f"Count(Row({c}))"
    for c in ("s != null", "s < 0", "s < 1000000000", "s >= -1000000000", "u <= 1000", "s == 10000000000",
              "u > 10000000000", "-99999999999 <= s <= -9999999999")
]
# checked against the reference's own counters at every slab; the other
# queries' counters against what those show (every plane of the field
# in ceil(depth / slab) slabs, none for a count with no ladder job)
REP = ["Sum(field=s)", "Min(Row(f=1), field=u)", "Max(field=s)", "Count(Row(u != 143))"]
DEPTH = {"u": 10, "s": 12, "deep": 32}
ROW_BYTES = N_SHARDS * WORDS_PER_ROW * 4


def _import(holder, seed: int, n: int) -> None:
    """Values of u and s on n random columns over the 16 shards, the
    fields' extremes among them."""
    rng = np.random.default_rng(seed)
    cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, n).astype(np.uint64))
    idx = holder.index("i")
    for name, (lo, hi) in (("u", U), ("s", SG)):
        vals = rng.integers(lo, hi + 1, len(cols))
        vals[rng.choice(len(cols), 4, replace=False)] = [lo, hi, lo, hi]
        idx.field(name).import_values(cols, vals)


def _build(holder, fo):
    ingest(holder, fo, 7, "deep", -TOP, TOP)
    idx = holder.index("i")
    idx.create_field("u", fo(type="int", min=U[0], max=U[1]))
    idx.create_field("s", fo(type="int", min=SG[0], max=SG[1]))
    _import(holder, 70, 6000)
    return holder


class Pair:
    """The reference's and the port's executors over the same data; the
    reference answers each query once, at its default slab (its answers
    do not depend on the slab)."""

    def __init__(self, jex, tex):
        self.jex, self.tex = jex, tex
        self._want = {}

    def want(self, pql):
        if pql not in self._want:
            slab = jbs.slab_planes()
            jbs.configure(slab_planes=16)
            try:
                self._want[pql] = values(self.jex.execute("i", pql))
            finally:
                jbs.configure(slab_planes=slab)
        return self._want[pql]

    def port(self, pql):
        """The port's answer, which must be the reference's, and the
        slabs and slab bytes it counted."""
        before = tbs.stats_snapshot()
        assert values(self.tex.execute("i", pql)) == self.want(pql), pql
        after = tbs.stats_snapshot()
        return after["slabs"] - before["slabs"], after["slab_bytes"] - before["slab_bytes"]


@pytest.fixture(scope="module")
def pair():
    """Both packages over the same data on one device, the reference's
    result cache off so every query stages; its knobs, budget and mesh
    and the port's knob restored at the end."""
    old_mesh = pmesh.active_mesh()
    pmesh.set_active_mesh(None)
    saved = (JRC.budget_bytes, JDEVCACHE.budget_bytes, jbs.slab_planes(), tbs.slab_planes())
    JRC.configure(budget_bytes=0)
    ref = _build(JHolder(None).open(), JFieldOptions)
    port = _build(THolder(device="cpu"), TFieldOptions)
    yield Pair(JExecutor(ref), TExecutor(port))
    JRC.configure(budget_bytes=saved[0])
    JDEVCACHE.budget_bytes = saved[1]
    jbs.configure(slab_planes=saved[2])
    tbs.configure(slab_planes=saved[3])
    pmesh.set_active_mesh(old_mesh)


def _field_of(pql: str) -> str:
    return next(f for f in ("deep", "u", "s") if f"field={f}" in pql or f"({f} " in pql or f"<= {f} " in pql)


def _slabs_of(pql: str, slab: int):
    """(slabs, slab bytes) a streamed query over every shard counts."""
    depth = DEPTH[_field_of(pql)]
    return -(-depth // slab), depth * ROW_BYTES


def _set_slab(slab: int) -> None:
    jbs.configure(slab_planes=slab)
    tbs.configure(slab_planes=slab)


@pytest.mark.parametrize("slab", SLABS)
def test_slab_counters_match_reference(pair, slab):
    """The reference's own counters for a Sum, a filtered Min, a Max and
    a Count with a mask term, at this slab."""
    _set_slab(slab)
    for pql in REP:
        want = pair.want(pql)
        jb = jbs.stats_snapshot()
        assert values(pair.jex.execute("i", pql)) == want, pql
        ja = jbs.stats_snapshot()
        ref = ja["slabs"] - jb["slabs"], ja["slab_bytes"] - jb["slab_bytes"]
        assert pair.port(pql) == ref == _slabs_of(pql, slab), pql


@pytest.mark.parametrize("slab", SLABS)
def test_aggregates_match_reference(pair, slab):
    _set_slab(slab)
    for pql in AGGS:
        assert pair.port(pql) == _slabs_of(pql, slab), pql
    for pql in AGGS_PORT:
        pair.port(pql)


@pytest.mark.parametrize("slab", SLABS)
def test_condition_counts_match_reference(pair, slab, monkeypatch):
    """Every shape's answer equals the reference's; a count with ladder
    jobs stages each plane once in slabs of at most `slab` planes, one
    with none stages no plane."""
    _set_slab(slab)
    held = []
    real = K.bsi_range_step
    monkeypatch.setattr(K, "bsi_range_step", lambda planes, *a, **k: held.append(planes.shape[0]) or real(planes, *a, **k))
    for pql in COUNTS:
        assert pair.port(pql) == _slabs_of(pql, slab), pql
    for pql in COUNTS_NO_JOB:
        assert pair.port(pql) == (0, 0), pql
    assert held and max(held) <= slab


def test_budget_halves_the_shard_axis_at_slab_3(pair):
    """A quarter budget of 80 [1, W] rows: a 16-shard slab of 3 planes
    plus 3 rows (and the port's carried state) does not fit, an 8-shard
    one does, so both packages answer in two chunks and count the same
    slabs."""
    dcache = pair.tex.holder.dcache
    old = dcache.budget_bytes
    dcache.budget_bytes = JDEVCACHE.budget_bytes = 4 * 80 * WORDS_PER_ROW * 4
    _set_slab(3)
    try:
        for pql in ["Sum(field=s)", "Count(Row(-5 <= s <= 900))", "Min(field=s)", "Max(Row(f=1), field=u)", "Count(Row(u < 500))"]:
            n, nbytes = _slabs_of(pql, 3)
            want = pair.want(pql)
            if pql in ("Sum(field=s)", "Count(Row(-5 <= s <= 900))"):
                jb = jbs.stats_snapshot()
                assert values(pair.jex.execute("i", pql)) == want, pql
                ja = jbs.stats_snapshot()
                assert (ja["slabs"] - jb["slabs"], ja["slab_bytes"] - jb["slab_bytes"]) == (2 * n, nbytes), pql
            assert pair.port(pql) == (2 * n, nbytes), pql
    finally:
        dcache.budget_bytes = JDEVCACHE.budget_bytes = old


def test_import_values_between_queries(pair):
    """At slab 3 over extents of 4 shards: values imported into shards 2
    and 9 re-stage only the slab extents covering them, the bytes the
    reference re-stages, and the answers follow the import."""
    old = (jres.extent_rows(), tres.extent_rows())
    jres.configure(extent_rows=4)
    tres.configure(extent_rows=4)
    _set_slab(3)
    queries = ["Sum(field=s)", "Count(Row(u < 500))"]
    try:

        def restaged(run):
            jb, tb = jres.stats_snapshot()["restage_bytes"], tres.stats_snapshot(pair.tex.holder.dcache)["restage_bytes"]
            run()
            ja, ta = jres.stats_snapshot()["restage_bytes"], tres.stats_snapshot(pair.tex.holder.dcache)["restage_bytes"]
            return ja - jb, ta - tb

        def both():
            for pql in queries:
                assert values(pair.tex.execute("i", pql)) == values(pair.jex.execute("i", pql)), pql

        restaged(both)
        assert restaged(both) == (0, 0)
        cols = np.array([2 * SHARD_WIDTH + 5, 2 * SHARD_WIDTH + 77, 9 * SHARD_WIDTH + 1000], np.uint64)
        for ex in (pair.jex, pair.tex):
            idx = ex.holder.index("i")
            idx.field("s").import_values(cols, np.array([-2999, 17, 2500]))
            idx.field("u").import_values(cols, np.array([1000, 0, 333]))
        ref, port = restaged(both)
        assert ref == port and 0 < port < 4 * ROW_BYTES * (DEPTH["s"] + DEPTH["u"])
    finally:
        jres.configure(extent_rows=old[0])
        tres.configure(extent_rows=old[1])


# ---------------------------------------------------------------------------
# the slab steps' twins, chained over random splits
# ---------------------------------------------------------------------------


def _words(rng, *shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


def _splits(rng, depth: int):
    """(lo, d) slabs of planes [0, depth) at random cut points, MSB first."""
    cuts = sorted(set(rng.choice(np.arange(1, depth), min(depth - 1, int(rng.integers(0, 5))), replace=False).tolist())) if depth > 1 else []
    bounds = [0, *cuts, depth]
    return [(a, b - a) for a, b in zip(bounds[:-1], bounds[1:])][::-1]


@pytest.mark.parametrize("depth", [1, 2, 7, 13, 31, 32])
def test_min_max_step_chain_equals_whole_stack(depth):
    rng = np.random.default_rng(depth)
    planes = _words(rng, depth, 3, 40)
    exists = _words(rng, 3, 40) & _words(rng, 3, 40)
    sign, filt = _words(rng, 3, 40), _words(rng, 3, 40)
    empty = torch.zeros_like(exists)
    for sg in (sign, None):
        key_bits = depth + (sg is not None)
        for ft in (filt, None, empty):
            for is_min in (True, False):
                want = obsi.min_max_stream(planes, exists, sg, ft, is_min)
                for _ in range(3):
                    sp = _splits(rng, depth)
                    state = None
                    for n, (lo, d) in enumerate(sp):
                        state = K.bsi_min_max_step(planes[lo : lo + d], exists, sg, ft, state, is_min, n == 0,
                                                   n == len(sp) - 1, key_bits)
                    assert torch.equal(state, want), (sg is None, ft is None, is_min, sp)
                if ft is empty:
                    assert want.tolist() == [0, 0, 0]
                    continue
                val, _, _ = obsi.decode_min_max(want.tolist(), depth, is_min, sg is not None)
                assert torch.equal(K.bsi_min_max(planes, exists, sg, ft, is_min), want), val


# every job shape _decompose gives, with its predicates as functions of
# the top magnitude
JOB_SHAPES = [
    ((("lt", "pos", False),), lambda t: (t // 3,), ("neg",)),
    ((("lt", "pos", True),), lambda t: (t,), ("neg",)),
    ((("gt", "neg", False),), lambda t: (t // 2,), ()),
    ((("gt", "pos", True),), lambda t: (1,), ()),
    ((("gt", "pos", False),), lambda t: (0,), ("pos",)),
    ((("lt", "neg", True),), lambda t: (t // 5,), ("pos",)),
    ((("eq", "neg", False),), lambda t: (t // 7,), ("consider",)),
    ((("eq", "pos", False),), lambda t: (0,), ()),
    ((("between", "pos", False),), lambda t: (t // 9, t // 2), ()),
    ((("between", "neg", False),), lambda t: (1, t), ()),
    ((("lt", "pos", True), ("lt", "neg", True)), lambda t: (t // 2, t // 3), ()),
    ((("lt", "consider", False), ("gt", "consider", True)), lambda t: (t, t // 4), ("consider", "pos", "neg")),
]


@pytest.mark.parametrize("depth", [1, 3, 8, 20, 32])
def test_range_step_chain_equals_whole_stack(depth):
    rng = np.random.default_rng(100 + depth)
    planes = _words(rng, depth, 2, 36)
    exists, sign = _words(rng, 2, 36), _words(rng, 2, 36)
    top = (1 << depth) - 1
    for jobs, preds_of, extras in JOB_SHAPES:
        for preds in (preds_of(top), tuple(int(rng.integers(0, top + 1)) for _ in preds_of(top))):
            if jobs[0][0] == "between":
                preds = tuple(sorted(preds))
            want, off = [], 0
            for kind, sel, allow_eq in jobs:
                p = list(preds[off : off + obsi.range_npreds(kind)]) + [0]
                off += obsi.range_npreds(kind)
                want.append(int(obsi.range_single(planes, exists, sign, sel, kind, allow_eq, p[0], p[1], "count").sum()))
            want += [int(obsi.popcount_words(obsi.job_mask(exists, sign, None, sel)).sum()) for sel in extras]
            for _ in range(3):
                sp = _splits(rng, depth)
                state = None
                for n, (lo, d) in enumerate(sp):
                    state = K.bsi_range_step(planes[lo : lo + d], exists, sign, state, jobs, preds, lo, n == 0,
                                             n == len(sp) - 1, extras)
                assert state.tolist() == want, (jobs, preds, sp)


def test_step_wrappers_refuse_bad_state():
    rng = np.random.default_rng(5)
    planes, row = _words(rng, 4, 2, 8), _words(rng, 2, 8)
    with pytest.raises(ValueError, match="later slab"):
        K.bsi_min_max_step(planes, row, None, None, None, True, False, True, 8)
    with pytest.raises(ValueError, match="va must be"):
        K.bsi_min_max_step(planes, row, row, None, (row, row), True, False, True, 33)
    with pytest.raises(ValueError, match="bits above"):
        K.bsi_range_step(planes, row, None, None, [("lt", "consider", False)], [16], 0, True, True)
    with pytest.raises(ValueError, match="later slab"):
        K.bsi_range_step(planes, row, None, row[None], [("between", "consider", False)], [1, 3], 0, False, True)
    with pytest.raises(ValueError, match="1-2 jobs"):
        K.bsi_range_step(planes, row, row, None, [("eq", "pos", False)] * 3, [1, 1, 1], 0, True, True)


# ---------------------------------------------------------------------------
# the knob
# ---------------------------------------------------------------------------


@pytest.fixture
def knob():
    saved = tbs.slab_planes()
    yield
    tbs.configure(slab_planes=saved)


def test_knob_from_config_env_and_configure(knob, monkeypatch):
    cfg = Config.load(overrides={"bsi": {"slab_planes": 5}})
    assert cfg.bsi.slab_planes == 5 and "slab-planes = 5" in cfg.to_toml()
    assert Config.load(env={"PILOSA_TPU_BSI__SLAB_PLANES": "11"}).bsi.slab_planes == 11
    monkeypatch.setenv("PILOSA_TPU_BSI_SLAB_PLANES", "6")
    assert tbs._env_slab_planes() == 6
    for raw in ("-4", "0", "nope"):
        monkeypatch.setenv("PILOSA_TPU_BSI_SLAB_PLANES", raw)
        assert tbs._env_slab_planes() == 16, raw
    tbs.configure(slab_planes=-3)
    assert tbs.slab_planes() == 16
    tbs.configure(slab_planes=5)
    assert tbs.slab_planes() == 5
    tbs.configure(slab_planes=0)
    assert tbs.slab_planes() == 16


def test_server_takes_the_knob(knob, monkeypatch, tmp_path):
    """`--bsi-slab-planes` and `[bsi] slab-planes` reach the node, which
    installs the slab; a node started with it streams at that slab."""
    seen = {}

    class Stop(Exception):
        pass

    class FakeNode(NodeServer):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **kw)

        def start(self):
            raise Stop

    monkeypatch.setattr(tnode, "NodeServer", FakeNode)
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu", "--bsi-slab-planes", "6"])
    assert seen["bsi_slab_planes"] == 6 and tbs.slab_planes() == 6
    toml = tmp_path / "c.toml"
    toml.write_text("[bsi]\nslab-planes = 9\n")
    with pytest.raises(Stop):
        tmain(["--config", str(toml), "server", "--data-dir", "", "--device", "cpu"])
    assert tbs.slab_planes() == 9
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu", "--bsi-slab-planes", "0"])
    assert tbs.slab_planes() == 16
    monkeypatch.undo()

    srv = NodeServer(None, "bsknob", device="cpu", bsi_slab_planes=3)
    srv.start()
    try:
        assert tbs.slab_planes() == 3
        idx = srv.holder.create_index("k")
        idx.create_field("v", TFieldOptions(type="int", min=0, max=500))
        idx.field("v").import_values(np.array([1, 2, 3], np.uint64), np.array([7, 300, 500]))
        before = tbs.stats_snapshot()
        assert srv.executor.execute("k", "Count(Row(v > 100))") == [2]
        assert tbs.stats_snapshot()["slabs"] - before["slabs"] == 3  # 9 planes in slabs of 3
    finally:
        srv.stop()
