"""Time and bool fields, Store, ClearRow, MinRow and MaxRow in the port,
against pilosa_tpu on the same inputs.

- timeq: the port's copy (pilosa_tpu_torch/core/timeq.py) against the
  reference's for every quantum, random instants (month ends and leap
  days among them) and open bounds.
- ingest: the same Set calls with a timestamp and the same
  import_bits(timestamps=) calls into both packages' holders give the
  same views and the same bits in each.
- executor: 64 shards whose hour views are sparse, sparse Row results
  and the device cache; the read set with the error texts and keyed time
  fields, the write set and the tight device budget run in
  test_torch_time_reads.py, test_torch_time_writes.py and
  test_torch_time_budget.py (shared data: torch_time_cases.py).
- durable: a data dir with time and bool fields written by either
  package opens in the other with the same views, bits and answers.

The port runs on the CPU here (its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu.core import timeq as jtimeq
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core import timeq as ttimeq
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

from torch_time_cases import (
    R1,
    R2,
    T0,
    both,
    norm,
    run_both,
    stored,
)

QUANTUMS = sorted(jtimeq.VALID_QUANTUMS)


# ---------------------------------------------------------------------------
# timeq
# ---------------------------------------------------------------------------


def random_instants(rng, n):
    """Random instants plus month ends, leap days and year ends."""
    fixed = [
        datetime(2024, 2, 29, 23), datetime(2024, 2, 29), datetime(2023, 2, 28, 5), datetime(2024, 1, 31, 12),
        datetime(2024, 12, 31, 23), datetime(2025, 1, 1), datetime(2020, 2, 29, 1), datetime(2023, 3, 31, 22),
        datetime(2024, 4, 30), datetime(2024, 8, 31, 23, 59),
    ]
    base = datetime(2019, 1, 1)
    rand = [base + timedelta(minutes=int(m)) for m in rng.integers(0, 7 * 365 * 24 * 60, n)]
    return fixed + rand


@pytest.mark.parametrize("quantum", QUANTUMS)
def test_timeq_matches_reference(quantum):
    rng = np.random.default_rng(len(quantum) + 7 * QUANTUMS.index(quantum))
    ttimeq.validate_quantum(quantum)
    instants = random_instants(rng, 40)
    for t in instants:
        assert ttimeq.views_by_time("standard", t, quantum) == jtimeq.views_by_time("standard", t, quantum)
        s = t.strftime(jtimeq.TIME_FORMAT)
        assert ttimeq.parse_time(s) == jtimeq.parse_time(s)
    for _ in range(60):
        a, b = rng.choice(len(instants), 2)
        start = instants[a]
        # short, day-long, month-long and multi-year spans, and the empty one
        end = start + timedelta(hours=int(rng.choice([0, 1, 5, 30, 24 * 40, 24 * 800]))) if rng.random() < 0.5 else instants[b]
        want = jtimeq.views_by_time_range("standard", start, end, quantum)
        assert ttimeq.views_by_time_range("standard", start, end, quantum) == want, (start, end)
    names = [v for t in instants[:15] for v in jtimeq.views_by_time("standard", t, quantum)] + ["standard"]
    assert ttimeq.min_max_view_times(names, quantum) == jtimeq.min_max_view_times(names, quantum)
    assert ttimeq.min_max_view_times(["standard"], quantum) == (None, None)


def test_timeq_parse_and_validate_match_reference():
    for secs in (0, 1, 951782400, 1709251199, 1709251200, 2**31 + 5):
        assert ttimeq.parse_time(secs) == jtimeq.parse_time(secs)
    when = datetime(2024, 2, 29, 3)
    assert ttimeq.parse_time(when) is when
    for bad in ("2024-02-30T00:00", "yesterday", None):
        with pytest.raises(ValueError) as want:
            jtimeq.parse_time(bad)
        with pytest.raises(ValueError) as got:
            ttimeq.parse_time(bad)
        assert str(got.value) == str(want.value)
    for q in ("YX", "HY", "yMD"):
        with pytest.raises(ValueError) as want:
            jtimeq.validate_quantum(q)
        with pytest.raises(ValueError) as got:
            ttimeq.validate_quantum(q)
        assert str(got.value) == str(want.value)




def test_time_and_bool_ingest_matches_reference():
    """The same Set(…, ts) and import_bits(timestamps=) calls give the
    same view names and bits; the timestamped import's unit views are
    exactly the reference's."""
    ref_ex, port_ex = both(3)
    want, got = stored(ref_ex.holder), stored(port_ex.holder)
    assert got.keys() == want.keys()
    assert got == want
    views = {k[2] for k in got if k[1] == "t"}
    assert "standard" in views and any(len(v) == len("standard_2024022912") for v in views)
    assert {k[2] for k in got if k[1] == "tn"} == {k[2] for k in want if k[1] == "tn"}
    assert "standard" not in {k[2] for k in got if k[1] == "tn"}
    for name in ("t", "tn", "b"):
        jf, tf = ref_ex.holder.index("i").field(name), port_ex.holder.index("i").field(name)
        assert sorted(tf.views) == sorted(jf.views)
        assert tf.options.time_quantum == jf.options.time_quantum


def test_set_bit_with_timestamp_matches_reference():
    ref, port = JHolder(None).open(), THolder(device="cpu")
    for h, fo in ((ref, JFieldOptions), (port, TFieldOptions)):
        idx = h.create_index("i")
        idx.create_field("t", fo(type="time", time_quantum="MDH"))
        idx.create_field("s", fo())
    for when in (datetime(2024, 2, 29, 23), datetime(2024, 3, 1), datetime(2023, 12, 31, 23, 30)):
        for h in (ref, port):
            assert h.index("i").field("t").set_bit(4, SHARD_WIDTH + 3, when)
    assert stored(port) == stored(ref)
    with pytest.raises(ValueError) as want:
        ref.index("i").field("s").set_bit(1, 1, datetime(2024, 1, 1))
    with pytest.raises(ValueError) as got:
        port.index("i").field("s").set_bit(1, 1, datetime(2024, 1, 1))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# executor differentials (the reads with the errors and keyed fields, the
# writes and the tight budget have files of their own:
# test_torch_time_reads.py, test_torch_time_writes.py,
# test_torch_time_budget.py)
# ---------------------------------------------------------------------------


def test_sparse_hour_views_match_reference():
    """64 shards whose hour views each hold bits in a few shards: the
    stacked lowering re-lowers over a compacted shard list."""
    ref_ex, port_ex = both(64, seed=11, hour_shards=2)
    for pql in [
        f"Count(Row(t=0, {R2}))",
        "Row(t=1, from='2024-02-29T05:00', to='2024-02-29T09:00')",
        "Count(Shift(Row(t=2, from='2024-03-01T00:00', to='2024-03-01T07:00'), n=1))",
        "Count(Intersect(Row(t=0, from='2024-02-25T00:00', to='2024-02-25T06:00'), Row(f=1)))",
        "TopN(f, Row(t=1, from='2024-02-26T04:00', to='2024-02-26T09:00'), n=3)",
    ]:
        run_both(ref_ex, port_ex, pql)


@pytest.mark.parametrize("k", [2, 9, 10, 20])
def test_sparse_row_result_holds_only_its_rows(k):
    """Row 0 of f holds bits in k of 20 shards while row 1 fills all 20,
    so Row(f=0) lowers over 20 shards. Its answers equal the reference's;
    with fewer than half the rows non-empty its segments share one
    [k, W] copy, else they are rows of the [20, W] result."""
    ref, port = JHolder(None).open(), THolder(device="cpu")
    rng = np.random.default_rng(40 + k)
    cols1 = rng.integers(0, 20 * SHARD_WIDTH, 4000).astype(np.uint64)
    cols0 = (rng.integers(0, SHARD_WIDTH, 300) + SHARD_WIDTH * rng.integers(0, k, 300)).astype(np.uint64)
    for h, fo in ((ref, JFieldOptions), (port, TFieldOptions)):
        idx = h.create_index("i")
        f = idx.create_field("f", fo())
        f.import_bits(np.r_[np.zeros(len(cols0)), np.ones(len(cols1))].astype(np.uint64), np.r_[cols0, cols1])
        idx.track_columns(np.r_[cols0, cols1])
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    for pql in ["Row(f=0)", "Intersect(Row(f=0), Row(f=1))", "Count(Row(f=0))"]:
        run_both(ref_ex, port_ex, pql)
    (row,) = port_ex.execute("i", "Row(f=0)")
    assert len(row.segments) == k
    rows_held = k if 2 * k < 20 else 20
    for seg in row.segments.values():
        assert seg.untyped_storage().nbytes() == rows_held * seg.numel() * 4


def test_store_and_clear_row_drop_only_the_views_they_touch():
    """Stacks of the views a Store or ClearRow writes are dropped from the
    device cache; another field's stacks stay resident."""
    _, port_ex = both(3, seed=13)
    idx = port_ex.holder.index("i")
    port_ex.execute("i", f"Count(Row(t=1, {R1})) Count(Row(g=1)) Count(Row(f=2))")
    owners = lambda f: {k for k in idx.dcache._entries if k[0] == f.view("standard")._stack_token}
    g_before = owners(idx.field("g"))
    assert g_before
    before = port_ex.execute("i", f"Count(Row(t=1, {R1}))")
    port_ex.execute("i", "ClearRow(t=1)")
    assert port_ex.execute("i", f"Count(Row(t=1, {R1}))") == [0] != before
    port_ex.execute("i", "Store(Row(g=1), f=2)")
    assert port_ex.execute("i", "Count(Row(f=2))") == port_ex.execute("i", "Count(Row(g=1))")
    assert owners(idx.field("g")) >= g_before


# ---------------------------------------------------------------------------
# durable: both directions
# ---------------------------------------------------------------------------


def durable_ingest(holder, executor, fo):
    idx = holder.create_index("i")
    t = idx.create_field("t", fo(type="time", time_quantum="YMDH"))
    idx.create_field("b", fo(type="bool"))
    idx.create_field("f", fo())
    rng = np.random.default_rng(17)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 2000).astype(np.uint64)
    ts = [T0 + timedelta(hours=int(h)) for h in rng.integers(0, 72, len(cols))]
    t.import_bits(rng.integers(0, 2, len(cols)).astype(np.uint64), cols, timestamps=ts)
    idx.track_columns(cols)
    executor.execute("i", "Set(3, b=true) Set(4, b=false) Set(9, t=3, 2024-02-21T05:00) Set(12, f=1)")


DURABLE_READS = [
    "Count(Row(t=0, from='2024-02-20T05:00', to='2024-02-22T01:00'))",
    "Row(t=1, from='2024-02-21T00:00')",
    "Rows(t, from='2024-02-21T00:00', to='2024-02-21T06:00')",
    "Count(Row(b=true)) Count(Row(b=false))",
    "MaxRow(field=t)",
]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_time_views_cross_open(tmp_path, writer):
    """A data dir with time and bool fields written by one package opens
    in the other: the same views, bits and answers."""
    d = str(tmp_path / "data")
    if writer == "reference":
        h = JHolder(d).open()
        durable_ingest(h, JExecutor(h), JFieldOptions)
    else:
        h = THolder(d, device="cpu").open()
        durable_ingest(h, TExecutor(h), TFieldOptions)
    want_bits = stored(h)
    want = [norm(r) for q in DURABLE_READS for r in (JExecutor(h) if writer == "reference" else TExecutor(h)).execute("i", q)]
    h.close()
    other = THolder(d, device="cpu").open() if writer == "reference" else JHolder(d).open()
    ex = TExecutor(other) if writer == "reference" else JExecutor(other)
    assert stored(other) == want_bits
    assert [norm(r) for q in DURABLE_READS for r in ex.execute("i", q)] == want
    assert sorted(other.index("i").field("t").views) == sorted({k[2] for k in want_bits if k[1] == "t"})
    other.close()


# ---------------------------------------------------------------------------
# the card's path never runs the twin
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_row_results_never_run_the_twin(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")

    def refuse(*a, **k):
        raise AssertionError("plan_rows_plain ran on the card's path")

    monkeypatch.setattr(kernels, "plan_rows_plain", refuse)
    h = THolder(device="cuda")
    ex = TExecutor(h)
    idx = h.create_index("i")
    t = idx.create_field("t", TFieldOptions(type="time", time_quantum="YMDH"))
    t.import_bits(np.array([0, 0, 1], np.uint64), np.array([1, SHARD_WIDTH + 2, 5], np.uint64),
                  timestamps=[T0, T0 + timedelta(hours=30), T0])
    before = kernels.LAUNCHES["plan_rows"]
    got = ex.execute("i", f"Row(t=0, {R1}) Count(Shift(Row(t=0), n=1)) Shift(Row(t=0, {R1}), n=33)")
    assert [list(got[0].columns()), got[1]] == [[SHARD_WIDTH + 2], 2]
    assert kernels.LAUNCHES["plan_rows"] - before >= 3


# ---------------------------------------------------------------------------
# the CLI's import with a timestamp column
# ---------------------------------------------------------------------------


def test_cli_import_with_timestamps_matches_reference(tmp_path, capsys):
    """`import` of "row,col,timestamp" lines (some without a timestamp)
    into a time field prints what the reference CLI prints, and both
    servers then give the same time-range answers."""
    import json
    import urllib.request

    from pilosa_tpu.cli.main import main as jmain
    from pilosa_tpu.server.node import NodeServer as JNodeServer
    from pilosa_tpu_torch.cli.main import main as tmain
    from pilosa_tpu_torch.server import NodeServer as TNodeServer

    csv = tmp_path / "bits.csv"
    lines = ["# row,col,timestamp"]
    rng = np.random.default_rng(19)
    for k in range(300):
        when = (T0 + timedelta(hours=int(rng.integers(0, 60)))).strftime("%Y-%m-%dT%H:%M")
        lines.append(f"{k % 3},{int(rng.integers(0, 3 * SHARD_WIDTH))}" + ("" if k % 11 == 0 else f",{when}"))
    csv.write_text("\n".join(lines) + "\n")
    queries = (
        b"Count(Row(t=0, from='2024-02-20T05:00', to='2024-02-21T19:00')) Rows(t, from='2024-02-22T00:00') "
        b"Row(t=2, from='2024-02-21T00:00', to='2024-02-21T12:00') Count(Row(t=1))"
    )
    outs = []
    for main, server in ((jmain, JNodeServer(None, "n0", bind="localhost:0")), (tmain, TNodeServer(None, "n0", bind="localhost:0", device="cpu"))):
        server.start()
        try:
            for path, body in (("/index/i", {}), ("/index/i/field/t", {"options": {"type": "time", "timeQuantum": "YMDH"}})):
                urllib.request.urlopen(urllib.request.Request(server.node.uri + path, data=json.dumps(body).encode(), method="POST"))
            capsys.readouterr()
            rc = main(["import", "--host", server.node.uri, "-i", "i", "-f", "t", "--batch-size", "64", str(csv)])
            err = capsys.readouterr().err
            req = urllib.request.Request(server.node.uri + "/index/i/query", data=queries, method="POST")
            with urllib.request.urlopen(req) as r:
                outs.append((rc, err, json.loads(r.read())))
        finally:
            server.stop()
    assert outs[1] == outs[0] and outs[0][0] == 0 and "imported 300 records" in outs[0][1]
    assert outs[0][2]["results"][0] > 0