"""The port's cross-request Count batcher (pilosa_tpu_torch/exec/batcher.py)
against pilosa_tpu's (mirrors tests/test_batcher.py).

Each group-commit scenario runs through both batchers with the same
threads, gated by events and by waiting until the queue holds the
expected waiters (never by sleeps), and both must give the same results
to every caller and the same STATS. The executed round sizes are the
port's own: it merges exactly the calls it was given, where the
reference pads each merged round to a power of two with no-op lanes.
End to end, concurrent single-Count requests through the port's API
(admission, batcher, executor on the CPU) answer what the reference's
executor answers for each alone.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import batcher as jbatch
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu_torch.exec import batcher as tbatch
from pilosa_tpu_torch.exec.executor import ExecOptions
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.server.node import NodeServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SIDES = {"reference": (jbatch, jparse), "port": (tbatch, tparse)}


def reset(mod):
    for k in mod.STATS:
        mod.STATS[k] = 0


def enqueue_until(b, n, index="i"):
    for _ in range(2000):
        with b._mu:
            if len(b._queue.get(index, ())) >= n:
                return
        time.sleep(0.002)
    raise AssertionError("waiters never queued")


@pytest.mark.parametrize(
    "pql,want",
    [
        ("Count(Row(f=1))", True),
        ("Count(Row(f=1))Count(Intersect(Row(f=1), Row(f=2)))", True),
        ("Row(f=1)", False),
        ("Count(Row(f=1))Row(f=2)", False),
        ("Set(1, f=1)", False),
        ("TopN(f, n=3)", False),
        ("Count(Row(f=1), Row(f=2))", False),
    ],
)
def test_batchable_matches_reference(pql, want):
    assert tbatch.batchable(tparse(pql)) == jbatch.batchable(jparse(pql)) == want
    opt = ExecOptions()
    assert tbatch.batch_eligible(tparse(pql), None, opt) == want
    assert not tbatch.batch_eligible(tparse(pql), [0], opt)
    assert not tbatch.batch_eligible(tparse(pql), None, ExecOptions(column_attrs=True))


def scenario_merge(mod, parse):
    """A held leader, four followers queued behind it: one merged round,
    each follower its own slice in queue order."""
    b = mod.CountBatcher()
    release, entered = threading.Event(), threading.Event()
    execs, results = [], {}

    def execute(q):
        execs.append(len(q.calls))
        if len(execs) == 1:
            entered.set()
            release.wait(5)
        return list(range(len(q.calls)))

    def client(name):
        results[name] = b.run("i", parse("Count(Row(f=1))"), execute)

    leader = threading.Thread(target=client, args=("L",))
    leader.start()
    assert entered.wait(5)
    followers = []
    for k in range(4):  # one at a time: queue order is the slice order
        t = threading.Thread(target=client, args=(f"f{k}",))
        t.start()
        followers.append(t)
        enqueue_until(b, k + 1)
    release.set()
    for t in [leader] + followers:
        t.join(5)
    return results, execs


def scenario_promoted(mod, parse):
    """Arrivals during a merged round are served by a promoted leader that
    merges its own query into the next round."""
    b = mod.CountBatcher()
    entered = [threading.Event(), threading.Event()]
    gates = [threading.Event(), threading.Event()]
    execs, results = [], {}

    def execute(q):
        i = len(execs)
        execs.append(len(q.calls))
        if i < 2:
            entered[i].set()
            gates[i].wait(5)
        return list(range(len(q.calls)))

    def client(name):
        results[name] = b.run("i", parse("Count(Row(f=1))"), execute)

    def start(name):
        t = threading.Thread(target=client, args=(name,))
        t.start()
        return t

    ts = [start("L")]
    assert entered[0].wait(5)
    ts.append(start("A"))
    enqueue_until(b, 1)
    ts.append(start("B"))
    enqueue_until(b, 2)
    gates[0].set()
    assert entered[1].wait(5)
    ts.append(start("C"))
    enqueue_until(b, 1)
    ts.append(start("D"))
    enqueue_until(b, 2)
    gates[1].set()
    for t in ts:
        t.join(5)
    return results, execs


def scenario_errors(mod, parse):
    """A merged round that raises re-runs each waiter alone: the good
    query answers, only the bad one fails."""
    b = mod.CountBatcher()
    release, entered = threading.Event(), threading.Event()
    state = {"n": 0}

    def execute(q):
        state["n"] += 1
        if state["n"] == 1:
            entered.set()
            release.wait(5)
            return [1]
        if any("boom" in c.children[0].args for c in q.calls):
            raise ValueError("boom")
        return [len(q.calls)] * len(q.calls)

    results = {}

    def client(name, pql):
        try:
            results[name] = b.run("i", parse(pql), execute)
        except ValueError as e:
            results[name] = f"error {e}"

    ts = [threading.Thread(target=client, args=("L", "Count(Row(f=1))"))]
    ts[0].start()
    assert entered.wait(5)
    for k, (name, pql) in enumerate((("good", "Count(Row(f=1))"), ("bad", "Count(Row(boom=1))"))):
        ts.append(threading.Thread(target=client, args=(name, pql)))
        ts[-1].start()
        enqueue_until(b, k + 1)
    release.set()
    for t in ts:
        t.join(5)
    return results, None


def scenario_cap(mod, parse):
    """74 queued behind a held leader: merges of at most 64 calls."""
    b = mod.CountBatcher()
    release, entered = threading.Event(), threading.Event()
    execs = []

    def execute(q):
        execs.append(len(q.calls))
        if len(execs) == 1:
            entered.set()
            release.wait(5)
        return [0] * len(q.calls)

    n = mod.MAX_BATCH_CALLS + 10
    ts = [threading.Thread(target=lambda: b.run("i", parse("Count(Row(f=1))"), execute)) for _ in range(n)]
    ts[0].start()
    assert entered.wait(5)
    for t in ts[1:]:
        t.start()
    enqueue_until(b, n - 1)
    release.set()
    for t in ts:
        t.join(10)
    return {"rounds": len(execs)}, execs


@pytest.mark.parametrize("scenario", [scenario_merge, scenario_promoted, scenario_errors, scenario_cap])
def test_group_commit_matches_reference(scenario):
    out = {}
    for side, (mod, parse) in SIDES.items():
        reset(mod)
        results, execs = scenario(mod, parse)
        out[side] = (results, dict(mod.STATS), execs)
    (jres, jstats, jexecs), (tres, tstats, texecs) = out["reference"], out["port"]
    assert tres == jres
    assert tstats == jstats
    if scenario is scenario_merge:
        assert texecs == [1, 4] and tres["f2"] == [2]
    elif scenario is scenario_promoted:
        assert texecs == [1, 2, 2] and tres["C"] == [0] and tres["D"] == [1]
    elif scenario is scenario_errors:
        assert tres == {"L": [1], "good": [1], "bad": "error boom"}
    else:
        # no padding: every executed call is a real one
        assert texecs[0] == 1 and max(texecs) == tbatch.MAX_BATCH_CALLS
        assert sum(texecs) == tbatch.MAX_BATCH_CALLS + 10 < sum(jexecs)


def test_device_failure_of_a_merged_round_fails_every_waiter():
    """A merged round that fails on the device (the multi-root kernel does
    not launch) fails each of its waiters with that error: nothing re-runs
    alone on the single-root kernel, and no isolation split is counted."""
    tbatch.reset_stats()
    b = tbatch.CountBatcher()
    release, entered = threading.Event(), threading.Event()
    execs, results = [], {}

    def execute(q):
        execs.append(len(q.calls))
        if len(execs) == 1:
            entered.set()
            release.wait(5)
            return [1]
        if len(q.calls) > 1:
            raise RuntimeError("plan_count_multi kernel launch failed: CUDA error 1")
        return [len(q.calls)]

    def client(name, pql):
        try:
            results[name] = b.run("i", tparse(pql), execute)
        except RuntimeError as e:
            results[name] = f"error {e}"

    ts = [threading.Thread(target=client, args=("L", "Count(Row(f=1))"))]
    ts[0].start()
    assert entered.wait(5)
    for k, name in enumerate(("a", "b")):
        ts.append(threading.Thread(target=client, args=(name, f"Count(Row(f={k + 2}))")))
        ts[-1].start()
        enqueue_until(b, k + 1)
    release.set()
    for t in ts:
        t.join(5)
    failed = "error plan_count_multi kernel launch failed: CUDA error 1"
    assert results == {"L": [1], "a": failed, "b": failed}
    assert execs == [1, 2]
    assert tbatch.STATS["merged_execs"] == 1 and tbatch.STATS["fallback_splits"] == 0


def test_rounds_split_by_lowering_class():
    """A round mixing classes executes one merge per class, in arrival
    order; the batch-size histogram records every round."""
    b = tbatch.CountBatcher()
    b.classify = lambda index, q: "odd" if "g" in str(q) else "even"
    release, entered = threading.Event(), threading.Event()
    execs, results = [], {}

    def execute(q):
        execs.append(str(q).count("Count"))
        if len(execs) == 1:
            entered.set()
            release.wait(5)
        return [str(c) for c in q.calls]

    def client(name, pql):
        results[name] = b.run("i", tparse(pql), execute)

    ts = [threading.Thread(target=client, args=("L", "Count(Row(f=0))"))]
    ts[0].start()
    assert entered.wait(5)
    for k, (name, pql) in enumerate([("a", "Count(Row(f=1))"), ("b", "Count(Row(g=1))"), ("c", "Count(Row(f=2))"), ("d", "Count(Row(g=2))")]):
        ts.append(threading.Thread(target=client, args=(name, pql)))
        ts[-1].start()
        enqueue_until(b, k + 1)
    release.set()
    for t in ts:
        t.join(5)
    assert execs == [1, 2, 2]
    assert results["a"] == ["Count(Row(f=1))"] and results["d"] == ["Count(Row(g=2))"]
    assert b.batch_sizes.count == 3 and b.batch_sizes.total == 5.0


def test_adaptive_hold_waits_for_the_hinted_mates():
    """With the admission hint at 3, a fresh leader holds until two more
    queries line up and runs all three as one merged round."""
    tbatch.reset_stats()
    b = tbatch.CountBatcher()
    b.hold_timeout = 10.0  # bounded by the mates, not the clock, here
    b.load_hint = lambda index: 3
    execs, results = [], {}

    def execute(q):
        execs.append(len(q.calls))
        return list(range(len(q.calls)))

    def client(name):
        results[name] = b.run("i", tparse("Count(Row(f=1))"), execute)

    ts = [threading.Thread(target=client, args=(n,)) for n in ("L", "A", "B")]
    ts[0].start()
    for _ in range(2000):
        with b._mu:
            if b._busy.get("i"):
                break
        time.sleep(0.002)
    ts[1].start()
    enqueue_until(b, 1)
    ts[2].start()
    for t in ts:
        t.join(10)
    assert execs == [3]
    assert results == {"L": [0], "A": [1], "B": [2]}
    assert tbatch.STATS["merged_execs"] == 1 and tbatch.STATS["batched"] == 2


def test_indexes_batch_independently():
    b = tbatch.CountBatcher()
    release, entered = threading.Event(), threading.Event()
    seen = []

    def execute(q):
        seen.append(len(q.calls))
        if len(seen) == 1:
            entered.set()
            release.wait(5)
        return [0] * len(q.calls)

    t = threading.Thread(target=lambda: b.run("i", tparse("Count(Row(f=1))"), execute))
    t.start()
    assert entered.wait(5)
    # another index is not busy: it leads at once, not behind "i"
    assert b.run("j", tparse("Count(Row(f=1))"), lambda q: [5]) == [5]
    release.set()
    t.join(5)


def test_concurrent_clients_through_the_api_match_reference():
    """16 threads x 6 single-Count requests through the port's API
    (admission, batcher, executor; CPU) equal the reference executor's
    answer for each query alone; whether rounds merged depends on timing
    and is not asserted."""
    rng = np.random.default_rng(1100)
    n_shards = 4
    jh = JHolder().open()
    jh.create_index("i").create_field("f")
    node = NodeServer(None, "n0", bind="localhost:0", device="cpu", cache_result_mb=0)
    node.holder.open()
    try:
        node.api.create_index("i")
        node.api.create_field("i", "f")
        for row in range(4):
            cols = rng.integers(0, n_shards * SHARD_WIDTH, 3000).astype(np.uint64)
            rows = np.full(len(cols), row, np.uint64)
            jh.index("i").field("f").import_bits(rows, cols)
            jh.index("i").track_columns(cols)  # as the API's import does
            node.api.import_bits("i", "f", rows, cols)
        queries = [
            "Count(Row(f=0))",
            "Count(Intersect(Row(f=0), Row(f=1)))",
            "Count(Union(Row(f=2), Row(f=3)))",
            "Count(Difference(Row(f=1), Row(f=2)))",
            "Count(Xor(Row(f=0), Row(f=3)))",
            "Count(Not(Row(f=1)))",
        ]
        want = {q: JExecutor(jh).execute("i", q)[0] for q in queries}
        got, errors = [], []

        def client(k):
            try:
                for j in range(6):
                    q = queries[(k + j) % len(queries)]
                    got.append((q, node.api.query_response("i", q).results[0]))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        ts = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errors
        assert len(got) == 96 and all(r == want[q] for q, r in got)
        assert node.scheduler.pending() == (0, 0)
        assert node.count_batcher.batch_sizes.count >= 1
    finally:
        node.stop()
