"""The port's admission control (pilosa_tpu_torch/sched/) against
pilosa_tpu's.

Admission: the same scripted arrivals go through the reference's
AdmissionController and the port's (same cap, queue depth, byte budget,
fake or real clock) and must grant, queue, shed and report alike: a full
queue sheds with the same message, reason and Retry-After; queued
classes dequeue in the same weighted-fair order; a deadline exhausted on
arrival or expiring in the queue sheds without leaving residue; the byte
budget gates in-flight queries and an oversized one runs alone; a ticket
is released when the query fails. Tenants: token buckets, override
parsing, limits and quota maps equal the reference's; a rate-limited
index sheds with the reference's reason and quota detail. Cost: on
set-field queries `estimate` prices exactly what the reference prices
(same shards, same device budget, nothing resident, no cached result);
a BSI reference is priced at the plane-streamed slab peak as the
reference prices it, except a signed field 32 bits deep, which the
reference stages whole and the port streams; the estimate's running totals (staged
positions, resident bytes, the shard count) equal a walk. Internal legs
take their own lane alike on both sides. Also: the per-index device-cache
quotas, the prefetch offer and the prefetcher's warm (it stages what is
missing, skips what is resident), and the CLI knobs reaching the node.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.core import devcache as jdevcache
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.resultcache import RESULT_CACHE as JRC
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu.sched import admission as jadm
from pilosa_tpu.sched import cost as jcost
from pilosa_tpu.sched import tenants as jten
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE as TRC
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.sched import admission as tadm
from pilosa_tpu_torch.sched import cost as tcost
from pilosa_tpu_torch.sched import tenants as tten
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

SIDES = {"reference": (jadm, jcost, jten), "port": (tadm, tcost, tten)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def wait_until(pred, what):
    for _ in range(3000):
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def shed_of(fn):
    try:
        fn()
    except (jadm.ShedError, tadm.ShedError) as e:
        return (str(e), e.reason, e.retry_after, e.quota_limit, e.quota_usage, e.quota_value)
    return None


def both(scenario):
    """Run `scenario(adm, cost, tenants)` on each side; the outcomes must
    be equal. Returns the port's."""
    out = {side: scenario(*mods) for side, mods in SIDES.items()}
    assert out["port"] == out["reference"]
    return out["port"]


def test_shed_when_queue_full():
    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=1, queue_depth=0, retry_after=1.5, clock=FakeClock())
        t = ctl.admit(cost=cost.QueryCost(device_bytes=10))
        shed = shed_of(lambda: ctl.admit())
        snap = ctl.snapshot()
        t.release()
        return shed, snap["inflight"], snap["inflightBytes"], ctl.pending()

    shed, inflight, nbytes, pending = both(scenario)
    assert shed[1] == "queue" and shed[2] == 1.5 and inflight == 1 and nbytes == 10 and pending == (0, 0)


def test_weighted_fair_class_order_and_queued_grants():
    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=1, queue_depth=16)
        hold = ctl.admit()
        order, lock = [], threading.Lock()

        def arrive(cls, name):
            t = ctl.admit(cls=cls)
            with lock:
                order.append(name)
            t.release()

        ts = []
        for k, (cls, name) in enumerate([("batch", "b1"), ("batch", "b2"), ("interactive", "i1"),
                                         ("internal", "n1"), ("interactive", "i2"), ("bogus", "d1")]):
            ts.append(threading.Thread(target=arrive, args=(cls, name)))
            ts[-1].start()
            wait_until(lambda k=k: ctl.queue_depth() == k + 1, "queued")
        snap = ctl.snapshot()["queued"]
        hold.release()
        for t in ts:
            t.join(5)
        return order, snap, ctl.pending()

    order, snap, pending = both(scenario)
    assert order[0] == "i1" and pending == (0, 0)
    assert snap == {"batch": 2, "interactive": 3, "internal": 1}


def test_deadlines_shed_without_residue():
    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=1, queue_depth=4)
        on_arrival = shed_of(lambda: ctl.admit(deadline=0))
        hold = ctl.admit()
        t0 = time.monotonic()
        in_queue = shed_of(lambda: ctl.admit(deadline=0.05))
        waited = time.monotonic() - t0
        left = ctl.pending()
        hold.release()
        return on_arrival[:2], in_queue[:2], waited >= 0.04, left, ctl.pending()

    on_arrival, in_queue, waited, left, pending = both(scenario)
    assert on_arrival[1] == in_queue[1] == "deadline" and waited
    assert left == (0, 1) and pending == (0, 0)


def test_byte_budget_gates_and_oversized_runs_alone():
    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=8, queue_depth=8, byte_budget=100)
        a = ctl.admit(cost=cost.QueryCost(device_bytes=60))
        got = threading.Event()

        def second():
            ctl.admit(cost=cost.QueryCost(device_bytes=60)).release()
            got.set()

        th = threading.Thread(target=second)
        th.start()
        wait_until(lambda: ctl.queue_depth() == 1, "byte-gated")
        gated = not got.is_set() and ctl.snapshot()["inflightBytes"] == 60
        a.release()
        th.join(5)
        big = ctl.admit(cost=cost.QueryCost(device_bytes=500))  # over the whole budget: alone
        big_bytes = ctl.snapshot()["inflightBytes"]
        big.release()
        return gated, got.is_set(), big_bytes, ctl.pending()

    assert both(scenario) == (True, True, 500, (0, 0))


LEG_KEYS = ("inflight", "inflightBytes", "inflightBytesByIndex", "inflightLegs", "waitingLegs")


def test_internal_leg_lane():
    """Internal fan-out legs (`leg=True`) take a lane of their own: granted
    while every coordinator slot is held, counted into the in-flight bytes
    but never gated by the byte budget, queued FIFO up to the queue depth
    and shed past it, shed on a spent deadline, held to the tenant's
    in-flight byte quota, and granted in arrival order as legs release."""

    def scenario(adm, cost, ten):
        pol = ten.TenantPolicy(overrides=["q:inflight-bytes=100"])
        ctl = adm.AdmissionController(max_concurrent=1, queue_depth=1, byte_budget=50, retry_after=1.0,
                                      tenants=pol)
        snaps = []
        snap = lambda: snaps.append({k: ctl.snapshot()[k] for k in LEG_KEYS})  # noqa: E731
        hold = ctl.admit(cost=cost.QueryCost(device_bytes=40))
        leg1 = ctl.admit(leg=True, cost=cost.QueryCost(device_bytes=40), index="i")
        snap()
        granted = []

        def queued_leg(name):
            t = ctl.admit(leg=True, index="i")
            granted.append(name)
            t.release()

        th = threading.Thread(target=queued_leg, args=("leg2",))
        th.start()
        wait_until(lambda: ctl.snapshot()["waitingLegs"] == 1, "a queued leg")
        snap()
        full = shed_of(lambda: ctl.admit(leg=True, index="i"))
        spent = shed_of(lambda: ctl.admit(leg=True, deadline=0, index="i"))
        leg1.release()
        th.join(5)
        snap()
        q1 = ctl.admit(leg=True, cost=cost.QueryCost(device_bytes=80), index="q")
        over = shed_of(lambda: ctl.admit(leg=True, cost=cost.QueryCost(device_bytes=30), index="q"))
        snap()
        q1.release()
        hold.release()
        snap()
        return snaps, granted, full[:2] + full[3:], spent[:2], over[:2] + over[3:], ctl.pending()

    snaps, granted, full, spent, over, pending = both(scenario)
    assert snaps[0]["inflight"] == 1 and snaps[0]["inflightLegs"] == 1 and snaps[0]["inflightBytes"] == 80
    assert snaps[1]["waitingLegs"] == 1 and granted == ["leg2"] and snaps[2]["inflightLegs"] == 0
    assert full[1] == "queue" and spent[1] == "deadline" and over[1] == "bytes"
    assert snaps[-1]["inflightBytes"] == 0 and pending == (0, 0)


def test_internal_leg_waits_out_its_deadline_in_the_queue():
    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=1, queue_depth=4)
        leg = ctl.admit(leg=True)
        t0 = time.monotonic()
        shed = shed_of(lambda: ctl.admit(leg=True, deadline=0.05))
        waited = time.monotonic() - t0 >= 0.04
        left = ctl.snapshot()["waitingLegs"]
        leg.release()
        return shed[:3], waited, left, ctl.snapshot()["inflightLegs"]

    shed, waited, left, inflight = both(scenario)
    assert shed[1] == "deadline" and "in queue" in shed[0] and waited and left == 0 and inflight == 0


def test_load_hint_and_done_batching():
    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=2, queue_depth=4)
        ts = [ctl.admit(batchable=True, index="i") for _ in range(2)]
        other = ctl.load("j")
        full = ctl.load("i")
        ts[0].done_batching()
        after = ctl.load("i")
        for t in ts:
            t.release()
        return other, full, after, ctl.load("i")

    assert both(scenario) == (0, 2, 1, 0)


def test_ticket_released_when_the_query_fails():
    """Through the port's API: a failing query (unknown index, bad call)
    leaves no slot held."""
    from pilosa_tpu_torch.exec.executor import ExecError, NotFoundError
    from pilosa_tpu_torch.server.node import NodeServer

    node = NodeServer(None, "n0", bind="localhost:0", device="cpu", max_concurrent_queries=1)
    node.holder.open()
    try:
        node.api.create_index("i")
        node.api.create_field("i", "f")
        with pytest.raises(NotFoundError):
            node.api.query_response("nope", "Count(Row(f=1))")
        with pytest.raises(ExecError):
            node.api.query_response("i", "Count(Row(f=1)) Count(Row(f=1), Row(f=2))")
        assert node.scheduler.pending() == (0, 0)
        assert node.api.query_response("i", "Count(Row(f=1))").results == [0]
    finally:
        node.stop()


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------


def test_token_bucket_and_overrides_match_reference():
    def scenario(adm, cost, ten):
        b = ten.TokenBucket(rate=2.0, burst=4.0, now=0.0)
        trace = [b.take(3, 0.0), b.take(2, 0.0), b.take(2, 1.0), b.peek(1, 1.0)]
        b.refund(10)
        trace.append(b.tokens)
        ov = ten.parse_overrides(["i:qps=5;hbm-bytes=65536", " ", "j:cache-bytes=10"])
        pol = ten.TenantPolicy(default_qps=1, default_cache_bytes=7, overrides=["i:qps=5;hbm-bytes=65536"])
        errs = []
        for bad in ("noindex", "i:bogus=1", "i:qps=x", ":qps=1"):
            try:
                ten.parse_overrides([bad])
            except ValueError as e:
                errs.append(str(e))
        return trace, ov, tuple(pol.limits("i")), tuple(pol.limits("k")), pol.hbm_quota_map(), pol.cache_quota_map(), errs

    both(scenario)


def test_rate_limited_index_sheds_with_quota_detail():
    def scenario(adm, cost, ten):
        clock = FakeClock()
        pol = ten.TenantPolicy(default_qps=1.0, clock=clock)
        ctl = adm.AdmissionController(max_concurrent=4, queue_depth=4, tenants=pol, clock=clock)
        ctl.admit(index="i").release()
        shed = shed_of(lambda: ctl.admit(index="i"))
        throttled = pol.throttled("i")
        clock.t = 1.0
        ctl.admit(index="i").release()
        other = ctl.admit(index="j")
        other.release()
        untenanted = ctl.admit()
        untenanted.release()
        ctl.drop_index("i")
        return shed, throttled, pol.bucket_count()

    shed, throttled, buckets = both(scenario)
    assert shed[1] == "rate" and shed[3] == "qps" and throttled and buckets == 1


def test_inflight_byte_quota():
    def scenario(adm, cost, ten):
        pol = ten.TenantPolicy(overrides=["i:inflight-bytes=100"])
        ctl = adm.AdmissionController(max_concurrent=4, queue_depth=4, tenants=pol)
        a = ctl.admit(index="i", cost=cost.QueryCost(device_bytes=80))
        shed = shed_of(lambda: ctl.admit(index="i", cost=cost.QueryCost(device_bytes=30)))
        b = ctl.admit(index="j", cost=cost.QueryCost(device_bytes=30))
        snap = ctl.snapshot()["inflightBytesByIndex"]
        a.release()
        b.release()
        return shed, snap

    shed, snap = both(scenario)
    assert shed[1] == "bytes" and shed[3] == "inflight-bytes" and snap == {"i": 80, "j": 30}


def test_prefetch_offered_only_when_the_arrival_would_wait():
    class Offers:
        def __init__(self):
            self.n = 0

        def offer(self, warm):
            self.n += 1
            return True

    def scenario(adm, cost, ten):
        ctl = adm.AdmissionController(max_concurrent=1, queue_depth=4)
        ctl.prefetcher = Offers()
        idle = ctl.maybe_prefetch(lambda: None, index="i")
        t = ctl.admit()
        busy = ctl.maybe_prefetch(lambda: None, index="i")
        t.release()
        return idle, busy, ctl.prefetcher.n

    assert both(scenario) == (False, True, 1)


def test_prefetcher_backs_off_while_its_warms_find_everything_resident():
    """After IDLE_STREAK warms in a row that warmed nothing the
    prefetcher takes one offer in BACKOFF_EVERY; a warm that stages
    something ends the back-off."""
    from pilosa_tpu_torch.hbm import prefetch

    pf = prefetch.Prefetcher(depth=4).start()

    def offer_and_wait(n):
        k = pf.warmed
        taken = pf.offer(lambda: n)
        if taken:
            wait_until(lambda: pf.warmed == k + 1, "the warm")
        return taken

    try:
        assert all(offer_and_wait(0) for _ in range(prefetch.IDLE_STREAK))
        taken = [offer_and_wait(0) for _ in range(2 * prefetch.BACKOFF_EVERY)]
        assert sum(taken) == 2 and pf.skipped == 2 * prefetch.BACKOFF_EVERY - 2
        while not offer_and_wait(1):
            pass
        assert all(offer_and_wait(0) for _ in range(prefetch.IDLE_STREAK))
        assert pf.warmed == prefetch.IDLE_STREAK + 2 + 1 + prefetch.IDLE_STREAK
    finally:
        pf.stop()


def test_prefetcher_warms_what_is_missing_and_skips_what_is_resident():
    """A queued query's warm on the prefetcher's thread stages the rows
    it reads (the query then hits them); a warm of the same rows once
    resident copies, assembles and pins nothing."""
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.hbm import residency
    from pilosa_tpu_torch.hbm.prefetch import Prefetcher

    rng = np.random.default_rng(1460)
    h = THolder(device="cpu").open()
    f = h.create_index("i").create_field("f")
    bits = {}
    for row in (1, 2):
        cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 4000).astype(np.uint64))
        f.import_bits(np.full(len(cols), row, np.uint64), cols)
        bits[row] = set(cols.tolist())
    ex = Executor(h)
    pql = "Count(Intersect(Row(f=1), Row(f=2)))"
    saved = residency.extent_rows()
    residency.configure(extent_rows=1)  # 3 extents a row: a lowering assembles them
    residency.reset_stats()
    pf = Prefetcher(depth=2).start()
    try:
        assert pf.offer(lambda: ex.warm("i", tparse(pql)))
        for _ in range(2000):
            if pf.warmed:
                break
            time.sleep(0.002)
        assert pf.warmed == 1
        snap = residency.stats_snapshot(h.dcache)
        assert snap["prefetch_staged"] == 6 and snap["pinned_bytes"] == 0
        assert ex.execute("i", pql) == [len(bits[1] & bits[2])]
        assert residency.stats_snapshot()["prefetch_hits"] == 6
        before = residency.stats_snapshot(h.dcache)
        with residency.prefetching():
            assert ex.warm("i", tparse(pql)) == 0
        after = residency.stats_snapshot(h.dcache)
        for k in ("restage_bytes", "assemblies", "prefetch_staged", "pinned_bytes"):
            assert after[k] == before[k], k
    finally:
        pf.stop()
        residency.configure(extent_rows=saved)
        h.close()


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

SET_QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=0)))",
    "Count(Not(Row(f=1)))",
    "Row(f=1)",
    "TopN(f, n=3)",
    "TopN(f, Row(g=0), n=3)",
    "GroupBy(Rows(f), Rows(g))",
    "Rows(f)",
    "Set(3, f=1)",
    "Count(Row(f=1)) Count(Row(g=0)) Set(4, f=2)",
    "Count(Shift(Row(f=1), n=2))",
    "Count(Row(nope=1))",
]


@pytest.fixture
def priced():
    """The same data in both holders (staged bursts left unmerged, so the
    staged-merge surcharge counts), the reference's device budget equal
    to the port holder's, both result caches empty."""
    th = THolder(device="cpu").open()
    jh = JHolder().open()
    saved = jdevcache.DEVICE_CACHE.budget_bytes
    jdevcache.DEVICE_CACHE.budget_bytes = th.dcache.budget_bytes
    JRC.reset()
    TRC.reset()
    rng = np.random.default_rng(1400)
    for h, FO in ((jh, JFieldOptions), (th, TFieldOptions)):
        idx = h.create_index("i")
        idx.create_field("f")
        idx.create_field("g")
        idx.create_field("v", FO(type="int", min=-1000, max=1000))
    for name, row in (("f", 1), ("f", 2), ("g", 0)):
        cols = rng.integers(0, 5 * SHARD_WIDTH, 2000).astype(np.uint64)
        for h in (jh, th):
            h.index("i").field(name).import_bits(np.full(len(cols), row, np.uint64), cols)
    yield jh, th
    jdevcache.DEVICE_CACHE.budget_bytes = saved
    th.close()


def test_cost_matches_reference_on_set_fields(priced):
    jh, th = priced
    for pql in SET_QUERIES:
        for shards in (None, [0, 2]):
            want = jcost.estimate(jh.index("i"), jparse(pql), shards)
            got = tcost.estimate(th.index("i"), tparse(pql), shards)
            assert (got.device_bytes, got.sweeps, got.write, got.transport_ms) == (
                want.device_bytes, want.sweeps, want.write, want.transport_ms), pql
    assert tcost.estimate(None, "Count(Row(f=1))") == tcost.QueryCost(device_bytes=WORDS_PER_ROW * 4, sweeps=1)
    assert tcost.estimate(th.index("i"), "Count(Row(f=1") == tcost.ZERO_COST


def test_cost_prices_the_whole_bsi_plane_stack(priced):
    """A BSI reference is priced at its slab peak, min(depth, slab) + 3
    rows, not at the whole plane stack (depth + 2) the port staged before
    slab streaming: equal to the reference's `_bsi_planes` for unsigned
    and signed fields up to 31 bits at each slab; for a signed field 32
    bits deep, which the reference stages whole (depth + 2), the port's
    slab peak."""
    from pilosa_tpu.exec import bsistream as jbs
    from pilosa_tpu_torch.exec import bsistream as tbs

    jh, th = priced
    for h, FO in ((jh, JFieldOptions), (th, TFieldOptions)):
        h.index("i").create_field("u", FO(type="int", min=0, max=5000))
        h.index("i").create_field("deep", FO(type="int", min=-(2**32 - 1), max=2**32 - 1))
    idx, jidx = th.index("i"), jh.index("i")
    stack = 5 * WORDS_PER_ROW * 4
    saved = (jbs.slab_planes(), tbs.slab_planes())
    try:
        for slab in (4, 11, 16):
            jbs.configure(slab_planes=slab)
            tbs.configure(slab_planes=slab)
            for name in ("v", "u", "deep", "nope", None):
                want = jcost._bsi_planes(jidx, name)
                depth = idx.field(name).options.bit_depth if name in ("v", "u", "deep") else 0
                if name == "deep":
                    assert want == depth + 2
                    want = min(depth, slab) + 3
                assert tcost._bsi_planes(idx, name) == want, (name, slab)
            for pql in ("Count(Row(v > 5))", "Sum(field=u)", "Min(field=v)"):
                want = jcost.estimate(jidx, jparse(pql)).device_bytes
                assert tcost.estimate(idx, pql).device_bytes == want, (pql, slab)
            depth = idx.field("deep").options.bit_depth
            assert tcost.estimate(idx, "Sum(field=deep)").device_bytes == (min(depth, slab) + 3) * stack < (depth + 2) * stack
    finally:
        jbs.configure(slab_planes=saved[0])
        tbs.configure(slab_planes=saved[1])


def test_cost_running_totals_equal_a_walk(tmp_path):
    """The estimate's per-query inputs are running totals: each view's
    staged positions, each owner's resident bytes and the index's shard
    count. Through staging, a read barrier, a fold, a WAL replay, a new
    shard and a deleted field they equal a walk over the fragments."""
    from pilosa_tpu_torch.exec.executor import Executor

    def check(h):
        idx = h.index("i")
        assert idx.shard_count() == len(idx.available_shards())
        for f in idx._fields.values():
            for v in f.views.values():
                frags = list(v.fragments.values())
                assert v.staged.n == sum(fr._pending_n + fr._premerged_n for fr in frags)
                with h.dcache._mu:
                    walked = sum(h.dcache._sizes.get(k, 0) for k in h.dcache._by_owner.get(v._stack_token, ()))
                assert h.dcache.owner_resident_bytes(v._stack_token) == walked

    rng = np.random.default_rng(1450)
    h = THolder(str(tmp_path / "d"), device="cpu").open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        idx.create_field(name)
    ex = Executor(h)

    def burst(name, row, hi_shard):
        cols = rng.integers(0, hi_shard * SHARD_WIDTH, 3000).astype(np.uint64)
        idx.field(name).import_bits(np.full(len(cols), row, np.uint64), cols)

    burst("f", 1, 3)
    burst("g", 0, 3)
    check(h)
    assert idx.field("f").view("standard").staged.n > 0
    ex.execute("i", "Count(Intersect(Row(f=1), Row(g=0)))")  # the read barrier parks the merged keys
    check(h)
    burst("f", 1, 3)
    check(h)
    for fr in idx.field("f").view("standard").fragments.values():
        fr.sync_pending_now()  # a host read folds everything in
    check(h)
    assert idx.field("f").view("standard").staged.n == 0
    burst("f", 2, 5)  # new shards
    check(h)
    assert idx.shard_count() == 5 and idx.shard_list() == [0, 1, 2, 3, 4]
    h.close()
    h = THolder(str(tmp_path / "d"), device="cpu").open()  # the WAL's staged sets come back
    check(h)
    idx = h.index("i")
    idx.delete_field("f")
    check(h)
    h.close()


# ---------------------------------------------------------------------------
# device-cache quotas and the CLI
# ---------------------------------------------------------------------------


def test_device_cache_quota_evicts_the_over_quota_index_first():
    import torch

    dc = DeviceCache(budget_bytes=10_000)
    for owner, index in ((1, "a"), (2, "b")):
        dc.tag_owner(owner, index)
    for k in range(4):
        dc.put((1, k), torch.zeros(250, dtype=torch.int32))  # 1000 B each
        dc.put((2, k), torch.zeros(250, dtype=torch.int32))
    dc.configure_quotas(overrides={"a": 2000})
    assert dc.index_resident_bytes() == {"a": 2000, "b": 4000}
    assert dc.quota_evictions_by_index() == {"a": 2}
    assert dc.owner_resident_bytes(2) == 4000
    dc.configure_quotas(default_bytes=1500)  # each index alike
    assert dc.index_resident_bytes() == {"a": 1000, "b": 1000}


def test_cli_front_end_knobs_reach_the_node(monkeypatch):
    from pilosa_tpu_torch.cli.main import main as tmain
    from pilosa_tpu_torch.server import node as tnode

    seen = {}

    class Stop(Exception):
        pass

    class FakeNode(tnode.NodeServer):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **kw)

        def start(self):
            self.stop()
            raise Stop

    monkeypatch.setattr(tnode, "NodeServer", FakeNode)
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu", "--max-concurrent-queries", "3",
               "--admission-queue-depth", "7", "--hbm-prefetch-depth", "2", "--cache-result-mb", "1",
               "--cache-count-repair", "false", "--tenants-overrides", "i:qps=5"])
    assert seen["max_concurrent_queries"] == 3 and seen["admission_queue_depth"] == 7
    assert seen["hbm_prefetch_depth"] == 2 and seen["cache_result_mb"] == 1
    assert seen["cache_count_repair"] is False and list(seen["tenant_overrides"]) == ["i:qps=5"]
