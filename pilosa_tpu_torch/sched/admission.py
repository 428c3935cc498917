"""Admission controller: bounded, deadline- and priority-aware queueing.

The port of pilosa_tpu/sched/admission.py. Every query is admitted before
it may dispatch:

- at most `max_concurrent` queries execute at once (kernel launches
  serialize behind exec/plan.py's dispatch lock anyway: past the cap
  queries would only pile onto that lock);
- while the in-flight device-byte account (sched/cost.py's estimate,
  against a budget that follows the holder's device cache by default)
  is full, further queries WAIT in per-class queues;
- the classes drain weighted-fair (WFQ virtual finish times):
  `interactive` ahead of `batch` whenever both wait, without starving
  `batch`; `internal` in between. WITHIN a class a start-time-fair queue
  keyed on index shares the class across tenants;
- per-index limits from sched/tenants.py: token buckets charged before
  queueing, an in-flight byte quota checked under the lock;
- the queue is bounded and deadline-aware: a full queue, or a deadline
  that cannot be met, sheds the query with `ShedError` -> HTTP 429 and a
  Retry-After derived from the constraint (the configured value is a
  floor);
- internal legs (`leg=True`) have a lane of their own, as in the
  reference, so legs never wait on coordinator slots.

It also feeds the Count batcher's adaptive hold (`load`) and the
prefetcher (`maybe_prefetch`). The clock is injectable: the tests drive
expiry with a fake clock. Plain threading locks; the statsd gauges of
the reference are not ported (`snapshot` reads the same numbers).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from pilosa_tpu_torch.sched.cost import QueryCost, ZERO_COST
from pilosa_tpu_torch.sched.tenants import TenantPolicy
from pilosa_tpu_torch.utils.stats import Histogram

# Request headers understood by the query routes. Priority selects the
# class; deadline carries the REMAINING seconds of the sender's budget
# (the distributed executor stamps its fan-out legs with
# `deadline.remaining()` so a remote node sheds early instead of timing
# out late).
PRIORITY_HEADER = "X-Pilosa-Priority"
DEADLINE_HEADER = "X-Pilosa-Deadline"

CLASS_INTERACTIVE = "interactive"
CLASS_BATCH = "batch"
CLASS_INTERNAL = "internal"

# WFQ weights: higher weight -> earlier virtual finish -> dequeues first.
CLASS_WEIGHTS: Dict[str, float] = {
    CLASS_INTERACTIVE: 8.0,
    CLASS_INTERNAL: 4.0,
    CLASS_BATCH: 1.0,
}

# every live controller, for the tests' idle check (leaked_state)
_live_controllers: "weakref.WeakSet[AdmissionController]" = weakref.WeakSet()


def leaked_state() -> List[Tuple[int, int, int]]:
    """(controller-id, queued, inflight) for every non-idle controller."""
    out: List[Tuple[int, int, int]] = []
    for ctl in list(_live_controllers):
        queued, inflight = ctl.pending()
        if queued or inflight:
            out.append((id(ctl), queued, inflight))
    return out


class ShedError(Exception):
    """Load shed: the caller should reply 429 with Retry-After.

    Not an ApiError/ExecError subclass: those map to 400s; a shed must
    surface as a real 429, which clients retry.

    `trace_id` is the id the query would have run under (the API stamps
    it); the 429's body and X-Pilosa-Trace-Id header carry it, as the
    reference's do.

    `reason` is the shed taxonomy tag (rate | bytes | queue | deadline)
    and, when a tenant quota tripped, `quota_limit`/`quota_usage`/
    `quota_value` name the limit for the X-Pilosa-Quota-* response
    headers — so a client can tell "the node is overloaded" from "YOU
    are over YOUR quota" without reading /metrics."""

    def __init__(self, msg: str, retry_after: float = 1.0,
                 trace_id: str = "", reason: str = "",
                 quota_limit: str = "", quota_usage: float = 0.0,
                 quota_value: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after
        self.status = 429
        self.trace_id = trace_id
        self.reason = reason
        self.quota_limit = quota_limit
        self.quota_usage = quota_usage
        self.quota_value = quota_value


class _ShedInfo:
    """Everything a shed decision carries to _finish_admit: the human
    `why` for the message, the `reason` tag for sched.shed, the DERIVED
    Retry-After seconds (`after`; the shed-retry-after knob is applied
    as a floor at raise time), and the tripped quota's detail when one
    did."""

    __slots__ = ("why", "reason", "after", "limit", "usage", "value")

    def __init__(self, why: str, reason: str, after: float = 0.0,
                 limit: str = "", usage: float = 0.0, value: float = 0.0):
        self.why = why
        self.reason = reason
        self.after = after
        self.limit = limit
        self.usage = usage
        self.value = value


class Ticket:
    """A granted admission: holds one concurrency slot and the query's
    device-byte weight until release(). Context-manager friendly."""

    __slots__ = (
        "cls", "cost", "waited", "batchable", "index", "granted_at",
        "leg", "_controller", "_released", "_batch_done",
    )

    def __init__(self, controller: "AdmissionController", cls: str,
                 cost: QueryCost, waited: float, batchable: bool = False,
                 index: Optional[str] = None, granted_at: float = 0.0,
                 leg: bool = False):
        self._controller = controller
        self._released = False
        self._batch_done = False
        self.cls = cls
        self.cost = cost
        self.batchable = batchable
        self.index = index
        self.granted_at = granted_at  # controller-clock time of the grant
        self.leg = leg  # internal fan-out leg (separate admission lane)
        self.waited = waited  # seconds spent queued before the grant

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._controller._release(self)

    def done_batching(self) -> None:
        """Drop this query from the adaptive-batching load hint NOW —
        its batcher round is over, only result slicing/serialization
        remains, so it can no longer be anyone's batch mate. Leaving it
        counted until release() would make fresh Count leaders hold a
        window for mates that cannot arrive."""
        if self._released or self._batch_done or not self.batchable:
            return
        self._batch_done = True
        self._controller._release_batchable(self)

    def __enter__(self) -> "Ticket":
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()


class _Entry:
    __slots__ = (
        "cls", "cost", "deadline_at", "enq_at", "batchable", "index",
        "granted", "shed",
    )

    def __init__(self, cls: str, cost: QueryCost, deadline_at: Optional[float],
                 enq_at: float, batchable: bool = False,
                 index: Optional[str] = None):
        self.cls = cls
        self.cost = cost
        self.deadline_at = deadline_at
        self.enq_at = enq_at
        self.batchable = batchable
        self.index = index
        self.granted = False
        self.shed = False


class _ClassQueue:
    """One WFQ class's queue, with a SECOND-LEVEL start-time-fair queue
    (SFQ) keyed on index inside it: per-index FIFO sub-queues drained by
    the same virtual-clock machinery the classes use (equal weight 1 per
    index). A tenant flooding the class parks its excess behind its own
    virtual time — it gets every slot when alone (work-conserving), but
    the moment another index queues, grants interleave ~1:1 instead of
    draining the flood first. Not self-locking: the controller guards
    every call under sched.mu."""

    __slots__ = ("subs", "ivtime", "iglobal", "n")

    def __init__(self):
        # index -> FIFO of its entries; plain dict keeps deterministic
        # insertion-order iteration for tie-breaks
        self.subs: Dict[Optional[str], Deque[_Entry]] = {}
        self.ivtime: Dict[Optional[str], float] = {}
        self.iglobal = 0.0  # intra-class SFQ anchor (mirror of _vglobal)
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def _floor(self) -> float:
        active = [
            self.ivtime[k] for k, q in self.subs.items() if q
        ]
        return min(active) if active else 0.0

    def append(self, e: _Entry) -> None:
        q = self.subs.get(e.index)
        if q is None:
            q = self.subs[e.index] = deque()
        if not q:
            # a (re-)activating index competes from NOW — same no-banked-
            # credit rule as the class-level clocks
            self.ivtime[e.index] = max(
                self.ivtime.get(e.index, 0.0), self.iglobal, self._floor()
            )
        q.append(e)
        self.n += 1

    def _best_key(self) -> Optional[object]:
        """The index whose head would finish first in intra-class
        virtual time (equal weights: min ivtime). Returns a 1-tuple so
        a None index is distinguishable from 'queue empty'."""
        best = None
        best_v = 0.0
        for k, q in self.subs.items():
            if not q:
                continue
            v = self.ivtime[k]
            if best is None or v < best_v:
                best, best_v = (k,), v
        return best

    def head(self) -> Optional[_Entry]:
        best = self._best_key()
        return self.subs[best[0]][0] if best is not None else None

    def popleft(self) -> _Entry:
        best = self._best_key()
        if best is None:
            raise IndexError("pop from empty _ClassQueue")
        (k,) = best
        q = self.subs[k]
        e = q.popleft()
        self.n -= 1
        start = self.ivtime[k]
        self.iglobal = max(self.iglobal, start)
        self.ivtime[k] = start + 1.0
        if not q:
            self._retire_locked(k)
        return e

    def remove(self, e: _Entry) -> None:
        q = self.subs.get(e.index)
        if q is None:
            raise ValueError("entry not queued")
        q.remove(e)  # raises ValueError when absent
        self.n -= 1
        if not q:
            self._retire_locked(e.index)

    def purge_expired(self, now: float) -> List[_Entry]:
        """Pop expired sub-queue heads (consecutive ones per index) —
        the per-index mirror of the old class-FIFO head purge. Entries
        expiring behind a live head still wake via their own cv
        timeout."""
        out: List[_Entry] = []
        for k in list(self.subs):
            q = self.subs[k]
            while q and q[0].deadline_at is not None and q[0].deadline_at <= now:
                out.append(q.popleft())
                self.n -= 1
            if not q:
                self._retire_locked(k)
        return out

    def _retire_locked(self, k: Optional[str]) -> None:
        """A sub-queue drained: drop the deque, and prune its virtual
        time once it holds no banked debt (re-activation anchors to at
        least iglobal anyway) so tenant churn cannot grow the map."""
        del self.subs[k]
        if self.ivtime.get(k, 0.0) <= self.iglobal:
            self.ivtime.pop(k, None)

    def forget(self, index: str) -> None:
        """drop_index GC: forget a deleted index's banked virtual time
        (only when nothing of its is still queued)."""
        if index not in self.subs:
            self.ivtime.pop(index, None)


class AdmissionController:
    def __init__(
        self,
        max_concurrent: int = 16,
        queue_depth: int = 128,
        byte_budget: int = 0,  # 0 = follow devcache's HBM budget
        default_class: str = CLASS_INTERACTIVE,
        retry_after: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        tenants: Optional[TenantPolicy] = None,
        device_budget: Optional[Callable[[], int]] = None,
    ):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if default_class not in CLASS_WEIGHTS:
            # operator config (vs. request headers, which normalize):
            # silently promoting a typo like "bach" to interactive would
            # invert the intended deprioritization with no signal
            raise ValueError(
                f"unknown admission default class {default_class!r}; "
                f"expected one of {sorted(CLASS_WEIGHTS)}"
            )
        self.max_concurrent = max_concurrent
        self.max_queue_depth = max(0, queue_depth)
        self._byte_budget = byte_budget
        self.default_class = default_class
        self.retry_after = retry_after  # FLOOR for derived Retry-After
        # the device budget a byte_budget of 0 follows (the node passes
        # its holder's device cache budget); None: no byte gate
        self._device_budget = device_budget
        # per-index QoS policy (sched/tenants.py): rate buckets charged
        # before queueing, in-flight byte quota checked under sched.mu
        self.tenants = tenants
        self._clock = clock
        self._cv = threading.Condition(threading.Lock())
        self._queues: Dict[str, _ClassQueue] = {}
        self._vtime: Dict[str, float] = {c: 0.0 for c in CLASS_WEIGHTS}
        # global virtual clock: the start tag of the entry most recently
        # granted from the queue (SFQ). A class re-activating after idling
        # jumps UP to it (no banked advantage) and a class that banked
        # debt during a solo-saturation epoch is measured against it, so
        # its residual handicap is bounded by ~one service quantum instead
        # of growing without bound (no 429-starvation on re-entry).
        self._vglobal = 0.0
        self._inflight = 0
        self._inflight_bytes = 0
        # per-index in-flight byte attribution (both lanes; key None =
        # requests bound to no index, "-" in snapshots). Drained entries
        # stay at 0; only index deletion (drop_index) removes a key.
        self._inflight_bytes_index: Dict[Optional[str], int] = {}
        # EWMA of per-query service seconds (grant -> release), feeding
        # the early-shed deadline feasibility estimate (per lane: legs
        # run shard subsets, so their service time differs from whole
        # coordinator queries). The EWMA tracks the MEAN — a bimodal mix
        # (cheap Counts + occasional fat scans) averages to something no
        # actual query takes — so each lane also keeps a log-bucket
        # histogram and feasibility uses max(ewma, p95): the principled
        # tail estimate the flight-recorder histograms provide.
        self._svc_ewma = 0.0
        self._leg_svc_ewma = 0.0
        self._svc_hist = Histogram()
        self._leg_svc_hist = Histogram()
        # SEPARATE lane for internal fan-out legs (remote=True): a
        # coordinator holds its own node's slot while it blocks on its
        # legs, and each leg must be admitted on the peer — if legs
        # competed for the peers' coordinator slots, two nodes could
        # hold-and-wait on each other until every deadline expired
        # (distributed deadlock). Legs never fan out further (they run
        # local shards only), so a leg-only lane has no wait cycle; it
        # is bounded by the same cap/queue-depth and deadline-sheds the
        # same way. Waiters are a real FIFO: freed slots hand off to the
        # OLDEST waiter, so a steady arrival stream cannot starve a
        # parked leg past its deadline.
        self._inflight_leg = 0
        self._leg_waiters: Deque[_Entry] = deque()
        # batchable (pure-Count, batcher-eligible) queries in flight,
        # PER INDEX: the count batcher's adaptive-hold hint counts ONLY
        # these — Row/TopN/remote traffic can never join a count batch,
        # the batcher queues per index so other-index Counts are not
        # batch mates either, and an inflated hint would tax every solo
        # Count with a full hold window under mixed load
        self._inflight_batchable: Dict[Optional[str], int] = {}
        # queued counterpart kept as an O(1) counter — the hint is read
        # on the query hot path, and scanning whole queues under
        # sched.mu there would serialize admission behind it
        self._queued_batchable: Dict[Optional[str], int] = {}
        # optional HBM extent prefetcher (hbm/prefetch.py, wired by
        # NodeServer when hbm-prefetch-depth > 0): maybe_prefetch() peeks
        # the admitted queue and warms arrivals that are about to wait
        self.prefetcher = None
        # sheds by reason (rate | bytes | queue | deadline)
        self._shed: Dict[str, int] = {}
        _live_controllers.add(self)

    # -- public surface ----------------------------------------------------

    def normalize_class(self, raw: Optional[str]) -> str:
        raw = (raw or "").strip().lower()
        return raw if raw in CLASS_WEIGHTS else self.default_class

    def admit(
        self,
        cls: Optional[str] = None,
        cost: Optional[QueryCost] = None,
        deadline: Optional[float] = None,
        batchable: bool = False,
        index: Optional[str] = None,
        leg: bool = False,
    ) -> Ticket:
        """Block until the query may execute; returns the Ticket to
        release when it finishes. Raises ShedError (-> 429) when the
        queue is full or `deadline` (remaining seconds) cannot be met.
        `batchable` marks pure-Count queries eligible for the count
        batcher — only those feed the per-`index` adaptive-batching
        load hint. `leg` routes internal fan-out legs through their own
        lane (see __init__: sharing the coordinator slots would allow a
        distributed hold-and-wait deadlock)."""
        cost = cost or ZERO_COST
        cls = self.normalize_class(cls)
        t0 = self._clock()
        deadline_at = t0 + deadline if deadline is not None else None
        if deadline_at is not None and cost.transport_ms > 0.0:
            # collective-cost accounting (sched/cost.py): a granted query
            # still pays its mesh-collective / cross-group-leg transport
            # before results land, so it must START that much before its
            # deadline — feasibility and in-queue expiry both honor it
            deadline_at -= cost.transport_ms / 1000.0
        # tenant rate buckets charge BEFORE any queueing, on BOTH lanes:
        # a rate-limited tenant's queries must not hold queue slots while
        # they wait for tokens — occupying the bounded queue is exactly
        # the monopolization the limits exist to stop. The bucket's own
        # refill time is the informed Retry-After.
        if self.tenants is not None and index is not None:
            denial = self.tenants.acquire(index, cost.device_bytes)
            if denial is not None:
                shed = _ShedInfo(
                    f"index {index!r} over its {denial.limit} limit",
                    denial.reason, after=denial.retry_after,
                    limit=denial.limit, usage=denial.usage,
                    value=denial.value,
                )
                return self._finish_admit(
                    cls, cost, shed, 0.0, batchable, index, t0, leg=leg,
                )
        if leg:
            return self._admit_leg(
                cls, cost, deadline, deadline_at, t0, index
            )
        shed: Optional[_ShedInfo] = None
        waited = 0.0
        with self._cv:
            if deadline is not None and (
                deadline <= 0
                or (deadline_at is not None and deadline_at <= t0)
            ):
                # exhausted outright, or the transport bill alone
                # (collective + cross-group legs, sched/cost.py) already
                # exceeds it — no grant could land results in time
                shed = _ShedInfo(
                    "deadline already exhausted on arrival", "deadline"
                )
            else:
                # per-index in-flight byte quota: checked before the
                # fast path so an over-quota tenant cannot ride an idle
                # moment past its cap
                shed = self._tenant_inflight_shed_locked(index, cost)
            if shed is not None:
                pass
            elif (
                not self._queued_total_locked()
                and self._inflight < self.max_concurrent
                and self._bytes_ok_locked(cost)
            ):
                self._account_grant_locked(
                    cls, cost, queued=False, batchable=batchable, index=index
                )
            elif self._queued_total_locked() >= self.max_queue_depth:
                shed = _ShedInfo(
                    "admission queue full", "queue",
                    after=self._drain_estimate_locked(),
                )
            elif deadline_at is not None and not self._deadline_feasible_locked(
                deadline_at
            ):
                # EARLY shed: the learned service rate says this deadline
                # cannot be met from the back of the queue — reject NOW,
                # while the sender still has budget to re-map the leg to
                # a replica, instead of discovering the miss only when
                # the deadline expires
                shed = _ShedInfo(
                    "deadline cannot be met from the back of the queue",
                    "deadline", after=self._drain_estimate_locked(),
                )
            else:
                entry = _Entry(
                    cls, cost, deadline_at, t0, batchable=batchable,
                    index=index,
                )
                q = self._queues.get(cls)
                if q is None:
                    q = self._queues[cls] = _ClassQueue()
                if not q:
                    # a (re-)activating class competes from NOW: lift its
                    # virtual time to the global clock / live floor so an
                    # idle class banks no credit — and any debt banked
                    # during a solo-saturation epoch shrinks to ~1 quantum
                    self._vtime[cls] = max(
                        self._vtime[cls],
                        self._vglobal,
                        self._vtime_floor_locked(),
                    )
                q.append(entry)
                if entry.batchable:
                    self._queued_batchable[index] = (
                        self._queued_batchable.get(index, 0) + 1
                    )
                # work-conserving on ARRIVAL too: the fast path is
                # skipped whenever anything is queued, but this entry
                # (or another class's head) may fit right now — e.g. a
                # cheap query arriving behind a byte-gated fat head
                # with slots free must not wait for a release
                self._pump_locked()
                while not entry.granted and not entry.shed:
                    timeout = None
                    if entry.deadline_at is not None:
                        timeout = entry.deadline_at - self._clock()
                        if timeout <= 0:
                            break
                    self._cv.wait(timeout)
                if not entry.granted:
                    # deadline ran out in the queue (or a pump pass
                    # already purged us): drop the entry — a shed query
                    # must never leave a queue residue — and pump: our
                    # departure may unblock entries behind us (e.g. a
                    # byte-gated fat head expiring with cheap queries
                    # queued after it)
                    try:
                        self._queues[cls].remove(entry)
                        self._dequeued_batchable_locked(entry)
                    except (KeyError, ValueError):
                        pass
                    self._pump_locked()
                    shed = _ShedInfo(
                        "deadline cannot be met in queue", "deadline",
                        after=self._svc_estimate_locked(
                            self._svc_ewma, self._svc_hist
                        ),
                    )
                else:
                    waited = self._clock() - t0
        return self._finish_admit(
            cls, cost, shed, waited, batchable, index, t0
        )

    def _admit_leg(
        self,
        cls: str,
        cost: QueryCost,
        deadline: Optional[float],
        deadline_at: Optional[float],
        t0: float,
        index: Optional[str] = None,
    ) -> Ticket:
        """Internal fan-out legs: own concurrency lane (same cap and
        waiting bound, FIFO, deadline-aware) so legs never compete with
        coordinator slots — legs run local shards only, so this lane has
        no wait cycle and always drains. Tenant limits are enforced here
        too (rate buckets already charged by admit(); the in-flight byte
        quota below): each node polices its own slice of a fan-out, so
        an abusive tenant's legs shed at the peers as well."""
        shed: Optional[_ShedInfo] = None
        waited = 0.0
        with self._cv:
            if deadline is not None and (
                deadline <= 0
                or (deadline_at is not None and deadline_at <= t0)
            ):
                shed = _ShedInfo(
                    "deadline already exhausted on arrival", "deadline"
                )
            else:
                shed = self._tenant_inflight_shed_locked(
                    index, cost, leg=True
                )
            if shed is not None:
                pass
            elif (
                self._inflight_leg < self.max_concurrent
                and not self._leg_waiters
            ):
                self._inflight_leg += 1
                # legs ACCOUNT bytes (so public admission sees the real
                # HBM pressure where shard work actually lands) but are
                # never byte-GATED: a leg waiting on bytes held by a
                # coordinator that is itself waiting on remote legs
                # would recreate the cross-node hold-and-wait cycle
                self._inflight_bytes += cost.device_bytes
                self._bump_index_bytes_locked(index, cost.device_bytes)
            elif len(self._leg_waiters) >= self.max_queue_depth:
                shed = _ShedInfo(
                    "internal-leg queue full", "queue",
                    after=self._drain_estimate_locked(leg=True),
                )
            elif deadline_at is not None and not self._leg_feasible_locked(
                deadline_at
            ):
                # EARLY shed — this is the lane X-Pilosa-Deadline
                # actually arrives on: reject while the SENDER still has
                # budget to re-map the leg to a replica, instead of
                # burning its whole budget to learn the miss at expiry
                shed = _ShedInfo(
                    "deadline cannot be met from the back of the queue",
                    "deadline", after=self._drain_estimate_locked(leg=True),
                )
            else:
                # strict FIFO handoff: grants come only from
                # _pump_legs_locked popping the HEAD, so a new arrival
                # can never beat an earlier parked waiter to a freed
                # slot — a steady stream would otherwise win every
                # post-release race and starve waiters past deadline
                entry = _Entry(cls, cost, deadline_at, t0, index=index)
                self._leg_waiters.append(entry)
                while not entry.granted and not entry.shed:
                    timeout = None
                    if entry.deadline_at is not None:
                        timeout = entry.deadline_at - self._clock()
                        if timeout <= 0:
                            break
                    self._cv.wait(timeout)
                if not entry.granted:
                    try:
                        self._leg_waiters.remove(entry)
                    except ValueError:
                        pass
                    shed = _ShedInfo(
                        "deadline cannot be met in queue", "deadline",
                        after=self._svc_estimate_locked(
                            self._leg_svc_ewma, self._leg_svc_hist
                        ),
                    )
                else:
                    waited = self._clock() - t0
        return self._finish_admit(
            cls, cost, shed, waited, batchable=False, index=index,
            t0=t0, leg=True,
        )

    def _finish_admit(
        self,
        cls: str,
        cost: QueryCost,
        shed: Optional[_ShedInfo],
        waited: float,
        batchable: bool,
        index: Optional[str],
        t0: float,
        leg: bool = False,
    ) -> Ticket:
        if shed is not None:
            # the knob is a floor under the derived constraint time
            retry = max(self.retry_after, shed.after)
            with self._cv:
                self._shed[shed.reason] = self._shed.get(shed.reason, 0) + 1
            raise ShedError(
                f"query shed ({shed.why}); retry after {retry:g}s",
                retry_after=retry, reason=shed.reason,
                quota_limit=shed.limit, quota_usage=shed.usage,
                quota_value=shed.value,
            )
        return Ticket(
            self, cls, cost, waited, batchable=batchable, index=index,
            granted_at=t0 + waited, leg=leg,
        )

    def _pump_legs_locked(self) -> None:
        """FIFO grant for the leg lane: freed slots go to the oldest
        live waiter; expired heads are purged (their waiter raises)."""
        now = self._clock()
        touched = False
        while self._inflight_leg < self.max_concurrent and self._leg_waiters:
            head = self._leg_waiters.popleft()
            touched = True
            if head.deadline_at is not None and head.deadline_at <= now:
                head.shed = True
                continue
            head.granted = True
            self._inflight_leg += 1
            self._inflight_bytes += head.cost.device_bytes
            self._bump_index_bytes_locked(
                head.index, head.cost.device_bytes
            )
        if touched:
            self._cv.notify_all()

    def _release(self, ticket: Ticket) -> None:
        if ticket.leg:
            with self._cv:
                self._inflight_leg -= 1
                self._inflight_bytes -= ticket.cost.device_bytes
                self._bump_index_bytes_locked(
                    ticket.index, -ticket.cost.device_bytes
                )
                dt = max(0.0, self._clock() - ticket.granted_at)
                self._leg_svc_ewma = (
                    dt
                    if self._leg_svc_ewma <= 0.0
                    else 0.8 * self._leg_svc_ewma + 0.2 * dt
                )
                self._leg_svc_hist.observe(dt)
                self._pump_legs_locked()
                # freed leg bytes may unblock byte-gated PUBLIC heads
                self._pump_locked()
                self._cv.notify_all()
            return
        with self._cv:
            self._inflight -= 1
            self._inflight_bytes -= ticket.cost.device_bytes
            self._bump_index_bytes_locked(
                ticket.index, -ticket.cost.device_bytes
            )
            if ticket.batchable and not ticket._batch_done:
                self._drop_batchable_locked(ticket.index)
            # learned service time drives the early-shed feasibility check
            dt = max(0.0, self._clock() - ticket.granted_at)
            self._svc_ewma = (
                dt
                if self._svc_ewma <= 0.0
                else 0.8 * self._svc_ewma + 0.2 * dt
            )
            self._svc_hist.observe(dt)
            self._pump_locked()
            self._cv.notify_all()

    def _drop_batchable_locked(self, index: Optional[str]) -> None:
        left = self._inflight_batchable.get(index, 0) - 1
        if left > 0:
            self._inflight_batchable[index] = left
        else:
            self._inflight_batchable.pop(index, None)

    def _dequeued_batchable_locked(self, entry: _Entry) -> None:
        """Keep the O(1) queued-batchable counter in step with every
        path that removes an entry from a class queue."""
        if not entry.batchable:
            return
        left = self._queued_batchable.get(entry.index, 0) - 1
        if left > 0:
            self._queued_batchable[entry.index] = left
        else:
            self._queued_batchable.pop(entry.index, None)

    def _release_batchable(self, ticket: Ticket) -> None:
        """Ticket.done_batching(): the hint-relevant part of the query
        is over even though the slot is still held."""
        with self._cv:
            self._drop_batchable_locked(ticket.index)

    def maybe_prefetch(
        self,
        warm: Optional[Callable[[], None]],
        index: Optional[str] = None,
    ) -> bool:
        """Admitted-queue peek feeding the HBM prefetcher: when a new
        arrival would WAIT (slots full or a queue already formed), its
        warm closure — a stage-only lowering, Executor.warm — is offered
        to the background prefetcher so the query's operand extents ride
        PCIe while the current dispatch occupies the device. Queries that
        would take the fast path are never offered: they are about to
        stage for themselves anyway. Returns True when offered. The peek
        is racy by design — warming an extent twice is a cache hit, and
        warming for a query that got in anyway costs nothing. A tenant
        currently out of rate tokens is never warmed: its queries are
        about to shed, and the stage would spend PCIe (and evict
        in-quota tenants' residency) on work that will not run."""
        if warm is None or self.prefetcher is None:
            return False
        if self.tenants is not None and self.tenants.throttled(index):
            return False
        with self._cv:
            would_wait = (
                self._queued_total_locked() > 0
                or self._inflight >= self.max_concurrent
            )
        if not would_wait:
            return False
        # offer OUTSIDE sched.mu: the prefetcher takes its own lock and
        # admission must never serialize behind another subsystem's mutex
        return self.prefetcher.offer(warm)

    def queue_depth(self) -> int:
        with self._cv:
            return self._queued_total_locked()

    def load(self, index: Optional[str] = None) -> int:
        """BATCHABLE queries on `index` that could line up behind a batch
        leader — the adaptive-batching hint fed to exec/batcher.py's
        CountBatcher (which queues per index). Only batcher-eligible
        (pure-Count, same-index) traffic counts: Row/TopN/remote queries
        and other indexes' Counts can never join this batch, and
        inflating the hint with them would tax every solo Count a full
        hold window under mixed load. Capped at max_concurrent: queued
        queries hold no ticket, so at most the concurrency cap's worth
        of calls can ever reach the batcher simultaneously."""
        with self._cv:
            return min(
                self._inflight_batchable.get(index, 0)
                + self._queued_batchable.get(index, 0),
                self.max_concurrent,
            )

    def pending(self) -> Tuple[int, int]:
        """(queued, inflight) across BOTH lanes (leak-guard surface)."""
        with self._cv:
            return (
                self._queued_total_locked() + len(self._leg_waiters),
                self._inflight + self._inflight_leg,
            )

    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "inflight": self._inflight,
                "inflightBytes": self._inflight_bytes,
                "inflightBytesByIndex": {
                    (k if k is not None else "-"): v
                    for k, v in self._inflight_bytes_index.items()
                    if v > 0
                },
                "inflightLegs": self._inflight_leg,
                "waitingLegs": len(self._leg_waiters),
                "queued": {
                    cls: len(q) for cls, q in self._queues.items() if q
                },
                "maxConcurrent": self.max_concurrent,
                "queueDepth": self.max_queue_depth,
                "byteBudget": self._effective_byte_budget(),
                "shed": dict(self._shed),
            }

    # -- internals (all *_locked run under self._cv) -----------------------

    def _effective_byte_budget(self) -> int:
        if self._byte_budget > 0:
            return self._byte_budget
        if self._device_budget is not None:
            return int(self._device_budget())
        return 1 << 62

    def _bytes_ok_locked(self, cost: QueryCost) -> bool:
        budget = self._effective_byte_budget()
        if cost.device_bytes > budget:
            # a query heavier than the whole budget still runs — alone
            # w.r.t. BYTES (byte-weightless writes may share) — exactly
            # like devcache admits a single over-budget entry
            return self._inflight_bytes == 0
        return self._inflight_bytes + cost.device_bytes <= budget

    def _fits_with_reservation_locked(
        self, cost: QueryCost, reserved: QueryCost
    ) -> bool:
        """May this entry be granted while `reserved` (a byte-gated WFQ
        head) waits for bytes? Zero-byte work always may (it cannot
        delay the head); byte-weighted work only if it leaves the head's
        earmark intact — which, while the head is actually gated, it
        cannot, so the earmark drains and the head is never starved."""
        if cost.device_bytes == 0:
            return True
        return (
            self._inflight_bytes
            + cost.device_bytes
            + reserved.device_bytes
            <= self._effective_byte_budget()
        )

    def _queued_total_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _vtime_floor_locked(self) -> float:
        active = [
            self._vtime[cls] for cls, q in self._queues.items() if q
        ]
        return min(active) if active else 0.0

    def _account_grant_locked(
        self, cls: str, cost: QueryCost, queued: bool, batchable: bool,
        index: Optional[str],
    ) -> None:
        self._inflight += 1
        self._inflight_bytes += cost.device_bytes
        self._bump_index_bytes_locked(index, cost.device_bytes)
        if batchable:
            self._inflight_batchable[index] = (
                self._inflight_batchable.get(index, 0) + 1
            )
        if queued:
            # WFQ credit is consumed only by CONTENDED grants: advancing
            # virtual time on uncontended fast-path grants would bank a
            # huge lag for whichever class idles, inverting the priority
            # order for many rounds at the moment contention starts.
            # The global clock advances to the granted entry's start tag
            # (SFQ), anchoring later (re-)activations.
            start = self._vtime.get(cls, 0.0)
            self._vglobal = max(self._vglobal, start)
            self._vtime[cls] = start + 1.0 / CLASS_WEIGHTS[cls]

    def _pump_locked(self) -> None:
        """Grant queued entries while capacity allows, WFQ order: the
        class whose head would FINISH first in virtual time (vtime +
        1/weight) wins — interactive's small increments beat batch's big
        ones whenever both queues are non-empty. A byte-gated head
        blocks only ITS class (per-class FIFO preserved) and RESERVES
        its bytes: byte-weightless entries from other classes are still
        granted (work-conserving for writes), but byte-weighted ones
        must not eat the earmark — otherwise a steady cheap stream
        could refill the budget forever and starve the gated head.
        Within the winning class, the head is the second-level SFQ's
        pick (_ClassQueue): the index whose virtual time is lowest, so
        same-class tenants drain fair instead of FIFO."""
        now = self._clock()
        granted_any = False
        byte_blocked: set = set()
        reserved: Optional[QueryCost] = None
        while self._inflight < self.max_concurrent:
            best_cls = None
            best_finish = 0.0
            for cls, q in self._queues.items():
                if cls in byte_blocked:
                    continue
                for expired in q.purge_expired(now):
                    self._dequeued_batchable_locked(expired)
                    expired.shed = True  # its waiter raises ShedError
                    granted_any = True  # wake it
                if not q:
                    continue
                finish = self._vtime[cls] + 1.0 / CLASS_WEIGHTS[cls]
                if best_cls is None or finish < best_finish:
                    best_cls, best_finish = cls, finish
            if best_cls is None:
                break
            head = self._queues[best_cls].head()
            if not self._bytes_ok_locked(head.cost):
                if reserved is None:
                    reserved = head.cost  # earmark its bytes
                byte_blocked.add(best_cls)
                continue  # other classes may still have grantable heads
            if reserved is not None and not self._fits_with_reservation_locked(
                head.cost, reserved
            ):
                byte_blocked.add(best_cls)
                continue
            self._queues[best_cls].popleft()
            self._dequeued_batchable_locked(head)
            head.granted = True
            self._account_grant_locked(
                best_cls,
                head.cost,
                queued=True,
                batchable=head.batchable,
                index=head.index,
            )
            granted_any = True
        if granted_any:
            self._cv.notify_all()

    def _svc_estimate_locked(self, ewma: float, hist: Histogram) -> float:
        """Per-query service estimate for feasibility: the EWMA mean,
        lifted by the histogram's p95 when the tail runs heavier than
        the mean (a bimodal cheap/fat mix must not promise the cheap
        queries' latency to a deadline that will land behind a fat one)."""
        if hist.count == 0:
            return ewma
        return max(ewma, hist.quantile(0.95))

    def _deadline_feasible_locked(self, deadline_at: float) -> bool:
        """Can a query joining the back of the queue RIGHT NOW plausibly
        start before `deadline_at`? Uses the learned per-query service
        estimate (EWMA floor-lifted by the service histogram's p95):
        `ahead` queries drain over max_concurrent lanes, so the expected
        wait is ~rounds x svc. Conservative on purpose — with no history
        every deadline is feasible, and a feasible verdict only means
        "queue and see" (the in-queue expiry check still sheds a miss);
        an infeasible verdict sheds immediately so the sender re-maps
        while it still has deadline budget."""
        svc = self._svc_estimate_locked(self._svc_ewma, self._svc_hist)
        if svc <= 0.0:
            return True
        ahead = self._queued_total_locked() + self._inflight
        rounds = (ahead + self.max_concurrent - 1) // self.max_concurrent
        return self._clock() + rounds * svc <= deadline_at

    def _leg_feasible_locked(self, deadline_at: float) -> bool:
        """Leg-lane counterpart of _deadline_feasible_locked, against the
        leg service estimate (legs run shard subsets — different timings)."""
        svc = self._svc_estimate_locked(
            self._leg_svc_ewma, self._leg_svc_hist
        )
        if svc <= 0.0:
            return True
        ahead = len(self._leg_waiters) + self._inflight_leg
        rounds = (ahead + self.max_concurrent - 1) // self.max_concurrent
        return self._clock() + rounds * svc <= deadline_at

    def _drain_estimate_locked(self, leg: bool = False) -> float:
        """Queue-drain time estimate for a shed's Retry-After: the work
        ahead drains over max_concurrent lanes at the learned service
        rate — the same arithmetic the feasibility checks run, turned
        into 'when a retry plausibly fits'. 0 with no history (the
        shed-retry-after knob floors it)."""
        if leg:
            svc = self._svc_estimate_locked(
                self._leg_svc_ewma, self._leg_svc_hist
            )
            ahead = len(self._leg_waiters) + self._inflight_leg
        else:
            svc = self._svc_estimate_locked(self._svc_ewma, self._svc_hist)
            ahead = self._queued_total_locked() + self._inflight
        if svc <= 0.0:
            return 0.0
        rounds = (ahead + self.max_concurrent - 1) // self.max_concurrent
        return max(1, rounds) * svc

    def _tenant_inflight_shed_locked(
        self, index: Optional[str], cost: QueryCost, leg: bool = False
    ) -> Optional[_ShedInfo]:
        """Per-index in-flight device-byte quota (sched/tenants.py).
        A single query whose estimate exceeds the whole quota still
        runs — alone w.r.t. its own tenant's bytes — the same
        single-oversized-entry rule the global byte budget and devcache
        apply; otherwise that tenant could never run it at all."""
        if self.tenants is None or index is None:
            return None
        if cost.device_bytes <= 0:
            return None
        quota = self.tenants.limits(index).inflight_bytes
        if quota <= 0:
            return None
        held = self._inflight_bytes_index.get(index, 0)
        if cost.device_bytes > quota:
            if held == 0:
                return None
        elif held + cost.device_bytes <= quota:
            return None
        if leg:
            svc = self._svc_estimate_locked(
                self._leg_svc_ewma, self._leg_svc_hist
            )
        else:
            svc = self._svc_estimate_locked(self._svc_ewma, self._svc_hist)
        return _ShedInfo(
            f"index {index!r} over its inflight-bytes quota",
            "bytes", after=svc, limit="inflight-bytes",
            usage=float(held), value=float(quota),
        )

    def _bump_index_bytes_locked(
        self, index: Optional[str], delta: int
    ) -> None:
        """Per-index in-flight byte account (both lanes). A drained
        index stays in the map at 0 (only drop_index removes keys)."""
        if not delta:
            return
        cur = self._inflight_bytes_index.get(index)
        if cur is None:
            if delta < 0:
                # a release landing after drop_index (the index was
                # deleted with this query in flight): keep it forgotten
                return
            cur = 0
        self._inflight_bytes_index[index] = max(0, cur + delta)

    def drop_index(self, index: str) -> None:
        """The node's index delete: forget a deleted index's byte
        attribution and its banked intra-class SFQ virtual time.
        In-flight queries on it decrement into an absent key afterwards,
        which _bump_index_bytes_locked ignores."""
        with self._cv:
            self._inflight_bytes_index.pop(index, None)
            for cq in self._queues.values():
                cq.forget(index)
        if self.tenants is not None:
            # tenants.mu is taken AFTER sched.mu is released (lock
            # ordering: admission calls into the policy with sched.mu
            # free on the bucket path too)
            self.tenants.drop_index(index)

    def inflight_bytes_by_index(self) -> Dict[str, int]:
        """Snapshot of per-index in-flight bytes."""
        with self._cv:
            return {
                (k if k is not None else "-"): v
                for k, v in self._inflight_bytes_index.items()
            }
