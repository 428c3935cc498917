"""Cross-request Count batching: group commit of concurrent Count queries
into one multi-root dispatch.

The port of pilosa_tpu/exec/batcher.py. The executor folds adjacent
Counts within one request into one MultiCountPlan (one plan_count_multi
launch, exec/plan.py); this module extends that across requests. The
first query to arrive executes at once as the leader, so an idle server
adds no latency; queries arriving while its dispatch runs queue, and
when it finishes the queue executes as one merged multi-Count request,
each caller getting its slice of the results. Batch size follows load,
as group commit batches WAL writers.

Leadership is handed off: a leader runs its own query, then ONE snapshot
of the waiters behind it, then promotes the first later arrival instead
of looping, so no client serves everyone else's queries for long. When
the admission controller reports batchable queries in flight
(`load_hint`), a fresh leader holds its dispatch up to `hold_timeout`
for them to line up. Rounds split by lowering class (`classify`). A
merged round that fails on a query's own error (a missing field, a bad
argument) re-runs each waiter alone, so one bad query fails only itself;
any other failure (a kernel that does not build or launch, a CUDA error)
is the device's and fails every waiter of the round, never served
instead by per-query launches.

The reference pads a merged round to a power of two with all-zero
`Count(Difference())` lanes so XLA compiles one program per size family;
plan_count_multi is a hand-written kernel with no compile cache, so the
port merges exactly the calls it was given.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from pilosa_tpu_torch.core.translate import TranslateError
from pilosa_tpu_torch.exec.executor import ExecError
from pilosa_tpu_torch.exec.translation import TranslationError
from pilosa_tpu_torch.pql import Query
from pilosa_tpu_torch.utils.stats import Histogram

# the most calls merged into one execution: bounds result-slicing latency
# for the earliest waiter under fan-in (one plan_count_multi launch holds
# 64 roots)
MAX_BATCH_CALLS = 64

# errors that belong to one query of a merged round: lowering's and
# translation's. A RuntimeError (a kernel launch, CUDA, out of memory) is
# none of them.
QUERY_ERRORS = (ExecError, TranslationError, TranslateError, ValueError, LookupError, TypeError)

STATS = {"leader": 0, "batched": 0, "merged_execs": 0, "fallback_splits": 0}
_STATS_MU = threading.Lock()


def _bump(key: str) -> None:
    with _STATS_MU:  # request threads bump concurrently; tests read exact totals
        STATS[key] += 1


def reset_stats() -> None:
    with _STATS_MU:
        for k in STATS:
            STATS[k] = 0


def batchable(query: Query) -> bool:
    """Only plain read Counts merge: every call `Count(<one child>)`."""
    return bool(query.calls) and all(c.name == "Count" and len(c.children) == 1 for c in query.calls)


def batch_eligible(query, shards, opt) -> bool:
    """Whether a request is routed through the batcher: the one predicate
    the API's routing (_query_batched) and its admission hint (_admit)
    share."""
    return (
        shards is None
        and not opt.remote
        and not opt.column_attrs
        and not opt.exclude_row_attrs
        and not opt.exclude_columns
        and isinstance(query, Query)
        and batchable(query)
    )


class _Waiter:
    __slots__ = ("query", "event", "results", "error", "promoted", "cls")

    def __init__(self, query: Query, cls=None):
        self.query = query
        self.event = threading.Event()
        self.results = None
        self.error = None
        self.promoted = False  # woken to take over leadership
        self.cls = cls  # lowering class: different classes never merge


class CountBatcher:
    """Per-index group-commit batcher. `run(index, query, execute)` calls
    `execute(merged_query)`, which must return one result per call (the
    API binds it to the executor)."""

    def __init__(self):
        self._mu = threading.Lock()
        # signalled whenever a waiter enqueues: the leader's hold sleeps on it
        self._arrived = threading.Condition(self._mu)
        self._busy: Dict[str, bool] = {}
        self._queue: Dict[str, Deque[_Waiter]] = {}
        # load_hint(index): batchable queries on `index` the admission
        # controller holds (in flight or queued), the batch mates a fresh
        # leader may wait for, at most hold_timeout seconds
        self.load_hint: Optional[Callable[[str], int]] = None
        self.hold_timeout: float = 0.005
        # calls per executed round
        self.batch_sizes = Histogram()
        self._sizes_mu = threading.Lock()
        # classify(index, query) -> hashable lowering class; rounds run
        # per class. None: one class. Never fails a query.
        self.classify: Optional[Callable[[str, Query], object]] = None

    def _class_of(self, index: str, query: Query):
        if self.classify is None:
            return None
        try:
            return self.classify(index, query)
        except Exception:  # noqa: BLE001 - classification is advisory
            return None

    def run(self, index: str, query: Query, execute: Callable[[Query], list]):
        cls = self._class_of(index, query)
        with self._mu:
            if self._busy.get(index):
                w = _Waiter(query, cls)
                self._queue.setdefault(index, deque()).append(w)
                self._arrived.notify_all()
            else:
                self._busy[index] = True
                w = None
        if w is not None:
            w.event.wait()
            if w.promoted:
                # leads the next round, merged with its own query
                _bump("leader")
                self._serve_round(index, execute, first=w)
            else:
                _bump("batched")
            if w.error is not None:
                raise w.error
            return w.results
        # leadership taken: only now read the load hint (once a round)
        target = 0
        if self.load_hint is not None:
            try:
                target = min(int(self.load_hint(index)), MAX_BATCH_CALLS)
            except Exception:  # noqa: BLE001 - a hint never fails a query
                target = 0
        if target >= 2:
            # hold, bounded, until `target` queries (the hint's unit) line up
            lead = _Waiter(query, cls)
            deadline = time.monotonic() + self.hold_timeout
            with self._mu:
                while 1 + len(self._queue.get(index, ())) < target:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._arrived.wait(remaining)
            _bump("leader")
            self._serve_round(index, execute, first=lead)
            if lead.error is not None:
                raise lead.error
            return lead.results
        return self._lead(index, query, execute)

    def _lead(self, index: str, query: Query, execute):
        _bump("leader")
        self._record_round(len(query.calls))
        try:
            return execute(query)
        finally:
            self._serve_round(index, execute)

    def _serve_round(self, index: str, execute, first: Optional[_Waiter] = None) -> None:
        """Serve the waiters present now (MAX_BATCH_CALLS-sized merges per
        lowering class, in arrival order, `first` ahead), then hand
        leadership to the first later arrival or free the index."""
        with self._mu:
            round_ = self._queue.get(index) or deque()
            self._queue[index] = deque()
        if first is not None:
            round_.appendleft(first)
        by_cls: Dict[object, Deque[_Waiter]] = {}
        order: List[object] = []
        for wtr in round_:
            if wtr.cls not in by_cls:
                by_cls[wtr.cls] = deque()
                order.append(wtr.cls)
            by_cls[wtr.cls].append(wtr)
        for cls in order:
            bucket = by_cls[cls]
            while bucket:
                batch: List[_Waiter] = []
                n = 0
                while bucket and n + len(bucket[0].query.calls) <= MAX_BATCH_CALLS:
                    wtr = bucket.popleft()
                    batch.append(wtr)
                    n += len(wtr.query.calls)
                if not batch:  # one oversized query: alone
                    batch = [bucket.popleft()]
                self._run_batch(batch, execute)
        with self._mu:
            queued = self._queue.get(index)
            if queued:
                nxt = queued.popleft()
                nxt.promoted = True
                nxt.event.set()  # takes over; _busy stays held
            else:
                self._queue.pop(index, None)
                self._busy.pop(index, None)

    def _record_round(self, n_calls: int) -> None:
        with self._sizes_mu:
            self.batch_sizes.observe(float(n_calls))

    def _run_batch(self, batch: List[_Waiter], execute) -> None:
        if len(batch) == 1:
            w = batch[0]
            self._record_round(len(w.query.calls))
            try:
                w.results = execute(w.query)
            except Exception as e:  # noqa: BLE001 - delivered to the waiter
                w.error = e
            w.event.set()
            return
        calls = [c for w in batch for c in w.query.calls]
        self._record_round(len(calls))
        try:
            _bump("merged_execs")
            res = execute(Query(calls=calls))
            k = 0
            for w in batch:
                n = len(w.query.calls)
                w.results = res[k : k + n]
                k += n
                w.event.set()
        except QUERY_ERRORS:
            # error isolation: one bad query must not fail its batch mates
            _bump("fallback_splits")
            for w in batch:
                try:
                    w.results = execute(w.query)
                except Exception as e:  # noqa: BLE001
                    w.error = e
                w.event.set()
        except Exception as e:  # noqa: BLE001 - the device's: every waiter gets it
            for w in batch:
                if w.results is None:
                    w.error = e
                    w.event.set()
