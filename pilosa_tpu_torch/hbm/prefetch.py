"""Background extent prefetcher: stage the next query's operands while
the current query's kernels run.

The port of pilosa_tpu/hbm/prefetch.py. Kernel launches serialize behind
exec/plan.py's dispatch lock, but staging does not, so while one query
holds the card a queued query's extents can be copied in. The admission
controller feeds it (sched/admission.py `maybe_prefetch`): when its peek
says an arrival will wait, the arrival's warm closure (Executor.warm, a
lowering with no dispatch) is offered here.

One worker and a bounded queue: one thread does not compete with the
query threads for the host, and a full queue drops its oldest offer
instead of piling up stale warms. `offer` never blocks; the worker
swallows every task error (a warm is an optimization, never a failure).
A warm costs host time even where it finds every operand resident, and
a server whose operands stay resident is bound by that host time: after
IDLE_STREAK warms in a row that warmed nothing (a task returning 0), the
prefetcher takes one offer in BACKOFF_EVERY, until a warm stages again.
The worker runs under `residency.prefetching()`, so what it stages and
the queries' later hits on it are counted.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Optional

from pilosa_tpu_torch.hbm import residency

IDLE_STREAK = 16
BACKOFF_EVERY = 16


class Prefetcher:
    def __init__(self, depth: int = 4, logger: Optional[Callable[[str], None]] = None) -> None:
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.depth = depth
        self.logger = logger or (lambda msg: None)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._q: Deque[Callable[[], Optional[int]]] = deque()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        self.offered = 0
        self.dropped = 0
        self.skipped = 0  # offers declined while backing off
        self.warmed = 0  # tasks run to their end
        self._idle = 0  # tasks in a row that returned 0
        self._declined = 0

    def start(self) -> "Prefetcher":
        with self._mu:
            if self._thread is not None:
                return self
            self._closing = False
            t = self._thread = threading.Thread(target=self._run, name="hbm-prefetch", daemon=True)
        t.start()
        return self

    def stop(self) -> None:
        with self._mu:
            self._closing = True
            self._q.clear()
            self._cv.notify_all()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def offer(self, warm: Callable[[], Optional[int]]) -> bool:
        """Enqueue a warm task (it returns the trees it warmed: 0 when
        every operand was resident); never blocks. A full queue drops its
        oldest offer: the newest queued query is the likeliest to still
        be waiting when its extents land. False: not taken (closed, or
        backing off)."""
        with self._mu:
            if self._closing or self._thread is None:
                return False
            self.offered += 1
            if self._idle >= IDLE_STREAK:
                self._declined += 1
                if self._declined % BACKOFF_EVERY:
                    self.skipped += 1
                    return False
            if len(self._q) >= self.depth:
                self._q.popleft()
                self.dropped += 1
            self._q.append(warm)
            self._cv.notify()
            return True

    def idle(self) -> bool:
        with self._mu:
            return not self._q

    def _run(self) -> None:
        while True:
            with self._mu:
                while not self._q and not self._closing:
                    self._cv.wait()
                if self._closing:
                    return
                task = self._q.popleft()
            try:
                with residency.prefetching():
                    n = task()
                with self._mu:
                    self.warmed += 1
                    self._idle = self._idle + 1 if n == 0 else 0
            except Exception as e:  # noqa: BLE001 - warming never fails anything
                self.logger(f"hbm prefetch task error: {e!r}")
