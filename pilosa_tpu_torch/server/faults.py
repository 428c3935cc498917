"""Transport fault tolerance for the internode plane, and deterministic
fault injection.

The port of pilosa_tpu/server/faults.py, its HTTP half:

- `RetryPolicy`: exponential backoff with seeded jitter, and a
  per-request `DeadlineBudget` that every attempt and every backoff
  sleep of one logical RPC shares.
- `CircuitBreaker` / `BreakerRegistry`: one closed -> open -> half-open
  state machine per peer URI, consulted by InternalClient._do and by
  the distributed executor's failover.
- `FaultInjector`: a test hook on InternalClient that injects connection
  refusals, timeouts, slow responses, HTTP 500s and per-peer partitions
  from countable rules and a seeded RNG, so a chaos scenario replays.

Connection-level failures, timeouts and 5xx (and 408/429) are
retryable; other 4xx and remote payload errors are not: failover cannot
fix a bad request. Every clock and sleep is injectable. The reference's
WAL and object-store rules and the "kill" rule wait for the port's fault
plane; locks are plain `threading.Lock`s (no lock tracking) and no
counters are kept.
"""

from __future__ import annotations

import io
import random
import threading
import time
import urllib.error
from typing import Callable, Dict, List, Optional, Tuple

# breaker states (reference naming: closed = healthy, open = fast-fail,
# half-open = single probe allowed after the cooldown)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


def retryable_status(code: int) -> bool:
    """5xx means the peer (or its executor) choked — retry/fail over.
    408/429 are explicit try-again signals. Everything else in 4xx is a
    caller bug no amount of retrying fixes."""
    return code >= 500 or code in (408, 429)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


class DeadlineBudget:
    """Monotonic per-request budget shared by every attempt (and every
    backoff sleep) of one logical RPC."""

    __slots__ = ("total", "_clock", "_start")

    def __init__(self, total: float, clock: Callable[[], float] = time.monotonic):
        self.total = float(total)
        self._clock = clock
        self._start = clock()

    def elapsed(self) -> float:
        return self._clock() - self._start

    def remaining(self) -> float:
        return max(0.0, self.total - self.elapsed())

    def expired(self) -> bool:
        return self.total - self.elapsed() <= 0.0


class RetryPolicy:
    """Exponential backoff with seeded jitter.

    `backoff(attempt)` is the sleep before retry number `attempt` (the
    1-based count of attempts already made): base * multiplier^(attempt-1)
    capped at max_backoff, scaled into [(1-jitter)*full, full] by the
    seeded RNG so concurrent retries decorrelate reproducibly."""

    def __init__(
        self,
        max_attempts: int = 3,
        base_backoff: float = 0.05,
        max_backoff: float = 2.0,
        multiplier: float = 2.0,
        jitter: float = 0.5,
        seed: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("retry max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_backoff = base_backoff
        self.max_backoff = max_backoff
        self.multiplier = multiplier
        self.jitter = jitter
        self.clock = clock
        self.sleep = sleep
        self._mu = threading.Lock()
        self._rng = random.Random(seed)

    def backoff(self, attempt: int) -> float:
        full = min(
            self.max_backoff,
            self.base_backoff * (self.multiplier ** max(0, attempt - 1)),
        )
        if self.jitter <= 0:
            return full
        with self._mu:
            r = self._rng.random()
        return full * (1.0 - self.jitter * r)

    def budget(self, total: float) -> DeadlineBudget:
        return DeadlineBudget(total, clock=self.clock)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open -> (cooldown)
    -> half-open single probe -> closed on success / open on failure."""

    def __init__(
        self,
        threshold: int = 5,
        cooldown: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.cooldown = cooldown
        self._clock = clock
        self._on_transition = on_transition
        self._mu = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._mu:
            return self._effective_state_locked()

    def _effective_state_locked(self) -> str:
        if self._state == OPEN and (
            self._clock() - self._opened_at >= self.cooldown
        ):
            return HALF_OPEN
        return self._state

    def _transition_locked(self, new: str) -> None:
        old = self._state
        self._state = new
        if self._on_transition is not None and old != new:
            self._on_transition(old, new)

    def allow(self) -> bool:
        """May a request go out right now? Open denies in microseconds;
        after the cooldown exactly one half-open probe gets through until
        its outcome is recorded."""
        with self._mu:
            st = self._effective_state_locked()
            if st == CLOSED:
                return True
            if st == HALF_OPEN:
                if self._state == OPEN:  # cooldown just elapsed
                    self._transition_locked(HALF_OPEN)
                    self._probing = False
                if self._probing:
                    return False
                self._probing = True
                return True
            return False

    def record_neutral(self) -> None:
        """Outcome unknowable (e.g. the attempt timed out under a starved
        caller budget): release a held half-open probe slot WITHOUT moving
        the state machine — otherwise the un-recorded probe would pin
        `allow()` false forever."""
        with self._mu:
            self._probing = False

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition_locked(CLOSED)

    def record_failure(self) -> None:
        with self._mu:
            self._probing = False
            if self._state == HALF_OPEN or (
                self._state == OPEN
                and self._effective_state_locked() == HALF_OPEN
            ):
                # failed probe: re-open and restart the cooldown
                self._opened_at = self._clock()
                self._transition_locked(OPEN)
                return
            if self._state == OPEN:
                return
            self._failures += 1
            if self._failures >= self.threshold:
                self._opened_at = self._clock()
                self._transition_locked(OPEN)


class BreakerRegistry:
    """One CircuitBreaker per peer URI, with transition counters pushed
    to a StatsClient (`breaker.opened` / `breaker.half_open` /
    `breaker.closed`)."""

    def __init__(
        self,
        threshold: int = 5,
        cooldown: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        logger: Optional[Callable[[str], None]] = None,
    ):
        self.threshold = threshold
        self.cooldown = cooldown
        self._clock = clock
        self.logger = logger
        self._mu = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    @staticmethod
    def _norm(uri: str) -> str:
        return uri.rstrip("/")

    def for_uri(self, uri: str) -> CircuitBreaker:
        key = self._norm(uri)
        with self._mu:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(
                    threshold=self.threshold,
                    cooldown=self.cooldown,
                    clock=self._clock,
                    on_transition=self._transition_cb(key),
                )
                self._breakers[key] = br
            return br

    def _transition_cb(self, uri: str):
        def cb(old: str, new: str) -> None:
            if self.logger is not None:
                self.logger(f"breaker {uri}: {old} -> {new}")

        return cb

    def allow(self, uri: str) -> bool:
        return self.for_uri(uri).allow()

    def record(self, uri: str, ok: bool) -> None:
        br = self.for_uri(uri)
        if ok:
            br.record_success()
        else:
            br.record_failure()

    def record_neutral(self, uri: str) -> None:
        self.for_uri(uri).record_neutral()

    def state(self, uri: str) -> str:
        with self._mu:
            br = self._breakers.get(self._norm(uri))
        return CLOSED if br is None else br.state

    def snapshot(self) -> Dict[str, str]:
        """Peer URI -> breaker state for every peer ever recorded
        (exposed in /status so operators see which peers are shunned)."""
        with self._mu:
            items = list(self._breakers.items())
        return {uri: br.state for uri, br in items}

    def reset(self) -> None:
        with self._mu:
            self._breakers.clear()


# ---------------------------------------------------------------------------
# fault injection (test-only)
# ---------------------------------------------------------------------------


class InjectedFault(Exception):
    """Marker base so tests can tell injected failures from real ones
    (the client classifies them exactly like their real counterparts)."""


class InjectedRefusal(InjectedFault, ConnectionRefusedError):
    pass


class InjectedTimeout(InjectedFault, TimeoutError):
    pass


class _Rule:
    __slots__ = ("kind", "uri", "path", "prob", "times", "delay", "skip")

    def __init__(self, kind, uri, path, prob, times, delay, skip=0):
        self.kind = kind
        self.uri = uri
        self.path = path
        self.prob = prob
        self.times = times  # None = unlimited; else remaining match count
        self.delay = delay
        self.skip = skip  # matches ignored before the rule starts firing


class FaultInjector:
    """Deterministic chaos: rules match (uri, path prefix) and fire
    unconditionally, a fixed number of `times` (after `skip` matches),
    or with seeded probability `prob`, so a scenario replays exactly
    given the same seed and request sequence.

    Kinds: "refuse" (connection refused without dialing), "timeout",
    "http500", "slow" (sleep `delay`, then proceed) and "partition" (an
    unlimited refuse that `heal()` lifts). Install on one client with
    `client.fault_injector = inj` or process-wide with
    `install_injector(inj)` (and `uninstall_injector()` after)."""

    def __init__(self, seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        self._mu = threading.Lock()
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._rules: List[_Rule] = []
        self.injected: Dict[str, int] = {}

    # -- rule management ---------------------------------------------------

    def add_rule(
        self,
        kind: str,
        uri: Optional[str] = None,
        path: Optional[str] = None,
        prob: float = 1.0,
        times: Optional[int] = None,
        delay: float = 0.0,
        skip: int = 0,
    ) -> "FaultInjector":
        if kind not in ("refuse", "timeout", "http500", "slow", "partition"):
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._mu:
            self._rules.append(
                _Rule(
                    kind, uri.rstrip("/") if uri else None, path, prob,
                    times, delay, skip,
                )
            )
        return self

    def partition(self, uri: str) -> "FaultInjector":
        """Cut this client off from `uri` entirely (one-directional, the
        client side of a network partition)."""
        return self.add_rule("partition", uri=uri)

    def heal(self, uri: Optional[str] = None) -> None:
        """Remove the partitions of `uri`, or every rule when uri is None
        (the network is whole again)."""
        with self._mu:
            if uri is None:
                self._rules = []
                return
            key = uri.rstrip("/")
            self._rules = [
                r
                for r in self._rules
                if not (r.kind == "partition" and r.uri == key)
            ]

    def count(self, kind: Optional[str] = None) -> int:
        with self._mu:
            if kind is not None:
                return self.injected.get(kind, 0)
            return sum(self.injected.values())

    # -- the hook ----------------------------------------------------------

    def before_request(self, method: str, uri: str, path: str, url: str) -> None:
        """Called by InternalClient._do inside the attempt's try block,
        before the socket is dialed. Raises the injected failure (which
        then flows through the client's normal classification) or sleeps
        for "slow" rules."""
        uri = uri.rstrip("/")
        delay = 0.0
        fire: Optional[Tuple[str, str]] = None
        with self._mu:
            for r in self._rules:
                if r.uri is not None and r.uri != uri:
                    continue
                if r.path is not None and not path.startswith(r.path):
                    continue
                if r.times is not None and r.times <= 0:
                    continue
                if r.skip > 0:
                    r.skip -= 1
                    continue
                if r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                if r.times is not None:
                    r.times -= 1
                self.injected[r.kind] = self.injected.get(r.kind, 0) + 1
                if r.kind == "slow":
                    delay = max(delay, r.delay)
                    continue
                fire = (r.kind, r.uri or uri)
                break
        if delay > 0:
            self._sleep(delay)
        if fire is None:
            return
        kind, _ = fire
        if kind in ("refuse", "partition"):
            raise urllib.error.URLError(
                InjectedRefusal(f"[injected] connection refused: {url}")
            )
        if kind == "timeout":
            raise InjectedTimeout(f"[injected] timed out: {url}")
        if kind == "http500":
            raise urllib.error.HTTPError(
                url, 500, "[injected] internal server error", None,
                io.BytesIO(b"injected fault"),
            )

# ---------------------------------------------------------------------------
# process-wide installs (tests); the conftest leak-guard checks these
# ---------------------------------------------------------------------------

_global_mu = threading.Lock()
_global_injector: Optional[FaultInjector] = None
_global_breakers: Optional[BreakerRegistry] = None


def install_injector(inj: FaultInjector) -> None:
    """Every InternalClient without an injector of its own consults `inj`."""
    global _global_injector
    with _global_mu:
        _global_injector = inj


def uninstall_injector() -> None:
    global _global_injector
    with _global_mu:
        _global_injector = None


def global_injector() -> Optional[FaultInjector]:
    return _global_injector


def install_breakers(reg: BreakerRegistry) -> None:
    global _global_breakers
    with _global_mu:
        _global_breakers = reg


def uninstall_breakers() -> None:
    global _global_breakers
    with _global_mu:
        _global_breakers = None


def global_breakers() -> Optional[BreakerRegistry]:
    return _global_breakers
