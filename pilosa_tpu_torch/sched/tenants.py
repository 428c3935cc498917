"""Per-index (tenant) QoS policy: token buckets and byte quotas.

The port of pilosa_tpu/sched/tenants.py. It resolves, per index:

- token-bucket rate limits in queries/s and device-bytes/s (priced by
  sched/cost.py's estimate, the number the admission byte budget is
  charged), whose refill time is the 429's Retry-After;
- byte quotas: in-flight device bytes at admission
  (sched/admission.py), HBM residency (core/devcache.py's eviction) and
  result-cache bytes (core/resultcache.py). This object only resolves
  the numbers; each enforcement site owns its check.

Limits come from the `[tenants]` config section: defaults for every
index plus per-index overrides `"index:knob=value;knob=value"` (kebab
knob names). 0 means unlimited. A request bound to no index is never
limited. The clock is injectable (tests drive refill without sleeping);
buckets are created per index on first use and dropped by drop_index.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import threading

# kebab knob names accepted in a per-index override entry; they mirror
# the TenantsConfig `default_*` fields with the prefix dropped
_OVERRIDE_KEYS = (
    "qps", "bytes-per-s", "inflight-bytes", "hbm-bytes", "cache-bytes",
)


class TenantLimits(NamedTuple):
    """Effective limits for one index. 0 = unlimited."""

    qps: float
    bytes_per_s: float
    inflight_bytes: int
    hbm_bytes: int
    cache_bytes: int


UNLIMITED = TenantLimits(0.0, 0.0, 0, 0, 0)


class QuotaDenial(NamedTuple):
    """A tripped limit, with everything the 429 needs to say: which
    limit (kebab name, the X-Pilosa-Quota-Limit header), the usage that
    tripped it, the configured value, the shed-reason tag for
    sched.shed, and the seconds until the constraint actually clears
    (token-bucket refill — the informed Retry-After)."""

    limit: str
    usage: float
    value: float
    reason: str  # "rate" (qps bucket) | "bytes" (byte-denominated)
    retry_after: float


class TokenBucket:
    """Classic token bucket. Not self-locking: TenantPolicy guards all
    buckets under tenants.mu (take+refund across the two buckets must
    be atomic). `take` returns 0.0 on success, else the seconds until
    enough tokens refill — the informed Retry-After."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1e-9)
        self.tokens = self.burst  # start full: first burst is free
        self.stamp = now

    def _refill(self, now: float) -> None:
        dt = now - self.stamp
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self.stamp = now

    def take(self, n: float, now: float) -> float:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate

    def refund(self, n: float) -> None:
        self.tokens = min(self.burst, self.tokens + n)

    def peek(self, n: float, now: float) -> bool:
        """Would `take(n)` succeed right now? Consumes nothing."""
        self._refill(now)
        return self.tokens >= n


def parse_overrides(entries: Iterable[str]) -> Dict[str, Dict[str, float]]:
    """`"index:qps=5;hbm-bytes=65536"` entries -> {index: {knob: value}}.
    Operator config: malformed entries raise (like an unknown admission
    default class) instead of silently enforcing nothing."""
    out: Dict[str, Dict[str, float]] = {}
    for raw in entries:
        raw = raw.strip()
        if not raw:
            continue
        if ":" not in raw:
            raise ValueError(
                f"malformed tenant override {raw!r}: expected "
                "'index:knob=value[;knob=value...]'"
            )
        index, _, body = raw.partition(":")
        index = index.strip()
        if not index:
            raise ValueError(f"tenant override {raw!r} names no index")
        knobs = out.setdefault(index, {})
        for part in body.split(";"):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep or key not in _OVERRIDE_KEYS:
                raise ValueError(
                    f"tenant override {raw!r}: unknown knob {key!r}; "
                    f"expected one of {list(_OVERRIDE_KEYS)}"
                )
            try:
                knobs[key] = float(val.strip())
            except ValueError:
                raise ValueError(
                    f"tenant override {raw!r}: non-numeric value for "
                    f"{key!r}"
                ) from None
    return out


class TenantPolicy:
    def __init__(
        self,
        default_qps: float = 0.0,
        default_bytes_per_s: float = 0.0,
        default_inflight_bytes: int = 0,
        default_hbm_bytes: int = 0,
        default_cache_bytes: int = 0,
        overrides: Iterable[str] = (),
        clock: Callable[[], float] = time.monotonic,
    ):
        self._defaults = TenantLimits(
            qps=max(0.0, float(default_qps)),
            bytes_per_s=max(0.0, float(default_bytes_per_s)),
            inflight_bytes=max(0, int(default_inflight_bytes)),
            hbm_bytes=max(0, int(default_hbm_bytes)),
            cache_bytes=max(0, int(default_cache_bytes)),
        )
        self._overrides = parse_overrides(overrides)
        self._clock = clock
        self._mu = threading.Lock()
        # index -> (qps bucket | None, bytes/s bucket | None), lazily
        # created so an idle tenant costs nothing
        self._buckets: Dict[str, Tuple[Optional[TokenBucket],
                                       Optional[TokenBucket]]] = {}

    # -- limit resolution --------------------------------------------------

    def limits(self, index: str) -> TenantLimits:
        ov = self._overrides.get(index)
        if not ov:
            return self._defaults
        d = self._defaults
        return TenantLimits(
            qps=ov.get("qps", d.qps),
            bytes_per_s=ov.get("bytes-per-s", d.bytes_per_s),
            inflight_bytes=int(ov.get("inflight-bytes", d.inflight_bytes)),
            hbm_bytes=int(ov.get("hbm-bytes", d.hbm_bytes)),
            cache_bytes=int(ov.get("cache-bytes", d.cache_bytes)),
        )

    def any_limits(self) -> bool:
        """Is any enforcement configured at all?"""
        if any(self._defaults):
            return True
        return any(v for ov in self._overrides.values() for v in ov.values())

    def hbm_quota_map(self) -> Tuple[int, Dict[str, int]]:
        """(default, {index: quota}) for core/devcache.py."""
        return self._defaults.hbm_bytes, {
            idx: int(ov["hbm-bytes"])
            for idx, ov in self._overrides.items()
            if "hbm-bytes" in ov
        }

    def cache_quota_map(self) -> Tuple[int, Dict[str, int]]:
        """(default, {index: quota}) for core/resultcache.py."""
        return self._defaults.cache_bytes, {
            idx: int(ov["cache-bytes"])
            for idx, ov in self._overrides.items()
            if "cache-bytes" in ov
        }

    # -- rate enforcement --------------------------------------------------

    def _buckets_locked(
        self, index: str, lim: TenantLimits
    ) -> Tuple[Optional[TokenBucket], Optional[TokenBucket]]:
        pair = self._buckets.get(index)
        if pair is None:
            now = self._clock()
            # burst = one second of the configured rate (min one whole
            # query for qps, so a sub-1/s limit still ever grants)
            qb = (
                TokenBucket(lim.qps, max(1.0, lim.qps), now)
                if lim.qps > 0 else None
            )
            bb = (
                TokenBucket(lim.bytes_per_s, lim.bytes_per_s, now)
                if lim.bytes_per_s > 0 else None
            )
            pair = self._buckets[index] = (qb, bb)
        return pair

    def acquire(
        self, index: Optional[str], device_bytes: int
    ) -> Optional[QuotaDenial]:
        """Charge one query against `index`'s rate buckets. Returns the
        denial when a bucket is empty (nothing is consumed on denial —
        the qps token is refunded if the byte bucket rejects), None on
        grant or when the request is tenant-less/unlimited."""
        if index is None:
            return None
        lim = self.limits(index)
        if lim.qps <= 0 and lim.bytes_per_s <= 0:
            return None
        with self._mu:
            now = self._clock()
            qb, bb = self._buckets_locked(index, lim)
            if qb is not None:
                # owns: charge window is pure arithmetic; refill heals it
                wait = qb.take(1.0, now)
                if wait > 0.0:
                    return QuotaDenial(
                        limit="qps", usage=1.0, value=lim.qps,
                        reason="rate", retry_after=wait,
                    )
            if bb is not None and device_bytes > 0:
                # an estimate heavier than the whole bucket still runs —
                # alone w.r.t. its refill window (burst-sized take), the
                # same single-oversized-entry rule the byte budget and
                # devcache apply — otherwise that query could NEVER run
                need = min(float(device_bytes), bb.burst)
                # owns: charge window is pure arithmetic; refill heals it
                wait = bb.take(need, now)
                if wait > 0.0:
                    if qb is not None:
                        qb.refund(1.0)
                    return QuotaDenial(
                        limit="bytes-per-s", usage=float(device_bytes),
                        value=lim.bytes_per_s, reason="bytes",
                        retry_after=wait,
                    )
        return None

    def throttled(self, index: Optional[str]) -> bool:
        """Non-consuming peek: is `index` currently out of rate tokens?
        Gates prefetcher warming — a rate-limited tenant's queries are
        about to shed, so warming their extents would spend PCIe (and
        evict in-quota tenants' residency) on work that never runs."""
        if index is None:
            return False
        lim = self.limits(index)
        if lim.qps <= 0 and lim.bytes_per_s <= 0:
            return False
        with self._mu:
            now = self._clock()
            qb, bb = self._buckets_locked(index, lim)
            if qb is not None and not qb.peek(1.0, now):
                return True
            if bb is not None and not bb.peek(1.0, now):
                return True
        return False

    def drop_index(self, index: str) -> None:
        """Label GC hook (the node's index delete): forget a
        deleted index's bucket state so tenant churn cannot grow the
        policy map without bound."""
        with self._mu:
            self._buckets.pop(index, None)

    def bucket_count(self) -> int:
        """Live lazily-created bucket entries (GC test surface)."""
        with self._mu:
            return len(self._buckets)
