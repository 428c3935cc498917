"""Budgeted LRU cache of device tensors: the extent store.

The port's counterpart of pilosa_tpu/core/devcache.py: fragment rows
(`(fragment token, row)`), view row and plane stacks, their shard-major
extents (hbm/residency.py) and TopN tally bundles live here under keys
`(owner, *rest)`, where `owner` is a token from `new_owner_token()`;
`invalidate_owner(s)` drops everything an object cached. `get_or_build`
is single-flight: concurrent callers of one key run one build and share
its result.

A Holder owns one cache, sized for its device: half of the card's memory
on CUDA (`torch.cuda.mem_get_info`), 4 GiB on the CPU. An entry larger
than the whole budget is still admitted (the query needs it) and evicted
by the next insert.

Eviction drops the cache's reference only: a tensor an in-flight plan
still holds stays alive until the plan lets go, so memory safety needs no
pins. Pins (refcounts) serve two other rules. Anti-thrash: staging an
operand pins its resident extents before it builds the missing ones, so
building extent k never evicts extent k-1 of the same operand, and
`deferred_eviction` keeps a query's operands from evicting each other
while it stages them. Copy-on-write: the merge barrier patches a resident
entry in place only when it is not pinned; a pinned entry may be an
operand of a plan not yet launched, so it is cloned, the clone patched
and re-keyed (core/view.py). A pinned entry is never evicted; one
invalidated while pinned leaves lookup at once, and its bytes stay on the
ledger ("zombie" bytes) until the last unpin, since the plan still holds
the memory. `pin_timeout` (seconds, 0 = off; the `[hbm] pin-timeout`
knob, set process-wide by `hbm.residency.configure`) is a leak valve: a
pin older than that is released by the evictor.

Every entry may carry the shards it covers (`shards=`):
`invalidate_owner_shard` drops only the entries covering a written shard
(entries without coverage are dropped conservatively), and the merge
barrier walks `owner_entries` to patch or drop them. Per-index quotas
and attribution wait for the tenant scheduler.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Set, Tuple

import torch

_CPU_BUDGET_BYTES = 4 << 30

_tokens = itertools.count(1)
_token_mu = threading.Lock()

# the process-wide pin timeout every cache without its own reads
_default_pin_timeout = 0.0


def new_owner_token() -> int:
    """Process-unique owner id (object identity is not reuse-safe)."""
    with _token_mu:
        return next(_tokens)


def set_default_pin_timeout(seconds: float) -> None:
    global _default_pin_timeout
    _default_pin_timeout = float(seconds)


def default_pin_timeout() -> float:
    return _default_pin_timeout


def default_budget(device: torch.device) -> int:
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return total // 2
    return _CPU_BUDGET_BYTES


def _nbytes(value: object) -> int:
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return 64


class DeviceCache:
    """LRU key -> device tensor (or tensor bundle) map with a byte budget,
    pins and per-entry shard coverage."""

    def __init__(
        self,
        budget_bytes: int,
        pin_timeout: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.budget_bytes = int(budget_bytes)
        # None follows the process-wide default (set_default_pin_timeout)
        self.pin_timeout = pin_timeout
        self._clock = clock
        self._mu = threading.Lock()
        self._built = threading.Condition(self._mu)
        self._building: Set[Tuple] = set()
        self._entries: "OrderedDict[Tuple, object]" = OrderedDict()
        self._sizes: Dict[Tuple, int] = {}
        # resident bytes per owner token, kept with _sizes (the admission
        # discount reads it per query)
        self._owner_bytes: Dict[Hashable, int] = {}
        self._by_owner: Dict[Hashable, Set[Tuple]] = {}
        self._bytes = 0
        self._pins: Dict[Tuple, int] = {}
        self._pin_t0: Dict[Tuple, float] = {}
        self._zombies: Dict[Tuple, int] = {}
        self._extent_keys: Set[Tuple] = set()
        self._cover: Dict[Tuple, frozenset] = {}
        self._defer_evict = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_extent_bytes = 0  # cumulative; paging checks diff it
        self.built_bytes = 0  # cumulative bytes of every get_or_build build
        self.stale_pin_reclaims = 0
        # per-index (tenant) residency quotas, 0 / absent = unlimited
        # (configure_quotas): eviction lands on an index over its quota,
        # in its own LRU order, before the global pass, and holds it to
        # the quota even when the budget has room. Bytes are attributed
        # to an index through the owner token of each key (tag_owner).
        self._owner_index: Dict[Hashable, str] = {}
        self._index_quota_default = 0
        self._index_quota: Dict[str, int] = {}
        self._quota_evictions_index: Dict[str, int] = {}
        self.quota_evictions = 0  # of evictions, by the quota pass

    # -- core --------------------------------------------------------------

    def get(self, key: Tuple) -> Optional[object]:
        with self._mu:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return value

    def put(
        self,
        key: Tuple,
        value: object,
        *,
        extent: bool = False,
        shards: Optional[Iterable[int]] = None,
    ) -> None:
        with self._mu:
            self._put_locked(key, value, extent=extent, shards=shards)

    def get_or_build(
        self,
        key: Tuple,
        build: Callable[[], object],
        *,
        extent: bool = False,
        pin: bool = False,
        shards: Optional[Iterable[int]] = None,
    ) -> object:
        """The cached value of `key`, built at most once even under
        concurrent callers. With pin=True the entry is pinned under the
        same lock hold that found or inserted it."""
        with self._mu:
            while True:
                value = self._entries.get(key)
                if value is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    if pin:
                        self._pin_locked(key)
                    return value
                if key not in self._building:
                    self._building.add(key)
                    self.misses += 1
                    break
                self._built.wait()
        try:
            value = build()
        except BaseException:
            with self._mu:
                self._building.discard(key)
                self._built.notify_all()
            raise
        with self._mu:
            self._building.discard(key)
            self._put_locked(key, value, extent=extent, shards=shards)
            self.built_bytes += self._sizes.get(key, 0)
            if pin:
                self._pin_locked(key)
            self._built.notify_all()
        return value

    def _put_locked(self, key: Tuple, value: object, *, extent: bool = False, shards=None) -> None:
        if key in self._entries:
            self._drop_locked(key, replacing=True)
        nb = _nbytes(value)
        self._entries[key] = value
        self._sizes[key] = nb
        self._owner_bytes[key[0]] = self._owner_bytes.get(key[0], 0) + nb
        self._by_owner.setdefault(key[0], set()).add(key)
        if extent:
            self._extent_keys.add(key)
        if shards is not None:
            self._cover[key] = frozenset(shards)
        self._bytes += nb
        self._evict_locked(keep=key)

    def _drop_locked(self, key: Tuple, replacing: bool = False) -> None:
        self._entries.pop(key, None)
        nb = self._sizes.pop(key, 0)
        if not replacing and key in self._pins:
            # an in-flight plan holds the tensor: its bytes stay on the
            # ledger until the last unpin
            self._zombies[key] = self._zombies.get(key, 0) + nb
        else:
            self._bytes -= nb
        self._extent_keys.discard(key)
        self._cover.pop(key, None)
        keys = self._by_owner.get(key[0])
        if keys is not None:
            if key in keys:
                self._owner_bytes[key[0]] -= nb
            keys.discard(key)
            if not keys:
                del self._by_owner[key[0]]
                self._owner_bytes.pop(key[0], None)

    def _evict_locked(self, keep: Optional[Tuple]) -> None:
        if self._defer_evict > 0:
            return
        if self._index_quota or self._index_quota_default > 0:
            self._evict_over_quota_locked(keep)
        if self._bytes <= self.budget_bytes:
            return
        for key in list(self._entries):
            if self._bytes <= self.budget_bytes or len(self._entries) <= 1:
                break
            if key == keep or self._pinned_locked(key):
                continue
            if key in self._extent_keys:
                self.evicted_extent_bytes += self._sizes.get(key, 0)
            self._drop_locked(key)
            self.evictions += 1

    def _quota_for_locked(self, index: str) -> int:
        q = self._index_quota.get(index)
        return q if q is not None else self._index_quota_default

    def _evict_over_quota_locked(self, keep: Optional[Tuple]) -> None:
        """The per-index quota pass, in LRU order. Bytes still held by
        pins (zombies) count against their index, but only live unpinned
        entries go, so pins overshoot a quota for a while as they do the
        budget. An entry larger than its whole quota stays while it is
        all its index holds (the query needs it), as the budget admits a
        single entry over it."""
        by_idx = self._index_bytes_locked()
        for key in list(self._entries):
            if len(self._entries) <= 1:
                break
            if key == keep:
                continue
            idx = self._owner_index.get(key[0], "-")
            if idx == "-":
                continue
            quota = self._quota_for_locked(idx)
            if quota <= 0:
                continue
            held = by_idx.get(idx, 0)
            if held <= quota or self._pinned_locked(key):
                continue
            nb = self._sizes.get(key, 0)
            if nb >= held and nb > quota:
                continue
            if key in self._extent_keys:
                self.evicted_extent_bytes += nb
            self._drop_locked(key)
            by_idx[idx] = held - nb
            self.evictions += 1
            self.quota_evictions += 1
            self._quota_evictions_index[idx] = self._quota_evictions_index.get(idx, 0) + 1

    def _index_bytes_locked(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for sizes in (self._sizes, self._zombies):
            for key, nb in sizes.items():
                idx = self._owner_index.get(key[0], "-")
                out[idx] = out.get(idx, 0) + nb
        return out

    def tag_owner(self, owner: Hashable, index: str) -> None:
        """Attribute the entries of an owner token to an index (views and
        fragments tag theirs when they are made)."""
        with self._mu:
            self._owner_index[owner] = index

    def untag_owner(self, owner: Hashable) -> None:
        with self._mu:
            self._owner_index.pop(owner, None)

    def configure_quotas(self, default_bytes: int = 0, overrides: Optional[Dict[str, int]] = None) -> None:
        """Install per-index residency quotas (the [tenants] section; 0 =
        unlimited) and settle at once: an index over its new quota sheds
        its own LRU entries now."""
        with self._mu:
            self._index_quota_default = max(0, int(default_bytes))
            self._index_quota = {k: max(0, int(v)) for k, v in (overrides or {}).items()}
            self._evict_locked(keep=None)

    def index_resident_bytes(self) -> Dict[str, int]:
        """Resident bytes by owning index ("-": untagged owners)."""
        with self._mu:
            return self._index_bytes_locked()

    def quota_evictions_by_index(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._quota_evictions_index)

    def drop_index_attribution(self, index: str) -> None:
        """Forget a deleted index's quota evictions (its quota override
        stays: operator config re-applies if the index is recreated)."""
        with self._mu:
            self._quota_evictions_index.pop(index, None)

    def owner_resident_bytes(self, owner: Hashable) -> int:
        """Resident bytes cached under one owner token (the admission cost
        discount, sched/cost.py)."""
        with self._mu:
            return self._owner_bytes.get(owner, 0)

    # -- invalidation ------------------------------------------------------

    def invalidate(self, key: Tuple) -> None:
        with self._mu:
            if key in self._entries:
                self._drop_locked(key)

    def invalidate_many(self, keys: Iterable[Tuple]) -> None:
        with self._mu:
            for key in keys:
                if key in self._entries:
                    self._drop_locked(key)

    def invalidate_owner(self, owner: Hashable) -> None:
        self.invalidate_owners((owner,))

    def invalidate_owners(self, owners: Iterable[Hashable]) -> None:
        with self._mu:
            for owner in owners:
                for key in list(self._by_owner.get(owner, ())):
                    self._drop_locked(key)

    def invalidate_owner_shard(self, owner: Hashable, shard: int) -> None:
        """Drop this owner's entries whose coverage holds `shard`, and its
        entries without coverage: a one-shard write frees only the
        extents covering that shard."""
        with self._mu:
            for key in list(self._by_owner.get(owner, ())):
                cov = self._cover.get(key)
                if cov is None or shard in cov:
                    self._drop_locked(key)

    def invalidate_owner_uncovered(self, owner: Hashable) -> None:
        """Drop this owner's entries without coverage (ad-hoc builds such
        as TopN tally bundles, not keyed by version). The staged write
        path drops these at once; covered entries are keyed by version
        and wait for the merge barrier to patch or drop them."""
        with self._mu:
            for key in list(self._by_owner.get(owner, ())):
                if self._cover.get(key) is None:
                    self._drop_locked(key)

    def take(self, key: Tuple) -> Tuple[Optional[object], bool]:
        """Remove `key` from lookup and return (value, was pinned); (None,
        False) when it is not resident. The merge barrier takes an entry
        before patching it, so no query pins it mid-patch; a pinned
        entry's bytes stay on the ledger until its last unpin."""
        with self._mu:
            value = self._entries.get(key)
            if value is None:
                return None, False
            pinned = self._pinned_locked(key)
            self._drop_locked(key)
            return value, pinned

    def owner_entries(self, owner: Hashable) -> List[Tuple[Tuple, Optional[frozenset], bool]]:
        """[(key, coverage or None, is_extent)] of one owner's live
        entries, under one lock hold."""
        with self._mu:
            return [(k, self._cover.get(k), k in self._extent_keys) for k in self._by_owner.get(owner, ())]

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._sizes.clear()
            self._owner_bytes.clear()
            self._by_owner.clear()
            self._extent_keys.clear()
            self._cover.clear()
            self._pins.clear()
            self._pin_t0.clear()
            self._zombies.clear()
            self._bytes = 0

    @contextmanager
    def deferred_eviction(self) -> Iterator[None]:
        """Suspend budget eviction for the duration (nestable); the cache
        settles back under budget when the outermost session ends. The
        lowering stages a query's operands inside one, so making room for
        operand k never evicts operand k + 1's resident extents."""
        with self._mu:
            self._defer_evict += 1
        try:
            yield
        finally:
            with self._mu:
                self._defer_evict -= 1
                if self._defer_evict == 0:
                    self._evict_locked(keep=None)

    def contains_all(self, keys: Iterable[Tuple]) -> bool:
        """Whether every key is cached; touches no LRU order or pin."""
        with self._mu:
            return all(k in self._entries for k in keys)

    # -- pins --------------------------------------------------------------

    def pin_if_present(self, key: Tuple) -> bool:
        """Pin `key` if it is resident; True when the pin was taken."""
        with self._mu:
            if key not in self._entries:
                return False
            self._entries.move_to_end(key)
            self._pin_locked(key)
            return True

    def _pin_locked(self, key: Tuple) -> None:
        n = self._pins.get(key, 0)
        self._pins[key] = n + 1
        if n == 0:
            self._pin_t0[key] = self._clock()

    def unpin(self, key: Tuple) -> None:
        """Release one pin; an unknown key is a no-op (the pin timeout may
        have released it)."""
        with self._mu:
            n = self._pins.get(key, 0)
            if n > 1:
                self._pins[key] = n - 1
                return
            self._pins.pop(key, None)
            self._pin_t0.pop(key, None)
            zb = self._zombies.pop(key, None)
            if zb is not None:
                self._bytes -= zb
            if n == 1:
                self._evict_locked(keep=None)

    def unpin_all(self, keys: Iterable[Tuple]) -> None:
        for key in keys:
            self.unpin(key)

    def _pinned_locked(self, key: Tuple) -> bool:
        if key not in self._pins:
            return False
        timeout = self.pin_timeout if self.pin_timeout is not None else _default_pin_timeout
        if timeout > 0 and self._clock() - self._pin_t0.get(key, 0.0) > timeout:
            # a pin this old is a leak, not a query: release it
            self._pins.pop(key, None)
            self._pin_t0.pop(key, None)
            zb = self._zombies.pop(key, None)
            if zb is not None:
                self._bytes -= zb
            self.stale_pin_reclaims += 1
            return False
        return True

    @property
    def pinned_bytes(self) -> int:
        with self._mu:
            return sum(self._sizes.get(k) or self._zombies.get(k, 0) for k in self._pins)

    # -- introspection -----------------------------------------------------

    @property
    def bytes_used(self) -> int:
        with self._mu:
            return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def stats_snapshot(self) -> Dict[str, int]:
        with self._mu:
            return {
                "resident_bytes": self._bytes,
                "entries": len(self._entries),
                "evictions": self.evictions,
                "hits": self.hits,
                "misses": self.misses,
                "budget_bytes": self.budget_bytes,
                "resident_extents": len(self._extent_keys),
                "pinned_bytes": sum(self._sizes.get(k) or self._zombies.get(k, 0) for k in self._pins),
                "evicted_extent_bytes": self.evicted_extent_bytes,
                "built_bytes": self.built_bytes,
                "stale_pin_reclaims": self.stale_pin_reclaims,
                "quota_evictions": self.quota_evictions,
            }
