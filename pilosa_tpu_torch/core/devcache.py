"""Budgeted LRU cache of device tensors.

The port's counterpart of pilosa_tpu/core/devcache.py: fragment rows
(`(fragment token, row)`), view row stacks and TopN tally bundles live here
under keys `(owner, *rest)`, where `owner` is a token from
`new_owner_token()`; `invalidate_owner(s)` drops everything an object
cached. `get_or_build` is single-flight: concurrent callers of one key run
one build and share its result.

A Holder owns one cache, sized for its device: half of the card's memory
on CUDA (`torch.cuda.mem_get_info`), 4 GiB on the CPU. An entry larger
than the whole budget is still admitted (the query needs it) and evicted
by the next insert. Eviction drops the cache's reference only: a tensor
an in-flight plan still holds stays alive until the plan lets go, so no
pins are needed.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Iterable, Set, Tuple

import torch

_CPU_BUDGET_BYTES = 4 << 30

_tokens = itertools.count(1)
_token_mu = threading.Lock()


def new_owner_token() -> int:
    """Process-unique owner id (object identity is not reuse-safe)."""
    with _token_mu:
        return next(_tokens)


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
    """LRU key -> device tensor (or tensor bundle) map with a byte budget."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = int(budget_bytes)
        self._mu = threading.Lock()
        self._built = threading.Condition(self._mu)
        self._building: Set[Tuple] = set()
        self._entries: "OrderedDict[Tuple, object]" = OrderedDict()
        self._sizes: Dict[Tuple, int] = {}
        self._by_owner: Dict[Hashable, Set[Tuple]] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: Tuple, build: Callable[[], object]) -> object:
        with self._mu:
            while True:
                value = self._entries.get(key)
                if value is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
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
            self._put_locked(key, value)
            self._built.notify_all()
        return value

    def _put_locked(self, key: Tuple, value: object) -> None:
        if key in self._entries:
            self._drop_locked(key)
        nb = _nbytes(value)
        self._entries[key] = value
        self._sizes[key] = nb
        self._by_owner.setdefault(key[0], set()).add(key)
        self._bytes += nb
        for old in list(self._entries):
            if self._bytes <= self.budget_bytes or len(self._entries) <= 1:
                break
            if old != key:
                self._drop_locked(old)
                self.evictions += 1

    def _drop_locked(self, key: Tuple) -> None:
        self._entries.pop(key, None)
        self._bytes -= self._sizes.pop(key, 0)
        keys = self._by_owner.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_owner[key[0]]

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

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._sizes.clear()
            self._by_owner.clear()
            self._bytes = 0

    @property
    def bytes_used(self) -> int:
        with self._mu:
            return self._bytes
