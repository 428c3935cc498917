"""Versioned result cache with incremental count repair.

The port of pilosa_tpu/core/resultcache.py, for one node: query results
(Count scalars, TopN pairs, GroupBy groups) keyed on the index's cache
scope, the canonical post-translation query text and the shard list,
stored with the exact fragment-version vector the plan read. Three
freshness paths:

- **revalidation**: a repeat re-collects the versions (or, faster, one
  mutation clock per view); an equal vector means the stored result is
  what a recompute would give, served from host memory with no launch
  and no device read.
- **incremental repair** (Counts over a plain Row or a pure
  Intersect/Union of up to 8 plain Rows, `repair_spec`): the merge
  barrier captures the old host words of every row a cached Count
  watches (`interest_rows`) before a staged burst parks, and the
  burst's word delta (`FragMerge.word_delta`, from the merged keys of
  those rows only) patches the count: per merged shard,
  popcount(op(new leaves)) - popcount(op(old leaves)) over the changed
  words. Leaves in other views are read at their pinned versions
  (`Fragment.premerge_row_words`) outside the cache lock, in a deferred
  job that re-validates the entry before it commits. The popcounts run
  on the host in numpy, as in the reference: they cover a burst's
  changed words only.
- **structural re-key** (TopN, GroupBy, Counts the patch cannot cover):
  `dep_rows` names the rows a result depends on per (field, view); a
  burst that touched none of them moves the entry to the merged
  versions without recompute.

Clears, mutex writes and version gaps drop the entries they cover. One
process-global RESULT_CACHE serves every node of the process; keys carry
the index's `_cache_scope` and vector elements each view's
`_stack_token`, so two nodes never serve each other's entries. A cluster
coordinator's vectors also hold its peers' elements, fetched over
/internal/versions (exec/distributed.py); a key pays that round trip
only from its second sighting on (`note_candidate`). The subscription
pins of the reference's coherence plane are not ported.

The store is off (budget 0) until a NodeServer installs its `[cache]`
knobs (`configure`); a bare Executor then computes every query.
"""

from __future__ import annotations

import copy
import weakref
from collections import OrderedDict
from typing import Any, Dict, Hashable, Iterable, List, Optional, Set, Tuple

import numpy as np

import threading

# the [cache] result-mb default (64 MB) a NodeServer installs; 0
# disables the store (get/put do nothing)
DEFAULT_BUDGET_BYTES = 64 << 20

_UNSET = object()

# remote-vector keys remembered as sighted once (note_candidate)
_CANDIDATE_CAP = 1024


def _popcount(words: np.ndarray) -> int:
    """Exact popcount of a uint32 word array (small: delta words only)."""
    if not len(words):
        return 0
    return int(
        np.unpackbits(np.ascontiguousarray(words).view(np.uint8)).sum()
    )


def _op_popcount(op: str, arrays: list) -> int:
    acc = arrays[0]
    fn = np.bitwise_and if op == "and" else np.bitwise_or
    for a in arrays[1:]:
        acc = fn(acc, a)
    return _popcount(acc)


def _tree_delta(op: str, changed, same, other) -> int:
    """popcount(op(new leaves)) - popcount(op(old leaves)) over one
    shard's changed word selection. `changed` holds (old, new) word
    pairs for the merging view's touched leaves; `same` (untouched
    same-view leaves, from the barrier capture) and `other` (other-view
    operands, read at their pinned versions) are identical at both
    evaluations — which is exactly why the difference telescopes to
    the true count delta across sequential per-view merges."""
    fixed = list(same) + list(other)
    old_arrays = [o for o, _ in changed] + fixed
    new_arrays = [n for _, n in changed] + fixed
    return _op_popcount(op, new_arrays) - _op_popcount(op, old_arrays)


def _result_nbytes(kind: str, result: Any) -> int:
    if kind == "count":
        return 32
    # per-element rates sized to the real Python object graphs (a
    # GroupCount carries a FieldRow list; a Pair is a small dataclass):
    # a high-cardinality GroupBy must charge the budget roughly what it
    # costs in RSS, or a 64 MB knob would admit hundreds of real MB
    per = 384 if kind == "groupby" else 112
    try:
        return 64 + per * len(result)
    except TypeError:
        return 256


def _vector_nbytes(vector: tuple) -> int:
    n = 64
    for elem in vector:
        n += 48
        if elem[0] == "v":
            n += 16 * len(elem[5])
    return n


class _Entry:
    """One cached result.

    `vector` is a tuple of elements, one per (node, field, view) the
    query read:

      ("v", node, field, view, ident, shards, versions)
          ident = the View's `_stack_token` — instance identity, so a
          delete/recreate can never alias an old entry back to life;
      ("m", node, field, view)
          the field/view did not exist ("" view = field missing); its
          materialization changes the element shape, forcing a miss.

    `repair_spec` is set only for Counts over pure monotone trees —
    ("and"|"or", ((field, view, row), ...)) for Count(Intersect/Union
    of plain Rows); the single plain Row case is a one-leaf "and".
    The leaves' merged word deltas can patch the cached scalar in
    place (note_merges).

    `dep_rows` maps (field, view) -> frozenset(rows) | None: the exact
    rows the result depends on per referenced view (None / missing =
    depends on every row). A merge whose burst is disjoint from an
    exact dep set re-keys the entry without recompute."""

    __slots__ = (
        "key", "kind", "index", "text", "result", "vector", "repair_spec",
        "dep_rows", "clocks", "maybe_stale", "nbytes",
    )

    def __init__(
        self,
        key: tuple,
        kind: str,
        index: str,
        text: str,
        result: Any,
        vector: tuple,
        repair_spec: Optional[tuple],
        clocks: Optional[tuple] = None,
        dep_rows: Optional[dict] = None,
    ) -> None:
        self.key = key
        self.kind = kind
        self.index = index
        self.text = text
        self.result = result
        self.vector = vector
        self.repair_spec = repair_spec
        self.dep_rows = dep_rows
        # per-view mutation-clock vector (View.mutation_clock) read
        # BEFORE the version vector: clock-equal implies version-equal,
        # so warm repeats revalidate on one integer per view instead of
        # walking the shard axis. None = fall back to the exact vector.
        self.clocks = clocks
        # a covered mutation was observed since the entry last proved
        # fresh (store / hit / in-place repair). Drives the admission
        # cost discount only — a maybe-stale entry must not admit a
        # recompute byte-free (sched/cost.py); serving correctness
        # never reads it.
        self.maybe_stale = False
        extra = 0
        if repair_spec is not None:
            extra += 48 * len(repair_spec[1])
        if dep_rows:
            extra += sum(
                32 + 8 * (len(rows) if rows is not None else 0)
                for rows in dep_rows.values()
            )
        self.nbytes = (
            len(text)
            + _result_nbytes(kind, result)
            + _vector_nbytes(vector)
            + extra
        )

    def spec_rows(self, field: str, view: str) -> frozenset:
        """Leaf rows of `repair_spec` living in (field, view)."""
        if self.repair_spec is None:
            return frozenset()
        return frozenset(
            r for f, v, r in self.repair_spec[1] if f == field and v == view
        )


class ResultCache:
    """LRU byte-budgeted store of versioned query results (one
    process-global instance, RESULT_CACHE, like core/devcache.py)."""

    def __init__(self, budget_bytes: int = 0) -> None:
        self._mu = threading.Lock()
        self._budget = int(budget_bytes)
        self._repair_enabled = True
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        # view token -> keys whose vector covers it (invalidation/repair)
        self._by_token: Dict[int, Set[tuple]] = {}
        # index name -> resident bytes (per-tenant attribution; feeds the
        # cache.resident_bytes{index} gauge and quota work)
        self._by_index: Dict[str, int] = {}
        # (index, field, view) -> row -> refcount of repairable Count
        # entries interested in that row's pre-merge words (the merge
        # barrier's old-words capture hook, core/merge.py)
        self._interest: Dict[tuple, Dict[int, int]] = {}
        # keys sighted once whose vector needs peer round trips
        self._candidates: "OrderedDict[tuple, bool]" = OrderedDict()
        # (scope, text) -> live entry keys (admission cost discount)
        self._by_text: Dict[tuple, Set[tuple]] = {}
        # per-index (tenant) byte quotas ([tenants] section; 0 / absent
        # = unlimited): an index is held to its quota even when the
        # global budget has room, and under global pressure over-quota
        # owners evict first — tenant A's microsecond-serve entries
        # survive tenant B's flood
        self._tenant_quota_default = 0
        self._tenant_quota: Dict[str, int] = {}
        self._quota_evictions_index: Dict[str, int] = {}
        # view token -> weakref(View): the deferred tree-patch jobs read
        # other operands' premerge words OUTSIDE this cache's lock, and
        # resolve the owning View here (registered at View.open, dropped
        # with drop_view).
        self._views: Dict[int, Any] = {}
        self._counters: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "revalidations": 0,
            "repairs": 0,
            "tree_repairs": 0,
            "rekeys": 0,
            "evictions": 0,
            "stores": 0,
            "quota_evictions": 0,
        }

    # -- configuration ------------------------------------------------------

    def configure(
        self,
        budget_bytes: Any = _UNSET,
        repair: Any = _UNSET,
        tenant_default_bytes: Any = _UNSET,
        tenant_overrides: Any = _UNSET,
    ) -> None:
        """Install the server's [cache] knobs (cli/config.py ->
        server/node.py) and the [tenants] per-index cache quotas.
        Process-global like the [hbm] knobs: all in-process nodes share
        one store (entries stay node-scoped via the index/view tokens in
        their keys)."""
        with self._mu:
            if budget_bytes is not _UNSET:
                self._budget = int(budget_bytes)
            if repair is not _UNSET:
                self._repair_enabled = bool(repair)
            if tenant_default_bytes is not _UNSET:
                self._tenant_quota_default = max(0, int(tenant_default_bytes))
            if tenant_overrides is not _UNSET:
                self._tenant_quota = {
                    k: max(0, int(v))
                    for k, v in (tenant_overrides or {}).items()
                }
            self._evict_over_budget_locked()

    @property
    def budget_bytes(self) -> int:
        return self._budget

    @property
    def repair_enabled(self) -> bool:
        return self._repair_enabled

    # -- lookup / store -----------------------------------------------------

    def get(
        self, key: tuple, vector: Optional[tuple], recount: bool = True
    ) -> Tuple[bool, Any]:
        """(found, result). A hit requires the entry's stored vector to
        EQUAL the caller's freshly collected one — identical fragment
        versions mean identical content, so the stored result is what a
        recompute would return. `recount=False` suppresses the miss
        counter (the repair retry re-gets after running the barrier)."""
        if vector is None or self._budget <= 0:
            return False, None
        with self._mu:
            e = self._entries.get(key)
            if e is not None and e.vector == vector:
                self._entries.move_to_end(key)
                self._counters["hits"] += 1
                self._counters["revalidations"] += 1
                e.maybe_stale = False
                result = e.result
                kind = e.kind
            else:
                if recount:
                    self._counters["misses"] += 1
                return False, None
        if kind == "count":
            return True, result
        return True, copy.deepcopy(result)

    def get_by_clock(
        self, key: tuple, clocks: Optional[tuple]
    ) -> Tuple[bool, Any]:
        """(found, result): the O(#views) fast path — serve when the
        caller's freshly read per-view mutation clocks equal the
        entry's. Sound because every fragment-version bump also bumps
        its view's clock (and clocks were read BEFORE the entry's
        vector at store/refresh time): clock-equal ⇒ zero mutation
        events since ⇒ version-vector-equal. Misses are silent — the
        caller falls back to the exact vector path, which counts."""
        if clocks is None or self._budget <= 0:
            return False, None
        with self._mu:
            e = self._entries.get(key)
            if e is None or e.clocks is None or e.clocks != clocks:
                return False, None
            self._entries.move_to_end(key)
            self._counters["hits"] += 1
            self._counters["revalidations"] += 1
            e.maybe_stale = False
            result = e.result
            kind = e.kind
        if kind == "count":
            return True, result
        return True, copy.deepcopy(result)

    def refresh_clocks(self, key: tuple, clocks: Optional[tuple]) -> None:
        """Arm the clock fast path after a successful exact-vector
        revalidation. `clocks` MUST have been read before the vector
        the caller just matched — a write landing in between then keeps
        the fast path disarmed (live clock moved past), never wrong."""
        if clocks is None:
            return
        with self._mu:
            e = self._entries.get(key)
            if e is not None:
                e.clocks = clocks

    def count_miss(self) -> None:
        """Book one lookup that concluded a miss. The executor defers
        this until the repair retry has also failed, so one logical
        lookup never records both a miss and a hit (a repaired serve
        would otherwise read as cacheHitRate 0.5 on a 100%-served
        dashboard)."""
        with self._mu:
            self._counters["misses"] += 1

    def repairable(self, key: tuple) -> bool:
        """Whether a miss on `key` is worth a repair attempt: a live
        entry with a repair spec or exact dep rows (re-keyable), and
        repair enabled. The caller then runs the read barrier (which
        fires note_merges) and re-gets."""
        if not self._repair_enabled:
            return False
        with self._mu:
            e = self._entries.get(key)
            return e is not None and (
                e.repair_spec is not None or e.dep_rows is not None
            )

    def note_candidate(self, key: tuple) -> bool:
        """Record a sighting of a key whose vector needs peer round trips;
        True when it was seen before (now worth paying them)."""
        with self._mu:
            if key in self._entries:
                return True
            if key in self._candidates:
                self._candidates.move_to_end(key)
                return True
            self._candidates[key] = True
            while len(self._candidates) > _CANDIDATE_CAP:
                self._candidates.popitem(last=False)
            return False

    def put(
        self,
        key: tuple,
        kind: str,
        index: str,
        text: str,
        result: Any,
        vector: tuple,
        clocks: Optional[tuple] = None,
        repair_spec: Optional[tuple] = None,
        dep_rows: Optional[dict] = None,
    ) -> None:
        if vector is None or self._budget <= 0:
            return
        if kind != "count":
            result = copy.deepcopy(result)
        if repair_spec is not None and not self._spec_admissible(
            kind, vector, repair_spec
        ):
            repair_spec = None
        e = _Entry(key, kind, index, text, result, vector, repair_spec,
                   clocks, dep_rows)
        if e.nbytes > self._budget:
            return  # a single over-budget entry would evict everything
        with self._mu:
            quota = self._quota_for_locked(index)
            if 0 < quota < e.nbytes:
                # a single entry bigger than the tenant's whole quota
                # can never be held within it — don't store it and then
                # immediately evict it (or someone else's entries)
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._unindex_locked(old)
            self._entries[key] = e
            self._index_locked(e)
            self._counters["stores"] += 1
            self._candidates.pop(key, None)
            self._evict_over_budget_locked()

    def _spec_admissible(
        self, kind: str, vector: tuple, repair_spec: tuple
    ) -> bool:
        """A repair spec is only usable when every leaf's (field, view)
        is represented by at least one local (int-token) "v" element:
        the patch reads host words through the view registry, which
        only local views live in (every element of the port's vectors
        is local)."""
        if kind != "count" or not self._repair_enabled:
            return False
        op, leaves = repair_spec
        if op not in ("and", "or") or not leaves:
            return False
        local = {
            (el[2], el[3])
            for el in vector
            if el[0] == "v" and isinstance(el[4], int)
        }
        return all((f, v) in local for f, v, _ in leaves)

    # -- internal indexing (all under self._mu) -----------------------------

    def _index_locked(self, e: _Entry) -> None:
        self._bytes += e.nbytes
        self._by_index[e.index] = self._by_index.get(e.index, 0) + e.nbytes
        self._by_text.setdefault((e.key[0], e.text), set()).add(e.key)
        for elem in e.vector:
            if elem[0] != "v":
                continue
            ident = elem[4]
            if isinstance(ident, int):  # local/in-process view token
                self._by_token.setdefault(ident, set()).add(e.key)
        if e.repair_spec is not None:
            for f, v, row in e.repair_spec[1]:
                rows = self._interest.setdefault((e.index, f, v), {})
                rows[row] = rows.get(row, 0) + 1

    def _unindex_locked(self, e: _Entry) -> None:
        self._bytes -= e.nbytes
        left = self._by_index.get(e.index, 0) - e.nbytes
        if left > 0:
            self._by_index[e.index] = left
        else:
            self._by_index.pop(e.index, None)
        tkey = (e.key[0], e.text)
        keys = self._by_text.get(tkey)
        if keys is not None:
            keys.discard(e.key)
            if not keys:
                self._by_text.pop(tkey, None)
        for elem in e.vector:
            if elem[0] != "v":
                continue
            ident = elem[4]
            if isinstance(ident, int):
                keys = self._by_token.get(ident)
                if keys is not None:
                    keys.discard(e.key)
                    if not keys:
                        self._by_token.pop(ident, None)
        if e.repair_spec is not None:
            for f, v, row in e.repair_spec[1]:
                ikey = (e.index, f, v)
                rows = self._interest.get(ikey)
                if rows is not None:
                    n = rows.get(row, 0) - 1
                    if n > 0:
                        rows[row] = n
                    else:
                        rows.pop(row, None)
                        if not rows:
                            self._interest.pop(ikey, None)

    def _drop_locked(self, key: tuple, evict: bool = False) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._unindex_locked(e)
            if evict:
                self._counters["evictions"] += 1

    def _quota_for_locked(self, index: str) -> int:
        q = self._tenant_quota.get(index)
        return q if q is not None else self._tenant_quota_default

    def _evict_over_budget_locked(self) -> None:
        if self._tenant_quota or self._tenant_quota_default > 0:
            # tenant quotas first: over-quota owners shed their own LRU
            # entries before any in-quota entry is touched, and each
            # index is held to its quota even with global budget free
            self._evict_over_quota_locked()
        while self._bytes > self._budget and self._entries:
            self._drop_locked(next(iter(self._entries)), evict=True)

    def _evict_over_quota_locked(self) -> None:
        for key, e in list(self._entries.items()):
            quota = self._quota_for_locked(e.index)
            if quota <= 0:
                continue
            if self._by_index.get(e.index, 0) <= quota:
                continue
            self._drop_locked(key, evict=True)
            self._counters["quota_evictions"] += 1
            self._quota_evictions_index[e.index] = (
                self._quota_evictions_index.get(e.index, 0) + 1
            )

    # -- invalidation funnels ----------------------------------------------

    def note_mutation(self, token: int, shard: int) -> None:
        """A fragment of the view owning `token` mutated (the same
        on_mutate hook that drives dirty-extent invalidation). Entries
        covering that (view, shard) whose result cannot be repaired drop
        eagerly; repairable Count entries stay for the repair window —
        revalidation keeps either choice exact."""
        self.note_mutations(token, (shard,))

    def note_mutations(self, token: int, shards: Iterable[int]) -> None:
        with self._mu:
            keys = self._by_token.get(token)
            if not keys:
                return
            dirty = set(shards)
            for key in list(keys):
                e = self._entries.get(key)
                if e is None:
                    continue
                covered = any(
                    elem[0] == "v"
                    and elem[4] == token
                    and dirty.intersection(elem[5])
                    for elem in e.vector
                )
                if not covered:
                    continue
                if e.repair_spec is None and e.dep_rows is None:
                    self._drop_locked(key)
                else:
                    # kept for the repair/re-key window, but no longer
                    # hit-likely: the admission discount must charge a
                    # possible recompute its full device bytes
                    e.maybe_stale = True

    def note_merges(self, token: int, merges: Iterable[Any]) -> None:
        """The merge barrier just applied staged deltas for fragments of
        the view owning `token` (View.sync_pending). Per covered entry:

        - repair-spec Counts whose touched leaves all live in the
          merging view patch in place under the lock (every leaf's
          base words come from the barrier's consistent capture);
        - repair-spec Counts with leaves in OTHER views become a
          deferred patch job: the other operands' premerge words are
          read outside this lock (fragment locks order below it — see
          Fragment.on_mutate) and the job re-validates the entry's
          whole vector before committing, dropping it on any doubt;
        - entries whose exact `dep_rows` are disjoint from the burst
          re-key forward without recompute (structural revalidation);
        - everything else covering a merged shard drops (stale and
          unrepairable).
        """
        if not merges:
            return
        by_shard = {m.shard: m for m in merges}
        jobs: List[dict] = []
        with self._mu:
            keys = self._by_token.get(token)
            if not keys:
                return
            for key in list(keys):
                e = self._entries.get(key)
                if e is None:
                    continue
                job = self._apply_merges_locked(e, token, by_shard)
                if job is not None:
                    jobs.append(job)
        for job in jobs:
            self._run_patch_job(job)

    def _apply_merges_locked(
        self, e: _Entry, token: int, by_shard: Dict[int, Any]
    ) -> Optional[dict]:
        """In-lock half of merge application. Returns None when fully
        handled (patched, re-keyed, or dropped) or a deferred patch job
        when other-view operand words must be read outside the lock.
        Deferred entries keep their OLD vector until the job commits,
        so they cannot serve a half-patched result — an exact-vector
        hit in the window simply misses."""
        new_vector = list(e.vector)
        changed = False
        count = e.result if e.kind == "count" else None
        units: List[dict] = []
        dep_rekeyed = False
        for i, elem in enumerate(e.vector):
            if elem[0] != "v" or elem[4] != token:
                continue
            field, view = elem[2], elem[3]
            shards, versions = elem[5], list(elem[6])
            spec_here = e.spec_rows(field, view)
            touched = False
            for pos, s in enumerate(shards):
                m = by_shard.get(s)
                if m is None:
                    continue
                if (
                    not self._repair_enabled
                    or not m.applied
                    or not m.clean
                    or versions[pos] != m.base_version
                ):
                    self._drop_locked(e.key)
                    return None
                burst = set(m.rows)
                hit_leaves = spec_here & burst
                if hit_leaves:
                    unit = self._patch_unit_locked(
                        e, elem, s, m, hit_leaves)
                    if unit is None:
                        self._drop_locked(e.key)
                        return None
                    if unit["reads"]:
                        units.append(unit)
                    else:
                        count += unit["delta"]
                        self._counters["repairs"] += 1
                        if len(e.repair_spec[1]) > 1:
                            self._counters["tree_repairs"] += 1
                elif spec_here:
                    # no leaf of the merging view touched: the count
                    # is unchanged and the entry re-keys forward
                    pass
                else:
                    dep = (e.dep_rows or {}).get((field, view))
                    if dep is None or dep & burst:
                        # unknown/total dependence, or a dependent row
                        # changed: the stored result may differ
                        self._drop_locked(e.key)
                        return None
                    dep_rekeyed = True
                versions[pos] = m.new_version
                touched = True
            if touched:
                new_vector[i] = elem[:6] + (tuple(versions),)
                changed = True
        if not changed:
            return None
        if units:
            # defer: commit vector + count together once the operand
            # reads land (outside this lock)
            return {
                "key": e.key,
                "expect": e.vector,
                "vector": tuple(new_vector),
                "base": count,
                "units": units,
                "leaves": len(e.repair_spec[1]),
            }
        e.vector = tuple(new_vector)
        # the clock moved with the burst: disarm the fast path until
        # the next exact-vector revalidation re-reads live clocks
        e.clocks = None
        # patched/re-keyed to the merged versions: hit-likely again
        e.maybe_stale = False
        if e.kind == "count":
            e.result = count
        if dep_rekeyed:
            self._counters["rekeys"] += 1
        return None

    def _patch_unit_locked(
        self, e: _Entry, elem: tuple, shard: int, m: Any, hit_leaves: set
    ) -> Optional[dict]:
        """Build one shard's patch: old/new word arrays for every leaf
        in the merging view (from the barrier's capture — one
        consistent snapshot at base version), plus read descriptors
        for leaves in OTHER views (resolved outside the lock). Returns
        None when the capture is missing (entry raced in after the
        barrier read interest)."""
        op, leaves = e.repair_spec
        field, view = elem[2], elem[3]
        widx: Set[int] = set()
        changed_pairs = []  # (old, new) full-row arrays, merging view
        same_view = []      # old full-row arrays, untouched leaves
        reads = []          # (field, view, row, expect_version)
        for f, v, row in leaves:
            if f == field and v == view:
                old = m.old_words.get(row)
                if old is None:
                    return None
                if row in hit_leaves:
                    wi, wv = m.word_delta(row)
                    new = old.copy()
                    new[wi] |= wv
                    widx.update(int(x) for x in wi)
                    changed_pairs.append((old, new))
                else:
                    same_view.append(old)
            else:
                ver = self._elem_version(e.vector, f, v, shard)
                if ver is None:
                    return None
                reads.append((f, v, row, ver))
        if not widx:
            return {"delta": 0, "reads": [], "shard": shard, "op": op,
                    "widx": (), "changed": (), "same": (), "index": e.index}
        wsel = np.array(sorted(widx), dtype=np.int64)
        changed = tuple((o[wsel], n[wsel]) for o, n in changed_pairs)
        same = tuple(o[wsel] for o in same_view)
        if reads:
            return {"delta": 0, "reads": reads, "shard": shard, "op": op,
                    "widx": wsel, "changed": changed, "same": same,
                    "index": e.index}
        delta = _tree_delta(op, changed, same, ())
        return {"delta": delta, "reads": [], "shard": shard, "op": op,
                "widx": wsel, "changed": changed, "same": same,
                "index": e.index}

    @staticmethod
    def _elem_version(
        vector: tuple, field: str, view: str, shard: int
    ) -> Optional[int]:
        """The version `vector` pins for (field, view, shard) on a
        LOCAL element, or None when no int-token element covers it."""
        for el in vector:
            if (
                el[0] == "v"
                and el[2] == field
                and el[3] == view
                and isinstance(el[4], int)
                and shard in el[5]
            ):
                return el[6][el[5].index(shard)]
        return None

    def _run_patch_job(self, job: dict) -> None:
        """Deferred half of a multi-view tree patch: read the other
        operands' premerge words (fragment locks only — the cache lock
        is NOT held), then commit count + vector iff the entry's vector
        is still exactly what the in-lock half saw. Any surprise —
        operand view gone, fragment version moved past the entry's
        element, vector changed underneath — drops the entry instead:
        revalidation semantics make dropping always safe."""
        total = 0
        ok = True
        for unit in job["units"]:
            other = []
            for f, v, row, expect_ver in unit["reads"]:
                words = self._read_operand(
                    job["key"], f, v, row, unit["shard"], expect_ver)
                if words is None:
                    ok = False
                    break
                other.append(words[unit["widx"]])
            if not ok:
                break
            total += _tree_delta(
                unit["op"], unit["changed"], unit["same"], tuple(other))
        with self._mu:
            e = self._entries.get(job["key"])
            if e is None:
                return
            if e.vector != job["expect"]:
                # a concurrent barrier moved the entry while the reads
                # were in flight: the reads may mix states — drop
                self._drop_locked(job["key"])
                return
            if not ok:
                self._drop_locked(job["key"])
                return
            e.vector = job["vector"]
            e.clocks = None
            e.maybe_stale = False
            e.result = job["base"] + total
            self._counters["repairs"] += len(job["units"])
            if job["leaves"] > 1:
                self._counters["tree_repairs"] += len(job["units"])

    def _read_operand(
        self, key: tuple, field: str, view: str, row: int, shard: int,
        expect_version: int,
    ) -> Optional[np.ndarray]:
        """Premerge words of one other-view operand, with a version
        double-read bracketing the word read: the words are usable only
        if the fragment provably sat at the entry's pinned version the
        whole time (a stage bumps the version BEFORE any content can
        move, so version-stable implies content-stable)."""
        with self._mu:
            ref = self._views.get(self._token_for(key, field, view))
        v = ref() if ref is not None else None
        if v is None:
            return None
        frag = v.fragments.get(shard)
        if frag is None:
            return None
        v0 = frag.version
        if v0 != expect_version:
            return None
        words = frag.premerge_row_words(row)
        if frag.version != v0:
            return None
        return words

    def _token_for(self, key: tuple, field: str, view: str) -> int:
        e = self._entries.get(key)
        if e is None:
            return -1
        for el in e.vector:
            if (
                el[0] == "v"
                and el[2] == field
                and el[3] == view
                and isinstance(el[4], int)
            ):
                return el[4]
        return -1

    def interest_rows(self, index: str, field: str, view: str) -> Set[int]:
        """Rows of (index, field, view) that repairable Count entries
        are watching — the merge barrier captures these rows' pre-merge
        words so note_merges can patch without re-reading operands.
        Fast empty path: one dict lookup under the lock."""
        with self._mu:
            rows = self._interest.get((index, field, view))
            return set(rows) if rows else set()

    # -- view registry --------------------------------------------------------

    def register_view(self, view: Any) -> None:
        """Make `view` resolvable by its `_stack_token` for deferred
        tree-patch operand reads (View.open calls this; drop_view
        removes the registration with the token's entries)."""
        with self._mu:
            self._views[view._stack_token] = weakref.ref(view)

    def repair_likely(self, scope: Optional[Hashable], text: str) -> bool:
        """Whether a maybe-stale entry for (scope, text) is expected to
        come back via repair or re-key rather than recompute — the
        admission estimator's middle tier (sched/cost.py): such a
        repeat costs host microseconds, not device bytes, but charging
        it fully-free would let a recompute bypass the byte budget when
        the repair window closes unluckily."""
        if scope is None:
            return False
        with self._mu:
            keys = self._by_text.get((scope, text))
            if not keys:
                return False
            return any(
                e.repair_spec is not None or e.dep_rows is not None
                for k in keys
                if (e := self._entries.get(k)) is not None
            )

    # -- GC ----------------------------------------------------------------

    def drop_view(self, token: int) -> None:
        """A View closed (field/index delete, fragment drop): entries
        whose vector references it must not outlive it."""
        with self._mu:
            for key in list(self._by_token.get(token, ())):
                self._drop_locked(key)
            self._views.pop(token, None)

    def drop_index(self, index: str) -> None:
        """Label GC on index delete (NodeServer.drop_index_telemetry):
        the per-index byte attribution, the tenant eviction ledger and
        every entry must go with the index. (The quota OVERRIDE stays —
        operator config re-applies if the index is recreated.)"""
        with self._mu:
            for key, e in list(self._entries.items()):
                if e.index == index:
                    self._drop_locked(key)
            self._quota_evictions_index.pop(index, None)

    def drop_scope(self, scope: Hashable) -> None:
        """Drop every entry keyed under one Index's cache scope (rank
        cache recalculation: TopN order can change with no version
        bump)."""
        with self._mu:
            for key in list(self._entries):
                if key[0] == scope:
                    self._drop_locked(key)

    def _clear_locked(self) -> None:
        self._candidates.clear()
        self._entries.clear()
        self._by_token.clear()
        self._by_index.clear()
        self._interest.clear()
        self._by_text.clear()
        self._bytes = 0

    def clear(self) -> None:
        """Drop every entry (counters keep accumulating)."""
        with self._mu:
            self._clear_locked()

    def reset(self) -> None:
        """clear() plus counter reset and tenant-quota reset to
        unlimited (test isolation)."""
        with self._mu:
            self._clear_locked()
            for k in self._counters:
                self._counters[k] = 0
            self._tenant_quota_default = 0
            self._tenant_quota = {}
            self._quota_evictions_index = {}
            self._views = {}

    # -- introspection ------------------------------------------------------

    def has_text(self, scope: Optional[Hashable], text: str) -> bool:
        """Whether a HIT-LIKELY entry is stored for (scope, text) — the
        admission cost estimator's probe (sched/cost.py). Cheap by
        design (no version walk), but entries that observed a covered
        mutation since they last proved fresh are excluded: a
        maybe-stale entry's repeat may recompute at full cost, and
        admitting that byte-free would let it bypass the byte budget."""
        if scope is None:
            return False
        with self._mu:
            keys = self._by_text.get((scope, text))
            if not keys:
                return False
            return any(
                not e.maybe_stale
                for k in keys
                if (e := self._entries.get(k)) is not None
            )

    def stats_snapshot(self) -> Dict[str, Any]:
        """cache.* gauge values (NodeServer.publish_cache_gauges) plus
        the per-index byte attribution."""
        with self._mu:
            snap: Dict[str, Any] = dict(self._counters)
            snap["resident_bytes"] = self._bytes
            snap["entries"] = len(self._entries)
            snap["by_index"] = dict(self._by_index)
            snap["quota_evictions_by_index"] = dict(
                self._quota_evictions_index
            )
            return snap


RESULT_CACHE = ResultCache()
