"""View: groups fragments by shard for one view of a field.

The port of pilosa_tpu/core/view.py: fragment lookup, the staged
bulk-ingest router, the read barrier over staged writes, and the row and
plane stacks the stacked query path stages on the device (through
hbm/residency.py, as shard-major extents keyed by their fragments'
versions). A durable view keeps its fragments under
`<path>/fragments/<shard>` (.snap, .wal, .cache) and opens every
fragment found there.

Writes and the device: an exact write to a shard drops only the stack
entries covering that shard (`invalidate_owner_shard`). A staged write
(`stage_bulk`) drops nothing covered: it marks its shards dirty, and the
read barrier (`sync_pending`) merges every staged fragment the read
touches in one pass (core/merge.py), then patches each resident entry
covering a merged shard in place, old words | merged delta, re-keyed to
the new versions; an entry it cannot patch exactly is dropped. A patch
is one or_bits launch per entry on the launch stream: it ORs the
barrier's merged keys, read where they already are (core/merge.py
GroupKeys), through a segment table of one row per (dirty shard, touched
row), so a plan launched before it reads the old words; an entry pinned
by a plan not yet launched is cloned first and the clone patched. The
coherence hub is not ported.

The result cache (core/resultcache.py) rides the same funnels: each
mutation reports its shard (`note_mutation(s)`), each barrier its merges
(`note_merges`, which patch or re-key cached Counts), and `close` drops
every entry that read the view. `mutation_clock` moves after every
version bump of a fragment of the view, so one integer a view
revalidates a warm cached result.

`delete_fragment` (the holder cleaner's and a rolled-back resize's unit
of work) closes a fragment, removes its files and drops its device rows,
the view's stacks and the cached results that read the view. A fragment
made again for the shard starts above every version the deleted one
reached, so no stack key or cached version vector of the old one
revalidates against it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core import merge as merge_mod
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.devcache import DeviceCache, new_owner_token
from pilosa_tpu_torch.core.fragment import DEFAULT_MAX_OP_N, Fragment, StagedTally
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
from pilosa_tpu_torch.hbm import residency
from pilosa_tpu_torch.ops import merge as ops_merge
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


# moves after a view creates a fragment or closes, the only times a
# shard set of an index can change: Index.shard_list's memo is keyed on it
SHARDS_EPOCH = 0
_epoch_mu = threading.Lock()


def bump_shards_epoch() -> None:
    global SHARDS_EPOCH
    with _epoch_mu:
        SHARDS_EPOCH += 1


class View:
    def __init__(
        self,
        name: str,
        index: str,
        field: str,
        *,
        device: torch.device,
        dcache: DeviceCache,
        mutex: bool = False,
        cache_type: str = "ranked",
        cache_size: int = 50_000,
        path: Optional[str] = None,
    ):
        self.path = path  # the directory holding fragments/; None: in memory
        self.max_op_n = DEFAULT_MAX_OP_N  # passed to each new fragment
        self.name = name
        self.index = index
        self.field = field
        self.device = device
        self.dcache = dcache
        self.mutex = mutex
        self.cache_type = cache_type
        self.cache_size = cache_size
        self._mu = threading.RLock()
        self.fragments: Dict[int, Fragment] = {}
        # staged positions over the fragments (kept by each fragment)
        self.staged = StagedTally()
        # owner token for this view's stacks and TopN tally bundles
        self._stack_token = new_owner_token()
        dcache.tag_owner(self._stack_token, index)
        # bumped after every version bump of a fragment of this view (the
        # mutation funnel and the staged router) and before the write
        # returns: a clock read is never newer than a version vector read
        # after it, which is what lets the result cache arm an entry with
        # (clocks, vector). Its own lock: bumps run under fragment locks.
        self._clock_mu = threading.Lock()
        self.mutation_clock = 0
        # shards with staged writes whose covering stack entries were not
        # dropped at stage time (they are keyed by version, so never
        # served stale): the barrier patches or drops them
        self._dirty_staged: set = set()
        # the version a fragment made from now on starts at: above every
        # version a deleted fragment of this view reached
        self._version_floor = 0

    def open(self) -> "View":
        """Open every fragment of the view's directory (a shard with a
        .snap or a .wal file)."""
        if self.path is not None:
            frag_dir = os.path.join(self.path, "fragments")
            if os.path.isdir(frag_dir):
                for fn in sorted(os.listdir(frag_dir)):
                    if fn.endswith((".snap", ".wal")):
                        shard_s = fn.rsplit(".", 1)[0]
                        if shard_s.isdigit():
                            self.fragment(int(shard_s))
        # the cache's deferred tree patches find the view by its token
        RESULT_CACHE.register_view(self)
        return self

    def fragment(self, shard: int) -> Fragment:
        """Get-or-create (and open) the fragment for a shard."""
        with self._mu:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = Fragment(
                    self.index,
                    self.field,
                    self.name,
                    shard,
                    device=self.device,
                    dcache=self.dcache,
                    mutex=self.mutex,
                    cache_type=self.cache_type,
                    cache_size=self.cache_size,
                    path=None if self.path is None else os.path.join(self.path, "fragments", str(shard)),
                    max_op_n=self.max_op_n,
                    version=self._version_floor,
                ).open()
                frag.on_mutate = lambda s=shard: self._on_fragment_mutate(s)
                with frag._mu:  # what open replayed, then every change
                    self.staged.add(frag._pending_n + frag._premerged_n)
                    frag.staged_tally = self.staged
                self.fragments[shard] = frag
                bump_shards_epoch()
            return frag

    def _on_fragment_mutate(self, shard: int) -> None:
        with self._clock_mu:
            self.mutation_clock += 1
        self.dcache.invalidate_owner_shard(self._stack_token, shard)
        RESULT_CACHE.note_mutation(self._stack_token, shard)

    def close(self) -> None:
        """Close every fragment (WAL, cache sidecar) and drop every device
        tensor this view cached: a deleted field's stacks must not wait
        for LRU pressure to leave."""
        with self._mu:
            for frag in self.fragments.values():
                frag.close()
                self.dcache.untag_owner(frag._token)
                self.dcache.untag_owner(frag._stack_token)
            self.dcache.invalidate_owner(self._stack_token)
            self.dcache.untag_owner(self._stack_token)
            RESULT_CACHE.drop_view(self._stack_token)
            self._dirty_staged.clear()
        bump_shards_epoch()

    def fragment_if_exists(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def delete_fragment(self, shard: int) -> bool:
        """Drop one shard's fragment: close it, remove its snapshot, WAL
        and cache files, and drop its device rows, the view's stacks and
        the results cached over the view. False when there was none."""
        with self._mu:
            frag = self.fragments.pop(shard, None)
            if frag is None:
                return False
            with frag._mu:
                self._version_floor = max(self._version_floor, frag.version + 1)
                self.staged.add(-(frag._pending_n + frag._premerged_n))
                frag.staged_tally = None
            frag.close()
            self.dcache.untag_owner(frag._token)
            self.dcache.untag_owner(frag._stack_token)
            for p in (frag.snap_path, frag.wal_path, frag.cache_path):
                if p is not None:
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass
            with self._clock_mu:
                self.mutation_clock += 1
            self.dcache.invalidate_owner(self._stack_token)
            RESULT_CACHE.drop_view(self._stack_token)
            self._dirty_staged.discard(shard)
        bump_shards_epoch()
        return True

    def available_shards(self) -> List[int]:
        with self._mu:
            return sorted(self.fragments)

    def _frags_for(self, shards: tuple) -> list:
        with self._mu:
            return [self.fragments.get(s) for s in shards]

    def _stack_key(self, kind: str, ident, shards: tuple) -> tuple:
        # no versions here: staging appends each extent's own slice
        return (self._stack_token, kind, ident, shards)

    @staticmethod
    def _frag_versions(frags) -> tuple:
        return tuple(f.version if f is not None else -1 for f in frags)

    # -- the read barrier --------------------------------------------------

    def sync_pending(self, shards=None, frags=None) -> None:
        """Read barrier: merge every listed (default: every) fragment's
        staged delta in one batched pass, then patch or drop the resident
        stack entries covering the merged shards. Only the shards this
        barrier covered are reconciled: other dirty shards stay patchable
        until their own barrier."""
        if frags is None:
            with self._mu:
                if shards is None:
                    frags = list(self.fragments.values())
                else:
                    frags = [self.fragments.get(s) for s in shards]
        merges = merge_mod.merge_barrier(frags)
        if merges:
            # the same merged deltas patch or re-key cached Counts
            RESULT_CACHE.note_merges(self._stack_token, merges)
        synced = {f.shard for f in frags if f is not None}
        with self._mu:
            dirty = self._dirty_staged & synced
        if merges or dirty:
            self._reconcile_extents(merges, dirty)

    def _reconcile_extents(self, merges, dirty: set) -> None:
        """Patch or drop every stack entry covering a shard whose staged
        delta just merged (or merged earlier in a per-fragment read:
        `dirty` remembers those). An entry is patched only when every
        affected fragment was `clean` and the entry is keyed at its
        `base_version`; otherwise it is dropped, unless it is keyed at
        the fragments' current versions already."""
        patches = {m.shard: m for m in merges if m.clean}
        affected = dirty | {m.shard for m in merges}
        stale = affected - set(patches)
        if not affected:
            return
        for key, cover, is_extent in self.dcache.owner_entries(self._stack_token):
            if cover is None:
                self.dcache.invalidate(key)  # not keyed by version
                continue
            hit = cover & affected
            if not hit:
                continue
            if ((hit & stale) or not self._patch_entry(key, hit, patches, is_extent)) and not self._entry_current(
                key, hit
            ):
                self.dcache.invalidate(key)
        with self._mu:
            self._dirty_staged -= affected

    @staticmethod
    def _key_span(key):
        """(shard position of the entry's first shard, its versions, the
        tail kind) of a staged entry's key, or None."""
        tail = key[4:]
        if len(tail) == 4 and tail[0] == "ext":
            return tail[2] * tail[1], tail[3], "ext"
        if len(tail) == 2 and tail[0] == "mono":
            return 0, tail[1], "mono"
        return None

    def _entry_current(self, key, hit: set) -> bool:
        """Whether the entry is keyed at every hit shard's current
        version (a concurrent barrier may have patched it already). The
        version reads take no lock: a racing write makes the key stale
        anyway and marks the shard again."""
        if key[0] != self._stack_token or len(key) < 5:
            return False
        span_of = self._key_span(key)
        if span_of is None:
            return False
        lo, versions, _ = span_of
        for p, s in enumerate(key[3][lo : lo + len(versions)]):
            if s in hit:
                frag = self.fragments.get(s)
                if frag is None or versions[p] != frag.version:
                    return False
        return True

    def _patch_entry(self, key, hit: set, patches, is_extent: bool) -> bool:
        """Patch one resident stack entry to (old words | merged delta) and
        re-key it at the post-merge versions. True: reconciled (patched,
        or no longer resident); False: the caller drops it. Exact only
        when the entry is keyed at each patched fragment's base version
        and the fragment was clean."""
        if key[0] != self._stack_token or len(key) < 5:
            return False
        kind, ident, shards_t = key[1], key[2], key[3]
        if kind == "row":
            row_ids = [ident]
        elif kind == "planes":
            row_ids = list(ident)
        else:
            return False
        span_of = self._key_span(key)
        if span_of is None:
            return False
        lo, versions, tail_kind = span_of
        span = shards_t[lo : lo + len(versions)]
        upd = list(versions)
        deltas = []
        for p, s in enumerate(span):
            if s not in hit:
                continue
            m = patches.get(s)
            if m is None or versions[p] != m.base_version:
                return False
            upd[p] = m.new_version
            deltas.append((p, m))
        if not deltas:
            return False
        arr, pinned = self.dcache.take(key)
        if arr is None:
            return True  # evicted meanwhile: nothing resident to go stale
        n = len(span)
        # one segment table per merged key array (one per barrier group;
        # a barrier makes more than one group only when device memory is
        # short): a row per (dirty shard position p, touched row d)
        tables: Dict[int, tuple] = {}
        for p, m in deltas:
            _, ks, ke, base = tables.setdefault(id(m.keys), (m.keys, [], [], []))
            for d, rid in enumerate(row_ids):
                r = m.key_range(rid)
                if r is not None:  # None: a row the delta did not touch, re-key only
                    ks.append(r[0])
                    ke.append(r[1])
                    base.append((d * n + p) * WORDS_PER_ROW)
        if pinned:
            arr = arr.clone()  # a plan not yet launched holds the old words
        launches = upload = n_keys = 0
        for keys, ks, ke, base in tables.values():
            if not ks:
                continue
            keys_t, up = keys.on(arr.device)
            table = np.array([ks, ke, base], np.int64).T
            upload += up + ops_merge.or_bits(arr, keys_t, table)
            n_keys += int((table[:, 1] - table[:, 0]).sum())
            launches += 1
        new_tail = ("ext", key[5], key[6], tuple(upd)) if tail_kind == "ext" else ("mono", tuple(upd))
        self.dcache.put(key[:4] + new_tail, arr, extent=is_extent, shards=span)
        residency.note_extent_patch(launches, upload, n_keys)
        return True

    # -- stacked operands --------------------------------------------------

    def row_stack(self, row_id: int, shards, extents=None) -> Optional[torch.Tensor]:
        """int32[S, W] device stack of one row over `shards`, or None when
        no listed shard has a fragment. `extents` (hbm.ExtentTable)
        receives the pins on the staged entries."""
        shards = tuple(shards)
        frags = self._frags_for(shards)
        if all(f is None for f in frags):
            return None
        # merge and patch first: the keys below read the merged versions
        self.sync_pending(frags=frags)
        zeros = np.zeros(WORDS_PER_ROW, np.uint32)

        def build_slice(lo: int, hi: int) -> np.ndarray:
            return np.stack([f.row_words(row_id) if f is not None else zeros for f in frags[lo:hi]])

        return residency.stage_row_stack(
            self.dcache,
            self._stack_key("row", row_id, shards),
            len(shards),
            build_slice,
            self.device,
            table=extents,
            versions=self._frag_versions(frags),
            shards=shards,
        )

    def row_resident(self, row_id: int, shards) -> bool:
        """Whether row_stack(row_id, shards) would stage nothing: no listed
        fragment has a staged write for the barrier to merge, and every
        extent at the fragments' versions is cached (or no listed shard has
        a fragment). Pins and copies nothing."""
        shards = tuple(shards)
        frags = self._frags_for(shards)
        if all(f is None for f in frags):
            return True
        if any(f is not None and f._pending_n for f in frags):
            return False
        return residency.resident(
            self.dcache, self._stack_key("row", row_id, shards), len(shards), self._frag_versions(frags)
        )

    def plane_stack(self, row_ids, shards, extents=None) -> Optional[torch.Tensor]:
        """int32[D, S, W] device stack (rows x shards), or None when no
        listed shard has a fragment. A row a fragment lacks reads as zero
        words (an int field's high plane that older shards never wrote
        after its bit depth grew). Extents cut the shard axis and carry
        all D rows."""
        row_ids = tuple(row_ids)
        shards = tuple(shards)
        frags = self._frags_for(shards)
        if all(f is None for f in frags):
            return None
        self.sync_pending(frags=frags)

        def build_slice(lo: int, hi: int) -> np.ndarray:
            part = frags[lo:hi]
            out = np.zeros((len(row_ids), len(part), WORDS_PER_ROW), np.uint32)
            for j, f in enumerate(part):
                if f is not None:
                    f.rows_words_into(row_ids, out[:, j])
            return out

        return residency.stage_plane_stack(
            self.dcache,
            self._stack_key("planes", row_ids, shards),
            len(shards),
            build_slice,
            self.device,
            table=extents,
            versions=self._frag_versions(frags),
            shards=shards,
        )

    def stage_bulk(self, shards: np.ndarray, positions: np.ndarray) -> None:
        """Bulk-ingest router: one argsort splits the batch into per-shard
        chunks, each staged on its fragment. Then, once for the batch:
        the fragments' own device rows and the view's uncovered entries
        (TopN tally bundles) drop, and the shards are marked dirty for
        the barrier, which patches the covered entries."""
        if not len(shards):
            return
        order = np.argsort(shards)
        sh = shards[order]
        pos = positions[order]
        bounds = np.flatnonzero(sh[1:] != sh[:-1]) + 1
        starts = np.concatenate(([0], bounds)).astype(np.int64)
        tokens = []
        dirty = []
        try:
            # one group commit for the whole batch, at the barrier's exit
            with walmod.GROUP_COMMIT.barrier():
                for shard, chunk in zip(sh[starts].tolist(), np.split(pos, bounds)):
                    frag = self.fragment(int(shard))
                    frag.stage_positions(chunk, notify=False)
                    tokens.append(frag._token)
                    tokens.append(frag._stack_token)
                    dirty.append(int(shard))
        finally:
            # a fragment's cutover barrier can stop the batch part way: the
            # shards staged before it still need their notices
            self._staged_notices(tokens, dirty)

    def _staged_notices(self, tokens: list, dirty: list) -> None:
        """What stage_bulk owes the device cache, the mutation clock and
        the result cache for the shards it staged."""
        if not dirty:
            return
        self.dcache.invalidate_owners(tokens)
        with self._clock_mu:
            self.mutation_clock += 1
        self.dcache.invalidate_owner_uncovered(self._stack_token)
        # stage_positions ran notify=False: report the shards here (stale
        # unrepairable results drop, repairable Counts wait for the barrier)
        RESULT_CACHE.note_mutations(self._stack_token, dirty)
        with self._mu:
            self._dirty_staged.update(dirty)

    def set_bit(self, row_id: int, col: int) -> bool:
        return self.fragment(col // SHARD_WIDTH).set_bit(row_id, col)

    def clear_bit(self, row_id: int, col: int) -> bool:
        frag = self.fragment_if_exists(col // SHARD_WIDTH)
        return frag.clear_bit(row_id, col) if frag is not None else False

    def set_value(self, col: int, bit_depth: int, value: int, clear: bool = False) -> bool:
        return self.fragment(col // SHARD_WIDTH).set_value(col, bit_depth, value, clear)

    def value(self, col: int, bit_depth: int):
        frag = self.fragment_if_exists(col // SHARD_WIDTH)
        if frag is None:
            return 0, False
        return frag.value(col, bit_depth)
