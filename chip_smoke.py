#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pilosa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--shards 1024] [--seed 0]

Phases, each fatal on any mismatch or exception:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. kernels: build the hand-written CUDA kernels from the checkout (one
   nvcc per source, started together; ptxas' registers, stack frame and
   spills per function are printed), then hold each against its
   plain-PyTorch twin on the card (exact equality) at awkward shapes,
   including the popcount wrap mod 2^32, count2 over lists of 0-300
   segments of mixed widths and alignments (one launch each), plan_count
   at tile-edge widths, S = 1, one leaf, PUSH_ZERO alone, 48 leaves, a
   40-deep nest, the full stack depth and a table too large for shared
   memory, gather_tally on shard-major rows sharing words, a 10^5-entry
   segment, entries in no segment, src's last word, unaligned views and
   1024 shards x 8 rows with uniform and Zipf-skewed segment lengths,
   for the BSI kernels, depths 1..32, signed and unsigned fields, filters,
   every range kind and edge predicates, and the slab steps
   bsi_min_max_step and bsi_range_step chained over slabs of 1, 3, 7, 16
   and 32 planes at depths 1..32 (33-bit keys, every job shape of a
   condition), each chain equal to its twins' and to the whole-stack
   kernel's result, and for GroupBy's kernels
   counts_cross at widths that pack one to eight word ranges into its
   16 x 8 tensor-core tile, either way round, and that span several tiles
   (G = 2..40, R up to 70; G = 1 goes to rows_counts) and gather_and on aligned and unaligned slabs, a filter
   broadcast and a cross expansion past one 16-output chunk; for the
   merge barrier's kernels, or_bits on an empty table, an empty segment,
   one key, bit 31, the entry's last word, a word's run across the
   kernel's chunk boundary, two rows of a planes entry and 10^7 keys
   (tables outside the keys or the entry refused, the entry unchanged)
   and merge_mark on empty
   input, one key, all keys equal, sorted runs, keys near 2^63 - 1 and
   2^24 keys with duplicates, and the whole device merge against the
   host merge; plan_rows on random depth-3 trees with Shift nodes (n = 1,
   31, 32, 33, 2^20 - 1, 2^20; predecessor tables with gaps and -1s) at
   S = 1 and 13, hand-built programs at tile-edge widths and W % 4 != 0,
   unaligned views and a shard chunk; plan_count_multi at S = 1024, W =
   32768 for 2, 16 and 64 random roots over 4, 16 and 32 shared leaves;
3. main path: a 2^30-column index (1024 shards x 2^20 columns) with
   dense and sparse rows of a set field `f` and dense rows of `g`, loaded
   through Field.import_row_words / Field.import_bits / Set(), then the
   query set through Executor.execute, each answer held to an independent
   numpy computation on the generated words (byte-LUT popcount). Kernel
   launch counts are reset just before this phase and read just after it;
   every kernel of the path (plan_rows for Row and Shift results) must
   have launched, Row(f=1).count() over
   every shard's segment must make exactly one count2 launch, and
   TopN(f, Row(g=0), n=10) exactly one gather_tally launch, a 4-Count
   request exactly one plan_count_multi launch and no other; a filtered
   TopN under a device budget a quarter of which holds half the shards'
   rows tallies its filter in 2 shard chunks, held to numpy. Rows (with
   previous, limit, column) and GroupBy (one child; two children, with a
   filter, with limit and offset) follow, held to numpy; at 1024 shards
   the two-child GroupBys take the pruned descent and must launch
   counts_cross, gather_and and count2 or rows_counts;
3b. BSI path: two int fields on the same index, `amount` (signed,
   [-1e6, 1e6], about 90% of columns) and `age` (unsigned, [0, 120], every
   existing column), loaded through Field.import_values (8 shards) and
   the BSI view's fragment word imports (the rest), plus PQL Set/Clear of
   values, and `deep` (signed, 32 bits: values in +-(2^32 - 1) on 1 column
   in 16, the density cut for ingest time) through fragment word imports;
   then Sum/Min/Max (filtered and not, a Shift in the filter carried
   across shards, a non-call filter=), condition-row counts and condition
   rows in trees, each held to numpy answers built per shard while
   generating, at the default slab of 16 planes (amount and deep stream
   their planes in slabs) and again at 4 (every int field streams), with
   each query's slabs, slab bytes and launches of the streamed path
   printed. Launch counts are reset before and read after this phase
   too; bsi_sum, bsi_min_max, bsi_min_max_step, bsi_range and
   bsi_range_step must have launched;
3c. BSI slab residency: under a device budget a quarter of which holds
   22 [S, W] rows, Sum, Min and Count(Row(amount > 500000)) must run in
   one shard chunk at a slab of 16 and in two at 64 (the whole stack);
   chunks, launches, the card's peak memory and p50s printed;
4. timing: each kernel at the shapes the main paths gave it (count2 at
   Row.count()'s 1024 segments) against its twin: device time as 20
   back-to-back calls between two CUDA events, divided by 20, with a
   sleep kernel holding the card until all 20 are queued (so the host's
   dispatch stays out of it), and dispatch time, the host time of one
   call with the card idle (median of 20); each query's warm p50 latency
   over 20 runs. gather_tally's bound counts the 32-byte sectors of src
   that its entries touch, and it is timed again over Zipf-skewed segment
   lengths with the same number of entries; counts_cross and gather_and
   at the main path's GroupBy shapes, and counts_cross again at a
   one-shot shape (16 prefixes x 8 rows over 64 shards); plan_rows at 2
   leaves, at the 28-leaf tree and for a Shift over one leaf; the
   in-process p50s of Row(f=1), Count(Shift(Row(f=6), n=1)) and the
   6-Shift-twin Count printed beside their figures before plan_rows; the
   three BSI kernels again over `deep` at depth 32 (their edge
   predicates up to 2^32 - 1 held to the twin first); the slab steps at
   deep's two [16, S, W] slabs, the first (state written) and the last
   (state read, result reduced), and amount's last;
4b. residency, on the main path's holder (extent_rows 256: 4 extents a
   1024-shard stack), launch counts reset before and read after: the
   query set Count(Intersect(Row(f=0), Row(g=0))), Count(Union(Row(f=0),
   Row(f=1), Row(g=1))), Count(Not(Row(f=1))), TopN(f, Row(g=0), n=10),
   Sum(Row(g=0), field=amount) and Row(f=0) + .count(), every answer held
   to numpy on the words as they stand after each write. (a) twice warm:
   the second pass re-stages 0 bytes; (b) a staged burst of 2^21 columns
   into f row 0 and 2^21 into g row 0 (_exists tracked), then the set:
   one device merge per staged view (f, g, _exists), entries patched in
   place by or_bits from the merged keys (on the device route only the
   chunk tables go up: under 1/50 of 12 bytes a key applied), 0 bytes
   re-staged by the first Count; again with the host
   barrier (merge device_threshold -1), barrier ms side by side; (c) one
   PQL Set into f row 0: the next Count re-stages exactly one extent
   (32 MiB); or_bits, merge_mark, the device merge and the assembly of 4
   extents timed at these shapes, the first three rotating over 8 data
   sets that together exceed the L2 (each extent of Row(f=0) and
   Row(g=0) with its burst keys, or_bits alone and with its table copy;
   8 bursts of keys), and the host and
   device merge routes timed whole at 2^12..2^21 keys around the AUTO
   threshold, with numpy's version and np.unique alone; (d) paging: the budget set one extent
   below the set's working set, 3 cycles with extents and 3 with whole
   stacks, extents re-staging less in every cycle after the first, no pin
   left between queries; (e) a fresh 8-shard index under a budget below
   4 x one shard's stack answers a two-leaf Count and a filtered TopN;
4c. time, on the main path's holder, launch counts reset before and read
   after: a YMDH time field t over the index's first 128 shards (cut
   from every shard for the script's time) (2 rows, 32 random
   columns per shard, hour and row over 192 hours from 2024-01-01:
   786,432 bits a row, each in
   its Y, M, D and H views and the standard view) through one
   Field.import_bits per row with a datetime64 timestamp array, and a
   bool field b over the columns row 0's events touch; the 47-view range
   2024-01-02T03:00..2024-01-08T21:00 in Count, Row, an Intersect, an open
   bound, Count(Shift(n=1)), Shift(n=33), a filtered TopN, Rows, GroupBy,
   MinRow/MaxRow (filtered and not) and bool Counts, each held to a numpy
   model of the raw events; a burst of 2^20 timestamped columns into the
   resident hour view 2024-01-08T20 (patched in place: 0 bytes re-staged);
   p50s; the 47-leaf Row's and the Shift Row's device times against their
   bounds; then Store of the range, ClearRow and a bool flip;
5. serve: the port's NodeServer on the card, driven only over HTTP on one
   kept-alive connection, on a data dir (WAL, snapshots, group commit:
   the deployment users run) under the default temp dir, whose
   filesystem and free bytes are printed first (at least 2 GiB free, or
   the phase fails). Index `s` over 2^28 columns (256 shards: cut to keep
   the script inside its time; it had 512 before): set field
   `f` (2 dense, 4 sparse rows) through one import-roaring POST per shard,
   set field `g` (2 sparse rows) through /import JSON in batches of 5000,
   int field `amount` in 4 shards (8 before) through import-value; every import
   returns once its writes are fsynced, so the ingest rates are durable
   rates, and the numpy roaring decode is timed apart from the rest of
   the import-roaring requests (its share printed). Export-roaring of 4 shards reads back exactly what went in, and
   a Set/Clear changes the next Count by exactly its effect. Then 11
   queries (Counts, Row, TopN with and without a filter, Sum/Min/Max, a
   condition count), each held to numpy and to Executor.execute on the
   server's holder; launch counts are reset before the served query set
   and read after it, and six kernels must have launched (amount's Min/Max
   and its condition Count on the slab steps). Rows(f) and
   GroupBy(Rows(f), Rows(g)) are served too, held to numpy and to the
   executor (counts_cross launches). An unknown index answers 404; 8 clients x 2 rounds must get the serial answers; served and
   in-process p50s per query and the HTTP ingest rates are printed. The
   CLI (`python -m pilosa_tpu_torch.cli server`) must serve on the card
   and exit 0 on SIGTERM, and exit non-zero with CUDA_VISIBLE_DEVICES="";
5b. keyed: on the same node, after those measurements, index `k` with
   keys: 2^19 column keys in a seeded random arrival order, a keyed set
   field `segment` (32 keys, 1-3 per column, Zipf), a keyed mutex field
   `country` (64 ISO codes, Zipf), an unkeyed set field `plan` and an int
   field `spend`, loaded through /import with rowKeys/colKeys and
   import-value with colKeys in batches of 100,000 (keys/s and bits/s
   printed); a keyed Set of new keys, a Count of a key never seen, then
   12 keyed queries (Counts, a keyed Row, TopN, Rows, GroupBys one-shot
   and by descent, the previous=[...] cursor, Sum), each held to a numpy
   + dict model and to the executor, with served and in-process p50s;
5c. time served: a YMDH time field and a bool field on index `s` through
   HTTP DDL, 40,000 timestamped /import bits over 48 hours on existing
   columns of its first 16 shards; time-range
   Count, Row and Rows bodies and bool Counts held to numpy and to the
   executor;
5d. attributes served: SetRowAttrs on every row of f and g, 10^5
   SetColumnAttrs in batches of 1000 over columns of Row(g=0) and of a
   sparse row of f; Row bodies with and without columnAttrs=true,
   Options (excludeColumns, columnAttrs, shards) and TopN(attrName=,
   attrValues=) with and without a filter, each held to a numpy + dict
   model and to the executor, with served p50s; Row(g=0) with columnAttrs
   in process must make no Row.columns() call;
5e. front end: a second NodeServer, in memory, with the reference's
   front-end defaults (16 concurrent queries, a queue of 128, a 64 MB
   result cache with count repair, prefetch depth 4) on the serve
   phase's f/g words (f rows 0-3, g rows 0-1, existence) over its 256
   shards: with the cache budget at 0, 32 client threads x 20
   single-Count requests over 8 distinct trees, every answer held to
   numpy, the Count batcher must merge rounds and launch
   plan_count_multi (requests/s and p50 at 1 and 32 clients, the batch
   sizes and the prefetcher's warms printed); with the cache on, a
   repeated Count is a hit with no launch and no host read, after a
   staged /import of 1000 bits into its row it is repaired with no
   plan_count* launch, after a Clear it is recomputed, each equal to
   numpy; then a node of 8 shards with one slot and no queue answers 429
   with Retry-After while the slot is held and 200 after. (Phase 5 and
   the durable phase serve with the result cache off, so their p50s
   time execution as before it was ported.)
6. durable: the serve phase's node is stopped and the card's cache
   emptied; a second NodeServer opens the same data dir, timed from
   construction to its first 200 on /status (recovery). The 11 queries'
   first pass and warm p50s follow: every body must equal the one served
   before the restart byte for byte (and numpy's answer), as must the
   Rows/GroupBy, every keyed, every time and every attribute body (the
   time views reopened and the attribute logs replayed from the data
   dir), and the six kernels must launch
   again (counts reset just before). `inspect` of its keyed index and
   `check` of the stopped dir must exit 0, `check` with no bad file. Then
   kill -9: a CLI server on a fresh dir at 8 shards takes /import,
   import-value and PQL Set/Clear writes (the last ones in the WAL, after
   the last snapshot), is SIGKILLed after the last acknowledgement and
   restarted: every acknowledged bit and value must read back
   (export-roaring of every shard of both views, Count, Sum), and every
   acknowledged pair of a keyed index (keyed /import, then keyed PQL Sets
   in the WAL) through its CSV export. Again with
   --wal-sync-interval 0.2: the writes lost are counted, and none
   acknowledged before the last interval may be. The two kill -9 nodes
   run at once, each on its own dir, while the offline tools read the
   stopped one.
7. cluster: three `python -m pilosa_tpu_torch.cli server` processes on
   the card (`--cluster-hosts n0@...,n1@...,n2@... --replicas 2`, a
   probe every 0.5 s, the result cache off), each on a data dir of its
   own; nvidia-smi must show three more compute processes (or, where it
   reports another pid namespace, three contexts' worth of memory and
   each node's CUDA device). Through n0 only: index `c` over 512 shards
   (2^29 columns), set field `f` with 4 dense rows (densities 2^-4 to
   2^-7, nested) and 4 sparse ones, `g` with 4 dense rows (2^-5 to
   2^-8) and `h` with 8 sparse rows, one import-roaring POST a shard and
   field (8 client threads; each body goes to both owners), `amount` on
   64 shards (one column in 64) by /import-value, and a keyed index `ck`
   of 2^16 column keys and 8 row keys by one keyed /import; a keyed Set
   through n1 (its key stores forward the new keys to n0's). Then 26
   queries on `c` (the set algebra, a 3-Count batch, Rows, Shift, TopN
   with and without a filter, Rows, GroupBy of two and three children,
   Sum/Min/Max, a condition Count; a Count, an Intersect and a Sum over
   a Shift, whose carry crosses into shards another node answers,
   MinRow/MaxRow and a GroupBy with an offset, with and without a limit)
   and 3 keyed ones through every node (the nodes asked at once, a client
   thread each, here and in every later round; the data are made from
   --seed while the nodes start),
   each equal to numpy and the same on every node, with n0's served
   p50s; kill -9 of n2: n0 and n1 DEGRADED, every answer again through
   them; with n2 down, through n0: a new row of `f` on 32 shards n2 owns
   (16 as primary, 16 as replica), Sets of it on 4 more, a SetRowAttrs
   and a SetColumnAttrs: n0's /status shows pendingRepairs > 0; n2
   restarted on its data dir: NORMAL, and its block digests of the
   written shards differ from their co-owners'. Anti-entropy: `POST
   /internal/sync` on n0, n1 and n2 in turn (each pass's seconds,
   synced, reached and blocks merged printed); pendingRepairs 0 on
   every node; both owners' block digests equal on every written shard
   and on 16 more (field, shard) pairs drawn from --seed; one more pass
   a node repairs nothing and moves no node's restage_bytes; then every
   answer through n2 and n0 equal to numpy with the downtime writes,
   the new row's Count, filtered TopN, row and column attributes
   included. Then the resize: a CLI node n3 starts with `--join <n0>`
   while a writer imports a new row 9 of f (1000 bits a shard on every
   shard) through n0 in batches (again while the job runs), retrying
   503s and counting every acknowledged bit; the job is polled to DONE; every node reports 4
   members and NORMAL and no pending repair; n3 answers
   Count(Intersect(Row(f=0), Row(g=1))) (first pass and warm p50); every
   query through n0-n3 equals numpy with the writer's bits (Count(Row(f=9))
   the acknowledged count); the holder cleaner (the job's last phase) left
   each node exactly the fragments the 4-node placement assigns it, and the
   device-resident bytes fell on every node it took fragments from; a
   pass on each node that still owes a repair leaves pendingRepairs 0
   (the job's moves owe their new owners a repair, which its own passes
   repay, and so does a write a node missed while a probe held it DOWN),
   and one more on n3 repairs nothing and moves no restage_bytes. Then `POST /cluster/resize/remove-node` of n3
   and the same checks on n0-n2 (the 3-node placement); n3 stops. Each
   node logs its kernel launches as it stops: their sum must show every
   kernel of the cluster's queries, and n3's the kernels its answers
   ran. Then
   counts_cross at the cluster GroupBy's leg shapes (G = 11 x R = 8 over
   171 shards, 8 x 8 over 256) against its twin, timed, with its bound,
   and held to its twin at G = 12, 16 and 17 x R = 8 over 171.

The second-to-last lines are the card's name and power limit and one JSON
object with a row per kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory rate
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
REPS = 20
PLAIN_REPS = 5  # calls a twin's timing averages at the main path's shapes (20 until PR 11: the count2 twin takes 0.34 s a call)
# the set-field phase's depth: dense and sparse rows of `f`, rows of `g`
# (8 dense rows since the BSI phase joined the run; 16 before)
N_DENSE, N_SPARSE, N_G = 8, 8, 4

_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def np_popcount(words: np.ndarray) -> int:
    """Set bits of uint32 words: numpy's bitwise_count where numpy has it
    (2.0 on), else the byte table."""
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(words).sum(dtype=np.int64))
    return int(_LUT[np.ascontiguousarray(words).view(np.uint8)].sum(dtype=np.int64))


def sorted_unique(a) -> np.ndarray:
    """np.unique's values of an integer array, from a sort: numpy 2.3's
    np.unique finds unique integers through a hash table, about 50x slower
    at 2^21 keys (the `residency routes` line times it)."""
    a = np.sort(np.asarray(a).reshape(-1))
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if len(a) else a


def np_groups(rows_a, rows_b, filt=None):
    """{(i, j): popcount(a_i & b_j [& filt])} over the non-zero pairs of
    two lists of [S, W] word arrays: the numpy answer of a two-child
    GroupBy over row ids 0.., 0.."""
    out = {}
    for i, a in enumerate(rows_a):
        if filt is not None:
            a = a & filt
        for j, b in enumerate(rows_b):
            n = np_popcount(a & b)
            if n:
                out[(i, j)] = n
    return out


def group_json(fields, groups, keys=None):
    """The public JSON of a GroupBy answer from {(row ids...): count},
    sorted by row ids; keys[k] maps child k's row ids to row keys."""
    out = []
    for ids in sorted(groups):
        group = []
        for k, (fname, rid) in enumerate(zip(fields, ids)):
            if keys is not None and keys[k] is not None:
                group.append({"field": fname, "rowKey": keys[k][rid]})
            else:
                group.append({"field": fname, "rowID": int(rid)})
        out.append({"group": group, "count": int(groups[ids])})
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_SLEEP = {}


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    if "per_ms" not in _SLEEP:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SLEEP["per_ms"] = 20_000_000 / start.elapsed_time(end)
    return _SLEEP["per_ms"]


def cuda_time_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: `reps` calls back to back between two CUDA
    events, divided by `reps`. A sleep kernel queued ahead of the first
    event holds the card until every call is queued, so the host's dispatch
    work between calls stays out of the figure."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (1.5 * host_ms + 2.0)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def dispatch_ms(fn, reps: int = REPS) -> float:
    """Host time of one call with the card idle (median of `reps`): what the
    wrapper costs the host before the card starts."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_p50_ms(fn, reps: int = REPS) -> float:
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def zipf_lengths(rng, total: int, n: int, cap: int, a: float = 1.0) -> np.ndarray:
    """n segment lengths min(cap, floor(c / rank^a)) over a random order of
    the ranks 1..n (Zipf, exponent a), c chosen so that they sum to about
    `total`."""
    r = rng.permutation(np.arange(1, n + 1)).astype(np.float64)
    lo, hi = 1.0, float(total) * n
    for _ in range(100):
        c = (lo + hi) / 2
        lo, hi = (c, hi) if np.minimum(cap, np.floor(c / r**a)).sum() < total else (lo, c)
    return np.minimum(cap, np.floor(hi / r**a)).astype(np.int64)


def shard_major_idx(rng, lens: np.ndarray, w: int, pool: int = 0) -> np.ndarray:
    """gather_tally entries laid out as the executor lays out a filtered
    TopN's sparse rows: for lens[S, R], segment j * R + k holds lens[j, k]
    distinct sorted words of shard j's slice of an [S, w] src (drawn from
    `pool` words per shard when pool > 0, so the rows share words)."""
    parts = []
    for j, row_lens in enumerate(lens):
        words = rng.choice(w, pool, replace=False) if pool else None
        for n in row_lens:
            if words is not None:
                ws = rng.choice(words, n, replace=False)
            elif n > w // 8:
                ws = rng.choice(w, n, replace=False)
            else:  # a few more draws than n, deduplicated, then n of them
                ws = np.unique(rng.integers(0, w, n + n * n // w + 8))
                ws = rng.choice(ws, n, replace=False) if len(ws) >= n else rng.choice(w, n, replace=False)
            parts.append(j * w + np.sort(ws))
    return np.concatenate(parts).astype(np.int32)


def sector_bytes(idx, n_seg: int) -> tuple:
    """gather_tally's least traffic: idx and mask (8 B per entry), starts,
    ends and out (12 B per segment), and 32 B per distinct 32-byte sector of
    src that idx touches (src is 256-byte aligned); also the sector count."""
    sectors = len(sorted_unique(idx.cpu().numpy().astype(np.int64) >> 3))
    return 8 * idx.numel() + 12 * n_seg + 32 * sectors, sectors


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def multi_programs(rng, n_roots: int, n_leaves: int):
    """Postfix programs of `n_roots` Count trees over `n_leaves` shared
    leaves, as a batch of clients sends them: a Row, or an n-ary and, or,
    xor or andnot of 2-4 distinct Rows, every leaf used at least once."""
    from pilosa_tpu_torch.ops import kernels as K

    ops = ("and", "or", "xor", "andnot")
    progs = []
    for r in range(n_roots):
        k = int(rng.integers(1, 5))
        ids = [r % n_leaves] + [int(i) for i in rng.choice(n_leaves, size=k - 1, replace=False) if i != r % n_leaves]
        op = K.BINOPS[ops[int(rng.integers(len(ops)))]]
        progs.append([ids[0]] + [x for i in ids[1:] for x in (i, op)])
    return progs


def chain_programs(rng, n_roots: int, n_leaves: int, length: int):
    """Postfix programs of `n_roots` n-ary chains of `length` distinct
    leaves each (and, or, xor, andnot mixed), root r starting at leaf r."""
    from pilosa_tpu_torch.ops import kernels as K

    ops = ("and", "or", "xor", "andnot")
    progs = []
    for r in range(n_roots):
        ids = [r % n_leaves] + [int(i) for i in rng.permutation(n_leaves) if i != r % n_leaves][: length - 1]
        progs.append([ids[0]] + [x for i in ids[1:] for x in (i, K.BINOPS[ops[int(rng.integers(len(ops)))]])])
    return progs


def kernel_phase(rng, dev, errs):
    import torch

    from pilosa_tpu_torch.exec import plan as planmod
    from pilosa_tpu_torch.ops import kernels as K

    def rand_words(*shape):
        return torch.from_numpy(
            rng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)
        ).to(dev)

    def same(name, got, want):
        if not got.numel():  # an empty result: only its shape can differ
            check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}, twin {tuple(want.shape)}")
            return
        diff = int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs().max().item())
        errs[name] = max(errs.get(name, 0), diff)
        check(diff == 0, f"{name}: kernel differs from its twin by {diff}")

    def cpu(t):
        return t.cpu()

    # count2 / popcount at awkward shapes; [1:] views are not 16-byte aligned
    for shape in [(1,), (7,), (1000,), (3, 12345), (3, 13, 32768)]:
        a, b = rand_words(*shape), rand_words(*shape)
        for op in ("and", "or", "xor", "andnot"):
            same("count2", K.count2(a, b, op), K.count2(cpu(a), cpu(b), op))
        same("count2", K.popcount(a), K.popcount(cpu(a)))
        fa, fb = a.reshape(-1)[1:].contiguous(), b.reshape(-1)[1:].contiguous()
        fa2 = a.reshape(-1)[1:]  # a view: data_ptr offset by 4 bytes
        fb2 = b.reshape(-1)[1:]
        same("count2", K.count2(fa2, fb2, "and"), K.count2(cpu(fa), cpu(fb), "and"))
        same("count2", K.popcount(fa2), K.popcount(cpu(fa)))
    # segment lists, one launch each: 0, 1, 3, 37 and 300 segments of mixed
    # widths (empty, under one uint4, across the 4096-word tile edge, the
    # shard width), each starting 0-3 words past a 16-byte boundary
    check(K.count2_segments([], None, "none").numel() == 0, "count2 over no segments")
    widths = [0, 1, 3, 4, 5, 1000, 4095, 4096, 4097, 8192, 12345, 32768]
    for n_seg in (1, 3, 37, 300):
        ws = [int(rng.choice(widths)) for _ in range(n_seg)]
        offs = rng.integers(0, 4, size=(2, n_seg))
        a_l = [rand_words(w + 3)[o : o + w] for w, o in zip(ws, offs[0])]
        b_l = [rand_words(w + 3)[o : o + w] for w, o in zip(ws, offs[1])]
        for op in ("none", "and", "or", "xor", "andnot"):
            bl = None if op == "none" else b_l
            before = K.LAUNCHES["count2"]
            got = K.count2_segments(a_l, bl, op)
            launched = K.LAUNCHES["count2"] - before
            check(launched == (1 if sum(ws) else 0), f"count2 over {n_seg} segments made {launched} launches")
            same("count2", got, K.count2_segments_plain([cpu(x) for x in a_l], None if bl is None else [cpu(x) for x in bl], op))
    # the wrap: 2^27 all-ones words hold 2^32 bits, which must read 0 from
    # count2/popcount and exactly 2^32 as a segment count
    ones = torch.full((1 << 27,), -1, dtype=torch.int32, device=dev)
    got = K.popcount(ones)
    same("count2", got, K.count2_plain(ones, None, "none"))
    check(int(got.item()) == 0, f"popcount wrap: 2^32 bits read {int(got.item())}")
    got = K.count2(ones, ones, "and")
    check(int(got.item()) == 0, f"count2 wrap: 2^32 bits read {int(got.item())}")
    got = K.count2_segments([ones, ones[:5]], None, "none").tolist()
    check(got == [1 << 32, 160], f"count2_segments over 2^32 bits: {got}")
    del ones
    print("kernels: count2/popcount and count2_segments (0-300 segments, one launch each) "
          "equal to twins (incl. wrap mod 2^32 and the exact 2^32 segment count)")

    # rows_counts: R = 1 and 13, W = 32768, filters of 0, 1 and S rows
    for r, s in [(1, 1), (13, 13), (3 * 13, 13), (5, 5)]:
        stack = rand_words(r, 32768)
        for filt in (None, rand_words(32768), rand_words(s, 32768)):
            want = K.rows_counts_plain(cpu(stack), None if filt is None else cpu(filt))
            same("rows_counts", K.rows_counts(stack, filt), want)
    odd = rand_words(4, 1001)  # W % 4 != 0: scalar path
    same("rows_counts", K.rows_counts(odd, odd[0].contiguous()), K.rows_counts_plain(cpu(odd), cpu(odd[0])))
    print("kernels: rows_counts equal to twin (filters of 0, 1 and S rows)")

    # plan_count: random depth-3 trees with andnot, xor and PZero leaves
    s, w, n_leaves = 13, 32768, 5
    operands = [rand_words(s, w) for _ in range(n_leaves)]
    seen = set()

    def tree(depth):
        if depth == 0:
            if rng.random() < 0.15:
                seen.add("zero")
                return planmod.PZero()
            return planmod.PLeaf(int(rng.integers(n_leaves)))
        op = str(rng.choice(["and", "or", "xor", "andnot"]))
        seen.add(op)
        k = int(rng.integers(2, 4))
        return planmod.PNary(op, tuple(tree(depth - 1) for _ in range(k)))

    for _ in range(24):
        root = tree(3)
        leaves, _, prog = planmod._compile(root, operands, {})
        if not leaves:
            continue
        for n in (s, s - 4):
            want = K.plan_count_plain([cpu(t) for t in leaves], prog, n)
            same("plan_count", K.plan_count(leaves, prog, n), want)
    check({"andnot", "xor", "zero"} <= seen, f"plan trees lacked a case: {seen}")
    # the edges of the kernel's tiles (512 uint4 of a row, 256 for programs
    # more than 9 entries deep) and items: W not a multiple of the tile,
    # below one tile, one uint4; S = 1; one leaf; a program of PUSH_ZERO
    # alone
    deep = [i % 3 for i in range(11)] + [K.BINOPS["xor"]] * 10  # 11 deep: the 256-uint4 tile
    progs3 = [[0], [K.PUSH_ZERO], [0, 1, K.BINOPS["and"]], [0, 1, 2, K.BINOPS["xor"], K.BINOPS["rev_andnot"]], deep]
    for es, ew in ((1, 32768), (5, 1000), (3, 32772), (2, 4), (1, 1024)):
        ops3 = [rand_words(es, ew) for _ in range(3)]
        for prog in progs3:
            lv = ops3[: max([i + 1 for i in prog if i >= 0] or [1])]
            same("plan_count", K.plan_count(lv, prog, es), K.plan_count_plain([cpu(t) for t in lv], prog, es))
    # wide and deep: 48 leaves in one node, a 40-level nest, an andnot whose
    # head comes last (rev_andnot), a hand-built program at the full stack
    # depth (32), and a union of 1200 leaf references whose table is too
    # large for the kernel's shared-memory copy
    wide = [rand_words(s, w) for _ in range(48)]
    leaf = planmod.PLeaf
    nest = leaf(0)
    for d in range(1, 40):
        nest = planmod.PNary(("and", "or", "xor", "andnot")[d % 4], (nest, leaf(d)) if d % 3 else (leaf(d), nest))
    roots = [
        planmod.PNary("or", tuple(leaf(i) for i in range(48))),
        planmod.PNary("andnot", (leaf(39), planmod.PNary("or", tuple(leaf(i) for i in range(35))))),
        nest,
        planmod.PNary("xor", tuple(leaf(i % 48) for i in range(1200))),
    ]
    progs = [planmod._compile(r, wide, {})[::2] for r in roots]  # (leaves, program)
    check(K.BINOPS["rev_andnot"] in progs[1][1], "wide andnot did not compile to rev_andnot")
    codes, pushes, _ = K.plan_micro_program(progs[3][1])
    table_bytes = 8 * (len(codes) + len(pushes))
    check(table_bytes > 16384, f"the long program's table ({table_bytes} B) fits shared memory")
    progs.append((wide[: K.MAX_STACK], list(range(K.MAX_STACK)) + [K.BINOPS["or"]] * (K.MAX_STACK - 1)))
    for leaves, prog in progs:
        want = K.plan_count_plain([cpu(t) for t in leaves], prog, s)
        same("plan_count", K.plan_count(leaves, prog, s), want)
    del wide
    print(
        "kernels: plan_count equal to twin on 24 random depth-3 trees, tile-edge widths "
        "(W = 4, 1000, 1024, 32772), S = 1, one leaf, PUSH_ZERO alone, and 5 wide/deep/long programs"
    )

    # plan_count_multi at the main path's shape: N random roots over a
    # shared leaf set, 4, 16 and 32 distinct leaves (the words made on the
    # card: 32 leaves are 4 GiB); every count equal to the twin (per-root
    # plan_count_plain on the same tensors)
    S_M, W_M = 1024, 32768
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    multi_groups = []
    for n_roots, n_leaves in ((2, 4), (16, 16), (64, 32)):
        leaves = [torch.randint(-(2**31), 2**31, (S_M, W_M), dtype=torch.int32, device=dev, generator=gen)
                  for _ in range(n_leaves)]
        progs = multi_programs(rng, n_roots, n_leaves)
        same("plan_count_multi", K.plan_count_multi(leaves, progs, S_M), K.plan_count_multi_plain(leaves, progs, S_M))
        multi_groups.append(len(K.plan_count_multi_groups(progs)))
        del leaves
    # the wrapper's and the kernel's rarer branches: 100 roots (two
    # launches by the 64-root cap), 120 distinct leaves (more than one
    # launch's shared memory holds) and 64 chains of 40 leaves, whose
    # table (2673 entries) is read from device memory, not shared memory
    # (their own generator: the main path's data stay as they were)
    srng = np.random.default_rng([int(rng.bit_generator.seed_seq.entropy or 0), 12])
    for what, progs, n_leaves in (
        ("100 roots over 32 leaves", multi_programs(srng, 100, 32), 32),
        ("100 roots over 120 leaves", multi_programs(srng, 100, 120), 120),
        ("64 chains of 40 over 48 leaves", chain_programs(srng, 64, 48, 40), 48),
    ):
        leaves = [torch.randint(-(2**31), 2**31, (S_M, W_M), dtype=torch.int32, device=dev, generator=gen)
                  for _ in range(n_leaves)]
        n_groups = len(K.plan_count_multi_groups(progs))
        before = K.LAUNCHES["plan_count_multi"]
        got = K.plan_count_multi(leaves, progs, S_M)
        launched = K.LAUNCHES["plan_count_multi"] - before
        same("plan_count_multi", got, K.plan_count_multi_plain(leaves, progs, S_M))
        check(launched == n_groups, f"plan_count_multi, {what}: {launched} launches, {n_groups} groups")
        tables = K.plan_count_multi_tables(progs)
        n_meta = max(len(tb[1]) + len(tb[0]) + 1 + len(tb[3]) for tb in tables)
        if what.startswith("64 chains"):
            in_smem = [K.plan_count_multi_layout(len(g), len(sl), len(co), st)[3] for g, sl, _, co, st in tables]
            check(not any(in_smem), f"plan_count_multi, {what}: the table is kept in shared memory")
        multi_groups.append(n_groups)
        print(f"kernels: plan_count_multi equal to twin, {what}: {n_groups} launches, table {n_meta} entries")
        del leaves, got
    torch.cuda.empty_cache()
    print(
        f"kernels: plan_count_multi equal to twin at S = {S_M}, W = {W_M} for 2, 16 and 64 random roots over 4, 16 "
        f"and 32 shared leaves, 100 over 32 and 120, 64 chains over 48 ({multi_groups} launches)"
    )

    multi_edge_checks(dev, same)
    plan_rows_checks(rng, dev, same, rand_words)

    # gather_tally: random lengths with empty segments; 8 row segments per
    # shard sharing words; Zipf lengths with one segment of 10^5 entries;
    # entries in no segment; entries on src's last word; idx and mask not
    # 16-byte aligned; then at card size, 1024 shards x 8 rows shard-major
    # as the main path lays them out, with ~985 entries per segment and with
    # Zipf lengths of the same total
    # (the first case draws from `rng` as this phase always has, so the
    # main path's data stay the same; the others draw from their own)
    def gather_check(src, idx, lens, what, draw=rand_words):
        ends = np.cumsum(lens).astype(np.int32)
        args = (src, torch.from_numpy(np.asarray(idx, np.int32)).to(dev), draw(len(idx)),
                torch.from_numpy(ends - lens.astype(np.int32)).to(dev), torch.from_numpy(ends).to(dev))
        same("gather_tally", K.gather_tally(*args), K.gather_tally_plain(*args))
        if len(idx) > 1 and len(lens):  # the same entries from [1:] views
            v = (args[1][1:], args[2][1:], args[3].clamp(max=len(idx) - 1), args[4].clamp(max=len(idx) - 1))
            same("gather_tally", K.gather_tally(src, *v), K.gather_tally_plain(src, *(x.contiguous() for x in v)))
        return what

    src = rand_words(6, 2048)
    lens = rng.integers(0, 50, 40)
    lens[::3] = 0
    done = [gather_check(src, rng.integers(0, src.numel(), lens.sum()), lens, "empty segments")]
    grng = np.random.default_rng(4)

    def gwords(*shape):
        return torch.from_numpy(grng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)).to(dev)

    small = gwords(4, 1024)
    lens = np.full(32, 40)
    idx = shard_major_idx(grng, lens.reshape(4, 8), 1024, pool=64)
    done.append(gather_check(small, idx, lens, "8 rows per shard sharing words", gwords))
    lens = np.minimum(grng.zipf(1.4, 300), 4000)
    lens[17] = 100_000
    done.append(gather_check(small, grng.integers(0, small.numel(), lens.sum()), lens, "a 10^5-entry segment", gwords))
    idx = grng.integers(0, small.numel(), 300)
    done.append(gather_check(small, idx, np.zeros(40, np.int64), "entries in no segment", gwords))
    lens = np.array([3, 0, 5, 260, 9])
    done.append(gather_check(small, np.full(lens.sum(), small.numel() - 1), lens, "src's last word", gwords))
    big = gwords(1024, 32768)
    for what, lens in (
        ("uniform", np.full((1024, 8), 985)),
        ("Zipf", zipf_lengths(grng, 1024 * 8 * 985, 1024 * 8, 32768).reshape(1024, 8)),
    ):
        idx = shard_major_idx(grng, lens, 32768)
        done.append(gather_check(big, idx, lens.reshape(-1), f"1024 shards x 8 rows, {what}", gwords))
    del big
    print(f"kernels: gather_tally equal to twin on {', '.join(done)} (each also from unaligned views)")

    # BSI kernels: depths 1..32, S = 1 and 13, W = 32768 and W % 4 != 0
    n_range = 0
    for d in (1, 7, 8, 9, 20, 31, 32):
        top = (1 << d) - 1
        # edge predicates: 0, 1, the top two magnitudes, one past depth_max
        # (the ladders read bits below d only) and a random one
        preds = sorted({0, 1, top - 1, top, min(top + 1, 2**32 - 1), int(rng.integers(0, top + 1))})
        for s, w in ((1, 32768), (13, 32768), (13, 1001)):
            planes, ex, sg, ft = rand_words(d, s, w), rand_words(s, w), rand_words(s, w), rand_words(s, w)
            on_cpu = {id(x): x.cpu() for x in (planes, ex, sg, ft)}  # the twins' inputs, copied once
            c = lambda x: None if x is None else on_cpu[id(x)]  # noqa: E731
            for sign in (sg, None):
                for filt in (ft, None):
                    same("bsi_sum", K.bsi_sum(planes, ex, sign, filt), K.bsi_sum_plain(c(planes), c(ex), c(sign), c(filt)))
                    for is_min in (True, False):
                        same(
                            "bsi_min_max",
                            K.bsi_min_max(planes, ex, sign, filt, is_min),
                            K.bsi_min_max_plain(c(planes), c(ex), c(sign), c(filt), is_min),
                        )
                for sel in ("consider", "pos", "neg") if sign is not None else ("consider",):
                    for kind, allow in (("eq", False), ("lt", False), ("lt", True), ("gt", False), ("gt", True), ("between", False)):
                        for p0 in preds:
                            p1 = max(p0, top) if kind == "between" else 0
                            for mode in ("rows", "count"):
                                n_range += 1
                                same(
                                    "bsi_range",
                                    K.bsi_range(planes, ex, sign, sel, kind, allow, p0, p1, mode),
                                    K.bsi_range_plain(c(planes), c(ex), c(sign), sel, kind, allow, p0, p1, mode),
                                )
        empty = torch.zeros((13, 32768), dtype=torch.int32, device=dev)
        for sign in (rand_words(13, 32768), None):
            for is_min in (True, False):
                got = K.bsi_min_max(rand_words(d, 13, 32768), empty, sign, None, is_min)
                check(got.tolist() == [0, 0, 0], f"bsi_min_max on an empty mask: {got.tolist()}")
    torch.cuda.synchronize()
    print(
        "kernels: bsi_sum/bsi_min_max equal to twins at depths 1..32, signed and unsigned, "
        f"with and without a filter (empty masks give any = 0); bsi_range equal in {n_range} "
        "kind/sel/predicate/mode cases"
    )
    slab_step_checks(rng, dev, rand_words)

    # GroupBy kernels (their own generator, so the main path's data stay
    # the same): counts_cross at one tile packed with 1-2 word ranges, full,
    # and spread over 2-3 tiles of prefixes or 9 of rows (G = 2, 3, 8, 16,
    # 17, 40, R up to 70; G = 1 runs on rows_counts), W not a multiple of 4
    # or of a step, unaligned views; gather_and over
    # aligned and unaligned slabs, a filter broadcast, repeated indices and
    # a cross expansion over three 16-output chunks
    grng = np.random.default_rng(7)

    def gwords(*shape):
        return torch.from_numpy(grng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)).to(dev)

    for g, r, s, w in ((1, 3, 5, 32768), (2, 70, 3, 4100), (3, 4, 2, 1001), (8, 5, 4, 32768),
                       (16, 8, 2, 32768), (17, 2, 3, 4096), (40, 3, 1, 33)):
        acc, planes = gwords(g, s, w), gwords(r, s, w)
        same("counts_cross", K.counts_cross(acc, planes), K.counts_cross_plain(cpu(acc), cpu(planes)))
    buf = gwords(2 * 3 * 1001 + 1)
    acc = buf[1:].reshape(2, 3, 1001)  # 4 bytes past a 16-byte boundary
    planes = gwords(4, 3, 1001)
    same("counts_cross", K.counts_cross(acc, planes), K.counts_cross_plain(cpu(acc), cpu(planes)))
    for na, nb, s, w, ia, ib in ((5, 2, 3, 4096, [4, 0, 2, 2], [1, 1, 0, 1]), (3, 3, 1, 1003, [2, 0], [1, 1]),
                                 (6, 1, 8, 32768, [5, 1, 1, 0], [0, 0, 0, 0]),
                                 (5, 7, 2, 8200, np.repeat(np.arange(5), 7), np.tile(np.arange(7), 5))):
        a, b = gwords(na, s, w), gwords(nb, s, w)
        same("gather_and", K.gather_and(a, ia, b, ib), K.gather_and_plain(cpu(a), ia, cpu(b), ib))
    torch.cuda.synchronize()
    print("kernels: counts_cross equal to its twin at G = 1..40, R up to 70, W = 33..32768, unaligned; "
          "gather_and equal on aligned and unaligned slabs, a filter broadcast and a 35-output cross expansion")

    # the merge barrier's kernels (their own generator too): or_bits on an
    # empty table, an empty segment, one key, bit 31, the entry's last
    # word, a word's run across the kernel's chunk boundary, two rows of a
    # planes entry and 10^7 keys over 512 shards; tables outside the entry
    # refused and the entry unchanged. merge_mark on empty input, one key,
    # all keys equal, sorted runs, keys near 2^63 - 1 and 2^24 keys with
    # duplicates; the whole device merge against the host merge
    from pilosa_tpu_torch.ops import merge as opm
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    mrng = np.random.default_rng(8)
    last = SHARD_WIDTH - 1
    chunk = opm.OR_BITS_CHUNK
    big_shards = 512
    big = sorted_unique(np.concatenate([mrng.integers(0, big_shards * SHARD_WIDTH, 10**7), [0, big_shards * SHARD_WIDTH - 1]]))
    cut = np.searchsorted(big, np.arange(big_shards + 1) * SHARD_WIDTH)
    or_cases = {
        "empty table": (1, 2, {}),
        "empty segment": (1, 2, {(0, 0): [], (1, 0): [3, 40]}),
        "one key": (1, 2, {(1, 0): [77]}),
        "bit 31": (1, 2, {(0, 0): [31, 63, 95, 32 * 9 + 31, last]}),
        "last word": (2, 3, {(2, 1): [last - 31, last - 1, last], (0, 0): [0]}),
        "run across the chunk boundary": (1, 2, {(1, 0): np.arange(5, 5 + 3 * chunk)}),
        "two rows of a planes entry": (
            2, 3, {(p, d): mrng.integers(0, SHARD_WIDTH, 700) for p in range(3) for d in range(2)}),
        "10^7 keys": (1, big_shards, {(p, 0): big[cut[p]:cut[p + 1]] & last for p in range(big_shards)}),
    }
    n_keys_max = 0
    for D, n, segs in or_cases.values():
        span = D * SHARD_WIDTH  # fragment p's rows 0..D-1, packed as the barrier packs
        keys = sorted_unique(np.concatenate(
            [np.empty(0, np.int64)]
            + [p * span + d * SHARD_WIDTH + np.asarray(c, np.int64) for (p, d), c in segs.items()]))
        bounds = [(p * span + d * SHARD_WIDTH, (d * n + p) * WORDS_PER_ROW) for (p, d) in sorted(segs)]
        table = np.array([(*np.searchsorted(keys, [lo, lo + SHARD_WIDTH]), base) for lo, base in bounds],
                         np.int64).reshape(-1, 3)
        entry = torch.from_numpy(mrng.integers(0, 2**32, size=(D, n, WORDS_PER_ROW), dtype=np.uint32).view(np.int32))
        keys_t = torch.from_numpy(keys)
        want = opm.or_bits_plain(entry.clone(), keys_t, table)
        got = entry.to(dev)
        opm.or_bits(got, keys_t.to(dev), table)
        same("or_bits", got, want)
        n_keys_max = max(n_keys_max, len(keys))
    check(n_keys_max >= 10**7 - 10**5, f"or_bits: the largest case held {n_keys_max} keys")
    # a table row outside the keys or not naming a whole row of the entry
    # raises on the host, before any launch
    n_words = got.numel()
    keys_d = keys_t.to(dev)
    before = got.clone()
    for bad in ((0, 1, 1), (0, 1, n_words), (0, 1, -WORDS_PER_ROW), (2, 1, 0), (-1, 1, 0), (0, len(keys) + 1, 0)):
        try:
            opm.or_bits(got, keys_d, np.array([(0, 8, 0), bad], np.int64))
            fail(f"or_bits took table row {bad} with {len(keys)} keys into an entry of {n_words} words")
        except IndexError:
            pass
    torch.cuda.synchronize()
    check(torch.equal(got, before), "a refused or_bits call changed the entry")
    del got, before, keys_d, big
    near = (1 << 63) - 1
    cases = [
        np.empty(0, np.int64), np.array([12345], np.int64), np.full(1000, 77, np.int64),
        np.repeat(np.arange(0, 5000, 3, dtype=np.int64), 2),
        np.array([near - 40, near - 33, near - 33, near - 1, near, near], np.int64),
        np.cumsum(mrng.integers(0, 3, 1 << 24)),  # sorted, a step of 0 repeats a key
    ]
    for keys in cases:
        kt = torch.from_numpy(keys)
        keep, bit = opm.merge_mark(kt.to(dev))
        keep_p, bit_p = opm.merge_mark_plain(kt)
        same("merge_mark", keep.to(torch.int32), keep_p.to(torch.int32))
        same("merge_mark", bit, bit_p)
    big = cases[-1].view(np.uint64)
    mh = opm.merge_keys_host(big)
    md, dd = opm.merge_keys_device(big, dev)
    check(np.array_equal(md, mh) and np.array_equal(dd.cpu().numpy().view(np.uint64), mh),
          "merge_keys_device differs from merge_keys_host at 2^24 keys")
    torch.cuda.synchronize()
    print("kernels: or_bits equal to its twin on " + ", ".join(or_cases) + f" ({n_keys_max} keys); six tables "
          "outside the keys or the entry refused, the entry unchanged; "
          "merge_mark equal on empty, one key, all equal, sorted runs, keys near 2^63 - 1 and 2^24 keys; "
          "the device merge equals the host merge")


# ---------------------------------------------------------------------------
# phase 3: the main path over 2^30 columns
# ---------------------------------------------------------------------------


# the slab steps' job shapes: every decomposition exec/bsistream.py
# `_decompose` gives (lt pos with the neg mask term, a between straddling
# 0 as two lt jobs, eq neg, gt with the pos mask term, lte / gte), with
# their predicates as functions of the top magnitude
SLAB_JOBS = [
    ((("lt", "pos", False),), lambda t: (t // 3,), ("neg",)),
    ((("lt", "pos", True), ("lt", "neg", True)), lambda t: (t // 2, t // 3), ()),
    ((("eq", "neg", False),), lambda t: (t // 7,), ()),
    ((("eq", "pos", False),), lambda t: (0,), ("consider",)),
    ((("gt", "pos", False),), lambda t: (t // 5,), ("pos",)),
    ((("gt", "neg", True),), lambda t: (1,), ()),
    ((("lt", "neg", True),), lambda t: (t,), ("pos",)),
    ((("between", "pos", False),), lambda t: (t // 9, t // 2), ()),
    ((("lt", "consider", False), ("gt", "consider", True)), lambda t: (t, t // 4), ("consider", "pos", "neg")),
]
SLAB_SPLITS = (1, 3, 7, 16, 32)
SLAB_CHECK_SHAPES = ((13, 32768), (13, 1001))  # [S, W]: the uint4 path, and W % 4 != 0


def slab_step_checks(rng, dev, rand_words):
    """bsi_min_max_step and bsi_range_step chained over slabs of 1, 3, 7,
    16 and 32 planes (MSB first) at depths 1..32: each chain equals the
    same chain of twins and today's whole-stack kernel, exactly; Min/Max
    signed at depth 32 keys on 33 bits (int64 va from the first slab)."""
    import torch

    from pilosa_tpu_torch.ops import bsi as obsi
    from pilosa_tpu_torch.ops import kernels as K

    def slabs(depth, slab):
        los = list(range(0, depth, slab))[::-1]
        return [(n == 0, n == len(los) - 1, lo, min(slab, depth - lo)) for n, lo in enumerate(los)]

    n_mm = n_rng = 0
    for d in (1, 7, 9, 17, 20, 31, 32):
        top = (1 << d) - 1
        for s, w in SLAB_CHECK_SHAPES:
            planes, ex, sg, ft = rand_words(d, s, w), rand_words(s, w), rand_words(s, w), rand_words(s, w)
            ex = ex & rand_words(s, w)
            empty = torch.zeros_like(ex)
            for sign in (sg, None):
                key_bits = d + (sign is not None)
                for filt in (ft, None, empty):
                    for is_min in (True, False):
                        whole = K.bsi_min_max(planes, ex, sign, filt, is_min)
                        for slab in SLAB_SPLITS:
                            got = want = None
                            for first, last, lo, dd in slabs(d, slab):
                                got = K.bsi_min_max_step(planes[lo : lo + dd], ex, sign, filt, got, is_min, first, last, key_bits)
                                want = obsi.min_max_step(planes[lo : lo + dd], ex, sign, filt, want, is_min, first, last, key_bits)
                            n_mm += 1
                            check(torch.equal(got, want) and torch.equal(got, whole),
                                  f"bsi_min_max_step chain (depth {d}, slab {slab}, signed {sign is not None}, "
                                  f"filter {filt is not None}, min {is_min}, [{s}, {w}]): {got.tolist()} twin "
                                  f"{want.tolist()} whole {whole.tolist()}")
                        if filt is empty:
                            check(whole.tolist() == [0, 0, 0], f"bsi_min_max on an empty mask: {whole.tolist()}")
            for jobs, preds_of, extras in SLAB_JOBS:
                for preds in (preds_of(top), tuple(sorted(int(rng.integers(0, top + 1)) for _ in preds_of(top)))):
                    whole, off = [], 0
                    for kind, sel, allow_eq in jobs:
                        p = list(preds[off : off + obsi.range_npreds(kind)]) + [0]
                        off += obsi.range_npreds(kind)
                        whole.append(int(K.bsi_range(planes, ex, sg, sel, kind, allow_eq, p[0], p[1], "count").sum()))
                    whole += [int(obsi.popcount_words(obsi.job_mask(ex, sg, None, sel)).sum()) for sel in extras]
                    for slab in SLAB_SPLITS:
                        got = want = None
                        for first, last, lo, dd in slabs(d, slab):
                            got = K.bsi_range_step(planes[lo : lo + dd], ex, sg, got, jobs, preds, lo, first, last, extras)
                            want = obsi.range_step(planes[lo : lo + dd], ex, sg, want, jobs, preds, lo, first, last, extras)
                        n_rng += 1
                        check(got.tolist() == want.tolist() == whole,
                              f"bsi_range_step chain (depth {d}, slab {slab}, {jobs}, {preds}, [{s}, {w}]): "
                              f"{got.tolist()} twin {want.tolist()} whole {whole}")
    torch.cuda.synchronize()
    print(
        f"kernels: bsi_min_max_step equal to its twin and to bsi_min_max in {n_mm} chains, bsi_range_step to its "
        f"twin and to bsi_range in {n_rng} chains (slabs of {', '.join(map(str, SLAB_SPLITS))} planes, depths 1..32, "
        "signed and unsigned, filtered, empty masks)"
    )


def multi_edge_checks(dev, same):
    """plan_count_multi at every VEC (1, 2), ring depth (1, 2) and L (1,
    2, 4, 8 uint4 a lane) its launcher picks, over 4 to 96 leaves, at W
    on the tile edges (4, 1004, a VEC-1 and a VEC-2 tile + 4 words,
    32772) and S = 1; 1000 one-word shards (every block's run crosses
    shards mid-run); 1 root and 64; flat roots and roots that need stack
    entries (one at the launch's cap); and 513 items of VEC 2 in each of
    two shards over all-ones words (every lane's counter at its most).
    Each held exactly to the twin, in as many launches as
    plan_count_multi_groups makes. Own generators: the later checks'
    data stay as they were."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev).manual_seed(13)
    x = K.BINOPS
    stacked = [[0, 1, 2, x["xor"], x["rev_andnot"]], [i % 3 for i in range(11)] + [x["xor"]] * 10,
               [0, K.PUSH_ZERO, 1, x["or"], x["andnot"]]]
    seen = set()

    def run(n_roots, n_leaves, s, w, progs=None, fill=None):
        if progs is None:
            progs = [stacked[1]] if n_roots == 1 else (stacked + multi_programs(rng, n_roots - len(stacked), n_leaves))
        if fill is None:
            leaves = [torch.randint(-(2**31), 2**31, (s, w), dtype=torch.int32, device=dev, generator=gen)
                      for _ in range(n_leaves)]
        else:
            leaves = [torch.full((s, w), fill, dtype=torch.int32, device=dev) for _ in range(n_leaves)]
        tables = K.plan_count_multi_tables(progs)
        for _, slot_leaves, starts, codes, stack in tables:
            seen.add(K.plan_count_multi_layout(len(starts) - 1, len(slot_leaves), len(codes), stack)[:3])
        before = K.LAUNCHES["plan_count_multi"]
        got = K.plan_count_multi(leaves, progs, s)
        launched = K.LAUNCHES["plan_count_multi"] - before
        same("plan_count_multi", got, K.plan_count_multi_plain([t.cpu() for t in leaves], progs, s))
        check(launched == len(tables), f"plan_count_multi, {n_roots} roots over {n_leaves} leaves, S = {s}, "
              f"W = {w}: {launched} launches, {len(tables)} groups")
        return got

    for n_leaves in (4, 12, 24, 48, 90):
        for s, w in ((3, 4), (2, 1004), (3, 512 + 4), (3, 1024 + 4), (2, 32772), (1, 32768)):
            run(max(16, min(64, n_leaves)), n_leaves, s, w)  # every leaf read by some root
    run(1, 4, 5, 32772)
    run(64, 8, 3, 32772)
    run(64, 32, 2, 1004)
    run(40, 6, 1000, 4)
    cap = K.MULTI_CAP - 9  # leaves beside the 9 stack entries of stacked[1]
    run(2, cap, 2, 1028, progs=[[0] + [y for i in range(1, cap) for y in (i, x["or"])], stacked[1]])
    w_ones = 4 * 2**17 + 4  # 2^17 + 1 uint4 a shard row: 513 items of VEC 2 a shard
    got = run(3, 2, 2, w_ones, progs=[[0], [0, 1, x["and"]], [0, 1, x["xor"]]], fill=-1)
    check(got[:2].eq(32 * w_ones).all().item(), f"all-ones counts {got.tolist()}, not {32 * w_ones}")
    want = ({1, 2}, {1, 2}, {1, 2, 4, 8})
    reached = tuple({lay[i] for lay in seen} for i in range(3))
    check(all(a <= b for a, b in zip(want, reached)),
          f"plan_count_multi layouts (VEC, nbuf, L) reached {sorted(seen)}, not every VEC, nbuf and L of {want}")
    print(f"kernels: plan_count_multi equal to twin at (VEC, nbuf, L) {sorted(seen)}: W = 4, 1004, VEC-1 and VEC-2 "
          "tiles + 4, 32772; S = 1; 1000 one-word shards; 1 root and 64; stacked roots, one at the cap; 513 items of "
          "all-ones words a shard")


def plan_rows_checks(rng, dev, same, rand_words):
    """plan_rows against its twin, exactly: random depth-3 trees with Shift
    nodes (n in 1, 31, 32, 33, 2^20 - 1, 2^20 at W = 32768) whose
    predecessor tables have gaps and -1s, at S = 1 and 13, through the
    plan (one launch per root, one more per Shift over a subtree); then
    hand-built programs at tile-edge widths and W % 4 != 0, leaves that
    are unaligned views, and the predecessor rows of a shard chunk. Its
    own generator, so the main path's data stay the same."""
    import torch

    from pilosa_tpu_torch.exec import plan as planmod
    from pilosa_tpu_torch.ops import kernels as K

    prng = np.random.default_rng(int(rng.integers(2**31)))
    w = 32768
    shifts_n = (1, 31, 32, 33, (1 << 20) - 1, 1 << 20)
    n_trees = 0
    for s in (1, 13):
        operands = [rand_words(s, w) for _ in range(5)]
        host = [t.cpu() for t in operands]

        def prev_table():
            p = prng.integers(-1, s, s)
            p[prng.random(s) < 0.3] = -1
            return tuple(int(x) for x in p)

        def tree(depth):
            if depth == 0:
                return planmod.PLeaf(int(prng.integers(5)))
            kind = prng.random()
            if kind < 0.3:
                return planmod.PShift(tree(depth - 1), int(prng.choice(shifts_n)), prev_table())
            op = str(prng.choice(["and", "or", "xor", "andnot"]))
            return planmod.PNary(op, tuple(tree(depth - 1) for _ in range(int(prng.integers(2, 4)))))

        for _ in range(16):
            root = tree(3)
            if not isinstance(root, planmod.PShift):
                root = planmod.PShift(root, int(prng.choice(shifts_n)), prev_table())
            got = planmod._rows(root, operands, {})
            want = planmod._rows(root, host, {})
            same("plan_rows", got[0], want[0])
            same("plan_rows", got[1], want[1])
            n_trees += 1
    # hand-built programs: widths at the 1024-word tile's edges, below one
    # tile and W % 4 != 0, S = 1 and 13; shifted and plain pushes of the
    # same leaf; a stacked operand; unaligned views (data_ptr 4 bytes past
    # a 16-byte boundary)
    progs = [
        [0],
        [0, 1, K.BINOPS["or"]],
        [0, 1, 2, K.BINOPS["xor"], K.BINOPS["rev_andnot"]],
        [2, 0, 1, K.BINOPS["and"], K.BINOPS["andnot"], K.PUSH_ZERO, K.BINOPS["or"]],
    ]
    n_cases = 0
    for es, ew in ((1, 32768), (13, 1024), (13, 1025), (3, 1023), (2, 4), (5, 1001), (1, 2048)):
        for aligned in (True, False):
            if aligned:
                lv = [rand_words(es, ew) for _ in range(2)]
            else:
                lv = [rand_words(es * ew + 1)[1:].view(es, ew) for _ in range(2)]
            lv.append(lv[0])
            for n in (1, 31, 32, 33, ew * 32 - 1, ew * 32):
                p = [int(x) for x in prng.integers(-1, es, es)]
                sh = [None, (n, tuple(p)), (n // 2, tuple(reversed(p)))]
                for prog in progs:
                    got = K.plan_rows(lv, sh, prog)
                    want = K.plan_rows_plain([t.cpu() for t in lv], sh, prog)
                    same("plan_rows", got[0], want[0])
                    same("plan_rows", got[1], want[1])
                    n_cases += 1
    # a shard chunk: 7 output rows and 3 predecessor rows after them
    chunk = [rand_words(10, w) for _ in range(2)]
    prev = (7, 0, 1, -1, 3, 8, 5, 9, -1, -1)
    root = planmod.PNary("or", (planmod.PShift(planmod.PLeaf(0), 33, prev), planmod.PLeaf(1)))
    got, want = planmod._rows(root, chunk, {}), planmod._rows(root, [t.cpu() for t in chunk], {})
    same("plan_rows", got[0], want[0])
    same("plan_rows", got[1], want[1])
    print(f"kernels: plan_rows equal to twin on {n_trees} random depth-3 trees with Shift (S = 1, 13), "
          f"{n_cases} hand-built programs (W = 4..32768, W % 4 != 0, unaligned views), a shard chunk")


def main_path(args, rng):
    import torch

    from pilosa_tpu_torch import Executor, Holder
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server import wire
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    S, W = args.shards, WORDS_PER_ROW
    n_dense, n_sparse, n_g = N_DENSE, N_SPARSE, N_G

    # data, generated in bulk from the seed
    t0 = time.perf_counter()
    f_words = []
    for r in range(n_dense):  # density 2^-(1 + r mod 4)
        w = rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
        for _ in range(r % 4):
            w &= rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
        f_words.append(w)
    sparse_cols = []  # ~1000 bits per (row, shard)
    for _ in range(n_sparse):
        pos = rng.integers(0, SHARD_WIDTH, size=(S, 1000), dtype=np.uint64)
        sparse_cols.append((pos + (np.arange(S, dtype=np.uint64) * SHARD_WIDTH)[:, None]).reshape(-1))
    g_words = [rng.integers(0, 2**32, size=(S, W), dtype=np.uint32) for _ in range(n_g)]
    set_calls = [(int(rng.integers(0, S * SHARD_WIDTH)), int(rng.integers(n_g))) for _ in range(8)]
    gen_s = time.perf_counter() - t0
    print(f"main: generated data in {gen_s:.1f} s")

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # ingest through the port's entry points
    t0 = time.perf_counter()
    holder = Holder()
    idx = holder.create_index("smoke", track_existence=True)
    f = idx.create_field("f")
    g = idx.create_field("g")
    exists = idx.existence_field()
    for s in range(S):
        ex_row = np.zeros(W, np.uint32)
        for r in range(n_dense):
            f.import_row_words(r, s, f_words[r][s])
            ex_row |= f_words[r][s]
        for r in range(n_g):
            g.import_row_words(r, s, g_words[r][s])
            ex_row |= g_words[r][s]
        exists.import_row_words(0, s, ex_row)
    for k, cols in enumerate(sparse_cols):
        f.import_bits(np.full(len(cols), n_dense + k, np.uint64), cols)
        idx.track_columns(cols)
    ex = Executor(holder)
    set_pql = " ".join(f"Set({c}, g={r})" for c, r in set_calls)
    ex.execute("smoke", set_pql)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0

    # the numpy reference state
    def pack(cols):
        words = np.zeros(S * W, np.uint32)
        np.bitwise_or.at(words, (cols >> np.uint64(5)).astype(np.int64), np.uint32(1) << (cols & np.uint64(31)).astype(np.uint32))
        return words.reshape(S, W)

    rows = {("f", r): f_words[r] for r in range(n_dense)}
    for k, cols in enumerate(sparse_cols):
        rows[("f", n_dense + k)] = pack(cols)
    for r in range(n_g):
        rows[("g", r)] = g_words[r].copy()
    all_cols = np.zeros((S, W), np.uint32)
    for (_, _), words in rows.items():
        all_cols |= words
    for c, r in set_calls:
        rows[("g", r)].reshape(-1)[c >> 5] |= np.uint32(1 << (c & 31))
        all_cols.reshape(-1)[c >> 5] |= np.uint32(1 << (c & 31))

    def shifted_count(words):
        """(count, [S + 1, W] words) of the row shifted up one column; the
        last shard's top bit carries into shard S."""
        flat = np.concatenate([words.reshape(-1), np.zeros(W, np.uint32)])
        out = (flat << np.uint32(1)) | np.concatenate([[np.uint32(0)], flat[:-1] >> np.uint32(31)])
        return np_popcount(out), out.reshape(S + 1, W)

    R = lambda fld, r: rows[(fld, r)]  # noqa: E731
    pc = np_popcount
    shift_n, shift_words = shifted_count(R("f", 6))
    # 34 distinct leaves: g=0 minus the union of every other row and six
    # shifted rows (the shifts extend the shard list past the last shard)
    wide_rows = [R("f", r) for r in range(n_dense + n_sparse)] + [R("g", r) for r in range(1, n_g)]
    wide_union = np.concatenate([np.bitwise_or.reduce(wide_rows), np.zeros((1, W), np.uint32)]).reshape(-1)
    for r in range(6):
        wide_union |= shifted_count(R("f", r))[1].reshape(-1)
    wide_g0 = np.concatenate([R("g", 0), np.zeros((1, W), np.uint32)]).reshape(-1)
    wide_rows_pql = (
        [f"Row(f={r})" for r in range(n_dense + n_sparse)]
        + [f"Row(g={r})" for r in range(1, n_g)]
        + [f"Shift(Row(f={r}), n=1)" for r in range(6)]
    )
    wide_pql = "Count(Difference(Row(g=0), Union({})))".format(", ".join(wide_rows_pql))
    queries = [
        ("Count(Intersect(Row(f=1), Row(g=0)))", [pc(R("f", 1) & R("g", 0))]),
        ("Count(Union(Row(f=0), Row(f=1), Row(f=2)))", [pc(R("f", 0) | R("f", 1) | R("f", 2))]),
        ("Count(Difference(Row(f=3), Row(g=1)))", [pc(R("f", 3) & ~R("g", 1))]),
        ("Count(Xor(Row(f=4), Row(g=2)))", [pc(R("f", 4) ^ R("g", 2))]),
        ("Count(Not(Row(f=5)))", [pc(all_cols & ~R("f", 5))]),
        ("Count(Shift(Row(f=6), n=1))", [shift_n]),
        (
            f"Count(Intersect(Row(f=0), Row(f={n_dense}))) Count(Union(Row(f=7), Row(g=3)))",
            [pc(R("f", 0) & R("f", n_dense)), pc(R("f", 7) | R("g", 3))],
        ),
        (wide_pql, [pc(wide_g0 & ~wide_union)]),
    ]
    del wide_rows, wide_union, wide_g0
    totals = {r: pc(R("f", r)) for r in range(n_dense + n_sparse)}
    top = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    ic = {r: pc(R("f", r) & R("g", 0)) for r in range(n_dense + n_sparse)}
    top_f = sorted(((r, c) for r, c in ic.items() if c), key=lambda kv: (-kv[1], kv[0]))[:10]

    t0 = time.perf_counter()
    for pql, want in queries:
        got = ex.execute("smoke", pql)
        check(got == want, f"{pql}: got {got}, numpy says {want}")
    # a 4-Count request: one plan_count_multi launch, no plan_count
    four = "Count(Row(f=1)) Count(Intersect(Row(f=1), Row(g=0))) Count(Union(Row(f=2), Row(g=1))) Count(Not(Row(f=3)))"
    want4 = [pc(R("f", 1)), pc(R("f", 1) & R("g", 0)), pc(R("f", 2) | R("g", 1)), pc(all_cols & ~R("f", 3))]
    before = dict(K.LAUNCHES)
    got = ex.execute("smoke", four)
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}
    check(got == want4, f"{four}: got {got}, numpy says {want4}")
    check(launched == {"plan_count_multi": 1}, f"the 4-Count request launched {launched}, not one plan_count_multi")
    print(f"main: a 4-Count request equals numpy with launches {launched}")
    row_f1 = ex.execute("smoke", "Row(f=1)")[0]
    before = K.LAUNCHES["count2"]
    row_count = row_f1.count()
    launched = K.LAUNCHES["count2"] - before
    check(row_count == totals[1], f"Row(f=1).count() {row_count} != {totals[1]}")
    check(
        launched == 1,
        f"Row(f=1).count() over {len(row_f1.segments)} segments made {launched} count2 launches, not 1",
    )
    print(f"main: Row(f=1).count() over {len(row_f1.segments)} segments: {launched} count2 launch")
    shifted = ex.execute("smoke", "Shift(Row(f=6), n=1)")[0]
    for s in (0, 1, S // 2, S - 1):
        seg = shifted.segment(s).cpu().numpy().view(np.uint32)
        check(np.array_equal(seg, shift_words[s]), f"Shift(Row(f=6)) shard {s} differs from numpy")
    got = [(p.id, p.count) for p in ex.execute("smoke", "TopN(f, n=10)")[0]]
    check(got == top, f"TopN(f, n=10): got {got}, numpy says {top}")
    before = K.LAUNCHES["gather_tally"]
    got = [(p.id, p.count) for p in ex.execute("smoke", "TopN(f, Row(g=0), n=10)")[0]]
    launched = K.LAUNCHES["gather_tally"] - before
    check(got == top_f, f"TopN(f, Row(g=0), n=10): got {got}, numpy says {top_f}")
    check(launched == 1, f"TopN(f, Row(g=0), n=10) made {launched} gather_tally launches, not 1")
    # a filtered TopN whose filter stack exceeds the budget: a quarter of
    # it holds half the shards' rows, so the filter lowers in 2 chunks,
    # each tallied on the card, the tallies merged on the host
    from pilosa_tpu_torch.exec import executor as exmod

    full_budget = holder.dcache.budget_bytes
    holder.dcache.budget_bytes = 4 * (S // 2) * W * 4
    ic2 = {r: pc(R("f", r) & R("g", 0) & R("g", 1)) for r in range(n_dense + n_sparse)}
    top_2 = sorted(((r, c) for r, c in ic2.items() if c), key=lambda kv: (-kv[1], kv[0]))[:5]
    chunks = exmod.TOPN_STATS["chunks"]
    tq = time.perf_counter()
    got = [(p.id, p.count) for p in ex.execute("smoke", "TopN(f, Intersect(Row(g=0), Row(g=1)), n=5)")[0]]
    topn_budget_ms = (time.perf_counter() - tq) * 1e3
    chunks = exmod.TOPN_STATS["chunks"] - chunks
    holder.dcache.budget_bytes = full_budget
    check(got == top_2, f"TopN(f, Intersect(Row(g=0), Row(g=1)), n=5) under the budget: got {got}, numpy says {top_2}")
    check(chunks == 2, f"the filtered TopN under the budget walked {chunks} chunks, not 2")
    print(
        f"main: TopN(f, Intersect(Row(g=0), Row(g=1)), n=5) under a {4 * (S // 2) * W * 4} B "
        f"budget: {chunks} filter chunks of {S // 2} shards, {topn_budget_ms:.1f} ms (staging included), equals numpy"
    )
    # Rows and GroupBy: at S = 1024 a prefix tile holds 2 rows, so the
    # two-child GroupBys descend (counts_cross over chunks of 2 prefixes;
    # gather_and for the filtered selections)
    wire_of = lambda pql: [wire.result_to_public_json(r) for r in ex.execute("smoke", pql)]  # noqa: E731
    f_rows = [R("f", r) for r in range(n_dense + n_sparse)]
    g_rows = [R("g", r) for r in range(n_g)]
    gset = np.flatnonzero(_bits(R("g", 2)))
    g_col = int(gset[len(gset) // 2])
    groups_fg = np_groups(f_rows, g_rows)
    groups_fg_f1 = np_groups(f_rows, g_rows, R("f", 1))
    all_fg = group_json(("f", "g"), groups_fg)
    group_checks = [
        ("Rows(f)", [list(range(n_dense + n_sparse))]),
        (f"Rows(g, column={g_col})", [[r for r in range(n_g) if (int(R("g", r).reshape(-1)[g_col >> 5]) >> (g_col & 31)) & 1]]),
        ("Rows(f, previous=3, limit=4)", [[4, 5, 6, 7]]),
        ("GroupBy(Rows(f))", [group_json(("f",), {(r,): totals[r] for r in range(n_dense + n_sparse) if totals[r]})]),
        ("GroupBy(Rows(f), Rows(g))", [all_fg]),
        ("GroupBy(Rows(f), Rows(g), filter=Row(f=1))", [group_json(("f", "g"), groups_fg_f1)]),
        ("GroupBy(Rows(f), Rows(g), limit=5, offset=2)", [all_fg[2:7]]),
    ]
    base_launches = dict(K.LAUNCHES)
    for pql, want in group_checks:
        got = wire_of(pql)
        check(got == want, f"{pql}: got {str(got)[:300]}, numpy says {str(want)[:300]}")
    gb_launches = {k: K.LAUNCHES[k] - base_launches[k] for k in K.LAUNCHES}
    check(
        gb_launches["counts_cross"] > 0 and gb_launches["gather_and"] > 0
        and gb_launches["count2"] + gb_launches["rows_counts"] > 0,
        f"the GroupBys did not launch counts_cross, gather_and and count2 or rows_counts: {gb_launches}",
    )
    print(
        f"main: Rows and GroupBy equal numpy ({len(groups_fg)} groups of f x g, {len(groups_fg_f1)} filtered); "
        f"launches {gb_launches}"
    )
    torch.cuda.synchronize()
    first_query_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for name in ("count2", "rows_counts", "plan_count", "plan_count_multi", "plan_rows", "gather_tally", "counts_cross",
                 "gather_and"):
        check(launches[name] > 0, f"main path never launched {name}: {launches}")
    print(
        f"main: {S} shards x {SHARD_WIDTH} columns = {S * SHARD_WIDTH} columns; "
        f"ingest {ingest_s:.2f} s; first pass of the queries (staging included) "
        f"{first_query_s:.2f} s; every answer equals numpy"
    )
    print(f"main: launches during ingest + queries: {launches}")
    resident = holder.dcache.bytes_used
    print(
        f"main: device cache resident {resident} B; torch allocated "
        f"{torch.cuda.memory_allocated()} B, peak {torch.cuda.max_memory_allocated()} B"
    )
    state = {
        "f1": R("f", 1), "g0": R("g", 0), "exists": all_cols,
        # phase 4b holds its answers to these, updated with its writes
        "f_rows": [R("f", r) for r in range(n_dense + n_sparse)], "g1": R("g", 1),
        "g_rows": [R("g", r) for r in range(n_g)],  # the same arrays as g0 and g1
    }

    # warm per-query latency
    lat = {}
    timed = [q for q, _ in queries] + ["Row(f=1)", "TopN(f, n=10)", "TopN(f, Row(g=0), n=10)"]
    timed += [q for q, _ in group_checks]
    for pql in timed:
        wide_name = f"Count(Difference(Row(g=0), Union(<{len(wide_rows_pql)} rows, 6 of them shifted>)))"
        name = wide_name if pql == wide_pql else pql
        lat[name] = host_p50_ms(lambda pql=pql: ex.execute("smoke", pql))
    lat["Row(f=1) + .count()"] = host_p50_ms(lambda: ex.execute("smoke", "Row(f=1)")[0].count())
    for pql, ms in lat.items():
        print(f"query p50 {ms:.3f} ms  {pql}")
    wide_name = f"Count(Difference(Row(g=0), Union(<{len(wide_rows_pql)} rows, 6 of them shifted>)))"
    print(
        f"re-timed in process (row mode on plan_rows): Row(f=1) {lat['Row(f=1)']:.3f} ms (ROADMAP before: 9.9), "
        f"Count(Shift(Row(f=6), n=1)) {lat['Count(Shift(Row(f=6), n=1))']:.3f} ms (3.93), "
        f"the 6-Shift-twin Count {lat[wide_name]:.3f} ms (25.6)"
    )
    lat["TopN(f, Intersect(Row(g=0), Row(g=1)), n=5) under the budget, first pass"] = topn_budget_ms
    state["topn_budget_chunks"] = chunks
    return holder, ex, launches, lat, ingest_s, resident, state


# ---------------------------------------------------------------------------
# phase 3b: the BSI path over the same 2^30 columns
# ---------------------------------------------------------------------------

BSI_KERNELS = ("bsi_sum", "bsi_min_max", "bsi_min_max_step", "bsi_range", "bsi_range_step")
AMOUNT = (-1_000_000, 1_000_000)  # signed: base 0, 20 magnitude bits
AGE = (0, 120)  # unsigned: base 0, 7 magnitude bits, no sign row
N_VALUE_IMPORT = 8  # shards loaded through Field.import_values (16 until PR 11: cut for the script's time)
# signed, 32 magnitude bits: values in +-(2^32 - 1) on 1 column in 16 (cut
# for ingest time), loaded as fragment words; the extremes at shard 0
DEEP = (-(2**32 - 1), 2**32 - 1)
DEEP_DENSITY = 1 / 16
DEEP_LT = -(2**31)  # Count(Row(deep < DEEP_LT))
DEEP_GT = 2**32 - 4096  # Count(Row(deep > DEEP_GT))


def _bits(words: np.ndarray) -> np.ndarray:
    """uint32 words -> one bool per column (bit b of word w = column 32w + b)."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), bitorder="little").astype(bool)


def _pack(bits: np.ndarray) -> np.ndarray:
    """bool [..., columns] -> uint32 words, the inverse of _bits."""
    return np.packbits(np.ascontiguousarray(bits), axis=-1, bitorder="little").view(np.uint32)


def _pack_positions(pos: np.ndarray) -> np.ndarray:
    """uint32 [W] words of one shard's set columns (sorted, unique)."""
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    pos = pos.astype(np.int64)
    bits = np.left_shift(1, pos & 31).astype(np.float64)
    return np.bincount(pos >> 5, weights=bits, minlength=WORDS_PER_ROW).astype(np.uint32)


def _planes(has: np.ndarray, vals: np.ndarray, depth: int) -> np.ndarray:
    """[depth, W] magnitude plane words of the columns in `has`."""
    mag = np.where(has, np.abs(vals), 0).astype(np.uint32)
    out = np.empty((depth, len(mag) // 32), np.uint32)
    for d in range(depth):
        out[d] = _pack(((mag >> np.uint32(d)) & np.uint32(1)).astype(bool))
    return out


def _extreme(vals: np.ndarray, is_min: bool):
    if not len(vals):
        return None
    v = int(vals.min() if is_min else vals.max())
    return v, int((vals == v).sum())


def _merge_extreme(a, b, is_min: bool):
    if a is None or b is None:
        return a if b is None else b
    if a[0] == b[0]:
        return a[0], a[1] + b[1]
    return min(a, b) if is_min else max(a, b)


def bsi_shard(seed: int, s: int, state, writes, sample: bool):
    """Generate one shard's int values, the words or columns to ingest
    (before the PQL writes), and the shard's numpy answers (after them)."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng([seed, 3, s])
    has_a = rng.random(SHARD_WIDTH) < 0.9
    amt = rng.integers(AMOUNT[0], AMOUNT[1] + 1, SHARD_WIDTH)
    has_g = _bits(state["exists"][s])
    age = rng.integers(AGE[0], AGE[1] + 1, SHARD_WIDTH)
    for field, col, value in writes:
        # every write changes its column: a Clear target holds a value at
        # ingest, a Set target none
        if col // SHARD_WIDTH == s:
            (has_a if field == "amount" else has_g)[col % SHARD_WIDTH] = value is None
    out = {"s": s}
    if s < N_VALUE_IMPORT:
        ca, cg = np.flatnonzero(has_a), np.flatnonzero(has_g)
        base = np.uint64(s * SHARD_WIDTH)
        out["values"] = (ca.astype(np.uint64) + base, amt[ca], cg.astype(np.uint64) + base, age[cg])
    else:
        out["words"] = {
            "amount": (_pack(has_a), _pack(has_a & (amt < 0)), _planes(has_a, amt, 20)),
            "age": (_pack(has_g), None, _planes(has_g, age, 7)),
        }
    # the state after the PQL writes
    has_a, amt, has_g, age = has_a.copy(), amt.copy(), has_g.copy(), age.copy()
    for field, col, value in writes:
        if col // SHARD_WIDTH != s:
            continue
        pos = col % SHARD_WIDTH
        has, vals = (has_a, amt) if field == "amount" else (has_g, age)
        has[pos] = value is not None
        vals[pos] = 0 if value is None else value
    f1, g0 = _bits(state["f1"][s]), _bits(state["g0"][s])
    # Shift(Row(g=0), n=1) and Shift(Row(f=1), n=2) over this shard: the
    # last columns of shard s - 1 carry into its first
    prev_g0 = _bits(state["g0"][s - 1][-1:])[-1:] if s else np.zeros(1, bool)
    prev_f1 = _bits(state["f1"][s - 1][-1:])[-2:] if s else np.zeros(2, bool)
    g0_sh1 = np.concatenate([prev_g0, g0[:-1]])
    f1_sh2 = np.concatenate([prev_f1, f1[:-2]])
    a = amt[has_a]
    old = has_a & has_g & (age > 65)
    # amount at the columns phase 4b's bursts add to g row 0
    gb = state["g_burst"]
    lo, hi = np.searchsorted(gb, [s * SHARD_WIDTH, (s + 1) * SHARD_WIDTH])
    pos = (gb[lo:hi] - np.uint64(s * SHARD_WIDTH)).astype(np.int64)
    out["probe"] = (gb[lo:hi], np.where(has_a[pos], amt[pos], 0), has_a[pos])
    out["ans"] = {
        "sum": (int(a.sum()), len(a)),
        "sum_f1": (int(amt[has_a & f1].sum()), int((has_a & f1).sum())),
        "sum_g0": (int(amt[has_a & g0].sum()), int((has_a & g0).sum())),
        "sum_old": (int(amt[old].sum()), int(old.sum())),
        "min": _extreme(a, True),
        "max": _extreme(a, False),
        "max_age_g0": _extreme(age[has_g & g0], False),
        "gt500k": int((a > 500_000).sum()),
        "le_m250k": int((a <= -250_000).sum()),
        "eq12345": int((a == 12345).sum()),
        "ne0": int((a != 0).sum()),
        "btw1000": int(((a >= -1000) & (a <= 1000)).sum()),
        "notnull": len(a),
        "adult_f1": int((has_g & (age >= 18) & f1).sum()),
        "young_or_old": int((has_g & ((age < 13) | (age > 65))).sum()),
        "sum_g0_sh1": (int(amt[has_a & g0_sh1].sum()), int((has_a & g0_sh1).sum())),
        "min_age_f1_sh2": _extreme(age[has_g & f1_sh2], True),
    }
    # the signed 32-bit-deep field, after the amount and age writes (it
    # has none of its own)
    # drawn and packed from its set columns only (sorted, unique)
    pos = np.flatnonzero(rng.random(SHARD_WIDTH) < DEEP_DENSITY)
    d = rng.integers(DEEP[0], DEEP[1] + 1, len(pos))
    if s == 0:
        pos = np.union1d(pos, [7, 8, 9])
        d = rng.integers(DEEP[0], DEEP[1] + 1, len(pos))
        d[np.searchsorted(pos, [7, 8, 9])] = [DEEP[0], DEEP[1], 0]
    has_d = np.zeros(SHARD_WIDTH, bool)
    has_d[pos] = True
    deep = np.zeros(SHARD_WIDTH, np.int64)
    deep[pos] = d
    mag = np.abs(d).astype(np.uint64)
    out["deep_words"] = (
        _pack_positions(pos), _pack_positions(pos[d < 0]),
        np.stack([_pack_positions(pos[(mag >> np.uint64(b)) & np.uint64(1) == 1]) for b in range(32)]),
    )
    out["ans"] |= {
        "deep_sum": (int(d.sum()), len(d)),
        "deep_min": _extreme(d, True),
        "deep_max": _extreme(d, False),
        "deep_lt": int((d < DEEP_LT).sum()),
        "deep_gt": int((d > DEEP_GT).sum()),
        "deep_sum_g0_sh1": (int(deep[has_d & g0_sh1].sum()), int((has_d & g0_sh1).sum())),
    }
    if sample:
        out["age42"] = _pack(has_g & (age == 42))
    return out


def _bsi_shard_state(state, s: int) -> dict:
    """The rows of `state` that bsi_shard reads for shard s (its own and
    its predecessor's f1, g0 and existence words; phase 4b's burst
    columns in the shard), small enough to send to a worker process."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    keep = (s - 1, s) if s else (s,)
    out = {k: {i: state[k][i] for i in keep} for k in ("exists", "f1", "g0")}
    gb = state["g_burst"]
    lo, hi = np.searchsorted(gb, [s * SHARD_WIDTH, (s + 1) * SHARD_WIDTH])
    out["g_burst"] = gb[lo:hi]
    return out


def _bsi_shard_job(job):
    """bsi_shard in a worker process: job is its arguments."""
    return bsi_shard(*job)


def bsi_path(args, holder, ex, state):
    import torch

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    S = args.shards
    idx = holder.index("smoke")
    sw = SHARD_WIDTH
    # PQL writes: (field, column, value or None for Clear); the first goes
    # below -2^19, so its sign row and top plane change
    writes = [
        ("amount", 3 * sw + 12345, -777_777),
        ("amount", 5 * sw + 99, 0),
        ("amount", 2 * sw + 1, None),
        ("amount", (S // 2) * sw + 777, 1_000_000),
        ("amount", (S - 1) * sw + 5, None),
        ("age", ((S * 7) // 8) * sw + 3, 120),
    ]
    samples = sorted({0, N_VALUE_IMPORT, S // 2, S - 1})

    K.reset_launches()
    t0 = time.perf_counter()
    amount = idx.create_field("amount", FieldOptions(type="int", min=AMOUNT[0], max=AMOUNT[1]))
    age = idx.create_field("age", FieldOptions(type="int", min=AGE[0], max=AGE[1]))
    deep = idx.create_field("deep", FieldOptions(type="int", min=DEEP[0], max=DEEP[1]))
    check(
        (amount.options.base, amount.options.bit_depth, age.options.base, age.options.bit_depth) == (0, 20, 0, 7)
        and (deep.options.base, deep.options.bit_depth) == (0, 32),
        f"int field options: amount {amount.options}, age {age.options}, deep {deep.options}",
    )
    ans, age42, probes = {}, {}, []
    gen_s = import_s = values_s = 0.0
    n_values = 0

    def fold(out):
        probes.append(out["probe"])
        for k, v in out["ans"].items():
            if k in ("min", "max", "max_age_g0", "min_age_f1_sh2", "deep_min", "deep_max"):
                ans[k] = _merge_extreme(ans.get(k), v, k in ("min", "min_age_f1_sh2", "deep_min"))
            elif isinstance(v, tuple):
                old = ans.get(k, (0, 0))
                ans[k] = (old[0] + v[0], old[1] + v[1])
            else:
                ans[k] = ans.get(k, 0) + v
        if "age42" in out:
            age42[out["s"]] = out["age42"]

    def import_planes(frag, ex_w, sign_w, planes_w):
        frag.import_row_words(BSI_EXISTS_BIT, ex_w)
        if sign_w is not None:
            frag.import_row_words(BSI_SIGN_BIT, sign_w)
        for d, pw in enumerate(planes_w):
            frag.import_row_words(BSI_OFFSET_BIT + d, pw)

    # the shards are generated in 7 worker processes (numpy generation on
    # threads holds the GIL against the imports), each sent only the rows
    # of state its shard reads; the main thread imports
    bsi_views = {f: f._view_create(f.bsi_view_name()) for f in (amount, age, deep)}
    jobs = [(args.seed, s, _bsi_shard_state(state, s), writes, s in samples) for s in range(S)]
    pool = ProcessPoolExecutor(max_workers=7, mp_context=multiprocessing.get_context("spawn"))
    try:
        t_gen = time.perf_counter()
        for out in pool.map(_bsi_shard_job, jobs, chunksize=4):
            gen_s += time.perf_counter() - t_gen
            t_imp = time.perf_counter()
            if "values" in out:
                ca, va, cg, vg = out["values"]
                amount.import_values(ca, va)
                age.import_values(cg, vg)
                n_values += len(ca) + len(cg)
                values_s += time.perf_counter() - t_imp
            else:
                for f in (amount, age):
                    import_planes(bsi_views[f].fragment(out["s"]), *out["words"][f.name])
            import_planes(bsi_views[deep].fragment(out["s"]), *out.pop("deep_words"))
            fold(out)
            import_s += time.perf_counter() - t_imp
            t_gen = time.perf_counter()
    finally:
        pool.shutdown(cancel_futures=True)
    got = []
    for field, col, value in writes:
        pql = f"Clear({col}, {field}=0)" if value is None else f"Set({col}, {field}={value})"
        got += ex.execute("smoke", pql)
    check(got == [True] * len(writes), f"BSI writes returned {got}")
    state["sum_g0"] = ans["sum_g0"]
    state["probe"] = tuple(np.concatenate(p) for p in zip(*probes))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    values_per_s = n_values / values_s
    print(
        f"bsi: ingest {ingest_s:.2f} s (waits for generation in 7 processes {gen_s:.2f} s, imports {import_s:.2f} s); "
        f"Field.import_values took {n_values} values in {values_s:.2f} s = {values_per_s:.0f} values/s"
    )

    A = ans
    # (pql, numpy's answer, what it launches: "sum" bsi_sum, "mm:<field>"
    # bsi_min_max or, on a field deeper than the slab, bsi_min_max_step,
    # "count" bsi_range_step, "rows" bsi_range, "mask" plan_count)
    queries = [
        ("Sum(field=amount)", [A["sum"]], "sum"),
        ("Sum(Row(f=1), field=amount)", [A["sum_f1"]], "sum"),
        ("Sum(field=amount, filter=Row(age > 65))", [A["sum_old"]], "sum"),
        ("Min(field=amount)", [A["min"]], "mm:amount"),
        ("Max(field=amount)", [A["max"]], "mm:amount"),
        ("Max(Row(g=0), field=age)", [A["max_age_g0"]], "mm:age"),
        ("Count(Row(amount > 500000))", [A["gt500k"]], "count"),
        ("Count(Row(amount <= -250000))", [A["le_m250k"]], "count"),
        ("Count(Row(amount == 12345))", [A["eq12345"]], "count"),
        ("Count(Row(amount != 0))", [A["ne0"]], "count"),
        ("Count(Row(-1000 <= amount <= 1000))", [A["btw1000"]], "count"),
        ("Count(Row(amount != null))", [A["notnull"]], "mask"),
        ("Count(Intersect(Row(age >= 18), Row(f=1)))", [A["adult_f1"]], "rows"),
        ("Count(Union(Row(age < 13), Row(age > 65)))", [A["young_or_old"]], "rows"),
        # a Shift in the filter (carried across shards), a non-call filter
        ("Sum(field=amount, filter=Shift(Row(g=0), n=1))", [A["sum_g0_sh1"]], "sum"),
        ("Min(Shift(Row(f=1), n=2), field=age)", [A["min_age_f1_sh2"]], "mm:age"),
        ("Sum(field=amount, filter=5)", [A["sum"]], "sum"),
        # the signed field 32 bits deep
        ("Sum(field=deep)", [A["deep_sum"]], "sum"),
        ("Min(field=deep)", [A["deep_min"]], "mm:deep"),
        ("Max(field=deep)", [A["deep_max"]], "mm:deep"),
        (f"Count(Row(deep < {DEEP_LT}))", [A["deep_lt"]], "count"),
        (f"Count(Row(deep > {DEEP_GT}))", [A["deep_gt"]], "count"),
        ("Sum(Shift(Row(g=0), n=1), field=deep)", [A["deep_sum_g0_sh1"]], "sum"),
    ]
    depths = {"amount": amount.options.bit_depth, "age": age.options.bit_depth, "deep": deep.options.bit_depth}

    def kernel_of(what, slab):
        if what.startswith("mm:"):
            return "bsi_min_max_step" if depths[what[3:]] > slab else "bsi_min_max"
        return {"sum": "bsi_sum", "count": "bsi_range_step", "rows": "bsi_range", "mask": "plan_count"}[what]

    def norm(r):
        return (r.value, r.count) if hasattr(r, "value") else r

    from pilosa_tpu_torch.exec import bsistream

    t0 = time.perf_counter()
    deep_launches = {k: 0 for k in BSI_KERNELS}
    slab_stats = {}
    # the default slab of 16 streams amount (20 planes: 4, then 16) and
    # deep (32: 16 and 16); a slab of 4 streams every int field
    for slab in (16, 4):
        bsistream.configure(slab_planes=slab)
        for pql, want, what in queries:
            kernel = kernel_of(what, slab)
            before = dict(K.LAUNCHES)
            sb = bsistream.stats_snapshot()
            got = [norm(r) for r in ex.execute("smoke", pql)]
            sa = bsistream.stats_snapshot()
            check(got == want, f"{pql} at slab {slab}: got {got}, numpy says {want}")
            check(K.LAUNCHES[kernel] > before[kernel], f"{pql} at slab {slab} launched no {kernel}")
            delta = {k: sa[k] - sb[k] for k in sa}
            slab_stats[f"{slab} {pql}"] = delta
            print(f"bsi slab {slab}: {pql}: slabs {delta['slabs']}, slab bytes {delta['slab_bytes']}, "
                  f"plane dispatches {delta['plane_dispatches']}")
            if "deep" in pql and slab == 16:
                for k in deep_launches:
                    deep_launches[k] += K.LAUNCHES[k] - before[k]
        if slab == 16:
            first_s = time.perf_counter() - t0
    bsistream.configure(slab_planes=16)
    print(
        f"bsi: Shift filters, a non-call filter and the signed 32-bit-deep field (values in +-(2^32 - 1) on "
        f"1/{int(1 / DEEP_DENSITY)} of the columns) equal numpy at slabs of 16 and 4 planes; the deep queries "
        f"launched {deep_launches} at 16"
    )
    before = K.LAUNCHES["bsi_range"]
    row = ex.execute("smoke", "Row(age == 42)")[0]
    check(K.LAUNCHES["bsi_range"] > before, "Row(age == 42) launched no bsi_range")
    for s, words in age42.items():
        seg = row.segment(s)
        got_w = np.zeros_like(words) if seg is None else seg.cpu().numpy().view(np.uint32)
        check(np.array_equal(got_w, words), f"Row(age == 42) shard {s} differs from numpy")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for name in BSI_KERNELS + ("plan_count",):
        check(launches[name] > 0, f"BSI path never launched {name}: {launches}")
    print(
        f"bsi: first pass of the {len(queries) + 1} BSI queries at the default slab (plane staging included) "
        f"{first_s:.2f} s; every answer equals numpy"
    )
    print(f"bsi: launches during ingest + queries: {launches}")

    lat = {}
    for pql in [q for q, _, _ in queries] + ["Row(age == 42)"]:
        lat[pql] = host_p50_ms(lambda pql=pql: ex.execute("smoke", pql))
    for pql, ms in lat.items():
        print(f"query p50 {ms:.3f} ms  {pql}")
    info = {
        "ingest_s": ingest_s,
        "first_pass_s": first_s,
        "import_values": n_values,
        "import_values_per_s": values_per_s,
        "deep_launches": deep_launches,
        "slab_stats": slab_stats,
        "answers": {k: A[k] for k in ("sum", "min", "gt500k")},
    }
    return launches, lat, info


SLAB_RESIDENCY_ROWS = 22  # [S, W] rows a quarter of the budget holds: 19 and 21 fit, 23 does not


def bsi_slab_residency(args, holder, ex, answers):
    """Phase 3c: the residency slab streaming exists for. On `amount` (20
    planes, exists and sign) over every shard, a device budget a quarter
    of which holds 22 [S, W] rows: a slab of 16 planes with the word rows
    (19) and Min's or the range count's carried state (21) fits, the whole
    stack (23) does not. At a slab of 16, Sum, Min and Count(Row(amount >
    500000)) must run in one shard chunk, at 64 (the whole stack) in two,
    each answer equal to numpy's. Prints each query's chunks, launches and
    slab counters, the card's peak memory over its first run after
    torch.cuda.empty_cache() (peak allocated, and above what was allocated
    before the query), and its in-process p50."""
    import torch

    from pilosa_tpu_torch.exec import bsistream
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    row_b = args.shards * WORDS_PER_ROW * 4
    dcache = holder.dcache
    old_budget = dcache.budget_bytes
    chunks = []
    real_agg, real_count = bsistream._aggregate_chunk, bsistream._count_chunk
    bsistream._aggregate_chunk = lambda *a, **k: chunks.append(1) or real_agg(*a, **k)
    bsistream._count_chunk = lambda *a, **k: chunks.append(1) or real_count(*a, **k)
    queries = [
        ("Sum(field=amount)", answers["sum"]),
        ("Min(field=amount)", answers["min"]),
        ("Count(Row(amount > 500000))", answers["gt500k"]),
    ]
    out = {}
    try:
        dcache.budget_bytes = 4 * SLAB_RESIDENCY_ROWS * row_b
        for slab, want_chunks in ((16, 1), (64, 2)):
            bsistream.configure(slab_planes=slab)
            for pql, want in queries:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                chunks.clear()
                before = dict(K.LAUNCHES)
                sb = bsistream.stats_snapshot()
                t0 = time.perf_counter()
                r = ex.execute("smoke", pql)[0]
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated()
                sa = bsistream.stats_snapshot()
                got = (r.value, r.count) if hasattr(r, "value") else r
                check(got == want, f"{pql} at slab {slab} under the slab budget: got {got}, numpy says {want}")
                check(len(chunks) == want_chunks, f"{pql} at slab {slab}: {len(chunks)} shard chunks, want {want_chunks}")
                n_chunks = len(chunks)
                launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}
                p50 = host_p50_ms(lambda pql=pql: ex.execute("smoke", pql), reps=5)
                rec = {
                    "chunks": n_chunks, "launches": launched, "first_ms": first_ms, "p50_ms": p50,
                    "peak_bytes": peak, "peak_above_bytes": peak - base,
                    **{k: sa[k] - sb[k] for k in sa},
                }
                out[f"{slab} {pql}"] = rec
                print(
                    f"bsi slab residency (quarter budget {SLAB_RESIDENCY_ROWS} rows), slab {slab}: {pql}: "
                    f"{n_chunks} chunk(s), launches {launched}, slabs {rec['slabs']}, slab bytes "
                    f"{rec['slab_bytes']}, first run {first_ms:.1f} ms, peak {peak} B ({peak - base} B above "
                    f"the {base} B allocated before), p50 {p50:.3f} ms"
                )
    finally:
        bsistream._aggregate_chunk, bsistream._count_chunk = real_agg, real_count
        bsistream.configure(slab_planes=16)
        dcache.budget_bytes = old_budget
    return out


# ---------------------------------------------------------------------------
# phase 4: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_timing(holder, ex, launches, errs):
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    idx = holder.index("smoke")
    view_f = idx.field("f").view()
    view_g = idx.field("g").view()
    shards = tuple(range(len(view_f.fragments)))
    s_all = len(shards)
    a = view_f.row_stack(1, shards)
    b = view_g.row_stack(0, shards)
    w = a.shape[1]
    rows = {}

    def row(name, source, replaces, fn, plain, nbytes, bound_by="bytes"):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        diff = int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs().max().item())
        check(diff == 0, f"{name}: kernel differs from twin by {diff} at main-path shape")
        errs[name] = max(errs.get(name, 0), diff)
        ms = cuda_time_ms(fn)
        disp = dispatch_ms(fn)
        plain_ms = cuda_time_ms(plain, reps=PLAIN_REPS)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": errs.get(name, 0),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": None,
            "dispatch_ms": disp,
            "share_of_bound": bound / ms,
            "bytes": nbytes,
        }
        print(
            f"kernel {name}: device {ms:.4f} ms, dispatch {disp:.4f} ms (host, per call), "
            f"twin {plain_ms:.4f} ms, {nbytes} B moved, bound {bound:.4f} ms ({bound / ms:.1%} of it), "
            f"{launches.get(name, 0)} launches on the main paths"
        )

    src = "pilosa_tpu_torch/ops/cuda/bitmap_kernels.cu"
    # count2 at Row.count()'s shape: every segment of Row(f=1), one launch
    segs = list(ex.execute("smoke", "Row(f=1)")[0].segments.values())
    row(
        "count2", src, "pilosa_tpu/ops/pallas_kernels.py:134",
        lambda: K.count2_segments(segs, None, "none"), lambda: K.count2_segments_plain(segs, None, "none"),
        sum(t.numel() for t in segs) * 4 + len(segs) * 8,
    )
    print(
        f"Row(f=1).count(): 1 count2 launch over {len(segs)} segments, device {rows['count2']['ms']:.4f} ms "
        f"(bound {rows['count2']['bound_ms']:.4f} ms)"
    )
    # plan_count: Count(Intersect(Row(f=1), Row(g=0))), two [S, W] leaves
    prog = [0, 1, K.BINOPS["and"]]
    row(
        "plan_count", src, "pilosa_tpu/exec/plan.py:296",
        lambda: K.plan_count([a, b], prog, s_all),
        lambda: K.plan_count_plain([a, b], prog, s_all),
        2 * a.numel() * 4 + s_all * 8,
    )
    # plan_count_multi: 16 Count roots (1-4 Rows each) over 8 distinct
    # main-path row stacks, as one batcher round sends them; "earlier" is
    # the 16 plan_count launches the same roots took before
    mleaves = [view_f.row_stack(r, shards) for r in range(6)] + [b, view_g.row_stack(1, shards)]
    mprogs = multi_programs(np.random.default_rng(4), 16, len(mleaves))
    used = len({i for p in mprogs for i in p if i >= 0})
    row(
        "plan_count_multi", src, "pilosa_tpu/exec/plan.py:316",
        lambda: K.plan_count_multi(mleaves, mprogs, s_all),
        lambda: K.plan_count_multi_plain(mleaves, mprogs, s_all),
        used * a.numel() * 4 + len(mprogs) * s_all * 8,
    )
    multi_extra = {
        "plan_count_multi_earlier": cuda_time_ms(lambda: [K.plan_count(mleaves, p, s_all) for p in mprogs]),
        "plan_count_multi_earlier_dispatch": dispatch_ms(lambda: [K.plan_count(mleaves, p, s_all) for p in mprogs]),
    }
    rows["plan_count_multi"]["earlier_ms"] = multi_extra["plan_count_multi_earlier"]
    print(
        f"kernel plan_count_multi, 16 roots over {used} leaves: earlier (16 plan_count launches) "
        f"{multi_extra['plan_count_multi_earlier']:.4f} ms device, "
        f"{multi_extra['plan_count_multi_earlier_dispatch']:.4f} ms dispatch"
    )
    del mleaves
    # plan_count_multi at a full launch, 64 roots over 32 leaves (their
    # words made on the card from a seed), and at the served front end's
    # round, 10 roots over its rows f 0-3 and g 0-1 at 512 shards
    gen = torch.Generator(device=a.device).manual_seed(64)
    wide = [torch.randint(-(2**31), 2**31, (s_all, w), dtype=torch.int32, device=a.device, generator=gen)
            for _ in range(32)]
    front = shards[:512]
    fleaves = [view_f.row_stack(r, front) for r in range(4)] + [view_g.row_stack(r, front) for r in range(2)]
    for key, lv, n_roots, sh in (("plan_count_multi_64x32", wide, 64, s_all),
                                 ("plan_count_multi_10x6_front", fleaves, 10, len(front))):
        pr = multi_programs(np.random.default_rng(4), n_roots, len(lv))
        n_used = len({i for p in pr for i in p if i >= 0})
        check(torch.equal(K.plan_count_multi(lv, pr, sh).cpu(), K.plan_count_multi_plain(lv, pr, sh).cpu()),
              f"{key}: kernel differs from its twin")
        multi_extra[key] = cuda_time_ms(lambda lv=lv, pr=pr, sh=sh: K.plan_count_multi(lv, pr, sh))
        multi_extra[key + "_dispatch"] = dispatch_ms(lambda lv=lv, pr=pr, sh=sh: K.plan_count_multi(lv, pr, sh))
        multi_extra[key + "_bound"] = (n_used * sh * w * 4 + n_roots * sh * 8) / HBM_BYTES_PER_S * 1e3
        multi_extra[key + "_share"] = multi_extra[key + "_bound"] / multi_extra[key]
        ms, bound = multi_extra[key], multi_extra[key + "_bound"]
        print(
            f"kernel {key}: {n_roots} roots over {n_used} leaves, S = {sh}: device {ms:.4f} ms, dispatch "
            f"{multi_extra[key + '_dispatch']:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of it)"
        )
    del wide, fleaves
    # rows_counts: the filtered-TopN dense tally tile (2 rows x S shards)
    planes = view_f.plane_stack((0, 1), shards).reshape(-1, w)
    row(
        "rows_counts", src, "pilosa_tpu/ops/pallas_kernels.py:177",
        lambda: K.rows_counts(planes, b), lambda: K.rows_counts_plain(planes, b),
        (planes.numel() + b.numel()) * 4 + planes.shape[0] * 4,
    )
    # gather_tally: the sparse rows' entries of TopN(f, Row(g=0)), bound by
    # the 32-byte sectors of the filter stack they touch
    present = [(s, view_f.fragment_if_exists(s)) for s in shards]
    bundle = ex._topn_tally_build(list(range(N_DENSE, N_DENSE + N_SPARSE)), present, w, a.device)
    gi, gm, gs, ge = bundle.dev
    n_ent, n_seg = gi.numel(), gs.numel()
    g_bytes, g_sectors = sector_bytes(gi, n_seg)
    row(
        "gather_tally", src, "pilosa_tpu/ops/bitmap.py:179",
        lambda: K.gather_tally(b, gi, gm, gs, ge), lambda: K.gather_tally_plain(b, gi, gm, gs, ge),
        g_bytes, "bytes (32-byte sectors)",
    )
    rows["gather_tally"]["sectors"] = g_sectors
    # the same number of entries over Zipf-skewed segment lengths (one
    # segment per shard and sparse row, at most W entries)
    z_lens = zipf_lengths(np.random.default_rng(1), n_ent, n_seg, w)
    zi = torch.from_numpy(shard_major_idx(np.random.default_rng(2), z_lens.reshape(-1, N_SPARSE), w)).to(a.device)
    z_ends = np.cumsum(z_lens).astype(np.int32)
    z_args = (b, zi, torch.ones_like(zi), torch.from_numpy(z_ends - z_lens.astype(np.int32)).to(a.device),
              torch.from_numpy(z_ends).to(a.device))
    check(torch.equal(K.gather_tally(*z_args).cpu(), K.gather_tally_plain(*z_args).cpu()), "skewed gather_tally differs from twin")
    z_bytes, z_sectors = sector_bytes(zi, n_seg)
    # the main path's entries in the row-major order of earlier bundles
    # (segment k * n_present + j): what the shard-major layout is worth
    lens = (ge - gs).cpu().numpy()
    seg_of = np.repeat(np.arange(n_seg), lens)
    perm = torch.from_numpy(np.lexsort((np.arange(n_ent), seg_of // N_SPARSE, seg_of % N_SPARSE))).to(a.device)
    rm_lens = lens.reshape(-1, N_SPARSE).T.reshape(-1)
    rm_ends = np.cumsum(rm_lens).astype(np.int32)
    rm_args = (b, gi[perm], gm[perm], torch.from_numpy(rm_ends - rm_lens.astype(np.int32)).to(a.device),
               torch.from_numpy(rm_ends).to(a.device))
    check(
        torch.equal(K.gather_tally(*rm_args).reshape(N_SPARSE, -1).T.cpu(), K.gather_tally(b, gi, gm, gs, ge).reshape(-1, N_SPARSE).cpu()),
        "gather_tally over the row-major layout differs from the shard-major one",
    )
    extra = {
        "gather_tally_bound_words_ms": (n_ent * 4 * 3 + n_seg * 4 * 3) / HBM_BYTES_PER_S * 1e3,
        "gather_tally_row_major": cuda_time_ms(lambda: K.gather_tally(*rm_args)),
        "gather_tally_skewed": cuda_time_ms(lambda: K.gather_tally(*z_args)),
        "gather_tally_skewed_bound": z_bytes / HBM_BYTES_PER_S * 1e3,
    }
    extra["gather_tally_skewed_share"] = extra["gather_tally_skewed_bound"] / extra["gather_tally_skewed"]
    extra |= multi_extra
    del rm_args, perm
    print(
        f"gather_tally: {n_ent} entries, {n_seg} segments, {g_sectors} sectors touched; old 4-byte-gather bound "
        f"{extra['gather_tally_bound_words_ms']:.4f} ms; the same entries row-major "
        f"{extra['gather_tally_row_major']:.4f} ms. Zipf-skewed, {zi.numel()} entries (longest segment "
        f"{int(z_lens.max())}), {z_sectors} sectors: device {extra['gather_tally_skewed']:.4f} ms, bound "
        f"{extra['gather_tally_skewed_bound']:.4f} ms ({extra['gather_tally_skewed_share']:.1%} of it), "
        f"{extra['gather_tally_skewed'] / rows['gather_tally']['ms']:.2f}x the main path's"
    )
    del z_args, zi
    # count2 on one [W] segment (Row.count()'s launch before segment
    # lists) and with an operator on the Count(Intersect) operands, for
    # comparison with plan_count
    seg = a[0].contiguous()
    extra |= {
        "count2_one_segment": cuda_time_ms(lambda: K.popcount(seg)),
        "count2_one_segment_dispatch": dispatch_ms(lambda: K.popcount(seg)),
        "count2_one_segment_bound": (w * 4 + 8) / HBM_BYTES_PER_S * 1e3,
        "count2_and_SxW": cuda_time_ms(lambda: K.count2(a, b, "and")),
        "count2_and_SxW_dispatch": dispatch_ms(lambda: K.count2(a, b, "and")),
        "count2_and_SxW_plain": cuda_time_ms(lambda: K.count2_plain(a, b, "and")),
        "count2_and_SxW_bound": (2 * a.numel() * 4 + 8) / HBM_BYTES_PER_S * 1e3,
        "popcount_SxW": cuda_time_ms(lambda: K.popcount(a)),
    }
    print(
        f"kernel count2(and) on [S, W]: device {extra['count2_and_SxW']:.4f} ms "
        f"(dispatch {extra['count2_and_SxW_dispatch']:.4f} ms, twin {extra['count2_and_SxW_plain']:.4f} ms, "
        f"bound {extra['count2_and_SxW_bound']:.4f} ms); popcount of one [W] segment: device "
        f"{extra['count2_one_segment']:.4f} ms, dispatch {extra['count2_one_segment_dispatch']:.4f} ms"
    )
    # plan_count over 28 leaves: g=0 minus the union of the other 27 stacks
    # (every row of f and g, then copies of f rows up to 28 distinct stacks)
    from pilosa_tpu_torch.exec import plan as planmod

    n_f = N_DENSE + N_SPARSE
    stacks = [view_f.row_stack(r, shards) for r in range(n_f)] + [view_g.row_stack(r, shards) for r in range(N_G)]
    stacks += [stacks[i].clone() for i in range(28 - len(stacks))]
    wide_root = planmod.PNary(
        "andnot", (planmod.PLeaf(n_f), planmod.PNary("or", tuple(planmod.PLeaf(i) for i in range(28) if i != n_f)))
    )
    wl, _, wp = planmod._compile(wide_root, stacks, {})
    check(len(wl) == 28, f"wide plan has {len(wl)} leaves")
    check(torch.equal(K.plan_count(wl, wp, s_all).cpu(), K.plan_count_plain(wl, wp, s_all).cpu()), "wide plan_count differs from twin")
    extra["plan_count_28_leaves"] = cuda_time_ms(lambda: K.plan_count(wl, wp, s_all))
    extra["plan_count_28_leaves_dispatch"] = dispatch_ms(lambda: K.plan_count(wl, wp, s_all))
    extra["plan_count_28_leaves_plain"] = cuda_time_ms(lambda: K.plan_count_plain(wl, wp, s_all))
    extra["plan_count_28_leaves_bound"] = (28 * a.numel() * 4 + s_all * 8) / HBM_BYTES_PER_S * 1e3
    # plan_rows (row mode) at the same shapes: the 28-leaf tree's result
    # words, 2 leaves (Intersect(Row(f=1), Row(g=0))) and a Shift over one
    # leaf (Shift(Row(f=1), n=1): each shard's predecessor is the stack row
    # before it); each bound reads every leaf once and writes the result
    rl, rs, rp = planmod._compile(wide_root, stacks, {}, rows_mode=True)
    prev = tuple(range(-1, s_all - 1))
    for key, (lv, sh, pr) in {
        "plan_rows_2_leaves": ([a, b], [None, None], prog),
        "plan_rows_28_leaves": (rl, rs, rp),
        "plan_rows_shift_leaf": ([a], [(1, prev)], [0]),
    }.items():
        got, want = K.plan_rows(lv, sh, pr), K.plan_rows_plain(lv, sh, pr)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"{key}: plan_rows differs from twin")
        nbytes = (len(lv) + 1) * a.numel() * 4 + s_all * 8
        extra[key] = cuda_time_ms(lambda lv=lv, sh=sh, pr=pr: K.plan_rows(lv, sh, pr))
        extra[key + "_dispatch"] = dispatch_ms(lambda lv=lv, sh=sh, pr=pr: K.plan_rows(lv, sh, pr))
        extra[key + "_plain"] = cuda_time_ms(lambda lv=lv, sh=sh, pr=pr: K.plan_rows_plain(lv, sh, pr))
        extra[key + "_bound"] = nbytes / HBM_BYTES_PER_S * 1e3
        extra[key + "_share"] = extra[key + "_bound"] / extra[key]
        print(
            f"kernel {key}: device {extra[key]:.4f} ms, dispatch {extra[key + '_dispatch']:.4f} ms, twin "
            f"{extra[key + '_plain']:.4f} ms, bound {extra[key + '_bound']:.4f} ms ({extra[key + '_share']:.1%} of it)"
        )
        del got, want
    del rl, rs, rp
    # what replaced the per-launch pageable table copy: the host side of
    # staging the 2-leaf table in a pinned slot, and the device side of
    # its asynchronous copy (zeros for the [S] output included)
    parts = (np.zeros(s_all, np.int64), [a.data_ptr(), b.data_ptr()], prog, [0, 1])
    n_table = sum(len(p) for p in parts)
    extra["plan_count_staging_host"] = dispatch_ms(lambda: K._STAGING.launch(a.device, parts, lambda *args: 0))
    pinned = torch.zeros(n_table, dtype=torch.int64, pin_memory=True)
    extra["plan_count_staging_copy"] = cuda_time_ms(
        lambda: torch.empty(n_table, dtype=torch.int64, device=a.device).copy_(pinned, non_blocking=True)
    )
    print(
        f"plan_count staging ({n_table} int64): host {extra['plan_count_staging_host']:.4f} ms, "
        f"device copy {extra['plan_count_staging_copy']:.4f} ms"
    )

    # BSI kernels at the BSI path's shapes: the amount field's [20, S, W]
    # planes with its exists and sign rows; the age field's [7, S, W]
    # planes with its exists row (no sign row: an unsigned field)
    from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT

    bsrc = "pilosa_tpu_torch/ops/cuda/bsi_kernels.cu"
    fa, fg = idx.field("amount"), idx.field("age")
    va, vg = fa.view(fa.bsi_view_name()), fg.view(fg.bsi_view_name())
    da, dg = fa.options.bit_depth, fg.options.bit_depth
    ap = va.plane_stack(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + da), shards)
    ae, asg = va.row_stack(BSI_EXISTS_BIT, shards), va.row_stack(BSI_SIGN_BIT, shards)
    gp = vg.plane_stack(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + dg), shards)
    ge = vg.row_stack(BSI_EXISTS_BIT, shards)
    stack_b = ae.numel() * 4
    row(
        "bsi_sum", bsrc, "pilosa_tpu/ops/pallas_kernels.py:232",
        lambda: K.bsi_sum(ap, ae, asg, None), lambda: K.bsi_sum_plain(ap, ae, asg, None),
        (da + 2) * stack_b + (1 + 2 * da) * 8,
    )
    row(
        "bsi_min_max", bsrc, "pilosa_tpu/ops/bsi.py:568",
        lambda: K.bsi_min_max(ap, ae, asg, None, True), lambda: K.bsi_min_max_plain(ap, ae, asg, None, True),
        (da + 2) * stack_b + 3 * 8,
    )
    # Count(Row(amount > 500000)): one job, gt over the positive mask
    row(
        "bsi_range", bsrc, "pilosa_tpu/ops/bsi.py:861",
        lambda: K.bsi_range(ap, ae, asg, "pos", "gt", False, 500_000, 0, "count"),
        lambda: K.bsi_range_plain(ap, ae, asg, "pos", "gt", False, 500_000, 0, "count"),
        (da + 2) * stack_b + s_all * 8,
    )
    # Count(Row(age > 65)) on the unsigned field, and the rows mode of
    # Row(age == 42)
    age_count = lambda: K.bsi_range(gp, ge, None, "consider", "gt", False, 65, 0, "count")  # noqa: E731
    check(
        torch.equal(age_count().cpu(), K.bsi_range_plain(gp, ge, None, "consider", "gt", False, 65, 0, "count").cpu()),
        "bsi_range on age differs from its twin",
    )
    extra["bsi_range_age_count"] = cuda_time_ms(age_count)
    extra["bsi_range_age_count_plain"] = cuda_time_ms(
        lambda: K.bsi_range_plain(gp, ge, None, "consider", "gt", False, 65, 0, "count")
    )
    extra["bsi_range_age_count_bound"] = ((dg + 1) * stack_b + s_all * 8) / HBM_BYTES_PER_S * 1e3
    extra["bsi_range_age_rows"] = cuda_time_ms(lambda: K.bsi_range(gp, ge, None, "consider", "eq", False, 42, 0, "rows"))
    extra["bsi_range_age_rows_bound"] = (dg + 2) * stack_b / HBM_BYTES_PER_S * 1e3
    extra["bsi_sum_amount_filtered"] = cuda_time_ms(lambda: K.bsi_sum(ap, ae, asg, ge))
    extra["bsi_sum_amount_filtered_bound"] = ((da + 3) * stack_b + (1 + 2 * da) * 8) / HBM_BYTES_PER_S * 1e3
    print(
        f"kernel bsi_range on age (count): {extra['bsi_range_age_count']:.4f} ms "
        f"(twin {extra['bsi_range_age_count_plain']:.4f} ms, bound {extra['bsi_range_age_count_bound']:.4f} ms); "
        f"rows mode {extra['bsi_range_age_rows']:.4f} ms (bound {extra['bsi_range_age_rows_bound']:.4f} ms); "
        f"bsi_sum filtered {extra['bsi_sum_amount_filtered']:.4f} ms (bound {extra['bsi_sum_amount_filtered_bound']:.4f} ms)"
    )
    # the three BSI kernels over the signed field 32 bits deep: [32, S, W]
    # planes, its exists and sign rows; each bound reads 34 [S, W] rows
    # once (and the range kernel's edge predicates up to 2^32 - 1 held to
    # the twin first)
    fd = idx.field("deep")
    vd, dd = fd.view(fd.bsi_view_name()), fd.options.bit_depth
    dp = vd.plane_stack(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + dd), shards)
    de, dsg = vd.row_stack(BSI_EXISTS_BIT, shards), vd.row_stack(BSI_SIGN_BIT, shards)
    for sel, kind, p0, p1 in (("pos", "eq", 2**32 - 1, 0), ("neg", "eq", 2**32 - 1, 0), ("pos", "gt", 2**31, 0),
                              ("neg", "lt", 2**32 - 2, 0), ("pos", "between", 2**31 - 1, 2**32 - 1)):
        for allow_eq in (False, True):
            got = K.bsi_range(dp, de, dsg, sel, kind, allow_eq, p0, p1, "count")
            want = K.bsi_range_plain(dp, de, dsg, sel, kind, allow_eq, p0, p1, "count")
            check(torch.equal(got.cpu(), want.cpu()), f"bsi_range at depth 32 ({sel} {kind} {p0} {p1} {allow_eq}) differs from its twin")
    d32 = {
        "bsi_sum": (lambda: K.bsi_sum(dp, de, dsg, None), lambda: K.bsi_sum_plain(dp, de, dsg, None), (1 + 2 * dd) * 8),
        "bsi_min_max": (lambda: K.bsi_min_max(dp, de, dsg, None, True), lambda: K.bsi_min_max_plain(dp, de, dsg, None, True), 3 * 8),
        "bsi_range": (lambda: K.bsi_range(dp, de, dsg, "neg", "lt", True, 2**31, 0, "count"),
                      lambda: K.bsi_range_plain(dp, de, dsg, "neg", "lt", True, 2**31, 0, "count"), s_all * 8),
    }
    for name, (fn, plain, out_b) in d32.items():
        got, want = fn(), plain()
        diff = int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs().max().item())
        check(diff == 0, f"{name} at depth 32 (signed) differs from its twin by {diff}")
        nbytes = (dd + 2) * stack_b + out_b
        ms = cuda_time_ms(fn)
        r = {
            "ms": ms, "dispatch_ms": dispatch_ms(fn), "plain_ms": cuda_time_ms(plain, reps=3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes, "max_abs_err": diff,
            "launches": launches.get(name + "_deep", 0),
        }
        r["share_of_bound"] = r["bound_ms"] / ms
        rows[name]["d32_signed"] = r
        print(
            f"kernel {name} at depth 32 (signed, [{dd}, {s_all}, {w}]): device {ms:.4f} ms, dispatch "
            f"{r['dispatch_ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['share_of_bound']:.1%} of it), {r['launches']} launches on the deep queries"
        )
    step_rows(rows, launches, errs, stack_b, (dp, de, dsg, dd), (ap, ae, asg, da), bsrc)
    del dp, de, dsg
    # GroupBy kernels at the main path's shapes: GroupBy(Rows(f), Rows(g))
    # descends in chunks of gmax(S, W) = 2 prefixes, each a counts_cross of
    # a [2, S, W] accumulator against g's [4, S, W] planes; the filtered
    # GroupBy's selections are gather_and of 2 rows of f's [16, S, W]
    # planes with the [S, W] filter Row(f=1)
    from pilosa_tpu_torch.exec import groupby as gbmod

    gm = min(gbmod.gmax(s_all, w), N_DENSE + N_SPARSE)
    acc = view_f.plane_stack(tuple(range(gm)), shards)
    planes_g = view_g.plane_stack(tuple(range(N_G)), shards)
    gb_out = gm * N_G * s_all * 4
    row(
        "counts_cross", src, "pilosa_tpu/exec/groupby.py:68",
        lambda: K.counts_cross(acc, planes_g), lambda: K.counts_cross_plain(acc, planes_g),
        (gm + N_G) * s_all * w * 4 + gb_out,
    )
    f_all = view_f.plane_stack(tuple(range(N_DENSE + N_SPARSE)), shards)
    sel, zeros = list(range(gm)), [0] * gm
    # the bound reads each distinct operand slab once: gm rows of f, the
    # one filter slab, and writes gm slabs
    row(
        "gather_and", src, "pilosa_tpu/exec/groupby.py:97",
        lambda: K.gather_and(f_all, sel, a[None], zeros),
        lambda: K.gather_and_plain(f_all, sel, a[None], zeros),
        (len(set(sel)) + len(set(zeros)) + gm) * s_all * w * 4,
    )
    # counts_cross once more at a one-shot shape: G = 16 prefixes x R = 8
    # rows over 64 shards (the one-shot path's last level)
    s64 = shards[: min(64, s_all)]
    acc16 = view_f.plane_stack(tuple(range(16)), s64)
    planes8 = view_f.plane_stack(tuple(range(8)), s64)
    check(torch.equal(K.counts_cross(acc16, planes8).cpu(), K.counts_cross_plain(acc16, planes8).cpu()),
          "counts_cross at G = 16, R = 8 differs from its twin")
    one_bytes = (16 + 8) * len(s64) * w * 4 + 16 * 8 * len(s64) * 4
    extra |= {
        "counts_cross_oneshot_G16_R8_S64": cuda_time_ms(lambda: K.counts_cross(acc16, planes8)),
        "counts_cross_oneshot_dispatch": dispatch_ms(lambda: K.counts_cross(acc16, planes8)),
        "counts_cross_oneshot_plain": cuda_time_ms(lambda: K.counts_cross_plain(acc16, planes8)),
        "counts_cross_oneshot_bound": one_bytes / HBM_BYTES_PER_S * 1e3,
    }
    extra["counts_cross_oneshot_share"] = extra["counts_cross_oneshot_bound"] / extra["counts_cross_oneshot_G16_R8_S64"]
    print(
        f"kernel counts_cross one-shot (G 16, R 8, S {len(s64)}): device {extra['counts_cross_oneshot_G16_R8_S64']:.4f} ms, "
        f"dispatch {extra['counts_cross_oneshot_dispatch']:.4f} ms, twin {extra['counts_cross_oneshot_plain']:.4f} ms, "
        f"bound {extra['counts_cross_oneshot_bound']:.4f} ms ({extra['counts_cross_oneshot_share']:.1%} of it)"
    )
    del acc, planes_g, f_all, acc16, planes8
    print(
        f"kernel plan_count, 28 leaves: device {extra['plan_count_28_leaves']:.4f} ms "
        f"(dispatch {extra['plan_count_28_leaves_dispatch']:.4f} ms, twin {extra['plan_count_28_leaves_plain']:.4f} ms, "
        f"bound {extra['plan_count_28_leaves_bound']:.4f} ms, "
        f"{extra['plan_count_28_leaves_bound'] / extra['plan_count_28_leaves']:.1%} of it)"
    )
    return rows, extra


def step_rows(rows, launches, errs, stack_b, deep, amount, bsrc):
    """Timing rows of the slab step kernels at the main path's steps of
    `deep` (signed, 32 planes in two slabs of 16: a 33-bit key, int64 va):
    the first step, planes [16, 32), which writes the state, and the last,
    planes [0, 16), which reads it and reduces; Count(Row(deep > DEEP_GT))
    for the range step. And the last step of `amount` (planes [0, 16) after
    [16, 20); a 21-bit key, int32 va), and bsi_sum over one 16-plane slab.
    Each bound reads each distinct input once and writes the state (or the
    result) once."""
    import torch

    from pilosa_tpu_torch.ops import bsi as obsi
    from pilosa_tpu_torch.ops import kernels as K

    dp, de, dsg, dd = deep
    ap, ae, asg, da = amount
    jobs, preds = (("gt", "pos", False),), (DEEP_GT,)

    def same(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    def timed(fn, plain, nbytes, reps_plain=PLAIN_REPS):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        return {
            "exact": same(got, want), "ms": cuda_time_ms(fn), "dispatch_ms": dispatch_ms(fn),
            "plain_ms": cuda_time_ms(plain, reps=reps_plain), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        }

    hi, lo_ = dp[16:], dp[:16]
    kb = dd + 1
    va_rows = 2 if obsi.min_max_wide(kb) else 1
    mm = {
        "first": timed(
            lambda: K.bsi_min_max_step(hi, de, dsg, None, None, True, True, False, kb),
            lambda: obsi.min_max_step(hi, de, dsg, None, None, True, True, False, kb),
            (16 + 2) * stack_b + (1 + va_rows) * stack_b,
        )
    }
    state = K.bsi_min_max_step(hi, de, dsg, None, None, True, True, False, kb)
    mm["last"] = timed(
        lambda: K.bsi_min_max_step(lo_, de, dsg, None, state, True, False, True, kb),
        lambda: obsi.min_max_step(lo_, de, dsg, None, state, True, False, True, kb),
        (16 + 1 + 1 + va_rows) * stack_b + 3 * 8,
    )
    a_state = K.bsi_min_max_step(ap[16:], ae, asg, None, None, True, True, False, da + 1)
    mm["amount_last"] = timed(
        lambda: K.bsi_min_max_step(ap[:16], ae, asg, None, a_state, True, False, True, da + 1),
        lambda: obsi.min_max_step(ap[:16], ae, asg, None, a_state, True, False, True, da + 1),
        (16 + 3) * stack_b + 3 * 8,
    )
    rs = {
        "first": timed(
            lambda: K.bsi_range_step(hi, de, dsg, None, jobs, preds, 16, True, False),
            lambda: obsi.range_step(hi, de, dsg, None, jobs, preds, 16, True, False),
            (16 + 2) * stack_b + 2 * stack_b,
        )
    }
    r_state = K.bsi_range_step(hi, de, dsg, None, jobs, preds, 16, True, False)
    rs["last"] = timed(
        lambda: K.bsi_range_step(lo_, de, dsg, r_state, jobs, preds, 0, False, True),
        lambda: obsi.range_step(lo_, de, dsg, r_state, jobs, preds, 0, False, True),
        (16 + 2) * stack_b + 8,
    )
    a_jobs, a_preds = (("gt", "pos", False),), (500_000,)
    ar_state = K.bsi_range_step(ap[16:], ae, asg, None, a_jobs, a_preds, 16, True, False)
    rs["amount_last"] = timed(
        lambda: K.bsi_range_step(ap[:16], ae, asg, ar_state, a_jobs, a_preds, 0, False, True),
        lambda: obsi.range_step(ap[:16], ae, asg, ar_state, a_jobs, a_preds, 0, False, True),
        (16 + 2) * stack_b + 8,
    )
    # sum_stream_slab's port: bsi_sum over one [16, S, W] slab of deep
    # (16 planes, exists and sign read, a [1 + 32] tally written)
    sm = timed(lambda: K.bsi_sum(lo_, de, dsg, None), lambda: K.bsi_sum_plain(lo_, de, dsg, None),
               (16 + 2) * stack_b + 33 * 8)
    check(sm.pop("exact"), "bsi_sum over a 16-plane slab differs from its twin")
    sm["share_of_bound"] = sm["bound_ms"] / sm["ms"]
    rows["bsi_sum"]["slab16_signed"] = sm
    print(
        f"kernel bsi_sum over one slab ([16, {dp.shape[1]}, {dp.shape[2]}] signed, sum_stream_slab): device "
        f"{sm['ms']:.4f} ms, dispatch {sm['dispatch_ms']:.4f} ms, twin {sm['plain_ms']:.4f} ms, bound "
        f"{sm['bound_ms']:.4f} ms ({sm['share_of_bound']:.1%} of it)"
    )
    for name, parts, replaces in (("bsi_min_max_step", mm, "pilosa_tpu/ops/bsi.py:631"),
                                  ("bsi_range_step", rs, "pilosa_tpu/ops/bsi.py:917")):
        for step, r in parts.items():
            check(r["exact"], f"{name} ({step} step) differs from its twin at the main path's shape")
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            print(
                f"kernel {name} ({step} step, [16, {dp.shape[1]}, {dp.shape[2]}] signed): device {r['ms']:.4f} ms, "
                f"dispatch {r['dispatch_ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, {r['bytes']} B, bound "
                f"{r['bound_ms']:.4f} ms ({r['share_of_bound']:.1%} of it)"
            )
        last = parts["last"]
        errs[name] = max(errs.get(name, 0), 0)
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": bsrc,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": last["ms"],
            "plain_ms": last["plain_ms"],
            "bound_ms": last["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "dispatch_ms": last["dispatch_ms"],
            "share_of_bound": last["share_of_bound"],
            "bytes": last["bytes"],
            "steps": {k: {kk: vv for kk, vv in v.items() if kk != "exact"} for k, v in parts.items()},
        }


# ---------------------------------------------------------------------------
# phase 4b: residency — extents, the merge barrier and in-place patches
# ---------------------------------------------------------------------------

BURST = 1 << 21  # columns of one staged burst into f row 0, and into g row 0
RES_CYCLES = 2  # paging cycles of the query set, with extents and whole stacks (3 until PR 11)
RES_QUERIES = [
    "Count(Intersect(Row(f=0), Row(g=0)))",
    "Count(Union(Row(f=0), Row(f=1), Row(g=1)))",
    "Count(Not(Row(f=1)))",
    "TopN(f, Row(g=0), n=10)",
    "Sum(Row(g=0), field=amount)",
    "Row(f=0)",
]


def residency_bursts(seed: int, S: int) -> dict:
    """The columns of phase 4b's two staged bursts (f row 0 and g row 0
    each), drawn before the BSI phase, which records `amount` at the g
    columns for the filtered Sum's numpy answer."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng([seed, 4])
    out = {k: rng.integers(0, S * SHARD_WIDTH, BURST).astype(np.uint64) for k in ("f1", "g1", "f2", "g2")}
    out["g_burst"] = sorted_unique(np.concatenate([out["g1"], out["g2"]]))
    return out


def rotating(fns):
    """One callable running fns[0], fns[1], ... in turn. Timed back to
    back over sets whose data together exceeds the L2 (L2_BYTES), each
    call finds its data gone from the L2, as a patch or a merge on the
    path finds its entry or its burst."""
    turn = [0]

    def call():
        fn = fns[turn[0] % len(fns)]
        turn[0] += 1
        return fn()

    return call


def time_row(name, source, replaces, fns, plains, nbytes, launches, errs, bound_by="bytes"):
    """A `kernels` row: the kernel held to its twin on every data set,
    then its device, dispatch and twin times (phase 4's method) rotating
    over the sets, and its bound: the mean of the sets' bytes (`nbytes`,
    one per set) at the HBM rate."""
    import torch

    diff = 0
    for fn, plain in zip(fns, plains):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        diff = max([diff] + [int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max().item())
                             if a.numel() else 0 for a, b in zip(got, want)])
    check(diff == 0, f"{name}: kernel differs from its twin by {diff} at its path's shape")
    errs[name] = max(errs.get(name, 0), diff)
    fn, plain = rotating(fns), rotating(plains)
    ms, disp, plain_ms = cuda_time_ms(fn), dispatch_ms(fn), cuda_time_ms(plain)
    per_call = sum(nbytes) / len(nbytes)
    bound = per_call / HBM_BYTES_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": errs.get(name, 0), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None, "dispatch_ms": disp, "share_of_bound": bound / ms,
        "bytes": per_call, "data_sets": len(fns), "rotated_bytes": sum(nbytes),
    }
    print(
        f"kernel {name}: device {ms:.4f} ms, dispatch {disp:.4f} ms (host, per call), twin {plain_ms:.4f} ms, "
        f"{per_call:.0f} B moved per call, rotating over {len(fns)} sets ({sum(nbytes)} B, the L2 holds "
        f"{L2_BYTES}), bound {bound:.4f} ms ({bound / ms:.1%} of it), {launches} launches on the residency path"
    )
    return row


def residency_path(args, holder, ex, state, errs, smi):
    """Phase 4b on the main path's holder: warm passes, two staged bursts
    (device and host barrier), one exact Set, paging with extents against
    whole stacks, and a budget below one shard's stacks on a fresh index.
    Returns (kernel rows, info)."""
    import torch

    from pilosa_tpu_torch import Executor, Holder
    from pilosa_tpu_torch.core import merge as merge_mod
    from pilosa_tpu_torch.hbm import residency as res
    from pilosa_tpu_torch.hbm.residency import ExtentTable
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops import merge as opm
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    S, W, SW = args.shards, WORDS_PER_ROW, SHARD_WIDTH
    idx = holder.index("smoke")
    f, g = idx.field("f"), idx.field("g")
    cache = holder.dcache
    dev = holder.device
    ext = res.extent_rows()
    check(ext == res.DEFAULT_EXTENT_ROWS, f"extent_rows is {ext}, not the default {res.DEFAULT_EXTENT_ROWS}")
    ext_bytes = min(ext, S) * W * 4
    bursts = state["bursts"]
    f_rows, g0, g1, exists = state["f_rows"], state["g0"], state["g1"], state["exists"]
    f0, f1 = f_rows[0], f_rows[1]
    probe_cols, probe_amt, probe_has = state["probe"]
    sum_g0 = list(state["sum_g0"])  # (value, count) of Sum(Row(g=0), field=amount)
    pc = np_popcount
    sample = sorted({0, S // 3, S - 1})

    def set_bits(words, cols):
        """OR columns into [S, W] words; the columns that were clear."""
        cols = sorted_unique(np.asarray(cols, np.uint64))
        flat = words.reshape(-1)
        wi = (cols >> np.uint64(5)).astype(np.int64)
        bit = np.uint32(1) << (cols & np.uint64(31)).astype(np.uint32)
        new = (flat[wi] & bit) == 0
        np.bitwise_or.at(flat, wi, bit)
        return cols[new]

    def answers():
        ic = [pc(w & g0) for w in f_rows]
        top = sorted(((r, c) for r, c in enumerate(ic) if c), key=lambda kv: (-kv[1], kv[0]))[:10]
        return {
            RES_QUERIES[0]: [ic[0]],
            RES_QUERIES[1]: [pc(f0 | f1 | g1)],
            RES_QUERIES[2]: [pc(exists & ~f1)],
            RES_QUERIES[3]: [top],
            RES_QUERIES[4]: [tuple(sum_g0)],
            RES_QUERIES[5]: pc(f0),
        }

    def norm(pql, got):
        if pql.startswith("TopN"):
            return [[(p.id, p.count) for p in got[0]]]
        if pql.startswith("Sum"):
            return [(got[0].value, got[0].count)]
        return got

    def run_q(want, label):
        """One pass of the query set, each answer held to numpy: per query
        the first-pass ms, the bytes re-staged through the extent layer,
        the bytes of other entries built (TopN tally bundles) and the peak
        device memory above what was allocated before it."""
        out = {}
        for pql in RES_QUERIES:
            r0, b0 = res.stats_snapshot()["restage_bytes"], cache.built_bytes
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = ex.execute("smoke", pql)
            n = got[0].count() if pql == "Row(f=0)" else None
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if n is not None:
                check(n == want[pql], f"{label}: Row(f=0).count() {n}, numpy says {want[pql]}")
                for s in sample:
                    seg = got[0].segment(s)
                    check(seg is not None and np.array_equal(seg.cpu().numpy().view(np.uint32), f0[s]),
                          f"{label}: Row(f=0) shard {s} differs from numpy")
            else:
                check(norm(pql, got) == want[pql], f"{label}: {pql}: got {norm(pql, got)}, numpy says {want[pql]}")
            restaged = res.stats_snapshot()["restage_bytes"] - r0
            out[pql] = {
                "ms": ms, "restage_bytes": restaged, "other_built_bytes": cache.built_bytes - b0 - restaged,
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
            }
            check(cache.pinned_bytes == 0, f"{label}: {cache.pinned_bytes} B still pinned after {pql}")
        return out

    def show(label, out):
        print(f"residency {label} ({smi}): " + "; ".join(
            f"{q} {v['ms']:.1f} ms, re-staged {v['restage_bytes']} B, other {v['other_built_bytes']} B"
            for q, v in out.items()))

    def burst(fc, gc):
        f.import_bits(np.zeros(len(fc), np.uint64), fc)
        idx.track_columns(fc)
        g.import_bits(np.zeros(len(gc), np.uint64), gc)
        idx.track_columns(gc)
        set_bits(f0, fc)
        set_bits(exists, np.concatenate([fc, gc]))
        new = set_bits(g0, gc)
        i = np.searchsorted(probe_cols, new)
        check(np.array_equal(probe_cols[i], new), "a new g row 0 column has no amount probe")
        sum_g0[0] += int(probe_amt[i].sum())
        sum_g0[1] += int(probe_has[i].sum())
        return answers()

    t_phase = time.perf_counter()
    K.reset_launches()
    opm.reset_stats()
    merge_mod.reset_stats()
    res.reset_stats()
    info = {"extent_rows": ext, "extent_bytes": ext_bytes}

    # (a) warm: the second pass re-stages nothing
    want = answers()
    info["warm"] = [run_q(want, "warm 1"), run_q(want, "warm 2")]
    warm2 = sum(v["restage_bytes"] for v in info["warm"][1].values())
    check(warm2 == 0, f"the second warm pass re-staged {warm2} B")
    show("(a) warm pass 2", info["warm"][1])

    # (b) a staged burst, merged by the device barrier and patched in place
    def staged(label, fc, gc, device: bool):
        t0 = time.perf_counter()
        want = burst(fc, gc)
        import_s = time.perf_counter() - t0
        r0, m0, ms0, k0 = res.stats_snapshot(), merge_mod.stats_snapshot(), dict(opm.MERGE_STATS), dict(K.LAUNCHES)
        out = run_q(want, label)
        r1, m1 = res.stats_snapshot(), merge_mod.stats_snapshot()
        merges = {
            "device_launches": opm.MERGE_STATS["device_launches"] - ms0["device_launches"],
            "host_merges": opm.MERGE_STATS["host_merges"] - ms0["host_merges"],
            "barriers": m1["barriers"] - m0["barriers"],
            "barrier_ms": m1["barrier_ms"] - m0["barrier_ms"],
            "merge_ms": m1["merge_ms"] - m0["merge_ms"],
            "merge_mark_launches": K.LAUNCHES["merge_mark"] - k0["merge_mark"],
            "or_bits_launches": K.LAUNCHES["or_bits"] - k0["or_bits"],
        }
        patches = {k: r1[k] - r0[k]
                   for k in ("extent_patches", "extent_patch_batches", "patch_upload_bytes", "patch_keys")}
        want_merges = (3, 0, 3) if device else (0, 3, 0)
        check((merges["device_launches"], merges["host_merges"], merges["merge_mark_launches"]) == want_merges,
              f"{label}: merges {merges}: want one {'device' if device else 'host'} merge per staged view (f, g, _exists)")
        check(merges["barriers"] == 3, f"{label}: {merges['barriers']} barriers merged, not 3 (f, g, _exists)")
        check(patches["extent_patches"] > 0, f"{label}: no extent was patched")
        check(patches["extent_patch_batches"] == merges["or_bits_launches"],
              f"{label}: {patches['extent_patch_batches']} patch launches booked, {merges['or_bits_launches']} "
              "or_bits launches counted")
        if device:
            # the keys stay on the card: only the chunk tables go up, far
            # less than 12 bytes of (offset, value) pair per key applied
            check(50 * patches["patch_upload_bytes"] <= 12 * patches["patch_keys"],
                  f"{label}: {patches['patch_upload_bytes']} B uploaded for {patches['patch_keys']} keys applied")
        first = out[RES_QUERIES[0]]["restage_bytes"]
        check(first == 0, f"{label}: the first Count after the burst re-staged {first} B, not 0")
        show(f"(b) {label}", out)
        print(
            f"residency (b) {label} ({smi}): staged {len(fc)} + {len(gc)} columns (and _exists) in {import_s:.2f} s; "
            f"barriers {merges['barriers']} in {merges['barrier_ms']:.1f} ms, {merges['merge_ms']:.1f} ms of it in the key "
            f"merges ({merges['device_launches']} device, "
            f"{merges['host_merges']} host merges); {patches['extent_patches']} entries patched with "
            f"{patches['extent_patch_batches']} or_bits launches applying {patches['patch_keys']} keys, "
            f"{patches['patch_upload_bytes']} B uploaded for the patches; "
            f"first pass Count {out[RES_QUERIES[0]]['ms']:.1f} ms, filtered TopN {out[RES_QUERIES[3]]['ms']:.1f} ms; "
            f"peak device memory over the first query {out[RES_QUERIES[0]]['peak_bytes']} B"
        )
        return {"import_s": import_s, "queries": out, "merges": merges, "patches": patches}

    info["burst_device"] = staged("burst 1, device barrier", bursts["f1"], bursts["g1"], True)
    saved = merge_mod._device_threshold
    merge_mod.configure(device_threshold=-1)
    try:
        info["burst_host"] = staged("burst 2, host barrier", bursts["f2"], bursts["g2"], False)
    finally:
        merge_mod.configure(device_threshold=saved)
    print(
        f"residency (b) barrier ({smi}): device {info['burst_device']['merges']['barrier_ms']:.1f} ms, "
        f"host {info['burst_host']['merges']['barrier_ms']:.1f} ms, for the same burst size"
    )

    # (c) one exact Set into f row 0 re-stages exactly one extent of it
    s_c = S // 2
    clear = np.flatnonzero(~_bits(f0[s_c]))
    col = s_c * SW + int(clear[len(clear) // 2])
    check(ex.execute("smoke", f"Set({col}, f=0)") == [True], f"Set({col}, f=0) changed nothing")
    set_bits(f0, [col])
    set_bits(exists, [col])
    out = run_q(answers(), "after one Set")
    restaged = out[RES_QUERIES[0]]["restage_bytes"]
    check(restaged == ext_bytes, f"after one Set the Count re-staged {restaged} B, not one extent ({ext_bytes} B)")
    info["set"] = out
    print(f"residency (c) ({smi}): after Set({col}, f=0) the first Count re-staged {restaged} B (one extent)")

    # the barrier's kernels, the device merge and the assembly, at this
    # path's shapes, each rotating over 8 data sets larger than the L2
    # together, so no timed call finds its data left there by the last
    launches = {k: K.LAUNCHES[k] for k in ("or_bits", "merge_mark")}
    for k, n in launches.items():
        check(n > 0, f"the residency path never launched {k}: {dict(K.LAUNCHES)}")
    src = "pilosa_tpu_torch/ops/cuda/merge_kernels.cu"
    shards = tuple(range(S))
    tables = (ExtentTable(cache), ExtentTable(cache))
    f.view().row_stack(0, shards, extents=tables[0])
    g.view().row_stack(0, shards, extents=tables[1])
    parts = [cache.get(k) for t in tables for k in sorted(t.keys, key=lambda k: k[6] if k[4] == "ext" else 0)]
    n_ext = len(parts) // 2
    rows = {}
    # or_bits: each extent of Row(f=0) and of Row(g=0) taking burst 1's
    # keys in its shards as the patch pass gives them (a segment per
    # shard, key p * SW + column for shard position p of the extent), the
    # chunk table on the card first (the kernel alone), then as a patch
    # launches it (table copied from the pinned slot with the launch)
    def or_bits_set(target, keys):
        """One timed or_bits call's data: keys p * SW + column for shard
        position p of `target`, its segment table and chunk table, and
        its bytes (keys, chunk table, each distinct 32-byte sector read
        and written; and with 64-byte blocks instead of sectors)."""
        n_pos = target.shape[0]
        table = np.stack([np.searchsorted(keys, np.arange(n_pos) * SW),
                          np.searchsorted(keys, np.arange(1, n_pos + 1) * SW),
                          np.arange(n_pos) * W], axis=1).astype(np.int64)
        chunks = np.concatenate(opm._or_bits_chunks(table))
        word = keys // SW * W + ((keys & (SW - 1)) >> 5)  # flat word of each key in the entry
        head = 8 * len(keys) + 8 * len(chunks)
        return {
            "target": target, "keys": torch.from_numpy(keys).to(dev), "table": table,
            "chunks": torch.from_numpy(chunks).to(dev), "n_chunks": len(chunks) // 3,
            "bytes": head + 64 * len(sorted_unique(word >> 3)), "block_bytes": head + 128 * len(sorted_unique(word >> 4)),
        }

    sets = []
    for e, part in enumerate(parts):
        cols = bursts["f1"] if e < n_ext else bursts["g1"]
        lo = (e % n_ext) * min(ext, S) * SW
        keys = sorted_unique(cols[(cols >= np.uint64(lo)) & (cols < np.uint64(lo + part.shape[0] * SW))]).astype(
            np.int64) - lo
        sets.append(dict(or_bits_set(part.clone(), keys), orig=part, plain=part.clone()))

    def kernel_alone(t):
        rc = K.library().pt_or_bits(None, 0, t["chunks"].data_ptr(), t["target"].data_ptr(), t["keys"].data_ptr(),
                                    t["n_chunks"], SW - 1, K._stream(t["target"]))
        check(rc == 0, f"or_bits launch failed: CUDA error {rc}")
        return t["target"]

    def as_patched(t):
        opm.or_bits(t["target"], t["keys"], t["table"])
        return t["target"]

    rows["or_bits"] = time_row(
        "or_bits", src, "pilosa_tpu/core/view.py:544",
        [lambda t=t: kernel_alone(t) for t in sets],
        [lambda t=t: opm.or_bits_plain(t["plain"], t["keys"], t["table"]) for t in sets],
        [t["bytes"] for t in sets], launches["or_bits"], errs,
        "bytes (keys, chunk table, 32-byte sectors read and written)",
    )
    row = rows["or_bits"]
    row["keys_per_call"] = sum(t["keys"].numel() for t in sets) / len(sets)
    row["chunks_per_call"] = sum(t["n_chunks"] for t in sets) / len(sets)
    # as a patch launches it: the wrapper's table check, chunk cut and
    # pinned-slot copy with the launch; the device time with the copy,
    # and the host time of one call (the host's cost of one patch)
    for t in sets:
        fresh = t["orig"].clone()
        opm.or_bits(fresh, t["keys"], t["table"])
        check(torch.equal(fresh, t["plain"]), "or_bits through its wrapper differs from its twin")
    del fresh
    row["with_table_copy_ms"] = cuda_time_ms(rotating([lambda t=t: as_patched(t) for t in sets]))
    row["wrapper_dispatch_ms"] = dispatch_ms(lambda: as_patched(sets[0]))
    row["l2_warm_ms"] = cuda_time_ms(lambda: kernel_alone(sets[0]))
    row["bound_64b_ms"] = sum(t["block_bytes"] for t in sets) / len(sets) / HBM_BYTES_PER_S * 1e3
    row["share_of_64b_bound"] = row["bound_64b_ms"] / row["ms"]
    # what a cold patch pays for: the same number of keys spread one per
    # 64-byte block, two per block (one in each 32-byte sector) and two per
    # 32-byte sector, each timed cold over the 8 extents
    brng = np.random.default_rng([args.seed, 9])
    targets = [t["target"] for t in sets]
    n_blocks = targets[0].numel() // 16
    n_spread = min(1 << 18, n_blocks // 2)
    spread = {}
    for label in ("one key a 64-byte block", "two keys a block, one a sector", "two keys a 32-byte sector"):
        half = n_spread // 2
        if label.startswith("one"):
            words = brng.choice(n_blocks, n_spread, replace=False) * 16 + brng.integers(0, 16, n_spread)
        elif label.startswith("two keys a block"):
            words = np.repeat(brng.choice(n_blocks, half, replace=False) * 16, 2) + np.tile([0, 8], half) \
                + brng.integers(0, 8, 2 * half)
        else:
            words = np.repeat(brng.choice(n_blocks, half, replace=False) * 16 + brng.integers(0, 2, half) * 8, 2) \
                + np.tile([1, 6], half)
        keys = sorted_unique(words // W * SW + words % W * 32 + brng.integers(0, 32, len(words)))
        data = [or_bits_set(tg, keys) for tg in targets]
        spread[label] = {
            "keys": len(keys), "ms": cuda_time_ms(rotating([lambda t=t: kernel_alone(t) for t in data])),
            "bound_ms": data[0]["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_64b_ms": data[0]["block_bytes"] / HBM_BYTES_PER_S * 1e3,
        }
    row["spread"] = spread
    print(
        f"kernel or_bits ({smi}): {row['keys_per_call']:.0f} keys and {row['chunks_per_call']:.0f} chunks a call; "
        f"L2-warm {row['l2_warm_ms']:.4f} ms; with its table copy {row['with_table_copy_ms']:.4f} ms; wrapper "
        f"{row['wrapper_dispatch_ms']:.4f} ms host; bound counting 64-byte blocks (128 B each) {row['bound_64b_ms']:.4f} "
        f"ms ({row['share_of_64b_bound']:.1%}); cold, the same keys spread: "
        + "; ".join(f"{k} ({v['keys']} keys) {v['ms']:.4f} ms, sector bound {v['bound_ms']:.4f}, block bound "
                    f"{v['bound_64b_ms']:.4f}" for k, v in spread.items())
    )
    del data
    # merge_mark on 2^21 sorted keys: the path's four bursts and four
    # more drawn alike
    krng = np.random.default_rng([args.seed, 6])
    key_sets = [bursts[k] for k in ("f1", "g1", "f2", "g2")]
    key_sets += [krng.integers(0, S * SW, BURST).astype(np.uint64) for _ in range(4)]
    keys_dev = [torch.from_numpy(k.view(np.int64)).to(dev) for k in key_sets]
    sorted_dev = [torch.sort(k).values for k in keys_dev]
    rows["merge_mark"] = time_row(
        "merge_mark", src, "pilosa_tpu/ops/merge.py:76",
        [lambda k=k: opm.merge_mark(k) for k in sorted_dev], [lambda k=k: opm.merge_mark_plain(k) for k in sorted_dev],
        [13 * k.numel() for k in sorted_dev], launches["merge_mark"], errs,
    )
    n_keys = keys_dev[0].numel()
    n_unique = len(sorted_unique(key_sets[0]))
    merge_bytes = 8 * n_keys + 16 * n_unique
    assembled = torch.cat(parts[:n_ext], 0)
    extra = {
        "merge_device_ms": cuda_time_ms(rotating([lambda k=k: opm.merge_keys_on(k) for k in keys_dev])),
        "merge_device_dispatch_ms": dispatch_ms(lambda: opm.merge_keys_on(keys_dev[0])),
        "merge_device_bound_ms": merge_bytes / HBM_BYTES_PER_S * 1e3,
        "merge_sort_ms": cuda_time_ms(rotating([lambda k=k: torch.sort(k) for k in keys_dev])),
        "merge_keys": n_keys,
        "merge_unique_keys": n_unique,
        "assembly_ms": cuda_time_ms(lambda: torch.cat(parts[:n_ext], 0)),
        "assembly_dispatch_ms": dispatch_ms(lambda: torch.cat(parts[:n_ext], 0)),
        "assembly_bound_ms": 2 * assembled.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "assembly_extents": n_ext,
        "assemblies": res.stats_snapshot()["assemblies"],
    }
    for t in tables:
        t.release()
    del sets, assembled, parts, keys_dev, sorted_dev
    extra["merge_device_share"] = extra["merge_device_bound_ms"] / extra["merge_device_ms"]
    extra["assembly_share"] = extra["assembly_bound_ms"] / extra["assembly_ms"]
    # the barrier's two routes by burst size, host clock, each whole:
    # merge_keys_host (a sort and a mask) against merge_keys_device
    # (upload, sort, merge_mark, scan, compaction, read back), around the
    # AUTO crossover (merge.ACCEL_DEVICE_THRESHOLD keys); np.unique alone
    # at 2^21 keys, since numpy 2.3 finds unique integers by hashing
    sweep = []
    for n in (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, BURST):
        k = key_sets[4][:n]
        reps = 9 if n <= 1 << 18 else 5
        sweep.append({
            "keys": n, "host_ms": host_p50_ms(lambda: opm.merge_keys_host(k), reps=reps),
            "device_ms": host_p50_ms(lambda: opm.merge_keys_device(k, dev), reps=reps),
        })
    extra["route_sweep"] = sweep
    extra["numpy"] = np.__version__
    extra["np_unique_ms"] = host_p50_ms(lambda: np.unique(key_sets[4]), reps=1)  # 1.7 s a call (3 runs until PR 11)
    extra["merge_host_ms"] = sweep[-1]["host_ms"]
    cross = [p["keys"] for p in sweep if p["device_ms"] < p["host_ms"]]
    extra["device_wins_from"] = cross[0] if cross else None
    info["timing"] = extra
    print(
        f"residency timing ({smi}): device merge of {n_keys} keys ({n_unique} unique) {extra['merge_device_ms']:.4f} ms "
        f"(sort alone {extra['merge_sort_ms']:.4f} ms, dispatch {extra['merge_device_dispatch_ms']:.4f} ms; bound "
        f"{extra['merge_device_bound_ms']:.4f} ms, {extra['merge_device_share']:.1%}, "
        f"{info['burst_device']['merges']['device_launches']} launches on the burst); assembly of {n_ext} "
        f"extents into a {S}-shard operand {extra['assembly_ms']:.4f} ms (dispatch {extra['assembly_dispatch_ms']:.4f} "
        f"ms, bound {extra['assembly_bound_ms']:.4f} ms, {extra['assembly_share']:.1%}, plain PyTorch; "
        f"{extra['assemblies']} assemblies on the path); or_bits as a patch launches it (table check, chunk cut, "
        f"pinned-slot copy, launch) {rows['or_bits']['with_table_copy_ms']:.4f} ms device, "
        f"{rows['or_bits']['wrapper_dispatch_ms']:.4f} ms host per entry"
    )
    print(
        f"residency routes ({smi}; host clock, p50 of a whole merge): numpy {np.__version__}, "
        f"AUTO threshold {merge_mod.ACCEL_DEVICE_THRESHOLD} keys; "
        + "; ".join(f"{p['keys']} keys host {p['host_ms']:.3f} ms, device {p['device_ms']:.3f} ms" for p in sweep)
        + f"; the device route is faster from {extra['device_wins_from']} keys; np.unique alone at {BURST} keys "
        f"{extra['np_unique_ms']:.1f} ms"
    )

    # (d) paging: a budget one extent short of the query set's working set
    want = answers()

    def paging(rows_per_extent):
        res.configure(extent_rows=rows_per_extent)
        cache.clear()
        run_q(want, f"paging warm (extent_rows {rows_per_extent})")
        ws = cache.bytes_used
        budget0 = cache.budget_bytes
        cache.budget_bytes = ws - ext_bytes
        cycles = []
        try:
            for c in range(RES_CYCLES):
                out = run_q(want, f"paging cycle {c} (extent_rows {rows_per_extent})")
                cycles.append(sum(v["restage_bytes"] for v in out.values()))
        finally:
            cache.budget_bytes = budget0
        return {"working_set_bytes": ws, "restage_bytes_per_cycle": cycles}

    try:
        info["paging_extents"] = paging(ext)
        info["paging_whole"] = paging(0)
    finally:
        res.configure(extent_rows=ext)
    pe, pw = info["paging_extents"]["restage_bytes_per_cycle"], info["paging_whole"]["restage_bytes_per_cycle"]
    for c in range(1, RES_CYCLES):
        check(pe[c] < pw[c], f"paging cycle {c}: extents re-staged {pe[c]} B, whole stacks {pw[c]} B")
    print(
        f"residency (d) paging ({smi}): working set {info['paging_extents']['working_set_bytes']} B with extents, "
        f"{info['paging_whole']['working_set_bytes']} B whole; budget one extent ({ext_bytes} B) short; re-staged "
        f"per cycle: extents {pe}, whole stacks {pw}"
    )

    # (e) a budget under 4 x one shard's stack on a fresh 8-shard index:
    # each shard is lowered alone, over the budget, and nothing raises
    h2 = Holder()
    try:
        i2 = h2.create_index("tiny", track_existence=True)
        a, b = i2.create_field("a"), i2.create_field("b")
        trng = np.random.default_rng([args.seed, 5])
        aw = [trng.integers(0, 2**32, size=(8, W), dtype=np.uint32) for _ in range(3)]
        bw = trng.integers(0, 2**32, size=(8, W), dtype=np.uint32)
        for s_ in range(8):
            for r in range(3):
                a.import_row_words(r, s_, aw[r][s_])
            b.import_row_words(0, s_, bw[s_])
            i2.existence_field().import_row_words(0, s_, aw[0][s_] | aw[1][s_] | aw[2][s_] | bw[s_])
        h2.dcache.budget_bytes = 2 * W * 4
        ex2 = Executor(h2)
        got = ex2.execute("tiny", "Count(Intersect(Row(a=0), Row(b=0)))")
        check(got == [pc(aw[0] & bw)], f"(e) two-leaf Count {got}, numpy says {pc(aw[0] & bw)}")
        top = sorted(((r, pc(aw[r] & bw)) for r in range(3)), key=lambda kv: (-kv[1], kv[0]))
        got = [(p.id, p.count) for p in ex2.execute("tiny", "TopN(a, Row(b=0), n=3)")[0]]
        check(got == top, f"(e) filtered TopN {got}, numpy says {top}")
        check(h2.dcache.pinned_bytes == 0, "(e) pins left behind")
    finally:
        h2.close()
    print(f"residency (e): an 8-shard index under a {2 * W * 4}-B budget answers a two-leaf Count and a filtered TopN")

    info["phase_s"] = time.perf_counter() - t_phase
    info["launches"] = dict(K.LAUNCHES)
    return rows, info


# ---------------------------------------------------------------------------
# phase 4c: time and bool fields on the main path's holder
# ---------------------------------------------------------------------------

# Pilosa's documented time quantum "YMDH" (one view per year, month, day
# and hour): 2 rows of field t, 32 random columns per shard, hour and row
# over 8 days; the 47-view range of the queries below
TIME_QUANTUM = "YMDH"
TIME_START = np.datetime64("2024-01-01T00", "h")
TIME_HOURS = 192  # 240 until PR 11: cut for the script's time (the range's 47 views unchanged)
TIME_PER_HOUR = 32
TIME_RANGE = "from='2024-01-02T03:00', to='2024-01-08T21:00'"
TIME_RANGE_HOURS = (27, 189)  # the range's hours since TIME_START
TIME_OPEN = "from='2024-01-05T00:00'"  # to the field's last hour
TIME_OPEN_HOURS = (96, TIME_HOURS)
TIME_BURST = 1 << 20  # columns of one timestamped burst into t row 0, all in hour 2024-01-08T20
TIME_BURST_HOUR = 188
TIME_REPS = 4  # runs per p50 (REPS elsewhere): Rows and GroupBy read 47 views x 128 fragments on the host
TIME_SHARDS = 128  # the index's shards the time field's events fall in (cut from every shard for the script's time)


def _shift_np(words: np.ndarray, n: int) -> np.ndarray:
    """[S + 1, W] words of an [S, W] row shifted up n columns across shards
    (the last shard's top bits carry into shard S), n < 32 * W."""
    s, w = words.shape
    flat = np.concatenate([words.reshape(-1), np.zeros(w, np.uint32)])
    q, r = divmod(n, 32)
    lo = np.concatenate([np.zeros(q, np.uint32), flat[: len(flat) - q]])
    if r:
        prev = np.concatenate([[np.uint32(0)], lo[:-1]])
        lo = (lo << np.uint32(r)) | (prev >> np.uint32(32 - r))
    return lo.reshape(s + 1, w)


def time_path(args, holder, ex, state, errs, smi):
    """Phase 4c on the main path's holder (2^30 columns): a YMDH time field
    t and a bool field b, loaded through Field.import_bits with a datetime64
    timestamp array (b through import_bits too); the time queries held to a
    numpy model of the raw (row, column, hour) events; a timestamped burst
    into a resident hour view; p50s, the 47-leaf Row's and the Shift Row's
    device times and bounds. Launch counts are reset before and read after.
    Returns (the kernels row of plan_rows at the 47-leaf range, info)."""
    import torch

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.exec import plan as planmod
    from pilosa_tpu_torch.hbm import residency as res
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.server import wire
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    S, W, SW = args.shards, WORDS_PER_ROW, SHARD_WIDTH
    TS = min(S, TIME_SHARDS)  # the time field's shards; the index's others hold none of its bits
    t_phase = time.perf_counter()
    idx = holder.index("smoke")
    f_rows, g_rows = state["f_rows"], state["g_rows"]
    pc = np_popcount
    sample = sorted({0, 1, TS // 2, TS - 1, S - 1})
    rng = np.random.default_rng([args.seed, 10])
    base = (np.arange(TS, dtype=np.uint64) * np.uint64(SW))[None, :, None]
    events = [
        (rng.integers(0, SW, size=(TIME_HOURS, TS, TIME_PER_HOUR), dtype=np.uint64) + base).reshape(-1)
        for _ in range(2)
    ]
    hour_of = np.repeat(np.arange(TIME_HOURS), TS * TIME_PER_HOUR)
    # b: every column a row-0 event touched, true or false with equal odds
    b_cols = sorted_unique(events[0])
    b_val = rng.integers(0, 2, len(b_cols)).astype(np.uint64)
    burst = rng.integers(0, TS * SW, TIME_BURST).astype(np.uint64)

    def pack(cols):
        words = np.zeros(S * W, np.uint32)
        np.bitwise_or.at(words, (cols >> np.uint64(5)).astype(np.int64), np.uint32(1) << (cols & np.uint64(31)).astype(np.uint32))
        return words.reshape(S, W)

    def hours_words(r, lo, hi):
        return pack(events[r][(hour_of >= lo) & (hour_of < hi)])

    t_std = [pack(e) for e in events]
    b_true, b_false = pack(b_cols[b_val == 1]), pack(b_cols[b_val == 0])
    t_range = [hours_words(r, *TIME_RANGE_HOURS) for r in range(2)]
    t0_open = hours_words(0, *TIME_OPEN_HOURS)

    torch.cuda.synchronize()
    K.reset_launches()
    snap0 = res.stats_snapshot(holder.dcache)
    t0 = time.perf_counter()
    t = idx.create_field("t", FieldOptions(type="time", time_quantum=TIME_QUANTUM))
    b = idx.create_field("b", FieldOptions(type="bool"))
    stamps = TIME_START + hour_of.astype("timedelta64[h]")
    for r in range(2):
        t.import_bits(np.full(len(events[r]), r, np.uint64), events[r], timestamps=stamps)
        idx.track_columns(events[r])
    b.import_bits(b_val, b_cols)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    n_views = len(t.views)
    print(
        f"time: field t ({TIME_QUANTUM}) {n_views} views over {TS} of the index's {S} shards, {len(events[0])} bits a "
        f"row over {TIME_HOURS} hours (each in Y, M, D, H and standard), bool field b over the {len(b_cols)} columns "
        f"row 0 touches; ingest {ingest_s:.1f} s"
    )

    def run(pql):
        return ex.execute("smoke", pql)

    def check_row(pql, words, got=None):
        """A Row answer against [S', W] numpy words: its shards, count and
        sample shards' words."""
        got = run(pql)[0] if got is None else got
        nz = [s for s in range(words.shape[0]) if words[s].any()]
        check(sorted(got.segments) == nz, f"{pql}: {len(got.segments)} shards, numpy has {len(nz)}")
        check(got.count() == pc(words), f"{pql}: count {got.count()}, numpy {pc(words)}")
        for s in sample:
            seg = got.segment(s)
            have = np.zeros(W, np.uint32) if seg is None else seg.cpu().numpy().view(np.uint32)
            check(np.array_equal(have, words[s]), f"{pql}: shard {s} differs from numpy")

    def launched(fn):
        before = dict(K.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}

    rng_row = f"Row(t=0, {TIME_RANGE})"
    f_ic = [pc(fr & t_range[1]) for fr in f_rows]
    top = sorted(((r, c) for r, c in enumerate(f_ic) if c), key=lambda kv: (-kv[1], kv[0]))[:5]
    f0_ic = [pc(fr & t_range[0]) for fr in f_rows]
    min_f = next(r for r, c in enumerate(f0_ic) if c)
    max_f = max(r for r, c in enumerate(f0_ic) if c)
    shift1 = _shift_np(t_range[1], 1)
    shift33 = _shift_np(t_range[1], 33)
    reads = [
        (f"Count({rng_row})", [pc(t_range[0])]),
        (rng_row, t_range[0]),
        (f"Count(Intersect({rng_row}, Row(f=0)))", [pc(t_range[0] & f_rows[0])]),
        (f"Row(t=0, {TIME_OPEN})", t0_open),
        (f"Count(Shift(Row(t=1, {TIME_RANGE}), n=1))", [pc(shift1)]),
        (f"Shift(Row(t=1, {TIME_RANGE}), n=33)", shift33),
        (f"TopN(f, Row(t=1, {TIME_RANGE}), n=5)", [[{"id": r, "count": c} for r, c in top]]),
        (f"Rows(t, {TIME_RANGE})", [[0, 1]]),
        (f"GroupBy(Rows(t, {TIME_RANGE}), Rows(g))", [group_json(("t", "g"), np_groups(t_std, g_rows))]),
        ("MinRow(field=f) MaxRow(field=f)", [{"id": 0, "count": 1}, {"id": len(f_rows) - 1, "count": 1}]),
        (f"MinRow({rng_row}, field=f) MaxRow({rng_row}, field=f)",
         [{"id": min_f, "count": f0_ic[min_f]}, {"id": max_f, "count": f0_ic[max_f]}]),
        ("Count(Row(b=true)) Count(Row(b=false))", [pc(b_true), pc(b_false)]),
    ]
    t0 = time.perf_counter()
    query_launches, query_restage = {}, {}
    for pql, want in reads:
        before = res.stats_snapshot(holder.dcache)["restage_bytes"]
        got, query_launches[pql] = launched(lambda: run(pql))
        query_restage[pql] = res.stats_snapshot(holder.dcache)["restage_bytes"] - before
        if isinstance(want, np.ndarray):
            check_row(pql, want, got[0])
            check(query_launches[pql].get("plan_rows", 0) >= 1, f"{pql} made no plan_rows launch: {query_launches[pql]}")
        else:
            got = [wire.result_to_public_json(x) for x in got]
            check(got == want, f"{pql}: got {str(got)[:300]}, numpy says {str(want)[:300]}")
    check(query_launches[reads[4][0]].get("plan_rows", 0) == 2 and query_launches[reads[4][0]].get("plan_count", 0) == 0,
          f"Count(Shift(<47-leaf range>)) launches {query_launches[reads[4][0]]}, not 2 plan_rows and no plan_count")
    first_pass_s = time.perf_counter() - t0
    print(f"time: {len(reads)} read queries equal numpy (first pass {first_pass_s:.2f} s, staging included)")
    for pql, _ in reads:
        print(f"time: first pass re-staged {query_restage[pql]} B, launches {query_launches[pql]}  {pql}")

    # a timestamped burst into t row 0, all in the hour 2024-01-08T20 whose
    # view (one of the 47) is resident: merged at apply time by the view's
    # barrier and patched in place, so nothing is re-staged
    snap1 = res.stats_snapshot(holder.dcache)
    tb = time.perf_counter()
    _, burst_launches = launched(lambda: t.import_bits(
        np.zeros(TIME_BURST, np.uint64), burst,
        timestamps=np.full(TIME_BURST, TIME_START + np.timedelta64(TIME_BURST_HOUR, "h")),
    ))
    burst_s = time.perf_counter() - tb
    bw = pack(burst)
    t_range[0] |= bw
    t_std[0] |= bw
    snap2 = res.stats_snapshot(holder.dcache)
    got = run(f"Count({rng_row})")
    check(got == [pc(t_range[0])], f"Count of the range after the burst: {got}, numpy {pc(t_range[0])}")
    snap3 = res.stats_snapshot(holder.dcache)
    burst_info = {
        "columns": TIME_BURST,
        "s": burst_s,
        "launches": burst_launches,
        "restage_bytes_burst": snap2["restage_bytes"] - snap1["restage_bytes"],
        "restage_bytes_query": snap3["restage_bytes"] - snap2["restage_bytes"],
        "extent_patches": snap2["extent_patches"] - snap1["extent_patches"],
    }
    check(burst_info["restage_bytes_burst"] == 0 and burst_info["restage_bytes_query"] == 0,
          f"the burst into resident time views re-staged bytes: {burst_info}")
    check(burst_info["extent_patches"] > 0 and burst_launches.get("or_bits", 0) > 0,
          f"the burst patched no resident extent: {burst_info}")
    print(
        f"time: burst of {TIME_BURST} columns into hour view standard_2024010820 in {burst_s:.2f} s; "
        f"{burst_info['extent_patches']} extents patched in place; re-staged {burst_info['restage_bytes_burst']} B "
        f"by the burst, {burst_info['restage_bytes_query']} B by the next Count of the range; launches {burst_launches}"
    )

    # warm p50s of the reads
    lat = {}
    for pql, _ in reads:
        before = res.stats_snapshot(holder.dcache)["restage_bytes"]
        lat[pql] = host_p50_ms(lambda pql=pql: run(pql), reps=TIME_REPS)
        again = res.stats_snapshot(holder.dcache)["restage_bytes"] - before
        print(f"time p50 {lat[pql]:.3f} ms, re-staged {again} B over the {TIME_REPS} runs  {pql}")

    # device time of the 47-leaf Row (one plan_rows launch) and the Shift
    # Row (the union materialized, then shifted: two launches) against
    # their bound: every distinct leaf read once, the result written once.
    # The launches of this timing are taken off the phase's counts below:
    # they are not the main path's.
    timing_from = dict(K.LAUNCHES)
    kernel_rows = {}
    for name, pql in (("plan_rows", rng_row), ("plan_rows_shift_row", f"Shift(Row(t=1, {TIME_RANGE}), n=33)")):
        c = parse(pql).calls[0]
        (sp,) = ex._lower_plans(idx, c, ex._shards_for(idx, None, c))
        sp.release_extents()  # the timing below holds the operand tensors
        leaves, shifts, prog = planmod._compile(sp.root, sp.operands, {}, rows_mode=True)
        n_leaves = len(sp.operands)
        rows_s = sp.operands[0].shape[0]
        def fn(sp=sp):
            return planmod._rows(sp.root, sp.operands, {})

        def plain(leaves=leaves, shifts=shifts, prog=prog):
            # the twin of the root's launch on the card's tensors (a Shift
            # over the union: the union's result, then the shifted leaf)
            return K.plan_rows_plain(leaves, shifts, prog)

        got, want = fn(), plain()
        diff = int((got[0] != want[0]).sum().item()) + int((got[1] != want[1]).sum().item())
        errs["plan_rows"] = max(errs.get("plan_rows", 0), diff)
        check(diff == 0, f"{pql}: plan_rows differs from its twin in {diff} words")
        ms = cuda_time_ms(fn)
        disp = dispatch_ms(fn)
        plain_ms = cuda_time_ms(plain)
        nbytes = (n_leaves + 1) * rows_s * W * 4 + rows_s * 8
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernel_rows[name] = {
            "name": "plan_rows",
            "route": "cuda",
            "source": "pilosa_tpu_torch/ops/cuda/bitmap_kernels.cu",
            "replaces": "pilosa_tpu/exec/plan.py:340",
            "launches": 0,
            "max_abs_err": errs.get("plan_rows", 0),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": None,
            "dispatch_ms": disp,
            "share_of_bound": bound / ms,
            "bytes": nbytes,
            "leaves": n_leaves,
            "query": pql,
        }
        print(
            f"time: {pql}: {n_leaves} leaves x {rows_s} shards, device {ms:.4f} ms ({smi}), dispatch {disp:.4f} ms, "
            f"twin {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of it)"
        )
        del sp, leaves, got, want
    torch.cuda.synchronize()
    timing_launches = {k: K.LAUNCHES[k] - timing_from[k] for k in K.LAUNCHES if K.LAUNCHES[k] != timing_from[k]}
    print(f"time: launches of the device timing above (not counted as the main path's): {timing_launches}")

    # writes: Store the range into f row 100, ClearRow t row 1 (every view),
    # flip one bool column
    col = int(np.flatnonzero(_bits(b_true[TS // 2]))[0]) + (TS // 2) * SW
    writes = [
        (f"Store({rng_row}, f=100)", [True]),
        ("Count(Row(f=100))", [pc(t_range[0])]),
        ("ClearRow(t=1)", [True]),
        (f"Count(Row(t=1, {TIME_RANGE})) Count(Row(t=1))", [0, 0]),
        (f"Set({col}, b=false)", [True]),
        ("Count(Row(b=true)) Count(Row(b=false))", [pc(b_true) - 1, pc(b_false) + 1]),
    ]
    t0 = time.perf_counter()
    write_launches = {}
    for pql, want in writes:
        got, write_launches[pql] = launched(lambda: [wire.result_to_public_json(x) for x in run(pql)])
        check(got == want, f"{pql}: got {got}, numpy says {want}")
    writes_s = time.perf_counter() - t0
    check(write_launches[writes[0][0]].get("plan_rows", 0) >= 1, f"Store made no plan_rows launch: {write_launches}")
    print(f"time: Store, ClearRow and a bool flip equal numpy in {writes_s:.2f} s; launches {write_launches}")

    torch.cuda.synchronize()
    launches = {k: n - timing_launches.get(k, 0) for k, n in K.LAUNCHES.items()}
    for name in ("plan_rows", "plan_count", "rows_counts", "gather_tally", "count2", "or_bits"):
        check(launches[name] > 0, f"the time phase never launched {name}: {launches}")
    resident = holder.dcache.bytes_used
    snap = res.stats_snapshot(holder.dcache)
    print(f"time: launches {launches}")
    print(
        f"time summary ({smi}): ingest {ingest_s:.1f} s, first pass {first_pass_s:.2f} s, p50 "
        f"{lat[reads[0][0]]:.3f} ms Count(<47-leaf range>), {lat[rng_row]:.3f} ms Row(<47-leaf range>); "
        f"47-leaf Row device {kernel_rows['plan_rows']['ms']:.4f} ms (bound {kernel_rows['plan_rows']['bound_ms']:.4f}), "
        f"Shift Row {kernel_rows['plan_rows_shift_row']['ms']:.4f} ms (bound "
        f"{kernel_rows['plan_rows_shift_row']['bound_ms']:.4f}); burst re-staged {burst_info['restage_bytes_burst']} B; "
        f"device cache resident {resident} B; restage total {snap['restage_bytes'] - snap0['restage_bytes']} B"
    )
    info = {
        "views": n_views,
        "shards": TS,
        "bits_per_row": len(events[0]),
        "ingest_s": ingest_s,
        "first_pass_s": first_pass_s,
        "query_p50_ms": lat,
        "query_launches": query_launches,
        "first_pass_restage_bytes": query_restage,
        "burst": burst_info,
        "writes_s": writes_s,
        "write_launches": write_launches,
        "launches": launches,
        "timing_launches": timing_launches,
        "device_cache_bytes": resident,
        "shift_row": kernel_rows["plan_rows_shift_row"],
        "phase_s": time.perf_counter() - t_phase,
    }
    return kernel_rows["plan_rows"], info


# ---------------------------------------------------------------------------
# phase 5: the port served over HTTP
# ---------------------------------------------------------------------------

# f's dense rows: bit densities 2^-1 and 2^-3 (the AND of 1 and 3 draws)
SERVE_DENSE_DRAWS = (1, 3)
N_SERVE_SPARSE_F, N_SERVE_G = 4, 2  # sparse rows of f and g, ~1000 bits per shard each
N_SERVE_VALUES = 4  # shards of `amount` loaded through import-value (cut from 8 for the script's time)
IMPORT_BATCH = 5000  # writes per /import request: the default max-writes-per-request
# the serve phase's depth, cut to keep the script inside its time: index s
# over 256 shards (2^28 columns), 2 rounds of the query set per client
SERVE_SHARDS = 256  # 512 before: cut for the script's time on slow hosts
CONCURRENT_ROUNDS = 2
SERVE_QUERIES = [
    "Count(Intersect(Row(f=0), Row(g=0)))",
    "Count(Union(Row(f=0), Row(f=1), Row(g=1)))",
    "Count(Not(Row(f=1)))",
    "Row(g=0)",
    "TopN(f, n=5)",
    "TopN(f, Row(g=0), n=5)",
    "Sum(field=amount)",
    "Min(field=amount)",
    "Max(field=amount)",
    "Sum(Row(g=0), field=amount)",
    "Count(Row(amount > 500000))",
]
# amount's 20 planes stream at the served default slab of 16: Min/Max on
# bsi_min_max_step, the condition Count on bsi_range_step
SERVE_KERNELS = ("plan_count", "rows_counts", "gather_tally", "bsi_sum", "bsi_min_max_step", "bsi_range_step")
# Rows and GroupBy on index s (held to numpy and Executor.execute, and after
# the restart to the bodies served before it); the GroupBy launches
# counts_cross, and count2 too where it descends (6 rows of f over gmax =
# 2 prefixes at 1024 shards)
SERVE_GROUP_QUERIES = ["GroupBy(Rows(f), Rows(g))", "Rows(f)"]


class _Http:
    """One kept-alive HTTP/1.1 connection (http.client) to a node."""

    def __init__(self, uri: str):
        import http.client

        host, port = uri.removeprefix("http://").rsplit(":", 1)
        self.conn = http.client.HTTPConnection(host, int(port), timeout=600)

    def raw(self, method: str, path: str, body=None, ctype: str = "application/json"):
        """(status, raw body); a body that is not bytes goes as JSON."""
        if body is not None and not isinstance(body, bytes):
            body = json.dumps(body).encode()
        self.conn.request(method, path, body=body, headers={"Content-Type": ctype} if body is not None else {})
        r = self.conn.getresponse()
        return r.status, r.read()

    def json(self, method: str, path: str, body=None, ctype: str = "application/json"):
        status, raw = self.raw(method, path, body, ctype)
        check(status == 200, f"{method} {path}: HTTP {status}: {raw[:300]!r}")
        return json.loads(raw)

    def pql(self, query: str):
        return self.json("POST", "/index/s/query", query.encode(), "text/plain")["results"]

    def close(self):
        self.conn.close()


def _serve_cli(env=None):
    """`python -m pilosa_tpu_torch.cli server` in memory on a free port."""
    return subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir", "", "--bind", "127.0.0.1:0"],
        stderr=subprocess.PIPE, text=True, env=env,
    )


def cli_check():
    """The CLI serves on the card and stops with code 0 on SIGTERM (with a
    kept-alive connection open); without a card it exits non-zero."""
    import os
    import select
    import signal

    p = _serve_cli()
    try:
        ready, _, _ = select.select([p.stderr], [], [], 120)
        check(bool(ready), "CLI server printed nothing in 120 s")
        line = p.stderr.readline()
        m = re.search(r"listening on (http://\S+) \(device (\S+)\)", line)
        check(m is not None and m.group(2).startswith("cuda"), f"CLI server said {line!r}")
        c = _Http(m.group(1))
        c.json("POST", "/index/s", {})
        c.json("POST", "/index/s/field/f", {})
        check(c.pql("Set(7, f=1)") == [True] and c.pql("Count(Row(f=1))") == [1], "CLI server: Set then Count")
        t0 = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        try:
            rc = p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            fail("CLI server did not stop within 10 s of SIGTERM")
        c.close()
        check(rc == 0, f"CLI server exited {rc} on SIGTERM")
        print(f"serve: CLI server {m.group(1)} on {m.group(2)}: Set, Count 1; SIGTERM -> exit 0 in {time.perf_counter() - t0:.2f} s")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stderr.close()
    p = _serve_cli(dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        _, err = p.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        fail("CLI server without a card did not exit in 120 s")
    check(p.returncode != 0 and "no CUDA device" in err, f"CLI server without a card: exit {p.returncode}, {err!r}")
    print(f"serve: CLI server without a card exits {p.returncode}: {err.strip().splitlines()[-1]}")


def serve_path(args):
    import threading

    import torch

    from pilosa_tpu_torch.core import roaring_io
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server import NodeServer, wire
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    S, W = min(args.shards, SERVE_SHARDS), WORDS_PER_ROW
    n_val = min(S, N_SERVE_VALUES)
    rng = np.random.default_rng([args.seed, 5])
    print(
        f"serve: cut: index s over {S} of {args.shards} shards; int field amount in "
        f"{n_val} of them (import-value JSON carries ~7.5M values; the BSI phase drives the int path over every shard)"
    )

    # data from the seed: f = dense rows, then sparse rows (one roaring body
    # per shard); g = sparse rows (JSON /import); amount = int values
    t0 = time.perf_counter()
    rows = {}
    for r, draws in enumerate(SERVE_DENSE_DRAWS):
        w = rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
        for _ in range(draws - 1):
            w &= rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
        rows[("f", r)] = w
    base = (np.arange(S, dtype=np.uint64) * np.uint64(SHARD_WIDTH))[:, None]

    def sparse_row():
        """(absolute columns, [S, W] words) of ~1000 random bits per shard."""
        cols = (rng.integers(0, SHARD_WIDTH, size=(S, 1000), dtype=np.uint64) + base).ravel()
        words = np.zeros(S * W, np.uint32)
        np.bitwise_or.at(words, (cols >> np.uint64(5)).astype(np.int64), np.uint32(1) << (cols & np.uint64(31)).astype(np.uint32))
        return cols, words.reshape(S, W)

    n_dense = len(SERVE_DENSE_DRAWS)
    for r in range(N_SERVE_SPARSE_F):
        rows[("f", n_dense + r)] = sparse_row()[1]
    g_cols = []
    for r in range(N_SERVE_G):
        cols, rows[("g", r)] = sparse_row()
        g_cols.append(cols)
    has_a = rng.random((n_val, SHARD_WIDTH)) < 0.9
    amt = rng.integers(AMOUNT[0], AMOUNT[1] + 1, size=(n_val, SHARD_WIDTH))
    f_ids = range(n_dense + N_SERVE_SPARSE_F)
    R = lambda fld, r: rows[(fld, r)]  # noqa: E731

    def shard_positions(s):
        """Shard s's bits of f as sorted fragment positions row * 2^20 + col."""
        return np.concatenate(
            [np.flatnonzero(_bits(R("f", r)[s])).astype(np.uint64) + np.uint64(r * SHARD_WIDTH) for r in f_ids]
        )

    data_dir = durable_dir()
    with ThreadPoolExecutor(max_workers=8) as pool:
        bodies = list(pool.map(lambda s: roaring_io.encode(shard_positions(s)), range(S)))
    f_shard_bits = sum(_LUT[R("f", r).view(np.uint8)].reshape(S, -1).sum(axis=1, dtype=np.int64) for r in f_ids)
    exists = np.zeros((S, W), np.uint32)
    for words in rows.values():
        exists |= words
    exists[:n_val] |= _pack(has_a)
    n_body = sum(map(len, bodies))
    print(f"serve: generated the data and {S} roaring bodies ({n_body} B) in {time.perf_counter() - t0:.1f} s")

    # the result cache off: this phase's p50s time execution, as in the
    # runs before the cache was ported (phase 5e drives the cache)
    srv = NodeServer(data_dir, "smoke", bind="127.0.0.1:0", max_writes_per_request=0, cache_result_mb=0).start()
    http = _Http(srv.node.uri)
    try:
        print(f"serve: NodeServer {srv.node.uri} on {srv.holder.device}, data dir {data_dir}")
        http.json("POST", "/index/s", {"options": {"trackExistence": True}})
        http.json("POST", "/index/s/field/f", {})
        http.json("POST", "/index/s/field/g", {})
        http.json("POST", "/index/s/field/amount", {"options": {"type": "int", "min": AMOUNT[0], "max": AMOUNT[1]}})

        # ingest: one import-roaring POST per shard; /import JSON in batches
        # of 5000 writes; one import-value POST per shard of values
        # the numpy roaring decode (core/roaring_io.py) timed apart from the
        # rest of each request: the server runs in this process, and the
        # API calls the module's decode for each body
        decode_s = [0.0]
        real_decode = roaring_io.decode

        def timed_decode(data):
            td = time.perf_counter()
            try:
                return real_decode(data)
            finally:
                decode_s[0] += time.perf_counter() - td

        roaring_io.decode = timed_decode
        t0 = time.perf_counter()
        try:
            for s, body in enumerate(bodies):
                out = http.json("POST", f"/index/s/field/f/import-roaring/{s}", body, "application/octet-stream")
                check(out == {"changed": int(f_shard_bits[s])}, f"import-roaring shard {s}: {out}, want {int(f_shard_bits[s])} changed")
            roaring_s = time.perf_counter() - t0
        finally:
            roaring_io.decode = real_decode
        del bodies
        t0 = time.perf_counter()
        n_requests = n_import = 0
        for r, cols in enumerate(g_cols):
            for i in range(0, len(cols), IMPORT_BATCH):
                c = cols[i : i + IMPORT_BATCH]
                out = http.json("POST", "/index/s/field/g/import", {"rows": [r] * len(c), "cols": c.tolist()})
                check(out["errors"] == [] and out["applied"] == out["expected"] > 0, f"/import: {out}")
                n_requests += 1
                n_import += len(c)
        import_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_values = 0
        for s in range(n_val):
            cols = np.flatnonzero(has_a[s])
            body = {"cols": (cols + s * SHARD_WIDTH).tolist(), "values": amt[s, cols].tolist()}
            out = http.json("POST", "/index/s/field/amount/import-value", body)
            check(out == {"applied": 1, "expected": 1, "errors": []}, f"import-value shard {s}: {out}")
            n_values += len(cols)
        value_s = time.perf_counter() - t0
        ingest = {
            "roaring_s": roaring_s,
            "roaring_bytes": n_body,
            "roaring_bits": int(f_shard_bits.sum()),
            "roaring_mib_per_s": n_body / 2**20 / roaring_s,
            "roaring_bits_per_s": int(f_shard_bits.sum()) / roaring_s,
            "roaring_decode_s": decode_s[0],
            "roaring_decode_share": decode_s[0] / roaring_s,
            "import_s": import_s,
            "import_requests": n_requests,
            "import_bits_per_s": n_import / import_s,
            "import_value_s": value_s,
            "import_value_values": n_values,
            "import_value_values_per_s": n_values / value_s,
        }
        ingest["ingest_s"] = roaring_s + import_s + value_s
        print(
            f"serve: durable ingest {ingest['ingest_s']:.1f} s over HTTP: import-roaring {S} POSTs, {n_body / 2**20:.1f} MiB, "
            f"{ingest['roaring_bits']} bits in {roaring_s:.1f} s ({ingest['roaring_mib_per_s']:.2f} MiB/s, "
            f"{ingest['roaring_bits_per_s']:.0f} bits/s; the numpy decode {decode_s[0]:.2f} s of it, "
            f"{ingest['roaring_decode_share']:.1%}); /import {n_requests} POSTs, {n_import} bits in {import_s:.1f} s "
            f"({ingest['import_bits_per_s']:.0f} bits/s); import-value {n_val} POSTs, {n_values} values in {value_s:.1f} s "
            f"({ingest['import_value_values_per_s']:.0f} values/s)"
        )

        # read back what was acknowledged
        for s in sorted({0, 1, S // 2, S - 1}):
            status, raw = http.raw("GET", f"/index/s/field/f/export-roaring/{s}")
            check(status == 200 and np.array_equal(roaring_io.decode(raw), shard_positions(s)),
                  f"export-roaring shard {s} differs from what was imported")

        # numpy answers
        pc = np_popcount
        vals = amt[has_a]
        g0v = _bits(R("g", 0)[:n_val]).reshape(n_val, SHARD_WIDTH) & has_a
        top = sorted(((r, pc(R("f", r))) for r in f_ids), key=lambda kv: (-kv[1], kv[0]))[:5]
        ic = ((r, pc(R("f", r) & R("g", 0))) for r in f_ids)
        top_g0 = sorted(((r, c) for r, c in ic if c), key=lambda kv: (-kv[1], kv[0]))[:5]
        lo, hi = _extreme(vals, True), _extreme(vals, False)
        row_g0 = sorted_unique(g_cols[0])
        want = dict(zip(SERVE_QUERIES, [
            [pc(R("f", 0) & R("g", 0))],
            [pc(R("f", 0) | R("f", 1) | R("g", 1))],
            [pc(exists & ~R("f", 1))],
            [{"attrs": {}, "columns": row_g0.tolist()}],
            [[{"id": r, "count": c} for r, c in top]],
            [[{"id": r, "count": c} for r, c in top_g0]],
            [{"value": int(vals.sum()), "count": len(vals)}],
            [{"value": lo[0], "count": lo[1]}],
            [{"value": hi[0], "count": hi[1]}],
            [{"value": int(amt[g0v].sum()), "count": int(g0v.sum())}],
            [int((vals > 500_000).sum())],
        ]))

        f_list = [R("f", r) for r in f_ids]
        g_list = [R("g", r) for r in range(N_SERVE_G)]
        want["GroupBy(Rows(f), Rows(g))"] = [group_json(("f", "g"), np_groups(f_list, g_list))]
        want["Rows(f)"] = [list(f_ids)]

        # the query set over HTTP (then Rows and GroupBy); launches counted
        # for them alone
        torch.cuda.synchronize()
        K.reset_launches()
        served, first_ms = {}, {}
        for q in SERVE_QUERIES + SERVE_GROUP_QUERIES:
            tq = time.perf_counter()
            status, served[q] = http.raw("POST", "/index/s/query", q.encode(), "text/plain")
            first_ms[q] = (time.perf_counter() - tq) * 1e3
            check(status == 200, f"{q}: HTTP {status}: {served[q][:300]!r}")
            print(f"serve: first pass {first_ms[q]:.1f} ms  {q}")
        first_pass_s = sum(first_ms[q] for q in SERVE_QUERIES) / 1e3
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        from pilosa_tpu_torch.exec.groupby import gmax

        descends = len(f_ids) > gmax(S, W)
        for name in SERVE_KERNELS + ("counts_cross",) + (("count2",) if descends else ()):
            check(launches[name] > 0, f"the served queries never launched {name}: {launches}")
        resident = srv.holder.dcache.bytes_used
        for q in SERVE_QUERIES + SERVE_GROUP_QUERIES:
            got = json.loads(served[q])["results"]
            check(got == want[q], f"served {q}: {str(got)[:300]}, numpy says {str(want[q])[:300]}")
            local = [wire.result_to_public_json(r) for r in srv.executor.execute("s", q)]
            check(got == local, f"served {q} differs from Executor.execute on the server's holder")
        print(
            f"serve: {len(SERVE_QUERIES)} queries over HTTP equal numpy and Executor.execute; first query "
            f"{first_ms[SERVE_QUERIES[0]]:.1f} ms, first pass {first_pass_s:.2f} s; launches {launches}; "
            f"device cache {resident} B; Row(g=0) has {len(row_g0)} columns"
        )

        # errors: an unknown index
        status, raw = http.raw("POST", "/index/nope/query", b"Count(Row(f=0))", "text/plain")
        check(status == 404, f"unknown index: HTTP {status} {raw!r}")

        # a write changes the next Count by exactly its effect
        s = S // 2
        col = s * SHARD_WIDTH + int(np.flatnonzero(_bits(exists[s] & ~R("f", 0)[s]))[0])
        n0 = pc(R("f", 0))
        steps = [("Count(Row(f=0))", [n0]), (f"Set({col}, f=0)", [True]), ("Count(Row(f=0))", [n0 + 1]),
                 (f"Set({col}, f=0)", [False]), ("Count(Row(f=0))", [n0 + 1]), (f"Clear({col}, f=0)", [True]),
                 ("Count(Row(f=0)) Count(Not(Row(f=1)))", [n0, want[SERVE_QUERIES[2]][0]])]
        for q, expect in steps:
            got = http.pql(q)
            check(got == expect, f"{q}: {got}, want {expect}")
        print(f"serve: Set/Clear of column {col} moved Count(Row(f=0)) by exactly +1 and -1")

        # warm p50s: served (HTTP round trip) and in process (Executor.execute)
        lat = {}
        for q in SERVE_QUERIES + SERVE_GROUP_QUERIES:
            body = q.encode()
            served_ms = host_p50_ms(lambda: http.raw("POST", "/index/s/query", body, "text/plain"))
            local_ms = host_p50_ms(lambda: srv.executor.execute("s", q))
            lat[q] = {"served_ms": served_ms, "in_process_ms": local_ms, "front_end_ms": served_ms - local_ms}
            print(f"serve p50 {served_ms:.3f} ms served, {local_ms:.3f} ms in process, front end {served_ms - local_ms:.3f} ms  {q}")

        # 8 clients at once, CONCURRENT_ROUNDS rounds of the query set each
        errors = []

        def client(k):
            c = _Http(srv.node.uri)
            try:
                for rnd in range(CONCURRENT_ROUNDS):
                    for j in np.random.default_rng([k, rnd]).permutation(len(SERVE_QUERIES)).tolist():
                        q = SERVE_QUERIES[j]
                        status, raw = c.raw("POST", "/index/s/query", q.encode(), "text/plain")
                        if status != 200 or raw != served[q]:
                            errors.append((k, q, status, raw[:200]))
            finally:
                c.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in threads), "concurrent clients did not finish in 900 s")
        check(not errors, f"{len(errors)} concurrent answers differ from the serial ones: {errors[:3]}")
        concurrent_s = time.perf_counter() - t0
        print(
            f"serve: 8 clients x {CONCURRENT_ROUNDS} rounds x {len(SERVE_QUERIES)} queries in {concurrent_s:.1f} s, "
            "every answer equal to the serial one"
        )

        # the keyed index on the same durable node, after the measurements
        # above (which stay comparable with earlier runs)
        t0 = time.perf_counter()
        keyed = keyed_path(args, http, srv)
        keyed["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_ts = min(S, SERVE_TIME_SHARDS)
        time_served = serve_time(args, http, srv, np.flatnonzero(_bits(exists[:n_ts])).astype(np.uint64))
        time_served["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        attrs_served = serve_attrs(args, http, srv, rows, row_g0, served, want)
        attrs_served["phase_s"] = time.perf_counter() - t0
    finally:
        http.close()
        srv.stop()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    front_end = front_end_path(args, rows, exists)
    front_end["phase_s"] = time.perf_counter() - t0
    print(f"front end: phase {front_end['phase_s']:.1f} s")
    t0 = time.perf_counter()
    cli_check()
    recovered = {"data_dir": data_dir, "served": served, "want": want, "row_g0": row_g0, "n_val": n_val,
                 "keyed_served": keyed.pop("served"), "time_served": time_served.pop("served"),
                 "attrs_served": attrs_served.pop("served")}
    return recovered, {
        "front_end": front_end,
        "keyed": keyed,
        "time": time_served,
        "attrs": attrs_served,
        "launches": launches,
        "query_p50_ms": lat,
        "first_query_ms": first_ms[SERVE_QUERIES[0]],
        "first_pass_ms": first_ms,
        "row_g0_columns": len(row_g0),
        "first_pass_s": first_pass_s,
        "ingest": ingest,
        "device_cache_bytes": resident,
        "concurrent_s": concurrent_s,
        "cli_s": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# phase 5e: the served query front end (admission, the Count batcher, the
# result cache, the prefetcher) on an in-memory node
# ---------------------------------------------------------------------------

FE_TREES = [
    "Count(Row(f=0))",
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=0), Row(g=0)))",
    "Count(Union(Row(f=1), Row(g=1)))",
    "Count(Difference(Row(f=2), Row(g=0)))",
    "Count(Xor(Row(f=3), Row(g=1)))",
    "Count(Intersect(Row(f=2), Row(f=3), Row(g=0)))",
    "Count(Not(Row(f=0)))",
]
FE_CLIENTS = 32
# the client process of phase 5e: argv uri, trees (JSON), clients, requests
# a client, index; prints {"wall_s", "lat_ms", "answers": [[query, status, body]]}
FE_CLIENT_CODE = """
import http.client, json, sys, threading, time
uri, trees, n_clients, n_req = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
path = "/index/" + sys.argv[5] + "/query"
host, port = uri.removeprefix("http://").rsplit(":", 1)
lat, answers, mu = [], [], threading.Lock()
def client(k):
    c = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        for j in range(n_req):
            q = trees[(k + j) % len(trees)]
            t0 = time.perf_counter()
            c.request("POST", path, body=q.encode(), headers={"Content-Type": "text/plain"})
            r = c.getresponse()
            body = r.read().decode()
            dt = (time.perf_counter() - t0) * 1e3
            with mu:
                lat.append(dt)
                answers.append([q, r.status, body])
    finally:
        c.close()
ts = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
t0 = time.perf_counter()
for t in ts:
    t.start()
for t in ts:
    t.join()
print(json.dumps({"wall_s": time.perf_counter() - t0, "lat_ms": lat, "answers": answers}))
"""
FE_REQUESTS = 20  # single-Count requests a client
FE_IMPORT = 1000  # bits /import-ed into f row 0 before the repaired Count
# (d): rows of an index "p" that outgrow the device cache set for it
FE_COLD_ROWS, FE_COLD_SHARDS, FE_COLD_BUDGET_ROWS = 16, 128, 6
FE_COLD_REQUESTS = 10  # a client, each of (d)'s four runs


def front_end_path(args, rows, exists) -> dict:
    """A NodeServer in this process, in memory, with the reference's
    front-end defaults (16 concurrent queries, a queue of 128, a 64 MB
    result cache with count repair, prefetch depth 4), on the serve
    phase's f/g words over its shards (loaded as fragment words):
    (a) with the cache budget at 0, FE_CLIENTS threads x FE_REQUESTS
    single-Count requests over 8 distinct trees, every answer held to
    numpy, the Count batcher merging rounds on plan_count_multi;
    requests/s and p50 at 1 and FE_CLIENTS clients, the batch-size
    histogram, the prefetcher's warms; (b) with the cache on, a repeated
    Count is a hit with no launch and no host read, a staged /import into
    its row is repaired with no plan_count* launch, a Clear recomputes;
    (c) a second node of 8 shards with one slot and no queue answers 429
    with Retry-After while the slot is held, then 200; (d) the prefetcher
    where queued queries read rows that are not resident: FE_COLD_ROWS
    rows of an index p over FE_COLD_SHARDS shards under a device cache of
    FE_COLD_BUDGET_ROWS of them, one Row a request, FE_COLD_REQUESTS a
    client, cache off, the prefetcher attached and detached in turn (on,
    off, off, on)."""
    import threading

    import torch

    from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
    from pilosa_tpu_torch.exec import batcher as B
    from pilosa_tpu_torch.exec import plan as P
    from pilosa_tpu_torch.hbm import residency as res
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server import NodeServer
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW as W_ROW

    S = exists.shape[0]
    pc = np_popcount
    R = lambda fld, r: rows[(fld, r)]  # noqa: E731
    want = {
        FE_TREES[0]: pc(R("f", 0)),
        FE_TREES[1]: pc(R("f", 1)),
        FE_TREES[2]: pc(R("f", 0) & R("g", 0)),
        FE_TREES[3]: pc(R("f", 1) | R("g", 1)),
        FE_TREES[4]: pc(R("f", 2) & ~R("g", 0)),
        FE_TREES[5]: pc(R("f", 3) ^ R("g", 1)),
        FE_TREES[6]: pc(R("f", 2) & R("f", 3) & R("g", 0)),
        FE_TREES[7]: pc(exists & ~R("f", 0)),
    }
    t0 = time.perf_counter()
    srv = NodeServer(None, "fe", bind="127.0.0.1:0", max_writes_per_request=0, hbm_prefetch_depth=4).start()
    out = {}
    try:
        idx = srv.holder.create_index("s", track_existence=True)
        for fld, n in (("f", 4), ("g", 2)):
            field = idx.create_field(fld)
            for r in range(n):
                for s in range(S):
                    field.import_row_words(r, s, R(fld, r)[s])
        ex_field = idx.existence_field()
        for s in range(S):
            ex_field.import_row_words(0, s, exists[s])
        out["load_s"] = time.perf_counter() - t0
        print(
            f"front end: NodeServer {srv.node.uri} in memory, {S} shards ({S * SHARD_WIDTH} columns), f rows 0-3 and "
            f"g rows 0-1 of the serve phase loaded in {out['load_s']:.1f} s; max_concurrent_queries "
            f"{srv.scheduler.max_concurrent}, queue {srv.scheduler.max_queue_depth}, cache "
            f"{RESULT_CACHE.budget_bytes >> 20} MB, repair {RESULT_CACHE.repair_enabled}, prefetch depth {srv.prefetcher.depth}"
        )

        # (a) the batcher, the cache off
        RESULT_CACHE.configure(budget_bytes=0)
        http = _Http(srv.node.uri)
        try:
            for q in FE_TREES:  # the first pass stages every operand
                check(http.pql(q) == [want[q]], f"front end {q}: not {want[q]}")
            solo = []
            for k in range(FE_REQUESTS):
                q = FE_TREES[k % len(FE_TREES)]
                tq = time.perf_counter()
                got = http.pql(q)
                solo.append((time.perf_counter() - tq) * 1e3)
                check(got == [want[q]], f"front end {q}: {got}, numpy says {want[q]}")
        finally:
            http.close()
        solo_s = sum(solo) / 1e3
        B.reset_stats()
        K.reset_launches()
        res.reset_stats()
        lat, errors = [], []

        def run_clients(trees=FE_TREES, index="s", want=want, n_req=FE_REQUESTS) -> float:
            """FE_CLIENTS threads x FE_REQUESTS requests from a client
            process of their own (this process's interpreter lock stays
            the server's); answers checked here. Returns the wall s."""
            errors.clear()
            proc = subprocess.run(
                [sys.executable, "-c", FE_CLIENT_CODE, srv.node.uri, json.dumps(trees), str(FE_CLIENTS), str(n_req), index],
                capture_output=True, text=True, timeout=600,
            )
            check(proc.returncode == 0, f"front-end client process: {proc.returncode} {proc.stderr[-2000:]}")
            res_c = json.loads(proc.stdout)
            lat[:] = res_c["lat_ms"]
            for q, status, body in res_c["answers"]:
                got = json.loads(body).get("results") if status == 200 else None
                if got != [want[q]]:
                    errors.append((q, status, body[:200]))
            check(len(res_c["answers"]) == FE_CLIENTS * n_req,
                  f"front-end clients: {len(res_c['answers'])} answers of {FE_CLIENTS * n_req}: {proc.stderr[-1500:]}")
            check(not errors, f"front end: {len(errors)} wrong answers, first {errors[:3]}")
            return res_c["wall_s"]

        # where a request's time goes: the executor (lowering, kernels, the
        # host read) and the admission call (the cost estimate and any wait)
        spent = {"execute": [0.0, 0], "admit": [0.0, 0]}
        spent_mu = threading.Lock()

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    with spent_mu:
                        spent[name][0] += time.perf_counter() - t
                        spent[name][1] += 1
            return run

        real_exec, real_admit = srv.executor.execute_response, srv.api._admit
        srv.executor.execute_response = timed("execute", real_exec)
        srv.api._admit = timed("admit", real_admit)
        try:
            conc_s = run_clients()
        finally:
            srv.executor.execute_response, srv.api._admit = real_exec, real_admit
        stats, launches = dict(B.STATS), {k: v for k, v in K.LAUNCHES.items() if v}
        conc_lat = list(lat)
        # the same load with the prefetcher detached, then with the Count
        # batcher bypassed too: which layer moves requests/s and the tail
        variants = {}
        prefetcher, srv.scheduler.prefetcher = srv.scheduler.prefetcher, None
        try:
            dt = run_clients()
            variants["no prefetcher"] = (dt, list(lat))
            api_batched, srv.api._query_batched = srv.api._query_batched, lambda *a: None
            try:
                dt = run_clients()
                variants["no prefetcher, no batcher"] = (dt, list(lat))
            finally:
                srv.api._query_batched = api_batched
        finally:
            srv.scheduler.prefetcher = prefetcher
        dt = run_clients()  # as the first run, last: order effects show here
        variants["as shipped, again"] = (dt, list(lat))
        lat[:] = conc_lat
        check(stats["merged_execs"] > 0, f"the batcher merged no round: {stats}")
        # every merged round ran on one plan_count_multi launch (8 trees:
        # one group), and none failed into the per-query re-run
        check(stats["fallback_splits"] == 0, f"merged rounds split into per-query runs: {stats}")
        check(launches.get("plan_count_multi", 0) == stats["merged_execs"],
              f"{stats['merged_execs']} merged rounds, plan_count_multi launches {launches}")
        hist = srv.count_batcher.batch_sizes
        sizes = {f"<={b:g}": n for b, n in zip(hist_bounds(), hist.buckets) if n}
        pre = res.stats_snapshot()
        out["batcher"] = {
            "requests": FE_CLIENTS * FE_REQUESTS,
            "solo_requests_per_s": FE_REQUESTS / solo_s, "solo_p50_ms": statistics.median(solo),
            "requests_per_s": FE_CLIENTS * FE_REQUESTS / conc_s, "p50_ms": statistics.median(lat),
            "p99_ms": float(np.percentile(lat, 99)), "stats": stats, "launches": launches,
            "batch_sizes": hist.snapshot(), "batch_size_buckets": sizes,
            "prefetch": {"offered": srv.prefetcher.offered, "skipped": srv.prefetcher.skipped,
                         "warmed": srv.prefetcher.warmed, "dropped": srv.prefetcher.dropped,
                         "staged": pre["prefetch_staged"], "hits": pre["prefetch_hits"]},
            "admission": srv.scheduler.snapshot(),
            "spent_s": {k: v[0] for k, v in spent.items()}, "spent_calls": {k: v[1] for k, v in spent.items()},
            "variants": {
                k: {"requests_per_s": FE_CLIENTS * FE_REQUESTS / dt, "p50_ms": statistics.median(v),
                    "p99_ms": float(np.percentile(v, 99))}
                for k, (dt, v) in variants.items()
            },
        }
        ob = out["batcher"]
        print(
            f"front end (a): 1 client {ob['solo_requests_per_s']:.1f} requests/s, p50 {ob['solo_p50_ms']:.3f} ms; "
            f"{FE_CLIENTS} clients x {FE_REQUESTS} requests {ob['requests_per_s']:.1f} requests/s, p50 "
            f"{ob['p50_ms']:.3f} ms, p99 {ob['p99_ms']:.3f} ms; every answer equals numpy; batcher {stats}; "
            f"launches {launches}; batch sizes {sizes} (mean {ob['batch_sizes'].get('mean', 0):.2f}); prefetcher "
            f"{ob['prefetch']}"
        )
        print(
            f"front end (a): executor {spent['execute'][1]} calls, {spent['execute'][0]:.3f} s "
            f"({spent['execute'][0] / max(1, spent['execute'][1]) * 1e3:.3f} ms each, {spent['execute'][0] / conc_s:.1%} "
            f"of the {conc_s:.3f} s wall); admission {spent['admit'][1]} calls, {spent['admit'][0]:.3f} s summed over "
            f"the request threads ({spent['admit'][0] / max(1, spent['admit'][1]) * 1e3:.3f} ms each, the queue wait included)"
        )
        for k, v in ob["variants"].items():
            print(
                f"front end (a), {k}: {FE_CLIENTS} clients {v['requests_per_s']:.1f} requests/s, p50 "
                f"{v['p50_ms']:.3f} ms, p99 {v['p99_ms']:.3f} ms; every answer equals numpy"
            )

        # (b) the cache on: a hit, a repair, a recompute
        RESULT_CACHE.configure(budget_bytes=64 << 20)
        http = _Http(srv.node.uri)
        try:
            q = FE_TREES[0]
            check(http.pql(q) == [want[q]], f"cached {q}: first answer")
            c0 = RESULT_CACHE.stats_snapshot()
            torch.cuda.synchronize()
            K.reset_launches()
            P.reset_stats()
            check(http.pql(q) == [want[q]], f"cached {q}: repeat")
            c1 = RESULT_CACHE.stats_snapshot()
            hit_launches = {k: v for k, v in K.LAUNCHES.items() if v}
            hit_reads = P.STATS["host_reads"]
            check(c1["hits"] == c0["hits"] + 1 and not hit_launches and hit_reads == 0,
                  f"repeat of {q}: hits {c0['hits']} -> {c1['hits']}, launches {hit_launches}, plan {P.STATS}")
            rng = np.random.default_rng([args.seed, 11])
            cols = rng.choice(S * SHARD_WIDTH, FE_IMPORT, replace=False).astype(np.uint64)
            f0 = R("f", 0).copy().reshape(-1)
            np.bitwise_or.at(f0, (cols >> np.uint64(5)).astype(np.int64), np.uint32(1) << (cols & np.uint64(31)).astype(np.uint32))
            n_new = pc(f0)
            res_out = http.json("POST", "/index/s/field/f/import", {"rows": [0] * len(cols), "cols": cols.tolist()})
            check(res_out["errors"] == [], f"/import: {res_out}")
            K.reset_launches()
            got = http.pql(q)
            c2 = RESULT_CACHE.stats_snapshot()
            rep_launches = {k: v for k, v in K.LAUNCHES.items() if v}
            check(got == [n_new], f"{q} after /import of {FE_IMPORT} bits: {got}, numpy says {n_new}")
            # one repair a merged shard (the reference's counting)
            check(c2["repairs"] > c1["repairs"] and c2["hits"] == c1["hits"] + 1
                  and not any(k.startswith("plan_count") for k in rep_launches),
                  f"{q} after /import: repairs {c1['repairs']} -> {c2['repairs']}, launches {rep_launches}")
            col = int(cols[0])
            check(http.pql(f"Clear({col}, f=0)") == [True], "Clear")
            K.reset_launches()
            got = http.pql(q)
            c3 = RESULT_CACHE.stats_snapshot()
            clr_launches = {k: v for k, v in K.LAUNCHES.items() if v}
            check(got == [n_new - 1], f"{q} after Clear: {got}, numpy says {n_new - 1}")
            check(c3["misses"] == c2["misses"] + 1 and clr_launches.get("plan_count", 0) == 1,
                  f"{q} after Clear: misses {c2['misses']} -> {c3['misses']}, launches {clr_launches}")
        finally:
            http.close()
        out["cache"] = {"hit_launches": hit_launches, "hit_host_reads": hit_reads, "repair_launches": rep_launches,
                        "clear_launches": clr_launches,
                        "counters": c3}
        print(
            f"front end (b): repeat of {q} a hit with launches {hit_launches} and {hit_reads} host reads; "
            f"after /import of {FE_IMPORT} bits repaired to {n_new} with launches {rep_launches}; after a Clear "
            f"recomputed to {n_new - 1} with launches {clr_launches}; cache {({k: c3[k] for k in ('hits', 'misses', 'repairs', 'stores')})}"
        )

        # (d) queued queries whose rows are not resident
        RESULT_CACHE.configure(budget_bytes=0)
        sp = min(S, FE_COLD_SHARDS)
        crng = np.random.default_rng([args.seed, 13])
        cold = srv.holder.create_index("p", track_existence=False).create_field("f")
        cold_want = {}
        for r in range(FE_COLD_ROWS):
            words = crng.integers(0, 2**32, size=(sp, W_ROW), dtype=np.uint32)
            for s in range(sp):
                cold.import_row_words(r, s, words[s])
            cold_want[f"Count(Row(f={r}))"] = pc(words)
        cold_trees = list(cold_want)
        dcache = srv.holder.dcache
        budget = dcache.budget_bytes
        dcache.budget_bytes = FE_COLD_BUDGET_ROWS * sp * W_ROW * 4
        dcache.clear()
        cold_runs = []
        try:
            for on in (True, False, False, True):
                srv.scheduler.prefetcher = prefetcher if on else None
                res.reset_stats()
                o0, w0, k0 = prefetcher.offered, prefetcher.warmed, prefetcher.skipped
                dt = run_clients(cold_trees, "p", cold_want, FE_COLD_REQUESTS)
                st = res.stats_snapshot()
                cold_runs.append({
                    "prefetcher": on, "requests_per_s": FE_CLIENTS * FE_COLD_REQUESTS / dt,
                    "p50_ms": statistics.median(lat), "p99_ms": float(np.percentile(lat, 99)),
                    "offered": prefetcher.offered - o0, "warmed": prefetcher.warmed - w0,
                    "skipped": prefetcher.skipped - k0,
                    "prefetch_staged": st["prefetch_staged"], "prefetch_hits": st["prefetch_hits"],
                    "restage_mib": st["restage_bytes"] / 2**20,
                })
        finally:
            srv.scheduler.prefetcher = prefetcher
            dcache.budget_bytes = budget
        out["cold"] = cold_runs
        for run in cold_runs:
            print(
                f"front end (d), rows not resident ({FE_COLD_ROWS} rows x {sp} shards, cache {FE_COLD_BUDGET_ROWS} rows), "
                f"prefetcher {'on' if run['prefetcher'] else 'off'}: {FE_CLIENTS} clients {run['requests_per_s']:.1f} "
                f"requests/s, p50 {run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms; every answer equals numpy; warms "
                f"offered {run['offered']}, skipped {run['skipped']}, run {run['warmed']}; extents staged by warms "
                f"{run['prefetch_staged']}, "
                f"hit by queries {run['prefetch_hits']}; re-staged {run['restage_mib']:.0f} MiB"
            )
    finally:
        srv.stop()

    # (c) a 429 while the only slot is held, then a 200
    srv2 = NodeServer(None, "fe2", bind="127.0.0.1:0", max_concurrent_queries=1, admission_queue_depth=0).start()
    try:
        http = _Http(srv2.node.uri)
        try:
            http.json("POST", "/index/s", {})
            http.json("POST", "/index/s/field/f", {})
            cols = list(range(0, 8 * SHARD_WIDTH, SHARD_WIDTH // 2))
            http.json("POST", "/index/s/field/f/import", {"rows": [0] * len(cols), "cols": cols})
            ticket = srv2.scheduler.admit()
            try:
                http.conn.request("POST", "/index/s/query", body=b"Count(Row(f=0))", headers={"Content-Type": "text/plain"})
                r = http.conn.getresponse()
                status, raw, retry = r.status, r.read(), r.getheader("Retry-After")
            finally:
                ticket.release()
            check(status == 429 and retry == "1" and b"admission queue full" in raw,
                  f"a query while the slot is held: {status}, Retry-After {retry!r}, {raw!r}")
            check(http.pql("Count(Row(f=0))") == [len(cols)], "the query after the slot is free")
        finally:
            http.close()
    finally:
        srv2.stop()
    out["shed"] = {"status": status, "retry_after": retry, "body": raw.decode()}
    print(f"front end (c): one slot held: HTTP {status}, Retry-After {retry}, {raw.decode()}; released: 200 [{len(cols)}]")
    return out


def hist_bounds():
    from pilosa_tpu_torch.utils.stats import HIST_BOUNDS

    return list(HIST_BOUNDS) + [float("inf")]


# ---------------------------------------------------------------------------
# phase 5d: row and column attributes and Options on the served node
# ---------------------------------------------------------------------------

SERVE_ATTR_COLUMNS = 100_000  # SetColumnAttrs calls: half on Row(g=0)'s columns, half on a sparse row of f
SERVE_ATTR_BATCH = 1000  # SetColumnAttrs calls a query (max-writes-per-request is 5000)
SERVE_ATTR_REPS = 3  # runs per p50: the Row bodies are 0.5-4 MB of JSON (cut for the script's time)


def serve_attrs(args, http, srv, rows, row_g0, served, want) -> dict:
    """Row attrs on every row of f and g (string, int, float and bool
    values) through SetRowAttrs, SERVE_ATTR_COLUMNS SetColumnAttrs in
    batches of SERVE_ATTR_BATCH over the columns of Row(g=0) and of a
    sparse row of f; then Row bodies with and without columnAttrs,
    Options (excludeColumns, columnAttrs, shards) and TopN(attrName=,
    attrValues=), each held to a numpy + dict model and to
    Executor.execute, with served p50s. Row(g=0)'s columnAttrs is built
    from the store's ids, never from the row's columns: checked by
    counting Row.columns() calls in process. `served` and `want` take the
    new body of Row(g=0), which now carries g row 0's attrs. Returns the
    bodies for the durable phase's restart."""
    from pilosa_tpu_torch.core import row as rowmod
    from pilosa_tpu_torch.exec.executor import ExecOptions
    from pilosa_tpu_torch.server import wire
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng([args.seed, 13])
    S = rows[("f", 0)].shape[0]
    n_dense = len(SERVE_DENSE_DRAWS)
    f_ids = range(n_dense + N_SERVE_SPARSE_F)
    sparse_r = n_dense  # the first sparse row of f
    row_attrs, q = {}, []
    for fld, ids in (("f", f_ids), ("g", range(N_SERVE_G))):
        for r in ids:
            a = {"name": f"{fld}{r}", "kind": "dense" if fld == "f" and r < n_dense else "sparse",
                 "weight": r / 4 + 0.5, "even": r % 2 == 0, "rank": 10 * r}
            row_attrs[(fld, r)] = a
            q.append(f'SetRowAttrs({fld}, {r}, name="{a["name"]}", kind="{a["kind"]}", weight={a["weight"]!r}, '
                     f'even={"true" if a["even"] else "false"}, rank={a["rank"]})')
    t0 = time.perf_counter()
    check(http.pql(" ".join(q)) == [None] * len(q), "SetRowAttrs did not answer null")
    row_attrs_s = time.perf_counter() - t0
    f_cols = np.flatnonzero(_bits(rows[("f", sparse_r)].reshape(-1))).astype(np.int64)
    n = min(SERVE_ATTR_COLUMNS // 2, len(row_g0), len(f_cols))
    cols = np.unique(np.concatenate([rng.choice(row_g0.astype(np.int64), n, replace=False), rng.choice(f_cols, n, replace=False)]))
    tiers = rng.integers(0, 7, len(cols))
    col_attrs = {}
    t0 = time.perf_counter()
    for i in range(0, len(cols), SERVE_ATTR_BATCH):
        calls = []
        for c, t in zip(cols[i : i + SERVE_ATTR_BATCH].tolist(), tiers[i : i + SERVE_ATTR_BATCH].tolist()):
            col_attrs[c] = {"tier": t, "label": f"c{c % 1000}", "hot": t == 0}
            calls.append(f'SetColumnAttrs({c}, tier={t}, label="c{c % 1000}", hot={"true" if t == 0 else "false"})')
        check(http.pql(" ".join(calls)) == [None] * len(calls), "SetColumnAttrs did not answer null")
    col_attrs_s = time.perf_counter() - t0
    print(
        f"serve attrs: SetRowAttrs on {len(q)} rows of f and g in {row_attrs_s * 1e3:.1f} ms; {len(cols)} SetColumnAttrs "
        f"in {len(cols) // SERVE_ATTR_BATCH + 1} queries, {col_attrs_s:.1f} s ({len(cols) / col_attrs_s:.0f} calls/s)"
    )

    # the numpy + dict model
    def cas(columns):
        return [{"attrs": col_attrs[c], "id": c} for c in np.intersect1d(cols, np.asarray(columns, np.int64)).tolist()]

    pc = np_popcount
    g0 = row_g0.astype(np.int64).tolist()
    last = S - 1
    f0_last = (np.flatnonzero(_bits(rows[("f", 0)][last])) + last * SHARD_WIDTH).tolist()
    sparse = [r for r in f_ids if row_attrs[("f", r)]["kind"] == "sparse"]
    top = sorted(((r, pc(rows[("f", r)])) for r in sparse), key=lambda kv: (-kv[1], kv[0]))[:5]
    ic = ((r, pc(rows[("f", r)] & rows[("g", 0)])) for r in sparse)
    top_g0 = sorted(((r, c) for r, c in ic if c), key=lambda kv: (-kv[1], kv[0]))[:5]
    topn = 'attrName=kind, attrValues=["sparse"]'
    attr_queries = [
        ("", f"Row(f={sparse_r})", {"results": [{"attrs": row_attrs[("f", sparse_r)], "columns": f_cols.tolist()}]}),
        ("?columnAttrs=true", f"Row(f={sparse_r})",
         {"results": [{"attrs": row_attrs[("f", sparse_r)], "columns": f_cols.tolist()}], "columnAttrs": cas(f_cols)}),
        ("?columnAttrs=true", "Row(g=0)", {"results": [{"attrs": row_attrs[("g", 0)], "columns": g0}], "columnAttrs": cas(g0)}),
        ("", "Options(Row(g=0), excludeColumns=true, columnAttrs=true)",
         {"results": [{"attrs": row_attrs[("g", 0)], "columns": []}], "columnAttrs": []}),
        ("", f"Options(Row(f=0), shards=[{last}])", {"results": [{"attrs": row_attrs[("f", 0)], "columns": f0_last}]}),
        ("", f"TopN(f, n=5, {topn})", {"results": [[{"id": r, "count": c} for r, c in top]]}),
        ("", f"TopN(f, Row(g=0), n=5, {topn})", {"results": [[{"id": r, "count": c} for r, c in top_g0]]}),
    ]
    check(len(cas(g0)) > 1000 and len(cas(f_cols)) > 1000 and len(top) == len(sparse) and top_g0,
          "the attribute queries' model answers are trivial")
    out, lat = {}, {}
    for qs, pql, model in attr_queries:
        status, raw = http.raw("POST", "/index/s/query" + qs, pql.encode(), "text/plain")
        check(status == 200, f"{pql}{qs}: HTTP {status}: {raw[:300]!r}")
        got = json.loads(raw)
        check(got == model, f"served {pql}{qs}: {str(got)[:300]}, the model says {str(model)[:300]}")
        resp = srv.executor.execute_response("s", pql, opt=ExecOptions(column_attrs=bool(qs)))
        local = {"results": [wire.result_to_public_json(r) for r in resp.results]}
        if resp.column_attr_sets is not None:
            local["columnAttrs"] = [c.to_json() for c in resp.column_attr_sets]
        check(got == local, f"served {pql}{qs} differs from Executor.execute_response on the server's holder")
        out[(qs, pql)] = raw
        lat[pql + qs] = host_p50_ms(
            lambda pql=pql, qs=qs: http.raw("POST", "/index/s/query" + qs, pql.encode(), "text/plain"), reps=SERVE_ATTR_REPS
        )
        print(f"serve attrs p50 {lat[pql + qs]:.3f} ms served  {pql}{qs}")
    # Row(g=0)'s column attr sets come from the store's side: no
    # Row.columns() call in process, and what they add to the query
    calls = []
    real = rowmod.Row.columns
    rowmod.Row.columns = lambda self: calls.append(1) or real(self)
    try:
        resp = srv.executor.execute_response("s", "Row(g=0)", opt=ExecOptions(column_attrs=True))
    finally:
        rowmod.Row.columns = real
    check(not calls and len(resp.column_attr_sets) == len(cas(g0)),
          f"Row(g=0) with columnAttrs made {len(calls)} Row.columns() calls, {len(resp.column_attr_sets)} sets")
    in_process = {
        flag: host_p50_ms(
            lambda flag=flag: srv.executor.execute_response("s", "Row(g=0)", opt=ExecOptions(column_attrs=flag)), reps=SERVE_ATTR_REPS
        )
        for flag in (False, True)
    }
    print(
        f"serve attrs: Row(g=0) ({len(g0)} columns, {len(cas(g0))} with attrs) in process {in_process[False]:.3f} ms, "
        f"with columnAttrs {in_process[True]:.3f} ms (no Row.columns() call: a gather of the store's ids on the card)"
    )
    # Row(g=0) of the served query set now carries its row attrs
    status, served["Row(g=0)"] = http.raw("POST", "/index/s/query", b"Row(g=0)", "text/plain")
    want["Row(g=0)"] = [{"attrs": row_attrs[("g", 0)], "columns": g0}]
    check(status == 200 and json.loads(served["Row(g=0)"])["results"] == want["Row(g=0)"], "Row(g=0) after SetRowAttrs")
    return {
        "served": out,
        "row_attrs_s": row_attrs_s,
        "column_attrs": len(cols),
        "column_attrs_s": col_attrs_s,
        "query_p50_ms": lat,
        "row_g0_in_process_ms": in_process,
    }


# ---------------------------------------------------------------------------
# phase 5c: time and bool fields on the served node
# ---------------------------------------------------------------------------

SERVE_TIME_BITS = 40_000  # timestamped /import bits of field st, over 48 hours (100,000 until PR 11)
SERVE_TIME_SHARDS = 16  # ... in the first 16 shards: every (unit view, shard) is a fragment, files on disk
SERVE_TIME_START = 1704067200  # 2024-01-01T00:00 UTC, unix seconds
SERVE_TIME_RANGE = "from='2024-01-01T05:00', to='2024-01-02T19:00'"
SERVE_TIME_QUERIES = [
    f"Count(Row(st=0, {SERVE_TIME_RANGE}))",
    f"Row(st=1, {SERVE_TIME_RANGE})",
    f"Rows(st, {SERVE_TIME_RANGE})",
    "Count(Row(st=2, from='2024-01-02T00:00'))",
    "Count(Row(sb=true)) Count(Row(sb=false))",
]


def serve_time(args, http, srv, existing) -> dict:
    """A YMDH time field `st` and a bool field `sb` on index `s` through
    HTTP DDL, SERVE_TIME_BITS timestamped /import bits (unix seconds) over
    48 hours in batches of 5000, bool /import, all on columns of index s
    that exist already (`existing`: those of its first SERVE_TIME_SHARDS
    shards), so the answers served before stay what they were; the
    time-range Count, Row and Rows bodies must equal numpy's and
    Executor.execute's. Returns the bodies for the durable phase's
    restart."""
    from pilosa_tpu_torch.server import wire

    rng = np.random.default_rng([args.seed, 11])
    n = SERVE_TIME_BITS
    http.json("POST", "/index/s/field/st", {"options": {"type": "time", "timeQuantum": TIME_QUANTUM}})
    http.json("POST", "/index/s/field/sb", {"options": {"type": "bool"}})
    cols = rng.choice(existing, n).astype(np.int64)
    rows = rng.integers(0, 3, n)
    secs = SERVE_TIME_START + rng.integers(0, 48 * 3600, n)
    bools = rng.integers(0, 2, n)
    t0 = time.perf_counter()
    for i in range(0, n, IMPORT_BATCH):
        sl = slice(i, i + IMPORT_BATCH)
        body = {"rows": rows[sl].tolist(), "cols": cols[sl].tolist(), "timestamps": secs[sl].tolist()}
        out = http.json("POST", "/index/s/field/st/import", body)
        check(out["errors"] == [] and out["applied"] == out["expected"] > 0, f"timestamped /import: {out}")
        out = http.json("POST", "/index/s/field/sb/import", {"rows": bools[sl].tolist(), "cols": cols[sl].tolist()})
        check(out["errors"] == [], f"bool /import: {out}")
    import_s = time.perf_counter() - t0
    hours = (secs - SERVE_TIME_START) // 3600

    def columns(sel):
        return sorted_unique(cols[sel].astype(np.uint64)).tolist()

    # bool: the last write of a column wins (mutex)
    last = {}
    for c, v in zip(cols.tolist(), bools.tolist()):
        last[c] = v
    n_true = sum(last.values())
    in_range = (hours >= 5) & (hours < 43)
    want = {
        SERVE_TIME_QUERIES[0]: [len(columns(in_range & (rows == 0)))],
        SERVE_TIME_QUERIES[1]: [{"attrs": {}, "columns": columns(in_range & (rows == 1))}],
        SERVE_TIME_QUERIES[2]: [sorted({int(r) for r in rows[in_range]})],
        SERVE_TIME_QUERIES[3]: [len(columns((hours >= 24) & (rows == 2)))],
        SERVE_TIME_QUERIES[4]: [n_true, len(last) - n_true],
    }
    served, lat = {}, {}
    for q in SERVE_TIME_QUERIES:
        status, served[q] = http.raw("POST", "/index/s/query", q.encode(), "text/plain")
        check(status == 200, f"{q}: HTTP {status}: {served[q][:300]!r}")
        got = json.loads(served[q])["results"]
        check(got == want[q], f"served {q}: {str(got)[:300]}, numpy says {str(want[q])[:300]}")
        local = [wire.result_to_public_json(r) for r in srv.executor.execute("s", q)]
        check(got == local, f"served {q} differs from Executor.execute on the server's holder")
        lat[q] = host_p50_ms(lambda q=q: http.raw("POST", "/index/s/query", q.encode(), "text/plain"))
        print(f"serve time p50 {lat[q]:.3f} ms served  {q}")
    print(
        f"serve time: fields st ({TIME_QUANTUM}) and sb over HTTP DDL; {n} timestamped bits over 48 hours in "
        f"{n // IMPORT_BATCH} /import POSTs ({import_s:.1f} s, {n / import_s:.0f} bits/s); {len(SERVE_TIME_QUERIES)} "
        "bodies equal numpy and Executor.execute"
    )
    return {"served": served, "import_s": import_s, "bits_per_s": n / import_s, "query_p50_ms": lat}


# ---------------------------------------------------------------------------
# phase 5b: a keyed index on the served node
# ---------------------------------------------------------------------------

KEYED_COLUMNS = 1 << 19  # column keys "u%010d" (ids start at 1); cut to keep the script inside its time (2^20 until PR 11)
KEYED_BATCH = 100_000  # pairs or values per keyed /import or import-value request
KEYED_SEGMENTS = [f"seg-{k:02d}" for k in range(32)]
# 64 two-letter ISO 3166 codes, in Zipf rank order
COUNTRY_CODES = (
    "US DE JP GB FR IN BR CA IT ES AU KR MX NL SE CH PL BE TR ID AR NO AT DK IE FI SG IL NZ PT CZ GR "
    "ZA TH MY PH VN CL CO PE RO HU UA EG NG KE MA SA AE QA PK BD LK NP HK TW IS LU EE LV LT SI"
).split()
KEYED_PLANS = 4
KEYED_QUERIES = [
    'Count(Row(segment="seg-00"))',
    'Count(Intersect(Row(segment="seg-01"), Row(country="US")))',
    "Row(country=RAREST)",
    "TopN(segment, n=5)",
    'TopN(segment, Row(country="US"), n=5)',
    "Rows(segment)",
    'Rows(country, previous="DE", limit=10)',
    'Rows(segment, column="u0000001234")',
    "GroupBy(Rows(segment), Rows(country))",
    "GroupBy(Rows(segment), Rows(country), Rows(plan), filter=Row(plan=1), limit=100)",
    'GroupBy(Rows(segment), Rows(country), previous=["seg-05", "JP"], limit=10)',
    'Sum(Row(segment="seg-03"), field=spend)',
]


def _zipf_p(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def keyed_path(args, http, srv) -> dict:
    """Index `k` (keys, existence tracked) on the serve phase's durable
    node: KEYED_COLUMNS column keys in a seeded random arrival order (ids
    follow arrival, not key order); keyed set field `segment` (32 keys,
    each column in 1-3 segments of Zipf sizes), keyed mutex field
    `country` (64 ISO codes, Zipf), unkeyed set field `plan` (4 rows), int
    field `spend` in [0, 10^6]. Loaded through /import with rowKeys and
    colKeys and import-value with colKeys in batches of KEYED_BATCH; then
    a write, the keyed queries, each held to a numpy + dict model built
    while generating and to Executor.execute on the node's holder, and
    their served and in-process p50s."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server import wire

    n = KEYED_COLUMNS
    rng = np.random.default_rng([args.seed, 8])
    t0 = time.perf_counter()
    users = rng.permutation(n)  # arrival order
    col_keys = [f"u{x:010d}" for x in users.tolist()]
    id_of_user = np.empty(n, np.int64)
    id_of_user[users] = np.arange(1, n + 1)
    # segments: 1-3 Zipf draws per column, user-major, so column ids follow
    # the arrival order; a draw repeated within a column is one bit
    n_seg = rng.integers(1, 4, n)
    draws = rng.choice(len(KEYED_SEGMENTS), size=(n, 3), p=_zipf_p(len(KEYED_SEGMENTS), 1.1))
    take = np.arange(3)[None, :] < n_seg[:, None]
    seg_idx = draws[take]
    seg_col = np.nonzero(take)[0]  # arrival index of each pair
    _, first = np.unique(seg_idx, return_index=True)
    seg_id = np.zeros(len(KEYED_SEGMENTS), np.int64)  # key index -> row id (first appearance)
    seg_id[np.unique(seg_idx)[np.argsort(first)]] = np.arange(1, len(first) + 1)
    cty = rng.choice(len(COUNTRY_CODES), size=n, p=_zipf_p(len(COUNTRY_CODES), 1.2))
    _, first = np.unique(cty, return_index=True)
    cty_id = np.zeros(len(COUNTRY_CODES), np.int64)
    cty_id[np.unique(cty)[np.argsort(first)]] = np.arange(1, len(first) + 1)
    plan = rng.integers(0, KEYED_PLANS, n)
    spend = rng.integers(0, 10**6 + 1, n)
    # the model, by column id (0 unused; id n + 1 is the PQL Set below)
    mem = np.zeros((len(KEYED_SEGMENTS) + 2, n + 2), bool)  # by segment row id
    mem[seg_id[seg_idx], seg_col + 1] = True
    cty_of = np.zeros(n + 2, np.int64)  # country row id per column (0: none)
    cty_of[1 : n + 1] = cty_id[cty]
    plan_of = np.full(n + 2, -1, np.int64)
    plan_of[1 : n + 1] = plan
    spend_of = np.zeros(n + 2, np.int64)
    spend_of[1 : n + 1] = spend
    seg_key = {int(seg_id[k]): key for k, key in enumerate(KEYED_SEGMENTS) if seg_id[k]}
    cty_key = {int(cty_id[k]): code for k, code in enumerate(COUNTRY_CODES) if cty_id[k]}
    seg_pairs = [KEYED_SEGMENTS[k] for k in seg_idx.tolist()]
    seg_cols = [col_keys[i] for i in seg_col.tolist()]
    gen_s = time.perf_counter() - t0
    print(f"keyed: generated {n} column keys, {len(seg_idx)} segment pairs in {gen_s:.1f} s")

    http.json("POST", "/index/k", {"options": {"keys": True, "trackExistence": True}})
    http.json("POST", "/index/k/field/segment", {"options": {"keys": True}})
    http.json("POST", "/index/k/field/country", {"options": {"type": "mutex", "keys": True}})
    http.json("POST", "/index/k/field/plan", {})
    http.json("POST", "/index/k/field/spend", {"options": {"type": "int", "min": 0, "max": 10**6}})

    def load(path, bodies):
        t = time.perf_counter()
        n_req = n_keys = n_bits = 0
        for body in bodies:
            out = http.json("POST", path, body)
            check(out["errors"] == [] and out["applied"] == out["expected"] > 0, f"{path}: {out}")
            n_req += 1
            n_keys += len(body.get("rowKeys", ())) + len(body.get("colKeys", ()))
            n_bits += len(body.get("colKeys", ()))
        dt = time.perf_counter() - t
        return {"s": dt, "requests": n_req, "keys": n_keys, "keys_per_s": n_keys / dt, "bits": n_bits, "bits_per_s": n_bits / dt}

    B = KEYED_BATCH
    ingest = {
        "segment": load("/index/k/field/segment/import", (
            {"rowKeys": seg_pairs[i : i + B], "colKeys": seg_cols[i : i + B]} for i in range(0, len(seg_pairs), B))),
        "country": load("/index/k/field/country/import", (
            {"rowKeys": [COUNTRY_CODES[c] for c in cty[i : i + B].tolist()], "colKeys": col_keys[i : i + B]}
            for i in range(0, n, B))),
        "plan": load("/index/k/field/plan/import", (
            {"rows": plan[i : i + B].tolist(), "colKeys": col_keys[i : i + B]} for i in range(0, n, B))),
        "spend": load("/index/k/field/spend/import-value", (
            {"colKeys": col_keys[i : i + B], "values": spend[i : i + B].tolist()} for i in range(0, n, B))),
    }
    del seg_pairs, seg_cols
    total_s = sum(v["s"] for v in ingest.values())
    for name, v in ingest.items():
        print(
            f"keyed: ingest {name}: {v['requests']} POSTs, {v['bits']} {'values' if name == 'spend' else 'bits'} "
            f"and {v['keys']} keys in {v['s']:.1f} s ({v['bits_per_s']:.0f} {'values' if name == 'spend' else 'bits'}/s, "
            f"{v['keys_per_s']:.0f} keys/s)"
        )

    def kq(q):
        status, raw = http.raw("POST", "/index/k/query", q.encode(), "text/plain")
        check(status == 200, f"keyed {q}: HTTP {status}: {raw[:300]!r}")
        return raw

    # writes, and reads of keys never seen
    check(json.loads(kq('Set("u-new-1", segment="seg-new")'))["results"] == [True], "keyed Set of a new key pair")
    new_seg = len(KEYED_SEGMENTS) + 1
    mem[new_seg, n + 1] = True
    seg_key[new_seg] = "seg-new"
    check(json.loads(kq('Count(Row(segment="seg-new"))'))["results"] == [1], "keyed Count(Row(segment=\"seg-new\"))")
    check(json.loads(kq('Count(Row(segment="never-seen"))'))["results"] == [0], "keyed Count of a key never seen")

    # the model's answers
    sid = {key: i for i, key in seg_key.items()}
    cid = {key: i for i, key in cty_key.items()}
    key_of_id = lambda ids: [col_keys[i - 1] if i <= n else "u-new-1" for i in ids]  # noqa: E731
    cty_counts = np.bincount(cty_of, minlength=len(COUNTRY_CODES) + 1)
    rare = min((c, i) for i, c in enumerate(cty_counts) if i and c)[1]
    rare_cols = np.flatnonzero(cty_of == rare)
    seg_totals = {i: int(mem[i].sum()) for i in seg_key}
    us = cty_of == cid["US"]
    seg_us = {i: int((mem[i] & us).sum()) for i in seg_key}
    top = lambda counts: [{"id": i, "count": c, "key": seg_key[i]}  # noqa: E731
                          for i, c in sorted(((i, c) for i, c in counts.items() if c), key=lambda kv: (-kv[1], kv[0]))[:5]]
    seg_ids_sorted = sorted(i for i in seg_key if seg_totals[i])
    cty_ids_sorted = sorted(i for i in cty_key if cty_counts[i])
    u1234 = int(id_of_user[1234])
    pair_s, pair_c = np.nonzero(mem[:, 1 : n + 1])
    pair_c += 1
    ks = len(COUNTRY_CODES) + 1
    gb2 = np.bincount(pair_s * ks + cty_of[pair_c], minlength=(len(KEYED_SEGMENTS) + 2) * ks)
    groups2 = {(int(k // ks), int(k % ks)): int(v) for k, v in zip(np.flatnonzero(gb2), gb2[gb2 > 0]) if k % ks}
    p1 = plan_of[pair_c] == 1
    gb3 = np.bincount(pair_s[p1] * ks + cty_of[pair_c[p1]], minlength=(len(KEYED_SEGMENTS) + 2) * ks)
    groups3 = {(int(k // ks), int(k % ks), 1): int(v) for k, v in zip(np.flatnonzero(gb3), gb3[gb3 > 0]) if k % ks}
    anchor = (sid["seg-05"], cid["JP"] + 1)
    keys3 = (seg_key, cty_key, None)
    s3 = mem[sid["seg-03"]]
    want = dict(zip(KEYED_QUERIES, [
        [seg_totals[sid["seg-00"]]],
        [seg_us[sid["seg-01"]]],
        [{"attrs": {}, "columns": rare_cols.tolist(), "keys": key_of_id(rare_cols.tolist())}],
        [top(seg_totals)],
        [top(seg_us)],
        [[seg_key[i] for i in seg_ids_sorted]],
        [[cty_key[i] for i in cty_ids_sorted if i > cid["DE"]][:10]],
        [[seg_key[i] for i in seg_ids_sorted if mem[i, u1234]]],
        [group_json(("segment", "country"), groups2, keys3[:2])],
        [group_json(("segment", "country", "plan"), groups3, keys3)[:100]],
        [group_json(("segment", "country"), {k: v for k, v in groups2.items() if k >= anchor}, keys3[:2])[:10]],
        [{"value": int(spend_of[s3].sum()), "count": int(s3.sum())}],
    ]))
    queries = [q.replace("RAREST", f'"{cty_key[rare]}"') for q in KEYED_QUERIES]
    want = {q: want[kq_] for q, kq_ in zip(queries, KEYED_QUERIES)}

    torch.cuda.synchronize()
    K.reset_launches()
    served, first_ms = {}, {}
    for q in queries:
        tq = time.perf_counter()
        served[q] = kq(q)
        first_ms[q] = (time.perf_counter() - tq) * 1e3
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    # the three-child GroupBy descends where 32 x 64 prefixes pass the tile
    # (at 4M columns: 5 shards, gmax 409), its depth 0 on rows_counts
    from pilosa_tpu_torch.exec.groupby import gmax
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    descends = len(KEYED_SEGMENTS) * len(COUNTRY_CODES) > gmax((n + 1) // SHARD_WIDTH + 1, WORDS_PER_ROW)
    for name in ("counts_cross", "gather_and", "plan_count", "bsi_sum") + (("rows_counts",) if descends else ()):
        check(launches[name] > 0, f"the keyed queries never launched {name}: {launches}")
    lat = {}
    for q in queries:
        got = json.loads(served[q])["results"]
        check(got == want[q], f"keyed {q}: {str(got)[:300]}, the model says {str(want[q])[:300]}")
        local = [wire.result_to_public_json(r) for r in srv.executor.execute("k", q)]
        check(got == local, f"keyed {q} differs from Executor.execute on the server's holder")
        body = q.encode()
        served_ms = host_p50_ms(lambda: http.raw("POST", "/index/k/query", body, "text/plain"))
        local_ms = host_p50_ms(lambda: srv.executor.execute("k", q))
        lat[q] = {"served_ms": served_ms, "in_process_ms": local_ms, "first_ms": first_ms[q]}
        print(f"keyed p50 {served_ms:.3f} ms served, {local_ms:.3f} ms in process, first {first_ms[q]:.1f} ms  {q}")
    print(
        f"keyed: {len(queries)} queries over {n} column keys equal the model and Executor.execute; ingest "
        f"{total_s:.1f} s; {len(groups2)} segment x country groups; launches {launches}"
    )
    return {"columns": n, "gen_s": gen_s, "ingest": ingest, "ingest_s": total_s, "query_p50_ms": lat,
            "launches": launches, "served": served}


# ---------------------------------------------------------------------------
# phase 6: durable storage — restart, offline tools and kill -9
# ---------------------------------------------------------------------------

MIN_FREE_BYTES = 2 << 30  # the serve phase's data dir holds about 0.5 GiB
KILL_SHARDS = 8  # the kill -9 node's index
KILL_BIG = 20_000  # bits per shard of its first /import requests (past max_op_n: snapshots)
KILL_BATCH = 5000  # writes per request: the CLI server's default max-writes-per-request


def _filesystem(path: str) -> str:
    """The mount point and type of the filesystem holding `path`."""
    import os

    path = os.path.realpath(path)
    best = ("/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[0]):
                best = (mnt, parts[2])
    return f"{best[0]} ({best[1]})"


def durable_dir() -> str:
    """A fresh data dir under the default temp dir; fails when its
    filesystem has less than MIN_FREE_BYTES free."""
    import os
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="chip_smoke_data_")
    free = shutil.disk_usage(d).free
    print(f"durable: data dir {d} on {_filesystem(d)}, {free} bytes free")
    check(free >= MIN_FREE_BYTES, f"data dir {d} on {_filesystem(d)} has {free} bytes free; the run needs {MIN_FREE_BYTES}")
    return d


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(path) for n in names)


def _cli_server(data_dir: str, sync_interval: float):
    """`python -m pilosa_tpu_torch.cli server` on a data dir and a free
    port: (process, uri)."""
    import select

    p = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir", data_dir,
         "--bind", "127.0.0.1:0", "--wal-sync-interval", str(sync_interval)],
        stderr=subprocess.PIPE, text=True,
    )
    ready, _, _ = select.select([p.stderr], [], [], 180)
    if not ready:
        p.kill()
        p.wait()
        fail(f"CLI server on {data_dir} printed nothing in 180 s")
    line = p.stderr.readline()
    m = re.search(r"listening on (http://\S+)", line)
    if m is None:
        p.kill()
        p.wait()
        fail(f"CLI server on {data_dir} said {line!r}")
    return p, m.group(1)


def _kill_state(http, S: int, depth_rows: int):
    """(f's bits as {(row, column)}, v's values as {column: value}, the
    keyed index kk's pairs as {(row key, column key)}) read back through
    export-roaring of every shard of both views and the CSV export of
    kk."""
    from pilosa_tpu_torch.core import roaring_io
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    bits, values = set(), {}
    for s in range(S):
        status, raw = http.raw("GET", f"/index/k/field/f/export-roaring/{s}")
        check(status == 200, f"export-roaring f shard {s}: HTTP {status}")
        pos = roaring_io.decode(raw)
        bits |= set(zip((pos // SHARD_WIDTH).tolist(), (pos % SHARD_WIDTH + s * SHARD_WIDTH).tolist()))
        status, raw = http.raw("GET", f"/index/k/field/v/export-roaring/{s}?view=bsig_v")
        check(status == 200, f"export-roaring bsig_v shard {s}: HTTP {status}")
        pos = roaring_io.decode(raw)
        rows, cols = (pos // SHARD_WIDTH).astype(np.int64), (pos % SHARD_WIDTH).astype(np.int64)
        mag = np.zeros(SHARD_WIDTH, np.int64)
        for r in range(2, 2 + depth_rows):
            mag[cols[rows == r]] |= 1 << (r - 2)
        mag[cols[rows == 1]] *= -1
        for c in cols[rows == 0].tolist():
            values[c + s * SHARD_WIDTH] = int(mag[c])
    status, raw = http.raw("GET", "/export?index=kk&field=f")
    check(status == 200, f"export kk/f: HTTP {status}")
    pairs = {tuple(line.split(",")) for line in raw.decode().splitlines() if line}
    return bits, values, pairs


def kill9_check(seed: int, sync_interval: float) -> dict:
    """A CLI server on a fresh data dir takes /import, import-value and
    PQL Set/Clear writes (the last ones after the last snapshot, so the
    WAL holds them), is SIGKILLed right after the last acknowledgement,
    and restarts: every acknowledged bit and value must read back
    (export-roaring of every shard, Count, Sum). With sync_interval > 0,
    writes acknowledged within the last interval may be lost; the count
    lost is printed, and every earlier one must be there."""
    import os
    import shutil
    import signal
    import tempfile

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    S = KILL_SHARDS

    def kq(http, query: str):
        return http.json("POST", "/index/k/query", query.encode(), "text/plain")["results"]

    rng = np.random.default_rng([seed, 6, int(sync_interval * 1000)])
    d = tempfile.mkdtemp(prefix="chip_smoke_kill_")
    p, uri = _cli_server(d, sync_interval)
    acked = []  # (monotonic time of the acknowledgement, write)
    try:
        http = _Http(uri)
        http.json("POST", "/index/k", {})
        http.json("POST", "/index/k/field/f", {})
        http.json("POST", "/index/k/field/v", {"options": {"type": "int", "min": -1_000_000, "max": 1_000_000}})
        http.json("POST", "/index/kk", {"options": {"keys": True}})
        http.json("POST", "/index/kk/field/f", {"options": {"keys": True}})

        def bits_write(rows, cols):
            out = http.json("POST", "/index/k/field/f/import", {"rows": rows.tolist(), "cols": cols.tolist()})
            check(out["errors"] == [], f"kill -9 /import: {out}")
            acked.append((time.monotonic(), ("bits", rows.tolist(), cols.tolist())))

        def values_write(cols, vals):
            out = http.json("POST", "/index/k/field/v/import-value", {"cols": cols.tolist(), "values": vals.tolist()})
            check(out["errors"] == [], f"kill -9 import-value: {out}")
            acked.append((time.monotonic(), ("values", cols.tolist(), vals.tolist())))

        def keyed_write(rkeys, ckeys):
            out = http.json("POST", "/index/kk/field/f/import", {"rowKeys": rkeys, "colKeys": ckeys})
            check(out["errors"] == [], f"kill -9 keyed /import: {out}")
            acked.append((time.monotonic(), ("kbits", list(zip(rkeys, ckeys)))))

        def rand_keys(n_pairs):
            return ([f"rk{int(x)}" for x in rng.integers(0, 8, n_pairs)],
                    [f"ck{int(x):06d}" for x in rng.integers(0, 40_000, n_pairs)])

        for _ in range(KILL_BIG // KILL_BATCH):  # keyed: its shard passes max_op_n too
            keyed_write(*rand_keys(KILL_BATCH))
        for s in range(S):  # big: each shard passes max_op_n, so its fragments snapshot
            for _ in range(KILL_BIG // KILL_BATCH):
                bits_write(rng.integers(0, 4, KILL_BATCH), rng.integers(0, SHARD_WIDTH, KILL_BATCH) + s * SHARD_WIDTH)
            vcols = np.unique(rng.integers(0, SHARD_WIDTH, KILL_BATCH) + s * SHARD_WIDTH)
            values_write(vcols, rng.integers(-1_000_000, 1_000_001, len(vcols)))
        for k in range(40):  # small: these stay in the WAL
            if k % 4 == 0:
                bits_write(rng.integers(0, 4, 50), rng.integers(0, S * SHARD_WIDTH, 50))
            elif k % 4 == 1:
                vcols = np.unique(rng.integers(0, S * SHARD_WIDTH, 20))
                values_write(vcols, rng.integers(-999, 1000, len(vcols)))
            elif k % 4 == 2:
                r, c = int(rng.integers(0, 4)), int(rng.integers(0, S * SHARD_WIDTH))
                check(kq(http, f"Set({c}, f={r})") in ([True], [False]), "kill -9 Set")
                acked.append((time.monotonic(), ("set", r, c)))
                (rk,), (ck,) = rand_keys(1) if k % 8 == 2 else ([f"rk-new-{k}"], [f"ck-new-{k}"])
                out = http.json("POST", "/index/kk/query", f'Set("{ck}", f="{rk}")'.encode(), "text/plain")
                check(out["results"] in ([True], [False]), f"kill -9 keyed Set: {out}")
                acked.append((time.monotonic(), ("kbits", [(rk, ck)])))
            else:
                w = acked[int(rng.integers(0, len(acked)))][1]
                if w[0] == "bits":
                    r, c = w[1][0], w[2][0]
                    check(kq(http, f"Clear({c}, f={r})") in ([True], [False]), "kill -9 Clear")
                    acked.append((time.monotonic(), ("clear", r, c)))
        t_kill = time.monotonic()
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        http.close()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stderr.close()
    wal_bytes = sum(
        os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(d) for n in ns if n.endswith(".wal")
    )
    n_snaps = sum(n.endswith(".snap") for _, _, ns in os.walk(d) for n in ns)
    check(wal_bytes > 0 and n_snaps > 0, f"kill -9: {n_snaps} snapshots and {wal_bytes} WAL bytes before the kill")

    def expect(writes):
        bits, values, pairs = set(), {}, set()
        for w in writes:
            if w[0] == "bits":
                bits |= set(zip(w[1], w[2]))
            elif w[0] == "values":
                values.update(zip(w[1], w[2]))
            elif w[0] == "set":
                bits.add((w[1], w[2]))
            elif w[0] == "kbits":
                pairs |= set(w[1])
            else:
                bits.discard((w[1], w[2]))
        return bits, values, pairs

    t0 = time.perf_counter()
    p, uri = _cli_server(d, sync_interval)
    recovery_s = time.perf_counter() - t0
    try:
        http = _Http(uri)
        got = _kill_state(http, S, 21)
        writes = [w for _, w in acked]
        n_ok = len(writes)
        while n_ok >= 0 and expect(writes[:n_ok]) != got:
            n_ok -= 1
        check(n_ok >= 0, "kill -9: the restarted node's state is no prefix of the acknowledged writes")
        lost = len(writes) - n_ok
        if sync_interval == 0:
            check(lost == 0, f"kill -9: {lost} acknowledged writes lost in strict mode")
        else:
            early = [t for t, _ in acked[n_ok:] if t < t_kill - sync_interval]
            check(not early, f"kill -9: {len(early)} writes acknowledged before the last sync interval were lost")
        bits, values, pairs = expect(writes[:n_ok])
        for r in range(4):
            check(kq(http, f"Count(Row(f={r}))") == [sum(1 for b in bits if b[0] == r)], f"kill -9: Count(Row(f={r}))")
        vals = list(values.values())
        check(kq(http, "Sum(field=v)") == [{"value": int(sum(vals)), "count": len(vals)}], "kill -9: Sum(field=v)")
        http.close()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=60)
        check(rc == 0, f"kill -9: the restarted CLI server exited {rc} on SIGTERM")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stderr.close()
    shutil.rmtree(d, ignore_errors=True)
    print(
        f"durable: kill -9 (wal-sync-interval {sync_interval}): {len(acked)} acknowledged writes "
        f"({len(bits)} bits, {len(values)} values, {len(pairs)} keyed pairs), {n_snaps} snapshots and {wal_bytes} "
        f"WAL bytes at the kill; restart {recovery_s:.2f} s; {lost} lost; every acknowledged bit, value and "
        "keyed pair read back"
    )
    return {"sync_interval": sync_interval, "acked": len(acked), "lost": lost, "recovery_s": recovery_s,
            "wal_bytes": wal_bytes, "snapshots": n_snaps}


def durable_path(args, st) -> dict:
    """Phase 6 on the serve phase's stopped data dir: a second NodeServer
    recovers it (timed to its first 200 on /status) and must give every
    served answer again, byte for byte, through the six kernels; then
    `inspect` and `check`, while two CLI servers take writes and are
    killed -9 on dirs of their own."""
    import os

    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server import NodeServer, wire

    d = st["data_dir"]
    torch.cuda.empty_cache()  # the first node is stopped: its memory goes back
    dir_bytes = _dir_bytes(d)
    n_files = sum(len(ns) for _, _, ns in os.walk(d))
    print(f"durable: data dir {dir_bytes} bytes in {n_files} files")

    # (a) recovery: construction to a 200 on /status
    t0 = time.perf_counter()
    srv = NodeServer(d, "smoke2", bind="127.0.0.1:0", max_writes_per_request=0, cache_result_mb=0).start()
    http = _Http(srv.node.uri)
    try:
        status = http.json("GET", "/status")
        recovery_s = time.perf_counter() - t0
        check(status["state"] == "NORMAL", f"recovered node: /status {status}")
        print(f"durable: recovery {recovery_s:.2f} s (NodeServer on {srv.holder.device} to a 200 on /status)")

        # (b) the served query set, first pass, launches counted for it alone
        torch.cuda.synchronize()
        K.reset_launches()
        first_ms = {}
        for q in SERVE_QUERIES:
            tq = time.perf_counter()
            status, raw = http.raw("POST", "/index/s/query", q.encode(), "text/plain")
            first_ms[q] = (time.perf_counter() - tq) * 1e3
            check(status == 200, f"recovered {q}: HTTP {status}: {raw[:300]!r}")
            check(raw == st["served"][q], f"recovered {q}: {raw[:300]!r}, before the restart {st['served'][q][:300]!r}")
            check(json.loads(raw)["results"] == st["want"][q], f"recovered {q} differs from numpy")
            print(f"durable: first pass {first_ms[q]:.1f} ms  {q}")
        # Rows, GroupBy and every keyed body: byte for byte the pre-restart ones
        for index, bodies in (
            ("s", {q: st["served"][q] for q in SERVE_GROUP_QUERIES}), ("k", st["keyed_served"]), ("s", st["time_served"]),
        ):
            for q, before in bodies.items():
                tq = time.perf_counter()
                status, raw = http.raw("POST", f"/index/{index}/query", q.encode(), "text/plain")
                first_ms[q] = (time.perf_counter() - tq) * 1e3
                check(status == 200 and raw == before, f"recovered {index} {q}: {raw[:300]!r}, before {before[:300]!r}")
        for (qs, q), before in st["attrs_served"].items():
            status, raw = http.raw("POST", "/index/s/query" + qs, q.encode(), "text/plain")
            check(status == 200 and raw == before, f"recovered s {q}{qs}: {raw[:300]!r}, before {before[:300]!r}")
        print(
            f"durable: {len(SERVE_GROUP_QUERIES)} Rows/GroupBy, {len(st['keyed_served'])} keyed, "
            f"{len(st['time_served'])} time bodies (time views reopened from the data dir) and {len(st['attrs_served'])} "
            "attribute bodies (the attribute logs replayed) equal the pre-restart ones"
        )
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"the recovered queries never launched {name}: {launches}")
        for q in SERVE_QUERIES:
            local = [wire.result_to_public_json(r) for r in srv.executor.execute("s", q)]
            check(json.loads(st["served"][q])["results"] == local, f"recovered {q}: Executor.execute differs")
        lat = {}
        for q in SERVE_QUERIES:
            body = q.encode()
            served_ms = host_p50_ms(lambda: http.raw("POST", "/index/s/query", body, "text/plain"))
            local_ms = host_p50_ms(lambda: srv.executor.execute("s", q))
            lat[q] = {"served_ms": served_ms, "in_process_ms": local_ms}
            print(f"durable p50 {served_ms:.3f} ms served, {local_ms:.3f} ms in process  {q}")
        print(
            f"durable: {len(SERVE_QUERIES)} recovered answers equal the pre-restart bodies and numpy; first pass "
            f"{sum(first_ms[q] for q in SERVE_QUERIES) / 1e3:.2f} s; launches {launches}"
        )
    finally:
        http.close()
        srv.stop()
    torch.cuda.empty_cache()

    # (c) the offline tools on the stopped dir: `inspect` of the keyed
    # index (every index until PR 11: it materializes every fragment's
    # bits), `check` of every file; (d) meanwhile kill -9, strict and with
    # a sync interval, each node on a fresh dir of its own (the tools read
    # the disk, the nodes mostly start processes and answer HTTP)
    with ThreadPoolExecutor(2) as pool:
        kill_runs = [pool.submit(kill9_check, args.seed, si) for si in (0.0, 0.2)]
        tools = offline_tools(d)
        kills = [k.result() for k in kill_runs]
    return {
        "recovery_s": recovery_s,
        "first_pass_ms": first_ms,
        "first_pass_s": sum(first_ms[q] for q in SERVE_QUERIES) / 1e3,
        "query_p50_ms": lat,
        "launches": launches,
        "data_dir_bytes": dir_bytes,
        "data_dir_files": n_files,
        "tools": tools,
        "kill9": kills,
    }


# ---------------------------------------------------------------------------
# phase 7: the cluster, three CLI nodes on the card
# ---------------------------------------------------------------------------

CLUSTER_SHARDS = 512  # 2^29 columns, like the serve phase
CLUSTER_NODES = ("n0", "n1", "n2")
# the dense rows' densities 2^-d (bitmap and array containers): a field's
# rows are nested, each the AND of the one before it and a fresh draw
CLUSTER_F_DENSE_DRAWS = (4, 5, 6, 7)
CLUSTER_G_DENSE_DRAWS = (5, 6, 7, 8)
CLUSTER_SPARSE_BITS = 1000  # bits a shard of each sparse row (f rows 4-7, h rows 0-7)
CLUSTER_VALUE_SHARDS = 64  # shards of `amount` through /import-value
CLUSTER_VALUE_DENSITY = 64  # one column in 64 holds a value
CLUSTER_KEYS = 1 << 16  # column keys of index ck
CLUSTER_ROW_KEYS = 8  # row keys of its keyed field kf
CLUSTER_REPS = 5  # runs per served p50 at n0
CLUSTER_QUERIES = [
    "Count(Row(f=0))",
    "Count(Intersect(Row(f=0), Row(g=1)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=0)))",
    "Count(Difference(Row(f=0), Row(g=0)))",
    "Count(Xor(Row(f=1), Row(g=2)))",
    "Count(Not(Row(f=0)))",
    "Count(Row(f=0))Count(Row(f=1))Count(Intersect(Row(f=2), Row(g=3)))",
    "Row(f=4)",
    "Intersect(Row(f=5), Row(g=0))",
    "Shift(Row(f=6), n=1)",
    "TopN(f, n=5)",
    "TopN(f, Row(g=0), n=5)",
    "Rows(f)",
    "GroupBy(Rows(h), Rows(g))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
    "Sum(field=amount)",
    "Min(field=amount)",
    "Max(Row(g=1), field=amount)",
    "Count(Row(amount > 500000))",
    # a Shift's carry crosses into the next shard, which another node may
    # answer: each shard is counted once, with its predecessor's carry
    "Count(Shift(Row(h=0), n=2000))",
    "Count(Intersect(Shift(Row(f=0), n=1), Row(g=1)))",
    "Sum(Shift(Row(h=1), n=2000), field=amount)",
    # MinRow/MaxRow legs cross the wire; GroupBy's offset pages the merged groups
    "MinRow(field=h)",
    "MaxRow(field=f)",
    "GroupBy(Rows(h), Rows(g), offset=3)",
    "GroupBy(Rows(h), Rows(g), offset=3, limit=5)",
]
CLUSTER_KEYED_QUERIES = ['Row(kf="k9")', 'Count(Row(kf="k3"))', "TopN(kf, n=3)"]
# every kernel a cluster query runs on some node (amount's 21 planes stream
# at the default slab of 16: Min/Max on the min/max step, the condition
# Count on the range step; the batched Counts are one plan_count_multi a
# leg; the 3-child GroupBy descends, gather_and building its prefixes)
CLUSTER_KERNELS = (
    "plan_count", "plan_count_multi", "plan_rows", "gather_tally", "counts_cross", "gather_and",
    "bsi_sum", "bsi_min_max_step", "bsi_range_step",
)


# anti-entropy: while n2 is down, n0 takes a new row of f on
# CLUSTER_AE_SHARDS shards n2 owns as primary and as many as replica, Sets
# of it on CLUSTER_AE_SETS more, and row and column attributes
CLUSTER_AE_ROW = 8  # f's rows 0-7 hold the data above
CLUSTER_AE_SHARDS = 16
CLUSTER_AE_SETS = 4
CLUSTER_AE_SAMPLES = 16  # other (field, shard) pairs whose owners' digests must agree
CLUSTER_AE_ROW_ATTRS = {"label": "downtime", "rank": 3}
CLUSTER_AE_COL_ATTRS = {"city": "x"}


def downtime_writes(http0, seed: int, S: int) -> dict:
    """Phase 7's writes through n0 while n2 is down: row CLUSTER_AE_ROW of
    f on shards n2 owns (CLUSTER_SPARSE_BITS bits each, one `/import`),
    Sets of it on CLUSTER_AE_SETS more shards n2 owns, a SetRowAttrs and a
    SetColumnAttrs. Sets only: at replica 2 the merge is a union, so a
    Clear n2 missed would come back (the CPU tests hold that property to
    the reference)."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng([seed, 17])
    prim, repl, more = [], [], []
    for s in rng.permutation(S).tolist():
        ids = [n["id"] for n in http0.json("GET", f"/internal/fragment/nodes?index=c&shard={s}")]
        if "n2" not in ids:
            continue
        if len(more) < CLUSTER_AE_SETS:
            more.append(s)
        elif ids[0] == "n2" and len(prim) < CLUSTER_AE_SHARDS:
            prim.append(s)
        elif ids[0] != "n2" and len(repl) < CLUSTER_AE_SHARDS:
            repl.append(s)
    check(prim and repl and more, f"cluster: n2 owns too few shards of {S} for the downtime writes")
    shards = sorted(prim + repl)
    cols = {s: np.unique(rng.integers(0, SHARD_WIDTH, CLUSTER_SPARSE_BITS).astype(np.uint64)) for s in shards}
    abs_cols = np.concatenate([c + np.uint64(s * SHARD_WIDTH) for s, c in cols.items()])
    out = http0.json("POST", "/index/c/field/f/import", {"rows": [CLUSTER_AE_ROW] * len(abs_cols), "cols": abs_cols.tolist()})
    check(out["errors"] and out["applied"] < out["expected"], f"cluster: the import with n2 down: {str(out)[:300]}")
    set_cols = [s * SHARD_WIDTH + int(rng.integers(0, SHARD_WIDTH)) for s in more]
    for col in set_cols:
        got = http0.json("POST", "/index/c/query", f"Set({col}, f={CLUSTER_AE_ROW})".encode(), "text/plain")
        check(got == {"results": [True]}, f"cluster: Set({col}) with n2 down: {got}")
    row_attrs = ", ".join(f"{k}={json.dumps(v)}" for k, v in CLUSTER_AE_ROW_ATTRS.items())
    col_attrs = ", ".join(f"{k}={json.dumps(v)}" for k, v in CLUSTER_AE_COL_ATTRS.items())
    attr_col = int(abs_cols[0])
    for q in (f"SetRowAttrs(f, {CLUSTER_AE_ROW}, {row_attrs})", f"SetColumnAttrs({attr_col}, {col_attrs})"):
        http0.json("POST", "/index/c/query", q.encode(), "text/plain")
    return {"shards": shards, "primary": prim, "replica": repl, "set_shards": more, "cols": cols,
            "set_cols": set_cols, "attr_col": attr_col, "bits": int(len(abs_cols))}


def _pass_lines(n) -> list:
    """The anti-entropy pass lines a node logged, in order."""
    return [json.loads(ln.split("anti-entropy pass ", 1)[1]) for ln in list(n.lines) if "anti-entropy pass {" in ln]


def _sync(n, http, label: str) -> dict:
    """POST /internal/sync until a pass runs on n (a pass a peer's debt
    nudge started may be running: `ran` false); its reply, the wall
    seconds of the POST that ran and the line the node logged for it."""
    n_before = len(_pass_lines(n))
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        r = http.json("POST", "/internal/sync")
        dt = time.perf_counter() - t
        if r["ran"]:
            break
        check(time.perf_counter() - t_start < 300, f"cluster {label} {n.nid}: no pass ran in 300 s")
        time.sleep(0.2)
    t = time.perf_counter()
    while len(_pass_lines(n)) == n_before and time.perf_counter() - t < 10:
        time.sleep(0.02)  # the node's stderr reaches us on a thread
    lines = _pass_lines(n)
    check(len(lines) > n_before, f"cluster {label} {n.nid}: the pass logged no line")
    line = lines[-1]
    print(f"cluster {label} {n.nid}: pass {dt:.2f} s ({line['seconds']:.2f} s in the node), synced {r['synced']}, "
          f"reached {len(r['reached'])}, fragments {line['fragments']}, blocks merged {line['blocks']}, bits applied "
          f"{line['bits_applied']}, bits sent {line['bits_sent']}; restage_bytes {line['restage_bytes_before']} -> "
          f"{line['restage_bytes_after']}")
    return {"node": n.nid, "seconds": dt, "synced": r["synced"], "reached": len(r["reached"]), "pass": line}


def anti_entropy_check(nodes, down: dict, seed: int, S: int, status_of) -> dict:
    """After n2's restart: its copies of the written shards differ from
    their co-owners'; one `POST /internal/sync` on n0, n1 and n2 in turn
    repays every node's debt and leaves both owners' block digests equal
    on every written shard and on CLUSTER_AE_SAMPLES more (field, shard)
    pairs (each node's debt nudges are waited for before the next
    node's pass); then one more pass a node, with nothing drifted,
    repairs nothing and moves no node's `restage_bytes` (each node's
    count at the end of its repairing pass equals the count after its
    clean pass: no query ran in between)."""
    t_phase = time.perf_counter()
    https = {n.nid: _Http(n.uri) for n in nodes}
    by_id = {n.nid: n for n in nodes}
    try:
        def owners(shard):
            return [n["id"] for n in https["n0"].json("GET", f"/internal/fragment/nodes?index=c&shard={shard}")]

        def blocks(nid, field, view, shard):
            q = f"index=c&field={field}&view={view}&shard={shard}"
            return https[nid].json("GET", f"/internal/fragment/blocks?{q}")["blocks"]

        drifted = sum(blocks(a, "f", "standard", s) != blocks(b, "f", "standard", s)
                      for s in down["shards"] for a, b in [owners(s)])
        check(drifted >= 1, "cluster: n2's copies of the shards written while it was down equal their co-owners'")
        print(f"cluster: n2 restarted: f's block digests differ from the co-owner's on {drifted} of "
              f"{len(down['shards'])} written shards")
        passes = []
        for n in nodes:
            p = _sync(n, https[n.nid], "anti-entropy")
            # the reply comes once the local pass is done; the nudges that
            # ask the primaries of shards it holds no copy of for a pass
            # run on after it. Wait for them: a pass started meanwhile
            # would make a nudge's pass answer `ran` false, and that debt
            # would wait for the next pass here
            t = time.perf_counter()
            while status_of(n)["pendingRepairs"]:
                check(time.perf_counter() - t < 120, f"cluster: {n.nid}'s pendingRepairs 120 s after its pass: {status_of(n)}")
                time.sleep(0.1)
            p["nudges_s"] = time.perf_counter() - t
            passes.append(p)
            print(f"cluster anti-entropy {n.nid}: its pendingRepairs 0 {p['nudges_s']:.2f} s after its reply")
        pending = {n.nid: status_of(n)["pendingRepairs"] for n in nodes}
        check(not any(pending.values()), f"cluster: pendingRepairs {pending} after the passes")
        rng = np.random.default_rng([seed, 19])
        pairs = [("f", "standard", s) for s in down["shards"] + down["set_shards"]]
        kinds = [("f", "standard", S), ("g", "standard", S), ("h", "standard", S), ("_exists", "standard", S),
                 ("amount", "bsig_amount", min(S, CLUSTER_VALUE_SHARDS))]
        n_written = len(pairs)
        while len(pairs) < n_written + CLUSTER_AE_SAMPLES:
            fld, view, n_sh = kinds[int(rng.integers(len(kinds)))]
            pair = (fld, view, int(rng.integers(n_sh)))
            if pair not in pairs:
                pairs.append(pair)
        for fld, view, s in pairs:
            a, b = owners(s)
            ba, bb = blocks(a, fld, view, s), blocks(b, fld, view, s)
            check(ba == bb and len(ba) > 0, f"cluster: {fld}/{view} shard {s}: {a}'s and {b}'s block digests differ after the sync")
        print(f"cluster: pendingRepairs 0 on every node; both owners' block digests "
              f"equal on {n_written} written (f, shard) pairs and {CLUSTER_AE_SAMPLES} more")
        clean = [_sync(n, https[n.nid], "clean") for n in nodes]
        for c in clean:
            check(c["synced"] == 0 and c["pass"]["blocks"] == 0, f"cluster: a clean pass on {c['node']} repaired: {c}")
        restage = {}
        for n in nodes:
            lines = _pass_lines(n)
            before, last = lines[-2], lines[-1]
            restage[n.nid] = (before["restage_bytes_after"], last["restage_bytes_before"], last["restage_bytes_after"])
            check(len(set(restage[n.nid])) == 1, f"cluster: restage_bytes moved on {n.nid} over the clean passes: {restage[n.nid]}")
        pending = {n.nid: status_of(n)["pendingRepairs"] for n in nodes}
        check(not any(pending.values()), f"cluster: pendingRepairs {pending} after the clean passes")
        # every repairing pass, the ones the debt nudges started included
        repairing = [ln for n in nodes for ln in _pass_lines(n)[:-1]]
        totals = {k: sum(ln[k] for ln in repairing) for k in ("seconds", "fragments", "blocks", "bits_applied", "bits_sent")}
        totals["passes"] = len(repairing)
        print(f"cluster: {len(repairing)} repairing passes in all (nudged ones included): "
              + ", ".join(f"{k} {v:.2f}" if k == "seconds" else f"{k} {v}" for k, v in totals.items() if k != "passes"))
        print(f"cluster: clean passes repaired nothing; restage_bytes (after the repairing pass, before and after the "
              f"clean pass) {restage}")
    finally:
        for h in https.values():
            h.close()
    return {"drifted_shards": drifted, "passes": passes, "repairing_totals": totals, "digest_pairs": len(pairs),
            "clean": clean, "restage_bytes": restage, "phase_s": time.perf_counter() - t_phase,
            "pending_at_n0": down.get("pending_at_n0")}


def _free_ports(n: int):
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _Node:
    """One `python -m pilosa_tpu_torch.cli server` process of the cluster,
    its stderr drained into `lines` by a thread."""

    def __init__(self, nid: str, data_dir: str, port: int, hosts, extra=()):
        """`hosts` None: no --cluster-hosts (a node that joins)."""
        import threading

        self.nid, self.data_dir, self.port, self.hosts, self.extra = nid, data_dir, port, hosts, list(extra)
        self.uri = f"http://127.0.0.1:{port}"
        self.lines = []
        self.t_launch = time.perf_counter()
        membership = [] if hosts is None else ["--cluster-hosts", hosts]
        self.p = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir", data_dir,
             "--bind", f"127.0.0.1:{port}", "--node-id", nid] + membership + ["--replicas", "2",
             "--probe-interval", "0.5", "--max-writes-per-request", "0", "--cache-result-mb", "0"] + self.extra,
            stderr=subprocess.PIPE, text=True,
        )
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self):
        for line in self.p.stderr:
            self.lines.append(line.rstrip("\n"))

    def wait_listening(self, timeout: float = 180.0):
        """Seconds from the launch to the node's `listening on` line."""
        while time.perf_counter() - self.t_launch < timeout:
            if any("listening on" in ln for ln in self.lines):
                return time.perf_counter() - self.t_launch
            if self.p.poll() is not None:
                break
            time.sleep(0.05)
        fail(f"cluster node {self.nid} did not start: exit {self.p.poll()}, stderr {self.lines[-10:]}")

    def launches(self) -> dict:
        """The kernel launches the node logged as it stopped."""
        for ln in reversed(self.lines):
            m = re.search(r"stopped; kernel launches (\{.*\})", ln)
            if m:
                return json.loads(m.group(1))
        fail(f"cluster node {self.nid} logged no kernel launches: {self.lines[-5:]}")

    def stop(self, timeout: float = 60.0) -> int:
        import signal

        if self.p.poll() is None:
            self.p.send_signal(signal.SIGTERM)
            try:
                self.p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait()
        self._t.join(timeout=10)
        return self.p.returncode

    def kill9(self):
        self.p.kill()
        self.p.wait()
        self._t.join(timeout=10)


def _roaring_shard(dense, sparse) -> bytes:
    """A pilosa-dialect roaring body of one shard: `dense` is [(row, [W]
    uint32 words)], `sparse` [(row, sorted in-shard positions)]. A 2^16-bit
    container with more than 4096 bits is a bitmap container (its words
    as they are), else an array container."""
    import struct

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    per_row = SHARD_WIDTH >> 16
    conts = []  # (key, type, n, payload)
    for r, words in dense:
        chunks = words.reshape(per_row, 2048)
        counts = _LUT[chunks.view(np.uint8)].sum(axis=1, dtype=np.int64)
        pos = np.flatnonzero(_bits(words))  # the row's columns, for array containers
        ends = np.cumsum(counts)
        for k, n in enumerate(counts.tolist()):
            if n > 4096:
                conts.append((r * per_row + k, 2, n, chunks[k].tobytes()))
            elif n:
                lows = (pos[ends[k] - n : ends[k]] & 0xFFFF).astype("<u2")
                conts.append((r * per_row + k, 1, n, lows.tobytes()))
    for r, pos in sparse:
        hi = (pos >> np.uint64(16)).astype(np.int64)
        for k in np.unique(hi).tolist():
            lows = (pos[hi == k] & np.uint64(0xFFFF)).astype("<u2")
            conts.append((r * per_row + k, 1, len(lows), lows.tobytes()))
    conts.sort(key=lambda c: c[0])
    head = struct.pack("<HBBI", 12348, 0, 0, len(conts))
    desc = b"".join(struct.pack("<QHH", key, t, n - 1) for key, t, n, _ in conts)
    off, offs = 8 + 16 * len(conts), []
    for c in conts:
        offs.append(struct.pack("<I", off))
        off += len(c[3])
    return head + desc + b"".join(offs) + b"".join(c[3] for c in conts)


# the resize: n3 joins under a writer of f row 9 (1001 bits a shard), then leaves
CLUSTER_JOIN_ROW = CLUSTER_AE_ROW + 1
CLUSTER_JOIN_BATCH_SHARDS = 16  # shards a writer request covers (16,000 bits)
CLUSTER_JOIN_PACE = 0.3  # s between the writer's requests
CLUSTER_N3_REPS = 9  # n3's warm runs of its p50 query
CLUSTER_N3_QUERY = "Count(Intersect(Row(f=0), Row(g=1)))"
# kernels n3's legs of the query set run (the BSI ones where it holds amount)
RESIZE_N3_KERNELS = ("plan_count", "plan_count_multi", "plan_rows", "gather_tally", "counts_cross", "gather_and")
BSI_N3_KERNELS = ("bsi_sum", "bsi_min_max_step", "bsi_range_step")


def _cleaner_lines(n) -> list:
    """The holder-cleaner lines a node logged, in order."""
    return [json.loads(ln.split("holder cleaner ", 1)[1]) for ln in list(n.lines) if "holder cleaner {" in ln]


def _job_of(http) -> dict:
    return http.json("GET", "/cluster/resize/job")


def _wait_job(http, label: str, timeout: float = 900.0) -> dict:
    """Poll the coordinator's job record until it is no longer RUNNING."""
    t = time.perf_counter()
    while True:
        job = _job_of(http)
        if job["state"] not in ("RUNNING", "NONE"):
            return job
        check(time.perf_counter() - t < timeout, f"cluster {label}: the resize job still {job['state']} after {timeout} s")
        time.sleep(0.1)


def resize_steps(args, nodes, server_args, base_dir, S, want_with, row8, words_of, cols_of, ask_all, status_of) -> dict:
    """Phase 7's resize: n3 joins the loaded cluster under a writer, the
    cluster answers as one node over 4, the cleaner leaves each node its
    own fragments; then n3 leaves and the same holds over 3. `nodes` is
    n0-n2 (n0 the coordinator); returns what was measured, n3's launches
    included."""
    import os
    import threading

    from pilosa_tpu_torch.cluster.topology import Cluster, Node
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    t_phase = time.perf_counter()
    out = {}
    http0 = _Http(nodes[0].uri)
    rng = np.random.default_rng([args.seed, 23])
    # one bit a shard more than the sparse rows' 1000 draws: TopN's first
    # pass takes each shard's top n from its rank cache, ties by lowest id,
    # so a row tied with rows 4-7 in every shard would never be a candidate
    f9 = [np.sort(rng.choice(SHARD_WIDTH, CLUSTER_SPARSE_BITS + 1, replace=False)).astype(np.uint64) for _ in range(S)]
    row9 = (CLUSTER_JOIN_ROW, words_of(f9), cols_of(f9), {})
    batches = [list(range(s0, min(S, s0 + CLUSTER_JOIN_BATCH_SHARDS))) for s0 in range(0, S, CLUSTER_JOIN_BATCH_SHARDS)]
    w = {"acked_bits": 0, "acked": 0, "retries_503": 0, "during_job": 0, "replica_misses": 0, "failed": None}

    def writer():
        """Every batch once, then the batches again (the same bits) while
        the job runs, so that some requests meet the cutover barrier."""
        c = _Http(nodes[0].uri)
        i = 0
        try:
            while i < len(batches) or job_running.is_set():
                b = batches[i % len(batches)]
                i += 1
                cols = np.concatenate([f9[s] + np.uint64(s * SHARD_WIDTH) for s in b])
                body = {"rows": [CLUSTER_JOIN_ROW] * len(cols), "cols": cols.tolist()}
                t_end = time.perf_counter() + 300
                while True:
                    status, raw = c.raw("POST", "/index/c/field/f/import", body)
                    if status == 200:
                        break
                    if status == 503 and time.perf_counter() < t_end:
                        w["retries_503"] += 1
                        time.sleep(0.1)
                        continue
                    w["failed"] = f"HTTP {status}: {raw[:300]!r}"
                    return
                res = json.loads(raw)
                w["acked"] += 1
                if i <= len(batches):
                    w["acked_bits"] += len(cols)
                w["replica_misses"] += len(res.get("errors", []))
                if job_running.is_set():
                    w["during_job"] += 1
                time.sleep(CLUSTER_JOIN_PACE)
        finally:
            c.close()

    def placement(ids):
        return Cluster(nodes=[Node(id=i) for i in ids], replica_n=2)

    def check_holdings(live, cl, label):
        """Each live node holds exactly the fragments `cl` assigns it: every
        shard of f, g, h and _exists, amount's on its 64 shards, ck's on 0."""
        held = {}
        for n in live:
            c = _Http(n.uri)
            try:
                frags = c.json("GET", "/internal/index/c/fragments")["frags"]
                frags_k = c.json("GET", "/internal/index/ck/fragments")["frags"]
            finally:
                c.close()
            mine = {s for s in range(S) if any(o.id == n.nid for o in cl.shard_nodes("c", s))}
            for fld, n_sh in (("f", S), ("g", S), ("h", S), ("_exists", S), ("amount", min(S, CLUSTER_VALUE_SHARDS))):
                got = {sh for fl, _, sh in frags if fl == fld}
                want_sh = {s for s in mine if s < n_sh}
                check(got == want_sh, f"cluster {label}: {n.nid} holds {fld} on {len(got)} shards, the placement assigns "
                      f"{len(want_sh)} (extra {sorted(got - want_sh)[:8]}, missing {sorted(want_sh - got)[:8]})")
            owns_k0 = any(o.id == n.nid for o in cl.shard_nodes("ck", 0))
            check({sh for _, _, sh in frags_k} == ({0} if owns_k0 else set()), f"cluster {label}: {n.nid}'s ck fragments {frags_k}")
            held[n.nid] = len(frags) + len(frags_k)
        return held

    def check_cleaner(live, before_counts, label):
        """The cleaner's line a node logged in this job: a node it took
        fragments from holds fewer device-resident bytes after it."""
        runs = {}
        for n in live:
            lines = _cleaner_lines(n)[before_counts.get(n.nid, 0):]
            check(len(lines) == 1, f"cluster {label}: {n.nid} logged {len(lines)} holder-cleaner lines")
            ln = lines[0]
            if ln["removed"]:
                check(ln["resident_bytes_after"] < ln["resident_bytes_before"],
                      f"cluster {label}: {n.nid}'s cleaner removed {ln['removed']} fragments, resident bytes {ln}")
            runs[n.nid] = ln
        print(f"cluster {label}: holder cleaner per node (fragments removed, device-resident bytes before -> after): "
              + ", ".join(f"{k} {v['removed']} ({v['resident_bytes_before']} -> {v['resident_bytes_after']})" for k, v in runs.items()))
        return runs

    def wait_settled(live, n_members, label):
        t = time.perf_counter()
        while True:
            sts = {n.nid: status_of(n) for n in live}
            if all(len(st["nodes"]) == n_members and st["state"] == "NORMAL" for st in sts.values()):
                return time.perf_counter() - t
            check(time.perf_counter() - t < 300, f"cluster {label}: not {n_members} NORMAL members: "
                  + str({k: (len(v["nodes"]), v["state"]) for k, v in sts.items()}))
            time.sleep(0.2)

    def repay(live, label):
        """A pass on each node that owes a repair (waiting for its
        nudges; the job's own passes usually left none), then a clean
        pass on the last node: it repairs nothing and moves no
        restage_bytes, and no node owes a repair."""
        debt = {n.nid: status_of(n)["pendingRepairs"] for n in live}
        passes = []
        for n in live:
            if not status_of(n)["pendingRepairs"]:
                continue
            c = _Http(n.uri)
            try:
                passes.append(_sync(n, c, label))
            finally:
                c.close()
            t = time.perf_counter()
            while status_of(n)["pendingRepairs"]:
                check(time.perf_counter() - t < 120, f"cluster {label}: {n.nid}'s pendingRepairs 120 s after its pass: {status_of(n)}")
                time.sleep(0.1)
        c = _Http(live[-1].uri)
        try:
            clean = _sync(live[-1], c, label + " clean")
        finally:
            c.close()
        line = clean["pass"]
        check(clean["synced"] == 0 and line["blocks"] == 0 and line["restage_bytes_before"] == line["restage_bytes_after"],
              f"cluster {label}: the clean pass on {live[-1].nid} repaired or re-staged: {line}")
        pending = {n.nid: status_of(n)["pendingRepairs"] for n in live}
        check(not any(pending.values()), f"cluster {label}: pendingRepairs {pending} after the passes")
        print(f"cluster {label}: pendingRepairs {debt} before the passes, 0 after; the clean pass on {live[-1].nid} "
              f"{line['seconds']:.2f} s, restage_bytes {line['restage_bytes_before']} -> {line['restage_bytes_after']}")
        return {"debt_before": debt, "passes": [p["pass"] for p in passes], "clean": line}

    def job_line(job, label):
        st = job["stats"]
        print(f"cluster {label}: job {job['state']} in {st['seconds']:.2f} s: {st['legs']} legs, {st['bytes_streamed']} bytes "
              f"streamed, {st['catchup_rounds']} catch-up rounds, {st['delta_positions']} delta positions, "
              f"{len(job['moved'])} (index, shard, node) moves")
        return dict(st, moved=len(job["moved"]), state=job["state"])

    try:
        # every node stages the rows its legs read (the cleaner then frees them)
        want8 = want_with([row8])
        for n in nodes:
            c = _Http(n.uri)
            try:
                got = c.json("POST", "/index/c/query", CLUSTER_N3_QUERY.encode(), "text/plain")["results"]
            finally:
                c.close()
            check(got == want8[CLUSTER_N3_QUERY], f"cluster before the join {n.nid}: {got}, numpy {want8[CLUSTER_N3_QUERY]}")
        cleaned0 = {n.nid: len(_cleaner_lines(n)) for n in nodes}
        port3 = _free_ports(1)[0]
        t0 = time.perf_counter()
        n3 = _Node("n3", os.path.join(base_dir, "n3"), port3, None, list(server_args) + ["--join", nodes[0].uri])
        job_running = threading.Event()
        wt = threading.Thread(target=writer, name="join-writer")
        try:
            # the writer starts with the job
            while _job_of(http0)["state"] == "NONE":
                check(n3.p.poll() is None, f"n3 exited {n3.p.poll()}: {n3.lines[-10:]}")
                check(time.perf_counter() - t0 < 300, "cluster join: n3 asked for no job in 300 s")
                time.sleep(0.05)
            job_running.set()
            wt.start()
            job = _wait_job(http0, "join")
            job_running.clear()
            wt.join(timeout=900)
            check(not wt.is_alive(), "cluster join: the writer is still writing 900 s on")
            check(w["failed"] is None, f"cluster join: the writer failed: {w['failed']}")
            check(job["state"] == "DONE" and job["action"] == "add-node", f"cluster join: {job}")
            n3.wait_listening()
            join_s = time.perf_counter() - t0
            out["join"] = job_line(job, "join")
            out["join"]["wall_s"] = join_s
            out["writer"] = dict(w, requests=len(batches))
            n9 = len(row9[2])
            check(w["acked_bits"] == n9, f"cluster join: the writer's acknowledged bits {w['acked_bits']} != its {n9} bits")
            print(f"cluster join: n3 a member {join_s:.1f} s after its start; the writer's {len(batches)} imports of f row "
                  f"{CLUSTER_JOIN_ROW} ({n9} bits) all acknowledged, {w['acked']} requests in all (the batches again "
                  f"while the job ran), {w['during_job']} of them while the job ran, {w['retries_503']} 503s retried, "
                  f"{w['replica_misses']} replica misses")
            live = nodes + [n3]
            out["join"]["settled_s"] = wait_settled(live, 4, "join")
            # n3's first pass and warm p50 of one query
            c3 = _Http(n3.uri)
            try:
                body = CLUSTER_N3_QUERY.encode()
                first = _wall_ms(lambda: c3.raw("POST", "/index/c/query", body, "text/plain"))
                warm = statistics.median(_wall_ms(lambda: c3.raw("POST", "/index/c/query", body, "text/plain"))
                                         for _ in range(CLUSTER_N3_REPS))
            finally:
                c3.close()
            out["n3_first_ms"], out["n3_warm_p50_ms"] = first, warm
            print(f"cluster join: n3 served {CLUSTER_N3_QUERY} in {first:.3f} ms first, {warm:.3f} ms warm p50")
            want_j = want_with([row8, row9])
            out["joined_s"] = ask_all(live, "joined", want_j)
            cl4 = placement(["n0", "n1", "n2", "n3"])
            out["held_4"] = check_holdings(live, cl4, "join")
            out["n3_holds_amount"] = any(s < min(S, CLUSTER_VALUE_SHARDS) for s in range(S)
                                         if any(o.id == "n3" for o in cl4.shard_nodes("c", s)))
            out["cleaner_join"] = check_cleaner(nodes, cleaned0, "join")
            out["ae_after_join"] = repay(live, "joined")
            # n3 leaves
            cleaned1 = {n.nid: len(_cleaner_lines(n)) for n in nodes}
            t0 = time.perf_counter()
            http0.json("POST", "/cluster/resize/remove-node", {"id": "n3"})
            job = _wait_job(http0, "remove")
            check(job["state"] == "DONE" and job["action"] == "remove-node", f"cluster remove: {job}")
            out["remove"] = job_line(job, "remove")
            out["remove"]["wall_s"] = time.perf_counter() - t0
            out["remove"]["settled_s"] = wait_settled(nodes, 3, "remove")
            st3 = status_of(n3)
            # the removed node learns the new membership, without itself
            check([x["id"] for x in st3["nodes"]] == ["n0", "n1", "n2"] and st3["state"] == "NORMAL",
                  f"cluster remove: n3 after it left: {st3}")
            out["removed_s"] = ask_all(nodes, "removed", want_j)
            out["held_3"] = check_holdings(nodes, placement(["n0", "n1", "n2"]), "remove")
            out["cleaner_remove"] = check_cleaner(nodes, cleaned1, "remove")
            out["ae_after_remove"] = repay(nodes, "removed")
        finally:
            job_running.clear()
            if wt.is_alive():
                wt.join(timeout=60)
            rc3 = n3.stop()
        check(rc3 == 0, f"n3 exited {rc3} on SIGTERM")
        out["n3_launches"] = n3.launches()
    finally:
        http0.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"cluster resize: join and remove of n3 in {out['phase_s']:.1f} s")
    return out


def cluster_path(args, S: int = CLUSTER_SHARDS, server_args=(), on_card: bool = True) -> dict:
    """Phase 7: three CLI nodes (`--cluster-hosts n0@...,n1@...,n2@...
    --replicas 2`), each on its own data dir, all on the card; data
    imported through n0 only; the query set through every node, held to
    numpy; kill -9 of n2 (DEGRADED, answers unchanged), writes through n0
    while n2 is down (pending-repair debt), its restart on its data dir
    (NORMAL, its copies drifted), anti-entropy passes on every node
    (`anti_entropy_check`), then the query set and the new row's
    queries through n2 and n0, held to numpy with the downtime writes;
    the nodes' kernel launches read from the line each logs as it
    stops."""
    import os
    import threading

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    W = WORDS_PER_ROW
    t_phase = time.perf_counter()
    rng = np.random.default_rng([args.seed, 7])
    base_dir = durable_dir()
    ports = _free_ports(len(CLUSTER_NODES))
    hosts = ",".join(f"{nid}@http://127.0.0.1:{p}" for nid, p in zip(CLUSTER_NODES, ports))
    before_apps, before_used = (_compute_apps(), _memory_used_mib()) if on_card else ([], 0)
    nodes = [_Node(nid, os.path.join(base_dir, nid), p, hosts, server_args) for nid, p in zip(CLUSTER_NODES, ports)]
    info = {"shards": S, "nodes": list(CLUSTER_NODES)}
    try:
        # data from the seed, made while the nodes start
        t0 = time.perf_counter()

        def dense_rows(draws):
            out, w = [], None
            for d in range(1, max(draws) + 1):
                x = rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
                w = x if w is None else w & x
                if d in draws:
                    out.append(w.copy())
            return out

        f_dense = dense_rows(CLUSTER_F_DENSE_DRAWS)
        g_dense = dense_rows(CLUSTER_G_DENSE_DRAWS)

        def sparse_rows(n):
            """n rows of CLUSTER_SPARSE_BITS random bits a shard: per row a
            list of S sorted unique in-shard position arrays."""
            return [[np.unique(rng.integers(0, SHARD_WIDTH, CLUSTER_SPARSE_BITS).astype(np.uint64)) for _ in range(S)] for _ in range(n)]

        f_sparse = sparse_rows(4)
        h_sparse = sparse_rows(8)
        n_val = min(S, CLUSTER_VALUE_SHARDS)
        v_cols = [np.sort(rng.choice(SHARD_WIDTH, SHARD_WIDTH // CLUSTER_VALUE_DENSITY, replace=False)) for _ in range(n_val)]
        v_vals = [rng.integers(AMOUNT[0], AMOUNT[1] + 1, len(c)) for c in v_cols]
        nf = len(f_dense)
        with ThreadPoolExecutor(max_workers=8) as pool:
            f_bodies = list(pool.map(lambda s: _roaring_shard(
                [(r, f_dense[r][s]) for r in range(nf)], [(nf + r, f_sparse[r][s]) for r in range(4)]), range(S)))
            g_bodies = list(pool.map(lambda s: _roaring_shard([(r, g_dense[r][s]) for r in range(len(g_dense))], []), range(S)))
            h_bodies = list(pool.map(lambda s: _roaring_shard([], [(r, h_sparse[r][s]) for r in range(8)]), range(S)))
        n_body = sum(map(len, f_bodies)) + sum(map(len, g_bodies)) + sum(map(len, h_bodies))
        gen_s = time.perf_counter() - t0
        print(f"cluster: generated {S} shards x 3 roaring bodies ({n_body} B) and {sum(map(len, v_cols))} values in {gen_s:.1f} s")

        start_s = max(n.wait_listening() for n in nodes)
        info["start_s"] = start_s
        if on_card:
            apps, used = _compute_apps(), _memory_used_mib()
            pids = [n.p.pid for n in nodes]
            devices = [re.search(r"\(device (\S+)\)", "\n".join(n.lines)) for n in nodes]
            check(all(m is not None and m.group(1).startswith("cuda") for m in devices),
                  f"cluster nodes serve on {[m and m.group(1) for m in devices]}")
            if all(p in {a[0] for a in apps} for p in pids):
                how = f"nvidia-smi lists the node pids {pids}"
            elif len(apps) >= len(before_apps) + 3:
                how = f"nvidia-smi lists {len(apps) - len(before_apps)} more compute processes than before the nodes ({apps})"
            else:
                # nvidia-smi reports the nodes under pids of another namespace
                check(used - before_used >= 3 * 256,
                      f"nvidia-smi lists {apps} (before the nodes {before_apps}); {used - before_used} MiB more in use")
                how = (f"nvidia-smi lists {apps} (another pid namespace: before the nodes {before_apps}); "
                       f"{used - before_used} MiB more in use on the card; each node serves on {devices[0].group(1)}")
            print(f"cluster: 3 nodes on the card in {start_s:.1f} s: {how}")
            info["contexts"] = how

        # ingest through n0 only: 8 client threads, one connection each
        http0 = _Http(nodes[0].uri)
        http0.json("POST", "/index/c", {"options": {"trackExistence": True}})
        for fld in ("f", "g", "h"):
            http0.json("POST", f"/index/c/field/{fld}", {})
        http0.json("POST", "/index/c/field/amount", {"options": {"type": "int", "min": AMOUNT[0], "max": AMOUNT[1]}})
        local = threading.local()

        def post(path, body, ctype="application/octet-stream"):
            if not hasattr(local, "c"):
                local.c = _Http(nodes[0].uri)
            return local.c.json("POST", path, body, ctype)

        t0 = time.perf_counter()
        jobs = [(f"/index/c/field/{fld}/import-roaring/{s}", b) for fld, bodies in (("f", f_bodies), ("g", g_bodies), ("h", h_bodies))
                for s, b in enumerate(bodies)]
        with ThreadPoolExecutor(max_workers=8) as pool:
            outs = list(pool.map(lambda j: post(*j), jobs))
        check(all("changed" in o for o in outs), f"import-roaring: {outs[:3]}")
        roaring_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            outs = list(pool.map(lambda s: post("/index/c/field/amount/import-value", {
                "cols": (v_cols[s] + s * SHARD_WIDTH).tolist(), "values": v_vals[s].tolist()}, "application/json"), range(n_val)))
        check(all(o["errors"] == [] and o["applied"] == o["expected"] == 2 for o in outs), f"import-value: {outs[:3]}")
        value_s = time.perf_counter() - t0
        # the keyed index: 2^16 column keys in one /import
        key_order = rng.permutation(CLUSTER_KEYS)
        col_keys = [f"u{i:05d}" for i in key_order.tolist()]
        row_of = rng.integers(0, CLUSTER_ROW_KEYS, CLUSTER_KEYS)
        row_keys = [f"k{r}" for r in row_of.tolist()]
        t0 = time.perf_counter()
        http0.json("POST", "/index/ck", {"options": {"keys": True}})
        http0.json("POST", "/index/ck/field/kf", {"options": {"keys": True}})
        http0.json("POST", "/index/ck/field/kf/import", {"rowKeys": row_keys, "colKeys": col_keys})
        keyed_s = time.perf_counter() - t0
        del f_bodies, g_bodies, h_bodies
        info["ingest"] = {
            "roaring_s": roaring_s, "roaring_bytes": n_body, "roaring_requests": len(jobs),
            "roaring_mib_per_s": n_body / 2**20 / roaring_s, "import_value_s": value_s,
            "values": int(sum(map(len, v_cols))), "keyed_import_s": keyed_s, "generate_s": gen_s,
        }
        print(
            f"cluster: ingest through n0: {len(jobs)} import-roaring POSTs, {n_body / 2**20:.1f} MiB in {roaring_s:.1f} s "
            f"({n_body / 2**20 / roaring_s:.2f} MiB/s, each to 2 owners); {n_val} import-value POSTs in {value_s:.1f} s; "
            f"{CLUSTER_KEYS} keyed pairs in {keyed_s:.1f} s"
        )

        # the numpy answers
        t0 = time.perf_counter()
        pc = np_popcount

        def words_of(rows_pos):
            out = np.zeros((S, W), np.uint32)
            for s, pos in enumerate(rows_pos):
                if len(pos):
                    np.bitwise_or.at(out[s], (pos >> np.uint64(5)).astype(np.int64), np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32))
            return out

        f_words = f_dense + [words_of(r) for r in f_sparse]
        g_words = g_dense
        h_words = [words_of(r) for r in h_sparse]
        exists = np.zeros((S, W), np.uint32)
        for wds in f_words + g_words + h_words:
            exists |= wds
        for s in range(n_val):
            exists[s] |= _pack_positions(v_cols[s].astype(np.uint64))

        def cols_of(rows_pos):
            return np.concatenate([pos + np.uint64(s * SHARD_WIDTH) for s, pos in enumerate(rows_pos)])

        def bits_at(words, cols):
            """Bit of [S, W] words at each absolute column."""
            s = (cols // np.uint64(SHARD_WIDTH)).astype(np.int64)
            c = (cols % np.uint64(SHARD_WIDTH)).astype(np.int64)
            return ((words[s, c >> 5] >> (c & 31).astype(np.uint32)) & 1).astype(bool)

        vals_all = np.concatenate(v_vals)
        v_abs = np.concatenate([c.astype(np.uint64) + np.uint64(s * SHARD_WIDTH) for s, c in enumerate(v_cols)])
        g1_sel = bits_at(g_words[1], v_abs)
        f_counts = [pc(w) for w in f_words]
        top = sorted(((r, c) for r, c in enumerate(f_counts) if c), key=lambda kv: (-kv[1], kv[0]))[:5]
        ic = [pc(f_words[r] & g_words[0]) for r in range(nf)] + [int(bits_at(g_words[0], cols_of(f_sparse[r])).sum()) for r in range(4)]
        top_g0 = sorted(((r, c) for r, c in enumerate(ic) if c), key=lambda kv: (-kv[1], kv[0]))[:5]
        f4 = cols_of(f_sparse[0])
        f5 = cols_of(f_sparse[1])
        f6 = cols_of(f_sparse[2])
        gh, ghf = {}, {}
        for r in range(8):
            hc = cols_of(h_sparse[r])
            G = np.stack([bits_at(g, hc) for g in g_words])
            F = np.stack([bits_at(f, hc) for f in f_words])
            for j, n in enumerate(G.sum(axis=1).tolist()):
                if n:
                    gh[(r, j)] = n
            cnt = np.einsum("in,jn->ij", F.astype(np.int64), G.astype(np.int64))
            for i, j in zip(*np.nonzero(cnt)):
                ghf[(int(i), int(j), r)] = int(cnt[i, j])
        lo, hi = _extreme(vals_all, True), _extreme(vals_all[g1_sel], False)
        h0 = cols_of(h_sparse[0])
        f0_shifted = _shift_np(f_words[0], 1)[:S]  # its carry into shard S meets no bit of g
        h1_sel = np.isin(v_abs, cols_of(h_sparse[1]) + np.uint64(2000))
        gh_json = group_json(("h", "g"), gh)
        want = dict(zip(CLUSTER_QUERIES, [
            [f_counts[0]],
            [pc(f_words[0] & g_words[1])],
            [pc(f_words[1] | f_words[2] | g_words[0])],
            [pc(f_words[0] & ~g_words[0])],
            [pc(f_words[1] ^ g_words[2])],
            [pc(exists & ~f_words[0])],
            [f_counts[0], f_counts[1], pc(f_words[2] & g_words[3])],
            [{"attrs": {}, "columns": f4.tolist()}],
            [{"attrs": {}, "columns": f5[bits_at(g_words[0], f5)].tolist()}],
            [{"attrs": {}, "columns": (f6 + np.uint64(1)).tolist()}],
            [[{"id": r, "count": c} for r, c in top]],
            [[{"id": r, "count": c} for r, c in top_g0]],
            [list(range(nf + 4))],
            [group_json(("h", "g"), gh)],
            [group_json(("f", "g", "h"), {k: v for k, v in ghf.items()})],
            [{"value": int(vals_all.sum()), "count": len(vals_all)}],
            [{"value": lo[0], "count": lo[1]}],
            [{"value": hi[0], "count": hi[1]}],
            [int((vals_all > 500_000).sum())],
            [len(h0)],
            [pc(f0_shifted & g_words[1])],
            [{"value": int(vals_all[h1_sel].sum()), "count": int(h1_sel.sum())}],
            [{"id": 0, "count": 1}],
            [{"id": nf + 3, "count": 1}],
            [gh_json[3:]],
            [gh_json[3:8]],
        ]))
        # keyed: ids in order of first appearance
        first = {}
        for k in row_keys:
            first.setdefault(k, len(first) + 1)
        k3 = int((row_of == 3).sum())
        kcounts = sorted(((first[f"k{r}"], f"k{r}", int((row_of == r).sum())) for r in range(CLUSTER_ROW_KEYS)),
                         key=lambda t: (-t[2], t[0]))[:3]
        new_id = CLUSTER_KEYS + 1
        want_keyed = {
            'Row(kf="k9")': [{"attrs": {}, "columns": [new_id], "keys": ["u99999"]}],
            'Count(Row(kf="k3"))': [k3],
            "TopN(kf, n=3)": [[{"id": i, "count": c, "key": k} for i, k, c in kcounts]],
        }
        print(f"cluster: numpy answers in {time.perf_counter() - t0:.1f} s")
        del g1_sel

        # a keyed Set through n1: its key stores forward the new keys to n0's
        out = _Http(nodes[1].uri).json("POST", "/index/ck/query", b'Set("u99999", kf="k9")', "text/plain")
        check(out == {"results": [True]}, f"keyed Set through n1: {out}")

        def ask_all(live, label, want_c=want):
            """Every query through every live node, the nodes asked at
            once (a client thread each): equal to numpy and to the first
            node's bodies."""
            t = time.perf_counter()

            def ask(n):
                bodies, c = {}, _Http(n.uri)
                try:
                    for index, qs, wants in (("c", list(want_c), want_c), ("ck", CLUSTER_KEYED_QUERIES, want_keyed)):
                        for q in qs:
                            status, raw = c.raw("POST", f"/index/{index}/query", q.encode(), "text/plain")
                            check(status == 200, f"cluster {label} {n.nid} {q}: HTTP {status}: {raw[:300]!r}")
                            got = json.loads(raw)["results"]
                            check(got == wants[q], f"cluster {label} {n.nid} {q}: {str(got)[:300]}, numpy says {str(wants[q])[:300]}")
                            bodies[q] = raw
                finally:
                    c.close()
                return bodies

            with ThreadPoolExecutor(len(live)) as pool:
                per_node = list(pool.map(ask, live))
            for n, bodies in zip(live[1:], per_node[1:]):
                for q, raw in bodies.items():
                    check(raw == per_node[0][q], f"cluster {label} {q}: {n.nid}'s body differs from the first node's")
            dt = time.perf_counter() - t
            print(f"cluster {label}: {len(want_c) + len(CLUSTER_KEYED_QUERIES)} queries through "
                  f"{', '.join(n.nid for n in live)} equal numpy and each other in {dt:.1f} s")
            return dt

        def status_of(n):
            return _Http(n.uri).json("GET", "/status")

        def wait_state(n, state, timeout=30.0):
            t = time.perf_counter()
            while time.perf_counter() - t < timeout:
                if status_of(n)["state"] == state:
                    return time.perf_counter() - t
                time.sleep(0.1)
            fail(f"cluster: {n.nid} not {state} within {timeout} s: {status_of(n)}")

        info["whole_s"] = ask_all(nodes, "whole")
        # warm served p50s at n0
        lat = {}
        for index, qs in (("c", CLUSTER_QUERIES), ("ck", CLUSTER_KEYED_QUERIES)):
            for q in qs:
                body = q.encode()
                lat[q] = statistics.median(
                    _wall_ms(lambda: http0.raw("POST", f"/index/{index}/query", body, "text/plain")) for _ in range(CLUSTER_REPS)
                )
                print(f"cluster p50 {lat[q]:.3f} ms served at n0  {q}")
        info["query_p50_ms"] = lat

        # kill -9 n2: DEGRADED after a probe, every answer again
        nodes[2].kill9()
        info["degraded_after_s"] = wait_state(nodes[0], "DEGRADED")
        wait_state(nodes[1], "DEGRADED")  # the coordinator's broadcast
        print(f"cluster: kill -9 n2: n0 DEGRADED after {info['degraded_after_s']:.2f} s")
        info["degraded_s"] = ask_all(nodes[:2], "degraded")
        # writes n2 misses while it is down: its debt, anti-entropy's to repay
        down = downtime_writes(http0, args.seed, S)
        st = status_of(nodes[0])
        check(st["pendingRepairs"] > 0, f"cluster: writes with n2 down left no pending repairs at n0: {st}")
        down["pending_at_n0"] = st["pendingRepairs"]
        print(f"cluster: with n2 down, n0 took a new row f={CLUSTER_AE_ROW} on {len(down['shards'])} shards n2 owns "
              f"({len(down['primary'])} as primary, {len(down['replica'])} as replica; {down['bits']} bits), "
              f"{len(down['set_cols'])} Sets, a SetRowAttrs and a SetColumnAttrs: pendingRepairs {st['pendingRepairs']}")
        # restart n2 on its data dir: NORMAL again, every answer again
        t0 = time.perf_counter()
        nodes[2] = _Node("n2", nodes[2].data_dir, nodes[2].port, hosts, server_args)
        nodes[2].wait_listening()
        info["normal_after_s"] = wait_state(nodes[0], "NORMAL") + (time.perf_counter() - t0)
        check(status_of(nodes[2])["state"] == "NORMAL", f"restarted n2: {status_of(nodes[2])}")
        print(f"cluster: n2 restarted on its data dir: NORMAL {info['normal_after_s']:.2f} s after its start")
        # anti-entropy repays the debt; then through the restarted node and
        # the coordinator, whose legs go to it again, every answer equals
        # numpy with the downtime writes
        info["anti_entropy"] = anti_entropy_check(nodes, down, args.seed, S, status_of)
        def top5(counts):
            return [{"id": r, "count": c} for r, c in sorted(((r, c) for r, c in enumerate(counts) if c), key=lambda kv: (-kv[1], kv[0]))[:5]]

        def want_with(extra):
            """The answers with f's rows past 0-7: `extra` is [(row, words
            [S, W], sorted columns, attrs)], rows 8, 9, ... in order."""
            w = dict(want)
            ext = exists.copy()
            for _, wds, _, _ in extra:
                ext |= wds
            all_words = f_words + [wds for _, wds, _, _ in extra]
            w["Count(Not(Row(f=0)))"] = [pc(ext & ~f_words[0])]
            w["TopN(f, n=5)"] = [top5(f_counts + [len(cols) for _, _, cols, _ in extra])]
            w["TopN(f, Row(g=0), n=5)"] = [top5(ic + [int(bits_at(g_words[0], cols).sum()) for _, _, cols, _ in extra])]
            w["Rows(f)"] = [list(range(extra[-1][0] + 1))]
            w["MaxRow(field=f)"] = [{"id": extra[-1][0], "count": 1}]
            ghf_x = dict(ghf)
            for r in range(8):
                hc = cols_of(h_sparse[r])
                for row, wds, _, _ in extra:
                    in_row = bits_at(wds, hc)
                    for j, g in enumerate(g_words):
                        n = int((in_row & bits_at(g, hc)).sum())
                        if n:
                            ghf_x[(row, j, r)] = n
            w["GroupBy(Rows(f), Rows(g), Rows(h))"] = [group_json(("f", "g", "h"), ghf_x)]
            # each new row's own Count, filtered TopN and Row
            for row, wds, cols, attrs in extra:
                w[f"Count(Row(f={row}))"] = [len(cols)]
                w[f"TopN(f, Row(f={row}), n=5)"] = [top5([pc(x & wds) for x in all_words])]
                w[f"Row(f={row})"] = [{"attrs": attrs, "columns": cols.tolist()}]
            return w

        f8 = [np.unique(np.concatenate([down["cols"].get(s, np.empty(0, np.uint64)),
                                      np.array([c % SHARD_WIDTH for c in down["set_cols"] if c // SHARD_WIDTH == s], np.uint64)]))
              for s in range(S)]
        row8 = (CLUSTER_AE_ROW, words_of(f8), cols_of(f8), CLUSTER_AE_ROW_ATTRS)
        want_after = want_with([row8])
        info["restarted_s"] = ask_all([nodes[2], nodes[0]], "repaired", want_after)
        for n in (nodes[2], nodes[0]):
            out = _Http(n.uri).json("POST", "/index/c/query", {"query": f"Row(f={CLUSTER_AE_ROW})", "columnAttrs": True})
            check(out.get("columnAttrs") == [{"id": down["attr_col"], "attrs": CLUSTER_AE_COL_ATTRS}],
                  f"cluster repaired {n.nid}: column attributes {out.get('columnAttrs')}")
        print(f"cluster repaired: the column attributes written with n2 down read back through n2 and n0")
        info["resize"] = resize_steps(args, nodes, server_args, base_dir, S, want_with, row8, words_of, cols_of,
                                      ask_all, status_of)
        http0.close()
    finally:
        rcs = [n.stop() for n in nodes]
    check(all(rc == 0 for rc in rcs), f"cluster nodes exited {rcs} on SIGTERM")
    per_node = {n.nid: n.launches() for n in nodes}
    per_node["n3"] = info["resize"]["n3_launches"]
    total = {k: sum(per_node[n][k] for n in per_node) for k in per_node[CLUSTER_NODES[0]]}
    if on_card:
        for name in CLUSTER_KERNELS:
            check(total[name] > 0, f"the cluster's queries never launched {name}: {per_node}")
        ran = {k: v for k, v in per_node["n3"].items() if v}
        for name in RESIZE_N3_KERNELS + (BSI_N3_KERNELS if info["resize"]["n3_holds_amount"] else ()):
            check(per_node["n3"].get(name, 0) > 0, f"n3's answers never launched {name}: {ran}")
    info["launches"] = total
    info["launches_per_node"] = per_node
    info["phase_s"] = time.perf_counter() - t_phase
    import shutil

    shutil.rmtree(base_dir, ignore_errors=True)
    print(f"cluster: launches (n0, n1, n2 after its restart, n3) {total}; n3's {per_node['n3']}; phase {info['phase_s']:.1f} s")
    return info


def _wall_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def _compute_apps() -> list:
    """[(pid, used MiB)] of nvidia-smi's compute processes."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    apps = []
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps.append((int(parts[0]), int(parts[1]) if parts[1].isdigit() else -1))
    return apps


def _memory_used_mib() -> int:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return int(out.split()[0])


def counts_cross_legs(launches: int, errs) -> dict:
    """counts_cross at the cluster GroupBy's leg shapes on random words: G =
    gmax(171, W) = 11 prefixes x R = 8 rows over a third of 512 shards, and
    G = gmax(256, W) = 8 x R = 8 over half of them (one node down); §3's
    method, the bound each distinct word once (acc, planes, counts)."""
    import torch

    from pilosa_tpu_torch.exec.groupby import gmax
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW as W

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for s in (171, 256):
        g, r = gmax(s, W), 8
        acc = torch.randint(-(2**31), 2**31, (g, s, W), dtype=torch.int32, device="cuda", generator=gen)
        planes = torch.randint(-(2**31), 2**31, (r, s, W), dtype=torch.int32, device="cuda", generator=gen)
        got, ref = K.counts_cross(acc, planes), K.counts_cross_plain(acc, planes)
        diff = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max().item())
        check(diff == 0, f"counts_cross at G {g} x R {r}, S {s} differs from its twin by {diff}")
        errs["counts_cross"] = max(errs.get("counts_cross", 0), diff)
        nbytes = (g + r) * s * W * 4 + g * r * s * 4
        ms = cuda_time_ms(lambda: K.counts_cross(acc, planes))
        row = {
            "G": g, "R": r, "S": s, "ms": ms, "dispatch_ms": dispatch_ms(lambda: K.counts_cross(acc, planes)),
            "plain_ms": cuda_time_ms(lambda: K.counts_cross_plain(acc, planes), reps=PLAIN_REPS),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes, "launches_in_cluster": launches,
        }
        row["share_of_bound"] = row["bound_ms"] / ms
        out[f"G{g}_R{r}_S{s}"] = row
        print(
            f"kernel counts_cross at a cluster leg (G {g}, R {r}, S {s}): device {ms:.4f} ms, dispatch "
            f"{row['dispatch_ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['share_of_bound']:.1%} of it); {launches} counts_cross launches in the cluster phase"
        )
        del acc, planes, got, ref
    # the tensor-core tile holds 16 prefixes: one tile short of full, full,
    # and one prefix into a second tile
    s, r = 171, 8
    planes = torch.randint(-(2**31), 2**31, (r, s, W), dtype=torch.int32, device="cuda", generator=gen)
    for g in (12, 16, 17):
        acc = torch.randint(-(2**31), 2**31, (g, s, W), dtype=torch.int32, device="cuda", generator=gen)
        got, ref = K.counts_cross(acc, planes), K.counts_cross_plain(acc, planes)
        diff = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max().item())
        check(diff == 0, f"counts_cross at G {g} x R {r}, S {s} differs from its twin by {diff}")
        errs["counts_cross"] = max(errs.get("counts_cross", 0), diff)
        del acc, got, ref
    del planes
    print("kernel counts_cross equal to its twin at G = 11, 12, 16 and 17 x R = 8 over S = 171")
    torch.cuda.empty_cache()
    return out


def offline_tools(d: str) -> dict:
    """`inspect` and `check` on a stopped data dir, one after the other;
    the dir is deleted after them."""
    import shutil

    tools = {}
    for cmd in (["inspect", d, "--index", "k"], ["check", d]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.cli", *cmd], capture_output=True, text=True, timeout=900)
        lines = out.stdout.splitlines()
        check(out.returncode == 0, f"{cmd[0]}: exit {out.returncode}: {out.stderr[-2000:]}")
        check(len(lines) > 0, f"{cmd[0]} printed nothing")
        if cmd[0] == "check":
            bad = [line for line in lines if "CORRUPT" in line]
            check(not bad, f"check reports bad files: {bad[:5]}")
        tools[cmd[0]] = {"s": time.perf_counter() - t0, "lines": len(lines)}
        print(f"durable: {cmd[0]} exit 0, {len(lines)} lines in {tools[cmd[0]]['s']:.1f} s; last: {lines[-1] if lines else ''}")
    shutil.rmtree(d, ignore_errors=True)
    return tools


def _kernel_name(mangled: str) -> str:
    """`count2_kernel<4>` for a mangled kernel name (c++filt where the
    toolkit's host compiler brought it; else the name as it is)."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def ptxas_report(log: str):
    """One line per compiled function of nvcc's -Xptxas -v log: registers,
    stack frame (local memory) and spills."""
    out, fn, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            f = frame or ("?", "?", "?")
            out.append(
                f"{_kernel_name(fn)}: {m.group(1)} registers, {f[0]} B stack frame, "
                f"{f[1]} B spill stores, {f[2]} B spill loads"
            )
            fn = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = K.build()
    K.library()
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(p.name for p in libs)} in {build_s:.1f} s")
    ptxas = ptxas_report(K.BUILD_LOG["text"])
    for line in ptxas:
        print(f"  ptxas: {line}")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    errs = {}
    phase_s = {"build": build_s}
    t0 = time.perf_counter()
    kernel_phase(rng, dev, errs)
    phase_s["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    holder, ex, launches, lat, ingest_s, resident, state = main_path(args, rng)
    phase_s["main"] = time.perf_counter() - t0
    state["bursts"] = residency_bursts(args.seed, args.shards)
    state["g_burst"] = state["bursts"]["g_burst"]
    t0 = time.perf_counter()
    bsi_launches, bsi_lat, bsi_info = bsi_path(args, holder, ex, state)
    phase_s["bsi"] = time.perf_counter() - t0
    for name in BSI_KERNELS:
        launches[name] = bsi_launches[name]
        launches[name + "_deep"] = bsi_info["deep_launches"][name]
    t0 = time.perf_counter()
    bsi_info["slab_residency"] = bsi_slab_residency(args, holder, ex, bsi_info["answers"])
    phase_s["bsi slab residency"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, extra = kernel_timing(holder, ex, launches, errs)
    phase_s["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_rows, residency = residency_path(args, holder, ex, state, errs, smi)
    rows.update(res_rows)
    phase_s["residency"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["plan_rows"], time_info = time_path(args, holder, ex, state, errs, smi)
    rows["plan_rows"]["launches"] = launches["plan_rows"] + time_info["launches"]["plan_rows"]
    for key in ("plan_rows_2_leaves", "plan_rows_28_leaves", "plan_rows_shift_leaf"):
        rows["plan_rows"][key] = {k.removeprefix(key).lstrip("_") or "ms": v for k, v in extra.items() if k.startswith(key)}
    phase_s["time"] = time.perf_counter() - t0
    del state
    holder.close()  # the served node gets the card's memory to itself
    del holder, ex
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recovered, serve = serve_path(args)
    phase_s["serve"] = time.perf_counter() - t0 - serve["keyed"]["phase_s"] - serve["front_end"]["phase_s"]
    t0 = time.perf_counter()
    durable = durable_path(args, recovered)
    phase_s["durable"] = time.perf_counter() - t0
    torch.cuda.empty_cache()  # the cluster's three processes share the card
    t0 = time.perf_counter()
    cluster = cluster_path(args)
    phase_s["cluster"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["counts_cross"]["cluster_legs"] = counts_cross_legs(cluster["launches"]["counts_cross"], errs)
    phase_s["cluster legs"] = time.perf_counter() - t0
    for name, row in rows.items():
        row["launches_served"] = serve["launches"].get(name, 0)
        row["launches_recovered"] = durable["launches"].get(name, 0)
        row["launches_keyed"] = serve["keyed"]["launches"].get(name, 0)
        row["launches_front_end"] = serve["front_end"]["batcher"]["launches"].get(name, 0)
        row["launches_cluster"] = cluster["launches"].get(name, 0)
    keyed = serve["keyed"]
    phase_s["keyed (in serve)"] = keyed["phase_s"]
    phase_s["front end (in serve)"] = serve["front_end"]["phase_s"]
    print(
        f"keyed summary ({smi}): {keyed['columns']} column keys, phase {keyed['phase_s']:.1f} s, ingest "
        f"{keyed['ingest_s']:.1f} s ("
        + ", ".join(f"{k} {v['keys_per_s']:.0f} keys/s, {v['bits_per_s']:.0f} {'values' if k == 'spend' else 'bits'}/s"
                    for k, v in keyed["ingest"].items())
        + "); served p50 "
        + ", ".join(f"{v['served_ms']:.3f}" for v in keyed["query_p50_ms"].values())
        + " ms"
    )
    ing = serve["ingest"]
    print(
        f"durable summary ({smi}): recovery {durable['recovery_s']:.2f} s, first pass {durable['first_pass_s']:.2f} s, "
        f"warm served p50 {min(v['served_ms'] for v in durable['query_p50_ms'].values()):.3f}-"
        f"{max(v['served_ms'] for v in durable['query_p50_ms'].values()):.3f} ms; durable ingest: import-roaring "
        f"{ing['roaring_mib_per_s']:.2f} MiB/s, /import {ing['import_bits_per_s']:.0f} bits/s, import-value "
        f"{ing['import_value_values_per_s']:.0f} values/s; data dir {durable['data_dir_bytes']} bytes; kill -9 lost "
        + ", ".join(f"{k['lost']} (interval {k['sync_interval']})" for k in durable["kill9"])
    )
    print(
        f"cluster summary ({smi}): 3 nodes, replicas 2, {cluster['shards']} shards; ingest "
        f"{cluster['ingest']['roaring_mib_per_s']:.2f} MiB/s of roaring through n0; served p50 at n0 "
        f"{min(cluster['query_p50_ms'].values()):.3f}-{max(cluster['query_p50_ms'].values()):.3f} ms; DEGRADED "
        f"{cluster['degraded_after_s']:.2f} s after kill -9, NORMAL {cluster['normal_after_s']:.2f} s after the restart; "
        f"anti-entropy passes (s, repairing / clean) "
        + ", ".join(f"{p['node']} {p['pass']['seconds']:.2f} / {c['pass']['seconds']:.2f}"
                    for p, c in zip(cluster["anti_entropy"]["passes"], cluster["anti_entropy"]["clean"]))
        + f", blocks merged {cluster['anti_entropy']['repairing_totals']['blocks']}; "
        f"phase {cluster['phase_s']:.1f} s"
    )
    print("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    print(smi)
    print(json.dumps({
        "kernels": [
            rows[k]
            for k in ("plan_count", "plan_count_multi", "plan_rows", "gather_tally", "rows_counts", "count2", "bsi_sum", "bsi_min_max",
                      "bsi_min_max_step", "bsi_range", "bsi_range_step", "counts_cross", "gather_and", "or_bits", "merge_mark")
        ],
        "extra_ms": extra,
        "query_p50_ms": lat,
        "bsi_query_p50_ms": bsi_lat,
        "bsi": bsi_info,
        "bsi_launches": bsi_launches,
        "residency": residency,
        "time": time_info,
        "ingest_s": ingest_s,
        "device_cache_bytes": resident,
        "serve": serve,
        "durable": durable,
        "cluster": cluster,
        "shards": args.shards,
        "build_s": build_s,
        "phase_s": phase_s,
        "ptxas": ptxas,
    }))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
