"""Shared data and helpers of the BSI-shape differential tests
(tests/test_torch_bsi_shapes.py, tests/test_torch_bsi_deep.py): the same
ingest through pilosa_tpu and the port over 16 shards, and the cases of
seed and device budget. A plain module, not a test file: pytest collects
nothing here.
"""

import numpy as np

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.exec import bsistream
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

N_SHARDS = 16
# the last shard of the first of two chunks and the first of the second
BOUNDARY = [N_SHARDS // 2 - 1, N_SHARDS // 2]
TOP = 2**32 - 1
SEEDS = [0, 1, 2, 3, 4]
# the whole stack in one chunk; two chunks of 8 shards; one shard a chunk
BUDGETS = {None: "whole", 100 << 20: "two_chunks", 4 << 20: "per_shard"}
CHUNKS = {None: 1, 100 << 20: 2, 4 << 20: N_SHARDS}


def ingest(holder, fo, seed: int, field: str, lo: int, hi: int) -> None:
    """Set fields f and g with bits at each shard's last columns (the
    carries of a Shift) and an int field `field` in [lo, hi] with values
    on each shard's first columns, its extremes among them."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i")
    f, g = idx.create_field("f"), idx.create_field("g")
    idx.create_field(field, fo(type="int", min=lo, max=hi))
    width = N_SHARDS * SHARD_WIDTH
    ends = np.array([s * SHARD_WIDTH + SHARD_WIDTH - 1 - k for s in range(N_SHARDS) for k in range(3)], np.uint64)
    cols = np.concatenate([rng.integers(0, width, 3000).astype(np.uint64), ends])
    f.import_bits((cols % 3).astype(np.uint64), cols)
    g_cols = ends[rng.random(len(ends)) < 0.7]
    g.import_bits(np.zeros(len(g_cols), np.uint64), g_cols)
    starts = np.array([s * SHARD_WIDTH + k for s in range(N_SHARDS) for k in range(4)], np.uint64)
    vc = np.unique(np.concatenate([rng.integers(0, width, 4000).astype(np.uint64), starts]))
    vals = rng.integers(lo, hi + 1, len(vc))
    vals[rng.choice(len(vc), 6, replace=False)] = [lo, hi, 0, lo, hi, 1]
    idx.field(field).import_values(vc, vals)
    idx.track_columns(np.concatenate([cols, vc]))


def values(results):
    out = []
    for r in results:
        if hasattr(r, "value"):
            out.append((r.value, r.count))
        elif hasattr(r, "columns"):
            out.append([int(c) for c in r.columns()])
        else:
            out.append(r)
    return out


def pairs_of(field: str, lo: int, hi: int):
    """seed -> (the reference's answer to (pql, shards), port executor),
    built on first use; the reference answers each query once for every
    budget of the port."""
    cache = {}

    def get(seed):
        if seed not in cache:
            ref, port = JHolder(None).open(), THolder(device="cpu")
            ingest(ref, JFieldOptions, seed, field, lo, hi)
            ingest(port, TFieldOptions, seed, field, lo, hi)
            ref_ex, answers = JExecutor(ref), {}

            def want(pql, shards):
                key = (pql, None if shards is None else tuple(shards))
                if key not in answers:
                    answers[key] = values(ref_ex.execute("i", pql, shards=shards))
                return answers[key]

            cache[seed] = (want, TExecutor(port))
        return cache[seed]

    return get


def run_case(get, seed, budget, monkeypatch, pql, shard_lists) -> None:
    """One query over each shard list (None: every shard) equals the
    reference's answer, and over every shard its aggregates took the
    chunks the budget asks for."""
    want, port_ex = get(seed)
    dcache = port_ex.holder.dcache
    monkeypatch.setattr(dcache, "budget_bytes", budget or dcache.budget_bytes)
    chunks = []
    real = bsistream._aggregate_chunk
    monkeypatch.setattr(bsistream, "_aggregate_chunk", lambda *a, **k: chunks.append(1) or real(*a, **k))
    for shards in shard_lists:
        if shards is not None:
            chunks.clear()
        assert values(port_ex.execute("i", pql, shards=shards)) == want(pql, shards), (pql, shards)
        if shards is None:
            n_agg = pql.count("Sum(") + pql.count("Min(") + pql.count("Max(")
            assert len(chunks) >= n_agg * CHUNKS[budget], (pql, len(chunks))
