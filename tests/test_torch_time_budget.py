"""Time-range reads and writes of the port against pilosa_tpu under a
device budget that splits 20 shards into chunks and single shards, and
filtered TopNs over a set field under such a budget in both packages.
The port runs on the CPU here (its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import numpy as np
import pytest

from pilosa_tpu.core.devcache import DEVICE_CACHE
from pilosa_tpu_torch.exec import executor as texec
from pilosa_tpu_torch.pql import parse as tparse
from torch_time_cases import R1, READS, both, run_both


@pytest.fixture
def ref_budget():
    """Sets the reference's process-wide device budget; restores it."""
    old = DEVICE_CACHE.budget_bytes
    yield lambda nbytes: setattr(DEVICE_CACHE, "budget_bytes", nbytes)
    DEVICE_CACHE.budget_bytes = old
    DEVICE_CACHE.clear()


def test_time_range_under_a_budget_that_splits_the_shards(ref_budget):
    """A tight device budget splits the 20 shards into chunks (and single
    shards); every range, Shift, Store, filtered MinRow/MaxRow (walked
    per chunk) and filtered TopN (its filter tallied per chunk) still
    answers as the reference does under the same budget."""
    ref_ex, port_ex = both(20, seed=9)
    for budget, n_plans in ((8 << 20, 2), (4 << 20, 20)):
        port_ex.holder.dcache.budget_bytes = budget
        ref_budget(budget)
        plans = port_ex._lower_plans(port_ex.holder.index("i"), tparse(f"Row(t=0, {R1})").calls[0], list(range(20)))
        for sp in plans:
            sp.release_extents()
        assert len(plans) == n_plans
        chunks = texec.TOPN_STATS["chunks"]
        for pql in READS + [f"Store(Row(t=0, {R1}), f=50) Count(Row(f=50))"]:
            run_both(ref_ex, port_ex, pql)
        # the filtered TopNs walked the filter in shard chunks
        assert texec.TOPN_STATS["chunks"] - chunks >= n_plans


def topn_ingest(holder, fo, seed: int) -> None:
    """40 rows of f over 20 shards with Zipf-skewed counts (each shard's
    rank cache holds more candidates than n), g as the filter rows, row
    attrs on f."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    idx = holder.create_index("i")
    f, g = idx.create_field("f"), idx.create_field("g")
    width = 20 * SHARD_WIDTH
    rows = (rng.zipf(1.3, 30000) - 1) % 40
    cols = rng.integers(0, width, len(rows))
    f.import_bits(rows.astype(np.uint64), cols.astype(np.uint64))
    gcols = rng.integers(0, width, 20000)
    g.import_bits(rng.integers(0, 3, len(gcols)).astype(np.uint64), gcols.astype(np.uint64))
    idx.track_columns(np.concatenate([cols, gcols]).astype(np.uint64))
    for r in range(40):
        f.row_attr_store.set_attrs(r, {"kind": ["a", "b", "c"][r % 3], "n": r})


TOPN_QUERIES = [
    "TopN(f, Row(g=0), n=3)",
    "TopN(f, Union(Row(g=1), Row(g=2)), n=5)",
    "TopN(f, Row(g=0), n=0)",
    "TopN(f, Union(Row(f=1), Row(g=2)), n=4, threshold=3)",
    "TopN(f, Row(g=1), ids=[0, 1, 2, 7, 39])",
    "TopN(f, Row(f=0), n=6, tanimotoThreshold=50)",
    'TopN(f, Row(g=1), n=4, attrName=kind, attrValues=["a", "c"])',
    "TopN(f, Shift(Row(g=0), n=1), n=3)",
]


@pytest.fixture(scope="module")
def topn_pairs():
    """seed -> (reference executor, port executor, the port's default
    budget), built on first use."""
    from pilosa_tpu.core.field import FieldOptions as JFieldOptions
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.exec import Executor as JExecutor
    from pilosa_tpu_torch import Executor as TExecutor
    from pilosa_tpu_torch import Holder as THolder
    from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions

    cache = {}

    def get(seed):
        if seed not in cache:
            ref, port = JHolder(None).open(), THolder(device="cpu")
            topn_ingest(ref, JFieldOptions, seed)
            topn_ingest(port, TFieldOptions, seed)
            cache[seed] = (JExecutor(ref), TExecutor(port), port.dcache.budget_bytes)
        return cache[seed]

    return get


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_filtered_topn_under_a_budget_matches_reference(topn_pairs, ref_budget, seed):
    """A filtered TopN over 20 shards whose filter stack exceeds the
    budget: the port tallies it in shard chunks (two of 10 shards, then
    one shard a chunk) and answers as the reference does under the same
    budget through its per-shard route, early stops and threshold,
    explicit ids, Tanimoto and attr filters included; the answer is not
    empty."""
    ref_ex, port_ex, default = topn_pairs(seed)
    for budget, chunks in ((None, 1), (8 << 20, 2), (4 << 20, 20)):
        port_ex.holder.dcache.budget_bytes = budget or default
        if budget is not None:  # the first round: both at their defaults
            ref_budget(budget)
        for pql in TOPN_QUERIES:
            before = texec.TOPN_STATS["chunks"]
            got = run_both(ref_ex, port_ex, pql)
            assert got[0], pql
            assert texec.TOPN_STATS["chunks"] - before >= chunks, pql
    port_ex.holder.dcache.budget_bytes = default
