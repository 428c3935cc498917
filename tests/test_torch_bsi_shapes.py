"""BSI aggregates with a Shift in the filter and with a non-call filter,
which the reference answers through its per-shard loop and its stacked
fallback, against pilosa_tpu on the same inputs (the int field `amount`
over 16 shards; tests/test_torch_bsi_deep.py does the same for a signed
field 32 bits deep):

- a filter that holds Shift (Sum, Min, Max with a child or `filter=`):
  the port lowers the filter over each chunk's shards plus their Shift
  predecessors, so a carry crosses shards and chunk boundaries;
- a non-call `filter=` argument, which is no filter.

The stack is one chunk over five seeds, for one of them the device
budget splits it into two chunks, for another into one shard a chunk;
answers must be identical. The port runs on the CPU here (its kernels' plain
twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import pytest

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from torch_bsi_cases import BOUNDARY, BUDGETS, SEEDS, pairs_of, run_case

SHIFT_QUERIES = [
    "Sum(field=amount, filter=Shift(Row(g=0), n=1)) Min(field=amount, filter=Shift(Row(g=0), n=2))",
    "Max(Shift(Intersect(Row(f=2), Row(g=0)), n=1), field=amount) Sum(Shift(Shift(Row(g=0), n=1), n=1), field=amount)",
    f"Min(Shift(Row(f=0), n=5), field=amount) Sum(field=amount, filter=Shift(Row(f=0), n={SHARD_WIDTH}))",
]
OTHER_QUERIES = ["Sum(field=amount, filter=7) Min(field=amount, filter=\"x\") Max(field=amount, filter=2)"]
CASES = [(seed, None) for seed in SEEDS] + [(0, 100 << 20), (1, 4 << 20)]


@pytest.fixture(scope="module")
def pairs():
    return pairs_of("amount", -1000, 1000)


@pytest.mark.parametrize("seed,budget", CASES, ids=[f"{s}-{BUDGETS[b]}" for s, b in CASES])
def test_bsi_shapes_match_reference(pairs, seed, budget, monkeypatch):
    """Every query on all shards, and the Shift queries also on the two
    shards around the two chunks' boundary, give the reference's answers."""
    for pql in SHIFT_QUERIES + OTHER_QUERIES:
        run_case(pairs, seed, budget, monkeypatch, pql, [None, BOUNDARY] if pql in SHIFT_QUERIES else [None])
