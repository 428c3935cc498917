"""A signed int field 32 bits deep (values in +-(2^32 - 1): 32 magnitude
planes and a sign row, a 33-bit Min/Max key), which the reference
answers through its stacked fallback and its per-shard loop, against
pilosa_tpu on the same inputs over 16 shards: Sum, Min and Max (plain,
filtered, with a Shift in the filter, with a non-call filter) and
condition Counts at the edges. The stack is one chunk over five seeds,
and for one of them the device budget leaves one shard a chunk; answers
must be identical. The port runs
on the CPU here (its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import pytest

from torch_bsi_cases import BOUNDARY, BUDGETS, SEEDS, TOP, pairs_of, run_case

QUERIES = [
    "Sum(field=deep) Min(field=deep) Max(Row(g=0), field=deep, filter=2)",
    "Sum(Shift(Shift(Row(g=0), n=1), n=1), field=deep) Max(field=deep, filter=Shift(Union(Row(f=1), Row(g=0)), n=4))",
    f"Count(Row(deep < {-TOP + 1})) Count(Row(deep > {TOP - 1})) Count(Row({-TOP} <= deep <= {TOP})) Row(deep == {-TOP})",
]
CASES = [(seed, None) for seed in SEEDS] + [(0, 4 << 20)]


@pytest.fixture(scope="module")
def pairs():
    return pairs_of("deep", -TOP, TOP)


@pytest.mark.parametrize("seed,budget", CASES, ids=[f"{s}-{BUDGETS[b]}" for s, b in CASES])
def test_deep_field_matches_reference(pairs, seed, budget, monkeypatch):
    """Every query on all shards, and the Shift one also on the two shards
    around the two chunks' boundary, give the reference's answers."""
    for pql in QUERIES:
        run_case(pairs, seed, budget, monkeypatch, pql, [None, BOUNDARY] if "Shift" in pql else [None])
