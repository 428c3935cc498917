"""Time-field writes of the port against pilosa_tpu: Store, ClearRow,
bool flips and timestamped Sets over 1, 15 and 20 shards, with the
answers and the stored bits identical. The port runs on the CPU here
(its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import pytest

from torch_time_cases import WRITES, both, run_both, stored


@pytest.mark.parametrize("n_shards", [1, 15, 20])
def test_time_writes_match_reference(n_shards):
    ref_ex, port_ex = both(n_shards, seed=5)
    for pql in WRITES:
        run_both(ref_ex, port_ex, pql)
    assert stored(port_ex.holder) == stored(ref_ex.holder)
