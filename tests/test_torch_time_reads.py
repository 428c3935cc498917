"""Time-range reads of the port against pilosa_tpu: every query of
torch_time_cases.READS over 1, 15 and 20 shards, on all shards and on
the odd ones, then the error texts of torch_time_cases.ERRORS and a
keyed time field on the same data; answers and error texts must be
identical. The port runs on the CPU here (its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
from datetime import datetime

import pytest

from pilosa_tpu.exec.executor import ExecError as JExecError
from pilosa_tpu_torch import ExecError as TExecError
from pilosa_tpu_torch.core import timeq as ttimeq
from torch_time_cases import ERRORS, READS, both, run_both


@pytest.fixture(scope="module", params=[1, 15, 20], ids=["1shard", "15shards", "20shards"])
def loaded(request):
    return both(request.param)


@pytest.mark.parametrize("subset", [None, "odd"], ids=["all", "odd"])
def test_time_reads_match_reference(loaded, subset):
    ref_ex, port_ex = loaded
    n = len(ref_ex.holder.index("i").available_shards())
    shards = None if subset is None else list(range(1, n, 2)) or [0]
    for pql in READS:
        run_both(ref_ex, port_ex, pql, shards)
    # the 47-view range of the time phase: a 47-leaf union
    views = ttimeq.views_by_time_range("standard", datetime(2024, 1, 2, 3), datetime(2024, 1, 8, 21), "YMDH")
    assert len(views) == 47


@pytest.mark.parametrize("pql", ERRORS)
def test_time_errors_match_reference(loaded, pql):
    ref_ex, port_ex = loaded
    with pytest.raises((JExecError, ValueError)) as want:
        ref_ex.execute("i", pql)
    with pytest.raises((TExecError, ValueError)) as got:
        port_ex.execute("i", pql)
    assert str(got.value) == str(want.value), pql
    assert isinstance(got.value, TExecError) == isinstance(want.value, JExecError)


def test_keyed_time_field_matches_reference(loaded):
    ref_ex, port_ex = loaded
    for pql in [
        "Count(Row(kt=\"a\", from='2024-02-22T00:00', to='2024-02-28T00:00'))",
        "Row(kt=\"b\", from='2024-02-25T00:00')",
        "Rows(kt, from='2024-02-22T00:00', to='2024-02-28T00:00')",
        "Rows(kt)",
        "GroupBy(Rows(kt, from='2024-02-20T00:00', to='2024-02-26T00:00'), Rows(seg))",
        "TopN(seg, Row(kt=\"c\", from='2024-02-21T00:00', to='2024-03-01T00:00'), n=3)",
        'MaxRow(Row(kt="a"), field=seg) MinRow(field=kt)',
    ]:
        run_both(ref_ex, port_ex, pql, index="k")
