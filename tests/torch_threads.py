"""One intra-op thread for the port's CPU twins in a test process.

The suite runs in several worker processes at once (pytest-xdist
`-n 6`). With torch's default of one OpenMP thread per core in each
worker, the workers' thread teams oversubscribe the cores and the port's
tests run many times slower than alone: six copies of
tests/test_torch_bsi_shapes.py at once took over 1200 s on an 8-core
host, against 55 s with one thread each. Every tests/test_torch_*.py
imports this module before the port; servers the tests start inherit
OMP_NUM_THREADS. A plain module, not a test file: pytest collects
nothing here.
"""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)
