"""pilosa_tpu_torch: the PyTorch/CUDA port of pilosa_tpu for one NVIDIA
H100.

A bitmap index: set and mutex fields over 2^20-column shards, PQL queries
(Count over Row/Intersect/Union/Difference/Xor/Not/Shift trees, TopN)
answered from dense int32 word stacks on the card by hand-written CUDA
kernels (ops/cuda/bitmap_kernels.cu). The package imports torch and numpy
only. Entry points:

    from pilosa_tpu_torch import Holder, Executor
    h = Holder()                      # the CUDA card; Holder(device="cpu")
    idx = h.create_index("i")
    idx.create_field("f").import_bits(rows, cols)
    Executor(h).execute("i", "Count(Intersect(Row(f=1), Row(f=2)))")

Served over HTTP (pilosa_tpu_torch.server, one node, in memory):

    python -m pilosa_tpu_torch.cli server --data-dir '' --bind localhost:10101
"""

__version__ = "0.1.0"

from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.executor import Executor, ExecError

__all__ = ["Holder", "Executor", "ExecError"]
