"""Cross-tally of candidate row planes against a filter stack.

The port's slice of pilosa_tpu/exec/groupby.py: only `counts_cross` with
one group (G = 1), the shape the filtered TopN dense tally uses. It runs
on the rows_counts kernel: the [R, S, W] plane stack is viewed as R*S rows
and row r*S + s meets filter row s.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import kernels

# bytes of one plane-stack tile (candidate rows x shards x words)
TILE_BYTES = 256 << 20


def gmax(s: int, w: int) -> int:
    """Candidate rows per tile for an [S, W] filter stack."""
    return max(1, TILE_BYTES // (s * w * 4))


def counts_cross(src: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """src int32[S, W] x planes int32[R, S, W] -> per-shard counts
    int32[R, S] of popcount(planes[r, s] & src[s])."""
    r, s, w = planes.shape
    if src.shape != (s, w):
        raise ValueError(f"counts_cross: src {tuple(src.shape)} vs planes {tuple(planes.shape)}")
    return kernels.rows_counts(planes.reshape(r * s, w), src).reshape(r, s)
