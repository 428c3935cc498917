"""Stacked operand staging: whole-stack residency through the device cache.

The port's slice of pilosa_tpu/hbm/residency.py. A stack is one row (or a
set of rows) materialized across a shard list as a dense int32 device
tensor, built from host words once and kept in the holder's DeviceCache
under a key that carries every covered fragment's mutation version, so a
write to any covered fragment makes the key miss and the next query
re-stages. Extent paging, pins and prefetch are not ported: a stack is
staged whole.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.ops.bitmap import from_host


def stage_row_stack(
    cache: DeviceCache,
    key_base: Tuple,
    versions: Tuple[int, ...],
    build: Callable[[], np.ndarray],
    device: torch.device,
) -> torch.Tensor:
    """The device operand for `key_base` at fragment `versions`: cached,
    or built from the host words `build()` returns (uint32[S, W] for a
    row stack) and uploaded once."""
    return cache.get_or_build(
        key_base + ("mono", versions), lambda: from_host(build(), device)
    )


# a plane stack (uint32[D, S, W]: D rows x S shards) stages the same way
stage_plane_stack = stage_row_stack
