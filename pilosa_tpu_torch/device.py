"""Device selection for the port's entry points.

Every entry point takes an explicit `device`. None means the GPU: the port
is written for one CUDA card, and a missing card is an error, never a quiet
move to the CPU. The CPU runs only when the caller asks for it (the tests
do), and then every kernel function takes its plain-PyTorch twin.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain-PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
