"""Measure how fast this card runs the binary tensor-core product that
counts_cross is built on.

    python -m pilosa_tpu_torch.b1_probe

Builds the port's kernels and launches `b1_mma_probe_kernel`
(ops/cuda/bitmap_kernels.cu): 16 blocks of 8 warps per SM, each warp
running 8 independent chains of `mma.sync.aligned.m16n8k256 .b1 .and.popc`
on register words, so the figure is the tensor pipe's issue rate and not
a chain's latency. Times the launch between two CUDA events (best of 5)
and prints one JSON line: the card's name and power limit, the SM clock
nvidia-smi read right after, the mma's per microsecond per SM, and what
that rate makes of the m16n8k256 mma's that counts_cross issues at the
cluster GroupBy leg's shape (G = 11 prefixes x R = 8 rows over S = 171
shards of W = 32768 words: S * W / 8 mma's of one 16 x 8 tile), beside
that shape's byte bound at 3.35 TB/s.
"""

from __future__ import annotations

import json
import subprocess
import sys

SMS = 132
WARPS_PER_BLOCK = 8
CHAINS = 8  # kProbeChains in bitmap_kernels.cu
HBM_BYTES_PER_S = 3.35e12


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("b1_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = K.library()
    blocks, iters = SMS * 16, 4096
    sink = torch.zeros(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch() -> None:
        rc = lib.pt_b1_mma_probe(blocks, iters, sink.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"b1 probe launch failed: CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    clock_mhz = _smi("clocks.sm")
    mmas = blocks * WARPS_PER_BLOCK * iters * CHAINS
    per_us_per_sm = mmas / (best * 1e3) / SMS
    s, w, g, r = 171, 32768, 11, 8
    leg_mmas = s * w // 8
    leg_bound_ms = ((g + r) * s * w * 4 + g * r * s * 4) / HBM_BYTES_PER_S * 1e3
    print(json.dumps({
        "card": _smi("name,power.limit"),
        "sm_clock": clock_mhz,
        "probe_ms": best,
        "mma": mmas,
        "mma_per_us_per_sm": per_us_per_sm,
        "bit_ops_per_s": mmas * 16 * 8 * 256 * 2 / (best * 1e-3),
        "leg_mma": leg_mmas,
        "leg_mma_ms": leg_mmas / (per_us_per_sm * SMS) / 1e3,
        "leg_bound_ms": leg_bound_ms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
