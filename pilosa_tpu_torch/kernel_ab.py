"""Time the GroupBy and multi-Count kernels of several checkouts in turn,
on one card.

    python -m pilosa_tpu_torch.kernel_ab DIR [DIR ...]

Each DIR is the root of a checkout holding chip_smoke.py and the port.
For each, in the order given, a subprocess started in DIR builds its
kernels and times them with chip_smoke's `cuda_time_ms` on the same
seeded words, at the shapes of chip_smoke's main-path GroupBys (S = 1024
shards of W = 32768 words): gather_and of 2 rows with one filter slab
(the filtered selection), gather_and of 2 prefixes x 4 rows (a cross
expansion) and counts_cross of 2 prefixes x 4 rows; counts_cross at the
cluster GroupBy's leg shapes (11 prefixes x 8 rows over 171 shards, 8 x
8 over 256 with a node down) and at the one-shot shape (16 x 8 over 64);
and
plan_count_multi at the Count batcher's timing row (16 roots of 1-4 Rows
over 8 leaves), at a full 64-root launch over 32 leaves, and at the
served front end's round (10 roots over 6 leaves at 512 shards), the
roots from chip_smoke's `multi_programs` with seed 4. Each result is held
to its twin, and each bound reads every distinct operand slab once and
writes every output once, over 3.35 TB/s. Prints one JSON line per run;
give two checkouts in mirrored order (A B B A) so that drift shows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke
from pilosa_tpu_torch.ops import kernels as K
K.build()
K.library()
S, W = 1024, 32768
g = torch.Generator(device="cuda").manual_seed(0)
words = lambda n: torch.randint(-2**31, 2**31, (n, S, W), dtype=torch.int32, device="cuda", generator=g)
rows, filt, planes = words(2), words(1), words(4)
slab = S * W * 4
cases = {
    "gather_and_filtered": (lambda: K.gather_and(rows, [0, 1], filt, [0, 0]),
                            lambda: K.gather_and_plain(rows, [0, 1], filt, [0, 0]), (2 + 1 + 2) * slab),
    "gather_and_cross_2x4": (lambda: K.gather_and(rows, np.repeat(np.arange(2), 4), planes, np.tile(np.arange(4), 2)),
                             lambda: K.gather_and_plain(rows, np.repeat(np.arange(2), 4), planes, np.tile(np.arange(4), 2)),
                             (2 + 4 + 8) * slab),
    "counts_cross_2x4": (lambda: K.counts_cross(rows, planes), lambda: K.counts_cross_plain(rows, planes),
                         (2 + 4) * slab + 2 * 4 * S * 4),
}
for gg, rr, ss in ((11, 8, 171), (8, 8, 256), (16, 8, 64)):
    acc = torch.randint(-2**31, 2**31, (gg, ss, W), dtype=torch.int32, device="cuda", generator=g)
    pl = torch.randint(-2**31, 2**31, (rr, ss, W), dtype=torch.int32, device="cuda", generator=g)
    cases[f"counts_cross_{gg}x{rr}_s{ss}"] = (lambda acc=acc, pl=pl: K.counts_cross(acc, pl),
                                             lambda acc=acc, pl=pl: K.counts_cross_plain(acc, pl),
                                             (gg + rr) * ss * W * 4 + gg * rr * ss * 4)
for name, n_roots, n_leaves, s in (("plan_count_multi_16x8", 16, 8, S), ("plan_count_multi_64x32", 64, 32, S),
                                   ("plan_count_multi_10x6_s512", 10, 6, 512)):
    leaves = list(words(n_leaves))  # the first s shard rows of each are read
    progs = chip_smoke.multi_programs(np.random.default_rng(4), n_roots, n_leaves)
    used = len({i for p in progs for i in p if i >= 0})
    cases[name] = (lambda leaves=leaves, progs=progs, s=s: K.plan_count_multi(leaves, progs, s),
                   lambda leaves=leaves, progs=progs, s=s: K.plan_count_multi_plain(leaves, progs, s),
                   used * s * W * 4 + n_roots * s * 8)
out = {}
for name, (fn, plain, nbytes) in cases.items():
    if not torch.equal(fn(), plain()):
        raise SystemExit(name + " differs from its twin")
    ms = chip_smoke.cuda_time_ms(fn)
    bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    out[name] = {"ms": ms, "bound_ms": bound, "share": bound / ms}
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for d in args.dirs:
        root = os.path.abspath(d)
        out = subprocess.run([sys.executable, "-c", _RUN], cwd=root, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["root"] = root
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
