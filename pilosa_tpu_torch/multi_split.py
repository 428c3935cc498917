"""Split plan_count_multi's device time into copies, programs and
reductions, for one or more checkouts, on one card.

    python -m pilosa_tpu_torch.multi_split DIR [DIR ...]
    python -m pilosa_tpu_torch.multi_split --layouts DIR

Each DIR is the root of a checkout holding chip_smoke.py and the port.
For each, a subprocess started in DIR builds three variants of its
`ops/cuda/bitmap_kernels.cu` with nvcc (all started together) and times
`plan_count_multi` through the checkout's own wrapper with each loaded in
turn, on the same seeded words:

- `copies`: the kernel with the roots' programs cut out, so only the
  leaf tiles' bulk copies, the ring's barriers and the flushes run;
- `programs`: the programs run, but each root's popcount is not reduced
  or added to any counter (a never-taken store keeps it live);
- `whole`: the kernel as built.

The variants are made by replacing the lines named in PATCHES in a copy
of the source; a source matching none of a variant's patterns is an
error. Only `whole` is held to the twin (the others count nothing). The
shapes are CASES, with chip_smoke's `multi_programs` roots. Prints one
JSON line per checkout; give two in mirrored order (A B B A) so that
drift shows.

With `--layouts`, the checkout's kernel as built is timed instead at
every (VEC, nbuf, L) of its ring and lanes that its launcher would accept
(`kernels.multi_launch_ok`), forced in turn, each held to the twin:
what the launcher's choice (`plan_count_multi_layout`) is measured
against.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# variant -> (old, new) replacements; each variant's list must match at
# least once in the source (one entry per kernel design the tool knows)
PATCHES = {
    "copies": [
        # the root loop of a plan_count_multi kernel: run zero roots
        ("    for (int r = 0; r < n_root; ++r) {\n      const int pc0", "    for (int r = 0; r < 0; ++r) {\n      const int pc0"),
        # the warp's share of the roots, in the kernel that splits them
        ("      for (int r = r0; r < r1; ++r) {\n        const int pc0", "      for (int r = r0; r < r0; ++r) {\n        const int pc0"),
    ],
    "programs": [
        # the design that reduces every root every item (warp sum, then a
        # shared-memory atomic)
        (
            "      const uint32_t n = warp_sum(popc4(top));\n"
            "      if ((tid & 31) == 0 && n != 0u) atomicAdd(&cnt[r], (unsigned long long)n);\n",
            "      if (popc4(top) == 0xffffffffu) cnt[r] = 1ull;\n",
        ),
        # the design that adds each root's popcount into the lane's own
        # counter
        ("        my_cnt[r * 32] += n;  // root r's count in this lane\n",
         "        if (n == 0xffffffffu) my_cnt[0] = 1u;\n"),
    ],
}

# case -> (roots, distinct leaves, shards S, words W): the batcher's
# timing row of chip_smoke phase 4, a full 64-root launch, and the served
# front end's round (10 Counts over 6 Rows at 512 shards)
CASES = {
    "16_over_8": (16, 8, 1024, 32768),
    "64_over_32": (64, 32, 1024, 32768),
    "10_over_6_s512": (10, 6, 512, 32768),
}

_RUN = r"""
import ctypes, json, subprocess, sys
from pathlib import Path
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke
from pilosa_tpu_torch.ops import kernels as K
patches, cases = json.loads(sys.argv[1]), json.loads(sys.argv[2])
paths = K.build()
src = K._SRC_DIR / "bitmap_kernels.cu"
text = src.read_text()
variants = {"whole": None}
procs = []
for name, subs in patches.items():
    out, hits = text, 0
    for old, new in subs:
        hits += out.count(old)
        out = out.replace(old, new)
    if hits == 0:
        raise SystemExit(f"variant {name}: no pattern matches {src}")
    cu = K._BUILD_DIR / f"split_{name}.cu"
    cu.write_text(out)
    so = K._BUILD_DIR / f"split_{name}.so"
    procs.append((name, so, subprocess.Popen([K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
                                             stderr=subprocess.PIPE, text=True)))
for name, so, p in procs:
    _, err = p.communicate()
    if p.returncode != 0:
        raise SystemExit(f"variant {name}: nvcc failed\n{err}")
    variants[name] = so
g = torch.Generator(device="cuda").manual_seed(0)
def words(n, s, w):
    return [torch.randint(-2**31, 2**31, (s, w), dtype=torch.int32, device="cuda", generator=g) for _ in range(n)]
out = {}
for case, (n_roots, n_leaves, s, w) in cases.items():
    leaves = words(n_leaves, s, w)
    progs = chip_smoke.multi_programs(np.random.default_rng(4), n_roots, n_leaves)
    used = len({i for p in progs for i in p if i >= 0})
    bound = (used * s * w * 4 + n_roots * s * 8) / chip_smoke.HBM_BYTES_PER_S * 1e3
    res = {"bound_ms": bound}
    for name, so in variants.items():
        libs = [so if (so is not None and p.name.startswith("libbitmap_kernels")) else p for p in paths]
        K._lib = K._Library([ctypes.CDLL(str(p)) for p in libs])
        fn = lambda: K.plan_count_multi(leaves, progs, s)
        if name == "whole" and not torch.equal(fn(), K.plan_count_multi_plain(leaves, progs, s)):
            raise SystemExit(case + " differs from its twin")
        res[name + "_ms"] = chip_smoke.cuda_time_ms(fn)
    res["share"] = bound / res["whole_ms"]
    out[case] = res
    del leaves
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


_LAYOUTS = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke
from pilosa_tpu_torch.ops import kernels as K
cases = json.loads(sys.argv[1])
chosen = K.plan_count_multi_layout
g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for case, (n_roots, n_leaves, s, w) in cases.items():
    leaves = [torch.randint(-2**31, 2**31, (s, w), dtype=torch.int32, device="cuda", generator=g) for _ in range(n_leaves)]
    progs = chip_smoke.multi_programs(np.random.default_rng(4), n_roots, n_leaves)
    used = len({i for p in progs for i in p if i >= 0})
    want = K.plan_count_multi_plain(leaves, progs, s)
    (group, slots, starts, codes, stack), = K.plan_count_multi_tables(progs)
    res = {"bound_ms": (used * s * w * 4 + n_roots * s * 8) / chip_smoke.HBM_BYTES_PER_S * 1e3,
           "chosen": list(chosen(len(group), len(slots), len(codes), stack))}
    shape = (len(group), len(slots), len(codes), stack)
    for vec in K.MULTI_VECS:
        for nbuf in (1, 2, 3, 4, 6):
            for lanes in K.MULTI_LANES:
                tab = K.multi_launch_ok(*shape, vec, nbuf, lanes, True)
                if not K.multi_launch_ok(*shape, vec, nbuf, lanes, tab):
                    continue
                K.plan_count_multi_layout = lambda *a, _l=(vec, nbuf, lanes, tab): _l
                fn = lambda: K.plan_count_multi(leaves, progs, s)
                if not torch.equal(fn(), want):
                    raise SystemExit(f"{case} at VEC {vec}, nbuf {nbuf}, L {lanes} differs from its twin")
                res[f"vec{vec}_nbuf{nbuf}_L{lanes}_ms"] = chip_smoke.cuda_time_ms(fn)
    K.plan_count_multi_layout = chosen
    out[case] = res
    del leaves, want
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--layouts", action="store_true", help="time every ring layout of the checkout's kernel")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for d in args.dirs:
        root = os.path.abspath(d)
        argv = [_LAYOUTS, json.dumps(CASES)] if args.layouts else [_RUN, json.dumps(PATCHES), json.dumps(CASES)]
        out = subprocess.run([sys.executable, "-c", *argv], cwd=root, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["root"] = root
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
