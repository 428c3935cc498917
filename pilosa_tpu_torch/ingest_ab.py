"""Time the in-memory ingest and queries of chip_smoke.py's main and BSI
phases for several checkouts in turn, on one card.

    python -m pilosa_tpu_torch.ingest_ab DIR [DIR ...]

Each DIR is the root of a checkout holding chip_smoke.py and the port.
For each, in the order given, a subprocess started in DIR builds the
kernels and runs chip_smoke's `main_path` and `bsi_path` (with the
columns `residency_bursts` draws, as chip_smoke's own run has them) on
fresh data from seed 0 at chip_smoke's default 1024 shards, with no kernel phase
before them; this script prints one JSON line per run with the figures
it read: ingest, first pass and each query's warm p50. Give two
checkouts in mirrored order (A B B A) so that the host's drift shows.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_RUN = """
import argparse, json, sys, time
import numpy as np
sys.path.insert(0, ".")
import chip_smoke
from pilosa_tpu_torch.ops import kernels as K
K.build()
K.library()
args = argparse.Namespace(shards=1024, seed=0)
holder, ex, _, lat, ingest_s, _, state = chip_smoke.main_path(args, np.random.default_rng(0))
state["g_burst"] = chip_smoke.residency_bursts(args.seed, args.shards)["g_burst"]
_, bsi_lat, bsi = chip_smoke.bsi_path(args, holder, ex, state)
print(json.dumps({"main_ingest_s": ingest_s, "bsi": bsi, "main_p50_ms": lat, "bsi_p50_ms": bsi_lat}))
"""


def run_one(root: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", _RUN],
        cwd=root, capture_output=True, text=True, timeout=900,
    )
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    m = re.search(r"first pass of the queries \(staging included\) ([0-9.]+) s", out.stdout)
    res["main_first_pass_s"] = float(m.group(1)) if m else None
    res["root"] = root
    return res


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
        print(json.dumps(run_one(os.path.abspath(d))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
