"""Time chip_smoke.py's serve phase for several checkouts in turn, on one
card: what the served query front end (admission, the Count batcher)
adds to a served query.

    python -m pilosa_tpu_torch.serve_ab DIR [DIR ...]

Each DIR is the root of a checkout holding chip_smoke.py and the port.
For each, in the order given, a subprocess started in DIR builds the
kernels and runs chip_smoke's `serve_path` (seed 0, 512 shards: a data
dir loaded over HTTP, the first pass, then each query's served and
in-process warm p50 and 8 concurrent clients) without the sub-phases
that follow them (keyed index, time fields, attributes, the front-end
phase, the CLI). Where the checkout has admission, the same run also
times on the served index, per query, the cost estimate alone and the
whole admission call (estimate, prefetch peek, grant and release). One
JSON line a run. Give two checkouts in mirrored order (A B B A) so that
the host's drift shows.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_RUN = """
import argparse, json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from pilosa_tpu_torch.ops import kernels as K
K.build()
K.library()


def keyed(args, http, srv):
    out = {"served": None}
    if getattr(srv, "scheduler", None) is not None:
        from pilosa_tpu_torch.exec.executor import ExecOptions
        from pilosa_tpu_torch.pql import parse
        from pilosa_tpu_torch.sched import cost

        idx = srv.holder.index("s")
        out["admission_ms"] = {}
        for q in cs.SERVE_QUERIES:
            query = parse(q)
            out["admission_ms"][q] = {
                "estimate": cs.host_p50_ms(lambda: cost.estimate(idx, query)),
                "admit": cs.host_p50_ms(lambda: srv.api._admit("s", query, None, None, ExecOptions()).release()),
            }
    return out


cs.keyed_path = keyed
cs.serve_time = lambda *a: {"served": None}
cs.serve_attrs = lambda *a: {"served": None}
cs.front_end_path = lambda *a: {}
cs.cli_check = lambda: None
recovered, res = cs.serve_path(argparse.Namespace(shards=1024, seed=0))
print(json.dumps({"data_dir": recovered["data_dir"], "query_p50_ms": res["query_p50_ms"],
                  "concurrent_s": res["concurrent_s"], "first_pass_s": res["first_pass_s"],
                  "admission_ms": res["keyed"].get("admission_ms")}))
"""


def run_one(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=root, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    shutil.rmtree(res.pop("data_dir"), ignore_errors=True)
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
