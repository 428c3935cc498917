"""Split the served timestamped ingest's time by where the data dir lies
and by how the time views are written.

    python -m pilosa_tpu_torch.time_ingest_ab [--shards N] [--device cpu]
        [--imports port,deferred,exact] [--dirs tmp,shm,memory]

Run from the root of a checkout (it reads chip_smoke.py's served time
configuration). For every pair of an import mode and a data dir, in the
order given, an in-process NodeServer takes the served time phase's
load: a YMDH time field `st` and a bool field `sb` on index `s`,
SERVE_TIME_BITS timestamped `/import` bits (unix seconds over 48 hours,
rows 0-2) on random columns of N shards, in POSTs of IMPORT_BATCH bits,
each followed by the same columns' bool `/import`; then the first
`Count` of a time range. Import modes:

- port: `Field.import_bits` as it is: each unit view staged, then merged
  at once by its read barrier (`View.sync_pending`);
- deferred: each unit view staged, its merge left to the next read;
- exact: each unit view written through the per-fragment exact path
  (`Fragment.bulk_import`), as the reference's `Field.import_bits` does.

Data dirs: tmp (a fresh dir under the default temp dir), shm (one under
/dev/shm, a tmpfs; skipped where there is none) and memory (no data
dir). Prints one JSON line per run: seconds in the `st` POSTs, in the
`sb` POSTs, of the first Count, fragments and files made, and the
filesystem; for the first run also the functions the threads inside the
server's API were sampled in most (every 5 ms; innermost frame, and
anywhere on the stack), as shares of the samples.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np


def _sampler(stop: threading.Event, own: set, leaf: collections.Counter, stack: collections.Counter) -> None:
    """Every 5 ms, count the innermost function and every function on the
    stack of each thread that is inside the server's API (server/api.py)."""
    while not stop.wait(0.005):
        for tid, frame in sys._current_frames().items():
            if tid in own:
                continue
            keys = []
            while frame is not None:
                keys.append(f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_code.co_name}")
                frame = frame.f_back
            if not any(k.startswith("api.py:") for k in keys):
                continue
            leaf[keys[0]] += 1
            stack.update(set(keys))


def _import_bits_for(mode: str):
    """Field.import_bits with its time views written the `mode` way."""
    from pilosa_tpu_torch.core import field as fieldmod
    from pilosa_tpu_torch.core import wal as walmod

    real = fieldmod.Field.import_bits
    if mode == "port":
        return real

    def import_bits(self, row_ids, cols, timestamps=None, clear=False):
        if timestamps is None or not self.options.time_quantum:
            return real(self, row_ids, cols, timestamps, clear)
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        shards = cols >> np.uint64(fieldmod.SHARD_WIDTH_EXPONENT)
        with walmod.GROUP_COMMIT.barrier():
            self._import_view(fieldmod.VIEW_STANDARD, row_ids, cols, shards, not clear, clear)
            for vname, sel in self._time_view_groups(timestamps):
                self._import_view(vname, row_ids[sel], cols[sel], shards[sel], mode == "deferred", clear)

    return import_bits


def run_one(cs, imports: str, where: str, n_shards: int, device, profile: bool) -> dict:
    from pilosa_tpu_torch.core import field as fieldmod
    from pilosa_tpu_torch.server import NodeServer
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    if where == "memory":
        data_dir = None
    else:
        data_dir = tempfile.mkdtemp(prefix="time_ingest_ab_", dir="/dev/shm" if where == "shm" else None)
    rng = np.random.default_rng(11)
    n = cs.SERVE_TIME_BITS
    cols = rng.integers(0, n_shards * SHARD_WIDTH, n).astype(np.int64)
    rows = rng.integers(0, 3, n)
    secs = cs.SERVE_TIME_START + rng.integers(0, 48 * 3600, n)
    bools = rng.integers(0, 2, n)
    real = fieldmod.Field.import_bits
    fieldmod.Field.import_bits = _import_bits_for(imports)
    srv = NodeServer(data_dir, "ab", bind="127.0.0.1:0", device=device, max_writes_per_request=0).start()
    http = cs._Http(srv.node.uri)
    leaf, stack = collections.Counter(), collections.Counter()
    stop, own = threading.Event(), {threading.get_ident()}
    sampler = threading.Thread(target=_sampler, args=(stop, own, leaf, stack), daemon=True)
    try:
        http.json("POST", "/index/s", {"options": {"trackExistence": True}})
        http.json("POST", "/index/s/field/st", {"options": {"type": "time", "timeQuantum": cs.TIME_QUANTUM}})
        http.json("POST", "/index/s/field/sb", {"options": {"type": "bool"}})
        if profile:
            sampler.start()
            own.add(sampler.ident)
        st_s = sb_s = 0.0
        for i in range(0, n, cs.IMPORT_BATCH):
            sl = slice(i, i + cs.IMPORT_BATCH)
            t0 = time.perf_counter()
            body = {"rows": rows[sl].tolist(), "cols": cols[sl].tolist(), "timestamps": secs[sl].tolist()}
            out = http.json("POST", "/index/s/field/st/import", body)
            t1 = time.perf_counter()
            cs.check(out["errors"] == [], f"timestamped /import: {out}")
            out = http.json("POST", "/index/s/field/sb/import", {"rows": bools[sl].tolist(), "cols": cols[sl].tolist()})
            cs.check(out["errors"] == [], f"bool /import: {out}")
            st_s += t1 - t0
            sb_s += time.perf_counter() - t1
        stop.set()
        t0 = time.perf_counter()
        got = http.pql(f"Count(Row(st=0, {cs.SERVE_TIME_RANGE}))")
        first_s = time.perf_counter() - t0
        hours = (secs - cs.SERVE_TIME_START) // 3600
        sel = (hours >= 5) & (hours < 43) & (rows == 0)
        cs.check(got == [len(np.unique(cols[sel]))], f"Count of the range {got}, numpy {len(np.unique(cols[sel]))}")
        views = srv.holder.index("s").field("st").views
        res = {
            "imports": imports,
            "dir": where,
            "filesystem": "none" if data_dir is None else cs._filesystem(data_dir),
            "shards": n_shards,
            "bits": n,
            "st_import_s": st_s,
            "sb_import_s": sb_s,
            "st_bits_per_s": n / st_s,
            "first_count_s": first_s,
            "st_views": len(views),
            "st_fragments": sum(len(v.fragments) for v in views.values()),
            "files": 0 if data_dir is None else sum(len(f) for _, _, f in os.walk(data_dir)),
        }
        if profile:
            total = max(1, sum(leaf.values()))
            res["samples"] = total
            res["leaf_top"] = [(k, round(v / total, 4)) for k, v in leaf.most_common(15)]
            res["stack_top"] = [(k, round(v / total, 4)) for k, v in stack.most_common(25)]
        return res
    finally:
        stop.set()
        http.close()
        srv.stop()
        srv.holder.close()
        fieldmod.Field.import_bits = real
        if data_dir is not None:
            shutil.rmtree(data_dir, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=128)
    ap.add_argument("--device", default=None, help="cpu to run without a card")
    ap.add_argument("--imports", default="port,deferred,exact")
    ap.add_argument("--dirs", default="tmp,shm,memory")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"device: {smi}", flush=True)
    first, failed = True, False
    for where in args.dirs.split(","):
        if where == "shm" and not os.path.isdir("/dev/shm"):
            print(json.dumps({"dir": "shm", "skipped": "no /dev/shm"}), flush=True)
            continue
        for imports in args.imports.split(","):
            try:
                res = run_one(cs, imports, where, args.shards, args.device, first)
            except Exception as e:  # a dir that fills up ends its run, not the others
                res = {"imports": imports, "dir": where, "error": f"{type(e).__name__}: {e}"[:500]}
                failed = True
            print(json.dumps(res), flush=True)
            first = False
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
