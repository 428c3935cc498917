"""The port's CLI subcommands against pilosa_tpu's on the same inputs.

`inspect` and `check` of one data dir (written by the port, with
snapshots, WAL tails, a torn WAL, a corrupt snapshot and a roaring file),
`config` (TOML file plus environment) and `generate-config` must print
what the reference's print and exit with the same codes. `import` and
`export` talk HTTP to a port server on a data dir. The server honours
`--hbm-extent-rows`, `--hbm-pin-timeout` and `--merge-device-threshold`
(they reach hbm.residency and core.merge) and, since the query front end
was ported, `--hbm-prefetch-depth`, `--anti-entropy-interval` and the
three resize knobs (they reach NodeServer) and `--join` (a subprocess
joins a running node and answers as a member); it still refuses each
unported knob beside them by name.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.cli.main import main as jmain
from pilosa_tpu.core import roaring_io as jroaring
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.cli.main import main as tmain
from pilosa_tpu_torch.core import devcache as tdevcache
from pilosa_tpu_torch.core import merge as tmerge
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.hbm import residency as tres
from pilosa_tpu_torch.server import NodeServer
from pilosa_tpu_torch.server import node as tnode
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

REPO = Path(__file__).resolve().parent.parent


def _both(capsys, argv_ref, argv_port):
    rc_ref = jmain(argv_ref)
    out_ref = capsys.readouterr().out
    rc_port = tmain(argv_port)
    out_port = capsys.readouterr().out
    assert (rc_port, out_port) == (rc_ref, out_ref)
    return rc_port, out_port


@pytest.fixture
def data_dir(tmp_path):
    """A port data dir: a set field past max_op_n (snapshots) and with a
    WAL tail, an int field, a mutex field and a second index."""
    d = tmp_path / "data"
    h = THolder(str(d), device="cpu").open()
    rng = np.random.default_rng(0)
    idx = h.create_index("i")
    f = idx.create_field("f")
    cols = rng.integers(0, 3 * SHARD_WIDTH, 40000).astype(np.uint64)
    f.import_bits(rng.integers(0, 5, len(cols)).astype(np.uint64), cols)
    idx.track_columns(cols)
    v = idx.create_field("v", FieldOptions(type="int", min=-50, max=50))
    v.import_values(cols[:500], rng.integers(-50, 51, 500))
    idx.create_field("m", FieldOptions(type="mutex"))
    TExecutor(h).execute("i", "Set(7, f=9) Set(8, m=2) Set(9, m=2) Clear(9, m=2) Set(5, v=-3)")
    h.create_index("j").create_field("x").set_bit(1, 2 * SHARD_WIDTH + 1)
    h.close()
    return d


def test_inspect_matches_reference(data_dir, capsys):
    rc, out = _both(capsys, ["inspect", str(data_dir)], ["inspect", str(data_dir), "--device", "cpu"])
    assert rc == 0 and "i/f/standard/shard=2: rows=5" in out and "i/v/bsig_v/" in out
    for flt in (["--index", "j"], ["--index", "i", "--field", "m"]):
        _both(capsys, ["inspect", str(data_dir), *flt], ["inspect", str(data_dir), "--device", "cpu", *flt])


def test_check_matches_reference(data_dir, tmp_path, capsys):
    rc, out = _both(capsys, ["check", str(data_dir)], ["check", str(data_dir)])
    assert rc == 0 and ".snap: ok" in out and ".wal: ok" in out and "CORRUPT" not in out
    # a torn WAL tail is fine (replay drops it); a cut snapshot is not
    wal = next(p for p in data_dir.rglob("*.wal") if p.stat().st_size)
    with open(wal, "ab") as fh:
        fh.write(b"PTWL\x00")
    rc, out = _both(capsys, ["check", str(wal)], ["check", str(wal)])
    assert rc == 0 and "discarded on replay" in out
    snap = next(data_dir.rglob("*.snap"))
    snap.write_bytes(snap.read_bytes()[:-5])
    roaring = tmp_path / "x.roaring"
    roaring.write_bytes(jroaring.encode(np.arange(0, 5000, 3, dtype=np.uint64)))
    other = tmp_path / "notes.txt"
    other.write_text("x")
    argv = ["check", str(data_dir), str(roaring), str(other)]
    rc, out = _both(capsys, argv, argv)
    assert rc == 1 and "CORRUPT" in out and "dialect=" in out and "skipped" in out


def test_config_and_generate_config_match_reference(tmp_path, capsys, monkeypatch):
    toml = tmp_path / "c.toml"
    toml.write_text('data-dir = "/srv/p"\nbind = "0.0.0.0:9000"\n[wal]\nsync-interval = 0.25\n[cluster]\nreplicas = 2\n')
    monkeypatch.setenv("PILOSA_TPU_MAX_WRITES_PER_REQUEST", "77")
    rc, out = _both(capsys, ["--config", str(toml), "config"], ["--config", str(toml), "config"])
    assert rc == 0 and 'data-dir = "/srv/p"' in out and "sync-interval = 0.25" in out
    assert "max-writes-per-request = 77" in out
    rc, out = _both(capsys, ["generate-config"], ["generate-config"])
    assert rc == 0 and "sync-interval = 0.0" in out


def test_import_and_export_over_http(tmp_path, capsys):
    srv = NodeServer(str(tmp_path / "d"), "n0", bind="localhost:0", device="cpu").start()
    try:
        csv = tmp_path / "bits.csv"
        csv.write_text("# row,col\n1,5\n1,7\n2,%d\n" % (SHARD_WIDTH + 3))
        assert tmain(["import", "--host", srv.node.uri, "-i", "i", "-f", "f", "--create", str(csv)]) == 0
        vals = tmp_path / "vals.csv"
        vals.write_text("4,5\n9,6\n")
        argv = ["import", "--host", srv.node.uri, "-i", "i", "-f", "v", "--create", "--field-type", "int", str(vals)]
        assert tmain(argv) == 0
        assert "imported 2 records" in capsys.readouterr().err
        assert tmain(["export", "--host", srv.node.uri, "-i", "i", "-f", "f"]) == 0
        assert capsys.readouterr().out == f"1,5\n1,7\n2,{SHARD_WIDTH + 3}\n"
        out = tmp_path / "out.csv"
        assert tmain(["export", "--host", srv.node.uri, "-i", "i", "-f", "f", "-o", str(out)]) == 0
        assert out.read_text().count("\n") == 3
        res = srv.executor.execute("i", "Sum(field=v) Count(Row(f=1))")
        assert (res[0].value, res[0].count, res[1]) == (13, 2, 2)
    finally:
        srv.stop()
    assert os.path.exists(tmp_path / "d" / "i" / "v" / ".meta.json")


def test_import_with_keys_and_inspect_keyed_dir(tmp_path, capsys):
    """`import --index-keys --field-keys` loads row and column keys; the
    export writes them back; `inspect` and `check` of the keyed data dir
    print what the reference's print."""
    d = tmp_path / "d"
    srv = NodeServer(str(d), "n0", bind="localhost:0", device="cpu").start()
    try:
        uri = srv.node.uri
        csv = tmp_path / "keys.csv"
        csv.write_text("seg-a,user-1\nseg-b,user-2\nseg-a,user-3\n")
        argv = ["import", "--host", uri, "-i", "k", "-f", "seg", "--create", "--index-keys", "--field-keys", str(csv)]
        assert tmain(argv) == 0
        plan = tmp_path / "plan.csv"
        plan.write_text("2,user-2\n0,user-9\n")
        assert tmain(["import", "--host", uri, "-i", "k", "-f", "plan", "--create", "--index-keys", str(plan)]) == 0
        assert "imported 2 records" in capsys.readouterr().err
        assert tmain(["export", "--host", uri, "-i", "k", "-f", "seg"]) == 0
        assert capsys.readouterr().out == "seg-a,user-1\nseg-a,user-3\nseg-b,user-2\n"
        assert tmain(["export", "--host", uri, "-i", "k", "-f", "plan"]) == 0
        assert capsys.readouterr().out == "0,user-9\n2,user-2\n"
        res = srv.executor.execute("k", 'Count(Row(seg="seg-a")) Rows(seg) Row(plan=2)')
        assert res[:2] == [2, ["seg-a", "seg-b"]] and res[2].keys == ["user-2"]
    finally:
        srv.stop()
    assert (d / "k" / ".keys.translate").exists() and (d / "k" / "seg" / ".keys.translate").exists()
    rc, out = _both(capsys, ["inspect", str(d)], ["inspect", str(d), "--device", "cpu"])
    assert rc == 0 and "k/seg/standard/shard=0: rows=2 bits=3" in out
    rc, _ = _both(capsys, ["check", str(d)], ["check", str(d)])
    assert rc == 0


@pytest.fixture
def knobs():
    """Restore the process-wide knobs the server installs."""
    saved = (tres.extent_rows(), tdevcache.default_pin_timeout(), tmerge._device_threshold)
    yield
    tres.configure(extent_rows=saved[0], pin_timeout=saved[1])
    tmerge.configure(device_threshold=saved[2])


def test_server_knobs_reach_residency_and_merge(knobs, monkeypatch):
    """The three flags pass through the CLI into NodeServer, which
    installs them process-wide."""
    seen = {}

    class Stop(Exception):
        pass

    class FakeNode(NodeServer):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **kw)

        def start(self):
            self.stop()  # puts back the process-wide result-cache budget
            raise Stop

    monkeypatch.setattr(tnode, "NodeServer", FakeNode)
    argv = ["server", "--data-dir", "", "--device", "cpu", "--hbm-extent-rows", "8",
            "--hbm-pin-timeout", "2.5", "--merge-device-threshold", "123"]
    with pytest.raises(Stop):
        tmain(argv)
    assert (seen["hbm_extent_rows"], seen["hbm_pin_timeout"], seen["merge_device_threshold"]) == (8, 2.5, 123)
    assert (tres.extent_rows(), tdevcache.default_pin_timeout(), tmerge.device_threshold()) == (8, 2.5, 123)
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu"])
    assert (tres.extent_rows(), tdevcache.default_pin_timeout()) == (256, 60.0)
    assert tmerge._device_threshold is None


def test_server_refuses_prefetch_depth_by_name():
    """`--hbm-prefetch-depth` is ported now: beside an unported knob only
    that knob is named in the refusal."""
    with pytest.raises(SystemExit) as ei:
        tmain(["server", "--data-dir", "", "--device", "cpu", "--hbm-extent-rows", "8", "--hbm-prefetch-depth", "4",
               "--shed-retry-after", "2"])
    msg = str(ei.value)
    assert "--shed-retry-after" in msg and "not yet ported" in msg
    assert "--hbm-prefetch-depth" not in msg and "--hbm-extent-rows" not in msg


def test_server_subprocess_serves_with_the_knobs():
    """The CLI server with the three options serves a query and exits 0
    on SIGTERM."""
    p = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir", "", "--bind", "127.0.0.1:0",
         "--device", "cpu", "--hbm-extent-rows", "0", "--hbm-pin-timeout", "1", "--merge-device-threshold", "-1"],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = p.stderr.readline()
        m = re.search(r"listening on http://([^:]+):(\d+)", line)
        assert m, line
        import http.client

        conn = http.client.HTTPConnection(m.group(1), int(m.group(2)), timeout=30)
        for path, body in (("/index/i", b"{}"), ("/index/i/field/f", b"{}"), ("/index/i/query", b"Set(3, f=1) Count(Row(f=1))")):
            conn.request("POST", path, body)
            resp = conn.getresponse()
            out = resp.read()
            assert resp.status == 200, out
        assert b'"results": [true, 1]' in out or b'"results":[true,1]' in out, out
        conn.close()
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        p.stderr.close()


def _unported_flags():
    """(flag, a value away from its default) of every server knob whose
    feature the port lacks."""
    import importlib

    # the module: the package's `main` attribute is the function
    cli = importlib.import_module("pilosa_tpu_torch.cli.main")
    defaults = cli.Config()
    out = []
    for dest, (section, knob) in cli._FLAG_KNOBS.items():
        if (section, knob) in cli._PORTED_KNOBS:
            continue
        flag = "--" + dest.replace("_", "-")
        default = cli._knob(defaults, section, knob)
        if isinstance(default, bool):
            out.append((flag, [flag] if not default else [flag, "false"]))
        elif isinstance(default, (int, float)):
            out.append((flag, [flag, str(default * 2 + 1)]))
        elif isinstance(default, list):
            out.append((flag, [flag, "x"]))
        else:
            out.append((flag, [flag, default + "x"]))
    return out


def test_server_takes_the_anti_entropy_interval(monkeypatch):
    """`--anti-entropy-interval` is ported: it reaches NodeServer, whose
    default (the reference's 0.0) runs a pass only on demand."""
    seen = {}

    class Stop(Exception):
        pass

    class FakeNode(NodeServer):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **kw)

        def start(self):
            self.stop()  # puts back the process-wide result-cache budget
            raise Stop

    monkeypatch.setattr(tnode, "NodeServer", FakeNode)
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu", "--anti-entropy-interval", "2.5"])
    assert seen["anti_entropy_interval"] == 2.5
    seen.clear()
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu"])
    assert seen["anti_entropy_interval"] == 0.0
    srv = NodeServer(None, "n", device="cpu")
    try:
        assert srv.anti_entropy_interval == 0.0
    finally:
        srv.stop()


@pytest.mark.parametrize("flag,argv", _unported_flags(), ids=[f for f, _ in _unported_flags()])
def test_server_still_refuses_each_unported_knob(flag, argv):
    """Beside the ported `--anti-entropy-interval`, every knob whose
    feature is not ported is refused by its name, and only it."""
    with pytest.raises(SystemExit) as ei:
        tmain(["server", "--data-dir", "", "--device", "cpu", "--anti-entropy-interval", "0.5"] + argv)
    msg = str(ei.value)
    assert flag in msg and "not yet ported" in msg, msg
    assert "--anti-entropy-interval" not in msg


@pytest.mark.parametrize(
    "flag,value,kw,want",
    [
        ("--resize-transfer-concurrency", "7", "resize_transfer_concurrency", 7),
        ("--resize-cutover-timeout", "4.5", "resize_cutover_timeout", 4.5),
        ("--resize-resume-policy", "abort", "resize_resume_policy", "abort"),
    ],
)
def test_server_takes_the_resize_knobs(monkeypatch, flag, value, kw, want):
    """The resize knobs are ported: each reaches NodeServer and the node
    keeps it; a resume policy outside resume|abort exits naming it."""
    seen = {}

    class Stop(Exception):
        pass

    class FakeNode(NodeServer):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **kw)

        def start(self):
            seen["node"] = {k: getattr(self, k) for k in ("resize_transfer_concurrency", "resize_cutover_timeout", "resize_resume_policy")}
            self.stop()
            raise Stop

    monkeypatch.setattr(tnode, "NodeServer", FakeNode)
    with pytest.raises(Stop):
        tmain(["server", "--data-dir", "", "--device", "cpu", flag, value])
    assert seen[kw] == want and seen["node"][kw] == want
    from pilosa_tpu_torch.core.resultcache import RESULT_CACHE

    budget = RESULT_CACHE.budget_bytes
    with pytest.raises(SystemExit) as ei:
        tmain(["server", "--data-dir", "", "--device", "cpu", "--resize-resume-policy", "sometimes"])
    assert "resize_resume_policy" in str(ei.value)
    assert RESULT_CACHE.budget_bytes == budget  # refused before any process-wide setting moved


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_join_on_boot_subprocess(tmp_path):
    """A fresh `server --join <coordinator>` process asks the coordinator
    to admit it, waits for the job and then serves the whole index as a
    member (the reference's tests/test_lifecycle.py join-on-boot case)."""
    import json
    import time
    import urllib.request

    def http(method, uri, path, body=None, timeout=60):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(uri + path, data=data, method=method, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read() or b"{}")

    coord = NodeServer(str(tmp_path / "c0"), "c0", device="cpu").start()
    port = _free_port()
    p = None
    try:
        http("POST", coord.node.uri, "/index/jb", {"options": {}})
        http("POST", coord.node.uri, "/index/jb/field/f", {"options": {"type": "set"}})
        cols = [s * SHARD_WIDTH + 2 for s in range(16)]
        http("POST", coord.node.uri, "/index/jb/field/f/import", {"rows": [0] * len(cols), "cols": cols})
        p = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir", str(tmp_path / "j1"),
             "--bind", f"127.0.0.1:{port}", "--node-id", "j1", "--device", "cpu", "--join", coord.node.uri],
            cwd=REPO, stderr=subprocess.PIPE, text=True,
        )
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = p.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "listening on" in line:
                break
        assert any("joined cluster of 2 nodes" in ln for ln in lines), lines
        uri1 = f"http://127.0.0.1:{port}"
        for uri in (coord.node.uri, uri1):
            st = http("GET", uri, "/status")
            assert len(st["nodes"]) == 2 and st["state"] == "NORMAL", st
        assert http("POST", uri1, "/index/jb/query", {"query": "Count(Row(f=0))"})["results"] == [len(cols)]
        assert coord.resize_job["state"] == "DONE" and coord.resize_job["action"] == "add-node"
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == 0
    finally:
        if p is not None:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p.stderr.close()
        coord.stop()


def test_join_on_boot_reregisters_after_a_rollback():
    """The join loop on a virtual clock: a busy coordinator is asked again,
    and a join whose job rolled back (the node alone 10 s after it
    registered) registers again."""
    import types

    import importlib

    climain = importlib.import_module("pilosa_tpu_torch.cli.main")
    from pilosa_tpu_torch.server.client import ClientError

    now = [0.0]
    calls = []

    class Wake:
        def wait(self, t):
            now[0] += t

    class Client:
        def join_cluster(self, uri, payload):
            calls.append(now[0])
            if len(calls) == 1:
                raise ClientError("a resize job is already running")
            if len(calls) == 3:  # the second job commits
                srv.cluster.nodes = [srv.node, types.SimpleNamespace(id="c0")]
            return {"state": "RUNNING"}

    me = types.SimpleNamespace(id="j1", uri="http://j1")
    srv = types.SimpleNamespace(node=me, cluster=types.SimpleNamespace(nodes=[me]), state="NORMAL", client=Client())
    climain._join_on_boot(srv, "http://c0", timeout=100.0, clock=lambda: now[0], wake=Wake())
    assert len(calls) == 3 and calls[1] == 1.0 and calls[2] > 11.0
    srv.cluster.nodes = [me]
    calls.clear()
    Client.join_cluster = lambda self, uri, payload: {}
    with pytest.raises(SystemExit):
        climain._join_on_boot(srv, "http://c0", timeout=30.0, clock=lambda: now[0], wake=Wake())
