"""Elastic resize: a node joins or leaves a loaded cluster under writes.

The port of the reference's streaming resize (pilosa_tpu/server/node.py,
the resize job and its transfer plane) as a mixin of NodeServer, without
the tier snapshot-bootstrap branch: a moving fragment always streams from
its peer.

A moving fragment ships in two steps. The destination GETs
/internal/fragment/data?capture=<tag>, which snapshots the fragment and
arms a write capture on the source under one lock hold
(`Fragment.begin_streaming`); it then drains the capture
(/internal/fragment/delta) in catch-up rounds until a round comes back
empty. Captures are leased: a capture no drain touched for CAPTURE_LEASE
seconds is dropped, so a dead coordinator cannot leave a source buffering
writes. Each destination has a capture of its own (`<job>:<node id>`).

The coordinator's job (`start_resize`, a thread running `_run_resize`)
goes probe -> stream (each new member's `resize_stream`, members first,
joiners last, the old placement serving reads and writes meanwhile) ->
cutover (the sources' cutover write barrier on every armed capture, one
drain round on every destination, then the new membership installed on
every new member, each acknowledging it: the commit point) -> sweep
(fragments a write made after a destination's inventory walk, merged,
no capture) -> gc (the holder cleaner on every node). A failure or an
abort before the commit rolls back: the old membership everywhere, every
fragment the job created deleted, every capture released. After the
commit the job only rolls forward, and every moved shard owes its new
owner a pending repair, which the job's own anti-entropy pass drains.

The reference keeps the resize counters on its stats plane; the port has
none, so they are process-wide counters here (`stats_snapshot()`), and
each job record carries its own sums (`job["stats"]`).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from pilosa_tpu_torch.cluster.topology import STATE_NORMAL, Cluster, Frag, Node
from pilosa_tpu_torch.core.fragment import TransferCaptureLost
from pilosa_tpu_torch.server.client import ClientError

# a source's write capture expires after this many seconds without a drain
CAPTURE_LEASE = 600.0
# catch-up rounds a stream step runs at most (it stops at the first empty
# round; the cutover timeout bounds the same loop's wall clock)
MAX_CATCHUP_ROUNDS = 8
RESUME_POLICIES = ("resume", "abort")
# anti-entropy passes the coordinator runs at most to repay a committed
# job's repair debt (a nudge that finds a peer's pass running is dropped)
POST_RESIZE_PASSES = 10

# the reference's resize.* counters, for this process
STATS_KEYS = (
    "fragments_streamed",
    "bytes_streamed",
    "catchup_rounds",
    "delta_positions",
    "cutover_rejects",
    "aborts",
)
_stats_mu = threading.Lock()
_counters: Dict[str, int] = dict.fromkeys(STATS_KEYS, 0)


def count(name: str, n: int = 1) -> None:
    with _stats_mu:
        _counters[name] += n


def stats_snapshot() -> Dict[str, int]:
    with _stats_mu:
        return dict(_counters)


def reset_stats() -> None:
    with _stats_mu:
        for k in _counters:
            _counters[k] = 0


class ResizeAborted(Exception):
    pass


class Resizer:
    """The resize job and its transfer plane, mixed into NodeServer (which
    provides node, cluster, holder, client, api, logger, set_topology,
    probe_peers, try_sync_holder, _sync_attrs and _send_status)."""

    def _init_resize(self, transfer_concurrency: int, cutover_timeout: float, resume_policy: str) -> None:
        if resume_policy not in RESUME_POLICIES:
            raise ValueError(f"resize_resume_policy must be 'resume' or 'abort', got {resume_policy!r}")
        self.resize_transfer_concurrency = max(1, int(transfer_concurrency))
        self.resize_cutover_timeout = float(cutover_timeout)
        self.resize_resume_policy = resume_policy
        # source side: (tag, index, field, view, shard) -> {"frag", "expires"};
        # destination side: job -> {"fetched": {key: source uri}, "created": set}
        self._transfer_mu = threading.Lock()
        self._transfer_captures: Dict[tuple, dict] = {}
        self._resize_ledger: Dict[str, dict] = {}
        # called with each phase label on the job thread (tests stop or
        # abort a job at an exact point of its state machine with it)
        self.resize_phase_hook = None
        # the coordinator's job: at most one at a time, RUNNING -> DONE | ABORTED
        self.resize_job: Optional[dict] = None
        self._resize_mu = threading.Lock()
        self._resize_abort = threading.Event()
        self._resize_thread: Optional[threading.Thread] = None

    # -- placement -------------------------------------------------------------

    def _resize_source_legs(
        self,
        new_nodes: List[Node],
        replica_n: Optional[int] = None,
        old_nodes: Optional[List[Node]] = None,
        old_replica_n: Optional[int] = None,
    ):
        """(old cluster, new cluster, legs): the transfers this node runs
        for the old -> new placement, each ((index, field, view, shard),
        ResizeSource). The inventory is the union of every live old
        member's fragments (a joiner has none of its own); `old_nodes`
        carries the coordinator's liveness marks, so a DOWN member costs
        nothing."""
        old = self.cluster
        if old_nodes is not None:
            if old_replica_n is None:
                old_replica_n = replica_n if replica_n is not None else old.replica_n
            old = Cluster(nodes=old_nodes, replica_n=old_replica_n, partition_n=old.partition_n, hasher=old.hasher)
        new = Cluster(
            nodes=new_nodes,
            replica_n=replica_n if replica_n is not None else old.replica_n,
            partition_n=old.partition_n,
            hasher=old.hasher,
            state=STATE_NORMAL,
        )
        legs = []
        for idx in self.holder.indexes():
            inventory = set()
            for n in old.nodes:
                if n.id == self.node.id:
                    for f in idx.fields(include_hidden=True):
                        for vname, v in f.views.items():
                            inventory.update((f.name, vname, s) for s in v.fragments)
                    continue
                if n.state == "DOWN":
                    continue
                try:
                    inventory.update(self.client.fragment_inventory(n.uri, idx.name))
                except ClientError:
                    continue
            if not inventory:
                continue
            # every inventoried shard is visible to this node's fan-out
            for fl, _, sh in inventory:
                f = idx.field(fl)
                if f is not None:
                    f.add_remote_available([sh])
            frags = [Frag(fl, vw, sh) for fl, vw, sh in sorted(inventory)]
            for src in old.frag_sources(new, idx.name, frags).get(self.node.id, []):
                if idx.field(src.field) is not None:
                    legs.append(((idx.name, src.field, src.view, src.shard), src))
        return old, new, legs

    def resize_to(
        self,
        new_nodes: List[Node],
        replica_n: Optional[int] = None,
        old_nodes: Optional[List[Node]] = None,
        old_replica_n: Optional[int] = None,
    ) -> int:
        """The checkpoint resize (POST /internal/resize, the manual
        fallback): fetch every fragment the new placement assigns here,
        replace it wholesale, then install the new membership. Returns the
        fragments fetched."""
        _, new, legs = self._resize_source_legs(new_nodes, replica_n, old_nodes, old_replica_n)
        fetched = 0
        for (iname, fname, vname, shard), src in legs:
            try:
                blob = self.client.retrieve_fragment(src.node.uri, iname, fname, vname, shard)
            except ClientError as e:
                self.logger(f"resize fetch {iname}/{fname}: {e}")
                continue
            idx = self.holder.index(iname)
            f = idx.field(fname) if idx is not None else None
            if f is None:
                continue  # the field went since the inventory walk
            f._view_create(vname).fragment(shard).from_bytes(blob)
            fetched += 1
        self.set_topology(new_nodes, replica_n=new.replica_n)
        return fetched

    def clean_holder(self) -> int:
        """The holder cleaner: delete every fragment the current placement
        does not assign to this node (files, device rows, stacks, cached
        results). Logs `holder cleaner {json}` with the device-resident
        bytes before and after; returns the fragments removed."""
        if len(self.cluster.nodes) <= 1:
            return 0
        t0 = time.perf_counter()
        before = self.holder.dcache.stats_snapshot()["resident_bytes"]
        removed = 0
        for idx in self.holder.indexes():
            for f in idx.fields(include_hidden=True):
                for v in list(f.views.values()):
                    for shard in list(v.fragments):
                        if self.cluster.owns_shard(self.node.id, idx.name, shard):
                            continue
                        if v.delete_fragment(shard):
                            removed += 1
        line = dict(
            removed=removed,
            resident_bytes_before=before,
            resident_bytes_after=self.holder.dcache.stats_snapshot()["resident_bytes"],
            seconds=time.perf_counter() - t0,
        )
        self.logger(f"holder cleaner {json.dumps(line)}")
        return removed

    # -- source side: leased write captures ----------------------------------------

    def begin_fragment_capture(self, tag: str, key: tuple, frag) -> bytes:
        """Snapshot one fragment and arm its `tag` capture, leased; `key`
        is (index, field, view, shard). Returns the snapshot stream."""
        blob = frag.begin_streaming(tag)
        try:
            now = time.monotonic()
            with self._transfer_mu:
                self._sweep_captures_locked(now)
                self._transfer_captures[(tag,) + tuple(key)] = {"frag": frag, "expires": now + CAPTURE_LEASE}
        except BaseException:
            # an armed capture with no lease would buffer every write
            frag.end_capture(tag)
            raise
        return blob

    def drain_fragment_capture(self, tag: str, key: tuple) -> bytes:
        """Pop one transfer's captured writes (WAL-framed) and renew its
        lease. TransferCaptureLost (HTTP 410) when the capture is gone:
        the destination refetches the snapshot."""
        now = time.monotonic()
        with self._transfer_mu:
            self._sweep_captures_locked(now)
            ent = self._transfer_captures.get((tag,) + tuple(key))
            if ent is not None:
                ent["expires"] = now + CAPTURE_LEASE
        if ent is None:
            raise TransferCaptureLost(f"no active capture for {key} ({tag})")
        return ent["frag"].drain_capture(tag)

    def _sweep_captures_locked(self, now: float) -> None:
        for key, ent in list(self._transfer_captures.items()):
            if now >= ent["expires"]:
                del self._transfer_captures[key]
                ent["frag"].end_capture(key[0])

    def _transfer_tag(self, job: str) -> str:
        """This node's capture tag for one job's transfers."""
        return f"{job}:{self.node.id}"

    @staticmethod
    def _of_job(tag: str, job: Optional[str]) -> bool:
        return job is None or tag == job or tag.startswith(job + ":")

    def quiesce_job_captures(self, job: str, ttl: float) -> int:
        """The cutover write barrier on every fragment with a capture of
        `job` (the `resize-quiesce` message): writes to them raise
        TransferCutover (HTTP 503, Retry-After) until the captures end or
        `ttl` passes, so the drain that follows empties every capture
        before the new membership is installed."""
        with self._transfer_mu:
            frags = [ent["frag"] for k, ent in self._transfer_captures.items() if self._of_job(k[0], job)]
        for f in frags:
            f.block_writes(ttl)
        return len(frags)

    def release_job_captures(self, job: Optional[str] = None) -> int:
        """End a job's captures (every job's when None) and drop its
        ledger here: the committed job's teardown (`resize-release`).
        Fetched fragments stay."""
        with self._transfer_mu:
            keys = [k for k in self._transfer_captures if self._of_job(k[0], job)]
            ents = [(k, self._transfer_captures.pop(k)) for k in keys]
            if job is None:
                self._resize_ledger.clear()
            else:
                self._resize_ledger.pop(job, None)
        for k, ent in ents:
            ent["frag"].end_capture(k[0])
        return len(ents)

    def resize_cleanup(self, job: str, aborting: bool = False) -> int:
        """Delete the fragments this job's transfers created here, then
        release its captures and ledger (`resize-cleanup`, the rollback).
        Fragments that existed before the job stay. Outside an abort (a
        superseded job's stale ledger) a fragment the current placement
        assigns here stays too: its job committed and only the release
        was lost."""
        with self._transfer_mu:
            ledger = self._resize_ledger.get(job)
            created = list(ledger["created"]) if ledger else []
        removed = 0
        for iname, fname, vname, shard in created:
            if not aborting and self.cluster.owns_shard(self.node.id, iname, shard):
                continue
            idx = self.holder.index(iname)
            f = idx.field(fname) if idx is not None else None
            v = f.views.get(vname) if f is not None else None
            if v is not None and v.delete_fragment(shard):
                removed += 1
        self.release_job_captures(job)
        if removed:
            self.logger(f"resize cleanup ({job}): removed {removed} fragments")
        return removed

    # -- destination side ------------------------------------------------------------

    def resize_stream(
        self,
        job: str,
        new_nodes: List[Node],
        replica_n: Optional[int] = None,
        old_nodes: Optional[List[Node]] = None,
        old_replica_n: Optional[int] = None,
        post_commit: bool = False,
    ) -> dict:
        """This node's stream step: fetch every fragment the new placement
        assigns here (snapshot plus a capture on the source), then drain
        catch-up rounds until one comes back empty, all without touching
        the installed membership, and pull the attribute stores from the
        old members. Resumable: a leg in this job's ledger only catches
        up. `post_commit` (the sweep after the cutover)
        fetches only legs not in the ledger, merged into what is here,
        with no capture. Returns {"fetched", "deltas", "shards", "bytes",
        "rounds"}; `shards` feeds the coordinator's repair debt."""
        with self._transfer_mu:
            stale = [j for j in self._resize_ledger if j != job]
            ledger = self._resize_ledger.get(job)
            if ledger is None:
                ledger = self._resize_ledger[job] = {"fetched": {}, "created": set(), "bytes": 0}
        for j in stale:
            # a superseded job's leftovers (its coordinator died first)
            self.resize_cleanup(j)
        old, _, legs = self._resize_source_legs(new_nodes, replica_n, old_nodes, old_replica_n)
        # attributes are not sharded: every node holds all of them, so a
        # joiner pulls the stores, and the sweep pulls what was set meanwhile
        self._sync_attrs([n for n in old.nodes if n.id != self.node.id and n.state != "DOWN"])
        if post_commit:
            # ledger legs drained dry under the barrier; draining them now
            # would 410 into a refetch over post-cutover writes
            with self._transfer_mu:
                done = set(ledger["fetched"])
            legs = [(k, s) for k, s in legs if k not in done]
        with self._transfer_mu:
            bytes0 = ledger["bytes"]
        fetched = deltas = rounds = 0
        if legs:
            workers = min(self.resize_transfer_concurrency, len(legs))
            with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="resize-xfer") as pool:
                results = list(pool.map(lambda leg: self._transfer_leg(job, ledger, *leg, post_commit=post_commit), legs))
            fetched = sum(f for f, _ in results)
            deltas += sum(d for _, d in results)
        if not post_commit:
            deadline = time.monotonic() + max(self.resize_cutover_timeout, 0.5)
            for _ in range(MAX_CATCHUP_ROUNDS):
                applied = self._catchup_round(job)
                rounds += 1
                count("catchup_rounds")
                deltas += applied
                if applied == 0 or time.monotonic() >= deadline:
                    break
        shards: Dict[str, List[int]] = {}
        with self._transfer_mu:
            for iname, _f, _v, shard in ledger["fetched"]:
                if shard not in shards.setdefault(iname, []):
                    shards[iname].append(shard)
            nbytes = ledger["bytes"] - bytes0
        return {"fetched": fetched, "deltas": deltas, "shards": shards, "bytes": nbytes, "rounds": rounds}

    def _transfer_leg(self, job: str, ledger: dict, key: tuple, src, post_commit: bool = False) -> tuple:
        """Stream one fragment from its source, or only catch it up when
        the ledger says its snapshot landed. Returns (fetched 0|1,
        positions applied)."""
        if post_commit:
            n = self._fetch_leg(job, ledger, key, src.node.uri, capture=False, merge_existing=True)
            return (0 if n is None else 1), 0
        with self._transfer_mu:
            resumed = key in ledger["fetched"]
        if resumed:
            return 0, self._drain_or_refetch(job, ledger, key, src.node.uri)
        n = self._fetch_leg(job, ledger, key, src.node.uri)
        return (0 if n is None else 1), 0

    def _fetch_leg(
        self, job: str, ledger: dict, key: tuple, src_uri: str, capture: bool = True, merge_existing: bool = False
    ) -> Optional[int]:
        """Fetch one leg's snapshot (arming the source's capture unless
        `capture` is False) and record it in the ledger. Returns its size,
        or None when the leg is moot (its field went) or a mutex fragment
        could not be merged (its repair debt reconciles it)."""
        iname, fname, vname, shard = key
        idx = self.holder.index(iname)
        f = idx.field(fname) if idx is not None else None
        if f is None:
            self.logger(f"resize fetch {iname}/{fname}: field gone, skipping")
            return None
        blob = self.client.retrieve_fragment(
            src_uri, iname, fname, vname, shard, capture=self._transfer_tag(job) if capture else None
        )
        v = f._view_create(vname)
        existing = v.fragment_if_exists(shard)
        created = existing is None
        if merge_existing and not created:
            try:
                existing.merge_from_bytes(blob)
            except ValueError as e:
                self.logger(f"resize sweep merge {key}: {e}")
                return None
        else:
            v.fragment(shard).from_bytes(blob)
        with self._transfer_mu:
            ledger["fetched"][key] = src_uri
            ledger["bytes"] += len(blob)
            if created:
                ledger["created"].add(key)
        count("fragments_streamed")
        count("bytes_streamed", len(blob))
        return len(blob)

    def _drain_or_refetch(self, job: str, ledger: dict, key: tuple, src_uri: str) -> int:
        """Drain one leg's capture. A failed drain is ambiguous (the source
        pops its records, and the drain makes one attempt), so it refetches
        the snapshot and drains the fresh capture once; a 429 shed popped
        nothing and is retried instead."""
        err: Exception = ClientError("drain not attempted")
        for _ in range(4):
            try:
                return self._drain_leg(job, key, src_uri)
            except ClientError as e:
                err = e
                if e.status == 429:
                    time.sleep(min(e.retry_after or 0.05, 1.0))
                    continue
                break
            except ValueError as e:  # a torn delta: nothing of it applied
                err = e
                break
        self.logger(f"resize drain {key}: {err}; refetching snapshot")
        if self._fetch_leg(job, ledger, key, src_uri) is None:
            return 0
        try:
            return self._drain_leg(job, key, src_uri)
        except (ClientError, ValueError) as e:
            # the snapshot holds everything up to its arm point; the rest
            # waits in the fresh capture for the next round
            self.logger(f"resize drain {key} after refetch: {e}")
            return 0

    def _drain_leg(self, job: str, key: tuple, src_uri: str) -> int:
        iname, fname, vname, shard = key
        data = self.client.fragment_delta(src_uri, iname, fname, vname, shard, self._transfer_tag(job))
        if not data:
            return 0
        idx = self.holder.index(iname)
        f = idx.field(fname) if idx is not None else None
        v = f.views.get(vname) if f is not None else None
        if v is None:
            return 0
        applied = v.fragment(shard).apply_transfer_records(data)
        if applied:
            count("delta_positions", applied)
        return applied

    def _catchup_round(self, job: str) -> int:
        """One drain of every leg in the job's ledger, on the stream
        phase's concurrency (the cutover barrier lasts one such round).
        Returns the positions applied."""
        with self._transfer_mu:
            ledger = self._resize_ledger.get(job)
            legs = list(ledger["fetched"].items()) if ledger else []
        if not legs:
            return 0
        workers = min(self.resize_transfer_concurrency, len(legs))
        if workers <= 1:
            return sum(self._drain_or_refetch(job, ledger, key, uri) for key, uri in legs)
        with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="resize-drain") as pool:
            return sum(pool.map(lambda leg: self._drain_or_refetch(job, ledger, *leg), legs))

    def resize_catchup(self, job: str) -> int:
        """The cutover's drain round (the sources are quiesced, so it
        empties every capture before the new membership is installed)."""
        return self._catchup_round(job)

    # -- the coordinator's job ---------------------------------------------------------

    def start_resize(self, new_nodes: List[Node], action: str, replica_n: Optional[int] = None) -> dict:
        """Start a resize job on its own thread and return its record at
        once (poll GET /cluster/resize/job)."""
        if not self.node.is_coordinator:
            raise ClientError("node is not the coordinator")
        with self._resize_mu:
            if self.resize_job is not None and self.resize_job["state"] == "RUNNING":
                raise ClientError("a resize job is already running")
            job = {
                "id": f"{self.node.id}-{int(time.time() * 1000)}",
                "action": action,
                "state": "RUNNING",
                "phase": "starting",
                "committed": False,
                "nodes": [n.to_json() for n in new_nodes],
                "transfers": {},
                "moved": [],
                "error": None,
                "stats": {"legs": 0, "bytes_streamed": 0, "catchup_rounds": 0, "delta_positions": 0, "seconds": 0.0},
            }
            self.resize_job = job
            self._resize_abort.clear()
            self._resize_thread = threading.Thread(
                target=self._run_resize, args=(job, list(new_nodes), replica_n), name=f"resize-{self.node.id}", daemon=True
            )
            self._resize_thread.start()
        return job

    def abort_resize(self) -> dict:
        """Ask the running job to roll back at its next phase boundary. A
        committed job ignores it and rolls forward."""
        with self._resize_mu:
            job = self.resize_job
            if job is not None and job["state"] == "RUNNING" and not job.get("committed"):
                self._resize_abort.set()
        return self.resize_job or {"state": "NONE"}

    def _run_resize(self, job: dict, new_nodes: List[Node], replica_n) -> None:
        t_job = time.perf_counter()

        def finish(state: str, error: Optional[str] = None) -> None:
            # the seconds first: a poller that sees the state reads them
            job["stats"]["seconds"] = time.perf_counter() - t_job
            job["error"] = error
            job["state"] = state

        try:
            self._resize_job_body(job, new_nodes, replica_n, finish)
        finally:
            if job["state"] == "RUNNING":  # an exception the job did not catch
                finish("ABORTED", "resize job thread failed")
            self.logger(f"resize job {json.dumps(job)}")

    def _resize_job_body(self, job: dict, new_nodes: List[Node], replica_n, finish) -> None:
        old_members = list(self.cluster.nodes)
        old_replica = self.cluster.replica_n
        old_ids = {n.id for n in old_members}
        new_ids = {n.id for n in new_nodes}
        joiners = [n for n in new_nodes if n.id not in old_ids]
        removed = [n for n in old_members if n.id not in new_ids]
        job_id = job["id"]

        def phase(name: str) -> None:
            job["phase"] = name
            hook = self.resize_phase_hook
            if hook is not None:
                hook(name)
            if self._resize_abort.is_set():
                raise ResizeAborted()

        def rollback() -> None:
            # the old membership on the old members; a joiner goes back to
            # a cluster of its own; then every participant deletes what
            # the job created and releases its captures
            count("aborts")
            self._send_status(old_members, old_members, old_replica, STATE_NORMAL, retries=10)
            for n in joiners:
                solo = Node(id=n.id, uri=n.uri, is_coordinator=True)
                self._send_status([solo], [solo], 1, STATE_NORMAL)
            self._broadcast_transfer_msg(list(new_nodes) + old_members, {"type": "resize-cleanup", "job": job_id})

        old_json: List[dict] = []
        try:
            phase("probe")
            self.probe_peers()
            # joiners are not members, so probe_peers does not reach them
            for n in joiners:
                self.client.status(n.uri, timeout=2.0, probe=True)
            old_json = [m.to_json() for m in old_members]
            # members first (they fetch while everyone holds the old
            # placement's fragments), joiners last
            order = [n for n in new_nodes if n.id in old_ids] + joiners
            phase("stream")
            for n in order:
                phase(f"stream:{n.id}")
                self._stream_step(job, n, new_nodes, old_json, replica_n, old_replica, joining=n.id not in old_ids)
            new_replica = replica_n if replica_n is not None else old_replica
            phase("cutover")
            # fields made while the joiners streamed
            for n in joiners:
                try:
                    self.client.post_schema(n.uri, self.api.schema())
                except ClientError as e:
                    self.logger(f"schema refresh to joiner {n.id}: {e}")
            # the sources' barrier, acknowledged by every live old member:
            # a source that kept taking writes would grow captures whose
            # replay after the install could undo newer writes
            ttl = max(self.resize_cutover_timeout, 5.0) * 2
            for n in old_members:
                if n.state == "DOWN":
                    continue
                if n.id == self.node.id:
                    self.quiesce_job_captures(job_id, ttl)
                else:
                    self.client.send_message(n.uri, {"type": "resize-quiesce", "job": job_id, "ttl": ttl})
            # the last drain: with writes barred it empties every capture
            for n in new_nodes:
                if n.id == self.node.id:
                    applied = self.resize_catchup(job_id)
                else:
                    applied = int(self.client.resize_catchup(n.uri, job_id).get("applied", 0))
                job["stats"]["delta_positions"] += applied
                job["stats"]["catchup_rounds"] += 1
            # the commit point: every new member acknowledges the membership
            self._send_status(new_nodes, new_nodes, new_replica, STATE_NORMAL, require=True)
        except ResizeAborted:
            rollback()
            finish("ABORTED", "aborted")
            return
        except Exception as e:  # noqa: BLE001 - the job record carries the error
            rollback()
            self.logger(f"resize job {job_id} aborted: {e}")
            finish("ABORTED", str(e))
            return
        job["committed"] = True
        job["phase"] = "drain"
        if self.resize_phase_hook is not None:
            self.resize_phase_hook("committed")
        # removed nodes learn they are no longer members
        if removed:
            self._send_status(removed, new_nodes, new_replica, STATE_NORMAL)
        # the sweep: fragments a write made after a node's inventory walk
        for n in new_nodes:
            try:
                self._stream_step(
                    job, n, new_nodes, old_json, replica_n, old_replica, joining=n.id not in old_ids, post_commit=True
                )
            except (ResizeAborted, ClientError) as e:
                self.logger(f"post-cutover sweep on {n.id}: {e} (anti-entropy will repair)")
        # a write that slipped both drains is caught by anti-entropy: every
        # moved shard owes its new owner a repair
        if new_replica > 1:
            for iname, shard, dest in job.get("moved", []):
                self.holder.record_pending_repair(iname, int(shard), dest)
        self._broadcast_transfer_msg(list(new_nodes) + old_members, {"type": "resize-release", "job": job_id})
        job["phase"] = "gc"
        for n in new_nodes:
            try:
                if n.id == self.node.id:
                    self.clean_holder()
                else:
                    self.client.send_message(n.uri, {"type": "clean-holder"})
            except Exception as e:  # noqa: BLE001 - the cleaner is best-effort
                self.logger(f"clean-holder on {n.id}: {e}")
        finish("DONE")
        if job.get("moved") and new_replica > 1:
            # repay the debt now rather than at the next interval tick; a
            # pass (or a nudge) that met one already running is asked again
            try:
                for _ in range(POST_RESIZE_PASSES):
                    if not self.holder.pending_repair_count():
                        break
                    if self.try_sync_holder(wait_nudge=True) is None or self.holder.pending_repair_count():
                        time.sleep(0.2)
                left = self.holder.pending_repairs()
                if left:
                    self.logger(f"post-resize repair drain: {len(left)} entries left, e.g. {sorted(left)[:8]}")
            except Exception as e:  # noqa: BLE001 - the interval loop is the backstop
                self.logger(f"post-resize repair drain: {e}")

    def _stream_step(
        self, job: dict, n: Node, new_nodes, old_json, replica_n, old_replica_n, joining: bool, post_commit: bool = False
    ) -> None:
        """Order one node through its stream step. Under the "resume"
        policy a failed step is retried once after a liveness refresh (the
        node's ledger skips what landed); under "abort" the first failure
        aborts the job."""
        attempts = 2 if self.resize_resume_policy == "resume" else 1
        last: Optional[ClientError] = None
        for attempt in range(attempts):
            try:
                if n.id == self.node.id:
                    res = self.resize_stream(
                        job["id"],
                        new_nodes,
                        replica_n=replica_n,
                        old_nodes=[Node.from_json(m) for m in old_json],
                        old_replica_n=old_replica_n,
                        post_commit=post_commit,
                    )
                else:
                    res = self.client.resize_stream(
                        n.uri,
                        job["id"],
                        [m.to_json() for m in new_nodes],
                        old_nodes=old_json,
                        replica_n=replica_n,
                        old_replica_n=old_replica_n,
                        schema=self.api.schema() if joining else None,
                        post_commit=post_commit,
                    )
                ent = job["transfers"].setdefault(n.id, {"fetched": 0, "deltas": 0})
                ent["fetched"] += int(res.get("fetched", 0))
                ent["deltas"] += int(res.get("deltas", 0))
                st = job["stats"]
                st["legs"] += int(res.get("fetched", 0))
                st["bytes_streamed"] += int(res.get("bytes", 0))
                st["catchup_rounds"] += int(res.get("rounds", 0))
                st["delta_positions"] += int(res.get("deltas", 0))
                moved = job["moved"]
                for iname, shards in (res.get("shards") or {}).items():
                    for s in shards:
                        m = [iname, int(s), n.id]
                        if m not in moved:  # the sweep reports the same legs again
                            moved.append(m)
                return
            except ClientError as e:
                last = e
                self.logger(f"resize stream step on {n.id} failed (attempt {attempt + 1}/{attempts}): {e}")
                if attempt + 1 < attempts:
                    self.probe_peers()
                    try:
                        # a direct probe closes the node's breaker if it is healthy
                        self.client.status(n.uri, timeout=2.0, probe=True)
                    except ClientError:
                        pass
                    if self._resize_abort.is_set():
                        raise ResizeAborted()
        raise last

    def _broadcast_transfer_msg(self, nodes: List[Node], msg: dict) -> None:
        """Best-effort delivery of a transfer-plane message to a node set,
        each node once (this node's locally)."""
        seen: set = set()
        for n in nodes:
            if n.id in seen:
                continue
            seen.add(n.id)
            if n.id == self.node.id:
                try:
                    self.api.receive_message(dict(msg))
                except Exception as e:  # noqa: BLE001 - teardown is best-effort
                    self.logger(f"{msg.get('type')} locally: {e}")
                continue
            try:
                self.client.send_message(n.uri, msg, timeout=10.0)
            except ClientError as e:
                self.logger(f"{msg.get('type')} to {n.id}: {e}")

