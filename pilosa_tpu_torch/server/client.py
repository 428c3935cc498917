"""InternalClient: the node-to-node HTTP client.

The port of pilosa_tpu/server/client.py for the cluster's read and write
plane: remote query legs, schema pushes, fragment-version reads for the
result cache, status probes, cluster messages, the replica imports
(bits, values, roaring), availability reads, key-translation
replication and anti-entropy (block digests, block data and deltas,
attribute blocks, a pass on a peer). stdlib urllib only, JSON control
bodies and binary array frames (server/wire.py) for bulk data. Every method raises
ClientError on a transport or remote failure so the executor's failover
can re-map shards.

Every `_do` call rides the fault-tolerance plane (server/faults.py): its
`timeout` is a total deadline budget that all retry attempts share;
retryable failures (connection refused, timeouts, 5xx, 408, 429) back
off and retry within it (a 503 of a fragment's cutover barrier carries
Retry-After, which the wait honours); and a per-peer circuit breaker
fails a request to a known-dead node at once instead of spending the
budget. Every verb here is idempotent (set/clear semantics, reads,
status messages), so retrying a request whose response was lost is
safe, except the capture drain, which pops the source's records and so
makes one attempt: its caller refetches the snapshot on any failure.
The tier and coherence calls come with their slices; no tracing headers
are sent and TLS is not ported.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pilosa_tpu_torch.sched import admission as _admission
from pilosa_tpu_torch.server import faults, wire

DEFAULT_TIMEOUT = 30.0

# a timeout under a smaller per-attempt allotment than this says more about
# the caller's nearly spent budget than about the peer: it must not open
# the peer's breaker
_TIMEOUT_PENALTY_FLOOR = 1.0

TRACE_HEADER = "X-Pilosa-Trace-Id"


class ClientError(Exception):
    """A transport or remote failure: `status` (the HTTP code, None for a
    connection-level failure), `retryable` (may a retry or another
    replica fix it?), the peer `uri`, the peer's `retry_after` on a 429
    shed and the `trace_id` it named."""

    def __init__(
        self,
        msg: str,
        status: Optional[int] = None,
        retryable: bool = False,
        uri: str = "",
        retry_after: Optional[float] = None,
        trace_id: str = "",
    ):
        super().__init__(msg)
        self.status = status
        self.retryable = retryable
        self.uri = uri
        self.retry_after = retry_after
        self.trace_id = trace_id


class BreakerOpenError(ClientError):
    """Fast fail: the peer's circuit is open. Retryable, so the executor
    re-maps the shards to a replica; no request was sent."""

    def __init__(self, method: str, uri: str, path: str):
        super().__init__(
            f"{method} {uri}{path}: circuit open (peer marked dead)",
            status=None,
            retryable=True,
            uri=uri,
        )


class InternalClient:
    def __init__(
        self,
        timeout: float = DEFAULT_TIMEOUT,
        retry_policy: Optional[faults.RetryPolicy] = None,
        breakers: Optional[faults.BreakerRegistry] = None,
    ):
        self.timeout = timeout
        self.retry_policy = retry_policy or faults.RetryPolicy()
        self.breakers = breakers
        # a FaultInjector consulted before every dial (the process-wide one
        # of faults.install_injector when this is None)
        self.fault_injector: Optional[faults.FaultInjector] = None

    # -- plumbing ----------------------------------------------------------

    def _breakers(self) -> Optional[faults.BreakerRegistry]:
        return self.breakers or faults.global_breakers()

    @staticmethod
    def _is_timeout(e: Exception) -> bool:
        if isinstance(e, TimeoutError):  # socket.timeout is an alias
            return True
        return isinstance(e, urllib.error.URLError) and isinstance(e.reason, TimeoutError)

    def _classify(self, method: str, url: str, uri: str, e: Exception) -> ClientError:
        """A raw attempt failure as a classified ClientError."""
        if isinstance(e, urllib.error.HTTPError):
            detail = e.read().decode("utf-8", "replace")[:500]
            retry_after = None
            raw_ra = None
            trace_id = ""
            if e.headers:
                # the precise vendor header first; Retry-After is whole seconds
                raw_ra = e.headers.get("X-Pilosa-Retry-After") or e.headers.get("Retry-After")
                trace_id = e.headers.get(TRACE_HEADER) or ""
            if raw_ra:
                try:
                    retry_after = float(raw_ra)
                except ValueError:
                    retry_after = None
            err = ClientError(
                f"{method} {url} -> {e.code}: {detail}" + (f" [trace {trace_id}]" if trace_id else ""),
                status=e.code,
                retryable=faults.retryable_status(e.code),
                uri=uri,
                retry_after=retry_after,
                trace_id=trace_id,
            )
        else:
            # connection refused / reset / timeout / DNS: node-down shaped
            err = ClientError(f"{method} {url}: {e}", retryable=True, uri=uri)
        err.__cause__ = e
        return err

    def _do(
        self,
        method: str,
        uri: str,
        path: str,
        body: Optional[bytes] = None,
        query: Optional[Dict[str, Any]] = None,
        content_type: str = "application/json",
        timeout: Optional[float] = None,
        headers_fn=None,
        check_breaker: bool = True,
        max_attempts: Optional[int] = None,
    ) -> bytes:
        """One logical RPC: up to `retry_policy.max_attempts` attempts in a
        total budget of `timeout` (default `self.timeout`), with backoff
        between them and the peer's breaker consulted before each dial
        (`check_breaker=False` for liveness probes, which must reach a
        shunned peer so that it can recover). `headers_fn(remaining)` is
        evaluated per attempt with the budget's remaining seconds, so a
        deadline header shrinks across retries. `max_attempts` caps the
        attempts below the policy's for a verb that must not be retried."""
        url = uri.rstrip("/") + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        policy = self.retry_policy
        breakers = self._breakers()
        injector = self.fault_injector or faults.global_injector()
        budget = policy.budget(timeout if timeout is not None else self.timeout)
        attempts = 0
        while True:
            attempts += 1
            remaining = budget.remaining()
            if check_breaker and breakers is not None and not breakers.allow(uri):
                raise BreakerOpenError(method, uri, path)
            req = urllib.request.Request(url, data=body, method=method)
            if body is not None:
                req.add_header("Content-Type", content_type)
            if headers_fn is not None:
                for k, v in headers_fn(remaining).items():
                    req.add_header(k, v)
            try:
                if injector is not None:
                    injector.before_request(method, uri, path, url)
                with urllib.request.urlopen(req, timeout=max(remaining, 0.001)) as resp:
                    # chunked read with budget checks: the urlopen timeout
                    # is per socket operation, so a peer that drips bytes
                    # could otherwise stream past the total budget
                    chunks = []
                    while True:
                        chunk = resp.read(1 << 16)
                        if not chunk:
                            break
                        chunks.append(chunk)
                        if budget.expired():
                            raise TimeoutError("deadline budget exhausted mid-response")
                    data = b"".join(chunks)
                if breakers is not None:
                    breakers.record(uri, True)
                return data
            except Exception as e:  # noqa: BLE001 - classified below
                err = self._classify(method, url, uri, e)
                timed_out = self._is_timeout(e)
            # an HTTP status (a 4xx, a 429 shed, or a 503 with Retry-After
            # from a resize's cutover barrier) proves the peer alive: a
            # loaded or barred peer is not a dead one. Only node-down shaped
            # failures count against its breaker, and a timeout under a
            # starved allotment blames the caller's budget, not the peer.
            if breakers is not None:
                if err.status is not None and (not err.retryable or err.status == 429 or err.retry_after is not None):
                    breakers.record(uri, True)
                elif err.retryable and not (timed_out and remaining < _TIMEOUT_PENALTY_FLOOR):
                    breakers.record(uri, False)
                else:
                    # release a half-open probe slot this attempt may hold
                    breakers.record_neutral(uri)
            if not err.retryable or attempts >= (max_attempts or policy.max_attempts):
                raise err
            delay = policy.backoff(attempts)
            if err.retry_after is not None:
                # the peer said when to come back (a 429 shed, a 503 of a
                # cutover barrier)
                delay = max(delay, err.retry_after)
            if budget.remaining() <= delay:
                raise err  # no budget left for another attempt
            policy.sleep(delay)

    def _json(self, *args, **kw) -> Any:
        data = self._do(*args, **kw)
        return json.loads(data) if data else None

    # -- query ---------------------------------------------------------------

    def query_node(
        self,
        uri: str,
        index: str,
        query: str,
        shards: Optional[Sequence[int]] = None,
        remote: bool = False,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        priority: Optional[str] = None,
        device=None,
    ) -> List[Any]:
        """Run PQL on one peer (POST /internal/index/{i}/query). `timeout`
        bounds the RPC by the query deadline's remaining time; `deadline`
        (remaining seconds) and `priority` ride as headers, so the peer's
        admission controller sheds a leg that can no longer meet the
        sender's budget early (a 429 that retry and failover absorb).
        Row results land on `device`."""
        body = {"query": query, "remote": remote}
        if shards is not None:
            body["shards"] = list(shards)

        def hdrs(remaining: float) -> Dict[str, str]:
            h = {_admission.PRIORITY_HEADER: priority or _admission.CLASS_INTERNAL}
            if deadline is not None:
                h[_admission.DEADLINE_HEADER] = f"{max(0.0, min(deadline, remaining)):.3f}"
            return h

        resp = self._json(
            "POST",
            uri,
            f"/internal/index/{index}/query",
            json.dumps(body).encode(),
            timeout=timeout,
            headers_fn=hdrs,
        )
        if resp.get("error"):
            # the peer is alive and ran the request: a replica cannot fix it
            raise ClientError(resp["error"], retryable=False, uri=uri)
        return [wire.decode_result(r, device) for r in resp["results"]]

    # -- schema --------------------------------------------------------------

    def schema(self, uri: str) -> List[dict]:
        return self._json("GET", uri, "/schema")["indexes"]

    def post_schema(self, uri: str, schema: List[dict]) -> None:
        """Apply a full schema dump on a peer (additive: the repair for the
        DDL a node missed while it was down)."""
        self._json("POST", uri, "/schema", json.dumps({"indexes": schema}).encode())

    def fragment_versions(
        self, uri: str, index: str, query: str, shards: Sequence[int], timeout: float = 5.0
    ) -> dict:
        """A peer's fragment-version vector for one call (POST
        /internal/versions), the result cache's remote revalidation. A
        short timeout: an unreachable peer makes the cache miss, never
        blocks the query."""
        body = {"index": index, "query": query, "shards": list(shards)}
        return self._json("POST", uri, "/internal/versions", json.dumps(body).encode(), timeout=timeout) or {}

    def status(self, uri: str, timeout: Optional[float] = None, probe: bool = False) -> dict:
        """`probe=True` bypasses the peer's breaker: probes are how an open
        breaker learns that the node recovered."""
        return self._json("GET", uri, "/status", timeout=timeout, check_breaker=not probe)

    # -- cluster messages ------------------------------------------------------

    def send_message(self, uri: str, message: dict, timeout: Optional[float] = None) -> dict:
        return (
            self._json("POST", uri, "/internal/cluster/message", json.dumps(message).encode(), timeout=timeout)
            or {}
        )

    # -- resize -----------------------------------------------------------------

    def resize_node(
        self,
        uri: str,
        nodes: List[dict],
        old_nodes: Optional[List[dict]] = None,
        replica_n: Optional[int] = None,
        schema: Optional[List[dict]] = None,
        timeout: float = 300.0,
    ) -> dict:
        """One node's step of a checkpoint resize (POST /internal/resize):
        fetch what the new membership assigns it, then install it. A
        joining node gets the membership it joins and the schema."""
        body: Dict[str, Any] = {"nodes": nodes}
        if old_nodes is not None:
            body["oldNodes"] = old_nodes
        if replica_n is not None:
            body["replicaN"] = replica_n
        if schema is not None:
            body["schema"] = schema
        return self._json("POST", uri, "/internal/resize", json.dumps(body).encode(), timeout=timeout) or {}

    def resize_stream(
        self,
        uri: str,
        job: str,
        nodes: List[dict],
        old_nodes: Optional[List[dict]] = None,
        replica_n: Optional[int] = None,
        old_replica_n: Optional[int] = None,
        schema: Optional[List[dict]] = None,
        timeout: float = 600.0,
        post_commit: bool = False,
    ) -> dict:
        """One node's stream step of a job (POST /internal/resize/stream):
        every fragment the new placement assigns it, snapshot plus write
        capture, then catch-up rounds; the node serves the old placement
        meanwhile. Resumable (the node's ledger skips what landed), so
        retries are safe. `post_commit`: the sweep after the cutover,
        fetching only fragments made since, merged, with no capture."""
        body: Dict[str, Any] = {"job": job, "nodes": nodes}
        if old_nodes is not None:
            body["oldNodes"] = old_nodes
        if replica_n is not None:
            body["replicaN"] = replica_n
        if old_replica_n is not None:
            body["oldReplicaN"] = old_replica_n
        if schema is not None:
            body["schema"] = schema
        if post_commit:
            body["postCommit"] = True
        return self._json("POST", uri, "/internal/resize/stream", json.dumps(body).encode(), timeout=timeout) or {}

    def resize_catchup(self, uri: str, job: str, timeout: float = 120.0) -> dict:
        """The cutover's drain round on one destination."""
        return self._json("POST", uri, "/internal/resize/catchup", json.dumps({"job": job}).encode(), timeout=timeout) or {}

    def fragment_delta(self, uri: str, index: str, field: str, view: str, shard: int, job: str) -> bytes:
        """Drain one transfer's captured writes (WAL-framed bytes). One
        attempt: the drain pops the source's records, so a retry after a
        lost response would skip them; the caller refetches the snapshot
        instead (a 410, capture lost, too)."""
        q = {"index": index, "field": field, "view": view, "shard": shard, "job": job}
        return self._do("GET", uri, "/internal/fragment/delta", query=q, max_attempts=1)

    def join_cluster(self, coordinator_uri: str, node: dict) -> dict:
        """Ask the coordinator to admit a node; the resize job's record."""
        return self._json("POST", coordinator_uri, "/cluster/join", json.dumps(node).encode()) or {}

    def retrieve_fragment(
        self, uri: str, index: str, field: str, view: str, shard: int, capture: Optional[str] = None
    ) -> bytes:
        """A fragment's snapshot stream; `capture=<tag>` makes the source
        arm a write capture with it (drain it with fragment_delta)."""
        q: Dict[str, Any] = {"index": index, "field": field, "view": view, "shard": shard}
        if capture:
            q["capture"] = capture
        return self._do("GET", uri, "/internal/fragment/data", query=q)

    def fragment_inventory(self, uri: str, index: str) -> List[Tuple[str, str, int]]:
        """(field, view, shard) of every fragment a node holds of an index."""
        resp = self._json("GET", uri, f"/internal/index/{index}/fragments")
        return [(f, v, int(s)) for f, v, s in resp.get("frags", [])]

    # -- imports ----------------------------------------------------------------

    def import_bits(
        self,
        uri: str,
        index: str,
        field: str,
        shard: int,
        rows: Sequence[int],
        cols: Sequence[int],
        clear: bool = False,
        timestamps: Optional[Sequence[Optional[str]]] = None,
    ) -> None:
        """Ship an import frame to one owner. `cols` are absolute, so one
        frame may carry bits of many shards (the per-node batched replica
        ship): the receiver groups by shard itself; `shard` is
        informational. Timestamped imports travel as JSON."""
        if timestamps is None:
            self._do(
                "POST",
                uri,
                f"/internal/index/{index}/field/{field}/import",
                wire.encode_arrays(rows, cols),
                query={"clear": "1"} if clear else None,
                content_type=wire.ARRAYS_CTYPE,
            )
            return
        body = {
            "shard": shard,
            "rows": [int(r) for r in rows],
            "cols": [int(c) for c in cols],
            "clear": clear,
            "timestamps": list(timestamps),
        }
        self._do("POST", uri, f"/internal/index/{index}/field/{field}/import", json.dumps(body).encode())

    def import_values(
        self, uri: str, index: str, field: str, shard: int, cols: Sequence[int], values: Sequence[int]
    ) -> None:
        vals = np.asarray(values, np.int64).view(np.uint64)  # two's complement
        self._do(
            "POST",
            uri,
            f"/internal/index/{index}/field/{field}/import-value",
            wire.encode_arrays(np.asarray(cols, np.uint64), vals),
            content_type=wire.ARRAYS_CTYPE,
        )

    def import_roaring(
        self,
        uri: str,
        index: str,
        field: str,
        shard: int,
        data: bytes,
        clear: bool = False,
        view: Optional[str] = None,
    ) -> int:
        """Forward a serialized roaring bitmap to a shard owner; remote=1
        stops the receiver fanning it out again. Returns the owner's
        changed-bit count."""
        params = ["remote=1"]
        if clear:
            params.append("clear=1")
        if view:
            params.append(f"view={view}")
        resp = self._json(
            "POST", uri, f"/index/{index}/field/{field}/import-roaring/{shard}?" + "&".join(params), data
        )
        return int((resp or {}).get("changed", 0))

    # -- anti-entropy (the reference's http/client.go:842-933 and holder.go:975-1019) --

    def fragment_blocks(self, uri: str, index: str, field: str, view: str, shard: int) -> Dict[int, str]:
        """A peer's block digests of one fragment, {block id: hex}."""
        resp = self._json(
            "GET",
            uri,
            "/internal/fragment/blocks",
            query={"index": index, "field": field, "view": view, "shard": shard},
        )
        return {int(k): v for k, v in resp.get("blocks", {}).items()}

    def block_data(
        self, uri: str, index: str, field: str, view: str, shard: int, block: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """A peer's (rows, cols) of one block, as binary array frames."""
        data = self._do(
            "GET",
            uri,
            "/internal/fragment/block/data",
            query={"index": index, "field": field, "view": view, "shard": shard, "block": block},
            headers_fn=lambda _remaining: {"Accept": wire.ARRAYS_CTYPE},
        )
        rows, cols = wire.decode_arrays(data, 2)
        return rows, cols

    def send_block_deltas(
        self,
        uri: str,
        index: str,
        field: str,
        view: str,
        shard: int,
        sets: Tuple[np.ndarray, np.ndarray],
        clears: Tuple[np.ndarray, np.ndarray],
    ) -> None:
        """Ship a peer its set and clear deltas of one merged block."""
        self._do(
            "POST",
            uri,
            "/internal/fragment/block/deltas",
            wire.encode_arrays(sets[0], sets[1], clears[0], clears[1]),
            query={"index": index, "field": field, "view": view, "shard": shard},
            content_type=wire.ARRAYS_CTYPE,
        )

    def attr_blocks(self, uri: str, index: str, field: Optional[str]) -> list:
        """A peer's attribute-store block checksums: a field's row
        attributes, or the index's column attributes with no field."""
        q = {"field": field} if field else None
        return self._json("GET", uri, f"/internal/index/{index}/attrs/blocks", query=q)["blocks"]

    def attr_block_data(self, uri: str, index: str, field: Optional[str], block_id: int) -> dict:
        q = {"field": field} if field else None
        return self._json("GET", uri, f"/internal/index/{index}/attrs/block/{block_id}", query=q)["attrs"]

    def trigger_sync(self, uri: str, timeout: float = 300.0) -> dict:
        """Ask a peer to run one anti-entropy pass now (POST
        /internal/sync): {"synced": n, "ran": bool, "reached": [[index,
        shard, node id], ...]}, `reached` the replica reconciliations the
        pass confirmed. A whole pass over a large holder is slow, hence
        the long timeout."""
        return self._json("POST", uri, "/internal/sync", timeout=timeout) or {}

    # -- availability and key replication ----------------------------------------

    def available_shards(self, uri: str, index: str) -> Dict[str, List[int]]:
        """A peer's per-field cluster-known shards."""
        resp = self._json("GET", uri, f"/internal/index/{index}/available-shards")
        return {k: [int(s) for s in v] for k, v in resp.get("fields", {}).items()}

    def translate_keys_remote(self, uri: str, index: str, field: Optional[str], keys: Sequence[str]) -> List[int]:
        """Ask the translation primary to allocate ids for keys."""
        body = {"index": index, "keys": list(keys)}
        if field:
            body["field"] = field
        resp = self._json("POST", uri, "/internal/translate/keys", json.dumps(body).encode())
        if resp.get("error"):
            raise ClientError(resp["error"], retryable=False, uri=uri)
        return [int(i) for i in resp["ids"]]

    def translate_entries(
        self, uri: str, index: str, field: Optional[str], offset: int
    ) -> Tuple[List[Tuple[int, str]], int]:
        """The primary's key entries from replication offset `offset` on,
        and the offset after them."""
        q = {"index": index, "offset": offset}
        if field:
            q["field"] = field
        resp = self._json("GET", uri, "/internal/translate/data", query=q)
        return [(int(i), k) for i, k in resp["entries"]], int(resp["offset"])
