"""HTTP handler: the public REST routes of a node and the internal routes
of its cluster.

The port's slice of pilosa_tpu/server/handler.py: the same routing table
for the public routes and for the internal routes of the cluster's read
and write plane (remote query legs, fragment versions, cluster messages,
availability, replica imports, key translation, anti-entropy) and of
its membership changes (join, remove-node, abort, the job record,
set-coordinator, the resize steps and the fragment transfer), the same
JSON bodies and the same error mapping (NotFoundError -> 404; ShedError
-> 429 with Retry-After; DisabledError -> 503; TransferCutover, a
fragment inside a resize's cutover barrier, -> 503 with Retry-After: 1;
ExecError, ApiError, ParseError, ValueError and KeyError -> 400; anything
else -> 500 with the traceback logged). A malformed resize body is a 400
naming the field. A remote leg's execution error answers 200 with
{"error"}, as the reference's does: the peer ran the request, so the
coordinator must not fail it over. The metrics, debug, tier and
coherence routes come with the slices that port those planes; until
then they answer 404 as any unknown route does.

stdlib ThreadingHTTPServer, one thread per connection, HTTP/1.1 with
keep-alive. PQL arrives as a raw body or as JSON {"query": ...}.
"""

from __future__ import annotations

import json
import math
import re
import socket
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.core.fragment import TransferCaptureLost, TransferCutover
from pilosa_tpu_torch.exec.executor import ExecError, NotFoundError
from pilosa_tpu_torch.pql import ParseError
from pilosa_tpu_torch.sched.admission import CLASS_BATCH, ShedError
from pilosa_tpu_torch.server import resize as resizemod
from pilosa_tpu_torch.server import wire
import numpy as np

from pilosa_tpu_torch.server.api import TRACE_HEADER, ApiError, DisabledError, _field_options_from_json

_ROUTES: List[Tuple[str, re.Pattern, str]] = []

_REQUIRED = object()


class BadParam(ValueError):
    """Malformed or missing query parameter -> 400 with a JSON error body."""


def route(method: str, pattern: str):
    rx = re.compile("^" + pattern + "$")

    def deco(fn):
        _ROUTES.append((method, rx, fn.__name__))
        return fn

    return deco


class Handler(BaseHTTPRequestHandler):
    server_version = "pilosa-tpu/0.1"
    protocol_version = "HTTP/1.1"
    # a reply goes out as two writes (headers, then body): with Nagle's
    # algorithm the body waits for the client's delayed ACK of the headers
    disable_nagle_algorithm = True

    # no per-request log lines; the node's logger gets errors only
    def log_message(self, fmt, *args):
        pass

    @property
    def node(self):
        return self.server.node_server

    @property
    def api(self):
        return self.server.node_server.api

    # -- plumbing ------------------------------------------------------------

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _json_body(self) -> Any:
        data = self._body()
        return json.loads(data) if data else {}

    def _reply(
        self,
        obj: Any,
        code: int = 200,
        raw: Optional[bytes] = None,
        content_type: str = "application/json",
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = raw if raw is not None else json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, msg: str, code: int = 400) -> None:
        self._reply({"error": msg}, code=code)

    def _json_body_dict(self) -> dict:
        """A JSON object body, or a 400 naming what is wrong."""
        try:
            d = self._json_body()
        except ValueError:
            raise BadParam("request body must be valid JSON") from None
        if d is None:
            return {}
        if not isinstance(d, dict):
            raise BadParam(f"request body must be a JSON object, got {type(d).__name__}")
        return d

    def _body_str(self, d: dict, name: str) -> str:
        raw = d.get(name)
        if not isinstance(raw, str) or not raw:
            raise BadParam(f"body field {name!r} must be a non-empty string, got {raw!r}")
        return raw

    def _body_int(self, d: dict, name: str) -> Optional[int]:
        raw = d.get(name)
        if raw is None:
            return None
        if isinstance(raw, bool) or not isinstance(raw, int):
            raise BadParam(f"body field {name!r} must be an integer, got {raw!r}")
        return raw

    def _body_nodes(self, d: dict, name: str, required: bool = True) -> Optional[List[Node]]:
        """A membership list of node objects, or a 400 naming the field
        and the element."""
        raw = d.get(name)
        if raw is None:
            if required:
                raise BadParam(f"missing required body field {name!r}")
            return None
        if not isinstance(raw, list):
            raise BadParam(f"body field {name!r} must be a list of node objects, got {type(raw).__name__}")
        nodes = []
        for i, n in enumerate(raw):
            if not isinstance(n, dict) or not isinstance(n.get("id"), str) or not n["id"]:
                raise BadParam(f"body field {name!r}[{i}] must be a node object with a non-empty string 'id'")
            nodes.append(Node.from_json(n))
        return nodes

    def _admit_transfer(self):
        """A resize transfer is served in the batch admission class: it
        holds a real slot but never starves interactive queries. The
        ticket to release, or None with admission off."""
        sched = self.node.scheduler
        return None if sched is None else sched.admit(cls=CLASS_BATCH)

    def _int_param(self, name: str, default: Any = _REQUIRED) -> Optional[int]:
        raw = self.query.get(name)
        if raw is None:
            if default is _REQUIRED:
                raise BadParam(f"missing required query parameter {name!r}")
            return default
        try:
            return int(raw)
        except ValueError:
            raise BadParam(f"query parameter {name!r} must be an integer, got {raw!r}") from None

    def _str_param(self, name: str) -> str:
        raw = self.query.get(name)
        if not raw:
            raise BadParam(f"missing required query parameter {name!r}")
        return raw

    def _bool_param(self, name: str, default: bool = False) -> bool:
        raw = self.query.get(name)
        if raw is None:
            return default
        if raw in ("1", "true"):
            return True
        if raw in ("0", "false", ""):
            return False
        raise BadParam(
            f"query parameter {name!r} must be a boolean (1/0/true/false), got {raw!r}"
        )

    def _int_path(self, name: str, raw: str) -> int:
        try:
            return int(raw)
        except ValueError:
            raise BadParam(f"path parameter {name!r} must be an integer, got {raw!r}") from None

    def _int_list_param(self, name: str) -> List[int]:
        raw = self.query.get(name, "")
        try:
            # "1,,2" is a client typo that must 400, not become [1, 2]
            return [int(s) for s in raw.split(",")]
        except ValueError:
            raise BadParam(
                f"query parameter {name!r} must be comma-separated integers, got {raw!r}"
            ) from None

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        self.query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        for m, rx, fn_name in _ROUTES:
            if m != method:
                continue
            match = rx.match(parsed.path)
            if match:
                try:
                    getattr(self, fn_name)(**match.groupdict())
                except NotFoundError as e:
                    self._error(str(e), 404)
                except ShedError as e:
                    self._shed(e)
                except DisabledError as e:
                    self._error(str(e), 503)
                except TransferCutover as e:
                    # the barrier lasts one drain round: retry in a second
                    resizemod.count("cutover_rejects")
                    self._reply({"error": str(e)}, code=503, extra_headers={"Retry-After": "1"})
                except (ExecError, ApiError, ParseError, ValueError, KeyError) as e:
                    self._error(str(e), 400)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self.node.logger(traceback.format_exc())
                    self._error(f"internal error: {e}", 500)
                return
        self._error(f"no route for {method} {parsed.path}", 404)

    def _shed(self, e: ShedError) -> None:
        """Admission shed: 429, as the reference answers it. Retry-After
        is RFC 9110 delta-seconds (an integer, rounded up); the exact value
        rides X-Pilosa-Retry-After; a tenant quota's sheds name the limit;
        the id the query would have run under rides the body and the
        trace header."""
        hdrs = {
            "Retry-After": str(max(1, math.ceil(e.retry_after))),
            "X-Pilosa-Retry-After": f"{e.retry_after:g}",
        }
        if e.quota_limit:
            hdrs["X-Pilosa-Quota-Limit"] = e.quota_limit
            hdrs["X-Pilosa-Quota-Usage"] = f"{e.quota_usage:g}"
            hdrs["X-Pilosa-Quota-Value"] = f"{e.quota_value:g}"
        body = {"error": str(e)}
        if e.trace_id:
            hdrs[TRACE_HEADER] = e.trace_id
            body["traceId"] = e.trace_id
        self._reply(body, code=429, extra_headers=hdrs)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    # -- public routes -------------------------------------------------------

    @route("GET", "/status")
    def get_status(self):
        self._reply(self.api.status())

    @route("GET", "/")
    def get_home(self):
        self._reply(
            {
                "name": "pilosa-tpu",
                "version": self.api.version(),
                "see": ["/status", "/schema", "/index/{index}/query"],
            }
        )

    @route("GET", "/version")
    def get_version(self):
        self._reply({"version": self.api.version()})

    @route("GET", "/info")
    def get_info(self):
        self._reply(self.api.info())

    @route("GET", "/index/(?P<index>[^/]+)")
    def get_index(self, index: str):
        self._reply(self.api.index_info(index))

    @route("GET", "/index")
    def get_indexes(self):
        self._reply(self.api.schema())

    @route("GET", "/schema")
    def get_schema(self):
        self._reply({"indexes": self.api.schema()})

    @route("POST", "/schema")
    def post_schema(self):
        self.api.apply_schema(self._json_body().get("indexes", []))
        self._reply({})

    @route("GET", "/hosts")
    def get_hosts(self):
        self._reply(self.api.hosts())

    @route("POST", "/index/(?P<index>[^/]+)")
    def post_index(self, index: str):
        opts = self._json_body().get("options", {})
        self.api.create_index(
            index,
            keys=opts.get("keys", False),
            track_existence=opts.get("trackExistence", True),
        )
        self._reply({"success": True})

    @route("DELETE", "/index/(?P<index>[^/]+)")
    def delete_index(self, index: str):
        self.api.delete_index(index)
        self._reply({"success": True})

    @route("POST", "/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)")
    def post_field(self, index: str, field: str):
        from dataclasses import asdict

        opts = self._json_body().get("options", {})
        self.api.create_field(index, field, options=asdict(_field_options_from_json(opts)))
        self._reply({"success": True})

    @route("DELETE", "/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)")
    def delete_field(self, index: str, field: str):
        self.api.delete_field(index, field)
        self._reply({"success": True})

    @route("POST", "/index/(?P<index>[^/]+)/query")
    def post_query(self, index: str):
        body = self._body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        shards = None
        opts: Optional[Dict[str, Any]] = None
        if ctype == "application/json":
            opts = json.loads(body) if body else {}
            pql = opts.get("query", "")
            shards = opts.get("shards")
            if not isinstance(pql, str):
                raise BadParam(f"body field 'query' must be a string, got {pql!r}")
            if shards is not None and not (
                isinstance(shards, list) and all(type(x) is int for x in shards)
            ):
                raise BadParam(f"body field 'shards' must be a list of integers, got {shards!r}")
        else:
            pql = body.decode("utf-8")
            if "shards" in self.query:
                shards = self._int_list_param("shards")

        def flag(name: str) -> bool:
            if opts is not None and name in opts:
                return bool(opts[name])
            return self.query.get(name, "") in ("1", "true")

        resp = self.api.query_response(
            index,
            pql,
            shards=shards,
            headers=self.headers,
            column_attrs=flag("columnAttrs"),
            exclude_row_attrs=flag("excludeRowAttrs"),
            exclude_columns=flag("excludeColumns"),
            profile=flag("profile"),
        )
        out = {"results": [wire.result_to_public_json(r) for r in resp.results]}
        if resp.column_attr_sets is not None:
            out["columnAttrs"] = [s.to_json() for s in resp.column_attr_sets]
        self._reply(out)

    @route("POST", "/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import")
    def post_import(self, index: str, field: str):
        d = self._json_body()
        summary = self.api.import_bits(
            index,
            field,
            d.get("rowKeys") or d.get("rows") or [],
            d.get("colKeys") or d.get("cols") or [],
            clear=d.get("clear", False),
            timestamps=d.get("timestamps"),
        )
        self._reply(summary)

    @route("POST", "/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-value")
    def post_import_value(self, index: str, field: str):
        d = self._json_body()
        cols = d.get("colKeys") or d.get("cols") or []
        self._reply(self.api.import_values(index, field, cols, d.get("values", [])))

    @route("POST", "/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-roaring/(?P<shard>[^/]+)")
    def post_import_roaring(self, index: str, field: str, shard: str):
        """The body is a serialized roaring bitmap of fragment positions."""
        changed = self.api.import_roaring(
            index,
            field,
            self._int_path("shard", shard),
            self._body(),
            clear=self._bool_param("clear"),
            view=self.query.get("view"),
            local_only=self._bool_param("remote"),
        )
        self._reply({"changed": changed})

    @route("GET", "/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/export-roaring/(?P<shard>[^/]+)")
    def get_export_roaring(self, index: str, field: str, shard: str):
        data = self.api.export_roaring(
            index, field, self._int_path("shard", shard), view=self.query.get("view")
        )
        self._reply(None, raw=data, content_type="application/octet-stream")

    @route("POST", "/recalculate-caches")
    def post_recalculate_caches(self):
        self.api.recalculate_caches()
        self._reply({})

    @route("GET", "/index/(?P<index>[^/]+)/shard-nodes")
    def get_shard_nodes(self, index: str):
        self._reply(self.api.shard_nodes(index, self._int_param("shard")))

    @route("GET", "/export")
    def get_export(self):
        csv = self.api.export_csv(
            self._str_param("index"), self._str_param("field"), self._int_param("shard", None)
        )
        self._reply(None, raw=csv.encode(), content_type="text/csv")

    # -- internal routes -------------------------------------------------------

    @route("GET", "/internal/nodes")
    def get_internal_nodes(self):
        self._reply(self.api.hosts())

    @route("GET", "/internal/fragment/nodes")
    def get_fragment_nodes(self):
        """The owners of one shard."""
        self._reply(self.api.shard_nodes(self.query.get("index", ""), self._int_param("shard", 0)))

    @route("GET", "/internal/shards/max")
    def get_max_shards(self):
        self._reply({"standard": self.api.max_shards()})

    @route("POST", "/internal/index/(?P<index>[^/]+)/query")
    def post_internal_query(self, index: str):
        """A remote leg of a peer's fan-out, its results in the tagged
        internode encoding (server/wire.py)."""
        d = self._json_body()
        try:
            resp = self.api.query_response(
                index, d.get("query", ""), shards=d.get("shards"), remote=d.get("remote", True), headers=self.headers
            )
        except (ExecError, ApiError) as e:
            self._reply({"error": str(e)})
            return
        self._reply({"results": [wire.encode_result(r) for r in resp.results]})

    @route("POST", "/internal/versions")
    def post_internal_versions(self):
        """The result cache's revalidation: this node's fragment-version
        vector for one call over a shard list; `views: null` when the call
        is not cacheable here."""
        d = self._json_body_dict()
        index = self._body_str(d, "index")
        pql = self._body_str(d, "query")
        shards = d.get("shards")
        if not isinstance(shards, list) or not all(isinstance(s, int) and not isinstance(s, bool) for s in shards):
            raise BadParam("shards must be a list of integers")
        payload = self.node.executor.versions_payload(index, pql, shards)
        if payload is None:
            self._reply({"views": None})
            return
        shard_list, views = payload
        self._reply({"boot": self.node.boot_id, "shards": shard_list, "views": views})

    @route("POST", "/internal/cluster/message")
    def post_cluster_message(self):
        self._reply(self.api.receive_message(self._json_body()))

    @route("GET", "/internal/index/(?P<index>[^/]+)/available-shards")
    def get_available_shards(self, index: str):
        """Per field, the shards this node knows of cluster-wide."""
        idx = self._index_of(index)
        self._reply({"fields": {f.name: sorted(f.available_shards()) for f in idx.fields(include_hidden=True)}})

    # -- anti-entropy -------------------------------------------------------------

    @route("GET", "/internal/index/(?P<index>[^/]+)/attrs/blocks")
    def get_attr_blocks(self, index: str):
        """Attribute-store block checksums: ?field= a field's row
        attributes, none the index's column attributes."""
        self._reply({"blocks": self._attr_store(index, self.query.get("field")).blocks()})

    @route("GET", "/internal/index/(?P<index>[^/]+)/attrs/block/(?P<block>[0-9]+)")
    def get_attr_block_data(self, index: str, block: str):
        store = self._attr_store(index, self.query.get("field"))
        self._reply({"attrs": {str(k): v for k, v in store.block_data(int(block)).items()}})

    def _attr_store(self, index: str, field: Optional[str]):
        if not field:
            return self._index_of(index).column_attr_store
        return self._field_of(index, field).row_attr_store

    @route("POST", "/internal/sync")
    def post_internal_sync(self):
        """One anti-entropy pass now. `ran` is false when a pass was
        already running; `reached` lists the (index, shard, node)
        reconciliations the pass confirmed."""
        res = self.node.try_sync_holder()
        if res is None:
            self._reply({"synced": 0, "ran": False})
            return
        synced, reached = res
        self._reply({"synced": synced, "ran": True, "reached": [[i, s, d] for i, s, d in sorted(reached)]})

    def _index_of(self, index: str):
        idx = self.node.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        return idx

    def _field_of(self, index: str, field: str):
        f = self._index_of(index).field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        return f

    def _fragment(self):
        """The fragment ?index= &field= &view= &shard= names, or None where
        the view or the fragment does not exist."""
        f = self._field_of(self._str_param("index"), self._str_param("field"))
        v = f.views.get(self.query.get("view", "standard"))
        if v is None:
            return None
        return v.fragment_if_exists(self._int_param("shard"))

    @route("GET", "/internal/fragment/blocks")
    def get_fragment_blocks(self):
        frag = self._fragment()
        sums = frag.block_checksums() if frag is not None else {}
        self._reply({"blocks": {str(k): v.hex() for k, v in sums.items()}})

    @route("GET", "/internal/fragment/block/data")
    def get_block_data(self):
        """One block's (rows, cols): binary array frames when the client
        accepts them, else JSON."""
        block = self._int_param("block")  # checked even for a missing fragment
        frag = self._fragment()
        if frag is None:
            rows = cols = np.zeros(0, np.uint64)
        else:
            rows, cols = frag.block_pairs(block)
        if wire.ARRAYS_CTYPE in (self.headers.get("Accept") or ""):
            self._reply(None, raw=wire.encode_arrays(rows, cols), content_type=wire.ARRAYS_CTYPE)
        else:
            self._reply({"rows": rows.tolist(), "cols": cols.tolist()})

    @route("POST", "/internal/fragment/block/deltas")
    def post_block_deltas(self):
        """Apply a merged block's set and clear deltas to one fragment
        (made if missing): binary frames (sets rows, cols, clears rows,
        cols; the fragment in the query) or JSON."""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == wire.ARRAYS_CTYPE:
            d = dict(self.query)
            sr, sc, cr, cc = wire.decode_arrays(self._body(), 4)
            sets, clears = (sr, sc), (cr, cc)
        else:
            d = self._json_body()
            sets = (np.array(d["sets"]["rows"], np.uint64), np.array(d["sets"]["cols"], np.uint64))
            clears = (np.array(d["clears"]["rows"], np.uint64), np.array(d["clears"]["cols"], np.uint64))
        self.api.apply_block_deltas(d["index"], d["field"], d.get("view", "standard"), int(d["shard"]), sets, clears)
        self._reply({})

    # -- membership changes and the fragment transfer ------------------------------

    @route("POST", "/cluster/join")
    def post_cluster_join(self):
        d = self._json_body_dict()
        self._body_str(d, "id")
        self._body_str(d, "uri")
        self._reply(self.api.cluster_join(d))

    @route("POST", "/cluster/resize/remove-node")
    def post_remove_node(self):
        self._reply(self.api.remove_node(self._body_str(self._json_body_dict(), "id")))

    @route("POST", "/cluster/resize/abort")
    def post_resize_abort(self):
        self._reply(self.api.resize_abort())

    @route("GET", "/cluster/resize/job")
    def get_resize_job(self):
        self._reply(self.api.resize_job())

    @route("POST", "/cluster/resize/set-coordinator")
    def post_set_coordinator(self):
        self._reply(self.api.set_coordinator(self._json_body().get("id", "")))

    @route("POST", "/internal/resize")
    def post_internal_resize(self):
        """One node's checkpoint resize (the manual fallback): the schema
        first when given (a joiner), then fetch and install."""
        d = self._json_body_dict()
        nodes = self._body_nodes(d, "nodes")
        old_nodes = self._body_nodes(d, "oldNodes", required=False)
        replica_n = self._body_int(d, "replicaN")
        old_replica_n = self._body_int(d, "oldReplicaN")
        if d.get("schema"):
            self.api.apply_schema(d["schema"])
        fetched = self.node.resize_to(nodes, replica_n=replica_n, old_nodes=old_nodes, old_replica_n=old_replica_n)
        self._reply({"fetched": fetched})

    @route("POST", "/internal/resize/stream")
    def post_internal_resize_stream(self):
        """One node's stream step of a job (the installed membership keeps
        serving meanwhile)."""
        d = self._json_body_dict()
        job = self._body_str(d, "job")
        nodes = self._body_nodes(d, "nodes")
        old_nodes = self._body_nodes(d, "oldNodes", required=False)
        replica_n = self._body_int(d, "replicaN")
        old_replica_n = self._body_int(d, "oldReplicaN")
        post_commit = d.get("postCommit", False)
        if not isinstance(post_commit, bool):
            raise BadParam(f"body field 'postCommit' must be a boolean, got {post_commit!r}")
        if d.get("schema"):
            self.api.apply_schema(d["schema"])
        self._reply(
            self.node.resize_stream(
                job, nodes, replica_n=replica_n, old_nodes=old_nodes, old_replica_n=old_replica_n, post_commit=post_commit
            )
        )

    @route("POST", "/internal/resize/catchup")
    def post_internal_resize_catchup(self):
        """The cutover's drain round on this destination."""
        job = self._body_str(self._json_body_dict(), "job")
        self._reply({"applied": self.node.resize_catchup(job)})

    @route("GET", "/internal/fragment/data")
    def get_fragment_data(self):
        """A fragment's snapshot stream; with ?capture=<tag> the source's
        write capture is armed in the same lock hold (served in the batch
        admission class)."""
        capture = self.query.get("capture")
        ticket = self._admit_transfer() if capture else None
        try:
            frag = self._fragment()
            if frag is None:
                self._error("fragment not found", 404)
                return
            if capture:
                key = (self.query["index"], self.query["field"], self.query.get("view", "standard"), self._int_param("shard"))
                blob = self.node.begin_fragment_capture(capture, key, frag)
            else:
                blob = frag.to_bytes()
            self._reply(None, raw=blob, content_type="application/octet-stream")
        finally:
            if ticket is not None:
                ticket.release()

    @route("GET", "/internal/fragment/delta")
    def get_fragment_delta(self):
        """Drain one transfer's captured writes (WAL-framed bytes); 410
        when the capture is lost and the destination must refetch."""
        job = self._str_param("job")
        key = (self._str_param("index"), self._str_param("field"), self.query.get("view", "standard"), self._int_param("shard"))
        ticket = self._admit_transfer()
        try:
            try:
                data = self.node.drain_fragment_capture(job, key)
            except TransferCaptureLost as e:
                self._error(str(e), 410)
                return
            self._reply(None, raw=data, content_type="application/octet-stream")
        finally:
            if ticket is not None:
                ticket.release()

    @route("GET", "/internal/index/(?P<index>[^/]+)/fragments")
    def get_fragment_inventory(self, index: str):
        """[field, view, shard] of every fragment this node holds."""
        idx = self._index_of(index)
        frags = []
        for f in idx.fields(include_hidden=True):
            for vname, v in f.views.items():
                frags.extend([f.name, vname, shard] for shard in sorted(v.fragments))
        self._reply({"frags": frags})

    @route("POST", "/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import")
    def post_internal_import(self, index: str, field: str):
        """A replica's share of an import: binary array frames (rows, cols;
        clear by ?clear=1) or JSON for timestamped bits."""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == wire.ARRAYS_CTYPE:
            rows, cols = wire.decode_arrays(self._body(), 2)
            self.api.import_bits(index, field, rows, cols, clear=self._bool_param("clear"), local_only=True)
        else:
            d = self._json_body()
            self.api.import_bits(
                index, field, d.get("rows", []), d.get("cols", []),
                clear=d.get("clear", False), timestamps=d.get("timestamps"), local_only=True,
            )
        self._reply({})

    @route("POST", "/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-value")
    def post_internal_import_value(self, index: str, field: str):
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == wire.ARRAYS_CTYPE:
            cols, vals_u64 = wire.decode_arrays(self._body(), 2)
            # values travel as uint64 two's complement
            self.api.import_values(index, field, cols, vals_u64.view(np.int64), local_only=True)
        else:
            d = self._json_body()
            self.api.import_values(index, field, d.get("cols", []), d.get("values", []), local_only=True)
        self._reply({})

    def _translate_store(self, index: str, field: Optional[str]):
        store = self._field_of(index, field).translate_store if field else self._index_of(index).translate_store
        if store is None:
            raise NotFoundError(f"no key store: {index}" + (f"/{field}" if field else ""))
        return store

    @route("POST", "/internal/translate/keys")
    def post_translate_keys(self):
        """Allocate ids for keys: the translation primary only."""
        d = self._json_body()
        store = self._translate_store(d["index"], d.get("field"))
        coord = self.node.cluster.coordinator()
        if coord is not None and coord.id != self.node.node.id:
            self._reply({"error": "not the translation primary"})
            return
        self._reply({"ids": store.translate_keys(d.get("keys", []))})

    @route("GET", "/internal/translate/data")
    def get_translate_data(self):
        """The key entries from a replication offset on."""
        store = self._translate_store(self._str_param("index"), self.query.get("field"))
        entries, offset = store.entries_since(self._int_param("offset", 0))
        self._reply({"entries": entries, "offset": offset})


class NodeHTTPServer(ThreadingHTTPServer):
    """Serves each connection on a daemon thread and keeps the open
    connections, so that close() can end idle keep-alive connections and
    then join every handler thread (a request in flight finishes first)."""

    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: socketserver's default of 5 drops the connects
    # of a burst of clients past it, which the clients' TCP retries only
    # after a second
    request_queue_size = 128

    def __init__(self, *args, **kw):
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        super().__init__(*args, **kw)

    def process_request(self, request, client_address):
        with self._conns_mu:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_mu:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close(self) -> None:
        """Stop serving: no new connection, idle connections see end of
        input, and every handler thread has returned when this does."""
        self.shutdown()
        with self._conns_mu:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        self.server_close()  # joins the handler threads (block_on_close)


def make_http_server(node_server, host: str, port: int) -> NodeHTTPServer:
    srv = NodeHTTPServer((host, port), Handler)
    srv.node_server = node_server
    return srv
