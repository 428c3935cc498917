"""HTTP handler: the public REST routes of one node.

The port's slice of pilosa_tpu/server/handler.py: the same routing table
for the public routes, the same JSON bodies and the same error mapping
(NotFoundError -> 404; ExecError, ApiError, ParseError, ValueError and
KeyError -> 400; anything else -> 500 with the traceback logged). The
internal, cluster, metrics, debug, tier and coherence routes come with
the slices that port those planes; until then they answer 404 as any
unknown route does.

stdlib ThreadingHTTPServer, one thread per connection, HTTP/1.1 with
keep-alive. PQL arrives as a raw body or as JSON {"query": ...}.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.exec.executor import ExecError, NotFoundError
from pilosa_tpu_torch.pql import ParseError
from pilosa_tpu_torch.server import wire
from pilosa_tpu_torch.server.api import ApiError, _field_options_from_json

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
    ) -> None:
        body = raw if raw is not None else json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, msg: str, code: int = 400) -> None:
        self._reply({"error": msg}, code=code)

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
                except (ExecError, ApiError, ParseError, ValueError, KeyError) as e:
                    self._error(str(e), 400)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self.node.logger(traceback.format_exc())
                    self._error(f"internal error: {e}", 500)
                return
        self._error(f"no route for {method} {parsed.path}", 404)

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


class NodeHTTPServer(ThreadingHTTPServer):
    """Serves each connection on a daemon thread and keeps the open
    connections, so that close() can end idle keep-alive connections and
    then join every handler thread (a request in flight finishes first)."""

    daemon_threads = True
    allow_reuse_address = True

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
