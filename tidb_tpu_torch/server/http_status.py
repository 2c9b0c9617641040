"""HTTP status API: /status, /metrics, /schema, /settings.

Counterpart of tidb_tpu/server/http_status.py. Reference:
pkg/server/http_status.go — the side port serving liveness (`/status`,
with the live MySQL connection count), the metrics registry in
Prometheus text (`/metrics`, utils/metrics.py), schema introspection
(`/schema`, `/schema/<db>`, `/schema/<db>/<table>`, backed by the
catalog) and the GLOBAL settings (`/settings`).

The JAX package's other endpoints wait for their modules: `/profile`,
`/timeline*`, `/tsdb` and `/inspection` for the time-series tier
(ROADMAP.md queue 1, item 6), `/dcn` and `/links` for the multi-host
tier (item 8). Each raises ``NotImplementedError`` naming itself and its
item, and the handler's exception path answers it as the JAX package
answers any failure: HTTP 500 with ``{"error": "..."}``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: endpoint -> the ROADMAP.md item it waits for
UNPORTED_ENDPOINTS = {
    "/profile": "item 6, the time-series tier",
    "/timeline": "item 6, the time-series tier",
    "/timeline/start": "item 6, the time-series tier",
    "/timeline/stop": "item 6, the time-series tier",
    "/tsdb": "item 6, the time-series tier",
    "/inspection": "item 6, the time-series tier",
    "/dcn": "item 8, multi-host execution",
    "/links": "item 8, multi-host execution",
}


class StatusServer:
    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 10080,
                 connections=None):
        self.catalog = catalog
        # live MySQL-protocol connection count provider (a zero-arg
        # callable wired by server/server.py)
        self.connections = connections
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    path = self.path.split("?")[0].rstrip("/") or "/status"
                    if path in UNPORTED_ENDPOINTS:
                        raise NotImplementedError(
                            f"{path} is not ported yet (ROADMAP.md queue 1, "
                            f"{UNPORTED_ENDPOINTS[path]})")
                    if path == "/status":
                        from tidb_tpu_torch import __version__ as ver

                        try:
                            nconn = int(outer.connections()) if callable(
                                outer.connections) else 0
                        except Exception:
                            nconn = 0
                        self._send(200, json.dumps({
                            "connections": nconn,
                            "version": f"8.0.11-tidb-tpu-{ver}",
                            "git_hash": "embedded",
                        }))
                    elif path == "/metrics":
                        from tidb_tpu_torch.utils.metrics import REGISTRY

                        self._send(200, REGISTRY.render(), "text/plain; version=0.0.4")
                    elif path == "/schema":
                        out = {}
                        for db in outer.catalog.databases():
                            if db.startswith("_"):
                                continue
                            out[db] = outer.catalog.tables(db)
                        self._send(200, json.dumps(out))
                    elif path.startswith("/schema/"):
                        parts = path.split("/")[2:]
                        db = parts[0]
                        if len(parts) == 1:
                            self._send(200, json.dumps(outer.catalog.tables(db)))
                        else:
                            t = outer.catalog.table(db, parts[1])
                            self._send(200, json.dumps({
                                "name": t.name,
                                "columns": [
                                    {"name": n, "type": repr(ty).lower()}
                                    for n, ty in t.schema.columns
                                ],
                                "primary_key": t.schema.primary_key,
                                "indexes": t.indexes,
                                "rows": t.nrows,
                            }))
                    elif path == "/settings":
                        from tidb_tpu_torch.utils.sysvar import SysVars

                        sv = SysVars(outer.catalog.global_sysvars)
                        self._send(200, json.dumps(
                            {k: str(v) for k, v in sv.all().items()}))
                    else:
                        self._send(404, json.dumps({"error": "not found"}))
                except Exception as e:
                    self._send(500, json.dumps({"error": str(e)}))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = None

    def start_background(self) -> threading.Thread:
        th = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                              name="http-status")
        th.start()
        self._thread = th
        return th

    def shutdown(self) -> None:
        # BaseServer.shutdown() waits on an event only serve_forever sets:
        # never call it if serving never started
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self._httpd.server_close()
