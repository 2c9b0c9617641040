"""Threaded MySQL-protocol server over the port's Session.

Counterpart of tidb_tpu/server/server.py. Reference: pkg/server/server.go
(Server.Run accept loop) + conn.go:1009 (clientConn.Run read-dispatch
loop), one goroutine per connection; here one thread per connection, all
sharing the catalog. Each connection's statements run on the server's
device one at a time across the process (``session.statement_lock``);
handshakes, parsing and wire I/O stay concurrent. ``serve_forever``
also starts the two background workers the JAX server runs, the
auto-analyze ``StatsHandle`` (every 30 s) and the ``TTLWorker`` (every
60 s), and ``shutdown`` stops and joins them. With ``status_port`` (0: any
free port) it serves the HTTP status API beside the MySQL port
(server/http_status.py), started with the accept loop and shut down with
it; a status port that cannot be bound raises at construction.

The server runs on CUDA unless the caller passes ``device="cpu"``; with
no card present it raises before it listens.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Dict, Optional

from tidb_tpu_torch.chunk import resolve_device
from tidb_tpu_torch.server import protocol as P
from tidb_tpu_torch.session.session import Result, Session
from tidb_tpu_torch.stats.handle import StatsHandle
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject
from tidb_tpu_torch.utils.ttl import TTLWorker

COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A
COM_STMT_FETCH = 0x1C


class _Stmt:
    """A COM_STMT_PREPARE'd statement of one connection: its parameter
    count, the parameter types the client sent on its first EXECUTE, and
    the rows an EXECUTE with a read-only cursor left for COM_STMT_FETCH
    ([rows, column types, position])."""

    def __init__(self, nparams: int):
        self.nparams = nparams
        self.param_types = None
        self.cursor = None


class Server:
    def __init__(
        self,
        catalog: Optional[Catalog] = None,
        host: str = "127.0.0.1",
        port: int = 4000,
        device=None,
        status_port: Optional[int] = None,
    ):
        self.catalog = catalog if catalog is not None else Catalog()
        self.device = resolve_device(device)
        self.host = host
        self._next_conn_id = 0
        self._lock = racecheck.make_lock("server.conns")
        #: connection id (the handshake's) -> the connection's Session,
        #: while the client is connected and authenticated
        self.sessions: Dict[int, Session] = {}
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                outer._handle_conn(self.request)

        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = TCP((host, port), Handler)
        self.port = self._tcp.server_address[1]
        # the background workers (reference: the domain's stats handle
        # loop and the TTL job manager)
        self.stats_handle = StatsHandle(self.catalog, interval_s=30.0, device=self.device)
        self.ttl_worker = TTLWorker(self.catalog, interval_s=60.0, device=self.device)
        # the side HTTP port (reference pkg/server/http_status.go); None
        # serves none
        self.status_server = None
        if status_port is not None:
            from tidb_tpu_torch.server.http_status import StatusServer

            try:
                self.status_server = StatusServer(
                    self.catalog, host=host, port=status_port,
                    connections=lambda: self.connections)
            except BaseException:
                self._tcp.server_close()
                raise

    @property
    def connections(self) -> int:
        """Connected, authenticated clients (the /status count)."""
        with self._lock:
            return len(self.sessions)

    def serve_forever(self) -> None:
        self.stats_handle.start()
        self.ttl_worker.start()
        if self.status_server is not None:
            self.status_server.start_background()
        self._tcp.serve_forever()

    def start_background(self) -> threading.Thread:
        th = threading.Thread(
            target=self.serve_forever, daemon=True, name=f"mysql-serve-{self.port}"
        )
        th.start()
        return th

    def shutdown(self) -> None:
        # the accept loop first: it returns once serve_forever, which
        # starts the workers, has run, so no worker starts after its stop
        self._tcp.shutdown()
        if self.status_server is not None:
            self.status_server.shutdown()
        self.ttl_worker.stop()
        self.stats_handle.stop()
        self._tcp.server_close()

    # ------------------------------------------------------------------
    def _handle_conn(self, sock: socket.socket) -> None:
        io = P.PacketIO(sock)
        with self._lock:
            self._next_conn_id += 1
            conn_id = self._next_conn_id
        sess = Session(self.catalog, device=self.device)
        scramble = P.new_scramble()
        io.write_packet(P.handshake_v10(conn_id, str(sess.vars.get("version")), scramble))
        body = io.read_packet()
        if body is None:
            return
        try:
            user, db, auth = P.parse_handshake_response(body)
        except (IndexError, ValueError, struct.error):
            io.write_packet(P.err_packet(1045, "malformed handshake"))
            return
        # mysql_native_password against the catalog's user store
        # (reference: clientConn.openSessionAndDoAuth)
        if not self.catalog.users.authenticate(user, scramble, auth):
            io.write_packet(P.err_packet(1045, f"Access denied for user '{user}'@'%'", "28000"))
            return
        sess.user = user.lower()
        if db:
            sess.db = db.lower()
        io.write_packet(P.ok_packet())
        with self._lock:
            self.sessions[conn_id] = sess
        try:
            self._serve_commands(io, sess)
        finally:
            # a transaction left open rolls back, freeing its table locks
            sess.close()
            with self._lock:
                del self.sessions[conn_id]

    def _serve_commands(self, io: P.PacketIO, sess: Session) -> None:
        # prepared statements: per-connection registry (reference:
        # conn_stmt.go handleStmtPrepare/Execute)
        stmts = {}
        next_stmt_id = 0
        while True:
            io.reset_seq()
            body = io.read_packet()
            if not body:
                return
            cmd, payload = body[0], body[1:]
            try:
                if cmd == COM_QUIT:
                    return
                if cmd == COM_PING:
                    io.write_packet(P.ok_packet())
                elif cmd == COM_INIT_DB:
                    sess.execute(f"use `{payload.decode()}`")
                    io.write_packet(P.ok_packet())
                elif cmd == COM_QUERY:
                    inject("server/dispatch-query")
                    r = sess.execute(payload.decode("utf-8", "replace"))
                    self._write_result(io, r, sess)
                elif cmd == COM_FIELD_LIST:
                    io.write_packet(P.eof_packet())
                elif cmd == COM_STMT_PREPARE:
                    sql = payload.decode("utf-8", "replace")
                    nparams = P.count_placeholders(sql)
                    next_stmt_id += 1
                    sid = next_stmt_id
                    sess.prepare(f"__c{sid}", sql)
                    stmts[sid] = _Stmt(nparams)
                    io.write_packet(P.stmt_prepare_ok(sid, 0, nparams))
                    if nparams:
                        for _ in range(nparams):
                            io.write_packet(P.column_def("?", None))
                        io.write_packet(P.eof_packet())
                elif cmd == COM_STMT_EXECUTE:
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    st = stmts.get(sid)
                    if st is None:
                        io.write_packet(P.err_packet(1243, "unknown stmt"))
                        continue
                    _sid, params, st.param_types = P.parse_stmt_execute(
                        payload, st.nparams, st.param_types
                    )
                    r = sess.execute_prepared(f"__c{sid}", params)
                    # CURSOR_TYPE_READ_ONLY: keep the resultset and answer
                    # column defs only; rows go out through COM_STMT_FETCH
                    # (reference conn_stmt.go useCursor)
                    flags = payload[4] if len(payload) > 4 else 0
                    if (flags & P.CURSOR_TYPE_READ_ONLY) and r.columns:
                        types = r.types or [None] * len(r.columns)
                        st.cursor = [list(r.rows), types, 0]
                        io.write_packet(P.lenenc_int(len(r.columns)))
                        for name, t in zip(r.columns, types):
                            io.write_packet(P.column_def(name, t))
                        io.write_packet(P.eof_packet(P.SERVER_STATUS_CURSOR_EXISTS))
                    else:
                        self._write_result(io, r, sess, binary=True)
                elif cmd == COM_STMT_FETCH:
                    sid, nfetch = struct.unpack_from("<II", payload, 0)
                    st = stmts.get(sid)
                    if st is None or st.cursor is None:
                        io.write_packet(P.err_packet(1243, "no open cursor for stmt"))
                        continue
                    rows, types, pos = st.cursor
                    chunk = rows[pos : pos + max(nfetch, 1)]
                    for row in chunk:
                        io.write_packet(P.binary_row(row, types))
                    st.cursor[2] = pos + len(chunk)
                    if st.cursor[2] >= len(rows):
                        st.cursor = None  # drained: close the cursor
                        io.write_packet(P.eof_packet(P.SERVER_STATUS_LAST_ROW_SENT))
                    else:
                        io.write_packet(P.eof_packet(P.SERVER_STATUS_CURSOR_EXISTS))
                elif cmd == COM_STMT_CLOSE:
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    if stmts.pop(sid, None) is not None:
                        try:
                            sess.deallocate(f"__c{sid}")
                        except ValueError:
                            pass  # DEALLOCATE PREPARE by SQL got there first
                    # no response by protocol
                elif cmd == COM_STMT_RESET:
                    st = stmts.get(struct.unpack_from("<I", payload, 0)[0])
                    if st is not None:
                        st.cursor = None  # drop any open cursor
                    io.write_packet(P.ok_packet())
                else:
                    io.write_packet(P.err_packet(1047, f"unsupported command {cmd:#x}"))
            except Exception as e:  # error -> ERR packet, connection lives
                try:
                    errno = int(getattr(e, "mysql_errno", 0) or 1105)
                    io.write_packet(P.err_packet(errno, str(e)))
                except OSError:
                    return

    def _write_result(self, io: P.PacketIO, r: Result, sess: Session, binary: bool = False) -> None:
        if not r.columns:
            io.write_packet(P.ok_packet(affected=r.affected, last_insert_id=int(sess.last_insert_id)))
            return
        types = r.types or [None] * len(r.columns)
        io.write_packet(P.lenenc_int(len(r.columns)))
        for name, t in zip(r.columns, types):
            io.write_packet(P.column_def(name, t))
        io.write_packet(P.eof_packet())
        if binary:
            for row in r.rows:
                io.write_packet(P.binary_row(row, types))
        else:
            for row in r.rows:
                payload = b""
                for v, t in zip(row, types):
                    fv = P.format_value(v, t)
                    payload += b"\xfb" if fv is None else P.lenenc_str(fv)
                io.write_packet(payload)
        io.write_packet(P.eof_packet())
