"""The port's MySQL server binary.

    python3 -m tidb_tpu_torch.tidb_server [--config FILE] [--host HOST]
        [-P PORT] [--path DIR] [--status-port PORT] [--store cuda|cpu]
        [--tpch SF]

Counterpart of tidb_server.py (reference: cmd/tidb-server/main.go flags,
the TOML config loaded by InitializeConfig, createServer and the graceful
shutdown on SIGTERM). Layers: built-in defaults <- the ``--config`` TOML
(utils/config.py) <- the flags. ``--store`` names the engine: ``cuda``
(the default; with no card it raises before any data is loaded) or
``cpu``. With ``--path`` the catalog loads from the snapshot directory on
boot when its ``manifest.json`` is there, and is snapshotted back after
the accept loop returns on SIGTERM, once the TTL and stats workers have
been joined; a failed snapshot exits non-zero. ``--status-port`` serves
the HTTP status API (0: any free port). ``--tpch SF`` loads TPC-H at
scale factor SF into database ``tpch`` (``load_tpch``'s default seed).
The instance watchdog (utils/watchdog.py) runs for the server's life.
The binary prints ``tidb_tpu_torch listening on HOST:PORT`` once it
accepts connections (``-P 0``: any free port), and ``status on
HOST:PORT`` before it when it serves the status API.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="MySQL-compatible SQL engine on one CUDA card")
    ap.add_argument("--config", default=None, metavar="FILE", help="TOML config file")
    ap.add_argument("--host", default=None)
    ap.add_argument("-P", "--port", type=int, default=None, help="0: any free port")
    ap.add_argument("--path", default=None,
                    help="persistence dir: load on boot, snapshot on shutdown")
    ap.add_argument("--status-port", type=int, default=None,
                    help="HTTP status port (0: any free port)")
    ap.add_argument("--store", default=None, choices=["cuda", "cpu"],
                    help="the engine: cuda (default) or cpu")
    ap.add_argument("--tpch", type=float, default=None, metavar="SF",
                    help="bootstrap with TPC-H data at scale factor SF")
    args = ap.parse_args(argv)

    from tidb_tpu_torch.chunk import resolve_device
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.storage import Catalog
    from tidb_tpu_torch.utils.config import Config
    from tidb_tpu_torch.utils.watchdog import ensure_watchdog

    cfg = Config.from_toml(args.config) if args.config else Config()
    cfg = cfg.override(host=args.host, port=args.port, path=args.path, store=args.store,
                       status_port=args.status_port)
    device = resolve_device(cfg.device)
    catalog = Catalog()
    if cfg.path and os.path.exists(os.path.join(cfg.path, "manifest.json")):
        from tidb_tpu_torch.storage.persist import load_catalog

        t0 = time.perf_counter()
        load_catalog(cfg.path, catalog)
        print(f"loaded catalog from {cfg.path} in {time.perf_counter() - t0:.3f}s", flush=True)
    cfg.apply_variables(catalog)
    if args.tpch:
        from tidb_tpu_torch.bench import load_tpch

        print(f"generating TPC-H sf={args.tpch:g} ...", flush=True)
        load_tpch(catalog, sf=args.tpch)
    srv = Server(catalog, host=cfg.host, port=cfg.port, device=device,
                 status_port=cfg.status_port)
    srv.stats_handle.interval_s = cfg.auto_analyze_interval_s
    watchdog = ensure_watchdog(catalog)
    if srv.status_server is not None:
        print(f"status on {cfg.host}:{srv.status_server.port}", flush=True)
    print(f"tidb_tpu_torch listening on {cfg.host}:{srv.port}", flush=True)

    stopping = []

    def on_sigterm(*_):
        # shutdown() waits for serve_forever() to return, and the handler
        # runs on serve_forever's thread: stop the loop from another one;
        # the main thread then falls out of serve_forever and snapshots
        th = threading.Thread(target=srv.shutdown, daemon=True, name="mysql-shutdown")
        stopping.append(th)
        th.start()

    signal.signal(signal.SIGTERM, on_sigterm)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    # serve_forever returns before the helper's shutdown has joined the
    # workers: wait for it, so no TTL purge or ANALYZE runs under the
    # snapshot
    for th in stopping:
        th.join(timeout=30)
        if th.is_alive():
            # the workers may still run: a snapshot now could take its
            # tables at different moments
            raise RuntimeError("the server did not stop within 30 s; no snapshot taken")
    watchdog.stop()
    if cfg.path:
        from tidb_tpu_torch.storage.persist import save_catalog

        t0 = time.perf_counter()
        written = save_catalog(catalog, cfg.path)
        print(f"snapshot of {written} tables to {cfg.path} in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
