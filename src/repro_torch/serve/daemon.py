"""Socket front-end for the ensemble service.

A thin accept loop over :class:`~repro.serve.protocol.ProtocolHandler`:
one thread per connection, newline-delimited JSON in both directions. The
daemon binds ``host:port`` (``port=0`` picks a free port, read it back
from ``daemon.port``) and shares a single handler across connections, so
handles minted on one connection are usable from another — a client can
submit, disconnect, and reconnect to wait.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, List, Optional

from .protocol import ProtocolHandler


class ServiceDaemon:
    def __init__(self, service: Any, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.service = service
        self.handler = ProtocolHandler(service)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        # submits whose accept response never reached the client and were
        # cancelled to refund their admitted capacity
        self.abandoned_submits = 0

    def start(self) -> "ServiceDaemon":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="serve-accept")
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return   # listener closed
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="serve-conn")
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            fh = conn.makefile("r", encoding="utf-8")
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    resp = {"id": None, "ok": False,
                            "error": {"code": "bad-request",
                                      "message": "undecodable request"}}
                else:
                    resp = self.handler.handle(req)
                try:
                    conn.sendall(
                        (json.dumps(resp, separators=(",", ":"),
                                    default=str) + "\n").encode("utf-8"))
                except OSError:
                    # client went away mid-response: if that response was a
                    # successful submit, the handle id is lost forever —
                    # cancel the orphan so admission refunds the capacity
                    if (resp.get("ok") and req.get("op") == "submit"
                            and resp.get("handle")):
                        self.handler.abandon(resp["handle"])
                        self.abandoned_submits += 1
                    return
