"""Clients for the ensemble service: socket and in-process.

Both speak the same protocol (:mod:`repro.serve.protocol`) and expose the
same convenience methods; :class:`InProcessClient` short-circuits the
transport and calls the handler directly — handy for embedding the service
in an application process (and for tests).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, Dict, List, Optional

from .protocol import ProtocolHandler


class ServeRequestError(RuntimeError):
    """A request the server answered with ``ok: false``."""

    def __init__(self, error: Dict[str, Any]) -> None:
        super().__init__(error.get("message", "request failed"))
        self.code = error.get("code", "error")


class _ClientBase:
    def _roundtrip(self, req: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def _call(self, op: str, **fields: Any) -> Dict[str, Any]:
        req = {"op": op}
        req.update(fields)
        resp = self._roundtrip(req)
        if not resp.get("ok"):
            raise ServeRequestError(resp.get("error") or {})
        return resp

    # -- convenience wrappers -------------------------------------------------#

    def hello(self) -> Dict[str, Any]:
        return self._call("hello")

    def submit(self, kernel: str, sweep: List[Dict[str, Any]],
               tenant: str = "default", name: Optional[str] = None,
               slots: int = 1, resume: bool = False,
               compile: Optional[Dict[str, Any]] = None) -> str:
        resp = self._call("submit", kind="ensemble_sweep", kernel=kernel,
                          sweep=sweep, tenant=tenant, name=name,
                          slots=slots, resume=resume,
                          compile=compile or {})
        return resp["handle"]

    def wait(self, handle: str, timeout: Optional[float] = None) -> bool:
        return self._call("wait", handle=handle, timeout=timeout)["done"]

    def result(self, handle: str) -> Dict[str, Any]:
        return self._call("result", handle=handle)["results"]

    def states(self, handle: str) -> Dict[str, str]:
        return self._call("states", handle=handle)["states"]

    def cancel(self, handle: str) -> None:
        self._call("cancel", handle=handle)

    def stats(self) -> Dict[str, Any]:
        return self._call("stats")["stats"]

    def metrics(self) -> Dict[str, Any]:
        """Telemetry snapshot: ``exposition`` (Prometheus text) plus
        per-tenant queue-wait quantiles and carrier-sharing counts."""
        return self._call("metrics")["metrics"]

    def shutdown(self, drain: bool = True) -> None:
        self._call("shutdown", drain=drain)


class SocketClient(_ClientBase):
    """JSON-lines client over TCP. Thread-safe: one in-flight request at a
    time per client (requests serialize on an internal lock)."""

    def __init__(self, host: str, port: int, timeout: float = 300.0) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._fh = self._sock.makefile("r", encoding="utf-8")
        self._lock = threading.Lock()
        self._seq = 0

    def _roundtrip(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            req["id"] = self._seq
            self._sock.sendall(
                (json.dumps(req, separators=(",", ":")) + "\n")
                .encode("utf-8"))
            line = self._fh.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            return json.loads(line)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "SocketClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class InProcessClient(_ClientBase):
    """The same protocol without a socket: requests dispatch straight into
    a :class:`~repro.serve.protocol.ProtocolHandler`."""

    def __init__(self, service_or_handler: Any) -> None:
        self._handler = (service_or_handler
                         if isinstance(service_or_handler, ProtocolHandler)
                         else ProtocolHandler(service_or_handler))
        self._seq = 0
        self._lock = threading.Lock()

    def _roundtrip(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            req["id"] = self._seq
        # round-trip through JSON so in-process and socket clients accept
        # exactly the same payloads (no accidentally-richer types)
        return json.loads(json.dumps(
            self._handler.handle(json.loads(json.dumps(req, default=str))),
            default=str))
