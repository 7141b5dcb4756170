"""JSON-lines wire protocol for the ensemble service.

One request per line, one response per line, both JSON objects. Every
request carries ``op`` and a client-chosen ``id``; the response echoes the
``id`` and sets ``ok``. Failures answer ``{"ok": false, "error": {"code",
"message"}}`` — admission rejections surface their stable code so clients
can key retry policy on it.

Operations:

* ``hello``                         -> server banner + protocol version
* ``submit``   (tenant, kind=ensemble_sweep, kernel, sweep, [name, slots,
  resume, compile])                 -> handle id, namespace, task count
* ``wait``     (handle, [timeout])  -> done flag
* ``result``   (handle)             -> results produced so far (JSON-safe)
* ``states``   (handle)             -> per-task state map
* ``cancel``   (handle)             -> ok
* ``stats``                         -> service statistics
* ``metrics``                       -> telemetry snapshot: Prometheus text
  exposition + per-tenant queue-wait quantiles and carrier sharing
* ``shutdown`` ([drain])            -> ok (service stops after responding)

``kernel`` is a ``reg://<name>`` reference (a callable registered with
:func:`repro.core.pst.register_executable` in the server process) or a
``module:function`` path importable server-side. ``sweep`` is a list of
kwargs dicts, exactly the ``over=`` argument of :func:`repro.api.ensemble`.
The kernel resolves to the *callable* before compilation so fusion group
keys are computed — which is what lets sweeps from different tenants share
carriers.
"""

from __future__ import annotations

import importlib
import json
import threading
from typing import Any, Callable, Dict

from ..core.pst import resolve_executable
from .admission import AdmissionError

PROTOCOL_VERSION = 1


def _resolve_kernel(ref: str) -> Callable[..., Any]:
    if ref.startswith("reg://"):
        return resolve_executable(ref)
    if ":" in ref:
        module, _, attr = ref.partition(":")
        fn = getattr(importlib.import_module(module), attr)
        if callable(fn):
            return fn
    raise ValueError(f"unresolvable kernel reference {ref!r} — use "
                     f"'reg://<name>' or 'module:function'")


def jsonable(value: Any) -> Any:
    """Best-effort JSON projection of a result value: materialize array
    handles, fall back to ``repr`` for anything that won't round-trip."""
    materialize = getattr(value, "value", None)
    if callable(materialize):
        try:
            value = materialize()
        except Exception:  # noqa: BLE001 - keep the handle's repr instead
            pass
    tolist = getattr(value, "tolist", None)
    if callable(tolist):
        try:
            value = tolist()
        except Exception:  # noqa: BLE001
            pass
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return {"__repr__": repr(value)}


class ProtocolHandler:
    """Server-side request dispatcher, shared by the socket daemon and the
    in-process client — one protocol, two transports."""

    def __init__(self, service: Any) -> None:
        self.service = service
        self._handles: Dict[str, Any] = {}
        self._seq = 0
        self._lock = threading.Lock()

    def _register(self, handle: Any) -> str:
        with self._lock:
            self._seq += 1
            hid = f"h{self._seq}"
            self._handles[hid] = handle
        return hid

    def abandon(self, hid: str) -> None:
        """Refund a submission whose accept response never reached the
        client. Admission charged the tenant when ``submit`` succeeded; if
        the connection dies before the handle id is delivered, nobody can
        ever ``wait``/``cancel`` it, so the capacity would leak until the
        sweep finished on its own. Cancelling the orphan drives the normal
        pipeline-final path, which releases the admitted members."""
        with self._lock:
            handle = self._handles.pop(hid, None)
        if handle is None:
            return
        try:
            handle.cancel()
        except Exception:  # noqa: BLE001 - refund path must never raise
            pass

    def _handle_of(self, req: Dict[str, Any]) -> Any:
        hid = req.get("handle")
        with self._lock:
            handle = self._handles.get(hid)
        if handle is None:
            raise KeyError(f"unknown handle {hid!r}")
        return handle

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        rid = req.get("id")
        try:
            op = req.get("op")
            fn = getattr(self, f"_op_{op}", None)
            if fn is None:
                raise ValueError(f"unknown op {op!r}")
            resp = fn(req)
            resp.setdefault("ok", True)
        except AdmissionError as exc:
            resp = {"ok": False,
                    "error": {"code": exc.code, "message": str(exc)}}
        except Exception as exc:  # noqa: BLE001 - protocol boundary
            resp = {"ok": False,
                    "error": {"code": "error",
                              "message": f"{type(exc).__name__}: {exc}"}}
        resp["id"] = rid
        return resp

    # -- operations -----------------------------------------------------------#

    def _op_hello(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"server": "repro-serve", "version": PROTOCOL_VERSION}

    def _op_submit(self, req: Dict[str, Any]) -> Dict[str, Any]:
        kind = req.get("kind", "ensemble_sweep")
        if kind != "ensemble_sweep":
            raise ValueError(f"unsupported submission kind {kind!r}")
        from .. import api  # deferred
        fn = _resolve_kernel(req["kernel"])
        sweep = req.get("sweep") or []
        if not isinstance(sweep, list):
            raise ValueError("'sweep' must be a list of kwargs dicts")
        node = api.ensemble(fn, over=sweep, name=req.get("name"),
                            slots=int(req.get("slots", 1)))
        handle = self.service.submit(
            node, tenant=str(req.get("tenant", "default")),
            resume=bool(req.get("resume", False)),
            **dict(req.get("compile") or {}))
        return {"handle": self._register(handle), "ns": handle.ns,
                "n_tasks": handle.n_members}

    def _op_wait(self, req: Dict[str, Any]) -> Dict[str, Any]:
        handle = self._handle_of(req)
        timeout = req.get("timeout")
        done = handle.wait(float(timeout) if timeout is not None else None)
        return {"done": done}

    def _op_result(self, req: Dict[str, Any]) -> Dict[str, Any]:
        handle = self._handle_of(req)
        return {"done": handle.done(),
                "results": {name: jsonable(value)
                            for name, value in handle.results().items()}}

    def _op_states(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"states": self._handle_of(req).task_states()}

    def _op_cancel(self, req: Dict[str, Any]) -> Dict[str, Any]:
        self._handle_of(req).cancel()
        return {}

    def _op_stats(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"stats": self.service.stats()}

    def _op_metrics(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"metrics": self.service.metrics()}

    def _op_shutdown(self, req: Dict[str, Any]) -> Dict[str, Any]:
        drain = bool(req.get("drain", True))
        threading.Thread(target=self.service.stop, kwargs={"drain": drain},
                         daemon=True, name="serve-shutdown").start()
        return {}
