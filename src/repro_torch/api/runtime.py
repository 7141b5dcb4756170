"""RTS-side runtime of the declarative API.

Compiled tasks do not carry their input *values* — they carry
``{"__future__": <name>}`` placeholders. Every data-flow task executes
through one registered trampoline (:func:`_api_call`) that resolves the
placeholders against the process-global result store at execution time and
then calls the user's function. Because the trampoline and the user function
are both ``reg://`` registrations, compiled tasks stay journal-resumable.

Also here: deterministic auto-registration of user callables (so workflow
authors never have to call :func:`repro.core.register_executable` by hand)
and the encode/decode of placeholder arguments.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

from ..core.pst import (register_executable, registered_executable,
                        resolve_executable)
from ..core.results import STORE
from .errors import CompileError
from .futures import Future

TRAMPOLINE = "reg://_api.call"
COLLECT = "reg://_api.collect"

_reg_lock = threading.Lock()
# id(fn) -> reg:// ref, with a strong reference to fn so ids never recycle
_fn_refs: Dict[int, "tuple[Callable[..., Any], str]"] = {}


def ensure_registered(fn: Callable[..., Any]) -> str:
    """Register ``fn`` under a deterministic name; return its ``reg://`` ref.

    The name is ``<module>.<qualname>`` — stable across processes, which is
    what makes compiled workflows journal-resumable. Two *different*
    callables that share a qualname (e.g. two lambdas) get deterministic
    ``#<n>`` suffixes in registration order; resumable workflows should use
    module-level functions so that order cannot drift between sessions.
    """
    with _reg_lock:
        cached = _fn_refs.get(id(fn))
        if cached is not None:
            return cached[1]
        base = f"{getattr(fn, '__module__', 'anon')}." \
               f"{getattr(fn, '__qualname__', 'fn')}"
        name, n = base, 1
        while True:
            owner = registered_executable(name)
            if owner is None or owner is fn:
                break
            n += 1
            name = f"{base}#{n}"
        ref = register_executable(name, fn)
        _fn_refs[id(fn)] = (fn, ref)
        return ref


# --------------------------------------------------------------------------- #
# Placeholder encoding (compile time) / resolution (execution time)
# --------------------------------------------------------------------------- #

FUTURE_KEY = "__future__"


def encode(value: Any, where: str) -> Any:
    """Recursively replace Futures with serializable placeholders."""
    if isinstance(value, Future):
        if value.name is None:
            raise CompileError(f"unbound (unnamed) future in {where}")
        return {FUTURE_KEY: value.name}
    if isinstance(value, (list, tuple)):
        return [encode(v, where) for v in value]
    if isinstance(value, dict):
        if set(value) == {FUTURE_KEY}:
            # a literal dict of this exact shape would be indistinguishable
            # from a placeholder at resolution time and silently substituted
            raise CompileError(
                f"literal dict {{'{FUTURE_KEY}': ...}} in {where} collides "
                f"with the future-placeholder encoding — rename the key or "
                f"nest it under another key")
        return {k: encode(v, where) for k, v in value.items()}
    return value


def resolve(value: Any, ns: str) -> Any:
    """Recursively replace placeholders with their produced values."""
    if isinstance(value, dict):
        if set(value) == {FUTURE_KEY}:
            return STORE.get(ns, value[FUTURE_KEY])
        return {k: resolve(v, ns) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve(v, ns) for v in value]
    return value


# --------------------------------------------------------------------------- #
# Registered executables
# --------------------------------------------------------------------------- #

def _api_call(__ns__: str, __fn__: str, __args__: List[Any],
              __kwargs__: Dict[str, Any], _cancel_event: Any = None) -> Any:
    """The data-flow trampoline every compiled callable task runs through.

    ``_cancel_event`` is injected by the RTS (cooperative cancellation);
    it is forwarded to user functions that declare the same parameter, so
    the API layer does not hide the escape hatch the imperative layer has.
    """
    fn = resolve_executable(__fn__)
    args = resolve(__args__, __ns__)
    kwargs = resolve(__kwargs__, __ns__)
    code = getattr(fn, "__code__", None)
    if (_cancel_event is not None and code is not None
            and "_cancel_event" in _param_names(code)):
        kwargs["_cancel_event"] = _cancel_event
    return fn(*args, **kwargs)


def _param_names(code) -> "tuple[str, ...]":
    """Actual parameters only — co_varnames alone also lists body locals,
    which would inject an unexpected kwarg into functions that merely use
    ``_cancel_event`` as a variable name."""
    return code.co_varnames[:code.co_argcount + code.co_kwonlyargcount]


def _api_collect(values: List[Any]) -> List[Any]:
    """Decision/join task payload: returns its (already resolved) inputs.

    The paper's 'branching events specified as tasks where a decision is
    made': adaptive combinators compile their triggers to one of these, so
    the gathered round/branch results are themselves a journaled task result
    — which is exactly what makes adaptive loops replayable.
    """
    return values


register_executable("_api.call", _api_call)
register_executable("_api.collect", _api_collect)
