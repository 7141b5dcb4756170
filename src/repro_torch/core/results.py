"""Process-global output store: task results routed to their consumers.

The declarative API (``repro.api``) compiles data-flow edges — a task
consuming another task's *return value* — down to PST tasks whose kwargs
carry ``{"__future__": <producer name>}`` placeholders. Somebody has to hold
the produced values between the producer's completion and the consumer's
execution; that is this store.

* **Writer**: the WFProcessor's Dequeue routes ``task.result`` here when a
  task tagged with a workflow namespace (``task.tags["_wf_ns"]``) reaches
  DONE — before the stage-closure accounting that makes the consumer's stage
  schedulable, so a consumer can never execute before its inputs are
  readable. Adaptive combinators (``repeat_until``/``branch``) additionally
  write their aggregate values from their ``post_exec`` hooks.
* **Reader**: the API trampoline (``repro.api.runtime``) resolves
  placeholders at execution time, RTS-side; ``Future.result()`` reads the
  same keys after the run.
* **Resume**: the AppManager preloads replayed journal results for
  resumed-DONE tasks before the workflow starts, so consumers of tasks
  completed in a previous session still find their inputs.

Keys are ``(namespace, task name)``: the namespace is minted per
``api.compile()`` call, so concurrent workflows in one process (tests, the
federation benchmarks) never collide even when task names repeat.

The store is deliberately process-global and unbounded for the lifetime of a
namespace — values stay readable after the run for ``Future.result()``.
Long-lived processes that run many workflows should call
:meth:`ResultStore.clear_namespace` (``api`` does this in
``Compiled.close()``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Tuple

from .exceptions import MissingError

_MISSING = object()


# --------------------------------------------------------------------------- #
# Journal-value codecs
# --------------------------------------------------------------------------- #
# Rich result objects (e.g. the fusion engine's device-resident ArrayResult)
# cannot ride a DONE record as JSON. Instead they journal a small tagged dict
# ({"__codec__": <tag>, ...}) produced by the object's ``to_journal`` hook,
# and replay turns the dict back into the live object through a decoder
# registered here. The core stays ignorant of any concrete codec — higher
# layers register theirs at import time (see repro.fusion.handles).

_CODEC_KEY = "__codec__"
_CODECS: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
_SPILLERS: list = []
_codec_lock = threading.Lock()


def register_result_codec(tag: str,
                          decode: Callable[[Dict[str, Any]], Any]) -> None:
    """Register ``decode`` for journal records tagged ``tag``."""
    with _codec_lock:
        _CODECS[tag] = decode


def register_result_spiller(
        spill: Callable[[Any, str], "Dict[str, Any] | None"]) -> None:
    """Register ``spill(value, spill_dir) -> record|None``: a last chance
    to journal a value that neither carries a ``to_journal`` hook nor
    JSON-round-trips. Returning a tagged record (decodable through a
    registered codec) journals it; ``None`` passes to the next spiller
    (and ultimately to ``result_omitted``)."""
    with _codec_lock:
        _SPILLERS.append(spill)


def spill_journal_value(value: Any, spill_dir: Any) -> Any:
    """Offer ``value`` to the registered spillers; record dict or None."""
    if not spill_dir:
        return None
    with _codec_lock:
        spillers = list(_SPILLERS)
    for spill in spillers:
        try:
            record = spill(value, spill_dir)
        except Exception:  # noqa: BLE001 - a failed spill is just omitted
            record = None
        if record is not None:
            return record
    return None


def decode_journal_value(value: Any) -> Any:
    """Decode a journal-replayed result value.

    Plain values pass through. Tagged dicts dispatch to their codec; an
    unknown tag or a failing decoder raises :class:`MissingError`, which the
    resume path answers by re-running the producer (the same contract as
    ``result_omitted``).
    """
    if isinstance(value, dict) and _CODEC_KEY in value:
        with _codec_lock:
            decode = _CODECS.get(value[_CODEC_KEY])
        if decode is None:
            raise MissingError(
                f"no result codec registered for journal tag "
                f"{value[_CODEC_KEY]!r} — import the producing subsystem "
                f"before resuming")
        return decode(value)
    return value


class ResultStore:
    """Thread-safe ``(namespace, name) -> value`` map."""

    def __init__(self) -> None:
        self._data: Dict[Tuple[str, str], Any] = {}
        self._lock = threading.Lock()

    def put(self, ns: str, name: str, value: Any) -> None:
        with self._lock:
            self._data[(ns, name)] = value

    def get(self, ns: str, name: str, default: Any = _MISSING) -> Any:
        with self._lock:
            value = self._data.get((ns, name), _MISSING)
        if value is _MISSING:
            if default is _MISSING:
                raise MissingError(
                    f"no result for task {name!r} in workflow namespace "
                    f"{ns!r}: its producer has not completed (or its result "
                    f"was not journal-serializable on resume)")
            return default
        return value

    def has(self, ns: str, name: str) -> bool:
        with self._lock:
            return (ns, name) in self._data

    def names(self, ns: str) -> List[str]:
        with self._lock:
            return [n for (s, n) in self._data if s == ns]

    def clear_namespace(self, ns: str) -> int:
        with self._lock:
            keys = [k for k in self._data if k[0] == ns]
            for k in keys:
                del self._data[k]
            return len(keys)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


#: The single per-process store all components share (a store instance per
#: AppManager would leave the RTS-side trampoline, which only sees task
#: kwargs, with no way to find "its" store).
STORE = ResultStore()
