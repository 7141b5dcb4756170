"""Write-ahead journal: transactional state updates + resume (paper §II-B.4).

"All state updates in EnTK are transactional, hence any EnTK component that
fails can be restarted at runtime without losing information about ongoing
execution. In case of full failure, EnTK can reacquire upon restarting
information about the state of the execution up to the latest successful
transaction before the failure." — the journal is that mechanism. EnTK syncs
to disk and keeps hooks for an external database; we implement the disk path
(JSONL, append-only, explicit flush policy) plus replay.

Crash consistency (chaos plane PR):

* every record carries a ``cs`` crc32 checksum over its canonical
  serialization, so a torn or bit-rotted tail is *detected*, not silently
  replayed as a shorter-but-valid JSON prefix;
* a torn/corrupt FINAL record is **truncated from disk** (with a warning)
  both on replay and on open-for-append — appending after a torn tail would
  otherwise concatenate the new record onto the partial line and corrupt
  both. Truncation is idempotent: a second replay sees identical bytes.
* FAILED and pipeline-final transition records are fsynced (not just
  flushed) regardless of ``flush_every`` — a host crash can delay progress
  records, but never lose terminal state.

Records:
  {"rec": "transition", "kind": "task|stage|pipeline", "uid", "name",
   "frm", "to", "t", ...extra, "cs": crc32}
  {"rec": "session", "event": "start|resume|end", "t", ..., "cs": crc32}

Replay returns the latest state per (kind, name) so a resumed AppManager can
skip completed tasks — resume is keyed on *names* (stable across process
restarts) rather than uids (which are session-scoped).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import warnings
import zlib
from typing import Any, Dict, Optional, Tuple

from .exceptions import JournalCorruption

#: pipeline states whose journal record must hit the platter before the
#: caller proceeds (terminal state must survive a host crash)
_PIPELINE_FINAL = ("DONE", "FAILED", "CANCELED")


def _checksum(body: str) -> int:
    return zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF


def _seal(record: Dict[str, Any]) -> str:
    """Serialize a record with its ``cs`` checksum grafted on as the LAST
    key — replay pops it and re-serializes the remaining keys in their
    original order, so the check needs no canonicalization pass."""
    body = json.dumps(record, separators=(",", ":"), default=str)
    if body == "{}":
        return json.dumps({"cs": _checksum(body)}, separators=(",", ":"))
    return f'{body[:-1]},"cs":{_checksum(body)}}}'


def _verify(rec: Dict[str, Any]) -> bool:
    """Pop and check a parsed record's checksum. Records written before the
    checksum era (or hand-written fixtures) carry none and pass."""
    cs = rec.pop("cs", None)
    if cs is None:
        return True
    body = json.dumps(rec, separators=(",", ":"), default=str)
    return _checksum(body) == cs


def _line_ok(raw: bytes) -> bool:
    """One journal line decodes AND checksums (blank lines are fine)."""
    try:
        text = raw.decode("utf-8").strip()
    except UnicodeDecodeError:
        return False
    if not text:
        return True
    try:
        rec = json.loads(text)
    except json.JSONDecodeError:
        return False
    return isinstance(rec, dict) and _verify(rec)


class Journal:
    """Append-only JSONL write-ahead journal.

    ``flush_every`` trades durability for throughput: 1 = flush every record
    (strict transactional), N = flush every N records plus on close. The
    Fig.-6 benchmark sweeps this to show the cost of strict durability.
    ``fsync_critical`` (default on) additionally fsyncs FAILED and
    pipeline-final records the moment they are appended, regardless of
    ``flush_every`` — terminal state is never lost to a host crash.
    """

    def __init__(self, path: Optional[str], flush_every: int = 32,
                 fsync_critical: bool = True) -> None:
        self.path = path
        self.flush_every = max(1, flush_every)
        self.fsync_critical = fsync_critical
        self._lock = threading.Lock()
        self._since_flush = 0
        self._fh: Optional[io.TextIOWrapper] = None
        self.records_written = 0
        self.fsyncs = 0
        #: bytes of torn tail dropped before this session appended anything
        self.tail_recovered = 0
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # appending onto a torn tail would concatenate the first new
            # record into the partial line, corrupting BOTH — recover first
            self.tail_recovered = self.recover_tail(path)
            self._fh = open(path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        """True when a write-ahead file actually backs this journal."""
        return self._fh is not None

    # -- write ----------------------------------------------------------------#

    @staticmethod
    def _critical(record: Dict[str, Any]) -> bool:
        if record.get("rec") != "transition":
            return False
        to = record.get("to")
        return to == "FAILED" or (record.get("kind") == "pipeline"
                                  and to in _PIPELINE_FINAL)

    def append(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        record.setdefault("t", time.time())
        line = _seal(record)
        critical = self.fsync_critical and self._critical(record)
        with self._lock:
            self._fh.write(line + "\n")
            self.records_written += 1
            self._since_flush += 1
            if critical:
                self._fh.flush()
                try:
                    os.fsync(self._fh.fileno())
                except OSError:  # non-seekable sink (pipe/FIFO test double)
                    pass
                self.fsyncs += 1
                self._since_flush = 0
            elif self._since_flush >= self.flush_every:
                self._fh.flush()
                self._since_flush = 0

    def transition(self, kind: str, uid: str, name: str, frm: str, to: str,
                   **extra: Any) -> None:
        rec = {"rec": "transition", "kind": kind, "uid": uid, "name": name,
               "frm": frm, "to": to}
        rec.update(extra)
        self.append(rec)

    def session(self, event: str, **extra: Any) -> None:
        rec = {"rec": "session", "event": event}
        rec.update(extra)
        self.append(rec)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._since_flush = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    # -- crash recovery -------------------------------------------------------#

    @staticmethod
    def recover_tail(path: str) -> int:
        """Drop a torn/corrupt FINAL record from the journal file.

        Returns the number of bytes truncated (0 when the tail is intact).
        Only the *last* record is ever repaired — an append-only writer can
        tear at most its final line; anything invalid earlier is real
        corruption and is left for :meth:`replay` to raise on. Idempotent:
        a repaired journal is byte-stable across repeated recoveries."""
        if not path or not os.path.exists(path):
            return 0
        total = 0
        while True:
            with open(path, "rb") as fh:
                data = fh.read()
            if not data:
                return total
            if not data.endswith(b"\n"):
                cut = data.rfind(b"\n") + 1    # unterminated tail: torn write
            else:
                start = data.rfind(b"\n", 0, len(data) - 1) + 1
                if _line_ok(data[start:len(data) - 1]):
                    return total
                cut = start                    # terminated but fails checksum
            dropped = len(data) - cut
            with open(path, "rb+") as fh:
                fh.truncate(cut)
            warnings.warn(
                f"{path}: dropped {dropped} bytes of torn journal tail "
                "(recovered to the previous transaction)", RuntimeWarning)
            total += dropped

    # -- replay ---------------------------------------------------------------#

    @staticmethod
    def replay(path: str) -> Dict[str, Any]:
        """Replay a journal file.

        Returns ``{"state": {(kind, name): last_state}, "retries": {name: n},
        "results": {name: value}, "result_omitted": {name, ...},
        "sessions": [...], "records": n}``. ``results`` restores task return
        values recorded on DONE transitions (data-flow resume: consumers of
        a task completed in a previous session still find their inputs);
        ``result_omitted`` names DONE tasks whose value could not be
        journaled (not JSON-serializable) — the AppManager re-runs those on
        resume rather than hand their consumers a lost value. A torn or
        checksum-failing trailing record (torn write at crash) is truncated
        from disk with a warning — replay-then-replay is byte-stable; any
        earlier corruption raises :class:`JournalCorruption`.
        """
        state: Dict[Tuple[str, str], str] = {}
        retries: Dict[str, int] = {}
        results: Dict[str, Any] = {}
        result_omitted: set = set()
        sessions = []
        n = 0
        if not os.path.exists(path):
            return {"state": state, "retries": retries, "results": results,
                    "result_omitted": result_omitted, "sessions": sessions,
                    "records": 0}
        Journal.recover_tail(path)
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.readlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn final write: recover to previous transaction
                raise JournalCorruption(
                    f"{path}: undecodable record at line {i + 1}") from None
            if not isinstance(rec, dict) or not _verify(rec):
                if i == len(lines) - 1:
                    break
                raise JournalCorruption(
                    f"{path}: checksum mismatch at line {i + 1}")
            n += 1
            if rec.get("rec") == "transition":
                key = (rec["kind"], rec.get("name") or rec["uid"])
                state[key] = rec["to"]
                # pilot_lost FAILED hops are infrastructure failures
                # (federation member death): journaled for the audit trail,
                # but they never consumed the task's retry budget, so they
                # must not be restored into it on resume either
                if (rec["kind"] == "task" and rec["to"] == "FAILED"
                        and not rec.get("pilot_lost")):
                    retries[key[1]] = retries.get(key[1], 0) + 1
                if rec["kind"] == "task" and rec["to"] == "DONE":
                    # results ride the DONE record; a resumed-DONE replayed
                    # in a later session carries none — keep the last one
                    # actually recorded rather than clearing it
                    if "result" in rec:
                        results[key[1]] = rec["result"]
                        result_omitted.discard(key[1])
                    elif rec.get("result_omitted"):
                        result_omitted.add(key[1])
            elif rec.get("rec") == "session":
                sessions.append(rec)
        return {"state": state, "retries": retries, "results": results,
                "result_omitted": result_omitted, "sessions": sessions,
                "records": n}
