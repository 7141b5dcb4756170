"""Synchronizer: the AppManager subcomponent that owns the global state record.

Single consumer of the ``states`` queue. For every transition message it
(1) journals the transition (write-ahead), (2) updates the AppManager's
state table, and (3) acknowledges transactional messages. Because it is the
only writer of the journal and the state table, transitions are totally
ordered — the property the paper relies on for resumability.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from .broker import Broker
from .journal import Journal
from .state_service import STATES_QUEUE


class Synchronizer:
    def __init__(self, broker: Broker, journal: Journal,
                 state_table: Dict[str, str],
                 on_transition: Optional[Callable[[Dict[str, Any]], None]] = None,
                 batch: int = 256) -> None:
        self.broker = broker
        self.journal = journal
        self.state_table = state_table  # shared with AppManager: f"{kind}:{name}" -> state
        self.on_transition = on_transition
        self.batch = batch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.processed = 0
        self.crash_hook: Optional[Callable[[], None]] = None  # test injection

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="synchronizer")
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        if drain:
            # give the loop a chance to empty the queue
            for _ in range(200):
                if self.broker.depth(STATES_QUEUE) == 0:
                    break
                threading.Event().wait(0.01)
        self._stop.set()
        self.broker.kick(STATES_QUEUE)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.journal.flush()

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            # event-driven: block until transitions arrive (or stop kicks);
            # popped messages are always processed, even mid-shutdown, so a
            # transactional advance is never left waiting on its ack
            msgs = self.broker.get_many(STATES_QUEUE, self.batch, timeout=None,
                                        abort=self._stop)
            if self.crash_hook is not None:
                self.crash_hook()
            if not msgs:
                continue
            needs_flush = False
            for _tag, msg in msgs:
                if msg.get("type") != "transition":
                    continue
                extra = dict(msg.get("extra", {}))
                if "via" in msg:  # coalesced transition chain
                    extra["via"] = msg["via"]
                if "ns" in msg:   # workflow namespace: per-tenant routing
                    extra["ns"] = msg["ns"]
                self.journal.transition(
                    kind=msg["kind"], uid=msg["uid"], name=msg["name"],
                    frm=msg["frm"], to=msg["to"], **extra)
                self.state_table[f"{msg['kind']}:{msg['name']}"] = msg["to"]
                self.processed += 1
                if self.on_transition is not None:
                    self.on_transition(msg)
                if "_ack" in msg:
                    needs_flush = True
            if needs_flush:
                # transactional messages: force the WAL to disk before acking
                self.journal.flush()
            for _tag, msg in msgs:
                ack = msg.get("_ack")
                if ack is not None:
                    ack.set()
            self.broker.ack_many(STATES_QUEUE, [tag for tag, _ in msgs])
