"""In-process message broker with RabbitMQ delivery semantics.

EnTK uses a RabbitMQ server so that (1) producers/consumers are topology
unaware, (2) in-flight messages survive component failure, and (3) push/pull
are fully asynchronous (paper §II-C). Inside a single JAX controller process
the same contract is provided by named in-memory queues with explicit
acknowledgement and redelivery:

* ``put(queue, msg)`` — asynchronous publish (never blocks on consumers).
* ``get(queue, timeout)`` — returns ``(delivery_tag, msg)`` and holds the
  message *unacknowledged*; a consumer that dies without ``ack`` leaves the
  message eligible for redelivery via :meth:`requeue_unacked`.
* ``ack(queue, tag)`` — marks the message consumed.
* ``kick(queue)`` — wakes every consumer blocked on the queue *without*
  delivering a message (their ``get`` returns ``None``/``[]``). This is the
  event-driven core's wakeup channel: consumer loops block with
  ``timeout=None`` instead of sleep-polling, and producers of *state* (not
  messages) — task completions freeing slots, pilot resizes, component
  shutdown — kick the relevant queue so the consumer re-evaluates.
* ``get(..., abort=event)`` — a set ``abort`` event makes a blocked (or
  about-to-block) consumer return immediately; combined with ``kick`` this
  closes the set-stop-then-wake race without any polling timeout.

The broker records counters used by the Fig.-6 prototype benchmark
(messages in/out, peak depth) and is intentionally dependency-free so that
the benchmark measures toolkit overhead, not library overhead.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .exceptions import ValueError_


class _Queue:
    __slots__ = ("name", "messages", "unacked", "cv", "put_count",
                 "get_count", "ack_count", "peak_depth", "kick_pending")

    def __init__(self, name: str) -> None:
        self.name = name
        self.messages: deque = deque()
        self.unacked: Dict[int, Any] = {}
        self.cv = threading.Condition()
        self.put_count = 0
        self.get_count = 0
        self.ack_count = 0
        self.peak_depth = 0
        self.kick_pending = False


class Broker:
    """A set of named queues with ack/redeliver semantics."""

    def __init__(self) -> None:
        self._queues: Dict[str, _Queue] = {}
        self._lock = threading.Lock()
        self._tags = itertools.count(1)
        self._closed = False

    # -- queue management ---------------------------------------------------#

    def declare(self, name: str) -> None:
        with self._lock:
            if name not in self._queues:
                self._queues[name] = _Queue(name)

    def delete(self, name: str) -> None:
        with self._lock:
            self._queues.pop(name, None)

    def queues(self) -> List[str]:
        with self._lock:
            return list(self._queues)

    def _q(self, name: str) -> _Queue:
        try:
            return self._queues[name]
        except KeyError:
            raise ValueError_(f"queue {name!r} not declared") from None

    # -- publish / consume ----------------------------------------------------#

    def put(self, name: str, msg: Any) -> None:
        q = self._q(name)
        with q.cv:
            q.messages.append(msg)
            q.put_count += 1
            depth = len(q.messages)
            if depth > q.peak_depth:
                q.peak_depth = depth
            # Wake a consumer only on the empty→nonempty transition: while
            # messages are already pending, any sleeping consumer was
            # notified when the first one arrived and whoever is awake will
            # drain the rest. This collapses one-notify-per-message storms
            # (and their GIL handoffs) into one notify per idle period.
            if depth == 1:
                q.cv.notify()

    def put_many(self, name: str, msgs: Iterable[Any]) -> None:
        q = self._q(name)
        with q.cv:
            before = len(q.messages)
            q.messages.extend(msgs)
            added = len(q.messages) - before
            q.put_count += added
            if len(q.messages) > q.peak_depth:
                q.peak_depth = len(q.messages)
            if before == 0 and added:
                q.cv.notify_all()

    def get(self, name: str, timeout: Optional[float] = None,
            abort: Optional[threading.Event] = None
            ) -> Optional[Tuple[int, Any]]:
        """Pop one message; returns (delivery_tag, msg), or None on timeout,
        broker close, queue kick, or a set ``abort`` event."""
        q = self._q(name)
        deadline = None if timeout is None else time.monotonic() + timeout
        with q.cv:
            while not q.messages:
                if self._closed:
                    return None
                if q.kick_pending:
                    # kicks are latched, not edge-triggered: one delivered
                    # while the consumer was busy processing is consumed by
                    # its NEXT get, so capacity-change wakeups are never
                    # lost between blocking calls
                    q.kick_pending = False
                    return None
                if abort is not None and abort.is_set():
                    return None
                if deadline is None:
                    q.cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    q.cv.wait(remaining)
            msg = q.messages.popleft()
            tag = next(self._tags)
            q.unacked[tag] = msg
            q.get_count += 1
            return tag, msg

    def get_many(self, name: str, max_n: int, timeout: Optional[float] = None,
                 abort: Optional[threading.Event] = None
                 ) -> List[Tuple[int, Any]]:
        """Batch pop of up to ``max_n`` messages (at least one, else [])."""
        first = self.get(name, timeout=timeout, abort=abort)
        if first is None:
            return []
        out = [first]
        q = self._q(name)
        with q.cv:
            while q.messages and len(out) < max_n:
                msg = q.messages.popleft()
                tag = next(self._tags)
                q.unacked[tag] = msg
                q.get_count += 1
                out.append((tag, msg))
        return out

    def kick(self, name: str) -> None:
        """Wake a consumer of ``name`` without a message: its current (or,
        if it is busy, its next) ``get`` returns None (``get_many`` → []).
        The kick is latched until consumed, so it is never lost to the
        window between two blocking calls."""
        q = self._q(name)
        with q.cv:
            q.kick_pending = True
            q.cv.notify_all()

    def ack(self, name: str, tag: int) -> None:
        q = self._q(name)
        with q.cv:
            q.unacked.pop(tag, None)
            q.ack_count += 1

    def ack_many(self, name: str, tags: Iterable[int]) -> None:
        """Acknowledge a batch under one lock acquisition (consumers that
        ack message-by-message measurably serialize their producers)."""
        q = self._q(name)
        with q.cv:
            for tag in tags:
                q.unacked.pop(tag, None)
                q.ack_count += 1

    def requeue_unacked(self, name: str) -> int:
        """Redeliver every unacknowledged message (consumer-failure recovery)."""
        q = self._q(name)
        with q.cv:
            n = len(q.unacked)
            # preserve rough ordering: unacked messages go to the front
            for tag in sorted(q.unacked, reverse=True):
                q.messages.appendleft(q.unacked.pop(tag))
            q.cv.notify_all()
            return n

    # -- introspection --------------------------------------------------------#

    def depth(self, name: str) -> int:
        q = self._q(name)
        with q.cv:
            return len(q.messages)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            qs = list(self._queues.values())
        return {
            q.name: {
                "put": q.put_count,
                "got": q.get_count,
                "acked": q.ack_count,
                "depth": len(q.messages),
                "unacked": len(q.unacked),
                "peak_depth": q.peak_depth,
            }
            for q in qs
        }

    def close(self) -> None:
        """Wake all blocked consumers; subsequent gets return None when empty."""
        self._closed = True
        with self._lock:
            qs = list(self._queues.values())
        for q in qs:
            with q.cv:
                q.cv.notify_all()
