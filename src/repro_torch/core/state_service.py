"""StateService: every PST state transition in the toolkit goes through here.

Design (paper §II-B.3): components synchronize all transitions with the
AppManager by pushing messages through dedicated queues; the AppManager
acknowledges updates, which makes it the only stateful component and makes
updates transactional.

In-process realization: ``advance()`` (1) validates the transition against
the state tables, (2) applies it to the master object, (3) publishes a
transition message on the ``states`` queue for the Synchronizer to journal
and account, and (4) — when ``transact=True`` — blocks until the
Synchronizer acknowledges that the transition reached the write-ahead
journal. Final states default to transactional; high-frequency intermediate
states default to asynchronous journaling (ordering is still preserved by
the single-consumer Synchronizer). ``strict`` mode forces every transition
to be transactional, reproducing the paper's fully-synchronous behaviour
(and its management overhead — measured in the Fig. 7 benchmarks).

``durable=False`` (no write-ahead journal configured) downgrades the
*default* final-state transactionality to asynchronous publishing: with no
WAL behind the Synchronizer there is nothing for the ack to make durable,
and the round-trip would only couple the Dequeue hot path to the
Synchronizer's queue depth. Explicit ``strict`` mode still blocks.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Union

from .. import telemetry as tel
from . import states as st
from .broker import Broker
from .pst import Pipeline, Stage, Task

STATES_QUEUE = "states"

_FINAL = set(st.TASK_FINAL) | set(st.STAGE_FINAL) | set(st.PIPELINE_FINAL)

PSTObject = Union[Task, Stage, Pipeline]


def _kind(obj: PSTObject) -> str:
    if isinstance(obj, Task):
        return "task"
    if isinstance(obj, Stage):
        return "stage"
    return "pipeline"


class StateService:
    def __init__(self, broker: Broker, strict: bool = False,
                 ack_timeout: float = 10.0, durable: bool = True) -> None:
        self.broker = broker
        self.strict = strict
        self.ack_timeout = ack_timeout
        self.durable = durable
        broker.declare(STATES_QUEUE)
        self._lock = threading.Lock()

    def advance(self, obj: PSTObject, to_state: str,
                transact: Optional[bool] = None,
                sink: Optional[list] = None,
                **extra: Any) -> None:
        self.advance_seq(obj, (to_state,), transact=transact, sink=sink,
                         **extra)

    def flush(self, sink: list) -> None:
        """Publish messages deferred into ``sink`` in one queue operation."""
        if sink:
            self.broker.put_many(STATES_QUEUE, sink)
            sink.clear()

    def advance_seq(self, obj: PSTObject, to_states: Any,
                    transact: Optional[bool] = None,
                    sink: Optional[list] = None,
                    **extra: Any) -> None:
        """Apply a chain of transitions atomically and publish ONE message.

        Micro-transitions that always travel together (SCHEDULING→SCHEDULED,
        SUBMITTING→SUBMITTED, EXECUTED→DONE, …) each used to cost a lock
        round and a queue notify; on the O(10⁴)-task hot path those
        synchronization points dominate management overhead, so call sites
        coalesce them. Every hop is still validated in order and the
        journal records the full ``via`` chain.

        ``sink``: defer the publish into the caller's buffer instead of
        putting immediately. The caller must :meth:`flush` the sink before
        any hand-off that lets another component advance the same object
        (pending-queue puts, RTS submission, releasing the pipeline lock),
        so the states queue still sees every object's transitions in order
        while a batch of events costs one queue operation, not one per
        transition. Transactional messages flush the sink first and are
        never deferred.
        """
        if not to_states:
            return
        kind = _kind(obj)
        # No service-global lock here: a global lock would couple every
        # component's hot path to every other's (measured: it and the old
        # WFProcessor-global lock dominated management overhead at O(10⁴)
        # pipelines). Per-object ordering is owned by the pipeline lock
        # (WFProcessor scheduling/closure and AppManager.cancel both take
        # it); the ExecManager's submission chain runs outside that lock
        # and therefore guards its advance with a try/except, dropping
        # tasks that were finalized (canceled) concurrently.
        frm = obj.state
        for s in to_states:
            obj.advance(s)  # validates; raises StateTransitionError
        to_state = to_states[-1]
        if tel.enabled():
            # gated: this is THE hottest chokepoint in the toolkit — one
            # call per PST transition batch at O(10⁴) tasks. Off by
            # default; when tracing is on, the counter makes the state
            # machine's traffic visible per kind and destination state.
            tel.counter("state_transitions_total", kind=kind,
                        to=to_state).inc()
        if transact is None:
            transact = self.strict or (self.durable and to_state in _FINAL)
        if (not transact and not self.durable and not self.strict
                and to_state not in _FINAL):
            # Without a WAL nothing consumes intermediate states — the live
            # state table is only ever read for final states and the objects
            # themselves carry their current state. Skipping the publish
            # keeps the O(10⁴)-task hot path off the states queue entirely
            # between an entity's scheduling and its completion.
            return
        msg: Dict[str, Any] = {
            "type": "transition", "kind": kind, "uid": obj.uid,
            "name": obj.name, "frm": frm, "to": to_state,
        }
        ns = getattr(obj, "ns", None)
        if ns is not None:
            msg["ns"] = ns
        if len(to_states) > 1:
            msg["via"] = list(to_states[:-1])
        if extra:
            msg["extra"] = extra
        if not transact and sink is not None:
            sink.append(msg)
            return
        if sink is not None:
            self.flush(sink)  # earlier deferred states must land first
        ack: Optional[threading.Event] = None
        if transact:
            ack = threading.Event()
            msg["_ack"] = ack
        self.broker.put(STATES_QUEUE, msg)
        if ack is not None:
            ack.wait(self.ack_timeout)
