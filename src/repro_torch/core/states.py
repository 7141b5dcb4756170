"""State machines for Tasks, Stages and Pipelines.

The paper (§II-B.3) specifies that tasks, stages and pipelines undergo multiple
state transitions in both WFProcessor and ExecManager, synchronized with the
AppManager through dedicated queues. This module defines those states and the
legal transition tables; every transition anywhere in the toolkit goes through
:func:`validate_transition`, and the AppManager journals each one as a
transaction so that a restarted toolkit can resume from the last transition.

State values are ordered integers so "progress" comparisons are cheap; FINAL
states compare equal in precedence.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .exceptions import StateTransitionError

# --------------------------------------------------------------------------- #
# Task states
# --------------------------------------------------------------------------- #

INITIAL = "DESCRIBED"

# Workflow-management side (WFProcessor)
SCHEDULING = "SCHEDULING"          # tagged for execution, local copy made
SCHEDULED = "SCHEDULED"            # pushed to the Pending queue

# Workload-management side (ExecManager)
SUBMITTING = "SUBMITTING"          # pulled from Pending, translating to RTS task
SUBMITTED = "SUBMITTED"            # handed to the RTS (black box beyond this)
EXECUTED = "EXECUTED"              # RTS callback reported completion (any code)

# Final states (Dequeue tags on the return code)
DONE = "DONE"
FAILED = "FAILED"
CANCELED = "CANCELED"

TASK_FINAL = (DONE, FAILED, CANCELED)

TASK_STATES: Tuple[str, ...] = (
    INITIAL,
    SCHEDULING,
    SCHEDULED,
    SUBMITTING,
    SUBMITTED,
    EXECUTED,
    DONE,
    FAILED,
    CANCELED,
)

# numeric precedence for ordering / progress bars
_TASK_ORDER: Dict[str, int] = {
    INITIAL: 0,
    SCHEDULING: 1,
    SCHEDULED: 2,
    SUBMITTING: 3,
    SUBMITTED: 4,
    EXECUTED: 5,
    DONE: 6,
    FAILED: 6,
    CANCELED: 6,
}

# Legal transitions.  FAILED -> SCHEDULING is the resubmission path: a failed
# task re-enters the workflow layer without touching DESCRIBED, so completed
# work elsewhere is never repeated (paper requirement: multiple attempts
# without restarting completed tasks).
_TASK_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    INITIAL: (SCHEDULING, CANCELED),
    SCHEDULING: (SCHEDULED, CANCELED),
    SCHEDULED: (SUBMITTING, CANCELED),
    SUBMITTING: (SUBMITTED, FAILED, CANCELED),
    SUBMITTED: (EXECUTED, FAILED, CANCELED),
    EXECUTED: (DONE, FAILED, CANCELED),
    DONE: (),
    FAILED: (SCHEDULING,),  # resubmission
    CANCELED: (),
}

# --------------------------------------------------------------------------- #
# Stage states
# --------------------------------------------------------------------------- #

STAGE_INITIAL = "DESCRIBED"
STAGE_SCHEDULING = "SCHEDULING"
STAGE_SCHEDULED = "SCHEDULED"
STAGE_DONE = "DONE"
STAGE_FAILED = "FAILED"
STAGE_CANCELED = "CANCELED"

STAGE_FINAL = (STAGE_DONE, STAGE_FAILED, STAGE_CANCELED)

STAGE_STATES: Tuple[str, ...] = (
    STAGE_INITIAL,
    STAGE_SCHEDULING,
    STAGE_SCHEDULED,
    STAGE_DONE,
    STAGE_FAILED,
    STAGE_CANCELED,
)

_STAGE_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    STAGE_INITIAL: (STAGE_SCHEDULING, STAGE_CANCELED),
    STAGE_SCHEDULING: (STAGE_SCHEDULED, STAGE_CANCELED),
    STAGE_SCHEDULED: (STAGE_DONE, STAGE_FAILED, STAGE_CANCELED),
    STAGE_DONE: (),
    STAGE_FAILED: (STAGE_SCHEDULING,),  # pipeline-level retry
    STAGE_CANCELED: (),
}

# --------------------------------------------------------------------------- #
# Pipeline states
# --------------------------------------------------------------------------- #

PIPELINE_INITIAL = "DESCRIBED"
PIPELINE_SCHEDULING = "SCHEDULING"
PIPELINE_DONE = "DONE"
PIPELINE_FAILED = "FAILED"
PIPELINE_CANCELED = "CANCELED"

PIPELINE_FINAL = (PIPELINE_DONE, PIPELINE_FAILED, PIPELINE_CANCELED)

PIPELINE_STATES: Tuple[str, ...] = (
    PIPELINE_INITIAL,
    PIPELINE_SCHEDULING,
    PIPELINE_DONE,
    PIPELINE_FAILED,
    PIPELINE_CANCELED,
)

_PIPELINE_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    PIPELINE_INITIAL: (PIPELINE_SCHEDULING, PIPELINE_CANCELED),
    PIPELINE_SCHEDULING: (PIPELINE_DONE, PIPELINE_FAILED, PIPELINE_CANCELED),
    PIPELINE_DONE: (),
    PIPELINE_FAILED: (PIPELINE_SCHEDULING,),
    PIPELINE_CANCELED: (),
}

_TABLES = {
    "task": _TASK_TRANSITIONS,
    "stage": _STAGE_TRANSITIONS,
    "pipeline": _PIPELINE_TRANSITIONS,
}


def validate_transition(kind: str, uid: str, from_state: str, to_state: str) -> None:
    """Raise :class:`StateTransitionError` unless ``from_state -> to_state`` is legal.

    ``kind`` is one of ``task|stage|pipeline``.
    """
    table = _TABLES[kind]
    if from_state not in table:
        raise StateTransitionError(f"{kind} {uid}", from_state, to_state)
    if to_state not in table[from_state]:
        raise StateTransitionError(f"{kind} {uid}", from_state, to_state)


def legal_next(kind: str, from_state: str) -> Tuple[str, ...]:
    """Return the set of legal successor states (used by property tests)."""
    return _TABLES[kind].get(from_state, ())


def task_order(state: str) -> int:
    return _TASK_ORDER[state]
