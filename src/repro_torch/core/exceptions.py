"""Exception hierarchy for the EnTK-JAX core.

Mirrors the error taxonomy of the paper's failure model (§II-B.4): errors are
classified by their source — user/API error, EnTK component failure, RTS
failure, or task failure — because each class triggers a different recovery
path (reject, restart component, restart RTS, resubmit task).
"""

from __future__ import annotations


class EnTKError(Exception):
    """Base class for all toolkit errors."""


class TypeError_(EnTKError):
    """A PST object or argument had the wrong type (API-level user error)."""


class ValueError_(EnTKError):
    """A PST object or argument had an invalid value (API-level user error)."""


class MissingError(EnTKError):
    """A required attribute was missing from a PST description."""


class StateTransitionError(EnTKError):
    """An illegal state transition was attempted.

    All transitions are validated against the transition tables in
    :mod:`repro.core.states`; violating them indicates a toolkit bug, never a
    user error, so this is raised eagerly rather than recovered from.
    """

    def __init__(self, obj: str, from_state: str, to_state: str) -> None:
        super().__init__(
            f"illegal state transition for {obj}: {from_state!r} -> {to_state!r}"
        )
        self.obj = obj
        self.from_state = from_state
        self.to_state = to_state


class ComponentFailure(EnTKError):
    """An EnTK component (thread) died; AppManager may restart it."""


class RTSFailure(EnTKError):
    """The runtime system failed or became unresponsive.

    Per the paper's failure model the RTS is a black box: on this error the
    AppManager tears the RTS down, purges leftovers, starts a fresh instance
    and resubmits the tasks that were in flight.
    """


class TaskFailure(EnTKError):
    """A task executable failed; subject to the task's retry budget."""


class ResourceError(EnTKError):
    """Resource acquisition failed (pilot could not be started/resized)."""


class JournalCorruption(EnTKError):
    """The write-ahead journal could not be replayed."""
