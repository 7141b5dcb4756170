"""Errors raised by the declarative API at description/compile time."""

from __future__ import annotations

from ..core.exceptions import EnTKError


class CompileError(EnTKError):
    """A workflow description cannot be compiled onto PST.

    Raised at :func:`repro.api.compile` time (cycles, missing/foreign
    inputs, duplicate names, unsupported shapes) with a message that names
    the offending specs — never deep inside the run.
    """
