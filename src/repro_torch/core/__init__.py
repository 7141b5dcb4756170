"""EnTK core: the paper's contribution as a composable Python/JAX library.

Public API (mirrors the paper's user-facing constructs):

* :class:`Task`, :class:`Stage`, :class:`Pipeline` — the PST model (§II-B.1)
* :class:`AppManager` — the execution entry point (§II-B.2)
* :func:`register_executable` — name a callable so workflows are resumable
* :class:`ResourceDescription` — pilot sizing

Example::

    from repro.core import AppManager, Pipeline, Stage, Task
    from repro.rts.base import ResourceDescription

    p = Pipeline("demo")
    s = Stage("s1")
    s.add_tasks([Task(executable="sleep://0.01") for _ in range(8)])
    p.add_stages(s)

    amgr = AppManager(resources=ResourceDescription(slots=4))
    amgr.workflow = [p]
    overheads = amgr.run()
"""

from . import states  # noqa: F401
from .appmanager import AppManager  # noqa: F401
from .broker import Broker  # noqa: F401
from .exceptions import (EnTKError, RTSFailure, StateTransitionError,  # noqa: F401
                         TaskFailure)
from .journal import Journal  # noqa: F401
from .profiler import Profiler  # noqa: F401
from .pst import (Pipeline, Stage, Task, WorkflowIndex,  # noqa: F401
                  register_executable)
from .results import STORE as RESULT_STORE, ResultStore  # noqa: F401
