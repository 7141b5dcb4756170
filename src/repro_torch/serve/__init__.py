"""Multi-tenant serving layer: a persistent ensemble service.

The classic AppManager lifecycle is one workflow per process: describe,
``run()``, tear down. This package keeps ONE AppManager (and its pilot,
fusion engine and journal machinery) resident and feeds it many concurrent
workflow submissions from many tenants:

* :class:`~repro_torch.serve.service.EnsembleService` — the daemon core:
  owns the long-lived AppManager over a
  :class:`~repro_torch.rts.torch_rts.TorchRTS`, admits workflows through a
  per-tenant quota gate, arbitrates device time with a weighted fair-share
  policy, and batches same-kernel members *across* tenants into shared
  carriers (continuous batching — the fusion key excludes the workflow
  namespace, so members from different tenants are key-compatible by
  construction).
* :class:`~repro_torch.serve.journal.TenantJournals` — per-tenant
  write-ahead journals and spill directories, so one tenant's resume never
  replays (and one tenant's cleanup never deletes) another's records.
* :class:`~repro_torch.serve.daemon.ServiceDaemon` /
  :class:`~repro_torch.serve.client.SocketClient` — a small JSON-lines
  socket front-end plus the matching client;
  :class:`~repro_torch.serve.client.InProcessClient` speaks the same
  protocol without a socket.
"""

from .admission import AdmissionController, AdmissionError, TenantQuota  # noqa: F401
from .client import InProcessClient, SocketClient  # noqa: F401
from .daemon import ServiceDaemon  # noqa: F401
from .fair_share import FairSharePolicy  # noqa: F401
from .journal import TenantJournals  # noqa: F401
from .service import EnsembleService, SubmissionHandle  # noqa: F401

__all__ = [
    "AdmissionController", "AdmissionError", "TenantQuota",
    "FairSharePolicy", "TenantJournals",
    "EnsembleService", "SubmissionHandle",
    "ServiceDaemon", "SocketClient", "InProcessClient",
]
