"""Admission control: per-tenant quotas and queue-depth backpressure.

Every submission passes through :class:`AdmissionController` before it
touches the AppManager. Rejections are *named* — an
:class:`AdmissionError` carries a stable ``code`` the client can key retry
policy on — and they happen before any pipeline is compiled into the
running service, so a rejected workflow leaves no state behind.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .. import telemetry as tel
from ..core.exceptions import EnTKError


class AdmissionError(EnTKError):
    """A submission the service declined to admit.

    ``code`` is one of:

    * ``"member-quota"``     — the tenant's in-flight member quota is full;
    * ``"workflow-backlog"`` — the tenant already has its maximum number of
      active workflows;
    * ``"service-backlog"``  — the service-wide member backlog is at its
      depth limit (backpressure: retry after some work drains);
    * ``"service-stopping"`` — the service is shutting down.
    """

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code


@dataclass
class TenantQuota:
    """Per-tenant admission limits; ``0`` means unlimited.

    ``max_in_flight_members`` caps the tenant's members admitted but not
    yet finished; ``max_active`` caps its concurrently active workflows;
    ``weight`` is the tenant's fair-share weight (consumed by
    :class:`~repro.serve.fair_share.FairSharePolicy`).
    """

    max_in_flight_members: int = 0
    max_active: int = 0
    weight: float = 1.0


class AdmissionController:
    """Thread-safe admission gate over per-tenant and service-wide quotas.

    ``admit`` charges a submission's member count against the tenant (and
    the global backlog); ``release`` refunds it when the submission's last
    pipeline finalizes — the service owns that call, so a canceled or
    failed workflow refunds exactly once.
    """

    def __init__(self, default_quota: Optional[TenantQuota] = None,
                 max_backlog_members: int = 0) -> None:
        self.default_quota = default_quota or TenantQuota()
        self.max_backlog_members = max_backlog_members
        self._quotas: Dict[str, TenantQuota] = {}
        self._members: Dict[str, int] = {}   # tenant -> in-flight members
        self._active: Dict[str, int] = {}    # tenant -> active workflows
        self._total_members = 0
        self._stopping = False
        self._lock = threading.Lock()

    def register(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota

    def quota(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._quotas.get(tenant, self.default_quota)

    def stop_admitting(self) -> None:
        with self._lock:
            self._stopping = True

    @staticmethod
    def _reject(tenant: str, code: str, message: str) -> None:
        tel.counter("serve_admission_total", tenant=tenant, outcome="rejected",
                    code=code).inc()
        raise AdmissionError(code, message)

    def admit(self, tenant: str, n_members: int) -> None:
        """Charge ``n_members`` for one workflow, or raise AdmissionError."""
        with self._lock:
            if self._stopping:
                self._reject(
                    tenant, "service-stopping",
                    "service is shutting down; not admitting new work")
            q = self._quotas.get(tenant, self.default_quota)
            held = self._members.get(tenant, 0)
            if q.max_in_flight_members and \
                    held + n_members > q.max_in_flight_members:
                self._reject(
                    tenant, "member-quota",
                    f"tenant {tenant!r}: {held} members in flight + "
                    f"{n_members} requested exceeds quota "
                    f"{q.max_in_flight_members}")
            if q.max_active and \
                    self._active.get(tenant, 0) >= q.max_active:
                self._reject(
                    tenant, "workflow-backlog",
                    f"tenant {tenant!r}: {self._active[tenant]} active "
                    f"workflows at limit {q.max_active}")
            if self.max_backlog_members and \
                    self._total_members + n_members > \
                    self.max_backlog_members:
                self._reject(
                    tenant, "service-backlog",
                    f"service backlog {self._total_members} + {n_members} "
                    f"members exceeds depth limit "
                    f"{self.max_backlog_members}")
            self._members[tenant] = held + n_members
            self._active[tenant] = self._active.get(tenant, 0) + 1
            self._total_members += n_members
        tel.counter("serve_admission_total", tenant=tenant,
                    outcome="accepted").inc()
        tel.counter("serve_admitted_members_total",
                    tenant=tenant).inc(n_members)

    def release(self, tenant: str, n_members: int) -> None:
        with self._lock:
            self._members[tenant] = max(
                0, self._members.get(tenant, 0) - n_members)
            self._active[tenant] = max(0, self._active.get(tenant, 0) - 1)
            self._total_members = max(0, self._total_members - n_members)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            tenants = set(self._members) | set(self._active)
            return {t: {"in_flight_members": self._members.get(t, 0),
                        "active_workflows": self._active.get(t, 0)}
                    for t in tenants}
