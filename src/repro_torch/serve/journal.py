"""Per-tenant write-ahead journals for the serving layer.

One shared journal file would make every tenant's resume replay every other
tenant's transitions — and worse, the content-addressed spill directory
(``<journal>.spill/``, sha256-named payload files) would be shared: two
tenants producing byte-identical results collide on one spill file, and the
first tenant to clean up deletes the payload out from under the other's
resume. :class:`TenantJournals` fixes both by construction: each tenant gets
its own journal file (``<root>/<tenant>/journal.jsonl``) and its own spill
directory next to it (``<root>/<tenant>/journal.jsonl.spill/``), and resume
(:meth:`replay_tenant`) reads only the requesting tenant's file.

The router is Journal-shaped — the Synchronizer and AppManager drive it
through the same ``transition`` / ``session`` / ``flush`` / ``close``
surface — and routes each transition on the workflow namespace the
StateService stamped into it (``extra["ns"]``): namespaces registered to a
tenant land in that tenant's file, everything else (service lifecycle,
un-namespaced transitions) in ``<root>/service.jsonl``.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from typing import Any, Dict, List, Optional

from ..core.journal import Journal

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def _slug(tenant: str) -> str:
    """Filesystem-safe tenant directory name; collision-proofed with a
    short digest whenever sanitising changed anything."""
    safe = _SAFE.sub("_", tenant) or "tenant"
    if safe != tenant:
        safe += "-" + hashlib.sha256(tenant.encode()).hexdigest()[:8]
    return safe


class TenantJournals:
    """Journal router: one write-ahead file (and spill dir) per tenant."""

    def __init__(self, root: str, flush_every: int = 32) -> None:
        self.root = os.path.abspath(root)
        self.flush_every = flush_every
        os.makedirs(self.root, exist_ok=True)
        self._default = Journal(os.path.join(self.root, "service.jsonl"),
                                flush_every=flush_every)
        self._tenants: Dict[str, Journal] = {}
        self._ns_tenant: Dict[str, str] = {}
        self._lock = threading.Lock()

    # -- registration ---------------------------------------------------------#

    def register(self, ns: str, tenant: str) -> Journal:
        """Bind a workflow namespace to a tenant; opens the tenant's
        journal on first use."""
        with self._lock:
            self._ns_tenant[ns] = tenant
            journal = self._tenants.get(tenant)
            if journal is None:
                journal = Journal(self.tenant_journal_path(tenant),
                                  flush_every=self.flush_every)
                self._tenants[tenant] = journal
            return journal

    def tenant_journal_path(self, tenant: str) -> str:
        return os.path.join(self.root, _slug(tenant), "journal.jsonl")

    def tenant_spill_dir(self, tenant: str) -> str:
        """The tenant's private spill directory. Per-tenant by design:
        spill files are content-addressed (sha256 of the payload), so a
        shared directory would cross-link identical payloads from
        different tenants — and one tenant's cleanup would delete the
        other's resume data."""
        return self.tenant_journal_path(tenant) + ".spill"

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    # -- Journal-shaped surface (driven by Synchronizer / AppManager) ---------#

    def _journal_for_ns(self, ns: Optional[str]) -> Journal:
        if ns is None:
            return self._default
        with self._lock:
            tenant = self._ns_tenant.get(ns)
            if tenant is None:
                return self._default
            return self._tenants.get(tenant, self._default)

    def transition(self, kind: str, uid: str, name: str, frm: str, to: str,
                   **extra: Any) -> None:
        self._journal_for_ns(extra.get("ns")).transition(
            kind=kind, uid=uid, name=name, frm=frm, to=to, **extra)

    def append(self, record: Dict[str, Any]) -> None:
        self._journal_for_ns(record.get("ns")).append(record)

    def session(self, event: str, **extra: Any) -> None:
        self._default.session(event, **extra)

    def flush(self) -> None:
        with self._lock:
            journals = [self._default] + list(self._tenants.values())
        for j in journals:
            j.flush()

    def close(self) -> None:
        with self._lock:
            journals = [self._default] + list(self._tenants.values())
        for j in journals:
            j.close()

    @property
    def enabled(self) -> bool:
        return self._default.enabled

    @property
    def records_written(self) -> int:
        with self._lock:
            journals = [self._default] + list(self._tenants.values())
        return sum(j.records_written for j in journals)

    # -- resume ---------------------------------------------------------------#

    def replay_tenant(self, tenant: str) -> Dict[str, Any]:
        """Replay ONE tenant's journal — other tenants' links never enter
        the requesting tenant's resume."""
        return Journal.replay(self.tenant_journal_path(tenant))
