"""Weighted fair share across tenants.

The policy object is deliberately tiny: it answers ``weight(tenant)`` and
nothing else. The mechanism lives in the ExecManager's deficit-round-robin
lanes (``ExecManager.set_fair_share``) — each tenant's lane earns
``fair_quantum * weight`` member-slots of deficit per scheduler visit, so
over time device occupancy converges to the weight ratio while the packer's
largest-fit / chain-custody / starvation-guard logic keeps operating
unchanged *within* each lane's turn.
"""

from __future__ import annotations

import threading
from typing import Dict


class FairSharePolicy:
    """Tenant -> scheduling weight (relative; absolute scale is irrelevant).

    Unknown tenants get ``default_weight`` — a new tenant starts with a
    fair slice the moment its first submission lands, no registration
    required. Weights can be retuned while the service runs; the next
    scheduler sweep picks them up.
    """

    def __init__(self, default_weight: float = 1.0) -> None:
        self.default_weight = max(1e-6, float(default_weight))
        self._weights: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._weights[tenant] = max(1e-6, float(weight))

    def weight(self, tenant: str) -> float:
        with self._lock:
            return self._weights.get(tenant, self.default_weight)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._weights)
