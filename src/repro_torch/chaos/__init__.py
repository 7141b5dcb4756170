"""Chaos plane: deterministic, seedable fault injection at every layer.

The paper's requirement (iv) is fault tolerance; at full-system scale node
failure is the steady state, so recovery code that only runs when real
hardware dies is untested code. This package turns every failure seam the
stack already has into a *scheduled* fault source:

========== ===================================================== ==========
site       seam                                                   class
========== ===================================================== ==========
kernel     ``fault_injector`` (LocalRTS / fusion engine, per      task
           member per attempt)
carrier    ``fusion.engine.CARRIER_FAULT`` hook — the composed    infra-ish
           dispatch raises and the carrier walks the degrade      (tier)
           ladder; no member is lost
member     seeded victim pick for ``FederatedRTS`` member kill    infra
journal    torn-tail truncation of the write-ahead journal file   infra
spill      bit-flip in a content-addressed spill sidecar          infra
socket     seeded client-side connection drop mid-submit          infra
straggler  ``straggler_injector`` stall (watchdog speculation)    latency
========== ===================================================== ==========

Determinism: every decision is a pure function of ``(seed, site, key)`` via
:func:`repro.core.policies.keyed_uniform` — arrival order and thread
interleaving cannot change which members fault, so one seed reproduces one
failure story end to end. Fired events are recorded (``story()``) and
counted in ``chaos_injected_total{site}``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from .. import telemetry as tel
from ..core.policies import keyed_uniform

#: telemetry family: faults actually injected, by site
CHAOS_INJECTED = "chaos_injected_total"

#: the canonical sites (a schedule may define any subset)
SITES = ("kernel", "carrier", "member", "journal", "spill", "socket",
         "straggler")


@dataclass
class FaultSpec:
    """One site's injection spec: fire with probability ``rate`` per keyed
    decision; ``params`` carries site knobs (e.g. straggler ``stall_s``)."""

    site: str
    rate: float
    params: Dict[str, Any] = field(default_factory=dict)


class FaultSchedule:
    """A seeded fault schedule over the chaos sites.

    ``specs`` is either a mapping ``{site: rate}`` or an iterable of
    :class:`FaultSpec`. The schedule is stateless apart from its fired-event
    log: :meth:`fires` answers the same for the same ``(site, key)`` no
    matter when or from which thread it is asked.
    """

    def __init__(self, seed: int,
                 specs: "Dict[str, float] | Iterable[FaultSpec]") -> None:
        self.seed = seed
        if isinstance(specs, dict):
            specs = [FaultSpec(site, rate) for site, rate in specs.items()]
        self.specs: Dict[str, FaultSpec] = {s.site: s for s in specs}
        self._lock = threading.Lock()
        self._fired: List[tuple] = []

    def rate(self, site: str) -> float:
        spec = self.specs.get(site)
        return spec.rate if spec is not None else 0.0

    def param(self, site: str, name: str, default: Any = None) -> Any:
        spec = self.specs.get(site)
        return spec.params.get(name, default) if spec is not None else default

    def fires(self, site: str, key: Any) -> bool:
        """Deterministic injection decision for one (site, key) event."""
        rate = self.rate(site)
        if rate <= 0.0:
            return False
        hit = keyed_uniform(self.seed, "chaos", site, key) < rate
        if hit:
            with self._lock:
                self._fired.append((site, str(key)))
            tel.counter(CHAOS_INJECTED, site=site).inc()
        return hit

    def story(self) -> List[tuple]:
        """Every fault injected so far, sorted (thread arrival order is not
        part of the deterministic contract; the *set* of events is)."""
        with self._lock:
            return sorted(self._fired)

    # -- site adapters ------------------------------------------------------- #

    @staticmethod
    def _attempt_key(task: Any) -> str:
        # keyed per ATTEMPT: a fault keyed on the bare name would refire on
        # every retry and no budget could ever clear it
        return f"{getattr(task, 'name', task)}:{getattr(task, 'retries', 0)}"

    def kernel_fault_injector(self) -> Callable[[Any], bool]:
        """``fault_injector`` for LocalRTS / JaxRTS / the fusion engine:
        fails the task (exit 1, "injected fault") on scheduled attempts."""
        return lambda task: self.fires("kernel", self._attempt_key(task))

    def straggler_injector(self, stall_s: Optional[float] = None
                           ) -> Callable[[Any], float]:
        """``straggler_injector`` for LocalRTS: stall scheduled attempts by
        ``stall_s`` seconds (default from the site spec, then 0.5s)."""
        stall = (stall_s if stall_s is not None
                 else float(self.param("straggler", "stall_s", 0.5)))
        return lambda task: (
            stall if self.fires("straggler", self._attempt_key(task)) else 0.0)

    def carrier_fault_injector(self) -> Callable[[Any], bool]:
        """``fusion.engine.CARRIER_FAULT`` hook: a scheduled carrier's
        composed dispatch raises, exercising the degrade ladder (members
        complete via per-stage fused / scalar fallback — never lost)."""
        return lambda exe: self.fires(
            "carrier", exe.links[0][0].name if exe.links and exe.links[0]
            else "?")

    def pick_victims(self, site: str, names: Sequence[str]) -> List[str]:
        """The seeded subset of ``names`` this schedule kills at ``site``
        (federation member kill: apply ``simulate_dead`` to the result)."""
        return [n for n in names if self.fires(site, n)]

    def tear_journal(self, path: str) -> int:
        """Truncate the journal mid-record — the torn tail a host crash
        leaves behind. Cuts a seeded number of bytes into the final line;
        returns bytes dropped (0 when the file is empty/missing)."""
        if not path or not os.path.exists(path):
            return 0
        with open(path, "rb") as fh:
            data = fh.read()
        if not data:
            return 0
        body = data[:-1] if data.endswith(b"\n") else data
        start = body.rfind(b"\n") + 1
        line_len = len(data) - start
        if line_len <= 1:
            return 0
        drop = 1 + int(keyed_uniform(self.seed, "chaos", "journal", path)
                       * (line_len - 1))
        with open(path, "rb+") as fh:
            fh.truncate(len(data) - drop)
        with self._lock:
            self._fired.append(("journal", path))
        tel.counter(CHAOS_INJECTED, site="journal").inc()
        return drop

    def corrupt_spill(self, spill_dir: str) -> Optional[str]:
        """Flip one byte in a seeded spill sidecar (content-addressed .npy):
        the loader's hash check must reject it and re-run the producer.
        Returns the corrupted path, or None when no sidecar exists."""
        if not spill_dir or not os.path.isdir(spill_dir):
            return None
        files = sorted(f for f in os.listdir(spill_dir) if f.endswith(".npy"))
        if not files:
            return None
        pick = files[int(keyed_uniform(self.seed, "chaos", "spill", spill_dir)
                         * len(files)) % len(files)]
        path = os.path.join(spill_dir, pick)
        size = os.path.getsize(path)
        if size == 0:
            return None
        offset = int(keyed_uniform(self.seed, "chaos", "spill-off", pick)
                     * size) % size
        with open(path, "rb+") as fh:
            fh.seek(offset)
            byte = fh.read(1)
            fh.seek(offset)
            fh.write(bytes([byte[0] ^ 0xFF]))
        with self._lock:
            self._fired.append(("spill", pick))
        tel.counter(CHAOS_INJECTED, site="spill").inc()
        return path

    def drops_socket(self, key: Any) -> bool:
        """Client-harness decision: drop the connection after sending this
        submit, before reading the response (the daemon must refund the
        admitted capacity)."""
        return self.fires("socket", key)


__all__ = ["CHAOS_INJECTED", "SITES", "FaultSpec", "FaultSchedule"]
