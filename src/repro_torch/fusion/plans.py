"""Fusion planning: the fuse-vs-scalar cost model and micro-batch sizing.

Pure functions (no JAX, no RTS state) so the policy is unit-testable and
the JaxRTS stays a thin mechanism layer.

Model
-----
A fused dispatch replaces N per-task Python threads + N device dispatches
with one dispatch whose cost is roughly ``fixed + N · per_member``. Below
``min_batch`` members the fixed cost (trace/stack/pad plus the lost
per-member concurrency) outweighs the saved dispatches, so tiny groups run
scalar — that is the fallback the cost model owes the caller.

Micro-batching
--------------
A group larger than one device's worth of work is carved into
``lanes = free_slots // member_slots`` micro-batches so every free device
(or logical slot) gets one concurrent dispatch — the *adaptive* part: the
split follows the RTS's free capacity at submission time, not a constant.
``max_batch`` bounds any single dispatch (padding memory and compile-shape
growth are linear in the batch), re-chunking oversized lanes.

Mesh sharding
-------------
When the free capacity spans several devices AND the group is wide enough
(``shard_min_members``), micro-batch lanes stop paying: each lane is its own
lease + dispatch + compile-shape bucket. :func:`plan_mesh` instead plans a
1-D **mesh shape** — every free device joins one all-or-nothing lease and a
single ``shard_map`` dispatch splits the member axis across the mesh, so the
whole group executes in ``ceil(n / (devices × max_batch))`` dispatches.
``max_batch`` here bounds the *per-shard* batch, keeping per-device memory
identical to the micro-batch path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

#: Below this many congruent members, scalar execution wins.
DEFAULT_MIN_BATCH = 4

#: Largest single fused dispatch (bounds padding memory / compiled shapes).
DEFAULT_MAX_BATCH = 4096

#: Below this many linked stages, chain fusion degrades to per-stage fusion
#: (a 1-link "chain" is just a fused stage; composing buys nothing).
DEFAULT_MIN_CHAIN = 2

#: Below this many members, sharding across the mesh is not worth the
#: collective placement cost — per-device micro-batch lanes win.
DEFAULT_SHARD_MIN_MEMBERS = 64


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How one fusible group executes: fused chunk sizes + scalar count.

    ``batches`` are the fused micro-batch sizes, in member order; the first
    ``sum(batches)`` members fuse, the remaining ``scalar`` members run as
    ordinary tasks (only ever non-zero when the group is below threshold,
    in which case ``batches`` is empty — a plan never mixes arbitrarily).
    """

    batches: List[int]
    scalar: int

    @property
    def fused_members(self) -> int:
        return sum(self.batches)

    def record(self) -> Dict[str, Any]:
        """JSON-able plan summary for the carrier's journal record."""
        return {"kind": "fused", "lanes": len(self.batches),
                "scalar": self.scalar}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How one wide group executes as SPMD sharded dispatches.

    ``n_shards`` devices form a 1-D mesh; each entry of ``batches`` is the
    TOTAL member count of one sharded dispatch (the engine splits it into
    ``n_shards`` equal shards, padding the tail shard). Every dispatch takes
    one all-or-nothing lease of ``n_shards × member_slots`` slots.
    """

    n_shards: int
    batches: List[int]

    def record(self) -> Dict[str, Any]:
        """JSON-able plan summary for the carrier's journal record."""
        per_shard = max(math.ceil(b / self.n_shards) for b in self.batches)
        return {"kind": "shard", "mesh": [self.n_shards, per_shard],
                "dispatches": len(self.batches)}


@dataclasses.dataclass(frozen=True)
class DagPlan:
    """How one fused DAG executes: always ONE carrier spanning every node.

    A DAG is never micro-batched — its reduction needs the whole member
    set in one place — so the only decisions are whether the carrier may
    *compose* (one device program across the nodes; refused when the
    widest node exceeds ``max_batch`` or the RTS's dag knob is off, in
    which case the carrier runs its nodes sequentially per-stage inside
    the same lease) and whether it shards across the mesh.
    """

    n_nodes: int
    width: int
    composed: bool
    n_shards: int = 0

    def record(self) -> Dict[str, Any]:
        """JSON-able plan summary for the carrier's journal record."""
        rec: Dict[str, Any] = {"kind": "dag", "nodes": self.n_nodes,
                               "width": self.width,
                               "composed": self.composed}
        if self.n_shards:
            rec["mesh"] = self.n_shards
        return rec


def plan_dag(n_nodes: int, width: int, *, dag: bool = True,
             max_batch: int = DEFAULT_MAX_BATCH,
             n_shards: int = 0) -> DagPlan:
    """Plan one fused DAG of ``n_nodes`` nodes whose widest ensemble node
    has ``width`` members. ``dag=False`` (the RTS knob) or an over-wide
    node refuses composition; the carrier then executes its nodes
    sequentially, preserving ordering and reduction semantics."""
    composed = bool(dag) and 0 < width <= max(1, max_batch)
    return DagPlan(n_nodes=n_nodes, width=width, composed=composed,
                   n_shards=n_shards if composed else 0)


def plan_mesh(n_members: int, free_slots: Optional[int], member_slots: int,
              *, max_batch: int = DEFAULT_MAX_BATCH,
              shard_min_members: int = DEFAULT_SHARD_MIN_MEMBERS,
              max_devices: Optional[int] = None) -> Optional[MeshPlan]:
    """Plan a mesh shape for one wide group, or None when lanes should win.

    ``max_devices`` caps the mesh at the RTS's *distinct physical* device
    count — logical slot oversubscription widens lanes, not meshes. Returns
    None (caller falls back to :func:`plan_group` / :func:`plan_chain`)
    unless at least two devices are free and the group clears
    ``shard_min_members``.
    """
    if free_slots is None or member_slots <= 0:
        return None
    devices = free_slots // member_slots
    if max_devices is not None:
        devices = min(devices, max_devices)
    if devices < 2 or n_members < max(shard_min_members, devices):
        return None
    dispatches = math.ceil(n_members / (devices * max(1, max_batch)))
    base, rem = divmod(n_members, dispatches)
    batches = [base + (1 if i < rem else 0) for i in range(dispatches)]
    return MeshPlan(n_shards=devices, batches=batches)


def plan_group(n_members: int, free_slots: Optional[int], member_slots: int,
               *, min_batch: Optional[int] = None,
               max_batch: int = DEFAULT_MAX_BATCH) -> GroupPlan:
    """Plan one fusible group of ``n_members`` congruent tasks.

    ``free_slots`` is the RTS's leasable capacity right now (None = unknown:
    plan a single lane). ``member_slots`` is each member's device width —
    one micro-batch leases exactly that many devices, all-or-nothing.
    """
    threshold = DEFAULT_MIN_BATCH if min_batch is None else max(1, min_batch)
    if n_members < threshold:
        return GroupPlan(batches=[], scalar=n_members)
    lanes = 1
    if free_slots is not None and member_slots > 0:
        lanes = max(1, free_slots // member_slots)
    # never split so deep that a lane drops below the fuse threshold —
    # half-empty lanes would reintroduce the per-dispatch overhead the
    # fusion exists to amortize
    lanes = min(lanes, max(1, n_members // threshold))
    # memory bound: a lane may not exceed max_batch members per dispatch
    lanes = max(lanes, math.ceil(n_members / max(1, max_batch)))
    base, rem = divmod(n_members, lanes)
    batches = [base + (1 if i < rem else 0) for i in range(lanes)]
    return GroupPlan(batches=[b for b in batches if b], scalar=0)


def plan_chain(n_members: int, free_slots: Optional[int], member_slots: int,
               *, max_batch: int = DEFAULT_MAX_BATCH) -> List[int]:
    """Micro-batch sizes for one chain cohort (members sharing an entry link).

    Unlike :func:`plan_group` there is NO scalar fallback: chain members
    must execute inside a carrier, because the carrier is what serializes
    link k before link k+1 (a scalar remainder would race its own
    downstream links through the store). A tiny cohort simply becomes a
    tiny batched dispatch — ``vmap`` over 1 member is the scalar dispatch
    with an extra axis, so the cost model loses nothing by always batching.
    """
    if n_members <= 0:
        return []
    lanes = 1
    if free_slots is not None and member_slots > 0:
        lanes = max(1, free_slots // member_slots)
    lanes = min(lanes, n_members)
    lanes = max(lanes, math.ceil(n_members / max(1, max_batch)))
    base, rem = divmod(n_members, lanes)
    return [base + (1 if i < rem else 0) for i in range(lanes) if base or i < rem]
