"""Fusion groups: which tasks may share one batched device dispatch.

A *fusible group* is a set of tasks that (a) run the same pure-function
kernel, (b) have congruent argument pytrees (same kwarg names; array leaves
that differ only in values, or in their leading length for declared
pad-axis arguments), (c) agree on every *static* argument, and (d) share
the same resource shape (``slots``) and federation affinity (``backend``).
Such a group is semantically N independent tasks but can execute as one
``jax.vmap`` (or hand-written batched) dispatch — the whole point of the
fusion engine.

The contract is carried on the kernel function itself: :func:`fusable`
attaches a :class:`FusionSpec`, and :func:`fusion_group_key` folds the
spec identity plus the congruence-relevant parts of a member's kwargs into
a string key. Members with equal keys are fusible with each other; a key
of ``None`` means "never fuse" (unmarked callable, or fusion opted out).

Nothing here imports JAX: group keys are computed at *compile* time (the
declarative API tags tasks), and must stay cheap and import-light.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Sequence

FUSION_ATTR = "__fusion__"
REDUCTION_ATTR = "__fusion_reduction__"
GROUP_TAG = "_fusion_group"   # Task.tags key the Emgr / RTS read
CHAIN_TAG = "_fusion_chain"   # Task.tags key marking one link of a chain
DAG_TAG = "_fusion_dag"       # Task.tags key marking one node of a fused DAG


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """How a kernel participates in fused execution.

    ``static_argnames`` — kwargs that must be *equal and hashable* across
    every member of a group (they parameterize the trace, not the batch);
    they become part of the group key and are passed unbatched.

    ``shared_argnames`` — array-valued kwargs that are identical across
    members (e.g. a velocity model every member evaluates): passed once,
    unbatched, taken from the first member.

    ``pad_argnames`` — kwargs whose leading-axis length may differ between
    members: the engine pads them (edge-replication) to the group maximum
    and trims each member's output back to its own length along axis 0.

    ``trim_outputs`` — the output contract that padding relies on: when
    True (default), EVERY output leaf whose leading axis equals the padded
    length is treated as following the pad axis and trimmed to the
    member's own length. A kernel whose output mixes per-row leaves with
    fixed-length leaves that can collide with the padded length must set
    this False and slice its own outputs (the engine then delivers padded
    leaves untouched).

    ``batched`` — optional hand-written batched implementation. Called as
    ``batched(**kwargs)`` where every non-static/non-shared kwarg carries a
    leading batch axis; must return outputs with the same leading axis.
    When absent the engine vmaps the scalar kernel.

    ``check_finite`` — when True (default) a member whose outputs contain
    non-finite values FAILS alone (exit 1) while the rest of the batch
    completes: per-member failure isolation for numerical blow-ups.

    ``min_batch`` — per-kernel override of the engine's fuse-vs-scalar
    threshold (None = use the planner default).
    """

    static_argnames: Sequence[str] = ()
    shared_argnames: Sequence[str] = ()
    pad_argnames: Sequence[str] = ()
    batched: Optional[Callable[..., Any]] = None
    check_finite: bool = True
    min_batch: Optional[int] = None
    trim_outputs: bool = True


def fusable(fn: Optional[Callable[..., Any]] = None, *,
            static_argnames: Sequence[str] = (),
            shared_argnames: Sequence[str] = (),
            pad_argnames: Sequence[str] = (),
            batched: Optional[Callable[..., Any]] = None,
            check_finite: bool = True,
            min_batch: Optional[int] = None,
            trim_outputs: bool = True) -> Callable[..., Any]:
    """Mark ``fn`` as a fusion kernel (usable bare or with arguments).

    The function itself is unchanged — it still runs scalar anywhere a
    plain task callable runs. The marker is what lets ``api.ensemble``
    compute a group key and the JaxRTS batch congruent members.
    """
    spec = FusionSpec(
        static_argnames=tuple(static_argnames),
        shared_argnames=tuple(shared_argnames),
        pad_argnames=tuple(pad_argnames),
        batched=batched, check_finite=check_finite, min_batch=min_batch,
        trim_outputs=trim_outputs)

    def mark(f: Callable[..., Any]) -> Callable[..., Any]:
        setattr(f, FUSION_ATTR, spec)
        return f

    return mark(fn) if fn is not None else mark


def fusion_spec(fn: Any) -> Optional[FusionSpec]:
    """The :class:`FusionSpec` of a marked callable, else None."""
    spec = getattr(fn, FUSION_ATTR, None)
    return spec if isinstance(spec, FusionSpec) else None


def fusion_group_key(fn: Callable[..., Any], kwargs: Dict[str, Any],
                     *, slots: int = 1,
                     backend: Optional[str] = None) -> Optional[str]:
    """Group key for one member, or ``None`` when the member cannot fuse.

    Two members with equal keys are guaranteed congruent: same kernel
    object, same kwarg names, equal static values, same slots/backend.
    Static values enter as a digest of their reprs — ``repr`` equality is
    a conservative stand-in for value equality, and a false *negative*
    only costs a missed fusion, never a wrong batch.
    """
    spec = fusion_spec(fn)
    if spec is None:
        return None
    name = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', '?')}"
    statics = ";".join(
        f"{k}={kwargs[k]!r}" for k in sorted(spec.static_argnames)
        if k in kwargs)
    digest = hashlib.sha1(statics.encode()).hexdigest()[:12]
    keys = ",".join(sorted(kwargs))
    return f"{name}|{keys}|s{slots}|b{backend}|{digest}"


# --------------------------------------------------------------------------- #
# Reductions — the fan-in half of a fused DAG
# --------------------------------------------------------------------------- #
#
# ``api.gather(ensemble, reducer)`` is a k→1 edge: the reducer consumes the
# whole ensemble's member values. Scalar execution always works; the DAG
# data plane can additionally run a *marked* reducer device-side inside the
# carrier (a masked segment reduction over the stacked member axis — and a
# psum/pmax across the mesh on the sharded tier). The marker is strictly
# opt-in because the fused form must be a commutative reduction over the
# member set: order of members must not matter, and members excluded by
# padding or failure must drop out cleanly.

#: jnp defaults the engine implements for plain commutative reducers. Each
#: reduces over the member axis AND every element of each member's value —
#: the list-of-values equivalents are ``np.sum(values)``, ``np.mean(...)``,
#: ``np.max(...)``, ``np.min(...)``.
REDUCTION_KINDS = ("sum", "mean", "max", "min")


@dataclasses.dataclass(frozen=True)
class ReductionSpec:
    """How a gather reducer participates in fused DAG execution.

    ``kind`` — one of :data:`REDUCTION_KINDS`: the jnp-based default
    implementation, a full masked reduction of the valid members' stacked
    values to one scalar. Pick the kind that matches the scalar body
    (``kind="sum"`` for ``float(np.sum([...]))`` etc.) — the drift gates
    compare the two paths.

    ``combine`` — optional custom batched implementation, called as
    ``combine(stacked, mask)`` where ``stacked`` is the previous node's
    output pytree with a leading member axis and ``mask`` is a boolean
    ``(B,)`` vector of the members that are live (not padding, not failed).
    Must be jit-traceable; overrides ``kind``. Custom combines run on the
    unsharded tiers only (the engine cannot split an opaque combine across
    a mesh, so a sharded carrier degrades such a DAG to micro-batches).

    ``commutative`` — the fusion precondition. ``False`` documents a
    reducer that depends on member order: it keeps its scalar semantics
    everywhere and REFUSES device-side fusion (the DAG degrades to
    per-stage fused execution with identical values).
    """

    kind: str = "sum"
    combine: Optional[Callable[..., Any]] = None
    commutative: bool = True


def fusable_reduction(fn: Optional[Callable[..., Any]] = None, *,
                      kind: str = "sum",
                      combine: Optional[Callable[..., Any]] = None,
                      commutative: bool = True) -> Callable[..., Any]:
    """Mark a gather reducer as fusable into the DAG data plane.

    Like :func:`fusable`, the function itself is unchanged — it still runs
    scalar as ``fn(list_of_values)`` anywhere a plain reducer runs. The
    marker is what lets ``api.compile`` fold the fan-in edge into a
    ``_fusion_dag`` plan executed device-side.
    """
    if kind not in REDUCTION_KINDS:
        raise ValueError(
            f"unknown reduction kind {kind!r}; expected one of "
            f"{REDUCTION_KINDS} (or pass combine=)")
    spec = ReductionSpec(kind=kind, combine=combine,
                         commutative=bool(commutative))

    def mark(f: Callable[..., Any]) -> Callable[..., Any]:
        setattr(f, REDUCTION_ATTR, spec)
        return f

    return mark(fn) if fn is not None else mark


def reduction_spec(fn: Any) -> Optional[ReductionSpec]:
    """The *fusable* :class:`ReductionSpec` of a marked reducer, else None.

    Non-commutative specs return None here on purpose: to every consumer
    (the compiler's DAG detection, the engine) such a reducer is
    indistinguishable from an unmarked one — scalar semantics only.
    """
    spec = getattr(fn, REDUCTION_ATTR, None)
    if isinstance(spec, ReductionSpec) and spec.commutative:
        return spec
    return None


# --------------------------------------------------------------------------- #
# Chain tags
# --------------------------------------------------------------------------- #
#
# A *fusion chain* is a linear sequence of fusable ensemble stages with
# elementwise data flow: stage k+1's member *i* consumes exactly member *i*'s
# future from stage k, and the links agree on everything but the kernel
# (same slots, same backend — "same group key modulo kernel"), so one
# member-width device lease can run the whole chain. The compiler detects
# chains (api/compiler._detect_chains) and stamps every member task with a
# CHAIN_TAG dict; a chain-capable RTS re-assembles the links from the tags
# and executes each micro-batch of members as one composed dispatch with the
# intermediate buffers never touching the host.

def chain_tag(chain_id: str, link: int, member: int, n_links: int,
              carry: Optional[str] = None) -> Dict[str, Any]:
    """The CHAIN_TAG value for one member task of one chain link.

    ``c`` — chain id (unique per compile; NOT stable across sessions — the
    tag is runtime routing, never resume keying); ``k`` — link index;
    ``m`` — member index (aligns members across links); ``n`` — total links;
    ``a`` — the kwarg name the carried value arrives under (links > 0).
    Everything is JSON-scalar so the tag journals like any other tag.
    """
    tag: Dict[str, Any] = {"c": chain_id, "k": int(link), "m": int(member),
                           "n": int(n_links)}
    if carry is not None:
        tag["a"] = carry
    return tag


def parse_chain_tag(tags: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The validated CHAIN_TAG of a task, else None (malformed tags are
    treated as absent — a half-formed tag must degrade to per-stage
    fusion, never crash the packer)."""
    tag = tags.get(CHAIN_TAG)
    if (isinstance(tag, dict) and isinstance(tag.get("c"), str)
        and all(isinstance(tag.get(f), int) for f in ("k", "m", "n"))
            and 0 <= tag["k"] < tag["n"]):
        return tag
    return None


# --------------------------------------------------------------------------- #
# DAG tags
# --------------------------------------------------------------------------- #
#
# A *fusion DAG* generalizes a chain with fan-in and fan-out nodes: a linear
# sequence of NODES where each node is either a fusable ensemble (width k,
# role "e") or a fusable reduction (width 1, role "r") consuming the whole
# previous ensemble. An ensemble node may carry elementwise from the last
# ensemble node (kwarg ``a``, like a chain link) and/or consume the last
# reduction's broadcast value (kwarg ``b``, shared across its members). The
# compiler detects the shape (api/compiler._detect_dags) and stamps every
# task with a DAG_TAG dict; a DAG-capable RTS re-assembles the nodes and
# executes the whole round — ensemble → then → gather → broadcast →
# ensemble — as ONE composed dispatch.

def dag_tag(dag_id: str, node: int, member: int, n_nodes: int, *,
            width: int, role: str = "e", carry: Optional[str] = None,
            broadcast: Optional[str] = None,
            kind: Optional[str] = None) -> Dict[str, Any]:
    """The DAG_TAG value for one task of one DAG node.

    ``c``/``k``/``m``/``n`` mirror the chain tag (id, node index, member
    index within the node, total nodes) so the superstaging and drain
    machinery treat both flows uniformly. ``w`` — the node's full member
    width (readiness is count-based: node widths change across a fan-in,
    so the chain rule "waiting ⊆ arrived" does not transfer). ``r`` — node
    role, ``"e"`` ensemble or ``"r"`` reduction. ``a`` — elementwise carry
    kwarg; ``b`` — broadcast kwarg fed from the last reduction; ``rk`` —
    the reduction kind of an ``"r"`` node (``None`` = custom combine).
    JSON-scalar throughout, like the chain tag.
    """
    tag: Dict[str, Any] = {"c": dag_id, "k": int(node), "m": int(member),
                           "n": int(n_nodes), "w": int(width), "r": role}
    if carry is not None:
        tag["a"] = carry
    if broadcast is not None:
        tag["b"] = broadcast
    if kind is not None:
        tag["rk"] = kind
    return tag


def parse_dag_tag(tags: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The validated DAG_TAG of a task, else None — same degrade-don't-crash
    contract as :func:`parse_chain_tag`."""
    tag = tags.get(DAG_TAG)
    if (isinstance(tag, dict) and isinstance(tag.get("c"), str)
        and all(isinstance(tag.get(f), int) for f in ("k", "m", "n", "w"))
        and tag.get("r") in ("e", "r")
            and 0 <= tag["k"] < tag["n"] and tag["w"] >= 1):
        return tag
    return None
