"""repro.fusion — fused vectorized execution of homogeneous ensembles.

EnTK-style toolkits dispatch every ensemble member as its own task through
its own Python thread and its own JAX trace; for the O(10⁴) *homogeneous*
ensembles the paper targets (AnEn analog searches, seismic forward sweeps)
that drives the hardware at per-task Python speed. This subsystem detects
fusible groups — same pure-function kernel, congruent argument pytrees,
same placement — and executes each group as a small number of batched
device dispatches while keeping PST semantics intact: per-member DONE /
FAILED journal records, per-member retry budgets, resume that re-runs only
the failed members of a partially-failed batch.

Layers (who does what):

* :mod:`repro.fusion.groups` — the :func:`fusable` kernel marker and the
  compile-time group key (``api.ensemble`` tags members; ``fuse=False``
  opts out).
* :mod:`repro.fusion.plans` — the fuse-vs-scalar cost model and the
  adaptive micro-batch split over the RTS's free device slots.
* :mod:`repro.fusion.engine` — stacking/padding, the single
  ``jax.vmap``/batched dispatch, the per-member completion fan-out with
  NaN/exception isolation.
* :mod:`repro.fusion.handles` — :class:`ArrayResult`, the device-resident
  result handle whose journal form is a content-hash + spill path instead
  of a JSON-encoded array.

The ExecManager hands whole groups to any RTS advertising
``supports_fusion()`` (the JaxRTS; a federation advertises it when any
member does), charging pilot slots per *batch* instead of per member.
"""

from .groups import (CHAIN_TAG, DAG_TAG, FUSION_ATTR, GROUP_TAG,  # noqa: F401
                     REDUCTION_ATTR, REDUCTION_KINDS, FusionSpec,
                     ReductionSpec, chain_tag, dag_tag, fusable,
                     fusable_reduction, fusion_group_key, fusion_spec,
                     parse_chain_tag, parse_dag_tag, reduction_spec)
from .handles import ArrayResult  # noqa: F401
from .plans import (DEFAULT_MAX_BATCH, DEFAULT_MIN_BATCH,  # noqa: F401
                    DEFAULT_MIN_CHAIN, GroupPlan, plan_chain, plan_group)

__all__ = ["FusionSpec", "fusable", "fusion_spec", "fusion_group_key",
           "ReductionSpec", "fusable_reduction", "reduction_spec",
           "ArrayResult", "GroupPlan", "plan_group", "plan_chain",
           "GROUP_TAG", "CHAIN_TAG", "chain_tag", "parse_chain_tag",
           "DAG_TAG", "dag_tag", "parse_dag_tag",
           "FUSION_ATTR", "REDUCTION_ATTR", "REDUCTION_KINDS",
           "DEFAULT_MIN_BATCH", "DEFAULT_MAX_BATCH", "DEFAULT_MIN_CHAIN"]
