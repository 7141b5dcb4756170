"""The port's DAG tier on the CPU: the four cases of the JAX package's
``tests/test_dag.py`` on ``TorchRTS(device="cpu")`` — the diamond as one
dispatch with scalar values, refusal of a non-commutative reducer, a
poisoned member excluded from the reduction, and resume after a journaled
reduction — plus the masked reductions against numpy.

The diamond every adaptive round reduces to:

    e0 (ensemble) --fan-in--> r (gather reduction) --fan-out--> e1
      \\------------------elementwise carry--------------------/
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import states as st
from repro_torch.fusion import DAG_TAG, fusable, fusable_reduction
from repro_torch.fusion.engine import _apply_reduction
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

N = 8

# --------------------------------------------------------------------------- #
# Kernels (module-level: resume-stable registration)
# --------------------------------------------------------------------------- #

DA_CALLS = [0]


@fusable(static_argnames=())
def d_step_a(x, poison=0.0):
    DA_CALLS[0] += 1   # per scalar execution; once per vmap when fused
    return torch.ones(3) * torch.as_tensor(x, dtype=torch.float32) * 2.0 \
        + poison


@fusable(static_argnames=())
def d_step_b(a, center=0.0, poison=0.0):
    return (torch.as_tensor(a, dtype=torch.float32)
            - torch.as_tensor(center, dtype=torch.float32) + poison)


@fusable_reduction(kind="mean")
def d_mean(values):
    return float(np.mean([np.asarray(v) for v in values]))


@fusable_reduction(kind="mean", commutative=False)
def d_ordered(values):
    # declared order-dependent: must NEVER fuse, whatever the body does
    return float(np.mean([np.asarray(v) for v in values]))


def _diamond(name, *, reducer=d_mean, fuse=True, poison_a=(), poison_b=()):
    """e0 -> gather(reducer) -> e1(carry a, broadcast center)."""
    e0 = api.ensemble(
        d_step_a,
        over=[{"x": float(i + 1),
               "poison": float("nan") if i in poison_a else 0.0}
              for i in range(N)],
        name=f"{name}a", fuse=fuse)
    r = api.gather(e0, reducer, name=f"{name}r")
    e1 = e0.then(
        d_step_b, name=f"{name}b", arg="a",
        over=[{"center": r.out,
               "poison": float("nan") if i in poison_b else 0.0}
              for i in range(N)],
        fuse=fuse)
    return e0, r, e1


def _run(node, *, dag=True, journal=None, resume=False):
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(device="cpu", slot_oversubscribe=4)
        return holder["rts"]

    res = api.run(node, resources=ResourceDescription(slots=4),
                  rts_factory=factory, dag=dag, journal_path=journal,
                  resume=resume, timeout=60)
    return res, holder["rts"]


def _dag_tagged(compiled):
    return [t for p in compiled for s in p.stages for t in s.tasks
            if DAG_TAG in t.tags]


# --------------------------------------------------------------------------- #
# Detection + parity
# --------------------------------------------------------------------------- #

def test_diamond_composes_to_one_dispatch_with_scalar_values():
    _, _, e1s = _diamond("pds", fuse=False)
    res_s, _ = _run(e1s, dag=False)
    s_states = dict(res_s.task_states)
    s_vals = [np.asarray(s.out.result()).copy() for s in e1s.specs]
    res_s.close()

    _, _, probe = _diamond("pdp")
    compiled = api.compile(probe, name="pdp-probe")
    assert len(_dag_tagged(compiled)) == 2 * N + 1   # every node on the path
    compiled.close()

    e0, r, e1 = _diamond("pdf")
    res_f, rts = _run(e1)
    assert all(v == st.DONE for v in res_f.task_states.values())
    assert sorted(res_f.task_states.values()) == sorted(s_states.values())
    # exact-arithmetic kernel: the device mean of 2..16 is exact in fp32,
    # so fused and scalar agree bit for bit
    assert float(np.asarray(r.out.result())) == 9.0
    for ref, spec in zip(s_vals, e1.specs):
        assert np.array_equal(ref, np.asarray(spec.out.result()))
    stats = rts.fusion_stats
    assert stats["dag_carriers"] == 1
    assert stats["dispatches"] == 1        # the whole round, one dispatch
    assert stats["dag_links"] == 3
    assert stats["degraded"] == 0 and stats["scalar_fallback"] == 0
    res_f.close()


# --------------------------------------------------------------------------- #
# Commutativity precondition
# --------------------------------------------------------------------------- #

def test_noncommutative_reducer_refuses_fusion_with_identical_values():
    _, rs, e1s = _diamond("ncs", reducer=d_ordered, fuse=False)
    res_s, _ = _run(e1s, dag=False)
    s_vals = [np.asarray(s.out.result()).copy() for s in e1s.specs]
    s_red = float(np.asarray(rs.out.result()))
    res_s.close()

    _, _, probe = _diamond("ncp", reducer=d_ordered)
    compiled = api.compile(probe, name="ncp-probe")
    assert _dag_tagged(compiled) == []     # detection refused the path
    compiled.close()

    e0, r, e1 = _diamond("ncf", reducer=d_ordered)
    res_f, rts = _run(e1)
    assert all(v == st.DONE for v in res_f.task_states.values())
    assert float(np.asarray(r.out.result())) == s_red
    for ref, spec in zip(s_vals, e1.specs):
        assert np.array_equal(ref, np.asarray(spec.out.result()))
    stats = rts.fusion_stats
    assert stats["dag_carriers"] == 0      # degrade ladder: per-stage fused
    assert stats["dispatches"] > 1
    res_f.close()


# --------------------------------------------------------------------------- #
# Member failure vs the reduction
# --------------------------------------------------------------------------- #

def test_poisoned_member_fails_alone_and_is_excluded_from_reduction():
    e0, r, e1 = _diamond("px", poison_a={2})
    res, rts = _run(e1)
    states = res.task_states
    assert states["pxa-2"] == st.FAILED
    assert states["pxb-2"] == st.FAILED    # downstream of the poisoned carry
    assert states[r.name] == st.DONE       # reduction over the survivors
    assert sum(v == st.DONE for v in states.values()) == 2 * N + 1 - 2
    # masked mean over the 7 finite members: (72 - 6) / 7, fp32 on device
    assert np.isclose(float(np.asarray(r.out.result())), 66.0 / 7.0,
                      rtol=1e-6)
    assert rts.fusion_stats["dag_carriers"] == 1
    res.close()


# --------------------------------------------------------------------------- #
# Journal resume re-enters the round AFTER the reduction link
# --------------------------------------------------------------------------- #

def test_resume_reenters_after_journaled_reduction(tmp_path):
    journal = str(tmp_path / "wf.jsonl")

    # run 1: the whole fan-out stage dies INSIDE the composed dispatch —
    # the carrier still journals everything upstream of the failure
    _, r1, e1 = _diamond("rz", poison_b=set(range(N)))
    res, _ = _run(e1, journal=journal)
    states = res.task_states
    assert all(states[f"rza-{i}"] == st.DONE for i in range(N))
    assert states[r1.name] == st.DONE
    assert all(states[f"rzb-{i}"] == st.FAILED for i in range(N))
    res.close()

    # run 2 (resume, inputs fixed): only the fan-out stage re-executes —
    # an incomplete-DAG fragment whose carry (e0 outputs) and broadcast
    # (the reduction value) resolve from the journal
    DA_CALLS[0] = 0
    _, r2, e2 = _diamond("rz")
    res2, rts2 = _run(e2, journal=journal, resume=True)
    assert all(v == st.DONE for v in res2.task_states.values())
    assert DA_CALLS[0] == 0                # e0 never re-ran, in any form
    assert float(np.asarray(r2.out.result())) == 9.0   # restored value
    for i, spec in enumerate(e2.specs):
        assert np.allclose(np.asarray(spec.out.result()),
                           2.0 * (i + 1) - 9.0), i
    res2.close()


# --------------------------------------------------------------------------- #
# The masked reductions themselves
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
def test_masked_reduction_matches_numpy_over_the_valid_members(kind):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((6, 5)).astype(np.float32)
    vals[4, 2] = np.nan                    # non-finite member: dropped
    mask = np.array([True, True, False, True, True, True])   # pad row off
    got = _apply_reduction(torch.from_numpy(vals), mask, kind, None)
    keep = vals[[0, 1, 3, 5]]
    want = {"sum": keep.sum(), "mean": keep.mean(), "max": keep.max(),
            "min": keep.min()}[kind]
    assert np.isclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    # no valid member: NaN, so the reduce task fails instead of inventing
    # an identity element
    none = _apply_reduction(torch.from_numpy(vals), np.zeros(6, bool), kind,
                            None)
    assert np.isnan(float(none))
