"""Shared pieces of the sharded-tier tests (``test_torch_sharded_*.py``).

:func:`run_jax` runs a script of the JAX package in a subprocess on 8
(or ``devices``) forced host devices — the way ``tests/test_shard.py`` runs its
multi-device cases — and returns the JSON object its last line prints.
The hold-buffer scenarios below take the RTS class, ``Task`` and a fusable
kernel as arguments, so the same code drives ``JaxRTS`` in that subprocess
and ``TorchRTS`` over 8 lanes of the CPU in the test process; both record
what they saw in a plain dict.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax(source: str, timeout: float = 240.0, devices: int = 8,
            xla_flags: str = "") -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    env["XLA_FLAGS"] = " ".join(
        [f"--xla_force_host_platform_device_count={devices}", xla_flags])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(source)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, \
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------- #
# Hold-buffer scenarios (tests/test_shard.py's, for either package)
# --------------------------------------------------------------------------- #

def held_rts(make_rts, width_slots: int = 16):
    """An RTS whose planner sees an 8-place mesh without a started pilot:
    16 free slots, fusion_max_batch 8, shard_min_members 8."""
    rts = make_rts()
    rts._pool = list(range(width_slots))
    rts._slots_total = width_slots
    return rts


def group(task_cls, kernel, n, start=0, width=100, key="G"):
    return [task_cls(name=f"h{start + i}", executable=kernel,
                     kwargs={"x": float(start + i)},
                     tags={"_fusion_group": key, "_fusion_width": width})
            for i in range(n)]


def scenario_quanta(make_rts, task_cls, kernel) -> dict:
    rts = held_rts(make_rts)
    seen = {}
    try:
        out = rts._pack_fusible(group(task_cls, kernel, 30))
        seen["first"] = [len(out), len(rts._held["G"]),
                         len(rts.in_flight())]
        out = rts._pack_fusible(group(task_cls, kernel, 30, start=30))
        seen["second"] = [[t.name for t in out], len(rts._held["G"])]
        out = rts._pack_fusible(group(task_cls, kernel, 40, start=60))
        seen["third"] = [[t.name for t in out], "G" in rts._held,
                         bool(rts._hold_timers)]
        seen["shard_carriers"] = rts.fusion_stats["shard_carriers"]
        seen["slots"] = [t.slots for t in out]
    finally:
        rts.stop()
    return seen


def scenario_bypass(make_rts, task_cls, kernel) -> dict:
    rts = held_rts(make_rts)
    seen = {}
    try:
        out = rts._pack_fusible(group(task_cls, kernel, 4, width=4))
        seen["narrow"] = [[t.name for t in out], bool(rts._held)]
        members = group(task_cls, kernel, 8, width=100)
        for t in members:
            t.tags["_no_shard"] = True
        out = rts._pack_fusible(members)
        seen["no_shard"] = [[t.name for t in out], bool(rts._held)]
    finally:
        rts.stop()
    return seen


def scenario_rearm(make_rts, task_cls, kernel) -> dict:
    rts = held_rts(make_rts)
    seen = {}
    try:
        rts._pack_fusible(group(task_cls, kernel, 10))
        seen["armed"] = "G" in rts._hold_timers
        rts._flush_held("G", seen_at_arm=5)
        seen["progress"] = ["G" in rts._held, "G" in rts._hold_timers,
                            len(rts._held["G"])]
        rts._queue.append(task_cls(name="busy", executable="sleep://0"))
        rts._flush_held("G", seen_at_arm=10)
        seen["busy"] = ["G" in rts._held, "G" in rts._hold_timers]
        rts._queue.clear()
        rts._flush_held("G", seen_at_arm=10)
        seen["stalled"] = ["G" in rts._held,
                           rts.fusion_stats["shard_carriers"],
                           [t.name for t in rts._queue]]
    finally:
        rts.stop()
    return seen


def scenario_idle_flush(make_rts, task_cls, kernel) -> dict:
    rts = held_rts(make_rts)
    rts.shard_hold_s = 0.05
    seen = {}
    try:
        out = rts._pack_fusible(group(task_cls, kernel, 70))
        seen["first"] = [[t.name for t in out], len(rts._held["G"])]
        deadline = time.time() + 5.0
        while rts._held and time.time() < deadline:
            time.sleep(0.01)
        seen["flushed"] = not rts._held
    finally:
        rts.stop()
    return seen


def scenario_cancel(make_rts, task_cls, kernel) -> dict:
    rts = held_rts(make_rts)
    seen = {}
    try:
        members = group(task_cls, kernel, 10)
        rts._pack_fusible(members)
        rts.cancel([m.uid for m in members[:4]])
        seen["partial"] = [len(rts._held["G"]), len(rts.in_flight())]
        rts.cancel([m.uid for m in members[4:]])
        seen["emptied"] = ["G" in rts._held, bool(rts._hold_timers)]
    finally:
        rts.stop()
    return seen


def scenario_planned_slots(make_rts, task_cls, kernel) -> dict:
    rts = held_rts(make_rts)
    try:
        return {"wide": rts.planned_group_slots(100, 1),
                "wide2": rts.planned_group_slots(100, 2),
                "narrow": rts.planned_group_slots(4, 1)}
    finally:
        rts.stop()


SCENARIOS = {"quanta": scenario_quanta, "bypass": scenario_bypass,
             "rearm": scenario_rearm, "idle_flush": scenario_idle_flush,
             "cancel": scenario_cancel, "planned_slots": scenario_planned_slots}
