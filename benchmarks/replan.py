"""Receding-horizon replanning benchmark (BASELINE.json configs[3]).

The reference's headline capability is 50 Hz single-scene replanning on CPU
(ref: DevBlog blog-post.html:232,350): the environment is a runtime input, so
obstacles can move every tick without recompilation.  This benchmark drives
that loop explicitly:

* obstacles drift sinusoidally every tick (runtime data, zero recompiles),
* each tick solves warm-started from the previous tick's alpha under a
  budgeted iteration horizon (bounded per-tick latency),
* measured single-scene (reference-comparable Hz) and as a batched fleet
  (many arms replanning in one device program).

Usage:  python benchmarks/replan.py [--ticks 100] [--batch 0]
Prints one JSON line per mode plus a summary line.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops.scenario import Scenario
from irm_motion_planning_tpu.solvers.replan import Replanner
from irm_motion_planning_tpu.utils import compile_cache

REF_REPLAN_HZ = 50.0  # DevBlog blog-post.html:232,350


def drift_obstacles(scn: Scenario, tick: int, amp: float = 0.15) -> Scenario:
    """Runtime obstacle motion: sinusoidal drift, per-obstacle phase.
    Pure data transformation — the solver never recompiles."""
    n = scn.obstacles.shape[-2]
    phase = np.arange(n)[:, None] * 0.7
    t = tick * 0.1
    delta = amp * np.stack(
        [np.sin(t + phase[:, 0]), np.cos(1.3 * t + phase[:, 0])], axis=-1
    ).astype(np.float32)
    if scn.obstacles.ndim == 3:  # batched (B, O, 2)
        delta = delta[None]
    return Scenario(
        start=scn.start,
        goal=scn.goal,
        obstacles=scn.obstacles + jnp.asarray(delta),
        obstacle_weight=scn.obstacle_weight,
    )


def run_mode(cfg, scn, ticks, batched, engine="vmap"):
    rp = Replanner(cfg, budget_outer=2, budget_inner=25, batched=batched,
                   engine=engine)
    # Warm-up tick: compile excluded (ref protocol: optimizer_BLS.py:50-54).
    jax.block_until_ready(rp.plan(drift_obstacles(scn, 0)).alpha)
    t0 = time.time()
    costs = []
    for k in range(1, ticks + 1):
        res = rp.plan(drift_obstacles(scn, k))
        jax.block_until_ready(res.alpha)
        costs.append(res.stats.final_cost)
    dt = time.time() - t0
    hz = ticks / dt
    mean_cost = float(jnp.mean(jnp.stack(costs)))
    return hz, dt / ticks * 1e3, mean_cost


def stack_ticks(scn, ticks):
    """Scenario with a leading tick axis: the streamed environment rollout
    (obstacles drift per tick; start/goal fixed)."""
    per_tick = [drift_obstacles(scn, k) for k in range(1, ticks + 1)]
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs, axis=0), *per_tick
    )


def run_rollout(cfg, scn, ticks, batched, engine):
    """On-device replanning loop: ONE dispatch replans all ticks
    (lax.scan carrying the warm start) — removes per-tick solver-dispatch
    latency from the loop entirely."""
    rp = Replanner(cfg, budget_outer=2, budget_inner=25, batched=batched,
                   engine=engine)
    scn_ticks = stack_ticks(scn, ticks)
    rp.plan_rollout(scn_ticks)  # compile + warm-up
    rp.reset()
    t0 = time.time()
    _, stats = rp.plan_rollout(scn_ticks)
    jax.block_until_ready(stats.final_cost)
    dt = time.time() - t0
    hz = ticks / dt
    return hz, dt / ticks * 1e3, float(jnp.mean(stats.final_cost))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ticks", type=int, default=100)
    p.add_argument("--batch", type=int, default=256,
                   help="fleet size for the batched mode (0 = skip)")
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--engine", choices=["fleet", "vmap"], default="fleet",
                   help="fleet = the batch-trailing fleet engine (a "
                        "one-lane fleet for the single scene); vmap = the "
                        "sequential solver per lane")
    p.add_argument("--rollout", type=lambda x: str(x).lower() == "true",
                   default=True,
                   help="also measure the on-device lax.scan tick loop")
    args = p.parse_args()
    compile_cache.enable()

    cfg = mp.PlannerConfig(bls_mode="ladder")
    scn1 = mp.reference_scenario(cfg)

    hz, ms, cost = run_mode(cfg, scn1, args.ticks, batched=False,
                            engine=args.engine)
    print(json.dumps({
        "metric": "replan_rate_single_scene",
        "value": round(hz, 1), "unit": "Hz",
        "tick_ms": round(ms, 3), "mean_tick_cost": round(cost, 4),
        "vs_reference_50hz": round(hz / REF_REPLAN_HZ, 2),
    }))

    if args.rollout:
        hz, ms, cost = run_rollout(cfg, scn1, args.ticks, batched=False,
                                   engine=args.engine)
        print(json.dumps({
            "metric": "replan_rate_single_scene_ondevice",
            "value": round(hz, 1), "unit": "Hz",
            "tick_ms": round(ms, 3), "mean_tick_cost": round(cost, 4),
            "vs_reference_50hz": round(hz / REF_REPLAN_HZ, 2),
        }))

    if args.batch > 0:
        scnB = mp.replicate_scenario(scn1, args.batch)
        hz, ms, cost = run_mode(cfg, scnB, args.ticks, batched=True,
                                engine=args.engine)
        print(json.dumps({
            "metric": "replan_rate_fleet",
            "batch": args.batch,
            "value": round(hz, 1), "unit": "Hz (full-fleet ticks)",
            "plans_per_sec": round(hz * args.batch, 1),
            "tick_ms": round(ms, 3), "mean_tick_cost": round(cost, 4),
        }))

        if args.rollout:
            hz, ms, cost = run_rollout(cfg, scnB, args.ticks, batched=True,
                                       engine=args.engine)
            print(json.dumps({
                "metric": "replan_rate_fleet_ondevice",
                "batch": args.batch,
                "value": round(hz, 1), "unit": "Hz (full-fleet ticks)",
                "plans_per_sec": round(hz * args.batch, 1),
                "tick_ms": round(ms, 3), "mean_tick_cost": round(cost, 4),
            }))


if __name__ == "__main__":
    main()
