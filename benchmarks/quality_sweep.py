"""Seed sweep of the cross-device quality distribution.

A converged-fraction gap between two fp paths on one batch can be zero-mean
boundary-lane fp noise (its sign flips across seeds) or a real directional
effect.  This sweep runs benchmarks/quality.py's measurement at N seeds on
each named device platform and reports the per-seed converged-fraction and
mean-cost deltas against the first, plus sign statistics.

Usage:  python benchmarks/quality_sweep.py --seeds 0,1,2,3,4 --devices cpu,gpu
Writes one JSON line (stdout).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import jax

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import fleet
from irm_motion_planning_tpu.utils import compile_cache
from quality import summarize  # noqa: E402  (sibling module)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="0,1,2,3,4")
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--devices", default="cpu,gpu",
                   help="comma-separated device platforms; deltas are "
                        "taken against the first")
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--schedule", action="store_true", default=True,
                   help="benchmark per-round schedule (the headline config)")
    args = p.parse_args()
    compile_cache.enable()

    sched = {"bls": mp.REFERENCE_INNER_SCHEDULE_BLS,
             "gd": mp.REFERENCE_INNER_SCHEDULE_GD}[args.solver]
    cfg = mp.PlannerConfig(
        bls_mode="ladder", fixed_iters=True,
        inner_schedule=sched, max_inner_iteration=max(sched),
    )
    platforms = args.devices.split(",")
    devices = {p: jax.devices(p)[0] for p in platforms}
    bases = {p: jax.device_put(mp.make_basis(cfg), d)
             for p, d in devices.items()}
    runners = {
        p: fleet.make_fleet_solver(cfg, bases[p], solver=args.solver)
        for p in platforms
    }

    per_seed = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        scns = mp.random_scenarios(cfg, jax.random.PRNGKey(seed), args.batch)
        row = {"seed": seed}
        for b in platforms:
            scns_d = jax.device_put(scns, devices[b])
            res = jax.block_until_ready(runners[b](scns_d))
            row[b] = summarize(cfg, bases[b], scns_d, res)
            print(json.dumps({"seed": seed, "device": b, **row[b]}),
                  file=sys.stderr, flush=True)
        per_seed.append(row)

    base = platforms[0]
    deltas = {}
    for b in platforms[1:]:
        dc = [r[b]["converged_frac"] - r[base]["converged_frac"]
              for r in per_seed]
        dm = [r[b]["avg_cost_mean"] - r[base]["avg_cost_mean"]
              for r in per_seed]
        deltas[f"{b}-{base}"] = {
            "converged_frac_delta_per_seed": [round(d, 4) for d in dc],
            "converged_frac_delta_mean": round(sum(dc) / len(dc), 4),
            "sign_flips": bool(min(dc) < 0 < max(dc)),
            "avg_cost_delta_per_seed": [round(d, 5) for d in dm],
        }
    print(json.dumps({
        "metric": "quality_seed_sweep",
        "batch": args.batch,
        "solver": args.solver,
        "devices": {p: d.device_kind for p, d in devices.items()},
        "schedule": list(sched),
        "per_seed": per_seed,
        "deltas": deltas,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
