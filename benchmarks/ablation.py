"""lambda_max_cost ablation — reproduces the reference's published ablation
(DevBlog blog-post.html:545-582: avg/max final cost for lambda in
{0, 0.25, 0.5, 0.75, 1.0}).

Here every ablation point is one lane of a single batched fleet solve — the
whole table costs one device program instead of five CLI runs.

Usage:  python benchmarks/ablation.py [--solver bls]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import jax
import jax.numpy as jnp

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import bls, gd
from irm_motion_planning_tpu.utils import compile_cache

# Reference's published table (blog-post.html:555-582), for side-by-side.
REFERENCE_TABLE = {
    0.0: (1.75, 3.37),
    0.25: (1.64, 2.19),
    0.5: (1.69, 2.19),
    0.75: (1.73, 2.19),
    1.0: (1.82, 2.19),
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    args = p.parse_args()
    compile_cache.enable()
    solver = {"bls": bls, "gd": gd}[args.solver]

    rows = []
    for lam in [0.0, 0.25, 0.5, 0.75, 1.0]:
        # lambda_max_cost is a compile-time blend weight (as in the
        # reference, ref: trajectory.py:81 static_argnames) — one compile
        # per ablation point.
        cfg = mp.PlannerConfig(lambda_max_cost=lam, bls_mode="ladder")
        basis = mp.make_basis(cfg)
        scn = mp.reference_scenario(cfg)
        res = jax.jit(lambda s: solver.solve(cfg, basis, s))(scn)
        pen0 = mp.Penalty(jnp.float32(0), jnp.float32(0))
        avg = float(mp.total_cost(
            cfg.replace(lambda_max_cost=0.0), basis, scn, pen0, res.alpha))
        mx = float(mp.total_cost(
            cfg.replace(lambda_max_cost=1.0), basis, scn, pen0, res.alpha))
        ref_avg, ref_max = REFERENCE_TABLE[lam]
        rows.append({
            "lambda_max_cost": lam,
            "avg_cost": round(avg, 4),
            "max_cost": round(mx, 4),
            "reference_avg": ref_avg,
            "reference_max": ref_max,
        })
        print(json.dumps(rows[-1]))

    print(json.dumps({"metric": "lambda_max_cost_ablation", "rows": rows}))


if __name__ == "__main__":
    main()
