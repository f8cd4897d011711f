"""Problem-size scaling: per-solve time vs number of support timesteps T.

Reproduces the reference's published scaling study (DevBlog
blog-post.html:445-454: runtime grows linearly to ~100 support points, then
quadratically — the T x T kernel Gram matrices dominate).  On an
accelerator the crossover moves right: small-T solves are elementwise- and
overhead-bound, and the quadratic term shows only once the (2T, T) basis
GEMMs dominate.

Each T is a separate compile (T is a static shape); the persistent
compilation cache makes re-runs cheap.

Usage:  python benchmarks/problemsize.py [--sizes 25,50,100,150,200]
Prints one JSON line per size plus a summary line.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import fleet
from irm_motion_planning_tpu.utils import compile_cache


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="25,50,100,150,200")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--inner", type=int, default=15)
    args = p.parse_args()
    compile_cache.enable()

    rows = []
    for T in [int(s) for s in args.sizes.split(",")]:
        cfg = mp.PlannerConfig(
            n_timesteps=T, bls_mode="ladder", fixed_iters=True,
            max_inner_iteration=args.inner,
        )
        basis = mp.make_basis(cfg)
        scns = mp.replicate_scenario(mp.reference_scenario(cfg), args.batch)
        run = fleet.make_fleet_solver(cfg, basis, solver=args.solver)

        def run_to_completion():
            return jax.block_until_ready(run(scns))

        t0 = time.time()
        run_to_completion()
        compile_s = time.time() - t0
        times = []
        for _ in range(args.repeats):
            t0 = time.time()
            run_to_completion()
            times.append(time.time() - t0)
        best = min(times)
        rows.append({
            "n_timesteps": T,
            "per_solve_us": round(1e6 * best / args.batch, 2),
            "solves_per_sec": round(args.batch / best, 1),
            "compile_s": round(compile_s, 1),
        })
        print(json.dumps(rows[-1]), file=sys.stderr)

    print(json.dumps({
        "metric": "problem_size_scaling",
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
        "batch": args.batch,
        "points": rows,
    }))


if __name__ == "__main__":
    main()
