"""Decompose the fleet solve's wall time into its pipeline stages on the
default device: layout transposes, the smoothstep init, the solver itself,
and the output transpose.  Guides optimization — run on the GPU.

Usage: python benchmarks/decompose.py [--batch 32768]
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


def timeit(fn, *args, repeats=5):
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--inner", type=int, default=15)
    args = p.parse_args()
    compile_cache.enable()

    cfg = mp.PlannerConfig(
        bls_mode="ladder", fixed_iters=True, max_inner_iteration=args.inner
    )
    basis = mp.make_basis(cfg)
    scns = mp.replicate_scenario(mp.reference_scenario(cfg), args.batch)

    to_fleet = jax.jit(fleet.to_fleet)
    t_layout, fs = timeit(to_fleet, scns)

    # basis passed as a traced argument, not a closure constant.
    init = jax.jit(lambda b, f: fleet.fleet_init_alpha(cfg, b, f))
    t_init, a0 = timeit(init, basis, fs)

    solve_from_a0 = jax.jit(
        lambda b, f, a: fleet.fleet_solve(
            cfg, b, scns, alpha0=fleet.alpha_from_fleet(a),
            solver="bls",
        )
    )
    # NOTE: alpha_from_fleet then alpha_to_fleet inside — measures the
    # public path minus init.
    t_solve, _ = timeit(solve_from_a0, basis, fs, a0)

    full = fleet.make_fleet_solver(cfg, basis)
    t_full, _ = timeit(full, scns)

    print(json.dumps({
        "metric": "fleet_solve_decomposition",
        "batch": args.batch,
        "device": jax.devices()[0].device_kind,
        "layout_ms": round(t_layout * 1e3, 2),
        "init_ms": round(t_init * 1e3, 2),
        "solve_minus_init_ms": round(t_solve * 1e3, 2),
        "full_ms": round(t_full * 1e3, 2),
    }))


if __name__ == "__main__":
    main()
