"""Cross-device quality-distribution gate.

Per-scene outcomes are fp-path-dependent (the early-stop threshold 1e-3 sits
below cross-path f32 noise ~5e-3, see CLAUDE.md), so two fp paths must be
compared DISTRIBUTIONALLY: run the same random scenario batch through the
fleet engine on each named device platform and compare converged fraction
and the final-cost distribution against the first.  ``--devices cpu,gpu``
gates the GPU against the plain reference (the same engine at
Precision.HIGHEST on the host CPU).

Usage:  python benchmarks/quality.py [--batch 32768] [--devices cpu,gpu]
Prints one JSON line per device plus a verdict line.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import jax
import jax.numpy as jnp

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import fleet
from irm_motion_planning_tpu.utils import compile_cache


def summarize(cfg, basis, scns, res):
    """Per-lane unpenalized quality from a fleet SolveResult: blended
    obstacle cost under both lambda extremes (the reference's final report,
    ref: main.py:141-143) + endpoint error + converged fraction."""
    pen0 = mp.Penalty(jnp.float32(0), jnp.float32(0))
    avg_cfg = cfg.replace(lambda_max_cost=0.0)
    max_cfg = cfg.replace(lambda_max_cost=1.0)

    @jax.jit
    def lane_stats(alpha, scn):
        avg = mp.total_cost(avg_cfg, basis, scn, pen0, alpha)
        mx = mp.total_cost(max_cfg, basis, scn, pen0, alpha)
        rep = mp.constraint_report(cfg, basis, scn, alpha)
        err = jnp.maximum(rep["start_pos_err"], rep["goal_pos_err"])
        return avg, mx, err

    avg, mx, err = jax.vmap(lane_stats)(res.alpha, scns)
    conv = res.stats.converged
    # Certification of the converged flags: re-evaluate every lane's final
    # alpha EXACTLY (fleet_evaluate from alpha — the reference's constraint
    # protocol, ref trajectory.py:129-137) and count phantom convergences
    # (flag set, exact check violated).
    ok_exact = jax.jit(fleet.fleet_constraints, static_argnums=0)(
        cfg, basis, fleet.to_fleet(scns), fleet.alpha_to_fleet(res.alpha)
    )
    phantom = jnp.logical_and(conv, jnp.logical_not(ok_exact))
    q = lambda x, p: float(jnp.percentile(x, p))
    return {
        "converged_frac": round(float(jnp.mean(conv.astype(jnp.float32))), 4),
        "exact_converged_frac": round(
            float(jnp.mean(ok_exact.astype(jnp.float32))), 4),
        "phantom_frac": round(
            float(jnp.mean(phantom.astype(jnp.float32))), 5),
        "avg_cost_mean": round(float(jnp.mean(avg)), 4),
        "avg_cost_p50": round(q(avg, 50), 4),
        "avg_cost_p90": round(q(avg, 90), 4),
        "max_cost_mean": round(float(jnp.mean(mx)), 4),
        "max_cost_p90": round(q(mx, 90), 4),
        "endpoint_err_p90": round(q(err, 90), 5),
        "mean_inner_steps": round(float(jnp.mean(
            res.stats.inner_iters.astype(jnp.float32))), 1),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--devices", default="cpu,gpu",
                   help="comma-separated device platforms; the first is "
                        "the baseline the others are gated against")
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--inner", type=int, default=15)
    p.add_argument("--schedule", action="store_true",
                   help="use the benchmark's per-round inner schedule "
                        "(config.REFERENCE_INNER_SCHEDULE_*) instead of a "
                        "uniform --inner budget")
    p.add_argument("--ladder-eval", choices=["linearized", "exact"],
                   default="linearized")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tol-conv", type=float, default=0.02,
                   help="max allowed converged-fraction gap vs the first device "
                        "(absolute floor; the effective bound is "
                        "max(tol_conv, 0.15 * base fraction) — boundary-lane "
                        "flips at the sharp eps thresholds scale with the "
                        "converged population).  Convergence = "
                        "hard-constraint satisfaction at eps 0.01 while the "
                        "endpoint-error p90 on random scenes is ~0.03, so "
                        "lanes flip either way under fp-path noise.")
    p.add_argument("--tol-cost", type=float, default=0.01,
                   help="max allowed relative mean-cost gap vs the first device")
    args = p.parse_args()
    compile_cache.enable()

    if args.schedule:
        sched = {"bls": mp.REFERENCE_INNER_SCHEDULE_BLS,
                 "gd": mp.REFERENCE_INNER_SCHEDULE_GD}[args.solver]
        sched_kw = dict(inner_schedule=sched, max_inner_iteration=max(sched))
    else:
        sched_kw = dict(max_inner_iteration=args.inner)
    cfg = mp.PlannerConfig(
        bls_mode="ladder", fixed_iters=True, ladder_eval=args.ladder_eval,
        **sched_kw,
    )
    basis = mp.make_basis(cfg)  # fitted on the host CPU for every device
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(args.seed), args.batch)

    rows = {}
    for i, platform in enumerate(args.devices.split(",")):
        dev = jax.devices(platform)[0]
        basis_d, scns_d = jax.device_put((basis, scns), dev)
        res = jax.block_until_ready(fleet.make_fleet_solver(
            cfg, basis_d, solver=args.solver)(scns_d))
        name = platform if platform not in rows else f"{platform}#{i}"
        rows[name] = summarize(cfg, basis_d, scns_d, res)
        print(json.dumps({"device": name, "kind": dev.device_kind,
                          **rows[name]}), file=sys.stderr)

    names = list(rows)
    base = rows[names[0]]
    ok = True
    # Scale the tolerance with the converged population (boundary-lane flips
    # at the sharp eps thresholds are proportional to it) but cap the scaled
    # term: at high convergence a double-digit-point regression must FAIL.
    conv_bound = max(args.tol_conv, min(0.15 * base["converged_frac"], 0.05))
    for n in names[1:]:
        r = rows[n]
        if abs(r["converged_frac"] - base["converged_frac"]) > conv_bound:
            ok = False
        if abs(r["avg_cost_mean"] - base["avg_cost_mean"]) > (
            args.tol_cost * max(abs(base["avg_cost_mean"]), 1e-6)
        ):
            ok = False
    print(json.dumps({
        "metric": "quality_distribution_gate",
        "batch": args.batch,
        "devices": rows,
        "pass": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
