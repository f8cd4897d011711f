"""Bring-up smoke test on the GPU: the planner's main paths once, at full size, gated.

    python chip_smoke.py                # one card: every single-card phase
    python chip_smoke.py --four-cards   # four cards: the sharded fleet only

Everything runs in this one process: the CLI and bench.py are called
in-process, so no second JAX process ever opens the card.  Each phase drives
a user entry point at deployment scale and checks its output by the repo's
own gates (bench.py's reference-scene and paired same-scenes gates); a
phase that raises or misses its gate fails the run.  Timings are printed
for information beside the card's name and power limit; nothing is claimed.

The last line of standard output is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``; the exit code is 0
only when every phase passed on a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import bench
import irm_motion_planning_tpu as mp
from benchmarks.replan import drift_obstacles
from irm_motion_planning_tpu import cli
from irm_motion_planning_tpu.parallel import mesh as meshlib
from irm_motion_planning_tpu.parallel import sharded
from irm_motion_planning_tpu.solvers import fleet
from irm_motion_planning_tpu.solvers.replan import Replanner
from irm_motion_planning_tpu.utils import compile_cache

REQUIRED_PLATFORM = "gpu"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Lanes and ticks of each phase.  The defaults are deployment scale on
    one H100 80GB; tests pass tiny ones."""

    fleet: int = bench.DEFAULT_BATCH  # reference scene, BLS and GD
    # The exact ladder holds ~80 KB of temporaries per lane (20 GiB at 256k
    # lanes), so the fleet batch would not fit in the 60 GiB JAX reserves.
    exact: int = 524288
    random: int = 32768     # random scenes on the card
    reference: int = 2048   # paired subsample re-solved on the host CPU
    ticks: int = 20         # single-scene replanning ticks
    rollout_arms: int = 1024
    rollout_ticks: int = 10
    cli: int = 4096
    per_card: int = 32768   # --four-cards: random scenes per card


class PhaseFailed(AssertionError):
    """A phase's output missed its gate."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def final_line(ok: bool) -> str:
    return json.dumps({"ok": bool(ok), "device": bench.device_info()})


def card_label(device) -> str:
    """Where a timing was taken: the card and its power limit."""
    if device.platform != "gpu":
        return device.device_kind
    return bench.smi_line()


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# Phases.  Each takes the device it runs on and its sizes, prints what it
# measured, and raises when its gate fails.
# ---------------------------------------------------------------------------


def phase_device(device, sizes: Sizes):
    devs = jax.devices()
    print(f"platform={device.platform} device_kind={device.device_kind} "
          f"device_count={len(devs)}")
    if device.platform == "gpu":
        print(f"nvidia-smi: {bench.smi_line()}")
    check(device.platform == REQUIRED_PLATFORM,
          f"platform {device.platform} is not {REQUIRED_PLATFORM}")


def init_fit_error(cfg, basis) -> float:
    """Max error of the smoothstep warm start's fit to its straight line on
    the reference scene (the ill-conditioned Gram solve, models/rkhs.py)."""
    scn = mp.reference_scenario(cfg)
    a0 = fleet.fleet_init_alpha(cfg, basis, fleet.to_fleet(
        mp.replicate_scenario(scn, 1)))
    traj, _ = fleet.fleet_evaluate(cfg, basis, a0)
    line = scn.start + (scn.goal - scn.start) * basis.c[:, None]
    return float(jnp.max(jnp.abs(traj[..., 0] - line)))


def reference_scene(device, solver, ladder_eval, batch, timing=True):
    """The bench.py headline protocol on the reference scene, replicated:
    compile, solve, gate lane 0 with bench.reference_gate, and (with
    ``timing``) time one warm solve."""
    with jax.default_device(device):
        cfg = bench.bench_config(solver, ladder_eval)
        basis = mp.make_basis(cfg)
        scns = mp.replicate_scenario(mp.reference_scenario(cfg), batch)
        run, compile_s, mem = bench.compile_solver(
            fleet.make_fleet_solver(cfg, basis, solver=solver), scns)
        out, first_s = bench.timed(run, scns)
        ok, q = bench.reference_gate(cfg, basis, out.alpha[0], solver)
        same = bool(jnp.all(out.alpha == out.alpha[0:1]))
        print(f"  {solver}/{ladder_eval} batch={batch} compile_s={compile_s:.2f} "
              f"first_s={first_s:.3f} temp_bytes={mem.temp_size_in_bytes} "
              f"init_fit_max_err={init_fit_error(cfg, basis):.3e}")
        if timing:
            _, warm_s = bench.timed(run, scns)
            print(f"  warm_solve_s={warm_s:.4f} solves_per_s={batch / warm_s:.1f} "
                  f"[{card_label(device)}; informational]")
        print(f"  peak_bytes_in_use={peak_bytes(device)}")
        print(f"  gate avg={q['avg_cost']:.5f} (ref {q['ref_avg_cost']:.5f}) "
              f"max={q['max_cost']:.5f} (ref {q['ref_max_cost']:.5f}) "
              f"endpoint={q['endpoint_err']:.5f} < {q['endpoint_bound']} "
              f"lanes_identical={same}")
        check(ok, f"{solver}/{ladder_eval} reference-scene gate: {q}")
        check(bool(np.isfinite(np.asarray(out.stats.final_cost)).all()),
              "non-finite final cost")


def phase_bls(device, sizes: Sizes):
    reference_scene(device, "bls", "linearized", sizes.fleet)


def phase_gd(device, sizes: Sizes):
    reference_scene(device, "gd", "linearized", sizes.fleet)


def phase_exact(device, sizes: Sizes):
    reference_scene(device, "bls", "exact", sizes.exact, timing=False)


def phase_random(device, sizes: Sizes):
    """Random scenes on ``device`` against the plain reference: the same
    fleet engine at Precision.HIGHEST on the host CPU, with a basis fitted
    on the CPU, paired on a subsample of the same scenes
    (bench.paired_gate)."""
    with jax.default_device(device):
        cfg = bench.bench_config("bls")
        basis = mp.make_basis(cfg)
        scns = mp.random_scenarios(cfg, jax.random.PRNGKey(0), sizes.random)
        res, solve_s = bench.timed(
            fleet.make_fleet_solver(cfg, basis, solver="bls"), scns)
        t0 = time.perf_counter()
        ok, fields, ref = bench.paired_gate(cfg, basis, scns, res,
                                            sizes.reference)
        ref_s = time.perf_counter() - t0
        # Each side's trajectories through its own basis.
        traj, _ = fleet.fleet_evaluate(cfg, basis, fleet.alpha_to_fleet(
            res.alpha[:sizes.reference]))
        with jax.default_device(jax.devices("cpu")[0]):
            ref_traj, _ = fleet.fleet_evaluate(
                cfg, mp.make_basis(cfg), fleet.alpha_to_fleet(ref.alpha))
        dtraj = float(np.max(np.abs(np.asarray(traj) - np.asarray(ref_traj))))
        print(f"  batch={sizes.random} solve+compile_s={solve_s:.2f} "
              f"paired_lanes={sizes.reference} cpu_reference_s={ref_s:.2f}")
        print("  " + " ".join(f"{k}={v}" for k, v in fields.items()))
        print(f"  max_abs_dtrajectory={dtraj:.4e} (no lane-wise bound: "
              f"per-lane outcomes depend on the fp path)")
        check(bool(np.isfinite(np.asarray(res.stats.final_cost)).all()),
              "non-finite final cost")
        check(ok, f"paired same-scenes gate: {fields}")


def phase_replan(device, sizes: Sizes):
    """Single-scene warm-started replanning against drifting obstacles,
    then an on-device rollout of a fleet of arms."""
    with jax.default_device(device):
        cfg = mp.PlannerConfig(bls_mode="ladder")
        scn = mp.reference_scenario(cfg)
        rp = Replanner(cfg, budget_outer=2, budget_inner=25, engine="fleet")
        jax.block_until_ready(rp.plan(drift_obstacles(scn, 0)))  # compile
        ticks = []
        for k in range(1, sizes.ticks + 1):
            res, dt = bench.timed(rp.plan, drift_obstacles(scn, k))
            check(bool(np.isfinite(np.asarray(res.alpha)).all())
                  and bool(np.isfinite(float(res.stats.final_cost))),
                  f"tick {k} not finite")
            ticks.append(dt)
        print(f"  single-scene ticks={sizes.ticks} median_tick_ms="
              f"{1e3 * float(np.median(ticks)):.3f} "
              f"[{card_label(device)}; informational]")

        fleet_rp = Replanner(cfg, budget_outer=2, budget_inner=25,
                             batched=True, engine="fleet")
        arms = mp.replicate_scenario(scn, sizes.rollout_arms)
        per_tick = [drift_obstacles(arms, k)
                    for k in range(1, sizes.rollout_ticks + 1)]
        scn_ticks = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_tick)
        (alpha, stats), dt = bench.timed(fleet_rp.plan_rollout, scn_ticks)
        print(f"  rollout arms={sizes.rollout_arms} ticks={sizes.rollout_ticks} "
              f"compile+run_s={dt:.2f}")
        check(bool(np.isfinite(np.asarray(alpha)).all())
              and bool(np.isfinite(np.asarray(stats.final_cost)).all()),
              "rollout not finite")


def phase_cli(device, sizes: Sizes):
    """The CLI's fleet path in-process, as a user would run it."""
    with tempfile.TemporaryDirectory() as tmp, jax.default_device(device):
        argv = ["--batch", str(sizes.cli), "--engine", "fleet",
                "--fixed-iters", "true", "--inner-schedule", "reference",
                "--max-obstacles", "11",
                "--output", f"{tmp}/trajectory_result.txt"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out = buf.getvalue()
    print("  python -m irm_motion_planning_tpu.cli " + " ".join(argv[:-2]))
    print("\n".join("  | " + ln for ln in out.strip().splitlines()))
    check(rc == 0, f"cli exit code {rc}")
    check("result cost" in out and "constraint fulfiled" in out,
          "cli printed no cost/constraint report")


def phase_four_cards(device, sizes: Sizes, n_cards: int = 4, solver="bls"):
    """The scenario-sharded fleet (shard_map over a 1-D mesh of the cards)
    against the one-card fleet solve of each shard's scenes."""
    devs = jax.devices()[:n_cards]
    check(len(devs) == n_cards, f"need {n_cards} devices, have {len(devs)}")
    cfg = bench.bench_config(solver)
    basis = mp.make_basis(cfg)
    batch = n_cards * sizes.per_card
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(1), batch)
    mesh = meshlib.make_mesh(devs)
    run = sharded.make_shard_map_solver(cfg, basis, mesh, solver=solver,
                                        engine="fleet")
    (res, stats), dt = bench.timed(run, meshlib.shard_batch(mesh, scns))
    print(f"  mesh={n_cards} x {sizes.per_card} lanes compile+run_s={dt:.2f}")

    # One-card reference: each shard's scenes solved on that shard's card.
    per = sizes.per_card
    parts = []
    for i, d in enumerate(devs):
        shard = jax.tree_util.tree_map(lambda x: x[i * per:(i + 1) * per], scns)
        parts.append(bench.solve_on(d, cfg, basis, shard, solver))
    ref_alpha = np.concatenate([np.asarray(p.alpha) for p in parts])
    ref_conv = np.concatenate([np.asarray(p.stats.converged) for p in parts])
    alpha = np.asarray(res.alpha)
    conv = np.asarray(res.stats.converged)
    equal = float(np.mean(np.all(alpha == ref_alpha, axis=(1, 2))))
    print(f"  lanes_bitwise_equal_to_per_card_solves={equal:.6f}")

    host = {
        "n_total": float(batch),
        "converged_fraction": float(np.mean(conv, dtype=np.float64)),
        "mean_inner_iters": float(np.mean(
            np.asarray(res.stats.inner_iters), dtype=np.float64)),
        "mean_final_cost": float(np.mean(
            np.asarray(res.stats.final_cost), dtype=np.float64)),
        "max_final_cost": float(np.max(np.asarray(res.stats.final_cost))),
    }
    for k, v in host.items():
        got = float(stats[k])
        rel = abs(got - v) / max(abs(v), 1e-30)
        print(f"  psum {k}={got!r} host={v!r} rel_err={rel:.2e}")
        check(rel <= 1e-6, f"psum {k} {got} vs host {v}")

    ok_exact = np.asarray(fleet.fleet_constraints(
        cfg, basis, fleet.to_fleet(scns), fleet.alpha_to_fleet(alpha)))
    phantom = float(np.mean(conv & ~ok_exact))
    ref_scns_cost = bench.unpenalized_costs(cfg, basis, scns, ref_alpha)
    cost = float(jnp.mean(bench.unpenalized_costs(cfg, basis, scns, alpha)))
    ok, fields = bench.paired_bands(
        float(conv.mean()), float(ref_conv.mean()), cost,
        float(jnp.mean(ref_scns_cost)), phantom, batch)
    print("  " + " ".join(f"{k}={v}" for k, v in fields.items()))
    check(ok, f"sharded vs per-card bands: {fields}")


SINGLE_CARD = (
    ("device", phase_device),
    ("reference_bls", phase_bls),
    ("reference_gd", phase_gd),
    ("exact_ladder", phase_exact),
    ("random_vs_cpu_reference", phase_random),
    ("replanning", phase_replan),
    ("cli", phase_cli),
)
FOUR_CARDS = (
    ("device", phase_device),
    ("four_cards", phase_four_cards),
)


def phases_for(four_cards: bool):
    return FOUR_CARDS if four_cards else SINGLE_CARD


def run_phases(phases, device, sizes: Sizes) -> bool:
    """Run every phase; a failure is reported and the next phase runs."""
    ok = True
    for name, fn in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn(device, sizes)
        except Exception as e:  # report every phase, fail the run at the end
            traceback.print_exc()
            print(f"[{name}] FAIL ({time.perf_counter() - t0:.1f}s): "
                  f"{type(e).__name__}: {e}", flush=True)
            ok = False
        else:
            print(f"[{name}] PASS ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
    return ok


def main(argv=None, sizes: Sizes = Sizes()) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card sharded fleet phase and the "
                        "per-card solves it is compared with")
    args = p.parse_args(argv)
    device = jax.devices()[0]
    if device.platform != REQUIRED_PLATFORM:
        print(f"error: JAX found no {REQUIRED_PLATFORM} "
              f"(default device: {device.platform})", file=sys.stderr)
        print(final_line(False))
        return 1
    compile_cache.enable()
    ok = run_phases(phases_for(args.four_cards), device, sizes)
    if device.platform == "gpu":
        print(bench.smi_line())
    print(final_line(ok))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
