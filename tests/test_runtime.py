"""Tests for the runtime layer: CLI, IO formats, timing harness, plain
(Python-loop) solvers, and the receding-horizon replanner."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import bls, plain
from irm_motion_planning_tpu.solvers.replan import Replanner
from irm_motion_planning_tpu.utils import io as iolib
from irm_motion_planning_tpu.utils import timing


@pytest.fixture(scope="module")
def setup():
    cfg = mp.PlannerConfig(max_inner_iteration=30, max_outer_iteration=3)
    return cfg, mp.make_basis(cfg), mp.reference_scenario(cfg)


def test_io_roundtrip(tmp_path, setup):
    cfg, basis, scn = setup
    alpha = mp.init_alpha(cfg, basis, scn.start, scn.goal)
    path = str(tmp_path / "trajectory_result.txt")
    arr = iolib.save_trajectory_result(path, cfg, basis, alpha)
    assert arr.shape == (cfg.n_timesteps, cfg.n_joints)
    loaded = iolib.load_trajectory_result(path)
    np.testing.assert_allclose(loaded, arr, rtol=1e-6)

    spath = str(tmp_path / "trajectory_series.txt")
    iolib.save_trajectory_series(spath, cfg, basis, [alpha, alpha * 1.1])
    series = iolib.load_trajectory_series(spath, cfg)
    assert series.shape == (2, cfg.n_timesteps, cfg.n_joints)


def test_npz_roundtrip(tmp_path, setup):
    cfg, basis, scn = setup
    res = jax.jit(lambda s: bls.solve(cfg, basis, s))(scn)
    path = str(tmp_path / "solve.npz")
    iolib.save_solve_npz(path, res)
    loaded = iolib.load_solve_npz(path)
    np.testing.assert_array_equal(np.asarray(loaded.alpha), np.asarray(res.alpha))
    assert int(loaded.stats.inner_iters) == int(res.stats.inner_iters)


def test_timing_harness(setup):
    cfg, basis, scn = setup
    fn = jax.jit(lambda s: bls.solve(cfg, basis, s))
    rep = timing.time_fn(lambda: fn(scn), n_measurements=3, n_times=2)
    assert len(rep.per_measurement_ms) == 3
    assert rep.mean_ms > 0 and rep.stddev_ms >= 0
    assert rep.compile_ms >= rep.mean_ms  # first call included compile


def test_plain_solver_matches_jit_quality(setup):
    """Python-loop solver (capability of --jit-loop false) must reach the
    jitted solver's quality on the reference scene."""
    cfg, basis, scn = setup
    r_jit = jax.jit(lambda s: bls.solve(cfg, basis, s))(scn)
    r_plain, series = plain.plain_solve(cfg, basis, scn, solver="bls")
    pen = mp.initial_penalty(cfg)
    c_j = float(mp.total_cost(cfg, basis, scn, pen, r_jit.alpha))
    c_p = float(mp.total_cost(cfg, basis, scn, pen, r_plain.alpha))
    assert abs(c_j - c_p) / abs(c_j) < 5e-2
    assert series is None


def test_plain_solver_records_series(setup):
    cfg, basis, scn = setup
    res, series = plain.plain_solve(
        cfg, basis, scn, solver="gd", record_series=True
    )
    assert series is not None and len(series) >= 2
    assert series[0].shape == (cfg.n_timesteps, cfg.n_joints)


def test_replanner_warm_start_and_moving_obstacles(setup):
    """Receding-horizon loop: moving obstacles, warm-started ticks, no
    recompilation across ticks."""
    cfg, _, scn = setup
    rp = Replanner(cfg, budget_outer=2, budget_inner=15)
    r1 = rp.plan(scn)
    costs = []
    for k in range(3):
        moved = scn._replace(obstacles=scn.obstacles + 0.05 * (k + 1))
        rk = rp.plan(moved)
        pen = mp.initial_penalty(rp.tick_cfg)
        costs.append(float(mp.total_cost(rp.tick_cfg, rp.basis, moved, pen, rk.alpha)))
    assert rp._solve_jit._cache_size() == 1  # no recompiles across ticks
    assert all(np.isfinite(costs))
    # Warm starts are the replanner's reason to exist: replan the FINAL
    # scene once more warm (the carried alpha already solves it) vs a fresh
    # replanner solving the same scene cold from the smoothstep init under
    # the same budget.  The warm tick must converge in strictly fewer inner
    # iterations AND not land on a worse solution.
    moved = scn._replace(obstacles=scn.obstacles + 0.15)
    r_warm = rp.plan(moved)
    rp_cold = Replanner(cfg, budget_outer=2, budget_inner=15)
    r_cold = rp_cold.plan(moved)
    assert int(r_warm.stats.inner_iters) < int(r_cold.stats.inner_iters)
    pen = mp.initial_penalty(rp.tick_cfg)
    c_warm = float(mp.total_cost(rp.tick_cfg, rp.basis, moved, pen, r_warm.alpha))
    c_cold = float(mp.total_cost(rp.tick_cfg, rp_cold.basis, moved, pen, r_cold.alpha))
    assert c_warm < c_cold * 1.02


def test_replanner_batched(setup):
    cfg, _, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=10, batched=True)
    scns = mp.replicate_scenario(scn, 4)
    res = rp.plan(scns)
    assert res.alpha.shape[0] == 4
    res2 = rp.plan(scns)  # warm-started second tick
    assert res2.alpha.shape[0] == 4


def test_replanner_batched_fleet_engine(setup):
    """Production replanning path: the batch-trailing fleet engine."""
    cfg, _, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=10, batched=True,
                   engine="fleet")
    scns = mp.replicate_scenario(scn, 4)
    res = rp.plan(scns)
    assert res.alpha.shape[0] == 4
    res2 = rp.plan(scns)
    assert np.isfinite(np.asarray(res2.stats.final_cost)).all()


def test_replanner_single_scene_fleet_engine(setup):
    """Single-scene low-latency path: a one-lane fleet solve."""
    cfg, _, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=10, engine="fleet")
    r1 = rp.plan(scn)
    assert r1.alpha.shape == (cfg.n_timesteps, cfg.n_joints)
    r2 = rp.plan(scn._replace(obstacles=scn.obstacles + 0.05))
    assert np.isfinite(float(r2.stats.final_cost))


def test_replanner_single_scene_is_a_one_lane_fleet(setup):
    """The single-scene fleet tick solves exactly one lane: no lane pad in
    its program, and the same result as a one-lane fleet_solve."""
    from irm_motion_planning_tpu.solvers import fleet

    cfg, _, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=5, engine="fleet")
    alpha0 = mp.init_alpha(rp.tick_cfg, rp.basis, scn.start, scn.goal)
    hlo = rp._solve_jit.lower(rp.basis, scn, alpha0).as_text()
    assert "x128x" not in hlo and "128x" not in hlo
    tick = rp._solve_jit(rp.basis, scn, alpha0)
    one = jax.jit(lambda b, s, a: fleet.fleet_solve(rp.tick_cfg, b, s, a))(
        rp.basis, jax.tree_util.tree_map(lambda x: x[None], scn), alpha0[None])
    np.testing.assert_allclose(np.asarray(tick.alpha), np.asarray(one.alpha[0]),
                               rtol=1e-5, atol=1e-5)
    assert int(tick.stats.inner_iters) == int(one.stats.inner_iters[0])


def test_replanner_rollout_matches_tick_loop(setup):
    """The on-device lax.scan rollout must replay the host tick loop
    exactly: same engine, same ticks => same final alpha."""
    cfg, _, scn = setup
    ticks = [
        scn._replace(obstacles=scn.obstacles + 0.05 * (k + 1)) for k in range(3)
    ]

    rp_loop = Replanner(cfg, budget_outer=1, budget_inner=8, engine="fleet")
    for t in ticks:
        r_loop = rp_loop.plan(t)

    rp_roll = Replanner(cfg, budget_outer=1, budget_inner=8, engine="fleet")
    scn_ticks = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs, axis=0), *ticks
    )
    final_alpha, stats = rp_roll.plan_rollout(scn_ticks)
    assert stats.final_cost.shape[0] == 3
    np.testing.assert_allclose(
        np.asarray(final_alpha), np.asarray(r_loop.alpha), rtol=2e-5, atol=2e-5
    )


_CLI_ENV = dict(os.environ, JAX_PLATFORMS="cpu", MPLBACKEND="Agg")


def _run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "irm_motion_planning_tpu.cli", "--platform", "cpu"]
        + args,
        cwd=cwd,
        env=dict(_CLI_ENV, PYTHONPATH=os.path.dirname(os.path.dirname(__file__))),
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_cli_single_solve(tmp_path):
    r = _run_cli(["--max-outer-iteration", "2", "--max-inner-iteration", "20"],
                 str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "result cost" in r.stdout
    assert (tmp_path / "trajectory_result.txt").exists()
    arr = np.loadtxt(tmp_path / "trajectory_result.txt")
    assert arr.shape == (50, 3)


def test_cli_batched(tmp_path):
    r = _run_cli(["--batch", "4", "--max-outer-iteration", "1",
                  "--max-inner-iteration", "10"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "batch 4" in r.stdout


def test_cli_plain_loop_with_series(tmp_path):
    r = _run_cli(["--jit-loop", "false", "--extended-vis", "true",
                  "--max-outer-iteration", "1", "--max-inner-iteration", "10",
                  "--optimizer-name", "gd"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "trajectory_series.txt").exists()


def test_cli_rejects_fleet_sequential():
    """--bls-mode sequential + --engine fleet is an explicit error (exit 2),
    not silently-substituted ladder semantics."""
    import subprocess, sys, os
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "irm_motion_planning_tpu.cli",
         "--platform", "cpu", "--batch", "8", "--engine", "fleet",
         "--bls-mode", "sequential", "--max-outer-iteration", "1",
         "--max-inner-iteration", "2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 2
    assert "sequential" in out.stderr


def test_cli_headline_configuration(tmp_path):
    """The exact benchmark configuration must be reproducible from the CLI:
    the headline knobs (--inner-schedule reference, --ladder-eval,
    --max-obstacles) all plumb through to PlannerConfig; on the GPU the same
    flags reproduce bench.py's run."""
    r = _run_cli(
        ["--batch", "8", "--engine", "fleet",
         "--fixed-iters", "true", "--inner-schedule", "reference",
         "--ladder-eval", "linearized", "--max-obstacles", "11"],
        str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "batch 8" in r.stdout
    # the reference-schedule solve must satisfy the hard constraints
    # (test_headline_schedule_quality pins the cost numbers)
    assert "constraint fulfiled True" in r.stdout


def test_cli_rejects_schedule_without_fixed_iters(tmp_path):
    r = _run_cli(["--inner-schedule", "reference"], str(tmp_path))
    assert r.returncode == 2
    assert "--fixed-iters" in r.stderr


def test_cli_vmap_engine_honors_sequential():
    import subprocess, sys, os
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "irm_motion_planning_tpu.cli",
         "--platform", "cpu", "--batch", "4", "--engine", "vmap",
         "--bls-mode", "sequential", "--max-outer-iteration", "1",
         "--max-inner-iteration", "2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
