"""Fleet-engine invariants at tiny budgets: inner schedules, the exact vs
linearized ladder, certified converged flags, frozen lanes, warm starts, and
parity with the vmap engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import batched, fleet

B = 32
SCHEDULES = {"bls": mp.REFERENCE_INNER_SCHEDULE_BLS,
             "gd": mp.REFERENCE_INNER_SCHEDULE_GD}


def _scheduled(cfg, solver, rounds=10):
    """cfg with the benchmark's per-round schedule cut to ``rounds``: the
    budget at which random scenes actually converge."""
    sched = SCHEDULES[solver][:rounds]
    return cfg.replace(inner_schedule=sched, max_inner_iteration=max(sched),
                       max_outer_iteration=rounds)


@pytest.fixture(scope="module")
def setup():
    cfg = mp.PlannerConfig(max_inner_iteration=6, max_outer_iteration=2,
                           fixed_iters=True)
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(9), B)
    return cfg, basis, scns


def _solve(cfg, basis, scns, solver="bls", alpha0=None):
    return jax.jit(
        lambda b, s, a: fleet.fleet_solve(cfg, b, s, alpha0=a, solver=solver)
    )(basis, scns, alpha0)


def _assert_equal(r_a, r_b):
    for a, b in zip(jax.tree_util.tree_leaves(r_a),
                    jax.tree_util.tree_leaves(r_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_inner_schedule_bounds_each_round(setup, solver):
    """A per-round schedule caps every round at its own budget: no lane
    exceeds the schedule's sum, the budget actually binds, and a schedule
    equal to the uniform cap is the uniform solve bitwise."""
    cfg, basis, scns = setup
    uniform = _solve(cfg, basis, scns, solver)
    _assert_equal(
        _solve(cfg.replace(inner_schedule=(6, 6)), basis, scns, solver),
        uniform)
    sched = _solve(cfg.replace(inner_schedule=(2, 1)), basis, scns, solver)
    iters = np.asarray(sched.stats.inner_iters)
    assert iters.max() <= 3
    assert iters.sum() < np.asarray(uniform.stats.inner_iters).sum()


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_inner_schedule_ignored_under_early_exit(setup, solver):
    """config contract: inner_schedule applies only with fixed_iters=True;
    the early-exit while_loop self-schedules."""
    cfg, basis, scns = setup
    cfg = cfg.replace(fixed_iters=False)
    _assert_equal(
        _solve(cfg.replace(inner_schedule=(1, 1)), basis, scns, solver),
        _solve(cfg, basis, scns, solver))


def test_exact_ladder_close_to_linearized(setup):
    """ladder_eval='exact' (per-rung basis GEMMs) and 'linearized' (affine
    combination of two evaluations) are the same line search in real
    arithmetic: final costs agree to fp-path tolerance (step counts may not:
    the 1e-3 plateau stop sits below the cross-path fp noise)."""
    cfg, basis, scns = setup
    lin = _solve(cfg, basis, scns)
    ex = _solve(cfg.replace(ladder_eval="exact"), basis, scns)
    pen = mp.initial_penalty(cfg)
    cost = jax.vmap(lambda s, a: mp.total_cost(cfg, basis, s, pen, a))
    c_lin, c_ex = np.asarray(cost(scns, lin.alpha)), np.asarray(cost(scns, ex.alpha))
    gap = np.abs(c_lin - c_ex) / np.abs(c_ex)
    assert np.median(gap) < 1e-2 and gap.max() < 5e-2, gap


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_converged_flags_certified_by_exact_evaluation(setup, solver):
    """A converged flag means the reference's thing: the hard constraints
    hold on the exactly-evaluated final trajectory (ref:
    trajectory.py:129-137).  Zero phantom convergences at the solve's own
    batch width, and at least one lane converged to certify."""
    cfg, basis, scns = setup
    cfg = _scheduled(cfg, solver)
    res = _solve(cfg, basis, scns, solver)
    ok_exact = np.asarray(fleet.fleet_constraints(
        cfg, basis, fleet.to_fleet(scns), fleet.alpha_to_fleet(res.alpha)))
    conv = np.asarray(res.stats.converged)
    assert conv.any(), "budget too small: no converged lanes to certify"
    np.testing.assert_array_equal(conv & ~ok_exact, False)


def test_frozen_lanes_pass_through(setup):
    """A lane fulfilled after round r is frozen: more penalty rounds leave
    its alpha, counters and final cost bitwise unchanged."""
    cfg, basis, scns = setup
    short = _solve(_scheduled(cfg, "bls", 5), basis, scns)
    longer = _solve(_scheduled(cfg, "bls", 10), basis, scns)
    done = np.asarray(short.stats.converged)
    assert done.any()
    for a, b in zip(jax.tree_util.tree_leaves(short),
                    jax.tree_util.tree_leaves(longer)):
        np.testing.assert_array_equal(np.asarray(a)[done], np.asarray(b)[done])


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_warm_start_honoured(setup, solver):
    """alpha0 is the solve's starting point: passing the smoothstep init
    explicitly reproduces the default solve (to fp-path tolerance: the init
    is fused differently outside the solve), and restarting from a solve's
    own result needs fewer accepted steps than the cold start."""
    cfg, basis, scns = setup
    cold = _solve(cfg, basis, scns, solver)
    init = jax.jit(lambda b, s: fleet.alpha_from_fleet(
        fleet.fleet_init_alpha(cfg, b, fleet.to_fleet(s))))(basis, scns)
    explicit = _solve(cfg, basis, scns, solver, init)
    pen = mp.initial_penalty(cfg)
    cost = jax.vmap(lambda s, a: mp.total_cost(cfg, basis, s, pen, a))
    c_cold = np.asarray(cost(scns, cold.alpha))
    c_explicit = np.asarray(cost(scns, explicit.alpha))
    assert np.median(np.abs(c_explicit - c_cold) / np.abs(c_cold)) < 1e-3
    warm = _solve(cfg, basis, scns, solver, cold.alpha)
    assert (np.asarray(warm.stats.inner_iters).sum()
            < np.asarray(cold.stats.inner_iters).sum())


def test_gd_quality_matches_vmap(setup):
    """GD has no line search, so the fleet and vmap engines run the same
    steps in different layouts: final costs agree to fp-path tolerance."""
    cfg, basis, scns = setup
    ref = batched.make_batched_solver(cfg, basis, solver="gd")(scns)
    res = fleet.make_fleet_solver(cfg, basis, solver="gd")(scns)
    pen = mp.initial_penalty(cfg)
    cost = jax.vmap(lambda s, a: mp.total_cost(cfg, basis, s, pen, a))
    c_ref, c_res = np.asarray(cost(scns, ref.alpha)), np.asarray(cost(scns, res.alpha))
    np.testing.assert_allclose(c_res, c_ref, rtol=5e-2)


def test_single_lane_fleet_matches_wide_fleet_lane(setup):
    """A one-lane fleet (the single-scene Replanner's path) solves its
    scene like the same lane of a wider fleet, to fp-path tolerance (the
    GEMM width changes the fp path)."""
    cfg, basis, scns = setup
    wide = _solve(cfg, basis, scns)
    one = _solve(cfg, basis, jax.tree_util.tree_map(lambda x: x[:1], scns))
    pen = mp.initial_penalty(cfg)
    scn0 = jax.tree_util.tree_map(lambda x: x[0], scns)
    c_wide = float(mp.total_cost(cfg, basis, scn0, pen, wide.alpha[0]))
    c_one = float(mp.total_cost(cfg, basis, scn0, pen, one.alpha[0]))
    assert abs(c_one - c_wide) / abs(c_wide) < 5e-2
    assert jnp.isfinite(one.stats.final_cost).all()
