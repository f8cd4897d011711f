"""Fleet-solver tests: the batch-trailing layout must agree with the
vmap engine (math identity checked exactly at the op level; whole-solve
quality within fp-path tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops import costs
from irm_motion_planning_tpu.solvers import batched, fleet


@pytest.fixture(scope="module")
def setup():
    cfg = mp.PlannerConfig(max_inner_iteration=30, max_outer_iteration=3)
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(0), 8)
    return cfg, basis, scns


def test_layout_roundtrip(setup):
    cfg, basis, scns = setup
    fs = fleet.to_fleet(scns)
    assert fs.start.shape == (cfg.n_joints, 8)
    assert fs.obstacles.shape == (cfg.max_obstacles, 2, 8)
    a = jax.random.normal(jax.random.PRNGKey(1), (8, cfg.n_timesteps, cfg.n_joints))
    np.testing.assert_array_equal(
        np.asarray(fleet.alpha_from_fleet(fleet.alpha_to_fleet(a))), np.asarray(a)
    )


def test_fleet_ops_match_reference_ops(setup):
    """Cost and gradient in the trailing-batch layout must equal the
    single-scenario ops lane by lane (same math, different layout).

    Caveats that shape the tolerances:
    * the smoothstep-fit alpha has O(1e4) entries cancelling to O(1) in
      km @ alpha, so layout-level GEMM tiling noise is amplified ~1e4x —
      the check therefore uses a well-conditioned random alpha,
    * the max-cost argmax subgradient is discontinuous under near-ties, so
      the gradient check uses lambda_max_cost=0 (continuous); the cost
      itself is continuous and checked with the default blend."""
    cfg, basis, scns = setup
    fs = fleet.to_fleet(scns)
    a = 0.05 * jax.random.normal(
        jax.random.PRNGKey(5), (8, cfg.n_timesteps, cfg.n_joints)
    )
    fa = fleet.alpha_to_fleet(a)
    pen_b = costs.Penalty(
        jnp.full((8,), cfg.lambda_sg_constraint, jnp.float32),
        jnp.full((8,), cfg.lambda_jl_constraint, jnp.float32),
    )
    pen = mp.initial_penalty(cfg)
    cfg_avg = cfg.replace(lambda_max_cost=0.0)

    fcost = fleet.fleet_cost(cfg, basis, fs, pen_b, fa)
    _, fgrad = fleet.fleet_cost_and_grad(cfg_avg, basis, fs, pen_b, fa)
    fcons = fleet.fleet_constraints(cfg, basis, fs, fa)
    for i in range(8):
        scn_i = jax.tree_util.tree_map(lambda x: x[i], scns)
        c = mp.total_cost(cfg, basis, scn_i, pen, a[i])
        # different layouts reassociate f32 reductions: ~1e-4 relative noise
        np.testing.assert_allclose(float(fcost[i]), float(c), rtol=1e-3)
        g = mp.total_cost_grad(cfg_avg, basis, scn_i, pen, a[i])
        np.testing.assert_allclose(
            np.asarray(fgrad[..., i]), np.asarray(g), rtol=1e-3, atol=1e-5
        )
        assert bool(fcons[i]) == bool(
            mp.constraints_fulfilled(cfg, basis, scn_i, a[i])
        )


def test_fleet_init_matches_single(setup):
    cfg, basis, scns = setup
    fs = fleet.to_fleet(scns)
    fa = fleet.fleet_init_alpha(cfg, basis, fs)
    a = jax.vmap(lambda s: mp.init_alpha(cfg, basis, s.start, s.goal))(scns)
    # Both inits are f32-LU fits of the same smoothstep line (the fleet
    # engine factors the rank-2 init basis once, the single-scenario path
    # solves per lane); each fits the ideal line to ~3-5e-3, so their
    # pairwise trajectory difference is bounded by the sum of fit errors.
    traj_f, _ = fleet.fleet_evaluate(cfg, basis, fa)
    for i in range(8):
        traj_i, _ = mp.evaluate(cfg, basis, a[i])
        np.testing.assert_allclose(
            np.asarray(traj_f[..., i]), np.asarray(traj_i), atol=2e-2
        )


def test_fleet_solve_quality_matches_vmap(setup):
    cfg, basis, scns = setup
    ref = batched.make_batched_solver(cfg, basis)(scns)
    res = fleet.make_fleet_solver(cfg, basis)(scns)
    pen = mp.initial_penalty(cfg)
    for i in range(8):
        scn_i = jax.tree_util.tree_map(lambda x: x[i], scns)
        cr = float(mp.total_cost(cfg, basis, scn_i, pen, ref.alpha[i]))
        cf = float(mp.total_cost(cfg, basis, scn_i, pen, res.alpha[i]))
        assert abs(cr - cf) / abs(cr) < 7e-2, (i, cr, cf)


def test_fleet_gd(setup):
    cfg, basis, scns = setup
    res = fleet.make_fleet_solver(cfg, basis, solver="gd")(scns)
    assert res.alpha.shape == (8, cfg.n_timesteps, cfg.n_joints)
    assert np.isfinite(np.asarray(res.stats.final_cost)).all()


def test_fleet_reference_scene_parity():
    """On the reference scene the fleet solver must land at reference-quality
    final cost.

    Gate: within 1% (the strict 0.1%/bitwise gate belongs to the parity
    engine, tests/test_parity.py).  The inner-loop stop threshold
    (loop_loss_reduction=1e-3, inherited from the reference) sits below the
    ~5e-3 f32 noise between equally-valid evaluation orders, so per-scene
    outcomes differ slightly by fp path even though engines agree in
    distribution — fleet must not be systematically worse."""
    cfg = mp.PlannerConfig()
    basis = mp.make_basis(cfg)
    scns = mp.replicate_scenario(mp.reference_scenario(cfg), 4)
    res = fleet.make_fleet_solver(cfg, basis)(scns)
    scn = mp.reference_scenario(cfg)
    pen0 = mp.Penalty(jnp.float32(0), jnp.float32(0))
    avg_c = float(
        mp.total_cost(cfg.replace(lambda_max_cost=0.0), basis, scn, pen0, res.alpha[0])
    )
    max_c = float(
        mp.total_cost(cfg.replace(lambda_max_cost=1.0), basis, scn, pen0, res.alpha[0])
    )
    assert avg_c <= 1.6370234 * 1.01
    assert max_c <= 2.1964114 * 1.01
    # and the hard constraints must do at least as well as the reference run
    # (which ends with limits ok, endpoint error ~0.046)
    rep = mp.constraint_report(cfg, basis, scn, res.alpha[0])
    assert bool(rep["limit_ok"]) and bool(rep["vel_limit_ok"])
    assert float(rep["start_pos_err"]) < 0.05
    assert float(rep["goal_pos_err"]) < 0.05


def test_fleet_fixed_iters(setup):
    cfg, basis, scns = setup
    cfg_f = cfg.replace(fixed_iters=True, max_inner_iteration=10)
    res = fleet.make_fleet_solver(cfg_f, basis)(scns)
    assert np.isfinite(np.asarray(res.stats.final_cost)).all()


def test_fleet_rejects_sequential_bls_mode():
    """No flag is silently ignored: the fleet engine is ladder-only and must
    say so (the vmap engine honors bls_mode='sequential')."""
    cfg = mp.PlannerConfig(bls_mode="sequential", fixed_iters=True,
                           max_inner_iteration=2, max_outer_iteration=1)
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(0), 4)
    with pytest.raises(ValueError, match="sequential"):
        fleet.fleet_solve(cfg, basis, scns)
    # GD has no line search; sequential mode is meaningless there and the
    # fleet engine accepts it.
    fleet.fleet_solve(cfg, basis, scns, solver="gd")
