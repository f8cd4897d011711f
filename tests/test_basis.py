"""Unit tests for the RKHS basis (models/rkhs.py).

The reference has no tests; this suite implements the validation the
reference did informally (ref: DevBlog blog-post.html:278) plus structural
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.models import rkhs


@pytest.fixture(scope="module")
def setup():
    cfg = mp.PlannerConfig()
    return cfg, mp.make_basis(cfg)


def test_kernel_matrix_structure(setup):
    cfg, basis = setup
    T = cfg.n_timesteps
    assert basis.km.shape == (T, T)
    # RBF Gram matrix: symmetric, unit diagonal, entries in (0, 1].
    np.testing.assert_allclose(basis.km, basis.km.T, atol=0)
    np.testing.assert_allclose(np.diag(basis.km), 1.0, atol=0)
    assert (basis.km > 0).all() and (basis.km <= 1).all()
    # Derivative kernel: antisymmetric with zero diagonal.
    np.testing.assert_allclose(basis.dkm, -basis.dkm.T, atol=0)
    np.testing.assert_allclose(np.diag(basis.dkm), 0.0, atol=0)
    # Stacked operator is exactly [km; dkm].
    np.testing.assert_array_equal(np.asarray(basis.kv[:T]), np.asarray(basis.km))
    np.testing.assert_array_equal(np.asarray(basis.kv[T:]), np.asarray(basis.dkm))


def test_kernel_values_match_formula(setup):
    cfg, basis = setup
    t = np.linspace(0, 1, cfg.n_timesteps, dtype=np.float32)
    i, j = 3, 17
    expect = np.exp(-((t[i] - t[j]) ** 2) / (2 * cfg.rbf_variance**2))
    np.testing.assert_allclose(basis.km[i, j], expect, rtol=1e-6)
    d_expect = (t[j] - t[i]) / cfg.rbf_variance**2 * expect
    np.testing.assert_allclose(basis.dkm[i, j], d_expect, rtol=1e-5)


def test_dkm_is_time_derivative_of_km(setup):
    """dkm rows must be d/dt of the kernel row — check via finite differences
    of evaluate_at over a smooth alpha."""
    cfg, basis = setup
    key = jax.random.PRNGKey(1)
    alpha = 0.01 * jax.random.normal(key, (cfg.n_timesteps, cfg.n_joints))
    ts = jnp.linspace(0.1, 0.9, 7)
    eps = 1e-3
    pos_p, _ = rkhs.evaluate_at(cfg, basis, alpha, ts + eps)
    pos_m, _ = rkhs.evaluate_at(cfg, basis, alpha, ts - eps)
    _, vel = rkhs.evaluate_at(cfg, basis, alpha, ts)
    fd = (pos_p - pos_m) / (2 * eps)
    np.testing.assert_allclose(np.asarray(vel), np.asarray(fd), rtol=2e-2, atol=2e-3)


def test_smoothstep_boundary_conditions(setup):
    cfg, basis = setup
    c = np.asarray(basis.c)
    assert c[0] == 0.0 and abs(c[-1] - 1.0) < 1e-6
    # c'(0) = c'(1) = 0 via finite differences on a fine grid
    t = np.linspace(0, 1, 1001)
    cf = 6 * t**5 - 15 * t**4 + 10 * t**3
    assert abs(cf[1] - cf[0]) < 1e-8 and abs(cf[-1] - cf[-2]) < 1e-8


def test_mixing_matrix_reproducible(setup):
    cfg, basis = setup
    expect = jnp.eye(3) + cfg.mix_scale * jax.random.normal(
        jax.random.PRNGKey(0), (3, 3)
    )
    np.testing.assert_array_equal(np.asarray(basis.mix), np.asarray(expect))
    np.testing.assert_allclose(
        np.asarray(basis.mix @ basis.mix_inv), np.eye(3), atol=1e-6
    )


def test_init_alpha_hits_endpoints(setup):
    """The smoothstep fit must interpolate start and goal with near-zero
    boundary velocity (that's the point of the quintic, ref: trajectory.py:37)."""
    cfg, basis = setup
    scn = mp.reference_scenario(cfg)
    alpha = mp.init_alpha(cfg, basis, scn.start, scn.goal)
    traj, vel = mp.evaluate(cfg, basis, alpha)
    np.testing.assert_allclose(np.asarray(traj[0]), np.asarray(scn.start), atol=5e-3)
    np.testing.assert_allclose(np.asarray(traj[-1]), np.asarray(scn.goal), atol=5e-3)
    assert float(jnp.abs(vel[0]).max()) < 0.2
    assert float(jnp.abs(vel[-1]).max()) < 0.2


def test_evaluate_at_support_matches_evaluate(setup):
    cfg, basis = setup
    scn = mp.reference_scenario(cfg)
    alpha = mp.init_alpha(cfg, basis, scn.start, scn.goal)
    traj, vel = mp.evaluate(cfg, basis, alpha)
    traj2, vel2 = rkhs.evaluate_at(cfg, basis, alpha, basis.t)
    # Same Gram values at support points: results agree to fp tolerance.
    np.testing.assert_allclose(np.asarray(traj), np.asarray(traj2), atol=1e-3)
    np.testing.assert_allclose(np.asarray(vel), np.asarray(vel2), atol=2e-2)


def test_generalized_joint_count():
    """The engine must support arbitrary n_joints (the reference hardcodes 3,
    ref: robot.py:31)."""
    cfg = mp.PlannerConfig(
        n_joints=5, link_length=(1.0, 0.8, 0.6, 0.4, 0.2), n_timesteps=30
    )
    basis = mp.make_basis(cfg)
    assert basis.mix.shape == (5, 5)
    start = jnp.zeros(5)
    goal = jnp.ones(5) * 0.5
    alpha = mp.init_alpha(cfg, basis, start, goal)
    assert alpha.shape == (30, 5)
    traj, _ = mp.evaluate(cfg, basis, alpha)
    np.testing.assert_allclose(np.asarray(traj[-1]), 0.5, atol=1e-2)


def test_make_basis_fits_on_the_host_cpu(setup, monkeypatch):
    """The fit runs on the host CPU whatever the default device is; the
    basis then lands on the default device, uncommitted, bitwise equal."""
    cfg, basis = setup
    seen = []
    fit = rkhs.fit_basis

    def spy(c):
        seen.append(jax.config.jax_default_device)
        return fit(c)

    monkeypatch.setattr(rkhs, "fit_basis", spy)
    dev = jax.devices()[3]
    with jax.default_device(dev):
        placed = mp.make_basis(cfg)
    assert seen == [jax.local_devices(backend="cpu")[0]]
    for a, b in zip(placed, basis):
        assert a.devices() == {dev} and not a.committed
        np.testing.assert_array_equal(a, b)
