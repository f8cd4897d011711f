"""Planar n-link arm: forward kinematics, analytical workspace Jacobian,
and constraint predicates.

Capability parity with the reference robot model (ref: robot.py:12-113),
re-designed functionally:

* stateless jit-friendly functions parameterized by the static
  :class:`~irm_motion_planning_tpu.config.PlannerConfig` (link lengths become
  XLA constants),
* generalized to any ``n_joints`` (the reference hardcodes ``reshape(-1, 3)``,
  ref: robot.py:31, so it silently only supports 3 joints),
* batch-friendly: every function maps over a leading time axis and vmaps
  cleanly over a scenario axis.

Layout conventions (match the reference so its downstream math carries over):
  config/trajectory: ``(T, J)`` joint angles per support timestep,
  workspace points:  ``(2, T)``,
  Jacobian:          ``(2, T, J)``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import PlannerConfig
from .rkhs import _precision


def link_lengths(cfg: PlannerConfig) -> jnp.ndarray:
    """Link lengths as an f32 constant vector of shape (J,)."""
    return jnp.asarray(cfg.link_length, dtype=jnp.float32)


def fk(cfg: PlannerConfig, config: jnp.ndarray) -> jnp.ndarray:
    """End-effector position for each timestep.  (ref: robot.py:29-36)

    ``pos = L @ [cos, sin](cumsum(theta))`` — the cumulative joint angle of
    link i is ``theta_1 + ... + theta_i``; the EE is the link-length-weighted
    sum of the unit heading vectors.

    Args:
      config: ``(T, J)`` joint angles.
    Returns:
      ``(2, T)`` EE xy positions.
    """
    c = jnp.cumsum(config.reshape(-1, cfg.n_joints), axis=1)  # (T, J)
    ll = link_lengths(cfg)
    prec = _precision(cfg)
    pos_x = jnp.matmul(jnp.cos(c), ll, precision=prec)  # (T,)
    pos_y = jnp.matmul(jnp.sin(c), ll, precision=prec)
    return jnp.stack((pos_x, pos_y))


def fk_joint(cfg: PlannerConfig, config: jnp.ndarray, joint_id: int) -> jnp.ndarray:
    """Position of joint ``joint_id`` (1-based, as in the reference's
    fk_joint_1/2/3, ref: robot.py:39-72) for each timestep.  Returns (2, T)."""
    c = jnp.cumsum(config.reshape(-1, cfg.n_joints)[:, :joint_id], axis=1)
    ll = link_lengths(cfg)[:joint_id]
    prec = _precision(cfg)
    return jnp.stack((jnp.matmul(jnp.cos(c), ll, precision=prec),
                      jnp.matmul(jnp.sin(c), ll, precision=prec)))


def fk_all_joints(cfg: PlannerConfig, config: jnp.ndarray) -> jnp.ndarray:
    """Positions of every joint frame, vectorized (one cumsum instead of the
    reference's per-joint re-evaluation).  Returns ``(J, 2, T)`` where entry
    ``[k]`` is the position of joint k+1 (tip of link k+1)."""
    c = jnp.cumsum(config.reshape(-1, cfg.n_joints), axis=1)  # (T, J)
    ll = link_lengths(cfg)
    seg = jnp.stack((jnp.cos(c) * ll, jnp.sin(c) * ll))       # (2, T, J)
    tips = jnp.cumsum(seg, axis=2)                            # (2, T, J)
    return jnp.moveaxis(tips, 2, 0)                           # (J, 2, T)


def jacobian(cfg: PlannerConfig, config: jnp.ndarray) -> jnp.ndarray:
    """Analytical workspace Jacobian d(EE)/d(theta_j) per timestep.
    (ref: robot.py:75-87 — the reverse-cumsum trick)

    ``dpos/dtheta_j = sum_{i>=j} L_i * [-sin, cos](cumangle_i)``.

    Returns ``(2, T, J)``.
    """
    c = jnp.cumsum(config.reshape(-1, cfg.n_joints), axis=1)
    ll = link_lengths(cfg)
    x = -ll * jnp.sin(c)  # (T, J)
    y = ll * jnp.cos(c)
    # reverse cumulative sum over joints: rc[j] = sum_{i>=j} v[i]
    rcx = x + jnp.sum(x, axis=1, keepdims=True) - jnp.cumsum(x, axis=1)
    rcy = y + jnp.sum(y, axis=1, keepdims=True) - jnp.cumsum(y, axis=1)
    return jnp.stack((rcx, rcy))


# --- Constraint predicates (ref: robot.py:90-113) ---


def start_goal_position_ok(cfg: PlannerConfig, s, g, start_config, goal_config):
    start_ok = jnp.linalg.norm(s - start_config) < cfg.eps_position
    goal_ok = jnp.linalg.norm(g - goal_config) < cfg.eps_position
    return jnp.logical_and(start_ok, goal_ok)


def start_goal_velocity_ok(cfg: PlannerConfig, vs, vg):
    start_ok = jnp.linalg.norm(vs) < cfg.eps_velocity
    goal_ok = jnp.linalg.norm(vg) < cfg.eps_velocity
    return jnp.logical_and(start_ok, goal_ok)


def joint_position_ok(cfg: PlannerConfig, trajectory):
    return jnp.logical_and(
        trajectory.max() <= cfg.max_joint_position,
        trajectory.min() >= cfg.min_joint_position,
    )


def joint_velocity_ok(cfg: PlannerConfig, joint_velocity):
    return jnp.abs(joint_velocity).max() <= cfg.max_joint_velocity
