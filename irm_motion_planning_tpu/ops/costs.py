"""Loss library: the five cost terms, their hand-derived analytical
gradients, and the fused total cost/gradient used by the solvers.

Capability parity with the reference loss stack (ref: trajectory.py:81-297 and
environment.py:32-72), with these changes:

* every function is stateless and vmaps over a scenario batch axis,
* obstacles carry a weight vector (0 = padding) so obstacle count is a
  static bound, never a recompile (see ops/scenario.py),
* ``cost_and_grad`` computes the loss and its analytical gradient in ONE
  forward pass: the reference evaluates ``km @ alpha @ mix`` and the robot FK
  twice per optimizer step — once in compute_trajectory_cost
  (ref: trajectory.py:271-281) and once in compute_trajectory_cost_g
  (ref: trajectory.py:284-297).  Fusing halves the hot-loop matmul and
  transcendental work,
* ``total_cost`` is wrapped in ``jax.custom_vjp`` so autodiff users get the
  analytical gradient too (the reference validated the hand gradients against
  autodiff but never installed them as a VJP).

Gradient derivations match the reference exactly, including its quirks
(argmax subgradient of the max-cost blend, violation-masked limit losses).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PlannerConfig
from ..models import robot
from ..models.rkhs import Basis, evaluate, _precision
from .scenario import Scenario


class Penalty(NamedTuple):
    """Penalty-method multipliers (traced; escalate inside the dual loop,
    ref: optimizer_BLS.py:201-202)."""

    lambda_sg: jnp.ndarray
    lambda_jl: jnp.ndarray


def initial_penalty(cfg: PlannerConfig) -> Penalty:
    return Penalty(
        jnp.float32(cfg.lambda_sg_constraint), jnp.float32(cfg.lambda_jl_constraint)
    )


# ---------------------------------------------------------------------------
# Obstacle (workspace) cost.  Inverse-quadratic repulsion summed over the
# obstacle set (ref: environment.py:32-43):  cost_v[t] = sum_o w_o * 0.8 /
# (0.5 + 0.5 * ||f_t - o||^2).
# ---------------------------------------------------------------------------


def obstacle_cost_v(f: jnp.ndarray, obstacles: jnp.ndarray, weight: jnp.ndarray) -> jnp.ndarray:
    """Per-timestep obstacle cost.  f: (2, T); obstacles: (O, 2); weight: (O,).
    Returns (T,).  (ref: environment.py:32-43, plus padding weights.)"""
    diff = f[:, :, None] - obstacles.T[:, None, :]     # (2, T, O)
    d2 = jnp.sum(jnp.square(diff), axis=0)             # (T, O)
    per = 0.8 / (0.5 + 0.5 * d2)                       # (T, O)
    return jnp.sum(per * weight, axis=1)


def obstacle_cost_vg(
    f: jnp.ndarray, obstacles: jnp.ndarray, weight: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-timestep obstacle cost and its gradient w.r.t. f.
    Returns (cost_v (T,), cost_g (2, T)).  (ref: environment.py:46-58.)"""
    diff = f[:, :, None] - obstacles.T[:, None, :]     # (2, T, O)
    d2 = jnp.sum(jnp.square(diff), axis=0)             # (T, O)
    inv = 1.0 / (0.5 + 0.5 * d2)                       # (T, O)
    per = 0.8 * inv
    cost_v = jnp.sum(per * weight, axis=1)
    # d per / d f = -0.8 * diff / (0.5 + 0.5 d2)^2   (ref: environment.py:57)
    cost_g = jnp.sum((-0.8 * weight) * diff * jnp.square(inv)[None], axis=2)
    return cost_v, cost_g


def blend_weights(cfg: PlannerConfig, cost_v: jnp.ndarray) -> jnp.ndarray:
    """Per-timestep weights of the max/avg blended reduction's gradient:
    lambda_max * onehot(argmax) + (1 - lambda_max)/T (ref: trajectory.py:97-105,
    the argmax subgradient of the max term)."""
    t_len = cost_v.shape[0]
    lam = cfg.lambda_max_cost
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (t_len,), 0) == jnp.argmax(cost_v)
    ).astype(cost_v.dtype)
    return lam * onehot + (1.0 - lam) / t_len


def trajectory_obstacle_cost(
    cfg: PlannerConfig, trajectory: jnp.ndarray, scn: Scenario
) -> jnp.ndarray:
    """Blended obstacle cost of a joint-space trajectory (ref:
    trajectory.py:81-88,113-117): EE rollout -> point costs -> max/avg blend."""
    f = robot.fk(cfg, trajectory)
    cost_v = obstacle_cost_v(f, scn.obstacles, scn.obstacle_weight)
    lam = cfg.lambda_max_cost
    return lam * jnp.max(cost_v) + (1.0 - lam) * jnp.mean(cost_v)


def trajectory_obstacle_cost_g(
    cfg: PlannerConfig, trajectory: jnp.ndarray, scn: Scenario
) -> jnp.ndarray:
    """Gradient of the blended obstacle cost w.r.t. the joint trajectory
    (ref: trajectory.py:91-126): point gradient, argmax/avg blend, then pulled
    back through the workspace Jacobian via einsum."""
    f = robot.fk(cfg, trajectory)
    cost_v, cost_g = obstacle_cost_vg(f, scn.obstacles, scn.obstacle_weight)
    w = blend_weights(cfg, cost_v)                     # (T,)
    jac = robot.jacobian(cfg, trajectory)              # (2, T, J)
    return jnp.einsum("it,itj->tj", w * cost_g, jac, precision=_precision(cfg))


# ---------------------------------------------------------------------------
# Boundary (start/goal) costs (ref: trajectory.py:183-212).
# ---------------------------------------------------------------------------


def start_goal_cost(trajectory, start, goal):
    s, g = trajectory[0], trajectory[-1]
    return 0.5 * jnp.sum(jnp.square(s - start)) + 0.5 * jnp.sum(jnp.square(g - goal))


def start_goal_cost_g(trajectory, start, goal):
    grad = jnp.zeros_like(trajectory)
    grad = grad.at[0].set(trajectory[0] - start)
    return grad.at[-1].set(trajectory[-1] - goal)


def start_goal_velocity_cost(velocity):
    return 0.5 * jnp.sum(jnp.square(velocity[0])) + 0.5 * jnp.sum(
        jnp.square(velocity[-1])
    )


def start_goal_velocity_cost_g(velocity):
    grad = jnp.zeros_like(velocity)
    grad = grad.at[0].set(velocity[0])
    return grad.at[-1].set(velocity[-1])


# ---------------------------------------------------------------------------
# Joint limit costs (ref: trajectory.py:215-268).  Quadratic barrier measured
# from the joint-box center, active only where the trajectory exceeds the
# safety fraction of the limits (violation mask).
# ---------------------------------------------------------------------------


def _joint_pos_stats(cfg: PlannerConfig):
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    return mean, std


def _position_violation_mask(cfg: PlannerConfig, trajectory):
    over = trajectory > cfg.joint_safety_limit * cfg.max_joint_position
    under = trajectory < cfg.joint_safety_limit * cfg.min_joint_position
    return jnp.logical_or(over, under)


def joint_position_limit_cost(cfg: PlannerConfig, trajectory):
    mean, std = _joint_pos_stats(cfg)
    loss = 0.5 * jnp.square((trajectory - mean) / std)
    if cfg.constraint_violating_dependant_loss:
        loss = jnp.where(_position_violation_mask(cfg, trajectory), loss, 0.0)
    return jnp.sum(loss) / cfg.n_timesteps


def joint_position_limit_cost_g(cfg: PlannerConfig, trajectory):
    mean, std = _joint_pos_stats(cfg)
    grad = (trajectory - mean) / (std * std)
    if cfg.constraint_violating_dependant_loss:
        grad = jnp.where(_position_violation_mask(cfg, trajectory), grad, 0.0)
    return grad / cfg.n_timesteps


def _velocity_violation_mask(cfg: PlannerConfig, velocity):
    return jnp.abs(velocity) > cfg.joint_safety_limit * cfg.max_joint_velocity


def joint_velocity_limit_cost(cfg: PlannerConfig, velocity):
    loss = 0.5 * jnp.square(velocity / cfg.max_joint_velocity)
    if cfg.constraint_violating_dependant_loss:
        loss = jnp.where(_velocity_violation_mask(cfg, velocity), loss, 0.0)
    return jnp.sum(loss) / cfg.n_timesteps


def joint_velocity_limit_cost_g(cfg: PlannerConfig, velocity):
    grad = velocity / (cfg.max_joint_velocity**2)
    if cfg.constraint_violating_dependant_loss:
        grad = jnp.where(_velocity_violation_mask(cfg, velocity), grad, 0.0)
    return grad / cfg.n_timesteps


# ---------------------------------------------------------------------------
# Totals (ref: trajectory.py:271-297) and the fused cost+grad.
# ---------------------------------------------------------------------------


def _cost_terms(cfg, scn, penalty, trajectory, velocity):
    toc = trajectory_obstacle_cost(cfg, trajectory, scn)
    sgpc = start_goal_cost(trajectory, scn.start, scn.goal)
    sgvc = start_goal_velocity_cost(velocity)
    jpc = joint_position_limit_cost(cfg, trajectory)
    jvc = joint_velocity_limit_cost(cfg, velocity)
    return toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)


def _raw_total_cost(cfg: PlannerConfig, basis: Basis, scn: Scenario, penalty: Penalty, alpha):
    trajectory, velocity = evaluate(cfg, basis, alpha)
    return _cost_terms(cfg, scn, penalty, trajectory, velocity)


def _chain_to_alpha(cfg: PlannerConfig, basis: Basis, grad_pos, grad_vel):
    """Pull position-space and velocity-space gradients back to alpha-space:
    (km^T @ g_pos + dkm^T @ g_vel) @ mix^T (ref: trajectory.py:295), computed
    as one stacked (T, 2T) x (2T, J) GEMM."""
    prec = _precision(cfg)
    stacked = jnp.concatenate((grad_pos, grad_vel), axis=0)    # (2T, J)
    pulled = jnp.matmul(basis.kv.T, stacked, precision=prec)   # (T, J)
    return jnp.matmul(pulled, basis.mix.T, precision=prec)


def total_cost_grad(
    cfg: PlannerConfig, basis: Basis, scn: Scenario, penalty: Penalty, alpha
) -> jnp.ndarray:
    """Analytical gradient of the total cost w.r.t. alpha
    (ref: trajectory.py:284-297)."""
    trajectory, velocity = evaluate(cfg, basis, alpha)
    toc_g = trajectory_obstacle_cost_g(cfg, trajectory, scn)
    sgp_g = start_goal_cost_g(trajectory, scn.start, scn.goal)
    sgv_g = start_goal_velocity_cost_g(velocity)
    jp_g = joint_position_limit_cost_g(cfg, trajectory)
    jv_g = joint_velocity_limit_cost_g(cfg, velocity)
    grad_pos = toc_g + penalty.lambda_sg * sgp_g + penalty.lambda_jl * jp_g
    grad_vel = penalty.lambda_sg * sgv_g + penalty.lambda_jl * jv_g
    return _chain_to_alpha(cfg, basis, grad_pos, grad_vel)


def cost_and_grad(
    cfg: PlannerConfig, basis: Basis, scn: Scenario, penalty: Penalty, alpha
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused total cost + analytical gradient, sharing one forward pass
    (basis GEMM, FK rollout, obstacle distance field).  This is the hot
    function of every solver step."""
    trajectory, velocity = evaluate(cfg, basis, alpha)

    # Obstacle term: share distances between value and gradient.
    f = robot.fk(cfg, trajectory)
    cost_v, cost_g = obstacle_cost_vg(f, scn.obstacles, scn.obstacle_weight)
    lam = cfg.lambda_max_cost
    toc = lam * jnp.max(cost_v) + (1.0 - lam) * jnp.mean(cost_v)
    w = blend_weights(cfg, cost_v)
    jac = robot.jacobian(cfg, trajectory)
    toc_g = jnp.einsum("it,itj->tj", w * cost_g, jac, precision=_precision(cfg))

    sgpc = start_goal_cost(trajectory, scn.start, scn.goal)
    sgvc = start_goal_velocity_cost(velocity)
    jpc = joint_position_limit_cost(cfg, trajectory)
    jvc = joint_velocity_limit_cost(cfg, velocity)
    cost = toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)

    sgp_g = start_goal_cost_g(trajectory, scn.start, scn.goal)
    sgv_g = start_goal_velocity_cost_g(velocity)
    jp_g = joint_position_limit_cost_g(cfg, trajectory)
    jv_g = joint_velocity_limit_cost_g(cfg, velocity)
    grad_pos = toc_g + penalty.lambda_sg * sgp_g + penalty.lambda_jl * jp_g
    grad_vel = penalty.lambda_sg * sgv_g + penalty.lambda_jl * jv_g
    return cost, _chain_to_alpha(cfg, basis, grad_pos, grad_vel)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _total_cost_vjp(cfg: PlannerConfig, basis, scn, penalty, alpha):
    return _raw_total_cost(cfg, basis, scn, penalty, alpha)


def _total_cost_fwd(cfg, basis, scn, penalty, alpha):
    return _raw_total_cost(cfg, basis, scn, penalty, alpha), (basis, scn, penalty, alpha)


def _total_cost_bwd(cfg, res, g):
    # Gradient is only supported (and only meaningful for the solvers)
    # w.r.t. alpha; basis/scenario/penalty cotangents are reported as zero.
    basis, scn, penalty, alpha = res
    grad = total_cost_grad(cfg, basis, scn, penalty, alpha)
    zero = jax.tree_util.tree_map(jnp.zeros_like, (basis, scn, penalty))
    return (*zero, g * grad)


_total_cost_vjp.defvjp(_total_cost_fwd, _total_cost_bwd)


def total_cost(
    cfg: PlannerConfig, basis: Basis, scn: Scenario, penalty: Penalty, alpha
) -> jnp.ndarray:
    """Total penalized trajectory cost (ref: trajectory.py:271-281).

    Differentiable: ``jax.grad`` of this function returns the hand-derived
    analytical gradient (custom VJP), preserving the reference's
    analytical-gradient speed advantage under autodiff.
    """
    return _total_cost_vjp(cfg, basis, scn, penalty, alpha)


def total_cost_autodiff_only(
    cfg: PlannerConfig, basis: Basis, scn: Scenario, penalty: Penalty, alpha
) -> jnp.ndarray:
    """The raw cost WITHOUT the custom VJP — test oracle for gradient checks
    (the reference validated analytic gradients against jax.grad the same way,
    ref: DevBlog blog-post.html:278)."""
    return _raw_total_cost(cfg, basis, scn, penalty, alpha)


# ---------------------------------------------------------------------------
# Constraint checking (ref: trajectory.py:129-180).
# ---------------------------------------------------------------------------


def constraints_fulfilled(
    cfg: PlannerConfig, basis: Basis, scn: Scenario, alpha
) -> jnp.ndarray:
    """Boolean: all four hard constraints satisfied (ref: trajectory.py:129-137)."""
    trajectory, velocity = evaluate(cfg, basis, alpha)
    return jnp.logical_and(
        robot.start_goal_position_ok(
            cfg, trajectory[0], trajectory[-1], scn.start, scn.goal
        ),
        jnp.logical_and(
            robot.start_goal_velocity_ok(cfg, velocity[0], velocity[-1]),
            jnp.logical_and(
                robot.joint_position_ok(cfg, trajectory),
                robot.joint_velocity_ok(cfg, velocity),
            ),
        ),
    )


def solution_quality(cfg: PlannerConfig, basis: Basis, scn: Scenario, alpha) -> dict:
    """The reference's final quality readout (ref: main.py:141-143) as one
    helper: unpenalized obstacle cost under both lambda_max extremes plus
    the worst endpoint error.  Shared by every quality gate (bench.py,
    chip_smoke.py, tests/test_parity.py) so they can never drift apart;
    compare against config.REFERENCE_FINAL_COST."""
    pen0 = Penalty(jnp.float32(0), jnp.float32(0))
    avg = total_cost(cfg.replace(lambda_max_cost=0.0), basis, scn, pen0, alpha)
    mx = total_cost(cfg.replace(lambda_max_cost=1.0), basis, scn, pen0, alpha)
    rep = constraint_report(cfg, basis, scn, alpha)
    return {
        "avg_cost": avg,
        "max_cost": mx,
        "endpoint_err": jnp.maximum(rep["start_pos_err"], rep["goal_pos_err"]),
    }


def constraint_report(cfg: PlannerConfig, basis: Basis, scn: Scenario, alpha) -> dict:
    """Per-constraint diagnostics with measured norms — the capability of the
    reference's verbose check (ref: trajectory.py:140-180), returned as a dict
    (jit-friendly) instead of prints."""
    trajectory, velocity = evaluate(cfg, basis, alpha)
    return {
        "start_pos_err": jnp.linalg.norm(trajectory[0] - scn.start),
        "goal_pos_err": jnp.linalg.norm(trajectory[-1] - scn.goal),
        "start_vel": jnp.linalg.norm(velocity[0]),
        "goal_vel": jnp.linalg.norm(velocity[-1]),
        "traj_max": trajectory.max(),
        "traj_min": trajectory.min(),
        "vel_abs_max": jnp.abs(velocity).max(),
        "pos_ok": robot.start_goal_position_ok(
            cfg, trajectory[0], trajectory[-1], scn.start, scn.goal
        ),
        "vel_ok": robot.start_goal_velocity_ok(cfg, velocity[0], velocity[-1]),
        "limit_ok": robot.joint_position_ok(cfg, trajectory),
        "vel_limit_ok": robot.joint_velocity_ok(cfg, velocity),
        "all_ok": constraints_fulfilled(cfg, basis, scn, alpha),
    }
