"""Fleet solver: the batched engine, laid out for wide GEMMs.

``solvers/batched.py`` (vmap) is semantically clean but maps the basis
contraction to B independent (2T, T) x (T, J) GEMMs with N=3 output
columns.  This module re-lays the whole solve out **batch-trailing**: every
tensor carries the scenario lane as its LAST axis,

    alpha       (T, J, B)
    trajectory  (T, J, B)
    EE points   (2, T, B)
    obstacles   (O, 2, B)
    lane state  (B,)

so the hot contraction becomes ONE GEMM, ``kv (2T, T) @ alpha (T, J*B)``,
with thousands of output columns (B=4096 -> N=12288), and every elementwise
op runs with the lane axis minor (contiguous).  The line-search
ladder adds a trailing candidate axis, folding all Armijo trials of all lanes
into a single (2T, T) x (T, J*B*n) GEMM per inner step.

Semantics are the ladder-BLS / GD semantics of solvers/bls.py / gd.py, lane
exact (per-lane penalties, per-lane freeze masks); results match the vmap
engine to fp-path tolerance (see tests/test_fleet.py).

Reference capability this accelerates: the per-solve optimizer loop
(ref: optimizer_BLS.py:126-213, optimizer_GD.py:172-232) at fleet scale.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import PlannerConfig
from ..models import robot
from ..models.rkhs import Basis, _precision
from ..ops.costs import Penalty
from ..ops.scenario import Scenario
from .common import (
    SolveResult, freeze_when, inner_loop_bound, run_dual_loop,
)


# ---------------------------------------------------------------------------
# Layout transforms: leading-batch (API) <-> trailing-batch (device layout).
# ---------------------------------------------------------------------------


def to_fleet(scns: Scenario) -> Scenario:
    """(B, ...) leaves -> (..., B) leaves."""
    return Scenario(
        start=jnp.moveaxis(scns.start, 0, -1),            # (J, B)
        goal=jnp.moveaxis(scns.goal, 0, -1),              # (J, B)
        obstacles=jnp.moveaxis(scns.obstacles, 0, -1),    # (O, 2, B)
        obstacle_weight=jnp.moveaxis(scns.obstacle_weight, 0, -1),  # (O, B)
    )


def alpha_to_fleet(alpha: jnp.ndarray) -> jnp.ndarray:
    """(B, T, J) -> (T, J, B)."""
    return jnp.moveaxis(alpha, 0, -1)


def alpha_from_fleet(alpha: jnp.ndarray) -> jnp.ndarray:
    """(T, J, B) -> (B, T, J)."""
    return jnp.moveaxis(alpha, -1, 0)


# ---------------------------------------------------------------------------
# Batch-trailing math.
# ---------------------------------------------------------------------------


def fleet_evaluate(cfg, basis: Basis, alpha: jnp.ndarray):
    """alpha (T, J, ...L) -> (traj, vel) each (T, J, ...L) via one stacked
    GEMM.  Trailing lane axes ...L are (B,) or (B, n) for ladder candidates."""
    T, J = alpha.shape[:2]
    lanes = alpha.shape[2:]
    prec = _precision(cfg)
    both = jnp.matmul(
        basis.kv, alpha.reshape(T, -1), precision=prec
    ).reshape((2, T, J) + lanes)
    # mix over the joint axis: out[t, i, ...] = sum_j val[t, j, ...] * mix[j, i]
    both = jnp.einsum("ktj...,ji->kti...", both, basis.mix, precision=prec)
    return both[0], both[1]


def fleet_init_alpha(cfg, basis: Basis, scn: Scenario) -> jnp.ndarray:
    """Smoothstep warm start for every lane (ref: trajectory.py:73-78).

    The fitted system is ``km @ alpha = line @ mix_inv`` with
    ``line = 1 (x) start + c (x) (goal - start)`` — rank 2 along the time
    axis — so with ``init_u = km^-1 1`` and ``init_w = km^-1 c`` factored at
    basis build, the whole-fleet init is two outer products (elementwise, no
    per-solve linear solve)."""
    prec = _precision(cfg)
    sm = jnp.einsum("jb,ji->ib", scn.start, basis.mix_inv, precision=prec)
    dm = jnp.einsum(
        "jb,ji->ib", scn.goal - scn.start, basis.mix_inv, precision=prec
    )
    return (
        basis.init_u[:, None, None] * sm[None]
        + basis.init_w[:, None, None] * dm[None]
    )


def _fk_ee(cfg, traj):
    """traj (T, J, ...L) -> EE (2, T, ...L)."""
    c = jnp.cumsum(traj, axis=1)
    ll = robot.link_lengths(cfg)
    prec = _precision(cfg)
    return jnp.stack(
        (
            jnp.einsum("tj...,j->t...", jnp.cos(c), ll, precision=prec),
            jnp.einsum("tj...,j->t...", jnp.sin(c), ll, precision=prec),
        )
    )


def _fk_ee_and_jac(cfg, traj):
    """traj (T, J, B) -> (EE (2, T, B), jac (2, T, J, B))."""
    c = jnp.cumsum(traj, axis=1)
    ll = robot.link_lengths(cfg)[None, :, None]
    sin, cos = jnp.sin(c), jnp.cos(c)
    ee = jnp.stack(((cos * ll).sum(1), (sin * ll).sum(1)))
    x = -ll * sin
    y = ll * cos
    rcx = x + x.sum(1, keepdims=True) - jnp.cumsum(x, axis=1)
    rcy = y + y.sum(1, keepdims=True) - jnp.cumsum(y, axis=1)
    return ee, jnp.stack((rcx, rcy))


def _obstacle_v(ee, obstacles, weight):
    """ee (2, T, ...L), obstacles (O, 2, B), weight (O, B).  Lane axes ...L
    are (B,) or — for ladder candidates — (n, B): the rung axis sits BEFORE
    the batch axis so B stays the minor (contiguous) dimension of every
    elementwise op.  Returns cost_v (T, ...L)."""
    extra = ee.ndim - 3  # candidate axes inserted before B
    O, B = weight.shape
    obs = jnp.moveaxis(obstacles, 1, 0).reshape(
        (2, 1, O) + (1,) * extra + (B,)
    )  # (2, 1, O, 1..., B)
    w = weight.reshape((1, O) + (1,) * extra + (B,))
    diff = ee[:, :, None] - obs                      # (2, T, O, ...L)
    d2 = jnp.sum(jnp.square(diff), axis=0)           # (T, O, ...L)
    return jnp.sum(0.8 / (0.5 + 0.5 * d2) * w, axis=1)


def _obstacle_vg(ee, obstacles, weight):
    """Value + gradient w.r.t. ee.  ee (2, T, B) -> ((T, B), (2, T, B))."""
    obs = jnp.moveaxis(obstacles, 1, 0)[:, None]     # (2, 1, O, B)
    diff = ee[:, :, None] - obs                      # (2, T, O, B)
    d2 = jnp.sum(jnp.square(diff), axis=0)
    inv = 1.0 / (0.5 + 0.5 * d2)
    cost_v = jnp.sum(0.8 * inv * weight[None], axis=1)
    cost_g = jnp.sum((-0.8 * weight[None, None]) * diff * jnp.square(inv)[None], axis=2)
    return cost_v, cost_g


def _blend(cfg, cost_v):
    """cost_v (T, ...L) -> blended cost (...L,) (max/avg mix,
    ref: trajectory.py:85-87)."""
    lam = cfg.lambda_max_cost
    return lam * jnp.max(cost_v, axis=0) + (1.0 - lam) * jnp.mean(cost_v, axis=0)


def _blend_weights(cfg, cost_v):
    """Gradient weights of the blend: (T, B)."""
    T = cost_v.shape[0]
    lam = cfg.lambda_max_cost
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, cost_v.shape, 0)
        == jnp.argmax(cost_v, axis=0)[None]
    ).astype(cost_v.dtype)
    return lam * onehot + (1.0 - lam) / T


def _limit_terms(cfg, traj, vel):
    """Joint position/velocity limit losses (B,) (ref: trajectory.py:215-268)."""
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    pl = 0.5 * jnp.square((traj - mean) / std)
    vl = 0.5 * jnp.square(vel / cfg.max_joint_velocity)
    if cfg.constraint_violating_dependant_loss:
        pmask = jnp.logical_or(
            traj > cfg.joint_safety_limit * cfg.max_joint_position,
            traj < cfg.joint_safety_limit * cfg.min_joint_position,
        )
        vmask = jnp.abs(vel) > cfg.joint_safety_limit * cfg.max_joint_velocity
        pl = jnp.where(pmask, pl, 0.0)
        vl = jnp.where(vmask, vl, 0.0)
    T = traj.shape[0]
    return pl.sum(axis=(0, 1)) / T, vl.sum(axis=(0, 1)) / T


def _limit_grads(cfg, traj, vel):
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    pg = (traj - mean) / (std * std)
    vg = vel / (cfg.max_joint_velocity**2)
    if cfg.constraint_violating_dependant_loss:
        pmask = jnp.logical_or(
            traj > cfg.joint_safety_limit * cfg.max_joint_position,
            traj < cfg.joint_safety_limit * cfg.min_joint_position,
        )
        vmask = jnp.abs(vel) > cfg.joint_safety_limit * cfg.max_joint_velocity
        pg = jnp.where(pmask, pg, 0.0)
        vg = jnp.where(vmask, vg, 0.0)
    T = traj.shape[0]
    return pg / T, vg / T


def fleet_cost_from_traj(cfg, scn: Scenario, penalty: Penalty, traj, vel) -> jnp.ndarray:
    """Total penalized cost per lane given an already-evaluated trajectory.

    Split out from :func:`fleet_cost` because RKHS evaluation is LINEAR in
    alpha: line-search candidates' trajectories are affine combinations of
    two precomputed evaluations, so the ladder never re-runs the basis GEMM
    (see _make_bls_inner)."""
    ee = _fk_ee(cfg, traj)
    toc = _blend(cfg, _obstacle_v(ee, scn.obstacles, scn.obstacle_weight))
    extra = traj.ndim - 3  # rung axes inserted before B
    J, B = scn.start.shape
    start = scn.start.reshape((J,) + (1,) * extra + (B,))
    goal = scn.goal.reshape((J,) + (1,) * extra + (B,))
    sgpc = 0.5 * (
        jnp.sum(jnp.square(traj[0] - start), axis=0)
        + jnp.sum(jnp.square(traj[-1] - goal), axis=0)
    )
    sgvc = 0.5 * (
        jnp.sum(jnp.square(vel[0]), axis=0) + jnp.sum(jnp.square(vel[-1]), axis=0)
    )
    jpc, jvc = _limit_terms(cfg, traj, vel)
    # penalty fields are (B,); they broadcast over the leading rung axes.
    return toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)


def fleet_cost(cfg, basis, scn: Scenario, penalty: Penalty, alpha) -> jnp.ndarray:
    """Total penalized cost per lane.  alpha (T, J, ...L) -> (...L,)."""
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    return fleet_cost_from_traj(cfg, scn, penalty, traj, vel)


def fleet_cost_grad_eval(cfg, basis, scn, penalty: Penalty, alpha):
    """Fused per-lane cost + analytical alpha-gradient + the evaluated
    (traj, vel), so callers can reuse the basis evaluation (the line-search
    linearization needs it).  alpha (T, J, B) ->
    ((B,), (T, J, B), (T, J, B), (T, J, B))."""
    prec = _precision(cfg)
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    ee, jac = _fk_ee_and_jac(cfg, traj)
    cost_v, cost_g = _obstacle_vg(ee, scn.obstacles, scn.obstacle_weight)
    toc = _blend(cfg, cost_v)
    w = _blend_weights(cfg, cost_v)                          # (T, B)
    toc_g = jnp.einsum("itb,itjb->tjb", w[None] * cost_g, jac, precision=prec)

    sgpc = 0.5 * (
        jnp.sum(jnp.square(traj[0] - scn.start), axis=0)
        + jnp.sum(jnp.square(traj[-1] - scn.goal), axis=0)
    )
    sgvc = 0.5 * (
        jnp.sum(jnp.square(vel[0]), axis=0) + jnp.sum(jnp.square(vel[-1]), axis=0)
    )
    jpc, jvc = _limit_terms(cfg, traj, vel)
    cost = toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)

    sgp_g = jnp.zeros_like(traj).at[0].set(traj[0] - scn.start)
    sgp_g = sgp_g.at[-1].set(traj[-1] - scn.goal)
    sgv_g = jnp.zeros_like(vel).at[0].set(vel[0]).at[-1].set(vel[-1])
    jp_g, jv_g = _limit_grads(cfg, traj, vel)

    grad_pos = toc_g + penalty.lambda_sg * sgp_g + penalty.lambda_jl * jp_g
    grad_vel = penalty.lambda_sg * sgv_g + penalty.lambda_jl * jv_g
    stacked = jnp.concatenate((grad_pos, grad_vel), axis=0)   # (2T, J, B)
    T, J, B = alpha.shape
    pulled = jnp.matmul(
        basis.kv.T, stacked.reshape(2 * T, J * B), precision=prec
    ).reshape(T, J, B)
    grad = jnp.einsum("tib,ji->tjb", pulled, basis.mix, precision=prec)
    return cost, grad, traj, vel


def fleet_cost_and_grad(cfg, basis, scn, penalty: Penalty, alpha):
    """Fused per-lane cost + analytical alpha-gradient.
    alpha (T, J, B) -> ((B,), (T, J, B))."""
    cost, grad, _, _ = fleet_cost_grad_eval(cfg, basis, scn, penalty, alpha)
    return cost, grad


def fleet_constraints(cfg, basis, scn: Scenario, alpha) -> jnp.ndarray:
    """Per-lane hard-constraint check (B,) (ref: trajectory.py:129-137)."""
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    pos_ok = jnp.logical_and(
        jnp.linalg.norm(traj[0] - scn.start, axis=0) < cfg.eps_position,
        jnp.linalg.norm(traj[-1] - scn.goal, axis=0) < cfg.eps_position,
    )
    vel_ok = jnp.logical_and(
        jnp.linalg.norm(vel[0], axis=0) < cfg.eps_velocity,
        jnp.linalg.norm(vel[-1], axis=0) < cfg.eps_velocity,
    )
    box_ok = jnp.logical_and(
        traj.max(axis=(0, 1)) <= cfg.max_joint_position,
        traj.min(axis=(0, 1)) >= cfg.min_joint_position,
    )
    vbox_ok = jnp.abs(vel).max(axis=(0, 1)) <= cfg.max_joint_velocity
    return pos_ok & vel_ok & box_ok & vbox_ok


# ---------------------------------------------------------------------------
# Inner loops (lane-parallel).
# ---------------------------------------------------------------------------


class _BlsInner(NamedTuple):
    minimized: jnp.ndarray   # (B,)
    inner_iter: jnp.ndarray  # (B,)
    alpha: jnp.ndarray       # (T, J, B)
    bls_lr: jnp.ndarray      # (B,)
    loss: jnp.ndarray        # (B,)
    grad: jnp.ndarray        # (T, J, B)
    traj: jnp.ndarray        # (T, J, B) — evaluation at alpha (reused by ladder)
    vel: jnp.ndarray         # (T, J, B)


def _make_bls_inner(cfg: PlannerConfig, basis, scn: Scenario):
    tol = jnp.float32(cfg.loop_loss_reduction)
    n = cfg.max_bls_iteration
    rungs = jnp.power(
        jnp.float32(cfg.bls_beta_minus), jnp.arange(n, dtype=jnp.float32)
    )  # (n,)

    def for_outer(outer_iter, round_idx=None):
        del outer_iter
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha, penalty: Penalty):
            loss0, grad0, traj0, vel0 = fleet_cost_grad_eval(
                cfg, basis, scn, penalty, alpha
            )
            B = loss0.shape[0]

            def _raw_body(s: _BlsInner) -> _BlsInner:
                gnorm = jnp.sqrt(jnp.sum(jnp.square(s.grad), axis=(0, 1)))  # (B,)
                n_grad = s.grad / gnorm
                # reference quirk (optimizer_BLS.py:86): sum over ALL (J, J)
                # entries of grad^T @ n_grad; factorizes as
                # sum_t rowsum(grad)_t * rowsum(n_grad)_t.
                alpha_norm = jnp.sum(
                    jnp.sum(s.grad, axis=1) * jnp.sum(n_grad, axis=1), axis=0
                )  # (B,)
                # Rung-major candidates (T, J, n+1, B): the batch stays on
                # the minor axis so every elementwise op runs full-width
                # lanes.  Rung n is the ZERO-lr candidate — alpha itself,
                # bitwise — evaluated through the SAME batched path as the
                # real rungs; its loss is the Armijo/stop BASELINE.  The
                # ill-conditioned parametrization amplifies batched-vs-
                # unbatched fp-path differences on the same point to ~1e-4
                # relative, above the margin of small-lr rungs and the 1e-3
                # stop threshold, so a cross-path baseline (the carried
                # s.loss from fleet_cost_grad_eval) systematically flips
                # near-threshold accepts/stops: measured on 256 random
                # scenes (early-exit, reference budgets, exact tier) the
                # cross-path ladder converged 77% of lanes vs the
                # sequential reference's 53%; the same-path baseline
                # restores the reference's distribution
                # (benchmarks/certify.py).
                lrs = rungs[:, None] * s.bls_lr[None]            # (n, B)
                lrs_b = jnp.concatenate(
                    [lrs, jnp.zeros((1,) + lrs.shape[1:], lrs.dtype)], axis=0
                )                                                # (n+1, B)
                a_fac = 1.0 - cfg.lambda_reg * lrs_b             # (n+1, B)
                if cfg.ladder_eval == "linearized":
                    # LINEARIZATION: evaluation is linear in alpha, so every
                    # rung's trajectory is an affine combination of the
                    # CURRENT evaluation (carried in the state) and ONE
                    # evaluation of the search direction — no per-candidate
                    # basis GEMM.  Exact in real arithmetic; see
                    # config.ladder_eval for the measured fp-path trade.
                    gtraj, gvel = fleet_evaluate(cfg, basis, n_grad)
                    cand_traj = (a_fac * s.traj[:, :, None]
                                 - lrs_b * gtraj[:, :, None])
                    cand_vel = (a_fac * s.vel[:, :, None]
                                - lrs_b * gvel[:, :, None])
                else:
                    # EXACT: each rung's candidate alpha through the basis
                    # GEMMs, like the reference (ref: optimizer_BLS.py:139).
                    cand_alpha = (
                        a_fac[None, None] * s.alpha[:, :, None]
                        - lrs_b[None, None] * n_grad[:, :, None]
                    )                                            # (T,J,n+1,B)
                    cand_traj, cand_vel = fleet_evaluate(cfg, basis, cand_alpha)
                cand_loss = fleet_cost_from_traj(
                    cfg, scn, penalty, cand_traj, cand_vel
                )                                                # (n+1, B)
                base_loss = cand_loss[n]                         # (B,)
                required = (base_loss[None]
                            - cfg.bls_alpha * lrs * alpha_norm[None])
                ok = cand_loss[:n] <= required
                any_ok = jnp.any(ok, axis=0)                     # (B,)
                j = jnp.argmax(ok, axis=0)                       # (B,)
                lr_sel = jnp.take_along_axis(lrs, j[None], axis=0)[0]
                lr_eff = jnp.where(any_ok, lr_sel, 0.0)          # rejected -> no step
                new_alpha = (1.0 - cfg.lambda_reg * lr_eff) * s.alpha - lr_eff * n_grad
                sel_loss = jnp.take_along_axis(cand_loss[:n], j[None], axis=0)[0]
                new_loss = jnp.where(any_ok, sel_loss, base_loss)
                new_lr = jnp.where(
                    any_ok,
                    lr_sel * cfg.bls_beta_plus,
                    s.bls_lr * jnp.float32(cfg.bls_beta_minus) ** n,
                )
                stop = base_loss - new_loss < tol
                next_loss, next_grad, next_traj, next_vel = fleet_cost_grad_eval(
                    cfg, basis, scn, penalty, new_alpha
                )
                return _BlsInner(
                    minimized=stop,
                    inner_iter=jnp.where(stop, s.inner_iter, s.inner_iter + 1),
                    alpha=new_alpha,
                    bls_lr=new_lr,
                    loss=jnp.where(stop, new_loss, next_loss),
                    grad=jnp.where(stop, s.grad, next_grad),
                    traj=next_traj,
                    vel=next_vel,
                )

            def body(s: _BlsInner) -> _BlsInner:
                # Freeze minimized AND budget-exhausted lanes: the batched
                # early-exit while_loop keeps running while any lane is
                # active, and without the exhaustion term a capped lane
                # would take extra steps it never gets alone (see
                # common.py::run_dual_loop's outer freeze).
                done = jnp.logical_or(
                    s.minimized, s.inner_iter >= cfg.max_inner_iteration
                )
                return freeze_when(done, s, _raw_body(s))

            init = _BlsInner(
                minimized=jnp.zeros(B, bool),
                inner_iter=jnp.zeros(B, jnp.int32),
                alpha=alpha,
                bls_lr=jnp.full((B,), cfg.bls_lr_start, jnp.float32),
                loss=loss0,
                grad=grad0,
                traj=traj0,
                vel=vel0,
            )
            if cfg.fixed_iters:
                final = jax.lax.fori_loop(
                    0, bound, lambda _, s: body(s), init
                )
            else:
                final = jax.lax.while_loop(
                    lambda s: jnp.any(
                        jnp.logical_and(
                            s.inner_iter < cfg.max_inner_iteration,
                            jnp.logical_not(s.minimized),
                        )
                    ),
                    body,
                    init,
                )
            return final.alpha, final.inner_iter, final.loss

        return inner

    return for_outer


class _GdInner(NamedTuple):
    minimized: jnp.ndarray
    inner_iter: jnp.ndarray
    alpha: jnp.ndarray
    loss: jnp.ndarray
    grad: jnp.ndarray


def _make_gd_inner(cfg: PlannerConfig, basis, scn: Scenario):
    lr_schedule = jnp.asarray(cfg.gd_lr, dtype=jnp.float32)
    tol = jnp.float32(cfg.loop_loss_reduction)

    def for_outer(outer_iter, round_idx=None):
        # outer_iter is (B,) — per-lane learning rate (lanes can sit at
        # different penalty rounds, ref: optimizer_GD.py:209).
        lr = lr_schedule[jnp.clip(outer_iter, 0, len(cfg.gd_lr) - 1)]  # (B,)
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha, penalty: Penalty):
            loss0, grad0 = fleet_cost_and_grad(cfg, basis, scn, penalty, alpha)
            B = loss0.shape[0]

            def _raw_body(s: _GdInner) -> _GdInner:
                new_alpha = (1.0 - cfg.lambda_reg * lr) * s.alpha - lr * s.grad
                new_loss, new_grad = fleet_cost_and_grad(
                    cfg, basis, scn, penalty, new_alpha
                )
                stop = s.loss - new_loss < tol
                return _GdInner(
                    minimized=stop,
                    inner_iter=jnp.where(stop, s.inner_iter, s.inner_iter + 1),
                    alpha=jnp.where(stop, s.alpha, new_alpha),
                    loss=jnp.where(stop, s.loss, new_loss),
                    grad=jnp.where(stop, s.grad, new_grad),
                )

            def body(s: _GdInner) -> _GdInner:
                # Freeze minimized AND budget-exhausted lanes: the batched
                # early-exit while_loop keeps running while any lane is
                # active, and without the exhaustion term a capped lane
                # would take extra steps it never gets alone (see
                # common.py::run_dual_loop's outer freeze).
                done = jnp.logical_or(
                    s.minimized, s.inner_iter >= cfg.max_inner_iteration
                )
                return freeze_when(done, s, _raw_body(s))

            init = _GdInner(
                minimized=jnp.zeros(B, bool),
                inner_iter=jnp.zeros(B, jnp.int32),
                alpha=alpha,
                loss=loss0,
                grad=grad0,
            )
            if cfg.fixed_iters:
                final = jax.lax.fori_loop(
                    0, bound, lambda _, s: body(s), init
                )
            else:
                final = jax.lax.while_loop(
                    lambda s: jnp.any(
                        jnp.logical_and(
                            s.inner_iter < cfg.max_inner_iteration,
                            jnp.logical_not(s.minimized),
                        )
                    ),
                    body,
                    init,
                )
            return final.alpha, final.inner_iter, final.loss

        return inner

    return for_outer


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def fleet_solve(
    cfg: PlannerConfig,
    basis: Basis,
    scenarios: Scenario,
    alpha0: Optional[jnp.ndarray] = None,
    solver: str = "bls",
) -> SolveResult:
    """Solve a batch of scenarios in the batch-trailing layout.

    Args:
      scenarios: leading-batch Scenario (same convention as solve_batch).
      alpha0: optional (B, T, J) warm start.
    Returns: SolveResult with leading-batch leaves.
    """
    if solver == "bls" and cfg.bls_mode == "sequential":
        # Never silently substitute semantics: the fleet engine implements
        # the line search exclusively as the parallel ladder (which
        # enumerates exactly the lr sequence the sequential backtracking
        # loop would try and selects the same first-passing step — see
        # solvers/bls.py docstring — but evaluates candidates through the
        # linearized trajectory, a different fp path).  For the reference's
        # sequential execution at batch scale use the vmap engine
        # (solvers/batched.py), which honors bls_mode.
        raise ValueError(
            "bls_mode='sequential' is not supported by the fleet engine; "
            "use bls_mode='ladder' (same trial sequence) or the vmap engine"
        )
    fs = to_fleet(scenarios)
    B = scenarios.start.shape[0]
    if alpha0 is None:
        a0 = fleet_init_alpha(cfg, basis, fs)
    else:
        a0 = alpha_to_fleet(alpha0)
    penalty0 = Penalty(
        jnp.full((B,), cfg.lambda_sg_constraint, jnp.float32),
        jnp.full((B,), cfg.lambda_jl_constraint, jnp.float32),
    )
    make_inner = {"bls": _make_bls_inner, "gd": _make_gd_inner}[solver]
    inner = make_inner(cfg, basis, fs)
    res = run_dual_loop(
        cfg,
        basis,
        fs,  # only passed through to constraints_fn below
        a0,
        inner,
        constraints_fn=lambda a: fleet_constraints(cfg, basis, fs, a),
        penalty0=penalty0,
    )
    return SolveResult(
        alpha=alpha_from_fleet(res.alpha),
        stats=res.stats,
    )


def make_fleet_solver(cfg: PlannerConfig, basis: Basis, solver: str = "bls"):
    """Jitted fleet solver: leading-batch Scenario -> SolveResult.

    The basis is bound as a traced ARGUMENT, not a closure constant, so the
    executable embeds no (2T, T) constants and one compiled program serves
    any basis of the same shape."""

    @jax.jit
    def run(basis_arg: Basis, scenarios: Scenario) -> SolveResult:
        return fleet_solve(cfg, basis_arg, scenarios, solver=solver)

    return functools.partial(run, basis)
