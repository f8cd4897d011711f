"""Python-loop solver variants (capability of the reference's
``--jit-loop false`` paths: plain_optimize / dual_optimize,
ref: optimizer_BLS.py:65-123, optimizer_GD.py:100-169).

The loop control runs in Python while the math (fused cost+grad, trial
costs) stays jitted — matching the reference's "jitted loss/grad + Python
loop" configuration, which its blog benchmarks separately
(blog-post.html:384-385).  These variants can also record the per-iteration
trajectory series for the visualization tooling (ref: main.py:150-153), which
the fully-jitted path cannot.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PlannerConfig
from ..models.rkhs import Basis, evaluate, init_alpha
from ..ops.costs import Penalty, cost_and_grad, constraints_fulfilled, total_cost
from ..ops.scenario import Scenario
from .bls import descent_direction
from .common import SolveResult, SolveStats


def _jitted_ops(cfg: PlannerConfig, basis: Basis):
    cag = jax.jit(lambda s, p, a: cost_and_grad(cfg, basis, s, p, a))
    cost = jax.jit(lambda s, p, a: total_cost(cfg, basis, s, p, a))
    cons = jax.jit(lambda s, a: constraints_fulfilled(cfg, basis, s, a))
    ev = jax.jit(lambda a: evaluate(cfg, basis, a)[0])
    return cag, cost, cons, ev


def plain_solve(
    cfg: PlannerConfig,
    basis: Basis,
    scn: Scenario,
    alpha0: Optional[jnp.ndarray] = None,
    solver: str = "bls",
    record_series: bool = False,
) -> Tuple[SolveResult, Optional[List[np.ndarray]]]:
    """Python-loop penalty-method solve.  Returns (result, series) where
    series is the list of per-accepted-iteration trajectories when
    ``record_series`` (ref: optimizer_BLS.py:70-72,106-107)."""
    if solver == "bls":
        return _plain_bls(cfg, basis, scn, alpha0, record_series)
    if solver == "gd":
        return _plain_gd(cfg, basis, scn, alpha0, record_series)
    raise ValueError(f"unknown solver {solver!r}")


def _finish(cfg, basis, scn, alpha, outer_iter, total_inner, fulfilled, loss):
    return SolveResult(
        alpha=alpha,
        stats=SolveStats(
            outer_iters=jnp.asarray(outer_iter, jnp.int32),
            inner_iters=jnp.asarray(total_inner, jnp.int32),
            converged=jnp.asarray(fulfilled),
            final_cost=jnp.asarray(loss, jnp.float32),
        ),
    )


def _plain_bls(cfg, basis, scn, alpha0, record_series):
    """(ref: optimizer_BLS.py:65-123)"""
    cag, cost, cons, ev = _jitted_ops(cfg, basis)
    alpha = alpha0 if alpha0 is not None else init_alpha(cfg, basis, scn.start, scn.goal)
    lam_sg, lam_jl = cfg.lambda_sg_constraint, cfg.lambda_jl_constraint
    series = [np.asarray(ev(alpha))] if record_series else None

    total_inner = 0
    outer_iter = 0
    loss = np.inf
    fulfilled = False
    for outer_iter in range(cfg.max_outer_iteration):
        pen = Penalty(jnp.float32(lam_sg), jnp.float32(lam_jl))
        bls_lr = cfg.bls_lr_start
        for _ in range(cfg.max_inner_iteration):
            loss, grad = cag(scn, pen, alpha)
            n_grad, alpha_norm = descent_direction(cfg, grad)
            new_loss = loss
            for _ in range(cfg.max_bls_iteration):
                new_alpha = (1 - cfg.lambda_reg * bls_lr) * alpha - bls_lr * n_grad
                new_loss = cost(scn, pen, new_alpha)
                required = loss - cfg.bls_alpha * bls_lr * alpha_norm
                if float(new_loss) > float(required):
                    bls_lr *= cfg.bls_beta_minus
                else:
                    alpha = new_alpha
                    bls_lr *= cfg.bls_beta_plus
                    break
            total_inner += 1
            if float(loss) - float(new_loss) < cfg.loop_loss_reduction:
                break
            if record_series:
                series.append(np.asarray(ev(alpha)))
        fulfilled = bool(cons(scn, alpha))
        if fulfilled:
            break
        lam_sg *= cfg.lambda_constraint_increase
        lam_jl *= cfg.lambda_constraint_increase
    return _finish(cfg, basis, scn, alpha, outer_iter, total_inner, fulfilled, loss), series


def _plain_gd(cfg, basis, scn, alpha0, record_series):
    """(ref: optimizer_GD.py:122-169)"""
    cag, cost, cons, ev = _jitted_ops(cfg, basis)
    alpha = alpha0 if alpha0 is not None else init_alpha(cfg, basis, scn.start, scn.goal)
    lam_sg, lam_jl = cfg.lambda_sg_constraint, cfg.lambda_jl_constraint
    series = [np.asarray(ev(alpha))] if record_series else None

    total_inner = 0
    outer_iter = 0
    fulfilled = False
    last_loss = np.inf
    for outer_iter in range(cfg.max_outer_iteration):
        pen = Penalty(jnp.float32(lam_sg), jnp.float32(lam_jl))
        lr = cfg.gd_lr[outer_iter]
        last_loss, grad = cag(scn, pen, alpha)
        for _ in range(cfg.max_inner_iteration):
            new_alpha = (1 - cfg.lambda_reg * lr) * alpha - lr * grad
            new_loss, new_grad = cag(scn, pen, new_alpha)
            if float(last_loss) - float(new_loss) < cfg.loop_loss_reduction:
                break
            alpha, grad, last_loss = new_alpha, new_grad, new_loss
            total_inner += 1
            if record_series:
                series.append(np.asarray(ev(alpha)))
        fulfilled = bool(cons(scn, alpha))
        if fulfilled:
            break
        lam_sg *= cfg.lambda_constraint_increase
        lam_jl *= cfg.lambda_constraint_increase
    return _finish(cfg, basis, scn, alpha, outer_iter, total_inner, fulfilled, last_loss), series
