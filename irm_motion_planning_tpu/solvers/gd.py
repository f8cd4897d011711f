"""Gradient-descent solver with a per-outer-iteration learning-rate schedule.

Capability parity with the reference GD optimizer
(ref: optimizer_GD.py:14-232), as a pure ``lax.while_loop``/``fori_loop``
program over an explicit state pytree:

* the reference's ``jit_dual_optimize`` structure: inner descent loop with
  loss-reduction early stop, outer penalty loop with constraint check and
  lambda escalation (ref: optimizer_GD.py:172-232),
* its non-dual ``jit_optimize`` (ref: optimizer_GD.py:68-97) is the special
  case ``max_outer_iteration=1`` — same update rule and stopping test, so no
  separate code path is needed,
* loss and gradient come from ONE fused forward pass per step
  (the reference pays two, ref: optimizer_GD.py:184-186), and the loop state
  carries (loss, grad) at the current iterate so nothing is recomputed.

Update rule (ref: optimizer_GD.py:185):
    alpha' = (1 - lambda_reg * lr) * alpha - lr * grad
Stop test (ref: optimizer_GD.py:188-194): stop when
    last_loss - new_loss < loop_loss_reduction, REJECTING the trial step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import PlannerConfig
from ..models.rkhs import Basis, init_alpha
from ..ops.costs import Penalty, cost_and_grad
from ..ops.scenario import Scenario
from .common import (
    InnerFn, SolveResult, freeze_when, inner_loop_bound, run_dual_loop,
)


class _InnerState(NamedTuple):
    minimized: jnp.ndarray
    inner_iter: jnp.ndarray
    alpha: jnp.ndarray
    loss: jnp.ndarray   # loss at alpha
    grad: jnp.ndarray   # grad at alpha


def _make_inner(cfg: PlannerConfig, basis: Basis, scn: Scenario) -> "callable":
    """Returns inner(outer_iter) -> InnerFn."""
    lr_schedule = jnp.asarray(cfg.gd_lr, dtype=jnp.float32)
    lam_reg = jnp.float32(cfg.lambda_reg)
    tol = jnp.float32(cfg.loop_loss_reduction)

    def for_outer(outer_iter: jnp.ndarray, round_idx=None) -> InnerFn:
        # Per-outer-iteration learning rate (ref: optimizer_GD.py:209).
        lr = lr_schedule[outer_iter]
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha: jnp.ndarray, penalty: Penalty):
            loss0, grad0 = cost_and_grad(cfg, basis, scn, penalty, alpha)

            def _raw_body(state: _InnerState) -> _InnerState:
                new_alpha = (1.0 - lam_reg * lr) * state.alpha - lr * state.grad
                new_loss, new_grad = cost_and_grad(cfg, basis, scn, penalty, new_alpha)
                stop = state.loss - new_loss < tol
                return _InnerState(
                    minimized=stop,
                    inner_iter=jnp.where(stop, state.inner_iter, state.inner_iter + 1),
                    alpha=jnp.where(stop, state.alpha, new_alpha),
                    loss=jnp.where(stop, state.loss, new_loss),
                    grad=jnp.where(stop, state.grad, new_grad),
                )

            def body(state: _InnerState) -> _InnerState:
                # No-op for minimized AND budget-exhausted lanes (batched
                # lockstep must not grant extra steps — see
                # common.py::run_dual_loop's outer freeze).
                done = jnp.logical_or(
                    state.minimized,
                    state.inner_iter >= cfg.max_inner_iteration,
                )
                return freeze_when(done, state, _raw_body(state))

            init = _InnerState(
                minimized=jnp.asarray(False),
                inner_iter=jnp.asarray(0, jnp.int32),
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
                    lambda s: jnp.logical_and(
                        s.inner_iter < cfg.max_inner_iteration,
                        jnp.logical_not(s.minimized),
                    ),
                    body,
                    init,
                )
            return final.alpha, final.inner_iter, final.loss

        return inner

    return for_outer


def solve(
    cfg: PlannerConfig,
    basis: Basis,
    scn: Scenario,
    alpha0: Optional[jnp.ndarray] = None,
) -> SolveResult:
    """Full GD solve: smoothstep warm start + penalty-method dual loop
    (ref: optimizer_GD.py:54-65).  Pure; jit/vmap/shard_map freely."""
    if alpha0 is None:
        alpha0 = init_alpha(cfg, basis, scn.start, scn.goal)
    return run_dual_loop(cfg, basis, scn, alpha0, _make_inner(cfg, basis, scn))
