"""Backtracking-line-search solver (Armijo) — the reference's flagship
optimizer (ref: optimizer_BLS.py:22-213) — with a batch-friendly redesign
of the line search itself.

Per inner step (ref: optimizer_BLS.py:159-179):
    loss, grad at alpha (fused here; the reference evaluates them separately)
    n_grad = grad / ||grad||
    alpha_norm = sum(grad.T @ n_grad)
        NOTE: the reference sums ALL entries of the (J, J) matrix, i.e.
        including cross-joint terms — not the Frobenius inner product
        (ref: optimizer_BLS.py:86,166).  Replicated bit-for-bit for parity.
    line search over trial steps alpha' = (1 - lambda_reg*lr)*alpha - lr*n_grad
        Armijo accept iff new_loss <= loss - bls_alpha * lr * alpha_norm,
        shrink lr *= beta_minus on reject, grow lr *= beta_plus on accept
        (the accepted lr carries across inner iterations, resetting to
        bls_lr_start each outer iteration, ref: optimizer_BLS.py:193).

Two line-search executions:

* ``bls_mode='sequential'`` — the reference's data-dependent while_loop
  (ref: optimizer_BLS.py:130-150): try lr, halve on failure, stop on first
  accept.  Cheap per trial but serial: each trial is a dependent
  cost evaluation, so the step latency is O(#trials) kernel latencies.
* ``bls_mode='ladder'`` (default) — evaluate the whole geometric ladder
  ``lr * beta_minus**j, j = 0..max_bls_iteration-1`` as ONE batched cost
  evaluation and select the first Armijo-passing step.  The candidate axis
  folds into the basis GEMM ((T, T) x (T, n_cand*J) instead of 20
  sequential (T, T) x (T, J) matmuls), turning a branch-heavy loop into
  dense compute — the right trade on a wide accelerator.  Result is
  IDENTICAL to sequential mode: the ladder enumerates exactly the lrs the
  sequential loop would try, and first-passing selection mirrors its exit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import PlannerConfig
from ..models.rkhs import Basis, _precision, init_alpha
from ..ops.costs import Penalty, cost_and_grad, total_cost
from ..ops.scenario import Scenario
from .common import (
    InnerFn, SolveResult, freeze_when, inner_loop_bound, run_dual_loop,
)


def descent_direction(cfg: PlannerConfig, grad):
    """Normalized functional-gradient direction and its Armijo slope
    (ref: optimizer_BLS.py:165-166).  The slope sums ALL (J, J) entries of
    grad^T @ n_grad, like the reference (ref: optimizer_BLS.py:86)."""
    n_grad = grad / jnp.linalg.norm(grad)
    alpha_norm = jnp.sum(
        jnp.matmul(grad.T, n_grad, precision=_precision(cfg))
    )
    return n_grad, alpha_norm


def _trial(cfg: PlannerConfig, alpha, n_grad, lr):
    """One trial step (ref: optimizer_BLS.py:139)."""
    return (1.0 - cfg.lambda_reg * lr) * alpha - lr * n_grad


def _ladder_search(
    cfg: PlannerConfig, basis, scn, penalty, alpha, n_grad, alpha_norm, loss, bls_lr
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Parallel line search: all candidate lrs in one batched evaluation.

    Returns (alpha', bls_lr', new_loss, trials_used)."""
    n = cfg.max_bls_iteration
    ladder = bls_lr * jnp.power(
        jnp.float32(cfg.bls_beta_minus), jnp.arange(n, dtype=jnp.float32)
    )                                                             # (n,)
    cand = (
        (1.0 - cfg.lambda_reg * ladder)[:, None, None] * alpha
        - ladder[:, None, None] * n_grad
    )                                                             # (n, T, J)
    # PATH CONSISTENCY: evaluate alpha itself through the SAME batched
    # evaluation as the candidates and use that value as the Armijo
    # baseline.  The RKHS parametrization is ill-conditioned (alpha ~1e3,
    # trajectory ~1), so the batched-vs-unbatched fp-path difference on the
    # same point is ~1e-4 RELATIVE — above the Armijo margin of small-lr
    # rungs and above the 1e-3 stop threshold's noise floor.  Comparing a
    # batched candidate loss against an unbatched baseline systematically
    # flips near-threshold accepts: measured on 256 random scenes
    # (early-exit, reference budgets) the cross-path ladder converged 13%
    # of lanes vs the sequential reference's 53%; this same-path baseline
    # restores the reference's distribution (benchmarks/certify.py).
    cand = jnp.concatenate([cand, alpha[None]], axis=0)           # (n+1,T,J)
    cand_loss = jax.vmap(
        lambda a: total_cost(cfg, basis, scn, penalty, a)
    )(cand)                                                       # (n+1,)
    base_loss = cand_loss[n]
    required = base_loss - cfg.bls_alpha * ladder * alpha_norm
    ok = cand_loss[:n] <= required                                # Armijo
    any_ok = jnp.any(ok)
    # First passing rung == the sequential loop's exit point.
    j = jnp.argmax(ok)
    new_alpha = jnp.where(any_ok, cand[j], alpha)
    new_loss = jnp.where(any_ok, cand_loss[j], base_loss)
    # Accept: lr_j * beta_plus.  Exhausted: the sequential loop leaves
    # lr = bls_lr * beta_minus**n (ref: optimizer_BLS.py:144).
    lr_exhausted = bls_lr * jnp.float32(cfg.bls_beta_minus) ** n
    new_lr = jnp.where(any_ok, ladder[j] * cfg.bls_beta_plus, lr_exhausted)
    trials = jnp.where(any_ok, j, n).astype(jnp.int32)
    return new_alpha, new_lr, new_loss, base_loss, trials


class _BlsState(NamedTuple):
    obtained: jnp.ndarray
    bls_iter: jnp.ndarray
    bls_lr: jnp.ndarray
    alpha: jnp.ndarray
    loss: jnp.ndarray


def _sequential_search(
    cfg: PlannerConfig, basis, scn, penalty, alpha, n_grad, alpha_norm, loss, bls_lr
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The reference's backtracking while_loop (ref: optimizer_BLS.py:130-150)."""

    def _raw_body(s: _BlsState) -> _BlsState:
        new_alpha = _trial(cfg, s.alpha, n_grad, s.bls_lr)
        new_loss = total_cost(cfg, basis, scn, penalty, new_alpha)
        required = loss - cfg.bls_alpha * s.bls_lr * alpha_norm
        reject = new_loss > required
        return _BlsState(
            obtained=jnp.logical_not(reject),
            bls_iter=jnp.where(reject, s.bls_iter + 1, s.bls_iter),
            bls_lr=jnp.where(
                reject, s.bls_lr * cfg.bls_beta_minus, s.bls_lr * cfg.bls_beta_plus
            ),
            alpha=jnp.where(reject, s.alpha, new_alpha),
            loss=jnp.where(reject, s.loss, new_loss),
        )

    def body(s: _BlsState) -> _BlsState:
        # No-op once accepted OR trial budget exhausted (vmap lockstep
        # safety: without the exhaustion term a lane at max_bls_iteration
        # rejects would keep shrinking lr and could accept a step the
        # per-scene sequential semantics never try).
        done = jnp.logical_or(s.obtained, s.bls_iter >= cfg.max_bls_iteration)
        return freeze_when(done, s, _raw_body(s))

    init = _BlsState(
        obtained=jnp.asarray(False),
        bls_iter=jnp.asarray(0, jnp.int32),
        bls_lr=bls_lr,
        alpha=alpha,
        loss=loss,
    )
    final = jax.lax.while_loop(
        lambda s: jnp.logical_and(
            s.bls_iter < cfg.max_bls_iteration, jnp.logical_not(s.obtained)
        ),
        body,
        init,
    )
    return final.alpha, final.bls_lr, final.loss, loss, final.bls_iter


class _InnerState(NamedTuple):
    minimized: jnp.ndarray
    inner_iter: jnp.ndarray
    alpha: jnp.ndarray
    bls_lr: jnp.ndarray
    loss: jnp.ndarray   # loss at alpha
    grad: jnp.ndarray   # grad at alpha


def _make_inner(cfg: PlannerConfig, basis: Basis, scn: Scenario):
    tol = jnp.float32(cfg.loop_loss_reduction)
    search = _ladder_search if cfg.bls_mode == "ladder" else _sequential_search

    def for_outer(outer_iter: jnp.ndarray, round_idx=None) -> InnerFn:
        del outer_iter  # BLS re-derives its step size; no lr schedule.
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha: jnp.ndarray, penalty: Penalty):
            loss0, grad0 = cost_and_grad(cfg, basis, scn, penalty, alpha)

            def _raw_body(state: _InnerState) -> _InnerState:
                n_grad, alpha_norm = descent_direction(cfg, state.grad)
                new_alpha, new_lr, new_loss, base_loss, _ = search(
                    cfg, basis, scn, penalty,
                    state.alpha, n_grad, alpha_norm, state.loss, state.bls_lr,
                )
                # Early stop when the whole line search couldn't reduce the
                # loss by the threshold (ref: optimizer_BLS.py:172-178).
                # base_loss is the search's OWN evaluation of the current
                # iterate (same fp path as new_loss) so the reduction test
                # is path-consistent — see _ladder_search.
                stop = base_loss - new_loss < tol
                # Gradient for the NEXT iterate (discarded when stopping).
                next_loss, next_grad = cost_and_grad(
                    cfg, basis, scn, penalty, new_alpha
                )
                return _InnerState(
                    minimized=stop,
                    inner_iter=jnp.where(stop, state.inner_iter, state.inner_iter + 1),
                    alpha=new_alpha,
                    bls_lr=new_lr,
                    loss=jnp.where(stop, new_loss, next_loss),
                    grad=jnp.where(stop, state.grad, next_grad),
                )

            def body(state: _InnerState) -> _InnerState:
                # No-op for minimized AND budget-exhausted lanes: under a
                # batched early-exit while_loop the body keeps running while
                # ANY lane is active, so without the exhaustion term a lane
                # at the inner cap would take extra descent steps it never
                # gets alone (see common.py::run_dual_loop's outer freeze).
                done = jnp.logical_or(
                    state.minimized,
                    state.inner_iter >= cfg.max_inner_iteration,
                )
                return freeze_when(done, state, _raw_body(state))

            init = _InnerState(
                minimized=jnp.asarray(False),
                inner_iter=jnp.asarray(0, jnp.int32),
                alpha=alpha,
                bls_lr=jnp.float32(cfg.bls_lr_start),
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
    """Full BLS solve: smoothstep warm start + penalty-method dual loop
    (ref: optimizer_BLS.py:57-62).  Pure; jit/vmap/shard_map freely."""
    if alpha0 is None:
        alpha0 = init_alpha(cfg, basis, scn.start, scn.goal)
    return run_dual_loop(cfg, basis, scn, alpha0, _make_inner(cfg, basis, scn))
