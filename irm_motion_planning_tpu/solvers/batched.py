"""Batched solver engine: thousands of scenarios per device via vmap.

The reference solves one scenario per process (ref: main.py:117-129).  The
scaling axis here is the scenario batch: every leaf of ``Scenario`` gains a
leading batch dimension and the whole solve is ``jax.vmap``-ed and jitted
ONCE.  The tiny per-scenario tensors (50x3 alpha, 50x50 Gram matmuls) batch
into larger GEMMs — throughput comes from the batch, not from per-scenario
speed.

Early-exit semantics under vmap: the while_loop conditions become
lane-reductions (any lane active) and converged lanes are frozen by the
per-lane masks inside the solver bodies, so each lane's result equals its
sequential solve.  For throughput benchmarking use ``fixed_iters=True``
(identical results, no data-dependent trip counts).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import PlannerConfig
from ..models.rkhs import Basis, init_alpha
from ..ops.scenario import Scenario
from .common import SolveResult
from . import bls as _bls
from . import gd as _gd

_SOLVERS = {"bls": _bls.solve, "gd": _gd.solve}


def solve_batch(
    cfg: PlannerConfig,
    basis: Basis,
    scenarios: Scenario,
    alpha0: Optional[jnp.ndarray] = None,
    solver: str = "bls",
) -> SolveResult:
    """Solve a batch of scenarios.  Every Scenario leaf has a leading batch
    axis; returns a SolveResult with the same leading axis on every leaf.

    Pure function of its array arguments — jit it (or let
    :func:`make_batched_solver` do so).
    """
    fn = _SOLVERS[solver]
    if alpha0 is None:
        a0 = jax.vmap(lambda s: init_alpha(cfg, basis, s.start, s.goal))(scenarios)
    else:
        a0 = alpha0
    return jax.vmap(lambda s, a: fn(cfg, basis, s, a))(scenarios, a0)


def make_batched_solver(cfg: PlannerConfig, basis: Basis, solver: str = "bls"):
    """Jitted batched solver: scenarios -> SolveResult.  Compiled once per
    batch shape; obstacle/start/goal VALUES never recompile.  The basis is a
    bound traced argument, not a closure constant."""

    @jax.jit
    def run(basis_arg: Basis, scenarios: Scenario) -> SolveResult:
        return solve_batch(cfg, basis_arg, scenarios, solver=solver)

    return functools.partial(run, basis)


def batch_summary(result: SolveResult) -> dict:
    """Fleet-level convergence statistics (device-side reductions)."""
    return {
        "n": result.stats.converged.shape[0],
        "converged_fraction": jnp.mean(result.stats.converged.astype(jnp.float32)),
        "mean_inner_iters": jnp.mean(result.stats.inner_iters.astype(jnp.float32)),
        "mean_final_cost": jnp.mean(result.stats.final_cost),
        "max_final_cost": jnp.max(result.stats.final_cost),
    }
