"""Sharded multi-chip solver: scenario-axis parallelism over a device mesh.

The solve itself needs NO communication (scenarios are independent); `psum`
collectives (NCCL on GPUs, gloo on CPU clusters) aggregate fleet-level
convergence fractions and cost statistics across the mesh so every host sees
global telemetry without gathering per-scenario results.  The mesh is 1-D
over the scenario axis.

Two entry points:

* :func:`make_sharded_solver` — jit with `NamedSharding` annotations; XLA
  partitions the vmapped solver over the scenario axis (the idiomatic
  "let-the-compiler-do-it" path).
* :func:`make_shard_map_solver` — explicit per-device SPMD via `shard_map`,
  with in-program `psum` reductions producing replicated global stats.  This
  is the path that exercises collective compilation and is what
  `dryrun_multichip` validates.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import PlannerConfig
from ..models.rkhs import Basis
from ..ops.scenario import Scenario
from ..solvers.batched import solve_batch
from ..solvers.common import SolveResult
from .mesh import SCENARIO_AXIS, replicated, scenario_sharding


def make_sharded_solver(
    cfg: PlannerConfig, basis: Basis, mesh: Mesh, solver: str = "bls"
):
    """Jitted solver with sharding annotations: Scenario leaves sharded on
    their leading axis; results come back sharded the same way."""
    shard = scenario_sharding(mesh)
    repl = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, shard),
        out_shardings=shard,
    )
    def run(basis_arg: Basis, scenarios: Scenario) -> SolveResult:
        return solve_batch(cfg, basis_arg, scenarios, solver=solver)

    return functools.partial(run, basis)


def make_shard_map_solver(
    cfg: PlannerConfig,
    basis: Basis,
    mesh: Mesh,
    solver: str = "bls",
    engine: str = "vmap",
):
    """Explicit SPMD solver: each device runs the batched solve on its local
    scenario shard, then global fleet statistics are reduced with psum over
    the mesh (returned replicated on every device).

    ``engine='fleet'`` runs the batch-trailing fleet engine per shard — the
    production configuration for multi-device sweeps.

    Returns ``scenarios -> (SolveResult sharded, stats dict replicated)``.
    """

    def per_device(basis_arg: Basis, scenarios: Scenario):
        if engine == "fleet":
            from ..solvers.fleet import fleet_solve

            res = fleet_solve(cfg, basis_arg, scenarios, solver=solver)
        else:
            res = solve_batch(cfg, basis_arg, scenarios, solver=solver)
        n_local = res.stats.converged.shape[0]
        n_total = jax.lax.psum(jnp.float32(n_local), SCENARIO_AXIS)
        conv = jax.lax.psum(
            jnp.sum(res.stats.converged.astype(jnp.float32)), SCENARIO_AXIS
        )
        inner = jax.lax.psum(
            jnp.sum(res.stats.inner_iters.astype(jnp.float32)), SCENARIO_AXIS
        )
        cost_sum = jax.lax.psum(jnp.sum(res.stats.final_cost), SCENARIO_AXIS)
        cost_max = jax.lax.pmax(jnp.max(res.stats.final_cost), SCENARIO_AXIS)
        stats = {
            "n_total": n_total,
            "converged_fraction": conv / n_total,
            "mean_inner_iters": inner / n_total,
            "mean_final_cost": cost_sum / n_total,
            "max_final_cost": cost_max,
        }
        return res, stats

    # check_vma=False: the solver's loop carries start replicated (iteration
    # counters, learning rates) and become device-varying as lanes diverge —
    # sound here because every carry is per-shard state with no cross-device
    # dependence; the static varying-axis checker can't express that.
    mapped = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(SCENARIO_AXIS)),
        out_specs=(P(SCENARIO_AXIS), P()),
        check_vma=False,
    )

    @jax.jit
    def run(basis_arg: Basis, scenarios: Scenario):
        return mapped(basis_arg, scenarios)

    return functools.partial(run, basis)
