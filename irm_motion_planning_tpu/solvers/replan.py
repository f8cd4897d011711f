"""Receding-horizon replanning with warm starts under a real-time budget.

The reference achieves 50 Hz single-scene replanning by keeping the
environment a runtime input (ref: README.md:25-26, blog-post.html:232); every
solve restarts from the smoothstep fit (ref: trajectory.py:73-78).  This
module generalizes that into an explicit replanning loop (BASELINE.json
configs[3]):

* obstacles/start/goal change every tick with NO recompilation,
* warm start from the previous solution's alpha (falling back to the
  smoothstep fit on the first tick or after a reset),
* bounded latency: the solver runs with capped iteration horizons
  (``budget_*`` fields), trading optimality for a deterministic tick time,
* works batched: a fleet of arms replans in one device program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import PlannerConfig
from ..models.rkhs import Basis, init_alpha, make_basis
from ..ops.scenario import Scenario
from .batched import solve_batch
from .common import SolveResult


@dataclasses.dataclass
class Replanner:
    """Stateful replanning driver around the stateless solvers.

    Args:
      cfg: base planner config; iteration caps are overridden by the budget
        caps below for per-tick solves.
      budget_outer/budget_inner: iteration horizons per tick.  Small caps +
        warm starts give bounded per-tick latency; constraint penalties keep
        escalating across ticks through re-solving.
      solver: 'bls' or 'gd'.
    """

    cfg: PlannerConfig
    budget_outer: int = 2
    budget_inner: int = 25
    solver: str = "bls"
    batched: bool = False
    engine: str = "vmap"

    def __post_init__(self):
        if self.engine not in ("vmap", "fleet", "sequential"):
            raise ValueError(f"unknown engine {self.engine!r}")
        # The tick budgets REPLACE any per-round inner schedule: budget_inner
        # is the per-round cap here, and a schedule sized for the base
        # config's outer count would not validate against budget_outer.
        self.tick_cfg = self.cfg.replace(
            max_outer_iteration=min(self.budget_outer, self.cfg.max_outer_iteration),
            max_inner_iteration=self.budget_inner,
            inner_schedule=None,
        )
        self.basis = make_basis(self.tick_cfg)
        self._alpha: Optional[jnp.ndarray] = None

        cfg = self.tick_cfg

        # The basis is bound as a traced argument (functools.partial), never
        # a jit closure constant.
        if self.batched:
            if self.engine == "fleet":
                from .fleet import fleet_solve

                solver_name = self.solver

                def _solve_impl(basis: Basis, scn: Scenario, alpha0) -> SolveResult:
                    return fleet_solve(cfg, basis, scn, alpha0, solver=solver_name)
            else:
                solver_name = self.solver

                def _solve_impl(basis: Basis, scn: Scenario, alpha0) -> SolveResult:
                    return solve_batch(cfg, basis, scn, alpha0, solver=solver_name)

            def _init_impl(basis: Basis, scn: Scenario):
                return jax.vmap(
                    lambda s: init_alpha(cfg, basis, s.start, s.goal)
                )(scn)
        elif self.engine == "fleet":
            # Single scene through the fleet engine as a one-lane fleet: the
            # ladder folds every Armijo rung into one batched evaluation
            # instead of the sequential solver's serial trial loop.
            from .fleet import fleet_solve

            solver_name = self.solver

            def _solve_impl(basis: Basis, scn: Scenario, alpha0) -> SolveResult:
                scn_b = jax.tree_util.tree_map(lambda x: x[None], scn)
                res = fleet_solve(cfg, basis, scn_b, alpha0[None],
                                  solver=solver_name)
                return jax.tree_util.tree_map(lambda x: x[0], res)

            def _init_impl(basis: Basis, scn: Scenario):
                return init_alpha(cfg, basis, scn.start, scn.goal)
        else:
            from . import bls as _bls
            from . import gd as _gd

            fn = {"bls": _bls.solve, "gd": _gd.solve}[self.solver]

            def _solve_impl(basis: Basis, scn: Scenario, alpha0) -> SolveResult:
                return fn(cfg, basis, scn, alpha0)

            def _init_impl(basis: Basis, scn: Scenario):
                return init_alpha(cfg, basis, scn.start, scn.goal)

        def _rollout_impl(basis: Basis, alpha0, scn_ticks: Scenario):
            """The whole replanning loop ON DEVICE: lax.scan over the tick
            axis, carrying the warm-start alpha.  One dispatch replans N
            ticks (per-tick host dispatch pays the dispatch latency per
            tick; the scan pays it once)."""

            def step(alpha, scn):
                res = _solve_impl(basis, scn, alpha)
                return res.alpha, res.stats

            return jax.lax.scan(step, alpha0, scn_ticks)

        self._solve_jit = jax.jit(_solve_impl)
        self._solve_fn = functools.partial(self._solve_jit, self.basis)
        self._init_fn = functools.partial(jax.jit(_init_impl), self.basis)
        self._rollout_fn = functools.partial(jax.jit(_rollout_impl), self.basis)

    def reset(self) -> None:
        """Drop the warm start (next tick refits the smoothstep init)."""
        self._alpha = None

    def plan(self, scn: Scenario) -> SolveResult:
        """One replanning tick: solve ``scn`` warm-started from the previous
        tick's solution.  The first tick (or after reset) initializes from
        the smoothstep fit."""
        alpha0 = self._alpha if self._alpha is not None else self._init_fn(scn)
        result = self._solve_fn(scn, alpha0)
        self._alpha = result.alpha
        return result

    def plan_rollout(self, scn_ticks: Scenario):
        """Replan a whole obstacle-motion rollout in ONE device dispatch.

        ``scn_ticks`` has a leading tick axis on every leaf ((ticks, ...) or
        (ticks, B, ...) when batched): the streamed/predicted environment
        per tick.  Each tick solves under the budget caps, warm-started from
        the previous tick's alpha (lax.scan carry).  Returns (final
        SolveResult-alpha, per-tick SolveStats stacked on the tick axis);
        the warm start persists for subsequent ``plan``/``plan_rollout``
        calls."""
        first = jax.tree_util.tree_map(lambda x: x[0], scn_ticks)
        alpha0 = (
            self._alpha if self._alpha is not None else self._init_fn(first)
        )
        final_alpha, stats = self._rollout_fn(alpha0, scn_ticks)
        self._alpha = final_alpha
        return final_alpha, stats
