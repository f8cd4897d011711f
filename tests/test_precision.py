"""Every matrix product of every solver path runs at HIGHEST precision.

An f32 dot without an explicit precision may run as TF32 on a GPU (a 10-bit
mantissa).  The RKHS fit's O(1e4) coefficients cancel to O(1) trajectories,
so TF32 breaks the quality gates.  Each path is lowered on CPU (no
compilation) and every ``dot_general`` in its StableHLO must carry HIGHEST
for both operands — the precision set in one place,
models/rkhs.py::_precision.
"""

import re

import jax
import jax.numpy as jnp
import pytest

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.models import rkhs, robot
from irm_motion_planning_tpu.solvers import batched, bls, fleet, gd
from irm_motion_planning_tpu.solvers.replan import Replanner

CFG = mp.PlannerConfig(
    n_timesteps=8, max_obstacles=11, max_outer_iteration=2,
    max_inner_iteration=2, max_bls_iteration=3, fixed_iters=True,
)
B = 4


def _inputs(cfg=CFG):
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(0), B)
    scn = jax.tree_util.tree_map(lambda x: x[0], scns)
    alpha = 0.1 * jnp.ones((cfg.n_timesteps, cfg.n_joints), jnp.float32)
    return basis, scns, scn, alpha


def _fleet(solver, ladder_eval="linearized"):
    cfg = CFG.replace(ladder_eval=ladder_eval)
    basis, scns, _, _ = _inputs(cfg)
    return jax.jit(lambda b, s: fleet.fleet_solve(cfg, b, s, solver=solver)), (
        basis, scns)


def _vmap(solver):
    basis, scns, _, _ = _inputs()
    return jax.jit(lambda b, s: batched.solve_batch(CFG, b, s, solver=solver)), (
        basis, scns)


def _sequential(module):
    cfg = CFG.replace(bls_mode="sequential", fixed_iters=False)
    basis, _, scn, _ = _inputs(cfg)
    return jax.jit(lambda b, s: module.solve(cfg, b, s)), (basis, scn)


def _plain_step():
    # The Python-loop solver's per-step math outside its jitted cost ops.
    _, _, _, alpha = _inputs()
    return jax.jit(lambda g: bls.descent_direction(CFG, g)), (alpha,)


def _replan_tick():
    rp = Replanner(CFG, budget_outer=1, budget_inner=2, engine="fleet")
    _, _, scn, alpha = _inputs()
    return rp._solve_jit, (rp.basis, scn, alpha)


def _basis_and_init():
    _, _, scn, _ = _inputs()
    return jax.jit(lambda s, g: mp.init_alpha(CFG, rkhs.fit_basis(CFG), s, g)), (
        scn.start, scn.goal)


def _evaluate_at():
    basis, _, _, alpha = _inputs()
    ts = jnp.linspace(0.0, 1.0, 5)
    return jax.jit(lambda a, t: mp.evaluate_at(CFG, basis, a, t)), (alpha, ts)


def _cost_and_grad():
    basis, _, scn, alpha = _inputs()
    pen = mp.initial_penalty(CFG)
    return jax.jit(lambda s, a: mp.cost_and_grad(CFG, basis, s, pen, a)), (
        scn, alpha)


def _robot_fk():
    _, _, _, alpha = _inputs()
    return jax.jit(lambda q: (robot.fk(CFG, q), robot.fk_joint(CFG, q, 2))), (
        alpha,)


PATHS = {
    "fleet_bls_linearized": lambda: _fleet("bls"),
    "fleet_bls_exact": lambda: _fleet("bls", "exact"),
    "fleet_gd": lambda: _fleet("gd"),
    "vmap_bls": lambda: _vmap("bls"),
    "vmap_gd": lambda: _vmap("gd"),
    "sequential_bls": lambda: _sequential(bls),
    "sequential_gd": lambda: _sequential(gd),
    "plain_loop_step": _plain_step,
    "replanner_tick": _replan_tick,
    "make_basis_init_alpha": _basis_and_init,
    "evaluate_at": _evaluate_at,
    "cost_and_grad": _cost_and_grad,
    "robot_fk": _robot_fk,
}

_DOT = re.compile(r"stablehlo\.dot_general[^\n]*")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_dot_is_highest(path):
    fn, args = PATHS[path]()
    text = fn.lower(*args).as_text()
    dots = _DOT.findall(text)
    assert dots, f"{path}: no dot_general lowered"
    loose = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not loose, f"{path}: {len(loose)} of {len(dots)} dots not HIGHEST:\n" + (
        "\n".join(loose[:3]))
