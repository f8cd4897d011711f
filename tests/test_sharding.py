"""Multi-chip sharding tests on the 8-device virtual CPU mesh (conftest sets
--xla_force_host_platform_device_count=8) — the clusterless pattern for
validating mesh partitioning and collectives (SURVEY.md §4).

Exactness contract: sharding must not change the math.  The reference for a
sharded run is the SAME solver run per shard locally (identical lane
grouping -> identical fp path), and the comparison is BITWISE.  Comparing
against the full-batch unsharded run instead would need a loose tolerance
(the fleet engine folds the batch into GEMM lane dimensions, so per-lane fp
paths legitimately change with batch width) — which round 1 did with
rtol=7e-2, wide enough to hide real sharding bugs.  The full-batch relation
is covered distributionally by the psum-stats checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.parallel import mesh as meshlib
from irm_motion_planning_tpu.parallel import sharded
from irm_motion_planning_tpu.solvers import batched, fleet


@pytest.fixture(scope="module")
def cfg():
    return mp.PlannerConfig(
        fixed_iters=True, max_inner_iteration=10, max_outer_iteration=2
    )


@pytest.fixture(scope="module")
def eight_mesh(cpu_devices):
    assert len(cpu_devices) >= 8, "conftest must provide 8 virtual devices"
    return meshlib.make_mesh(cpu_devices[:8])


def _per_shard_local(solver_fn, scns, batch, n_shards):
    """Run the solver per shard locally (jitted), concatenate results —
    the bitwise reference for a sharded run."""
    per = batch // n_shards
    parts = []
    for i in range(0, batch, per):
        shard = jax.tree_util.tree_map(lambda x: x[i:i + per], scns)
        parts.append(np.asarray(solver_fn(shard).alpha))
    return np.concatenate(parts)


def test_sharded_solver_bitwise_matches_per_shard(cfg, eight_mesh):
    """jit+NamedSharding execution == running each device's shard locally,
    bitwise."""
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(0), 16)
    scns_sharded = meshlib.shard_batch(eight_mesh, scns)
    res = sharded.make_sharded_solver(cfg, basis, eight_mesh)(scns_sharded)
    # result really is sharded over the mesh
    assert len(res.alpha.sharding.device_set) == 8
    local = _per_shard_local(batched.make_batched_solver(cfg, basis),
                             scns, 16, 8)
    np.testing.assert_array_equal(np.asarray(res.alpha), local)


def test_shard_map_fleet_bitwise_matches_per_shard(cfg, eight_mesh):
    """shard_map + fleet engine (the production sharded configuration) ==
    per-shard local fleet runs, bitwise."""
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(1), 16)
    run = sharded.make_shard_map_solver(cfg, basis, eight_mesh,
                                        engine="fleet")
    res, _ = run(meshlib.shard_batch(eight_mesh, scns))
    solver = jax.jit(
        lambda b, s: fleet.fleet_solve(cfg, b, s)
    )
    local = _per_shard_local(lambda s: solver(basis, s), scns, 16, 8)
    np.testing.assert_array_equal(np.asarray(res.alpha), local)


def test_shard_map_collective_stats(cfg, eight_mesh):
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(1), 16)
    ref = batched.make_batched_solver(cfg, basis)(scns)
    ref_stats = batched.batch_summary(ref)

    run = sharded.make_shard_map_solver(cfg, basis, eight_mesh)
    res, stats = run(meshlib.shard_batch(eight_mesh, scns))
    # psum-reduced global stats equal the single-device reduction (the
    # 2e-2 allows vmap-engine full-batch fp divergence in final_cost)
    assert int(stats["n_total"]) == 16
    np.testing.assert_allclose(
        float(stats["mean_final_cost"]),
        float(ref_stats["mean_final_cost"]),
        rtol=2e-2,
    )
    # the shard_map program's own reduction must be self-consistent
    local = float(jnp.mean(jnp.asarray(res.stats.final_cost)))
    np.testing.assert_allclose(float(stats["mean_final_cost"]), local, rtol=1e-5)


def test_uneven_padding_helper():
    assert meshlib.pad_to_multiple(17, 8) == 24
    assert meshlib.pad_to_multiple(16, 8) == 16
