"""Worker process for tests/test_distributed.py: one host of a 2-process
jax.distributed CPU cluster solving a global scenario batch.

Each process builds ONLY its local_batch_slice of the global batch,
assembles the global sharded arrays with global_scenarios_from_local
(jax.make_array_from_process_local_data), runs the shard_map fleet solver,
and dumps its addressable result shards + the replicated psum stats."""

import sys

import numpy as np


def main():
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]

    from irm_motion_planning_tpu.parallel import distributed as dist

    assert dist.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )

    import jax

    assert jax.process_count() == num_processes

    import irm_motion_planning_tpu as mp
    from irm_motion_planning_tpu.parallel import mesh as meshlib
    from irm_motion_planning_tpu.parallel import sharded

    cfg = mp.PlannerConfig(
        n_timesteps=16, fixed_iters=True,
        max_inner_iteration=3, max_outer_iteration=2, max_bls_iteration=4,
    )
    basis = mp.make_basis(cfg)
    mesh = meshlib.make_mesh()

    batch = 8
    # Deterministic global batch; every process slices out only its share.
    scns_global = mp.random_scenarios(cfg, jax.random.PRNGKey(3), batch)
    sl = dist.local_batch_slice(batch)
    local = jax.tree_util.tree_map(lambda x: np.asarray(x)[sl], scns_global)
    scns = dist.global_scenarios_from_local(mesh, local)

    run = sharded.make_shard_map_solver(cfg, basis, mesh, engine="fleet")
    res, stats = run(scns)
    jax.block_until_ready(res)

    shards = {}
    for s in res.alpha.addressable_shards:
        start = s.index[0].start or 0
        shards[f"alpha_{start}"] = np.asarray(s.data)
    np.savez(
        f"{outdir}/proc{process_id}.npz",
        n_total=float(stats["n_total"]),
        converged_fraction=float(stats["converged_fraction"]),
        mean_final_cost=float(stats["mean_final_cost"]),
        max_final_cost=float(stats["max_final_cost"]),
        **shards,
    )


if __name__ == "__main__":
    main()
