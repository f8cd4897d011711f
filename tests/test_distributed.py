"""Multi-host runtime integration test — REAL multi-process execution.

Spawns a 2-process jax.distributed CPU cluster (gloo collectives over
localhost, 2 virtual devices per process = 4 global devices); each process
builds only its local slice of an 8-scenario batch, assembles the global
sharded arrays via jax.make_array_from_process_local_data, and runs the
shard_map fleet solver with psum statistics.  The reference being replaced
is single-process by construction (ref: optimizer_BLS.py:19,
optimizer_GD.py:11).

Checks:
* both processes complete and report identical (replicated) psum stats,
* the union of the processes' result shards equals a single-process run of
  the same global batch on a 4-device mesh, lane for lane (same per-device
  lane grouping -> same fp path),
* a misconfigured launch (explicit coordinator, missing peer) raises
  rather than silently degrading to single-process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "distributed_worker.py")


def _spawn(n, port, outdir, timeout=240):
    procs = []
    for i in range(n):
        env = dict(
            os.environ,
            PYTHONPATH=REPO,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
        )
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(i), str(n), str(port), outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = [p.communicate(timeout=timeout) for p in procs]
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_two_process_cluster_matches_single_process(tmp_path):
    """The shard_map fleet engine crosses the process boundary:
    shard_map x multi-process gloo on CPU."""
    # pid-derived port: avoid collisions with concurrent runs / TIME_WAIT.
    port = 40000 + (os.getpid() * 3) % 20000
    results = _spawn(2, port, str(tmp_path))
    for rc, out, err in results:
        assert rc == 0, err[-3000:]

    d0 = np.load(tmp_path / "proc0.npz")
    d1 = np.load(tmp_path / "proc1.npz")
    # Replicated psum stats must be identical on every host.
    for k in ("n_total", "converged_fraction", "mean_final_cost",
              "max_final_cost"):
        np.testing.assert_allclose(d0[k], d1[k], rtol=1e-6)
    assert float(d0["n_total"]) == 8.0

    # Reassemble the global result from both processes' shards.
    alpha = np.zeros((8, 16, 3), np.float32)
    seen = np.zeros(8, bool)
    for d in (d0, d1):
        for k in d.files:
            if not k.startswith("alpha_"):
                continue
            start = int(k.split("_")[1])
            block = d[k]
            alpha[start:start + block.shape[0]] = block
            seen[start:start + block.shape[0]] = True
    assert seen.all()

    # Single-process baseline: same global batch, same 4-device mesh shape
    # (2 lanes per device -> identical per-device fp path).
    import jax

    import irm_motion_planning_tpu as mp
    from irm_motion_planning_tpu.parallel import mesh as meshlib
    from irm_motion_planning_tpu.parallel import sharded

    cfg = mp.PlannerConfig(
        n_timesteps=16, fixed_iters=True,
        max_inner_iteration=3, max_outer_iteration=2, max_bls_iteration=4,
    )
    basis = mp.make_basis(cfg)
    mesh = meshlib.make_mesh(jax.devices()[:4])
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(3), 8)
    scns = meshlib.shard_batch(mesh, scns)
    run = sharded.make_shard_map_solver(cfg, basis, mesh, engine="fleet")
    res, stats = run(scns)
    np.testing.assert_allclose(alpha, np.asarray(res.alpha), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(d0["mean_final_cost"]), float(stats["mean_final_cost"]),
        rtol=1e-5,
    )


def test_misconfigured_launch_fails_loudly():
    """An explicitly requested coordinator that cannot form the cluster must
    fail loudly (exception or fatal abort) — NOT silently fall back to
    single-process execution.  (JAX's coordination client aborts the process
    on registration deadline, so both failure shapes are accepted; the
    forbidden outcome is reaching the post-init code.)"""
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
    )
    out = subprocess.run(
        [sys.executable, "-c",
         "from irm_motion_planning_tpu.parallel import distributed as d\n"
         "import sys\n"
         "try:\n"
         "    d.initialize_distributed('127.0.0.1:1', num_processes=2,"
         " process_id=0, initialization_timeout=5)\n"
         "except Exception:\n"
         "    sys.exit(42)\n"
         "print('REACHED_POST_INIT')\n"
         "sys.exit(0)\n"],
        env=env, timeout=120, capture_output=True, text=True,
    )
    assert out.returncode != 0, "silent fallback to single-process"
    assert "REACHED_POST_INIT" not in out.stdout


def test_no_coordinator_is_noop():
    from irm_motion_planning_tpu.parallel import distributed as d

    env_backup = {k: os.environ.pop(k, None)
                  for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")}
    try:
        assert d.initialize_distributed() is False
    finally:
        for k, v in env_backup.items():
            if v is not None:
                os.environ[k] = v


def test_local_batch_slice():
    from irm_motion_planning_tpu.parallel import distributed as d

    assert d.local_batch_slice(8, n_processes=2, index=0) == slice(0, 4)
    assert d.local_batch_slice(8, n_processes=2, index=1) == slice(4, 8)
    with pytest.raises(ValueError):
        d.local_batch_slice(9, n_processes=2, index=0)
