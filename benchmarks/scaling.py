"""Scaling-efficiency sweep: solves/s at 1, 2, 4, ... N devices — single- or
multi-process.

BASELINE.json configs[4]: 100k+ scenarios sharded across a mesh with
collective convergence reductions; report the solves/s scaling curve and
efficiency vs linear scaling.

On a multi-GPU host this measures NCCL-connected throughput; on a single
host it runs on virtual devices (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) to validate the scaling
HARNESS (virtual CPU devices share cores, so efficiency numbers there are
not hardware-meaningful).

Multi-host (the reference is single-process, ref: optimizer_BLS.py:19;
this is the replacement runtime):

    # on each host:
    python benchmarks/scaling.py --coordinator host0:1234 \
        --num-processes 4 --process-id $I

    # clusterless validation: spawn N local CPU processes that form a
    # jax.distributed cluster over gloo and solve ONE global batch
    python benchmarks/scaling.py --spawn 2 --per-device 16 ...

Each process builds only its local_batch_slice of the global batch and the
global sharded arrays are assembled with
jax.make_array_from_process_local_data (parallel/distributed.py).

Usage:
    python benchmarks/scaling.py --per-device 512 --repeats 3
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import subprocess
import sys
import time

import jax

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.parallel import distributed as dist
from irm_motion_planning_tpu.parallel import mesh as meshlib
from irm_motion_planning_tpu.parallel import sharded
from irm_motion_planning_tpu.utils import compile_cache


def measure(cfg, basis, n_devices, per_device, repeats, solver="bls",
            engine="fleet"):
    devices = jax.devices()[:n_devices]
    mesh = meshlib.make_mesh(devices)
    batch = per_device * n_devices
    if jax.process_count() > 1:
        # Multi-host: each process constructs ONLY its local slice of the
        # global batch and contributes it to the global sharded arrays.
        sl = dist.local_batch_slice(batch)
        local = mp.replicate_scenario(
            mp.reference_scenario(cfg), sl.stop - sl.start
        )
        scns = dist.global_scenarios_from_local(mesh, local)
    else:
        scns = mp.replicate_scenario(mp.reference_scenario(cfg), batch)
        scns = meshlib.shard_batch(mesh, scns)
    run = sharded.make_shard_map_solver(
        cfg, basis, mesh, solver=solver, engine=engine
    )

    def run_to_completion():
        _, stats = run(scns)
        return float(stats["mean_final_cost"])

    run_to_completion()  # compile + warm-up
    times = []
    for _ in range(repeats):
        t0 = time.time()
        run_to_completion()
        times.append(time.time() - t0)
    best = min(times)
    return batch / best


def spawn_local_cluster(n: int, argv) -> int:
    """Clusterless multi-host validation: fork n copies of this script that
    form a real jax.distributed cluster (gloo over localhost), each owning
    2 virtual CPU devices.  Process 0's JSON line is the result."""
    # Port derived from the parent pid: concurrent --spawn runs (or a
    # lingering TIME_WAIT socket from a crashed one) must not collide on a
    # fixed coordinator port.
    port = 20000 + os.getpid() % 20000
    procs = []
    for i in range(n):
        env = dict(
            os.environ,
            PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
        )
        cmd = [sys.executable, os.path.abspath(__file__),
               "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", str(n), "--process-id", str(i)] + argv
        # Non-zero ranks: DEVNULL, not PIPE — nothing reads their stdout
        # before wait(), so any output past the pipe buffer would deadlock.
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.DEVNULL if i else None,
            stderr=subprocess.DEVNULL if i else None,
        ))
    rc = 0
    for i, pr in enumerate(procs):
        pr.wait()
        rc = rc or pr.returncode
    return rc


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--per-device", type=int, default=512)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--max-devices", type=int, default=0, help="0 = all")
    p.add_argument("--max-inner-iteration", type=int, default=200)
    p.add_argument("--max-outer-iteration", type=int, default=10)
    p.add_argument("--engine", choices=["fleet", "vmap"], default="fleet")
    # Multi-host launch (parallel/distributed.py).
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (multi-host)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--spawn", type=int, default=0,
                   help="spawn N local CPU processes forming a "
                        "jax.distributed cluster (clusterless validation)")
    args = p.parse_args()

    if args.spawn:
        argv = []
        skip = 0
        for a in sys.argv[1:]:
            if skip:
                skip -= 1
                continue
            if a == "--spawn":
                skip = 1
                continue
            if a.startswith("--spawn="):
                continue
            argv.append(a)
        sys.exit(spawn_local_cluster(args.spawn, argv))

    # Must run before any backend-initializing JAX call.
    dist.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id
    )
    compile_cache.enable()

    cfg = mp.PlannerConfig(
        bls_mode="ladder",
        max_inner_iteration=args.max_inner_iteration,
        max_outer_iteration=args.max_outer_iteration,
    )
    basis = mp.make_basis(cfg)

    n_all = len(jax.devices())
    if args.max_devices:
        n_all = min(n_all, args.max_devices)
    if jax.process_count() > 1:
        # Multi-host: every process must participate in every computation,
        # so only the full mesh is measured (run per-count sweeps
        # single-process per host instead).
        counts = [n_all]
    else:
        counts = []
        n = 1
        while n <= n_all:
            counts.append(n)
            n *= 2
        if counts[-1] != n_all and n_all not in counts:
            counts.append(n_all)

    results = []
    base_per_device = None
    for n in counts:
        sps = measure(cfg, basis, n, args.per_device, args.repeats,
                      args.solver, args.engine)
        if base_per_device is None:
            base_per_device = sps / n
        eff = sps / (base_per_device * n)
        results.append(
            {"devices": n, "solves_per_sec": round(sps, 1),
             "efficiency_vs_linear": round(eff, 3)}
        )
        if jax.process_index() == 0:
            print(json.dumps(results[-1]), file=sys.stderr)

    if jax.process_index() == 0:
        print(json.dumps({
            "metric": "scaling_sweep",
            "platform": jax.devices()[0].platform,
            "processes": jax.process_count(),
            "per_device_batch": args.per_device,
            "points": results,
        }))


if __name__ == "__main__":
    main()
