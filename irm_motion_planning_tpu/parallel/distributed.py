"""Multi-host runtime: distributed launch + per-host global-array assembly.

The reference is single-process and CPU-pinned (ref: optimizer_GD.py:11,
optimizer_BLS.py:19); this module is the multi-process launch layer
(SURVEY.md §5.8): each host process calls
:func:`initialize_distributed` once before any JAX computation, builds its
LOCAL slice of the global scenario batch (:func:`local_batch_slice`),
assembles the global sharded arrays without any host ever materializing the
full batch (:func:`global_scenarios_from_local`, backed by
``jax.make_array_from_process_local_data``), and runs the mesh/shard_map
solvers from :mod:`.sharded` — XLA inserts the collectives (NCCL between
GPUs, gloo between CPU processes); only the psum-reduced fleet statistics
cross hosts.

Validated clusterlessly by ``tests/test_distributed.py``: two spawned CPU
processes (gloo collectives) solve a global batch end to end, and the
multi-process result matches the single-process result lane for lane.
``benchmarks/scaling.py --spawn N`` is the matching launcher.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from ..ops.scenario import Scenario
from .mesh import scenario_sharding

_COORD_ENV_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime (multi-host).

    Returns True when the distributed runtime is (now or already) live.

    * Pass coordinator/num_processes/process_id (or set
      ``COORDINATOR_ADDRESS`` plus ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``).
      Nothing is auto-detected from the environment beyond those variables.
    * Multi-process intent is never silently dropped: a configured
      coordinator that fails to form the cluster PROPAGATES the error, and
      num_processes/process_id without any coordinator raises.
    * With nothing configured this is an explicit no-op returning False
      (plain single-process execution).
    """
    if jax.distributed.is_initialized():
        return True
    if coordinator_address is None:
        for var in _COORD_ENV_VARS:
            if os.environ.get(var):
                coordinator_address = os.environ[var]
                break
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            # Explicit multi-process intent with no way to reach peers.
            raise ValueError(
                "num_processes/process_id configured but no coordinator "
                "address; set COORDINATOR_ADDRESS or pass "
                "coordinator_address"
            )
        return False
    # Cross-process collectives on the CPU backend need gloo.  Checked via
    # the environment, NOT jax.default_backend(): that call would initialize
    # the XLA backend, which must not happen before distributed.initialize.
    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kw = {}
    if initialization_timeout is not None:
        kw["initialization_timeout"] = initialization_timeout
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )
    return True


def local_batch_slice(global_batch: int, n_processes: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The slice of a global scenario batch owned by this host process.

    The global batch must divide evenly (pad with zero-weight scenarios via
    ``mesh.pad_to_multiple`` otherwise)."""
    n = jax.process_count() if n_processes is None else n_processes
    i = jax.process_index() if index is None else index
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} must be a multiple of the process "
            f"count {n}"
        )
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def global_scenarios_from_local(mesh, local: Scenario) -> Scenario:
    """Assemble the globally-sharded Scenario from this host's local shard.

    Every leaf's leading axis is this host's ``local_batch_slice`` of the
    global batch; the result is a global jax.Array sharded over the mesh's
    scenario axis, built with ``jax.make_array_from_process_local_data`` —
    no host ever holds the full batch, and no data crosses hosts here (each
    host's shard lands on its own devices)."""
    sharding = scenario_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)
        ),
        local,
    )
