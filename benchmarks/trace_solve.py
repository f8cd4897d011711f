"""Device-trace breakdown of one fixed-horizon fleet solve on the GPU.

Runs bench.py's configuration (reference scene replicated, BLS, the
per-round reference schedule) once to compile and warm up, then once more
under ``jax.profiler.trace``, and reduces the device trace to:

* compute kernels launched, and kernels per inner step (memory copies and
  sets are counted apart),
* device busy time (union of kernel and copy intervals) and device time per
  inner step,
* the device's idle share over the host's timed window of the solve,
* the kernels that take the most device time, with their launch counts.

Usage:  python benchmarks/trace_solve.py [--batch N] [--out DIR]
Prints one JSON line; the raw trace stays under --out.  Exits 2 without a
GPU: the trace reads the GPU's stream lines only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import collections
import glob
import json
import re
import time

import jax

import bench
import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import fleet
from irm_motion_planning_tpu.utils import compile_cache

# CUPTI's copy/set activities (MemcpyD2H, MemcpyD2D, Memset) and the
# runtime's copy kernel (memcpy128) share the stream line with the kernels.
_COPY = re.compile(r"(?i)^mem(cpy|set)")


def is_copy(name: str) -> bool:
    return bool(_COPY.match(name))


def device_events(xplane_path):
    """(name, start_ns, duration_ns) of every event on every GPU stream of
    the trace, plus {line name: event count} of the device planes."""
    from jax.profiler import ProfileData

    events, lines = [], {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            # "Stream #N(...)" lines hold the kernels and copies as the
            # device ran them; the other lines re-group the same events.
            if line.name.startswith("Stream"):
                events += [(e.name, e.start_ns, e.duration_ns) for e in evs]
    return events, lines


def union_ns(intervals) -> float:
    """Total length covered by (start, duration) intervals."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def reduce_trace(events, inner_steps: int, window_ns: float, top: int = 8):
    """Per-solve device metrics from stream events.  ``window_ns`` is the
    host's timed window of the solve."""
    busy = union_ns((s, d) for _, s, d in events)
    launches, seconds = collections.Counter(), collections.Counter()
    for name, _, dur in events:
        launches[name] += 1
        seconds[name] += dur * 1e-9
    kernels = sum(n for name, n in launches.items() if not is_copy(name))
    return {
        "kernels": kernels,
        "kernels_per_inner_step": kernels / inner_steps,
        "copies": len(events) - kernels,
        "device_busy_s": busy * 1e-9,
        "device_s_per_inner_step": busy * 1e-9 / inner_steps,
        "window_s": window_ns * 1e-9,
        "idle_share": 1.0 - busy / window_ns if window_ns else None,
        "top_kernels": [
            {"name": name, "launches": launches[name], "seconds": s}
            for name, s in seconds.most_common(top)
        ],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=bench.DEFAULT_BATCH)
    p.add_argument("--out", default="jax-trace")
    args = p.parse_args(argv)
    dev = bench.device_info()
    if dev["platform"] != "gpu":
        print(f"error: trace_solve.py traces a GPU; JAX found {dev}",
              file=sys.stderr)
        return 2
    compile_cache.enable()

    cfg = bench.bench_config("bls")
    basis = mp.make_basis(cfg)
    scns = mp.replicate_scenario(mp.reference_scenario(cfg), args.batch)
    run, compile_s, _ = bench.compile_solver(
        fleet.make_fleet_solver(cfg, basis), scns)
    jax.block_until_ready(run(scns))  # warm-up outside the trace

    with jax.profiler.trace(args.out):
        t0 = time.perf_counter_ns()
        jax.block_until_ready(run(scns))
        window_ns = time.perf_counter_ns() - t0
    path = sorted(glob.glob(os.path.join(
        args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    events, lines = device_events(path)
    inner_steps = sum(cfg.inner_schedule)
    print(json.dumps({
        "metric": "fleet_solve_device_trace",
        "device": dev,
        "nvidia_smi": bench.smi_line(),
        "batch": args.batch,
        "inner_steps": inner_steps,
        "compile_s": compile_s,
        **reduce_trace(events, inner_steps, window_ns),
        "device_lines": lines,
        "trace": path,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
