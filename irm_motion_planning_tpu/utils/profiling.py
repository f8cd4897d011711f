"""Profiling hook (capability of ref: main.py:131-134).

Wraps a region in ``jax.profiler.trace``, which traces the GPU too
(xplane/Perfetto traces; benchmarks/trace_solve.py reduces one).  The
reference hardcoded an absolute home directory; we default to ./jax-trace
and make the Perfetto link opt-in.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(log_dir: str = "jax-trace", perfetto_link: bool = False):
    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir, create_perfetto_link=perfetto_link):
        yield
