"""The trace reduction of benchmarks/trace_solve.py on hand-made events,
and its refusal to run without a GPU."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "trace_solve", os.path.join(REPO, "benchmarks", "trace_solve.py"))
trace_solve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_solve)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 10)], 15.0),           # overlap counted once
    ([(0, 10), (2, 3), (20, 5)], 15.0),   # nested interval and a gap
])
def test_union_ns(intervals, busy):
    assert trace_solve.union_ns(intervals) == busy


def test_reduce_trace():
    events = [("fusion.1", 0, 10), ("gemm", 10, 25), ("fusion.1", 50, 10),
              ("MemcpyD2H", 60, 5)]
    row = trace_solve.reduce_trace(events, inner_steps=2, window_ns=100)
    assert row["kernels"] == 3 and row["kernels_per_inner_step"] == 1.5
    assert row["copies"] == 1
    assert row["device_busy_s"] == pytest.approx(50e-9)
    assert row["device_s_per_inner_step"] == pytest.approx(25e-9)
    assert row["idle_share"] == pytest.approx(0.5)
    top = row["top_kernels"]
    assert [(k["name"], k["launches"]) for k in top] == [
        ("gemm", 1), ("fusion.1", 2), ("MemcpyD2H", 1)]
    assert top[1]["seconds"] == pytest.approx(20e-9)


@pytest.mark.parametrize("name,copy", [
    ("MemcpyD2H", True), ("MemcpyD2D", True), ("memcpy128", True),
    ("Memset", True), ("loop_multiply_fusion", False),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nt_align1>", False),
])
def test_is_copy(name, copy):
    assert trace_solve.is_copy(name) is copy


def test_refuses_without_gpu(capsys):
    """On the CPU the trace would hold no GPU stream and read as an idle
    device: the script exits non-zero before compiling and prints no row."""
    assert trace_solve.main(["--batch", "8"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "traces a GPU" in out.err
