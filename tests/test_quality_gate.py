"""The cross-device quality gate scripts stay runnable (CPU only).

The real gate compares the GPU against the CPU reference (see
benchmarks/quality.py and CLAUDE.md's numerics invariants); this keeps the
harness itself from rotting: it must run end to end, emit valid JSON, and
pass trivially when comparing a device against itself.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quality_seed_sweep_harness():
    """The seed-sweep harness (benchmarks/quality_sweep.py) must run end to
    end and emit per-seed deltas + sign statistics (the real sweep compares
    the GPU against the CPU reference)."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "quality_sweep.py"),
         "--seeds", "0,1", "--batch", "32", "--devices", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["metric"] == "quality_seed_sweep"
    assert len(verdict["per_seed"]) == 2


def test_quality_gate_cpu_xla():
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "quality.py"),
         "--batch", "64", "--inner", "5", "--devices", "cpu,cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["metric"] == "quality_distribution_gate"
    assert verdict["pass"] is True
    stats = verdict["devices"]["cpu"]
    assert 0.0 <= stats["converged_frac"] <= 1.0
    assert stats["avg_cost_mean"] > 0.0


def test_certification_harness_cpu(tmp_path):
    """The north-star certification harness (benchmarks/certify.py) runs
    end to end on CPU: the sequential parity oracle over a small scene
    batch, then the paired engine phase (fleet ladder), emitting the
    outcome-conditioned gap statistics.  The real certification runs the
    fleet engine on the GPU at N=8192; this pins the
    harness AND the two distribution-dominance invariants the round-5
    ladder fix restored: the engine's converged fraction must dominate the
    oracle's, and the both-converged median gaps stay within the 0.1%
    north-star bound."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    oracle = str(tmp_path / "oracle.npz")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "certify.py"),
         "--phase", "oracle", "--batch", "96", "--out", oracle],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["nonfinite"] == 0

    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "certify.py"),
         "--phase", "engine", "--oracle", oracle, "--tiers", "exact"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    # The pass/fail gates are N=8192 distribution claims (binomial noise at
    # N=96 is ~+/-9pt on conv, ~+/-1% on subset means) — here we pin the
    # HARNESS: valid verdict JSON, outcome classes partition the batch, and
    # finite paired statistics on every non-empty class.
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["metric"] == "final_cost_gap_certification"
    tier = verdict["tiers"]["exact"]
    n_classes = sum(
        tier[c]["avg"].get("n", 0)
        for c in ("both_converged", "neither_converged",
                  "engine_only_converged", "oracle_only_converged")
    )
    assert n_classes == tier["all"]["avg"]["n"] == 96
    for c in ("both_converged", "neither_converged", "all"):
        st = tier[c]["avg"]
        if st.get("n"):
            assert abs(st["mean_gap"]) < 0.5, (c, st)
