"""Entry-point plumbing: the persistent compile cache's location, the CLI's
platform choice, and the kernel options that no longer exist."""

import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from irm_motion_planning_tpu import cli  # noqa: E402
from irm_motion_planning_tpu.utils import compile_cache  # noqa: E402


@pytest.fixture
def cache_config():
    """Restore the cache directory enable() may set."""
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_is_used_and_nothing_else_set(cache_config, monkeypatch,
                                              tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    # JAX reads the variable itself at import; enable() must leave the
    # settings exactly as they are.
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    before = dict(jax.config.values)
    assert compile_cache.enable() == str(tmp_path)
    assert dict(jax.config.values) == before


def test_default_is_fixed_repo_path(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable() == expected
    assert jax.config.jax_compilation_cache_dir == expected
    assert compile_cache.enable() == expected  # same path on every call


def test_cli_platform_gpu_without_card_fails(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "irm_motion_planning_tpu.cli",
         "--platform", "gpu", "--max-outer-iteration", "1",
         "--max-inner-iteration", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no gpu device" in out.stderr
    assert not (tmp_path / "trajectory_result.txt").exists()


REMOVED = [
    ("cli", ["--backend", "fused"]),
    ("cli", ["--pallas-block-b", "512"]),
    ("cli", ["--recip-newton", "false"]),
    ("cli", ["--lane-compaction", "true"]),
    ("cli", ["--bls-bf16-ladder", "true"]),
    ("bench", ["--backend", "fused"]),
    ("bench", ["--block-b", "128"]),
    ("bench", ["--recip-newton", "false"]),
    ("bench", ["--ladder-unroll", "2"]),
    ("bench", ["--lane-compaction", "true"]),
]


@pytest.mark.parametrize("entry,argv", REMOVED,
                         ids=[f"{e}{a[0]}={a[1]}" for e, a in REMOVED])
def test_removed_options_are_rejected(entry, argv, capsys):
    parser = {"cli": cli.build_parser, "bench": bench.build_parser}[entry]
    with pytest.raises(SystemExit) as e:
        parser().parse_args(argv)
    assert e.value.code == 2


def test_bench_refuses_a_non_gpu_device(capsys):
    assert bench.main(["--batch", "8"]) == 2
    assert "measures a GPU" in capsys.readouterr().err
