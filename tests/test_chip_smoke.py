"""chip_smoke.py on CPU: its output contract, its failure paths, and every
phase at tiny size on an explicit CPU device.  The full-size run needs the
card: ``python chip_smoke.py``."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from irm_motion_planning_tpu.utils import compile_cache  # noqa: E402

TINY = chip_smoke.Sizes(fleet=8, exact=8, random=32, reference=16, ticks=3,
                        rollout_arms=4, rollout_ticks=2, cli=4, per_card=4)


@pytest.fixture
def on_cpu(monkeypatch):
    """Let the phases accept the CPU and keep the persistent compile cache
    off for the rest of the test session."""
    monkeypatch.setattr(chip_smoke, "REQUIRED_PLATFORM", "cpu")
    monkeypatch.setattr(compile_cache, "enable", lambda: "")
    return jax.devices("cpu")[0]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_final_line_shape():
    devs = jax.devices()
    line = chip_smoke.final_line(True)
    assert line == json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def test_non_gpu_platform_fails(capsys):
    rc = chip_smoke.main([], sizes=TINY)
    assert rc != 0
    out = capsys.readouterr().out
    assert _last_json(out) == json.loads(chip_smoke.final_line(False))
    assert "[device]" not in out  # no phase ran


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_failing_phase_gives_nonzero_exit(on_cpu, monkeypatch, capsys):
    def boom(device, sizes):
        raise RuntimeError("phase broke")

    ran = []
    monkeypatch.setattr(chip_smoke, "phases_for", lambda four: (
        ("boom", boom), ("after", lambda d, s: ran.append(True))))
    assert chip_smoke.main([], sizes=TINY) == 1
    out = capsys.readouterr().out
    assert "[boom] FAIL" in out and ran == [True]
    assert _last_json(out)["ok"] is False


def test_passing_phases_exit_zero(on_cpu, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "phases_for",
                        lambda four: (("fine", lambda d, s: None),))
    assert chip_smoke.main([], sizes=TINY) == 0
    assert _last_json(capsys.readouterr().out)["ok"] is True


@pytest.mark.parametrize("four_cards", [False, True])
def test_four_cards_option_selects_its_phase(on_cpu, monkeypatch, four_cards):
    seen = []
    monkeypatch.setattr(chip_smoke, "run_phases",
                        lambda phases, device, sizes: seen.extend(
                            n for n, _ in phases) or True)
    chip_smoke.main(["--four-cards"] if four_cards else [], sizes=TINY)
    if four_cards:
        assert seen == ["device", "four_cards"]
    else:
        assert "four_cards" not in seen and "cli" in seen


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.SINGLE_CARD])
def test_phase_at_tiny_size(on_cpu, name, capsys):
    dict(chip_smoke.SINGLE_CARD)[name](on_cpu, TINY)


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_four_cards_phase_on_virtual_devices(on_cpu, solver, capsys):
    """The sharded fleet on 4 virtual CPU devices against the per-device
    solves of each shard: the rehearsal of ``--four-cards``."""
    chip_smoke.phase_four_cards(on_cpu, TINY, n_cards=4, solver=solver)
    out = capsys.readouterr().out
    assert "lanes_bitwise_equal_to_per_card_solves=1.000000" in out


@pytest.mark.parametrize("perturb,ok", [
    ({}, True),
    ({"sub_conv": 0.40}, False),      # converged fraction off by 10 points
    ({"sub_cost": 2.1}, False),       # mean obstacle cost off by 5%
    ({"phantom": 3 / 100}, False),    # three phantom lanes of 100
])
def test_paired_bands(perturb, ok):
    args = dict(sub_conv=0.30, ref_conv=0.30, sub_cost=2.0, ref_cost=2.0,
                phantom=0.0, n=100)
    args.update(perturb)
    passed, fields = bench.paired_bands(**args)
    assert passed is ok
    assert fields["paired_check_lanes"] == 100


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_paired_gate_reference_fits_its_own_basis(shift):
    """The CPU reference never starts from the caller's basis: with the
    caller's init coefficients shifted, the reference is unchanged and the
    shift is reported."""
    import irm_motion_planning_tpu as mp
    from irm_motion_planning_tpu.solvers import fleet

    cfg = bench.bench_config("bls", inner=2)
    basis = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(3), 8)
    res = fleet.make_fleet_solver(cfg, basis)(scns)
    caller = basis._replace(init_u=basis.init_u + shift)
    _, fields, ref = bench.paired_gate(cfg, caller, scns, res, 4)
    own = bench.solve_on(jax.devices("cpu")[0], cfg, basis,
                         jax.tree_util.tree_map(lambda x: x[:4], scns))
    assert (ref.alpha == own.alpha).all()
    assert fields["init_u_max_abs_diff_vs_cpu_basis"] == pytest.approx(shift)


@pytest.mark.parametrize("text,expected", [
    ("NVIDIA H100 80GB HBM3, 400.00 W\n", ("NVIDIA H100 80GB HBM3", 400.0)),
    ("NVIDIA H100 PCIe, 350.00 W\nNVIDIA H100 PCIe, 350.00 W\n",
     ("NVIDIA H100 PCIe", 350.0)),
    ("NVIDIA H100 80GB HBM3, [N/A]", ("NVIDIA H100 80GB HBM3", None)),
])
def test_parse_smi(text, expected):
    assert bench.parse_smi(text) == expected
