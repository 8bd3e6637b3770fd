"""End-to-end example tests — the ATE north-star acceptance check.

BASELINE.md north star: "trajectory accuracy: ATE within C++ reference bound
on ICRA'18-style sequences". The reference publishes no numeric bound
(SURVEY.md §6), so the acceptance criterion is the one that matters in the
field: sub-decimeter ATE and sub-degree heading error on a model-aided
IMU+DVL+pressure survey, including a DVL-dropout window (the robustness
claim of ``/root/reference/README.md:10``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import icra18_mission


def test_icra18_mission_ate_bound():
    ate, dist = icra18_mission.main(["--cpu", "--minutes", "1.0", "--dtype", "f64"])
    assert dist > 30.0
    # north-star acceptance: centimetre-class ATE on a fully-aided sequence
    assert ate < 0.10, f"ATE {ate:.3f} m exceeds the 10 cm acceptance bound"


def test_icra18_mission_dvl_dropout_coasts():
    ate, dist = icra18_mission.main(
        ["--cpu", "--minutes", "1.5", "--dtype", "f64", "--dvl-dropout", "30,60"]
    )
    # 30 s of coasting on IMU+pressure (a third of the mission): drift must
    # stay bounded — ~0.5 m ATE over a ~70 m track (measured 0.52 m)
    assert ate < 1.0, f"dropout ATE {ate:.3f} m — model-aided coasting failed"


def test_full_stack_auv_all_filters_track():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import full_stack_auv

    wall = full_stack_auv.main(seconds=10.0)
    assert wall < 120.0


def test_noise_tuning_sweep_brackets_consistency():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import noise_tuning_sweep

    best = noise_tuning_sweep.main(candidates=6, seconds=10.0)
    assert 0.05 < best < 5.0


def test_example_clis_parse():
    """Every example's argument parser works (catches signature drift)."""
    import subprocess

    root = Path(__file__).resolve().parents[1]
    for name in (
        "icra18_mission.py",
        "fleet_monte_carlo.py",
        "online_estimator.py",
    ):
        out = subprocess.run(
            [sys.executable, str(root / "examples" / name), "--help"],
            capture_output=True,
            text=True,
            timeout=120,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        )
        assert out.returncode == 0, f"{name} --help failed: {out.stderr[-500:]}"


def test_fleet_monte_carlo_runs_at_low_rate():
    """Execute the fleet example end-to-end (the --help-only check missed a
    crash here once): low --rate exercises the dvl_every guard, and the run
    covers the NEES reduction, failover heal, and sharded-bank path."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import fleet_monte_carlo

    fleet_monte_carlo.main(["--bank", "8", "--seconds", "1", "--rate", "2", "--cpu"])


def test_online_estimator_runs_off_tpu():
    """Execute the online-ingest example end-to-end off-TPU (regression: the
    lanes kernels were launched with interpret=False on CPU and crashed, and
    gyro ticks without an event integrated a zero rate instead of the
    forward-filled last value)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import online_estimator

    rt = online_estimator.main(
        ["--cpu", "--bank", "4", "--seconds", "2", "--rate", "5"]
    )
    assert rt > 0


@pytest.mark.time_limit(210)
def test_online_estimator_fused_step_mode():
    """--fused-step dispatches predict + the tick's sensor updates through
    the single-launch step_lanes kernel; the loop must converge identically
    (same math, one launch) off-TPU in interpret mode."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import online_estimator

    rt = online_estimator.main(
        ["--cpu", "--bank", "4", "--seconds", "2", "--rate", "5", "--fused-step"]
    )
    assert rt > 0
