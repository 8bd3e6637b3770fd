"""The plain reference against the port's plain path (CPU, float64): at a
small bank, over the survey's first 300 ticks (every update of the schedule
at least once, the ADCP gate included), both configurations agree to
rounding, tick by tick and in the final state."""

import pytest
import torch

from .helpers import small_spec

CELLS = ["pose_fleet.survey_aided", "pose_montecarlo.survey_aided", "pose_montecarlo.survey_unaided"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_port_plain_path(cell):
    from portbench import run as R
    from portbench.reference import replay

    spec = small_spec(cell)
    res = R.run(spec, 2**33 + 5, 1e9, False, "cpu", max_ticks=200,
                numbers=replay.all_numbers(spec["mix"]["updates"]))
    num = res["verdict"].numbers
    assert res["ticks"] == 200 and res["lost"] == 0
    for key in ("track_sigma", "trace_rel", "dvl_nis", "final_mean_sigma", "final_cov_rel"):
        assert num[key] < 1e-7, (key, num[key])
    assert num["gate_mismatch"] == 0


def test_reference_process_noise_and_start():
    """The reference's own process noise and initial covariance are SPD and
    carry the configured scales (the Euler terms of the maximum jerk, the
    position prior)."""
    from portbench.reference import pose_ukf as ref

    spec = small_spec("pose_fleet.survey_aided")
    cfg = spec["config"]["filter"]
    q = ref.process_noise(cfg, 0.01, torch.float64, "cpu")
    assert torch.allclose(q[6, 6], torch.tensor(1.5 * 0.01**2 * (0.5 * 0.25) ** 2, dtype=torch.float64))
    assert torch.allclose(q[0, 0], torch.tensor(1.5 * 0.01**4 * (0.25 / 6.0) ** 2, dtype=torch.float64))
    assert bool((torch.linalg.eigvalsh(q) > 0).all())
    p0 = ref.initial_cov(cfg, 0.25, 1e-4, torch.float64, "cpu")
    assert float(p0[0, 0]) == 0.25 and float(p0[3, 3]) == 1e-4
    assert bool((torch.linalg.eigvalsh(p0) > 0).all())


def test_reference_manifold_round_trip():
    from portbench.reference import pose_ukf as ref

    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 54, generator=g, dtype=torch.float64)
    x[:, ref.QUAT] = x[:, ref.QUAT] / x[:, ref.QUAT].norm(dim=-1, keepdim=True)
    d = 0.1 * torch.randn(5, 53, generator=g, dtype=torch.float64)
    assert torch.allclose(ref.boxminus(ref.boxplus(x, d), x), d, atol=1e-12)
