"""The port's public constructors build on the card unless asked for the CPU.

A constructor called with ``device=None`` resolves it through
``utils/device.resolve_device``: the card where there is one, and otherwise a
``RuntimeError`` that names ``device='cpu'``; ``device="cpu"`` builds on the
CPU. This file imports no JAX and runs in a second.
"""

import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics, geodesy, manifolds
from slam_uwv_kalman_filters_tpu_torch.utils import convert, delayed_states

CONSTRUCTORS = {
    "velocity_ukf.default_process_noise": lambda **kw: vu.default_process_noise(torch.float64, **kw),
    "manifolds.quat_identity": lambda **kw: manifolds.quat_identity(torch.float64, **kw),
    "delayed_states.make_buffer": lambda **kw: delayed_states.make_buffer(4, 3, 1.0, **kw).values,
    "indirect_pose_ukf.init": lambda **kw: ipu.init([0.1, 0.1, 0.1], [0.01, 0.01, 0.01], 100.0, **kw)[0].cov,
    "dynamics.default_uwv_parameters": lambda **kw: dynamics.default_uwv_parameters(**kw).inertia_matrix,
    "geodesy.make_projection": lambda **kw: geodesy.make_projection(0.8, 0.1, **kw).lat0,
    "convert.from_numpy": lambda **kw: convert.from_numpy(np.zeros(3), **kw),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_builds_on_the_card_by_default(name):
    ctor = CONSTRUCTORS[name]
    assert ctor(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert ctor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor()
