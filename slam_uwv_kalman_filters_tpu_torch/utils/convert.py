"""numpy ↔ torch conversion of filter trees.

:func:`from_numpy` turns a NamedTuple tree whose leaves are numpy arrays
(for instance a JAX package ``PoseUKFState``, ``PoseUKFParams``,
``PoseInputs``, ``FleetMissionSpec``, ``VelocityUKFState`` or
``VelocityUKFParams`` after ``jax.tree.map(np.asarray, …)``)
into the port's NamedTuple of the same name, field by field; :func:`to_numpy`
turns a port tree into numpy leaves. ``None`` leaves (absent sensor streams)
stay ``None``, and strings (a step update's model name) stay strings. This
is how the parity tests feed both packages identical
state, parameters and inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device

__all__ = ["from_numpy", "to_numpy"]


def _port_types() -> dict:
    from ..models import monte_carlo, pose_driver, pose_fused, pose_ukf, velocity_fused, velocity_ukf
    from ..ops import dynamics, geodesy, ukf

    types = (
        pose_ukf.PoseState, pose_ukf.PoseUKFParams, pose_ukf.PoseUKFState,
        dynamics.UWVParameters, dynamics.PoseVelocityState, geodesy.GeographicProjection, ukf.UpdateInfo,
        pose_fused.LanesBankState, pose_fused.BankedPredictOperands,
        pose_driver.PoseInputs, pose_driver.PoseStepConstants, monte_carlo.FleetMissionSpec,
        velocity_ukf.VelocityState, velocity_ukf.VelocityUKFParams, velocity_ukf.VelocityUKFState,
        velocity_fused.VelLanesState,
    )
    return {t.__name__: t for t in types}


def from_numpy(tree: Any, device=None, dtype=torch.float64) -> Any:
    """Numpy-leaved NamedTuple tree → the port's NamedTuple of tensors on
    ``device`` (``None``: the card, see ``utils/device.py``); floating leaves
    are cast to ``dtype``, others keep theirs."""
    device = resolve_device(device)
    if tree is None or isinstance(tree, str):
        return tree
    if hasattr(tree, "_fields"):
        cls = _port_types().get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        if cls._fields != tree._fields:
            raise TypeError(f"{cls.__name__}: field names differ from the source tree")
        return cls(*(from_numpy(leaf, device, dtype) for leaf in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(leaf, device, dtype) for leaf in tree)
    arr = np.asarray(tree)
    t = torch.as_tensor(arr.copy(), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def to_numpy(tree: Any) -> Any:
    """Port tree → the same NamedTuple types with numpy leaves."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(leaf) for leaf in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(leaf) for leaf in tree)
    return tree.detach().cpu().numpy()
