"""Geodesy and earth models — the counterpart of
``slam_uwv_kalman_filters_tpu/ops/geodesy.py`` (the ``pose_estimation``
geographic layer the reference pulls in): WGS-84 normal gravity, the earth
rotation vector in the NWU navigation frame and a local tangent-plane
projection. All functions broadcast over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device

__all__ = [
    "EARTHW",
    "WGS84_A",
    "WGS84_E2",
    "wgs84_gravity",
    "earth_rotation_nav",
    "GeographicProjection",
    "make_projection",
    "nav_to_world",
    "world_to_nav",
]

WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared
EARTHW = 7.292115e-5  # earth rotation rate [rad/s] (pose_estimation::EARTHW)

_GAMMA_E = 9.7803253359  # gravity at the equator [m/s²]
_SOMIG_K = 1.931852652458e-3
_FREE_AIR = 3.0877e-6  # free-air gradient [s⁻²]
_FREE_AIR_LAT = 4.4e-9  # latitude correction of the gradient [s⁻²]
_FREE_AIR_H2 = 7.2115e-13  # second-order altitude term [1/(m²·s²)]


def wgs84_gravity(latitude, altitude=0.0) -> torch.Tensor:
    """Normal gravity on the WGS-84 ellipsoid (Somigliana closed form with
    second-order free-air correction); a Python float latitude is read as
    float64."""
    if not isinstance(latitude, torch.Tensor):
        latitude = torch.tensor(float(latitude), dtype=torch.float64)
    s2 = torch.sin(latitude) ** 2
    g0 = _GAMMA_E * (1.0 + _SOMIG_K * s2) / torch.sqrt(1.0 - WGS84_E2 * s2)
    return g0 - (_FREE_AIR - _FREE_AIR_LAT * s2) * altitude + _FREE_AIR_H2 * altitude**2


def earth_rotation_nav(latitude: torch.Tensor) -> torch.Tensor:
    """Earth rotation vector in the NWU frame, Ω·[cos φ, 0, sin φ], (..., 3)."""
    c, s = torch.cos(latitude), torch.sin(latitude)
    return torch.stack([EARTHW * c, torch.zeros_like(c), EARTHW * s], dim=-1)


class GeographicProjection(NamedTuple):
    """Anchor of the local NWU tangent-plane projection: latitude/longitude
    [rad], meridional radius and normal radius × cos φ₀ at the anchor."""

    lat0: torch.Tensor
    lon0: torch.Tensor
    m_rad: torch.Tensor
    n_rad_cos: torch.Tensor


def make_projection(latitude: float, longitude: float, dtype=torch.float64, device=None):
    device = resolve_device(device)
    lat0 = torch.as_tensor(latitude, dtype=dtype, device=device)
    lon0 = torch.as_tensor(longitude, dtype=dtype, device=device)
    s2 = torch.sin(lat0) ** 2
    w = torch.sqrt(1.0 - WGS84_E2 * s2)
    m_rad = WGS84_A * (1.0 - WGS84_E2) / w**3
    n_rad = WGS84_A / w
    return GeographicProjection(lat0=lat0, lon0=lon0, m_rad=m_rad, n_rad_cos=n_rad * torch.cos(lat0))


def nav_to_world(proj: GeographicProjection, x, y):
    """NWU nav position (x north, y west) [m] → (latitude, longitude) [rad]."""
    return proj.lat0 + x / proj.m_rad, proj.lon0 - y / proj.n_rad_cos


def world_to_nav(proj: GeographicProjection, lat, lon):
    """(latitude, longitude) [rad] → NWU nav position (x north, y west) [m]."""
    return (lat - proj.lat0) * proj.m_rad, -(lon - proj.lon0) * proj.n_rad_cos
