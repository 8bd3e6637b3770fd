"""Manifold algebra for unscented Kalman filtering — the PyTorch counterpart of
``slam_uwv_kalman_filters_tpu/ops/manifolds.py`` (the MTK manifold layer of
the reference C++ library).

Conventions are the JAX package's, pinned by the same oracle tests:

* Quaternions are ``[w, x, y, z]`` in the last axis.
* SO(3): ``q ⊞ δ = q ⊗ Exp(δ·scale)`` and ``a ⊟ b = Log(b⁻¹ ⊗ a)``.
* Flat fields (``vec``): ``⊞`` is addition, ``⊟`` subtraction.
* 3×3 matrix fields (``mat33``): 9 DOF, *column-major* vectorization.
* S² (``s2``): a unit 3-vector with 2 DOF, ⊞/⊟ the sphere's exponential
  and log maps in a Householder tangent basis.
* Product manifolds concatenate per-field tangent vectors in declaration
  order (the ``MTK_BUILD_MANIFOLD`` covariance layout).

Where JAX wrote a per-instance function and ``vmap``-ed it, every function
here broadcasts over leading batch axes: a quaternion is ``(..., 4)``, an S²
point ``(..., 3)``, a tangent vector ``(..., dof)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
from torch._C import _functorch

from ..utils.device import resolve_device

__all__ = [
    "quat_identity",
    "quat_normalize",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_rotate_inv",
    "quat_exp",
    "quat_log",
    "quat_to_matrix",
    "quat_from_matrix",
    "quat_from_euler_zyx",
    "so3_boxplus",
    "so3_boxminus",
    "affine_mul",
    "affine_inv",
    "affine_apply",
    "s2_normalize",
    "s2_tangent_basis",
    "s2_boxplus",
    "s2_boxminus",
    "Field",
    "ProductManifold",
    "make_manifold",
    "S2Direct",
    "S2_MANIFOLD",
]

# ---------------------------------------------------------------------------
# Quaternion / SO(3) algebra. Layout: q = [w, x, y, z] in the last axis.
# ---------------------------------------------------------------------------


def quat_identity(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=resolve_device(device))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p (both [w,x,y,z], broadcasting)."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate == inverse for unit quaternions."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, v = torch.broadcast_tensors(u, v)
    return torch.linalg.cross(u, v, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)·v via the expanded Rodrigues form."""
    w, u = q[..., :1], q[..., 1:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)⁻¹·v == R(q⁻¹)·v."""
    return quat_rotate(quat_conj(q), v)


def _sinc_half(theta2: torch.Tensor) -> torch.Tensor:
    """sin(θ/2)/θ with a Taylor fallback for small θ (θ² given)."""
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    taylor = 0.5 - theta2 / 48.0
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    exact = torch.sin(0.5 * safe_theta) / safe_theta
    return torch.where(small, taylor, exact)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) → unit quaternion (..., 4), MTK half-angle
    convention, Taylor-expanded near |v| = 0."""
    theta2 = (v * v).sum(-1)
    w = torch.cos(0.5 * torch.sqrt(theta2))
    xyz = _sinc_half(theta2)[..., None] * v
    return torch.cat([w[..., None], xyz], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation vector, |result| ≤ π (hemisphere w ≥ 0)."""
    q = torch.where(q[..., :1] < 0.0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:4]
    n2 = (xyz * xyz).sum(-1)
    n = torch.sqrt(n2)
    theta = 2.0 * torch.atan2(n, w)
    small = n2 < 1e-24
    safe_n = torch.where(small, torch.ones_like(n), n)
    # θ/|xyz| → 2/w as |xyz| → 0
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / safe_n)
    return scale[..., None] * xyz


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (branch-free Shepperd:
    all four candidates, the best-conditioned one selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_from_euler_zyx(roll, pitch, yaw) -> torch.Tensor:
    """(roll, pitch, yaw) → quaternion, R = Rz(yaw)·Ry(pitch)·Rx(roll)."""
    hr, hp, hy = (0.5 * torch.as_tensor(a, dtype=torch.float64) for a in (roll, pitch, yaw))
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def so3_boxplus(q: torch.Tensor, delta: torch.Tensor, scale=1.0) -> torch.Tensor:
    """q ⊞ δ = q ⊗ Exp(δ·scale), re-normalized."""
    return quat_normalize(quat_mul(q, quat_exp(delta * scale)))


def so3_boxminus(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """a ⊟ b = Log(b⁻¹ ⊗ a); exact inverse of so3_boxplus."""
    return quat_log(quat_mul(quat_conj(qb), qa))


# ---------------------------------------------------------------------------
# Rigid transforms as (quaternion, translation) pairs.
# ---------------------------------------------------------------------------


def affine_mul(qa: torch.Tensor, pa: torch.Tensor, qb: torch.Tensor, pb: torch.Tensor):
    """(qa, pa) ∘ (qb, pb): compose rigid transforms a·b."""
    return quat_mul(qa, qb), pa + quat_rotate(qa, pb)


def affine_inv(q: torch.Tensor, p: torch.Tensor):
    """(q, p)⁻¹."""
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, p)


def affine_apply(q: torch.Tensor, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(q, p)·v = R(q)v + p."""
    return quat_rotate(q, v) + p


# ---------------------------------------------------------------------------
# S² unit-sphere manifold (2 DOF), stored as a unit 3-vector.
# ---------------------------------------------------------------------------


def s2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def s2_tangent_basis(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal tangent basis B(x) (..., 3, 2) at unit vectors x: the
    first two columns of the Householder reflection mapping e₃ → ±x, the
    sign taken from the hemisphere (x₂ ≥ 0) so that |v| stays away from 0;
    the identity where |v|² < 1e-24."""
    sign = torch.where(x[..., 2:3] >= 0.0, 1.0, -1.0).to(x.dtype)
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype, device=x.device)
    v = sign * x - e3
    v2 = (v * v).sum(-1)[..., None, None]
    degen = v2 < 1e-24
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    h = eye - 2.0 * (v[..., :, None] * v[..., None, :]) / torch.where(degen, torch.ones_like(v2), v2)
    return torch.where(degen, eye, h)[..., :2]


def s2_boxplus(x: torch.Tensor, delta: torch.Tensor, scale=1.0) -> torch.Tensor:
    """x ⊞ δ = cos|v|·x + sin|v|·v/|v|, v = B(x)·δ·scale, renormalized."""
    v = (s2_tangent_basis(x) @ (delta * scale)[..., None])[..., 0]
    theta2 = (v * v).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-24
    safe = torch.where(small, torch.ones_like(theta), theta)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    return s2_normalize(torch.cos(theta) * x + sinc * v)


def s2_boxminus(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y ⊟ x = B(x)ᵀ·Log_x(y) ∈ ℝ², θ = atan2(|x×y|, x·y). Where y has no
    tangential part at x: 0 if y = x, and B(x)[:, 0]·π at the antipode."""
    x, y = torch.broadcast_tensors(x, y)
    s = torch.linalg.vector_norm(torch.linalg.cross(x, y, dim=-1), dim=-1, keepdim=True)
    d = (x * y).sum(-1, keepdim=True)
    theta = torch.atan2(s, d)
    t = y - d * x
    tn = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    small = tn < 1e-12
    b = s2_tangent_basis(x)
    u = torch.where(small, torch.where(d > 0.0, torch.zeros_like(x), b[..., 0]),
                    t / torch.where(small, torch.ones_like(tn), tn))
    return (b.transpose(-1, -2) @ (theta * u)[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Product manifolds (the MTK_BUILD_MANIFOLD equivalent).
# ---------------------------------------------------------------------------

_KIND_VEC = "vec"
_KIND_SO3 = "so3"
_KIND_S2 = "s2"
_KIND_MAT33 = "mat33"

_VALID_KINDS = (_KIND_VEC, _KIND_SO3, _KIND_S2, _KIND_MAT33)


@dataclasses.dataclass(frozen=True)
class Field:
    """One component of a product manifold: ``vec`` (ℝᵈⁱᵐ, shape (dim,)),
    ``so3`` (quaternion (4,), 3 DOF), ``s2`` (unit vector (3,), 2 DOF) or
    ``mat33`` ((3, 3), 9 DOF column-major)."""

    name: str
    kind: str
    dim: int = 0

    def __post_init__(self):
        if self.kind not in _VALID_KINDS:
            raise ValueError(f"unknown manifold field kind: {self.kind!r}")
        dof = {"so3": 3, "s2": 2, "mat33": 9}.get(self.kind, self.dim)
        if self.kind == _KIND_VEC and self.dim <= 0:
            raise ValueError(f"vec field {self.name!r} needs dim > 0")
        object.__setattr__(self, "dim", dof)


def _field_boxplus(field: Field, value, delta, scale):
    if field.kind == _KIND_VEC:
        return value + scale * delta
    if field.kind == _KIND_SO3:
        return so3_boxplus(value, delta, scale)
    if field.kind == _KIND_S2:
        return s2_boxplus(value, delta, scale)
    # column-major vectorization: δ[3*c+r] lands on (r, c)
    return value + scale * delta.reshape(*delta.shape[:-1], 3, 3).transpose(-1, -2)


def _field_boxminus(field: Field, a, b):
    if field.kind == _KIND_VEC:
        return a - b
    if field.kind == _KIND_SO3:
        return so3_boxminus(a, b)
    if field.kind == _KIND_S2:
        return s2_boxminus(a, b)
    d = (a - b).transpose(-1, -2)
    return d.reshape(*d.shape[:-2], 9)


class ProductManifold:
    """Product manifold over the fields of a NamedTuple state. Tangent
    vectors are ``(..., dof)`` tensors with per-field slices in declaration
    order, so the reference's ``MTK::subblock`` offsets map to slices of the
    covariance."""

    def __init__(self, fields: Sequence[Field]):
        self.fields = tuple(fields)
        self.slices: list[tuple[int, int]] = []
        off = 0
        for f in self.fields:
            self.slices.append((off, f.dim))
            off += f.dim
        self.dof = off

    def boxplus(self, x: Any, delta: torch.Tensor, scale=1.0) -> Any:
        """x ⊞ (scale·δ), δ of shape (..., dof) broadcasting against x."""
        updates = {}
        for f, (start, dim) in zip(self.fields, self.slices):
            updates[f.name] = _field_boxplus(
                f, getattr(x, f.name), delta[..., start : start + dim], scale
            )
        return x._replace(**updates)

    def boxminus(self, a: Any, b: Any) -> torch.Tensor:
        """a ⊟ b → (..., dof) tangent vector at b."""
        parts = [_field_boxminus(f, getattr(a, f.name), getattr(b, f.name)) for f in self.fields]
        shape = torch.broadcast_shapes(*[p.shape[:-1] for p in parts])
        return torch.cat([p.expand(*shape, p.shape[-1]) for p in parts], dim=-1)

    def block(self, name: str) -> slice:
        """Covariance slice of a field — the ``MTK::subblock`` equivalent."""
        for f, (start, dim) in zip(self.fields, self.slices):
            if f.name == name:
                return slice(start, start + dim)
        raise KeyError(name)

    def mean(self, points: Any, *, max_iters: int = 64, tol: float = 1e-12) -> Any:
        """Equal-weight manifold mean over the leading (sigma) axis of every
        field: flat fields in closed form, SO(3) and S² by ukfom's iterative
        mean started from points[0]."""
        curved = {_KIND_SO3: (so3_boxplus, so3_boxminus), _KIND_S2: (s2_boxplus, s2_boxminus)}
        updates = {}
        for f in self.fields:
            vals = getattr(points, f.name)
            if f.kind in curved:
                updates[f.name] = _iterative_mean(vals, *curved[f.kind], max_iters=max_iters, tol=tol)
            else:
                updates[f.name] = vals.mean(dim=0)
        return points._replace(**updates)


def _run_every_iteration(vals: torch.Tensor) -> bool:
    """True where the iterative mean may not read its convergence flag on
    the host: under ``torch.export``, or on the card while the current
    stream captures a CUDA graph (asked only for a CUDA tensor: a build
    without CUDA raises on the question)."""
    if torch.compiler.is_exporting():
        return True
    return vals.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _unbatched(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for a tensor batched by ``torch.func.vmap`` the
    tensor it wraps beneath every vmap level (all instances at once, which
    a host read may then take)."""
    while _functorch.is_batchedtensor(t):
        t = _functorch.get_unwrapped(t)
    return t


def _iterative_mean(vals: torch.Tensor, boxplus, boxminus, *, max_iters: int, tol: float) -> torch.Tensor:
    """Iterative Karcher mean of manifold points ``vals`` (K, ..., d) over
    the leading axis through ``boxplus`` / ``boxminus``, started from
    vals[0] (ukfom convention).

    Every instance of the batch runs its own tolerance loop, as the JAX
    ``lax.while_loop`` does under ``vmap``: an instance whose last correction
    fell to ``tol`` or below is frozen (masked). Once every instance is
    frozen the remaining iterations are identities, and the loop ends: on
    the CPU the host reads that flag; on the card each iteration copies it,
    non-blocking, to pinned host memory behind an event that the host polls
    and never waits on, so the loop ends a few iterations after the card has
    converged and the host never waits for the device.

    Under ``torch.func.vmap`` the flag is taken over the stored tensor
    beneath every vmap level (:func:`_unbatched`), so the loop ends once
    every instance of the whole vmapped bank has converged, as JAX's
    ``while_loop`` does under ``vmap``, and a vmapped call runs as many
    iterations as the bank form on the same stack.

    Where no host read is possible (under ``torch.export``, or while a CUDA
    graph is being captured, :func:`_run_every_iteration`) it runs all
    ``max_iters`` with no flag: a frozen instance's iterations are
    identities, so the result has the same bits."""
    m = vals[0]
    norm = torch.full(m.shape[:-1], float("inf"), dtype=vals.dtype, device=vals.device)
    run_all = _run_every_iteration(vals)
    on_card = vals.device.type == "cuda"
    # True until its copy lands, so a flag read early can never end the loop
    flags = torch.ones(max_iters, dtype=torch.bool, pin_memory=True) if on_card and not run_all else None
    reported = []  # (iteration, event) of the flags on their way to the host, oldest first
    for it in range(max_iters):
        active = norm > tol
        delta = boxminus(vals, m[None]).mean(dim=0)
        m = torch.where(active[..., None], boxplus(m, delta), m)
        norm = torch.where(active, torch.linalg.vector_norm(delta, dim=-1), norm)
        if run_all:
            continue
        any_active = (_unbatched(norm) > tol).any()
        if not on_card:
            if not bool(any_active):
                break
            continue
        flags[it].copy_(any_active, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(vals.device))  # the copy's stream
        reported.append((it, event))
        while reported and reported[0][1].query():
            if not bool(flags[reported.pop(0)[0]]):
                return m
    return m


def make_manifold(*fields: Field) -> ProductManifold:
    return ProductManifold(fields)


class S2Direct:
    """Measurement manifold of bare S² unit vectors (the seafloor normal of
    ``src/BottomUKF.cpp:63-67``): the part of the ProductManifold interface
    that ``ops.ukf.update`` needs."""

    dof = 2

    @staticmethod
    def boxminus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return s2_boxminus(a, b)

    @staticmethod
    def boxplus(x: torch.Tensor, delta: torch.Tensor, scale=1.0) -> torch.Tensor:
        return s2_boxplus(x, delta, scale)

    @staticmethod
    def mean(points: torch.Tensor, *, max_iters: int = 64, tol: float = 1e-12) -> torch.Tensor:
        return _iterative_mean(points, s2_boxplus, s2_boxminus, max_iters=max_iters, tol=tol)


S2_MANIFOLD = S2Direct()
