#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Builds the hand-written CUDA kernels from ``slam_uwv_kalman_filters_tpu_torch/
csrc`` and then, in order:

1. checks each kernel against its plain PyTorch version on the card, in
   float32 and float64, at bank 300 (more than two 128-thread blocks, with a
   ragged edge): K1 sigma deltas at n = 53, K2 the fused predict on perturbed
   mission states, K3 the in-kernel update for all seven models in both aux
   forms (valid covariance half only); then holds the float32 kernels' means
   (K2's predicted mean, K3's innovation) to the float32 plain version's
   accuracy against float64;
2. checks the two kernels of the banked (Monte-Carlo) path the same way: K2
   in full mode on perturbed mission states with a banked parameter draw, and
   K4, the generic-h update tail, for m = 1, 2, 3, 6 with a gate that rejects
   some instances and an S that is NaN for one, NaN in the invalid half of
   the covariance in both;
3. runs the first main path, the PoseUKF mission second (bench.py's 100-tick
   schedule: predict and acceleration every tick, DVL 5 Hz, pressure 2 Hz,
   ADCP 1 Hz, body efforts 10 Hz) on the lanes path at the fleet bank in
   float32 with one shared parameter set: one warm second that records the
   operands of every launch, then one timed second between a zeroing and a
   reading of the launch counters (100 K2, 118 K3);
4. runs the generic bank API on the mission state at the same bank (a
   custom sensor's update through ``pose_ukf.update_bank``: K1 sigma deltas,
   h in PyTorch, the K4 tail), with the counters zeroed before it and read
   after;
5. checks each kernel against its plain version on the operands the main
   path (K1 and K4: the generic update) gave it, at the same limits, and
   times the two in turns plain, kernel, kernel, plain;
6. traces 20 mission ticks with ``torch.profiler`` for the device's idle share;
7. runs the second main path, the same mission second with a banked
   Monte-Carlo parameter set (process noise, water-velocity scale,
   atmospheric pressure and vehicle inertia per instance) through
   ``pose_driver.pose_step_bank_lanes``, warm then timed as above (100
   K2-full, 108 K3, 10 K1, 10 K4), then checks and times K2-full and K4 on
   the operands it gave them;
8. replays the fleet Monte-Carlo mission (``monte_carlo.run_fleet_mission``,
   lanes path, 1-minute survey at 50 Hz, bank 1024, float32) and holds its
   ATE distribution to the bounds of the JAX package's fleet test;
9. runs a 1000-tick trajectory at bank 256 from perturbed mission starts:
   the float32 kernels against the float64 plain path on the card;
10. (after the checks of 1) checks the two whole-step kernels against their
   plain versions at bank 300, float32 and float64: K5 (PoseUKF predict + a
   chain of in-kernel updates) on the six-model chain with a rejected gate
   and NaN in the invalid covariance half, and against the K2 → K3 chain on
   the same operands; K6 (the VelocityUKF step) predict-only, update-only
   and predict + [DVL, pressure] with a rejected gate;
11. runs the stepped mission second (bench.py's ``steps=True`` schedule: one
   K5 launch per tick with acceleration and that tick's DVL, pressure and
   ADCP, K3 for body efforts at 10 Hz) at the fleet bank, warm then timed
   (100 K5, 10 K3), holds its final state to the chain's of 3, and checks
   and times K5 on the operands it gave it;
12. measures the online latency of bench.py's estimator pattern: one K5
   [acceleration, velocity] step per tick with a host-fresh DVL z copied to
   the card and a one-element readback, 400 ticks at bank 1 and 128;
13. runs the online estimator of examples/online_estimator.py --fused-step
   on the port (bank 128, 100 Hz, 10 s; events through the port's
   StreamPacker, forward-filled gyro) and holds its velocity error to the
   example's 0.02 m/s;
14. runs the VelocityUKF bank (bench.py's small-filter step: predict + DVL
   in one K6 launch) at bank 65 536, float32, 30 timed steps, and checks and
   times K6 on its operands.

Lines before the last carry the card (``nvidia-smi`` name and power limit),
the build time, every check with its limit, both mission rates, the idle
share, the fleet ATE, the trajectory differences and a JSON object with the
kernel table. The last line is ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; so does a machine without CUDA.

    python3 chip_smoke.py                       # the full run
    python3 chip_smoke.py --bank 2048 --ticks 100 --fleet-bank 64 --fleet-minutes 0.1 \
        --velocity-bank 4096 --online-seconds 2                           # a short one
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

DT = 0.01
TPU_KERNELS = {
    "sigma_deltas": "slam_uwv_kalman_filters_tpu/ops/kernels.py:217",
    "pose_predict": "slam_uwv_kalman_filters_tpu/models/pose_fused.py:206",
    "pose_predict_full": "slam_uwv_kalman_filters_tpu/models/pose_fused.py:206",
    "pose_update_model": "slam_uwv_kalman_filters_tpu/models/pose_update_fused.py:469",
    "pose_update_tail": "slam_uwv_kalman_filters_tpu/models/pose_update_fused.py:74",
    "pose_step": "slam_uwv_kalman_filters_tpu/models/pose_update_fused.py:626",
    "velocity_step": "slam_uwv_kalman_filters_tpu/models/velocity_fused.py:306",
}
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM3
# bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# launch counts of the two main paths' timed mission seconds
_NONE = {"sigma_deltas": 0, "pose_predict": 0, "pose_predict_full": 0, "pose_update_model": 0,
         "pose_update_tail": 0, "pose_step": 0, "velocity_step": 0}
SHARED_SECOND = {**_NONE, "pose_predict": 100, "pose_update_model": 118}
BANKED_SECOND = {**_NONE, "sigma_deltas": 10, "pose_predict_full": 100, "pose_update_model": 108,
                 "pose_update_tail": 10}
STEPPED_SECOND = {**_NONE, "pose_step": 100, "pose_update_model": 10}
# normalized-error limits of a kernel against its plain version on the card:
# float64 is held near rounding; float32 sums 107 sigma points and runs a
# 53-column factorization in another order than PyTorch's library calls
LIMITS = {torch.float64: 1e-9, torch.float32: 2e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


def mission_setup(nb: int, dtype, device, gen: torch.Generator | None = None, spread: float = 0.0):
    """The bench's mission filter bank, optionally perturbed (means moved, a
    random correlated covariance at the initial per-field scales)."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu_torch.ops import geodesy as geo
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config

    cfg = default_pose_ukf_config()
    f64 = torch.float64
    state, params = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4,
        cfg, dyn.default_uwv_parameters(device=device), imu_delta_t=DT, device=device,
    )
    bs = bank.replicate(state, nb)
    bs = bs._replace(rotation_rate=torch.tensor([0.0, 0.0, 0.01], dtype=f64, device=device).expand(nb, 3).contiguous())
    if spread:
        n = 53
        rn = lambda *s: torch.randn(*s, generator=gen, dtype=f64, device=device)
        mu = bs.mu
        dq = rn(nb, 3) * 0.3 * spread
        from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf

        bs = bs._replace(mu=mu._replace(
            position=mu.position + rn(nb, 3),
            orientation=mf.so3_boxplus(mu.orientation, dq),
            velocity=rn(nb, 3) * 0.5,
            acceleration=rn(nb, 3) * 0.1,
            water_velocity=rn(nb, 2) * 0.1,
            water_velocity_below=rn(nb, 2) * 0.1,
            water_density=mu.water_density + rn(nb, 1),
        ))
        g = rn(nb, n, n)
        c = g @ g.transpose(1, 2) / n + torch.eye(n, dtype=f64, device=device)
        s = torch.sqrt(torch.diagonal(c, dim1=1, dim2=2))
        sd = torch.sqrt(torch.diagonal(state.cov)) * spread
        bs = bs._replace(cov=c / (s[:, :, None] * s[:, None, :]) * sd[None, :, None] * sd[None, None, :])
    g0 = float(geo.wgs84_gravity(cfg.location.latitude, cfg.location.altitude))
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    meas = {
        "acc": (t([0.0, 0.0, g0]).expand(nb, 3), torch.eye(3, dtype=dtype, device=device) * 4e-5),
        "dvl": (t([0.3, 0.0, 0.0]).expand(nb, 3), torch.eye(3, dtype=dtype, device=device) * 1e-3),
        "press": (t([cfg.hydrostatics.atmospheric_pressure]).expand(nb, 1), torch.eye(1, dtype=dtype, device=device) * 2500.0),
        "adcp": (t([0.0, 0.0]).expand(nb, 2), torch.eye(2, dtype=dtype, device=device) * 1e-3),
        "eff": (t([0.0] * 6).expand(nb, 6), torch.eye(6, dtype=dtype, device=device)),
    }
    to = lambda tree: bank.tree_map(lambda a: a.to(dtype), tree)
    return to(bs), to(params), meas


def mission_tick(ls, params, meas, k: int):
    """One tick of bench.py's mission schedule on lanes state."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import ukf

    ls = pf.predict_lanes(ls, params, DT)
    ls, _ = puf.update_model_lanes("acceleration", ls, *meas["acc"])
    if k % 20 == 19:  # DVL 5 Hz
        ls, _ = puf.update_velocity_lanes(ls, params, *meas["dvl"])
    if k % 50 == 49:  # pressure 2 Hz
        ls, _ = puf.update_model_lanes(
            "pressure", ls, *meas["press"], aux=(params.atmospheric_pressure, 0.0, 0.0, 0.0))
    if k % 100 == 99:  # ADCP 1 Hz, χ²-95 gated
        ls, _ = puf.update_model_lanes("water_velocity", ls, *meas["adcp"], ukf.D2P95, aux=(0.5,))
    if k % 10 == 9:  # model-aided body efforts 10 Hz
        ls, _ = puf.update_body_efforts_lanes(ls, params, *meas["eff"])
    return ls


@contextlib.contextmanager
def patched(*swaps):
    """Set ``module.name = value`` for each (module, name, value) while the
    block runs."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, value in swaps:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def plain_route():
    """Route the lanes entry points to the plain versions, on any device."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf

    return patched((pf, "_pose_predict_lanes", pf.predict_lanes_plain),
                   (puf, "_pose_update_model_lanes", puf.update_model_lanes_plain))


def capture_operands(store: dict, counts: dict, keep=lambda key: True):
    """Record the operands of each kernel's last launch (K3's per model, K4's
    per m) in ``store`` where ``keep(key)``, and count launches per key in
    ``counts`` while the block runs; every launch still goes to the kernel."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels

    def recording(fn, key):
        def wrapped(*args):
            k = key(args)
            if keep(k):
                store[k] = args
            counts[k] = counts.get(k, 0) + 1
            return fn(*args)
        return wrapped

    predict_key = lambda a: "pose_predict_full" if len(a) > 7 and a[7] is not None else "pose_predict"
    return patched(
        (pf, "_pose_predict_lanes", recording(pf._pose_predict_lanes, predict_key)),
        (puf, "_pose_update_model_lanes",
         recording(puf._pose_update_model_lanes, lambda a: f"pose_update_model[{a[0]}]")),
        (puf, "_pose_update_lanes",
         recording(puf._pose_update_lanes, lambda a: f"pose_update_tail[{a[1].shape[1]}]")),
        (kernels, "sigma_deltas_lanes_cuda",
         recording(kernels.sigma_deltas_lanes_cuda, lambda a: "sigma_deltas")),
        (puf, "_pose_step_lanes", recording(puf._pose_step_lanes, lambda a: f"pose_step[{'+'.join(a[0])}]")),
        (vf, "_velocity_step_lanes",
         recording(vf._velocity_step_lanes, lambda a: f"velocity_step[{'+'.join(a[0]) or 'predict'}]")),
    )


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------


def _valid(x):
    n = x.shape[0]
    return x[torch.triu(torch.ones(n, n, dtype=torch.bool, device=x.device))]


def _cov_err(out_t, ref_t, scale_t):
    """Max |Δ| of the valid half, and the same over √(P_cc·P_rr) of
    ``scale_t`` — the entries span 1e-11 … 10, so the normalized error is what
    is limited. An update is normalized by its prior: an informative
    measurement cancels most of a variance, and float32 rounding of the prior
    then dominates the small posterior."""
    diag = torch.diagonal(scale_t, dim1=0, dim2=1).T.abs()  # (n, B)
    norm = torch.sqrt(diag[:, None, :] * diag[None, :, :]) + torch.finfo(ref_t.dtype).tiny
    d = (out_t - ref_t).abs()
    return _valid(d).max().item(), _valid(d / norm).max().item()


def _rel(out, ref):
    """Max |Δ|/(1 + |ref|); a NaN in one and not in the other is infinite,
    a NaN in both (an instance whose S is NaN) is agreement."""
    both = torch.isnan(out) & torch.isnan(ref)
    if bool((torch.isnan(out) ^ torch.isnan(ref)).any()):
        return float("inf")
    return torch.where(both, 0.0, (out - ref).abs() / (1.0 + ref.abs())).max().item()


def _pair(name):
    """(kernel wrapper, plain version) of kernel ``name``."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels

    return {
        "sigma_deltas": (kernels.sigma_deltas_lanes_cuda, kernels.sigma_deltas_lanes_plain),
        "pose_step": (puf.pose_step_lanes_cuda, puf.pose_step_lanes_plain),
        "velocity_step": (vf.velocity_step_lanes_cuda, vf.velocity_step_lanes_plain),
        "pose_predict": (pf.predict_lanes_cuda, pf.predict_lanes_plain),
        "pose_predict_full": (pf.predict_lanes_cuda, pf.predict_lanes_plain),
        "pose_update_model": (puf.update_model_lanes_cuda, puf.update_model_lanes_plain),
        "pose_update_tail": (puf.update_tail_cuda, puf.update_tail_plain),
    }[name]


def compare(name: str, label: str, args: tuple, stats: dict | None = None) -> None:
    """Run kernel ``name`` and its plain version on ``args``, log the errors
    beside the limit and raise past it; keep the float32 max abs error per
    kernel in ``stats``."""
    kern, plain = _pair(name)
    ko, po = kern(*args), plain(*args)
    torch.cuda.synchronize()
    if name == "sigma_deltas":
        dtype = ko.dtype
        scale = po.abs().amax(dim=(0, 1), keepdim=True)
        errs = {"abs": (ko - po).abs().max().item(), "rel": ((ko - po).abs() / scale).max().item()}
    elif name in ("pose_predict", "pose_predict_full"):
        dtype = ko[0].dtype
        a, n_err = _cov_err(ko[0], po[0], po[0])
        errs = {"abs": a, "cov": n_err, "mu": _rel(ko[1], po[1])}
    elif name in ("pose_step", "velocity_step"):
        dtype = ko[0].dtype
        if name == "pose_step":  # the updates' prior, the predicted covariance, normalizes
            from slam_uwv_kalman_filters_tpu_torch.models.pose_fused import predict_lanes_plain

            a, n_err = _cov_err(ko[0], po[0], predict_lanes_plain(*args[1:8])[0])
            errs = {"abs": a, "cov": n_err, "mu": _rel(ko[1], po[1])}
        else:
            errs = {"abs": (ko[0] - po[0]).abs().max().item(), "cov": _rel(ko[0], po[0]), "mu": _rel(ko[1], po[1]),
                    "trk": _rel(ko[2], po[2])}
        k_infos, p_infos = ko[-1], po[-1]
        thrs = [float(s6[0]) for s6 in args[10]] if name == "pose_step" else list(args[10])
        flips = 0
        for (km2, kacc, knu), (pm2, pacc, pnu), thr in zip(k_infos, p_infos, thrs):
            near = (pm2 - thr).abs() <= 1e-3 * abs(thr)
            flips += int(((kacc != pacc) & ~near).sum().item())
            errs["m2"] = max(errs.get("m2", 0.0), _rel(km2, pm2))
            errs["nu"] = max(errs.get("nu", 0.0), _rel(knu, pnu))
        errs["gate_flips"] = float(flips)
    elif name == "pose_update_tail":
        dtype = ko[0].dtype
        a, n_err = _cov_err(ko[0], po[0], args[5])  # normalized by the prior
        thr = float(args[6])
        near = (po[2] - thr).abs() <= 1e-3 * abs(thr)
        flips = int(((ko[3] != po[3]) & ~near).sum().item())
        errs = {"abs": a, "cov": n_err, "mu": _rel(ko[1], po[1]), "m2": _rel(ko[2], po[2]),
                "gate_flips": float(flips)}
    else:
        dtype = ko[0].dtype
        a, n_err = _cov_err(ko[0], po[0], args[4])  # normalized by the prior
        # gate outcomes must agree wherever m2 is not within 1e-3 of the threshold
        thr = float(args[5][0, 0])
        near = (po[2] - thr).abs() <= 1e-3 * abs(thr)
        flips = int(((ko[3] != po[3]) & ~near).sum().item())
        errs = {"abs": a, "cov": n_err, "mu": _rel(ko[1], po[1]), "m2": _rel(ko[2], po[2]),
                "nu": _rel(ko[4], po[4]), "gate_flips": float(flips)}
    limit = LIMITS[dtype]
    ok = max(v for k, v in errs.items() if k != "abs") <= limit
    log(f"check {label} {str(dtype).split('.')[-1]}: "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" limit={limit:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} ({dtype}) disagrees with its plain version: {errs}")
    if stats is not None and dtype == torch.float32:
        stats[name] = max(stats.get(name, 0.0), errs["abs"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_checks(device):
    """Each kernel against its plain version at bank 300, float32 and
    float64, on perturbed mission states."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import ukf

    nb = 300
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(7)
        bs, params, _ = mission_setup(nb, dtype, device, gen, spread=1.0)
        ls = pf.to_lanes(bs)
        compare("sigma_deltas", "sigma_deltas", (ls.cov_t,))  # K1 at n = 53
        ops = pf._predict_operands_shared(params, DT, dtype)
        compare("pose_predict", "pose_predict", (ls.cov_t, ls.mu_t, ls.rr_t, *ops))
        # K3: seven models × two aux forms, on the predicted states
        cov_p, mu_p = pf.predict_lanes_plain(ls.cov_t, ls.mu_t, ls.rr_t, *ops)
        mscal = puf._efforts_model_scal(params, dtype)
        for model, m in puf.FUSED_MODELS.items():
            z = torch.randn(m, nb, generator=gen, dtype=torch.float64, device=device).to(dtype)
            if model == "pressure":
                z = z * 50.0 + 101325.0
            var = {"velocity": 1e-3, "z_position": 0.01, "xy_position": 0.5, "acceleration": 4e-5,
                   "pressure": 2500.0, "water_velocity": 1e-3, "body_efforts": 1.0}[model]  # mission R
            r = (torch.eye(m, dtype=dtype, device=device) * var)[..., None].expand(m, m, nb).contiguous()
            thr = ukf.D2P95 if model in ("xy_position", "water_velocity") else None
            shared = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,),
                      "body_efforts": (0.01, 0.02, -0.01)}.get(model, ())
            aux_b = torch.randn(5, nb, generator=gen, dtype=torch.float64, device=device).to(dtype) * 0.01
            aux_b[0] += {"pressure": 101325.0, "water_velocity": 0.5}.get(model, 0.0)
            for form, aux_t in (("shared", None), ("banked", aux_b.contiguous())):
                scal = puf._scal_block(thr, shared, dtype, device)
                args = (model, z, r, mu_p, cov_p, scal, aux_t, mscal if model == "body_efforts" else None)
                compare("pose_update_model", f"pose_update_model[{model},{form}]", args)


def banked_params(params, nb: int, dtype, every_operand: bool = False):
    """A banked Monte-Carlo parameter set: the fleet harness's draw
    (``fleet_setup.monte_carlo_params``: ±20% process-noise and water-
    velocity scale, ±100 Pa p_atm) plus a per-instance vehicle inertia scale,
    as the JAX package's banked lanes test draws it. ``every_operand`` also
    moves each instance's Markov time constants and rest points and its
    projection anchor, so that every per-lane operand of K2's full mode
    differs between lanes."""
    import numpy as np

    from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup

    bp = fleet_setup.monte_carlo_params(params, nb, dtype)
    rng = np.random.default_rng(6)
    dev = params.process_noise.device
    draw = lambda sigma, *shape: torch.as_tensor(
        1.0 + sigma * rng.standard_normal((nb, *shape)).clip(-0.9, 0.9), device=dev).to(dtype)
    bp = bp._replace(model=bp.model._replace(inertia_matrix=bp.model.inertia_matrix * draw(0.2)[:, None, None]))
    if every_operand:
        bp = bp._replace(
            gyro_bias_tau=bp.gyro_bias_tau * draw(0.3), inertia_tau=bp.inertia_tau * draw(0.3),
            water_velocity_tau=bp.water_velocity_tau * draw(0.3),
            water_density_tau=bp.water_density_tau * draw(0.3),
            acc_bias_offset=bp.acc_bias_offset + 1e-3 * (draw(1.0, 3) - 1.0),
            inertia_offset=bp.inertia_offset * draw(0.1, 3, 3),
            water_density_offset=bp.water_density_offset * draw(0.01),
            projection=bp.projection._replace(
                lat0=bp.projection.lat0 + 0.05 * (draw(1.0) - 1.0),
                m_rad=bp.projection.m_rad * draw(1e-3)),
        )
    return bp


def phase_checks_banked(device):
    """The kernels of the banked path against their plain versions at bank
    300, float32 and float64: K2 in full mode on perturbed mission states
    with a banked parameter draw; K4 for m = 1, 2, 3, 6 on the predicted
    states, a gate that rejects some instances and an S that is NaN for one.
    NaN fills the invalid half of the covariance in both."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels

    nb = 300
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(8)
        bs, params, _ = mission_setup(nb, dtype, device, gen, spread=1.0)
        ls = pf.to_lanes(bs)
        n = pf.TANGENT_DIM
        upper = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)[..., None]
        cov_t = torch.where(upper, float("nan"), ls.cov_t).contiguous()
        bo = pf.banked_predict_operands(banked_params(params, nb, dtype, every_operand=True), DT, dtype)
        full_ops = (bo.coeff, bo.offs, bo.q0m_t, bo.scal, bo.aux_t)
        compare("pose_predict_full", "pose_predict_full", (cov_t, ls.mu_t, ls.rr_t, *full_ops))
        cov_p, mu_p = pf.predict_lanes_plain(cov_t, ls.mu_t, ls.rr_t, *full_ops)
        cov_p = torch.where(upper, float("nan"), cov_p).contiguous()
        deltas = kernels.sigma_deltas_lanes_plain(cov_p)
        for m in (1, 2, 3, 6):
            rn = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64, device=device).to(dtype)
            dz = 0.1 * rn(pf.NSIG, m, nb)
            dz = (dz - dz.mean(0)).contiguous()
            nu = 0.3 * rn(m, nb)
            nu[:, ::7] += 10.0  # every 7th instance fails the gate
            for thr in (-1.0, 5.991 * m):
                r = (torch.eye(m, dtype=dtype, device=device) * 0.05)[..., None].repeat(1, 1, nb)
                if thr >= 0:
                    r[0, 0, 5] = float("nan")  # instance 5: S is NaN, the gate keeps its prior
                compare("pose_update_tail", f"pose_update_tail[m={m},thr={thr:g}]",
                        (deltas, dz, nu.contiguous(), r, mu_p, cov_p, thr))


def phase_mean_accuracy(device):
    """The float32 kernels' means against float64, no worse than the float32
    plain version's (×2, plus 2 ulp of the value): K2's predicted mean and
    K3's innovation for acceleration (z ≈ g) and pressure (z ≈ 1e5 Pa), at
    bank 300 on perturbed mission states. Running sums of 107 gravities or
    pressures fail this; a mean about the zero sigma point passes. The
    trajectory guard alone tells the two apart by position only."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

    nb, f32, f64 = 300, torch.float32, torch.float64
    gen = torch.Generator(device=device).manual_seed(7)
    bs64, params64, _ = mission_setup(nb, f64, device, gen, spread=1.0)
    l64 = pf.to_lanes(bs64)
    l32, params32 = tree_map(lambda a: a.float(), l64), tree_map(lambda a: a.float(), params64)
    ulp = torch.finfo(f32).eps

    def worst(k32, p32, p64):
        """max over rows of err(kernel) / (2·err(plain) + 2 ulp·|value|)."""
        err_k = (k32.double() - p64).abs().amax(-1)
        bound = 2 * (p32.double() - p64).abs().amax(-1) + 2 * ulp * p64.abs().amax(-1)
        return (err_k / bound.clamp(min=torch.finfo(f64).tiny)).max().item()

    ratios = {}
    ops64, ops32 = pf._predict_operands_shared(params64, DT, f64), pf._predict_operands_shared(params32, DT, f32)
    mu64 = pf.predict_lanes_plain(l64.cov_t, l64.mu_t, l64.rr_t, *ops64)[1]
    mu_p = pf.predict_lanes_plain(l32.cov_t, l32.mu_t, l32.rr_t, *ops32)[1]
    mu_k = pf.predict_lanes_cuda(l32.cov_t, l32.mu_t, l32.rr_t, *ops32)[1]
    ratios["pose_predict mean"] = worst(mu_k, mu_p, mu64)
    for model, z0, var, aux in (("acceleration", 9.8, 4e-5, ()),
                                ("pressure", 101325.0, 2500.0, (101325.0, 0.0, 0.0, 0.0))):
        m = puf.FUSED_MODELS[model]
        z = torch.full((m, nb), z0, dtype=f64, device=device)
        r = (torch.eye(m, dtype=f64, device=device) * var)[..., None].expand(m, m, nb).contiguous()
        nu = [fn(model, z.to(dt), r.to(dt), ls.mu_t, ls.cov_t, puf._scal_block(None, aux, dt, device))[4]
              for fn, ls, dt in ((puf.update_model_lanes_plain, l64, f64),
                                 (puf.update_model_lanes_plain, l32, f32),
                                 (puf.update_model_lanes_cuda, l32, f32))]
        ratios[f"pose_update_model[{model}] innovation"] = worst(nu[2], nu[1], nu[0])
    torch.cuda.synchronize()
    log("float32 means (kernel error / bound from the plain version, limit 1): "
        + " ".join(f"{k}={v:.3f}" for k, v in ratios.items()))
    if max(ratios.values()) > 1.0:
        raise AssertionError(f"a float32 kernel mean is less accurate than its plain version: {ratios}")


def phase_mission(device, nb, captured: dict, counts: dict):
    """The first main path: one warm mission second at bank ``nb`` (f32,
    lanes, shared parameters) that records each kernel's operands, then one
    timed mission second with the launch counters zeroed just before it and
    read just after."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

    dtype = torch.float32
    bs, params, meas = mission_setup(nb, dtype, device)
    ls = pf.to_lanes(bs)
    like = tree_map(lambda a: a[0].clone(), bs)  # the tree shape for from_lanes
    del bs
    with capture_operands(captured, counts):  # warm mission second
        for k in range(100):
            ls = mission_tick(ls, params, meas, k)
    mission_counts = dict(counts)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(100):
        ls = mission_tick(ls, params, meas, k)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    rate = nb * 100 / seconds
    log(f"mission second (shared parameters): bank={nb} float32 ticks/s={rate:.6e} "
        f"seconds={seconds:.6f} launches={launches}")
    if launches != SHARED_SECOND:
        raise AssertionError(f"mission second launched {launches}, expected {SHARED_SECOND}")
    out = pf.from_lanes(ls, like)
    for name, t in (("cov", out.cov), ("mu", pf._pack_storage(out.mu))):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"mission second produced non-finite {name}")
    if not bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all()):
        raise AssertionError("mission second produced a non-positive variance")
    return ls, like, params, meas, launches, rate, mission_counts


def phase_generic(ls, like, params, meas, captured: dict, counts: dict):
    """The generic bank API on the card at the mission bank: a custom
    sensor's update through ``pose_ukf.update_bank`` with a user-supplied h
    (here the IMU specific force) on the mission state: K1's sigma deltas, h
    in PyTorch, the K4 tail. The counters are zeroed just before it and read
    just after."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    bs = pf.from_lanes(ls, like)
    nb = bs.cov.shape[0]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with capture_operands(captured, counts):
        out, info = pukf.update_bank(bs, params, *meas["acc"], pukf._h_acceleration, pukf._ACCELERATION_DEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    log(f"generic bank update: bank={nb} float32 seconds={seconds:.6f} launches={launches}")
    expected = {**_NONE, "sigma_deltas": 1, "pose_update_tail": 1}
    if launches != expected:
        raise AssertionError(f"generic bank update launched {launches}, expected {expected}")
    for name, t in (("cov", out.cov), ("mu", pf._pack_storage(out.mu)), ("m2", info.mahalanobis2)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"generic bank update produced non-finite {name}")
    if not bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all()):
        raise AssertionError("generic bank update produced a non-positive variance")
    return launches


def _time(fn, reps: int) -> float:
    """Milliseconds per call from CUDA events, after one warm call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# operations of each in-kernel measurement model per sigma point (estimate)
_H_OPS = {"velocity": 60, "z_position": 1, "xy_position": 2, "acceleration": 70, "pressure": 70,
          "water_velocity": 120, "body_efforts": 900}


def _bound(name: str, args: tuple):
    """(bound_ms, bound_by) of one launch on these operands: the larger of
    the bytes the function must move (each input read once — a half-valid
    (53, 53) matrix counts its valid half — each output written once) over
    the HBM rate and its float32 operations over the card's float32 rate.
    Operations are counted from the shapes: a multiply or an add is one, a
    square root or a trigonometric function is one. The sigma-point work
    between the factorization and the sums (boxplus, process model, Karcher
    mean, deviations; the in-kernel h of K3) is an estimate per point, named
    below."""
    n, K = 53, 107
    half = n * (n + 1) // 2
    chol = n**3 / 3 + 2 * n * n  # factorization plus equilibration
    if name == "sigma_deltas":
        nb = args[0].shape[-1]
        elems, ops = half + K * n, chol + K * n
    elif name in ("pose_predict", "pose_predict_full"):
        nb = args[0].shape[-1]
        per_lane = name == "pose_predict_full"
        # cov, mu, rr in; per-lane coeff, offs, q0m half and aux (full mode); cov, mu out
        elems = half + 54 + 3 + (2 * 54 + half + 12 if per_lane else 0) + half + 54
        ops = chol + K * 400 + 2 * K * half  # ~400 ops per point (estimate), ½ΣDDᵀ
    elif name == "pose_update_model":
        model, m, nb = args[0], args[1].shape[0], args[1].shape[-1]
        h_ops = _H_OPS[model]
        elems = half + 54 + m + m * m + (5 if args[6] is not None else 0) + half + 54 + 2 + m
        ops = chol + K * (h_ops + 60) + K * m * (m + 1) + m * n * (n + 1) + m * m * n + m * n * (n + 1)
    elif name == "pose_update_tail":
        nb, m = args[0].shape[-1], args[1].shape[1]
        elems = K * n + K * m + m + m * m + 54 + half + half + 54 + 2
        ops = K * m * (m + 1) + 2 * K * n * m + m * m * n + m * n * (n + 1) + 2 * m * n
    elif name == "pose_step":
        # K2's shared-mode predict, then K3's in-kernel update per model of the
        # chain; cov, mu, rr and per update z, R in; cov, mu and per update
        # m2, acc, nu out (no intermediate covariance: it is the function's own)
        nb = args[1].shape[-1]
        ms = [(model, z.shape[0]) for model, z in zip(args[0], args[8])]
        elems = half + 54 + 3 + half + 54 + sum(m + m * m + 2 + m for _, m in ms)
        ops = chol + K * 400 + 2 * K * half
        ops += sum(chol + K * (_H_OPS[model] + 60) + K * m * (m + 1) + m * n * (n + 1) + m * m * n + m * n * (n + 1)
                   for model, m in ms)
    else:  # velocity_step
        # per instance: cov (lower half), mu, efforts, gyro, tracker and per
        # update z, R in; cov, mu, tracker and per update m2, acc, nu out.
        # Operations (estimate): the 4x4 factor ~30, ~400 per Fossen row
        # (M·ν, Coriolis, both dampings, M⁻¹·rhs) for 10 rows, ~300 for the
        # reconstruction, ~60 for the tracker's pose, ~150 per update
        nb = args[2].shape[-1]
        ms = [len(z) for z in args[8]]
        elems = 10 + 4 + 6 + 3 + 13 + 16 + 4 + 13 + sum(m + m * m + 2 + m for m in ms)
        ops = (30 + 10 * 400 + 300 + 60 if args[1] else 0) + 150 * len(ms)
    esize = next(a for a in args if isinstance(a, torch.Tensor) and a.ndim == 3).element_size()
    t_bytes = elems * nb * esize / HBM_BYTES_PER_S
    t_ops = ops * nb / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_ms(name: str, args: tuple):
    """Time of the one PyTorch call that computes the same function, where
    there is one: for K1, ``torch.linalg.cholesky_ex`` of the equilibrated
    matrix plus the ± stack of its columns. K2 … K6 have none: no PyTorch
    call computes a filter's predict or update."""
    if name != "sigma_deltas":
        return None
    from slam_uwv_kalman_filters_tpu_torch.models.pose_fused import _mirror_half

    cov = _mirror_half(args[0]).permute(2, 1, 0)
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=torch.finfo(cov.dtype).tiny))
    corr = (cov / (d[..., :, None] * d[..., None, :])).contiguous()
    del cov

    def library():
        cols = torch.linalg.cholesky_ex(corr)[0].transpose(-1, -2) * d[:, None, :]
        return torch.cat([torch.zeros_like(cols[:, :1]), torch.stack([cols, -cols], 2).flatten(1, 2)], 1)

    ms = _time(library, 3)
    del corr
    return ms


def phase_mission_shapes(captured: dict, counts: dict, mission_counts: dict, mission_ms: float, stats: dict):
    """Each kernel against its plain version on the operands a main path
    gave it (K3 once per model, K4 once per m), at LIMITS; then both timed
    in turns plain, kernel, kernel, plain, and the library call where there
    is one. A kernel's time in the table is the launch-weighted mean over
    its keys. Returns {kernel: (ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
    per_key = {}
    for key, args in captured.items():
        name = key.split("[")[0]
        nb = next(a.shape[-1] for a in args if isinstance(a, torch.Tensor) and a.ndim == 3)
        compare(name, f"{key} main path bank={nb}", args, stats)
        kern, plain = _pair(name)
        p1, k1, k2, p2 = _time(lambda: plain(*args), 2), _time(lambda: kern(*args), 3), \
            _time(lambda: kern(*args), 3), _time(lambda: plain(*args), 2)
        bound_ms, bound_by = _bound(name, args)
        lib = _library_ms(name, args)
        per_key[key] = ((k1 + k2) / 2, (p1 + p2) / 2, bound_ms, bound_by, lib)
        log(f"time {key}: kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by})" + ("" if lib is None else f", library {lib:.3f} ms")
            + f" (f32, bank {nb}, {counts[key]} launches in the recorded pass)")
    times = {}
    for name in {k.split("[")[0] for k in per_key}:
        keys = [k for k in per_key if k.split("[")[0] == name]
        w = sum(counts[k] for k in keys)
        mean = lambda i: sum(counts[k] * per_key[k][i] for k in keys) / w
        by = max(keys, key=lambda k: counts[k] * per_key[k][2])
        times[name] = (mean(0), mean(1), mean(2), per_key[by][3], per_key[keys[0]][4])
    kernel_ms = sum(mission_counts[k] * per_key[k][0] for k in mission_counts if k in per_key)
    log(f"kernels of one mission second {kernel_ms:.1f} ms of {mission_ms:.1f} ms measured "
        f"({100 * (1 - kernel_ms / mission_ms):.1f}% outside the recorded kernels)")
    return times


def phase_profile(ls, params, meas, ticks: int = 20):
    """The device's idle share over ``ticks`` mission ticks under
    ``torch.profiler``: busy time is the union of the device-kernel
    intervals, over the host wall time of the ticks. Returns the idle share,
    or None where the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(ticks):
            ls = mission_tick(ls, params, meas, k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        log(f"profile: {ticks} mission ticks, idle share not measured (the profiler recorded no device events)")
        return None
    busy, cur = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in ev):
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    total = sum(e.time_range.end - e.time_range.start for e in ev)
    share = {name: sum(e.time_range.end - e.time_range.start for e in ev if f"{name}_kernel" in e.name) / total
             for name in TPU_KERNELS}
    idle = 1.0 - busy / wall_us
    log(f"profile: {ticks} mission ticks wall={wall_us / 1e6:.4f} s device busy={busy / 1e6:.4f} s "
        f"idle share={100 * idle:.3f}% device time: "
        + " ".join(f"{k}={100 * v:.2f}%" for k, v in share.items())
        + f" other={100 * (1 - sum(share.values())):.2f}% ({len(ev)} device events)")
    return idle


def banked_tick_inputs(meas, nb: int, k: int):
    """Tick ``k`` of bench.py's mission schedule as ``pose_driver.PoseInputs``
    for a bank: every stream present only on the ticks it fires, valid for
    every instance."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as drv

    z, r = meas["acc"]
    dev, dtype = z.device, z.dtype
    ones = torch.ones(nb, dtype=torch.bool, device=dev)
    stream = lambda key, on: (meas[key][0], meas[key][1].expand(nb, *meas[key][1].shape), ones) if on \
        else (None, None, None)
    dvl, press, adcp, eff = (stream("dvl", k % 20 == 19), stream("press", k % 50 == 49),
                             stream("adcp", k % 100 == 99), stream("eff", k % 10 == 9))
    return drv.PoseInputs(
        dt=torch.full((nb,), DT, dtype=dtype, device=dev),
        rotation_rate=torch.tensor([0.0, 0.0, 0.01], dtype=dtype, device=dev).expand(nb, 3),
        acc=z, acc_cov=r.expand(nb, 3, 3), acc_valid=ones,
        dvl=dvl[0], dvl_cov=dvl[1], dvl_valid=dvl[2],
        pressure=press[0], pressure_cov=press[1], pressure_valid=press[2],
        xy=None, xy_cov=None, xy_valid=None,
        adcp=adcp[0], adcp_cov=adcp[1],
        adcp_cell_weighting=None if adcp[0] is None else torch.full((nb,), 0.5, dtype=dtype, device=dev),
        adcp_valid=adcp[2],
        efforts=eff[0], efforts_cov=eff[1], efforts_valid=eff[2],
    )


def phase_banked_mission(device, nb, captured: dict, counts: dict):
    """The second main path: the mission second with a banked Monte-Carlo
    parameter set (:func:`banked_params`) through
    ``pose_driver.pose_step_bank_lanes`` at bank ``nb``, float32: K2 in full
    mode with its operands built once, pressure with per-instance p_atm (K3's
    aux lanes), body efforts with a per-instance vehicle model (K1, h in
    PyTorch, K4). A warm second records the operands of K2-full and K4, then
    a timed second runs between a zeroing and a reading of the counters."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as drv
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

    dtype = torch.float32
    bs, params, meas = mission_setup(nb, dtype, device)
    bp = banked_params(params, nb, dtype)
    banked_ops = pf.banked_predict_operands(bp, DT, dtype)
    ls = pf.to_lanes(bs)
    like = tree_map(lambda a: a[0].clone(), bs)
    del bs
    inputs = [banked_tick_inputs(meas, nb, k) for k in range(100)]
    keep = lambda key: key in ("pose_predict_full", "pose_update_tail[6]")
    with capture_operands(captured, counts, keep):  # warm mission second
        for inp in inputs:
            ls, _ = drv.pose_step_bank_lanes(ls, bp, inp, banked_ops=banked_ops)
    mission_counts = dict(counts)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for inp in inputs:
        ls, _ = drv.pose_step_bank_lanes(ls, bp, inp, banked_ops=banked_ops)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    rate = nb * 100 / seconds
    log(f"mission second (banked parameters): bank={nb} float32 ticks/s={rate:.6e} "
        f"seconds={seconds:.6f} launches={launches}")
    if launches != BANKED_SECOND:
        raise AssertionError(f"banked mission second launched {launches}, expected {BANKED_SECOND}")
    out = pf.from_lanes(ls, like)
    for name, t in (("cov", out.cov), ("mu", pf._pack_storage(out.mu))):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"banked mission second produced non-finite {name}")
    if not bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all()):
        raise AssertionError("banked mission second produced a non-positive variance")
    return launches, rate, mission_counts


def phase_fleet_ate(device, nb: int, minutes: float):
    """The fleet Monte-Carlo replay on the card (lanes path, float32): the
    JAX fleet test's setup — survey at 50 Hz, initial perturbations pos 0.05,
    vel 0.05, yaw 3e-3, the ``monte_carlo_params`` draw — held to its bounds:
    ATE max < 0.40 m, p50 < 0.16 m, every gated fix accepted, DVL NIS mean in
    (0.3, 2.0). Noise comes from seeded generators on the card."""
    import numpy as np

    from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup, monte_carlo
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank

    t0 = time.perf_counter()
    state, params, spec = fleet_setup.build_fleet_setup(minutes=minutes, rate=50.0, dtype_name="f32", device=device)
    bs = monte_carlo.perturb_initial_bank(
        bank.replicate(state, nb), torch.Generator(device=device).manual_seed(7),
        pos_sigma=0.05, vel_sigma=0.05, yaw_sigma=3e-3,
    )
    bp = fleet_setup.monte_carlo_params(params, nb, torch.float32)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    res = monte_carlo.run_fleet_mission(bs, bp, spec, torch.Generator(device=device).manual_seed(42), path="lanes")
    ate = res.ate.double().cpu().numpy()
    gacc = res.gps_accept_frac.cpu().numpy()
    nis = res.dvl_nis_mean.double().cpu().numpy()
    replay = time.perf_counter() - t1
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    p50, p95, worst = (float(np.percentile(ate, 50)), float(np.percentile(ate, 95)), float(ate.max()))
    log(f"fleet ATE replay: bank={nb} {spec.gyro.shape[0]} ticks float32 p50={p50:.4f} m p95={p95:.4f} m "
        f"max={worst:.4f} m gates min={gacc.min():.4f} DVL NIS mean={nis.mean():.4f} "
        f"replay={replay:.1f} s wall={time.perf_counter() - t0:.1f} s launches={launches}")
    if not (np.all(np.isfinite(ate)) and worst < 0.40 and p50 < 0.16 and np.all(gacc == 1.0)
            and 0.3 < nis.mean() < 2.0):
        raise AssertionError("the fleet ATE replay broke the fleet test's bounds")
    return {"p50_m": p50, "p95_m": p95, "max_m": worst, "replay_s": replay}


def phase_trajectory(device, ticks):
    """f32 kernels against the f64 plain path on the card, bank 256."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

    nb = 256
    gen = torch.Generator(device=device).manual_seed(11)
    bs64, params64, meas64 = mission_setup(nb, torch.float64, device)
    # the mission start of every instance: its initial covariance, its mean
    # moved by a draw from it (position 0.1 m, velocity 0.05 m/s)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64, device=device)
    bs64 = bs64._replace(mu=bs64.mu._replace(
        position=bs64.mu.position + 0.1 * rn(nb, 3), velocity=0.05 * rn(nb, 3)))
    bs32 = tree_map(lambda a: a.float(), bs64)
    _, params32, meas32 = mission_setup(nb, torch.float32, device)
    l32, l64 = pf.to_lanes(bs32), pf.to_lanes(bs64)
    t0 = time.perf_counter()
    worst_pos = worst_ang = worst_sig = 0.0
    for k in range(ticks):
        l32 = mission_tick(l32, params32, meas32, k)
        with plain_route():
            l64 = mission_tick(l64, params64, meas64, k)
        if k % 100 == 99 or k == ticks - 1:
            s32, s64 = pf.from_lanes(l32, bs32), pf.from_lanes(l64, bs64)
            for name, s in (("f32 kernels", s32), ("f64 plain", s64)):
                if not (bool(torch.isfinite(s.cov).all()) and bool(torch.isfinite(pf._pack_storage(s.mu)).all())):
                    raise AssertionError(f"trajectory tick {k}: non-finite {name} state")
                if not bool((torch.diagonal(s.cov, dim1=1, dim2=2) > 0).all()):
                    raise AssertionError(f"trajectory tick {k}: non-positive variance in {name}")
            dpos = (s32.mu.position.double() - s64.mu.position).norm(dim=1)
            sig = torch.diagonal(s64.cov, dim1=1, dim2=2)[:, 0:3].sum(1).sqrt()
            worst_pos = max(worst_pos, dpos.max().item())
            worst_sig = max(worst_sig, (dpos / sig).max().item())
            dq = mf.so3_boxminus(s32.mu.orientation.double(), s64.mu.orientation)
            worst_ang = max(worst_ang, dq.norm(dim=1).max().item())
    torch.cuda.synchronize()
    # 3x what the JAX package's own float32 generic path drifts from its
    # float64 one over the same 1000-tick mission from the same start
    # distribution at bank 256 on the CPU (3.4e-4 m, 8.7e-6 rad): float32
    # kernels may round differently, not worse
    limits = {"position_m": 1.0e-3, "orientation_rad": 2.6e-5}
    log(f"trajectory: bank={nb} ticks={ticks} max|Δposition|={worst_pos:.3e} m (limit {limits['position_m']:.1e}; "
        f"{worst_sig:.3e} of the f64 position σ) "
        f"max|Δorientation|={worst_ang:.3e} rad (limit {limits['orientation_rad']:.1e}) "
        f"wall={time.perf_counter() - t0:.1f}s")
    if worst_pos > limits["position_m"] or worst_ang > limits["orientation_rad"]:
        raise AssertionError("f32 kernel trajectory left the f64 plain trajectory")

# ---------------------------------------------------------------------------
# the whole-step kernels K5 and K6
# ---------------------------------------------------------------------------

STEP_VAR = {"velocity": 1e-3, "z_position": 0.01, "xy_position": 0.5, "acceleration": 4e-5, "pressure": 2500.0,
            "water_velocity": 1e-3}  # mission R of each model


def step_operands(ls, params, dtype, device, gen):
    """K5 operands on lanes state: the six-model chain with random z, the
    mission R, instance 0 pushed out of the χ²-95 gate of xy_position and
    water_velocity."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import ukf

    nb = ls.cov_t.shape[-1]
    z_ts, r_ts, s6 = [], [], []
    for model in puf.STEP_MODELS:
        m = puf.FUSED_MODELS[model]
        z = torch.randn(m, nb, generator=gen, dtype=torch.float64, device=device)
        z = z * 50.0 + 101325.0 if model == "pressure" else z
        thr = ukf.D2P95 if model in ("xy_position", "water_velocity") else None
        if thr is not None:
            z[:, 0] += 30.0
        z_ts.append(z.to(dtype).contiguous())
        r_ts.append((torch.eye(m, dtype=dtype, device=device) * STEP_VAR[model])[..., None].expand(m, m, nb).contiguous())
        aux = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,)}.get(model, ())
        s6.append(puf._scal_block(thr, aux, dtype, device).T)
    return (puf.STEP_MODELS, ls.cov_t, ls.mu_t, ls.rr_t, *pf._predict_operands_shared(params, DT, dtype),
            z_ts, r_ts, torch.cat(s6).contiguous())


def velocity_setup(nb: int, dtype, device, gen: torch.Generator | None = None):
    """bench.py's small-filter configuration (BASELINE configs[0]): the
    VelocityUKF at rest with thruster efforts [60, 0, 0, 0, 0, 1] on the
    default vehicle; with ``gen``, moved means, correlated covariances,
    efforts, gyro rates and tracker orientations per instance."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu
    from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank

    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    mu = vu.VelocityState(velocity=t([0.0, 0.0, 0.0]), z_position=t([0.0]))
    state, params = vu.init(mu, torch.eye(4, dtype=dtype, device=device) * 0.1,
                            bank.tree_map(lambda a: a.to(dtype), dyn.default_uwv_parameters(device=device)))
    state = vu.integrate_body_efforts(state, t([60.0, 0.0, 0.0, 0.0, 0.0, 1.0]))
    bs = bank.replicate(state, nb)
    if gen is not None:
        rn = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64, device=device).to(dtype)
        g = rn(nb, 4, 4)
        av = 0.05 * rn(nb, 3)
        bs = bs._replace(
            mu=vu.VelocityState(0.5 * rn(nb, 3), 2.0 * rn(nb, 1)),
            cov=0.02 * (g @ g.transpose(1, 2) / 4 + torch.eye(4, dtype=dtype, device=device)),
            body_efforts=30.0 * rn(nb, 6), angular_velocity=av,
            model_state=bs.model_state._replace(
                position=rn(nb, 3), orientation=mf.so3_boxplus(bs.model_state.orientation, 0.3 * rn(nb, 3)),
                linear_velocity=0.5 * rn(nb, 3), angular_velocity=av),
        )
        params = params._replace(model=params.model._replace(weight=t(1000.0), cog=t([0.01, -0.02, 0.05])))
    return bs, params


def phase_checks_steps(device):
    """K5 and K6 against their plain versions at bank 300, float32 and
    float64; K5 on the six-model chain (a rejected gate, NaN in the invalid
    covariance half) and against the K2 → K3 chain on the same operands; K6
    predict-only, update-only and predict + [DVL, pressure] with a rejected
    gate."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf

    nb = 300
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(9)
        bs, params, _ = mission_setup(nb, dtype, device, gen, spread=1.0)
        ls = pf.to_lanes(bs)
        n = pf.TANGENT_DIM
        upper = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)[..., None]
        ls = ls._replace(cov_t=torch.where(upper, float("nan"), ls.cov_t).contiguous())
        args = step_operands(ls, params, dtype, device, gen)
        compare("pose_step", "pose_step[six-model chain]", args)
        models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6 = args
        k5 = puf.pose_step_lanes_cuda(*args)
        cov, mu = pf.predict_lanes_cuda(cov_t, mu_t, rr_t, coeff, offs, q0m, scal)
        for k, model in enumerate(models):
            cov, mu, *_ = puf.update_model_lanes_cuda(model, z_ts[k], r_ts[k], mu, cov, scal6[k][:, None].contiguous())
        torch.cuda.synchronize()
        valid = torch.triu(torch.ones(n, n, dtype=torch.bool, device=device))
        same = torch.equal(k5[0][valid], cov[valid]) and torch.equal(k5[1], mu)
        prior = pf.predict_lanes_plain(cov_t, mu_t, rr_t, coeff, offs, q0m, scal)[0]
        a, n_err = _cov_err(k5[0], cov, prior)
        ok = max(n_err, _rel(k5[1], mu)) <= LIMITS[dtype]
        log(f"check pose_step against the K2 → K3 chain {str(dtype).split('.')[-1]}: max|Δcov|={a:.3e} "
            f"max|Δmu|={(k5[1] - mu).abs().max().item():.3e} normalized cov={n_err:.3e} bit-identical={same} "
            f"limit={LIMITS[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K5 disagrees with the K2 → K3 chain")
        vs, vp = velocity_setup(nb, dtype, device, gen)
        vl = vf.to_lanes(vs)
        z = (vl.mu_t[:3] + 0.05).contiguous()
        z[:, 0] += 3.0  # instance 0 fails the χ²-95 gate
        r3 = (torch.eye(3, dtype=dtype, device=device) * 0.01)[..., None].expand(3, 3, nb).contiguous()
        r1 = (torch.eye(1, dtype=dtype, device=device) * 0.04)[..., None].expand(1, 1, nb).contiguous()
        base = (vl.cov_t, vl.mu_t, vl.eff_t, vl.av_t, vl.trk_t, vf.params_block(vp, 0.05, dtype))
        for label, head, tail in (("predict", ((), True), ([], [], [])),
                                  ("update", (("dvl",), False), ([z], [r3], [7.815])),
                                  ("predict+dvl+pressure", (("dvl", "pressure"), True),
                                   ([z, (vl.mu_t[3:] + 0.1).contiguous()], [r3, r1], [7.815, -1.0]))):
            compare("velocity_step", f"velocity_step[{label}]", (*head, *base, *tail))


def stepped_tick(ls, params, meas, k: int):
    """One tick of bench.py's stepped schedule (``steps=True``): one K5 launch
    with acceleration and the tick's DVL (5 Hz), pressure (2 Hz) and χ²-gated
    ADCP (1 Hz), then body efforts (10 Hz) through K3."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import ukf

    ups = [puf.StepUpdate("acceleration", *meas["acc"])]
    if k % 20 == 19:
        ups.append(puf.StepUpdate("velocity", *meas["dvl"]))
    if k % 50 == 49:
        ups.append(puf.StepUpdate("pressure", *meas["press"], None, (params.atmospheric_pressure, 0.0, 0.0, 0.0)))
    if k % 100 == 99:
        ups.append(puf.StepUpdate("water_velocity", *meas["adcp"], ukf.D2P95, (0.5,)))
    ls, _ = puf.step_lanes(ls, params, DT, ups)
    if k % 10 == 9:
        ls, _ = puf.update_body_efforts_lanes(ls, params, *meas["eff"])
    return ls


def phase_stepped_mission(device, nb, chain_ls, captured: dict, counts: dict):
    """The third main path: the stepped mission second at bank ``nb``
    (float32, shared parameters), warm (recording K5's operands per chain)
    then timed between a zeroing and a reading of the counters (100 K5, 10
    K3). Its state after the two seconds is held to the K2 → K3 chain's after
    its two (``chain_ls``, the same start and schedule) at the float32 limit."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    dtype = torch.float32
    bs, params, meas = mission_setup(nb, dtype, device)
    ls = pf.to_lanes(bs)
    del bs
    with capture_operands(captured, counts, keep=lambda key: key.startswith("pose_step")):
        for k in range(100):
            ls = stepped_tick(ls, params, meas, k)
    mission_counts = {k: v for k, v in counts.items() if k.startswith("pose_step")}
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(100):
        ls = stepped_tick(ls, params, meas, k)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    rate = nb * 100 / seconds
    log(f"stepped mission second: bank={nb} float32 ticks/s={rate:.6e} seconds={seconds:.6f} launches={launches}")
    if launches != STEPPED_SECOND:
        raise AssertionError(f"stepped mission second launched {launches}, expected {STEPPED_SECOND}")
    a, n_err = _cov_err(ls.cov_t, chain_ls.cov_t, chain_ls.cov_t)
    mu_err = _rel(ls.mu_t, chain_ls.mu_t)
    ok = max(n_err, mu_err) <= LIMITS[dtype]
    log(f"check stepped second against the chain's second: max|Δcov|={a:.3e} normalized cov={n_err:.3e} "
        f"mu={mu_err:.3e} limit={LIMITS[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the stepped mission second left the K2 → K3 chain's state")
    return launches, rate, mission_counts


def phase_online_latency(device, ticks: int = 400):
    """bench.py's online-latency pattern on the port: per tick a host-made
    DVL z copied to the card, one K5 step (acceleration, velocity), and a
    one-element readback that closes the tick; p50 and p99 over ``ticks``
    ticks at bank 1 and 128, after one warm tick."""
    import numpy as np

    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    out, launches = {}, dict.fromkeys(cuda_lib.KERNELS, 0)
    for nb in (1, 128):
        bs, params, meas = mission_setup(nb, torch.float32, device)
        ls = pf.to_lanes(bs)
        acc = puf.StepUpdate("acceleration", *meas["acc"])
        r_dvl = meas["dvl"][1]
        z0 = np.tile(np.array([0.3, 0.0, 0.0], np.float32), (nb, 1))

        def tick(ls, zk):
            ls = puf.step_lanes(ls, params, DT, [acc, puf.StepUpdate("velocity", zk, r_dvl)])[0]
            ls.mu_t.reshape(-1)[0].item()  # the readback closes the tick
            return ls

        ls = tick(ls, torch.from_numpy(z0).to(device))
        cuda_lib.reset_launch_counts()
        lat = []
        for k in range(ticks):
            z_host = z0 + np.float32(1e-5 * np.sin(k))  # host-fresh measurement
            t1 = time.perf_counter()
            ls = tick(ls, torch.from_numpy(z_host).to(device))
            lat.append(time.perf_counter() - t1)
        bank_launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
        launches = {k: launches[k] + n for k, n in bank_launches.items()}
        lat_ms = np.asarray(lat) * 1e3
        out[nb] = (float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99)))
        log(f"online latency: bank={nb} float32 {ticks} ticks p50={out[nb][0]:.4f} ms p99={out[nb][1]:.4f} ms "
            f"launches={bank_launches}")
        if bank_launches != {**_NONE, "pose_step": ticks} or not bool(torch.isfinite(ls.cov_t).all()):
            raise AssertionError("online latency: the ticks launched something other than one K5 each, "
                                 "or the state went non-finite")
    return out, launches


def phase_online_estimator(device, nb: int = 128, seconds: int = 10, rate: float = 100.0):
    """examples/online_estimator.py --fused-step on the port: a seeded
    irregular, shuffled event stream (gyro 100 Hz, DVL 10 Hz, pressure 20 Hz)
    through the port's StreamPacker one second at a time, forward-filled gyro
    (set_rotation_rate_lanes), one K5 step per tick that has a DVL or
    pressure sample and one K2 predict per tick that has neither. Holds the
    final velocity error to the example's 0.02 m/s; the real-time factor is
    over the seconds after the first."""
    import numpy as np

    from slam_uwv_kalman_filters_tpu_torch import runtime
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config

    gyro, dvl, press = 0, 1, 2
    rng = np.random.default_rng(0)
    dt = 1.0 / rate
    n_ticks = int(rate)
    cfg = default_pose_ukf_config()
    g, rho, p_atm = 9.8209, float(cfg.hydrostatics.water_density), float(cfg.hydrostatics.atmospheric_pressure)
    true_v, depth = np.array([0.4, -0.1, 0.0]), -12.0
    f64, f32 = torch.float64, torch.float32
    state, params = pukf.init_from_pose(
        torch.tensor([0.0, 0.0, depth], dtype=f64), torch.eye(3, dtype=f64) * 0.25,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4, cfg,
        dyn.default_uwv_parameters(device=device), imu_delta_t=dt, device=device,
    )
    state = pukf.integrate_rotation_rate(state, torch.zeros(3, dtype=f64, device=device))
    state, params = bank.tree_map(lambda a: a.to(f32), state), bank.tree_map(lambda a: a.to(f32), params)
    like = bank.replicate(state, nb)
    ls = pf.to_lanes(like)
    r_dvl = torch.eye(3, dtype=f32, device=device) * 1e-4
    r_press = torch.eye(1, dtype=f32, device=device) * 2500.0
    press_aux = (params.atmospheric_pressure, 0.0, 0.0, 0.0)
    packer = runtime.StreamPacker(np.asarray([3, 3, 1], np.int32), t0_us=0, dt_us=int(1e6 / rate),
                                  window_ticks=n_ticks, payload_stride=6)
    last_gyro = np.zeros(3)
    total_events = 0
    steady_wall = first_wall = 0.0
    cuda_lib.reset_launch_counts()
    for sec in range(seconds):
        # one second of irregular sensor traffic, shuffled (the example's make_event_chunk)
        t0_us, dt_us = int(sec * 1e6), int(1e6 / rate)
        ts, ids, pay = [], [], []
        for k in range(n_ticks):
            t = t0_us + k * dt_us + rng.integers(-dt_us // 4, dt_us // 4)
            events = [(t, gyro, np.concatenate([rng.normal(scale=1e-4, size=3), np.zeros(3)]))]
            if k % 10 == 0:
                events.append((t + 1000, dvl, np.concatenate([true_v + rng.normal(scale=2e-3, size=3), np.zeros(3)])))
            if k % 5 == 0:
                events.append((t + 2000, press, np.asarray([p_atm - depth * g * rho + rng.normal(scale=50.0),
                                                            0, 0, 0, 0, 0])))
            for e in events:
                ts.append(e[0])
                ids.append(e[1])
                pay.append(e[2])
        order = rng.permutation(len(ts))
        ts, ids, pay = np.asarray(ts, np.int64)[order], np.asarray(ids, np.int32)[order], np.stack(pay)[order]
        total_events += len(ts)
        t_start = time.perf_counter()
        packer.push(ts, ids, pay)
        widx, values, valid = packer.pop(force=True)
        if widx != sec:
            raise AssertionError(f"online estimator: window {widx} released for second {sec}")
        gyro_vals, _ = runtime.forward_fill(values[gyro], valid[gyro], last_gyro)
        last_gyro = gyro_vals[-1, :3].copy()
        for k in range(n_ticks):
            rr = torch.from_numpy(np.tile(gyro_vals[k, :3], (nb, 1))).to(device=device, dtype=f32)
            ls = pf.set_rotation_rate_lanes(ls, rr)
            ups = []
            if valid[dvl, k]:
                zv = torch.from_numpy(np.tile(values[dvl, k, :3], (nb, 1))).to(device=device, dtype=f32)
                ups.append(puf.StepUpdate("velocity", zv, r_dvl))
            if valid[press, k]:
                zp = torch.from_numpy(np.tile(values[press, k, :1], (nb, 1))).to(device=device, dtype=f32)
                ups.append(puf.StepUpdate("pressure", zp, r_press, None, press_aux))
            if ups:
                ls, _ = puf.step_lanes(ls, params, dt, ups)
            else:
                ls = pf.predict_lanes(ls, params, dt)
        torch.cuda.synchronize()
        chunk = time.perf_counter() - t_start
        if sec == 0:
            first_wall = chunk
        else:
            steady_wall += chunk
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    v = pf.from_lanes(ls, like).mu.velocity[0].double().cpu().numpy()
    err = float(np.abs(v - true_v).max())
    rt = (seconds - 1) / steady_wall
    log(f"online estimator: bank={nb} {rate:.0f} Hz {seconds} s float32 native_packer={packer.native} "
        f"{total_events} events, {packer.dropped} dropped; steady state {rt:.3f}x real time "
        f"(first second {first_wall:.3f} s); final velocity error {err:.4f} m/s (limit 0.02) launches={launches}")
    if not err < 0.02:
        raise AssertionError("online estimator diverged")
    return {"real_time_factor": rt, "velocity_error_m_s": err}, launches


def phase_velocity_bank(device, nb: int, captured: dict, counts: dict, steps: int = 30):
    """The fourth main path: bench.py's small-filter step (VelocityUKF
    predict(0.05) + DVL z = [0.3, 0, 0], R = 1e-3·I) as one K6 launch per step
    on lanes state at bank ``nb``, float32 (``velocity_fused.params_block``
    keeps the parameter block from step to step): one warm step that records K6's
    operands, then ``steps`` timed steps between a zeroing and a reading of
    the counters."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    dtype = torch.float32
    bs, params = velocity_setup(nb, dtype, device)
    ls = vf.to_lanes(bs)
    z = torch.tensor([0.3, 0.0, 0.0], dtype=dtype, device=device).expand(nb, 3)
    r = torch.eye(3, dtype=dtype, device=device) * 1e-3
    step = lambda ls: vf.step_lanes(ls, params, 0.05, [vf.StepUpdate("dvl", z, r)])[0]
    with capture_operands(captured, counts, keep=lambda key: key.startswith("velocity_step")):
        ls = step(ls)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        ls = step(ls)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    rate = nb * steps / seconds
    log(f"VelocityUKF bank: bank={nb} float32 {steps} steps filter-steps/s={rate:.6e} seconds={seconds:.6f} "
        f"launches={launches}")
    if launches != {**_NONE, "velocity_step": steps}:
        raise AssertionError(f"VelocityUKF bank launched {launches}")
    out = vf.from_lanes(ls, bs)
    if not (bool(torch.isfinite(out.cov).all()) and bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all())):
        raise AssertionError("VelocityUKF bank produced a non-finite or non-positive covariance")
    return launches, rate, {k: steps for k in counts if k.startswith("velocity_step")}



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--bank", type=int, default=131072, help="mission-second bank (default 131072)")
    parser.add_argument("--ticks", type=int, default=1000, help="trajectory ticks (default 1000)")
    parser.add_argument("--fleet-bank", type=int, default=1024, help="fleet ATE replay bank (default 1024)")
    parser.add_argument("--fleet-minutes", type=float, default=1.0, help="fleet ATE replay minutes (default 1)")
    parser.add_argument("--velocity-bank", type=int, default=65536, help="VelocityUKF bank (default 65536)")
    parser.add_argument("--online-seconds", type=int, default=10, help="online estimator seconds (default 10)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import slam_uwv_kalman_filters_tpu_torch  # noqa: F401  (fails outside a checkout)
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    info = cuda_lib.build_info()
    log(f"build: {info['build_seconds']:.1f} s nvcc compile+link ({time.perf_counter() - t0:.1f} s to loaded library)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line or "stack frame" in line:
            log("ptxas: " + line.strip())

    phase_checks(device)
    phase_mean_accuracy(device)
    phase_checks_banked(device)
    phase_checks_steps(device)
    captured, counts, stats = {}, {}, {}
    ls, like, params, meas, shared, rate, mission_counts = phase_mission(device, args.bank, captured, counts)
    generic = phase_generic(ls, like, params, meas, captured, counts)
    times = phase_mission_shapes(captured, counts, mission_counts, 1e3 * args.bank * 100 / rate, stats)
    del captured
    idle = phase_profile(ls, params, meas)
    chain_ls = ls  # the chain's state after its two mission seconds
    del ls, like, params, meas
    captured, counts = {}, {}
    banked, rate_banked, mission_counts = phase_banked_mission(device, args.bank, captured, counts)
    times.update(phase_mission_shapes(captured, counts, mission_counts, 1e3 * args.bank * 100 / rate_banked, stats))
    del captured
    torch.cuda.empty_cache()
    captured, counts = {}, {}
    stepped, rate_stepped, mission_counts = phase_stepped_mission(device, args.bank, chain_ls, captured, counts)
    del chain_ls
    times.update(phase_mission_shapes(captured, counts, mission_counts, 1e3 * args.bank * 100 / rate_stepped, stats))
    del captured
    torch.cuda.empty_cache()
    latency, latency_launches = phase_online_latency(device)
    estimator, estimator_launches = phase_online_estimator(device, seconds=args.online_seconds)
    captured, counts = {}, {}
    velocity, rate_velocity, mission_counts = phase_velocity_bank(device, args.velocity_bank, captured, counts)
    times.update(phase_mission_shapes(captured, counts, mission_counts, 1e3 * args.velocity_bank * 30 / rate_velocity,
                                      stats))
    del captured
    torch.cuda.empty_cache()
    fleet = phase_fleet_ate(device, args.fleet_bank, args.fleet_minutes)
    phase_trajectory(device, args.ticks)

    # launches of each main path: the counters zeroed just before it, read just after
    paths = {
        "shared_mission_second": shared, "banked_mission_second": banked, "stepped_mission_second": stepped,
        "online_latency": latency_launches, "online_estimator": estimator_launches,
        "velocity_bank": velocity,
    }
    missing = [name for name in cuda_lib.KERNELS if not sum(p[name] for p in paths.values())]
    if missing:
        raise AssertionError(f"no main path launched {missing}")
    table = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": cuda_lib.KERNELS[name].source.replace("csrc/", "slam_uwv_kalman_filters_tpu_torch/csrc/"),
            "replaces": TPU_KERNELS[name],
            "launches": sum(p[name] for p in paths.values()),
            **{f"launches_{path}": p[name] for path, p in paths.items()},
            "launches_generic_bank_update": generic[name],
            "max_abs_err": stats[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": times[name][2],
            "bound_by": times[name][3],
            "library_ms": times[name][4],
        }
        for name in cuda_lib.KERNELS
    ], "mission_ticks_per_s": rate, "banked_mission_ticks_per_s": rate_banked,
        "stepped_mission_ticks_per_s": rate_stepped, "bank": args.bank,
        "online_latency_ms": {f"bank_{nb}": {"p50": v[0], "p99": v[1]} for nb, v in latency.items()},
        "online_estimator": estimator, "velocity_filter_steps_per_s": rate_velocity,
        "velocity_bank": args.velocity_bank,
        "dtype": "float32", "device_idle_share": idle, "fleet_ate": fleet, "card": smi,
        "wall_s": time.perf_counter() - t_start}
    log(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
