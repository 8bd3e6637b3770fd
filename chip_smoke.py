#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Builds the hand-written CUDA kernels from ``slam_uwv_kalman_filters_tpu_torch/
csrc`` and then, in order:

1. checks each kernel against its plain PyTorch version on the card, in
   float32 and float64, at bank 300 (more than two 128-thread blocks, with a
   ragged edge): K1 sigma deltas at n = 53 (lanes and bank-first layouts), K2
   the fused predict on perturbed
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
   then times K2 (both modes) at bank 1 and 256 and K5 on that chain at bank
   1 and 128 on the card alone, each held to its plain version first, and
   the host's cost of a kernel call (K5 at bank 1 straight to its wrapper,
   through the entry point, and through its op, which exported programs
   call);
13. runs the port's online estimator example
   (``slam_uwv_kalman_filters_tpu_torch/examples/online_estimator.py``)
   with --fused-step (bank 128, 100 Hz, 10 s; events through the port's
   StreamPacker, forward-filled gyro), which holds its velocity error to
   0.02 m/s; then the same with --aot at banks 128 and 1 (every tick function
   exported, round-tripped through bytes and replayed as a CUDA graph), each
   held bit for bit to a live run at its bank, with both real-time factors,
   the export seconds, the artifact bytes, the capture seconds and the
   captures and replays;
14. runs the VelocityUKF bank (bench.py's small-filter step: predict + DVL
   in one K6 launch) at bank 65 536, float32, 30 timed steps, and checks and
   times K6 on its operands;
15. (after the checks of 10) checks K7, the BottomUKF step, predict alone and
   predict + [range, normal] with a χ²-rejected instance, and K8, the banked
   SPD solve, on random and ill-conditioned 53x53 systems with 53
   right-hand sides, at bank 300, float32 and float64, in the lanes layout
   and bank-first with the right-hand side a transposed view;
16. runs the BottomUKF bank (bench.py's second small filter: predict + one
   range beam in one K7 launch) at bank 65 536, float32, 30 timed steps, and
   checks and times K7 on its operands;
17. runs the survey smoother: the fleet survey at 50 Hz for one minute over
   256 trajectories in float32, forward (K2, K3) storing every posterior on
   the card, backward (K1, K8) each tick; holds the smoothed covariance
   trace to the filtered one and prints both passes' times and the filtered
   and smoothed ATE; then checks and times K1 and K8 on the backward
   pass's (bank-first) operands, K1 beside ``cholesky_ex`` + the ± stack, K8
   beside ``cholesky_ex`` + ``cholesky_solve``, and checks K3 on the forward
   pass's operands and times it alone there per model;
18. (after the checks of 15) checks K9, the IndirectPoseUKF predict, on
   perturbed error states, and K10, its marker update with the 12-DOF
   augmentation, with 1 and 4 corners, shared and per-instance pixels and
   marker poses, at bank 300, float32 and float64, and that pad lanes stay
   finite and leave the bank's outputs unchanged;
19. runs the IndirectPoseUKF bank (bench.py's third small filter: predict +
   one marker corner, one K9 and one K10 launch) at bank 65 536, float32,
   30 timed steps, and checks and times K9 and K10 on its operands;
20. (after the checks of 18) checks K11, the PoseUKF visual-marker update
   with the 59-DOF augmentation, with 1 and 4 corners, shared and
   per-instance pixels and marker poses, at bank 300, float32 and float64,
   and that 28 pad lanes stay finite and leave the bank's outputs unchanged;
21. runs the marker-aided mission second: the shared mission second of 3
   plus one 4-corner marker tick (1 Hz, one K11 launch) at the fleet bank,
   float32, warm then timed (100 K2, 118 K3, 1 K11), and checks and times
   K11 on its operands;
22. runs the marker trajectory guard: 1000 ticks at bank 256 of the mission
   schedule plus a 4-corner marker sighting every 100 ticks through
   ``pose_driver.run_trajectory_bank_lanes``, the float32 kernels against
   the float64 plain path on the card, and holds the marker NIS finite on
   the sighting ticks and 0 elsewhere;
23. (after the checks of 20) checks K12, the banked Cholesky, against its
   plain version for n = 9, 53, 55, 59, 64 at banks 1, 127 and 300, float32
   and float64, on matrices with the 53-DOF covariance's spread and NaN in
   the unread upper half: explicit zeros above the diagonal, a non-SPD
   matrix NaN in both, n = 65 refused; and K13, the FMA roofline probe,
   against its plain version;
24. runs the Cholesky bank: ``ops.kernels.cholesky_banked`` on the
   covariance bank the shared mission second of 3 leaves (bank 131 072,
   float32, bank-first, read in place), counted (one K12), and checks and
   times K12 on its operands beside its plain version and
   ``torch.linalg.cholesky_ex`` with the same equilibration, and the call's
   wall time beside K12's event time;
25. runs the roofline: ``tools.roofline.measure_fma`` (chained K13
   launches), ``measure_hbm`` (the streaming triad) and ``measure_mxu``
   (cuBLAS float32 4096³ products, TF32 off), logged beside the data
   sheet's peaks, and ``count_tick_flops`` (a mission tick's matrix products
   on the generic bank path, on the CPU), and checks and times K13 on its
   operands;
26. runs the delayed fixes at bank 131 072, float32: from the shared
   second's end state, 200 states pushed at 100 Hz into per-instance
   delayed-state buffers of 256 while each moves at a known velocity, then
   one USBL-style fix 1 s late through
   ``pose_ukf.update_delayed_position_buffered_bank`` (K3, XY model, χ²95)
   and one through ``update_delayed_position_with_augmentation_bank`` (K1 at
   n = 55), both timed and counted; K1 and K3 checked and timed on their
   operands;
27. runs one live vehicle through the reference's class API:
   ``pose_ukf.PoseUKF`` on the card in float32 for 1000 ticks at 100 Hz
   (prediction with the delayed buffer, acceleration every tick, DVL 5 Hz,
   pressure 2 Hz, velocity-only body efforts 10 Hz, a fix 1 s late at
   0.5 Hz), per-tick p50 and p99, and holds its final pose to the same ticks
   through the class on the CPU in float64; then checks and times K1 at
   bank 1 on the operands the class gave it, and times K1 alone at bank 1
   for n = 1 … 64 and at bank 256 for n = 53;
28. (after 12) times K11 with 4 corners and K4 at m = 6 on the card alone at
   bank 1 and 256 (live vehicles near a marked structure; a generic update
   of a small bank), each held to its plain version first;
29. (after 28) times the small filters' kernels on the card alone on their
   banks' own operands (``tools/small_kernel_times.py``): K6 (predict +
   DVL), K7 (predict + range), K9 and K10 (1 and 4 corners) at banks 1, 256,
   16 384 and 65 536, each design a kernel picks among them, each held to
   its plain version first;
30. (last) runs the fleet-operations layer at bank 131 072, float32
   (``phase_fleet_ops``): the ported fleet Monte-Carlo example
   (``examples/fleet_monte_carlo.py``, 2 timed seconds, counted: 301 K2, 16
   K3) with its own checks (worst velocity error < 0.05 m/s, 1310 poisoned
   instances restarted, every instance healthy after the heal), its lanes
   second first held to the bank-first route's bits; 100 ticks plain and
   100 under ``failover.guarded``, and the selects under
   ``torch.cuda.set_sync_debug_mode("error")``; a checkpoint round trip bit
   for bit and a restart from the restored snapshot; a one-rank NCCL
   group's reductions against the local ones; 5 ticks under
   ``tracing.trace`` naming K2's and K3's kernels;
31. runs the ported examples, each with its own checks and its launches
   counted: the ICRA'18 survey (``--icra-minutes`` at 100 Hz, float32, the
   lanes replay as a bank of one: K2 and K3), held to an ATE under 0.10 m,
   and again for ``--icra-smooth-minutes`` with ``--smooth`` (the generic
   forward pass with K1 and the backward pass with K1 and K8; 1 minute, cut
   from the example's 3, whose two generic passes would take ~8 minutes;
   not below 1 minute, the length the bound is set for: at 0.5 minutes the
   JAX package's own example gives an ATE of 0.110 m on the CPU in
   float64), held to a smoothed ATE under 0.10 m as well; the noise-tuning sweep (8 candidates
   × 20 s at 25 Hz: K2 full mode and K3), held to its NIS bracket; the
   four-filter stack (``--full-stack-seconds`` at 50 Hz, every filter's
   generic solo functions; 10 s, cut from the example's 30), held to the
   example's five checks and all filters finite;
32. (after 17) runs ``torch.func.vmap`` over the solo filter functions
   (``phase_vmap``): (a) the vmap rules of K1 and K12 at bank 131 072 and of
   K8 at 256 systems (right-hand sides batched, then shared), each vmapped
   call bit for bit against one banked call, one launch, and held to the
   kernel's plain version; (b) ``vmap_filter(pose_ukf.predict)`` and the
   five mission-tick updates under ``masked`` for 100 ticks at bank 4096
   (one K1 launch per sigma-point draw), timed beside the generic bank
   forms, instances 0-63 held to a CPU float64 run within the trajectory
   guard's bounds; the VelocityUKF's vmapped solo predict at bank 65 536
   against K6; (c) the survey smoother over 64 trajectories whose dt
   differs (half at 0.02 s, half jittered ±1% from ``--seed``): finite,
   smoothed trace ≤ filtered, the shared-dt half held to the bank form.

A kernel under 1 ms is also timed on the card alone (``_device_ms``: the
calls held behind a spin kernel, so the host's time to enqueue each is
hidden); the ``ptxas`` lines of the warp-per-matrix and warp-per-instance
kernels K1, K2, K3, K4, K5, K8, K11 and K12 and of each design of the small
filters' K6, K7, K9 and K10 (registers, stack frame, spills) are printed on
their own, and the warps a block K3 (per model) and K12 choose at the main
paths' banks, and K2 (both modes), K4 (m = 6), K5, K11 and the design K6,
K7, K9 and K10 pick at each bank with the warps an SM keeps.

Lines before the last carry the card (``nvidia-smi`` name and power limit),
the build time, every check with its limit, both mission rates, the idle
share, the fleet ATE, the trajectory differences, the BottomUKF and
IndirectPoseUKF rates, the smoother's times and ATE, the marker-aided rate
and the marker trajectory's differences, the measured FMA and memory
ceilings, the delayed fixes' times and shares, the class's per-tick
latency and pose differences, the fleet-operations figures (filter-steps/s,
NEES, ms a tick plain and guarded, checkpoint bytes and seconds), the vmap
phase's checks and times, each new phase's seconds, and a JSON object
with the kernel table. The last line is ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; so does a machine without CUDA.

    python3 chip_smoke.py                       # the full run
    python3 chip_smoke.py --bank 2048 --ticks 100 --fleet-bank 64 --fleet-minutes 0.1 \
        --velocity-bank 4096 --online-seconds 2 --smoother-seconds 4 \
        --icra-minutes 1 --icra-smooth-minutes 1 --full-stack-seconds 5.2   # a short one
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
    "bottom_step": "slam_uwv_kalman_filters_tpu/models/bottom_fused.py:233",
    "solve_spd": "slam_uwv_kalman_filters_tpu/ops/kernels.py:391",
    "indirect_predict": "slam_uwv_kalman_filters_tpu/models/indirect_fused.py:182",
    "indirect_markers": "slam_uwv_kalman_filters_tpu/models/indirect_fused.py:283",
    "pose_markers": "slam_uwv_kalman_filters_tpu/models/pose_marker_fused.py:93",
    "cholesky": "slam_uwv_kalman_filters_tpu/ops/kernels.py:65",
    "fma_probe": "tools/roofline.py:114",
}
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM3
# bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# launch counts of the two main paths' timed mission seconds
_NONE = {"sigma_deltas": 0, "pose_predict": 0, "pose_predict_full": 0, "pose_update_model": 0,
         "pose_update_tail": 0, "pose_step": 0, "velocity_step": 0, "bottom_step": 0, "solve_spd": 0,
         "indirect_predict": 0, "indirect_markers": 0, "pose_markers": 0, "cholesky": 0, "fma_probe": 0}
SHARED_SECOND = {**_NONE, "pose_predict": 100, "pose_update_model": 118}
MARKER_SECOND = {**SHARED_SECOND, "pose_markers": 1}
BANKED_SECOND = {**_NONE, "sigma_deltas": 10, "pose_predict_full": 100, "pose_update_model": 108,
                 "pose_update_tail": 10}
STEPPED_SECOND = {**_NONE, "pose_step": 100, "pose_update_model": 10}
# normalized-error limits of a kernel against its plain version on the card:
# float64 is held near rounding; float32 sums 107 sigma points and runs a
# 53-column factorization in another order than PyTorch's library calls
LIMITS = {torch.float64: 1e-9, torch.float32: 2e-3}
# K11's: its plain version in float32 lands up to 3.5e-4 from its float64
# self (the NIS of the marker-aided second's operands at bank 128; 2.4e-4 on
# the checks' operands; measured on the CPU): two float32 versions may sit
# that far on opposite sides, and 3× margin on that gives 2.1e-3
MARKER_LIMITS = {torch.float64: 1e-9, torch.float32: 2.1e-3}
# K13's float32 chain against its plain version, relative to the largest
# output: 128 chained steps rounded once (fmaf) against twice or once
# (addcmul); the two float32 versions sit ~2e-7 from float64 on the CPU
PROBE_LIMIT = 1e-5
# bench.py's small-filter bank (the BottomUKF and IndirectPoseUKF banks) and
# the survey smoother's fleet of trajectories
BOTTOM_BANK = 65536
INDIRECT_BANK = 65536
SMOOTHER_BANK = 256
# the fleet-operations phase's bank: the fleet example at the mission second's scale
FLEET_OPS_BANK = 131072
# the warp-per-matrix and warp-per-instance kernels and the small filters'
# designs (K6, K7, K9, K10), whose ptxas lines are printed on their own
WARP_KERNELS = ("sigma_deltas_kernel", "solve_spd_kernel", "cholesky_kernel", "pose_update_model_kernel",
                "pose_predict_kernel", "pose_step_kernel", "pose_markers_kernel", "pose_update_tail_kernel",
                "bottom_step_group_kernel", "bottom_step_thread_kernel", "indirect_markers_kernel",
                "velocity_step_group_kernel", "velocity_step_thread_kernel", "indirect_predict_group_kernel",
                "indirect_predict_thread_kernel")
# the banks at which the small filters' kernels are timed alone: both sides
# of every design switch
SMALL_ALONE_BANKS = (1, 256, 16384, 65536)
# the visual marker of tests/test_full_mission.py: four corners of a 0.3 m
# square, a camera whose optical axis is body +x, a 1e-6·I pose prior
MARKER_CORNERS = ((0.15, 0.15, 0.0), (-0.15, 0.15, 0.0), (-0.15, -0.15, 0.0), (0.15, -0.15, 0.0))
MARKER_CAM_Q = (0.5, -0.5, 0.5, -0.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def _warps(name: str, dtype, *sizes) -> int:
    """Warps a block kernel ``name`` (K2–K7, K9–K12) launches with at ``sizes``."""
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    return cuda_lib.KERNELS[name].warps_per_block(dtype, *sizes)


def _resident(name: str, dtype, *sizes) -> int:
    """Warps an SM keeps resident at that block size (K2, K4–K7, K9–K11:
    the occupancy calculator's answer)."""
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    return cuda_lib.KERNELS[name].resident_warps(dtype, *sizes)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


def mission_setup(nb: int, dtype, device, gen: torch.Generator | None = None, spread: float = 0.0):
    """The bench's mission filter bank (``tools.roofline.mission_bank``),
    optionally perturbed (means moved, a random correlated covariance at the
    initial per-field scales)."""
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    def perturb(state, bs):
        n, f64 = 53, torch.float64
        rn = lambda *s: torch.randn(*s, generator=gen, dtype=f64, device=device)
        mu = bs.mu
        dq = rn(nb, 3) * 0.3 * spread
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
        return bs._replace(cov=c / (s[:, :, None] * s[:, None, :]) * sd[None, :, None] * sd[None, None, :])

    return roofline.mission_bank(nb, dtype, device, perturb if spread else None)


def mission_tick(ls, params, meas, k: int):
    """One tick of bench.py's mission schedule on lanes state."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import ukf
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    ls = pf.predict_lanes(ls, params, DT)
    ls, _ = puf.update_model_lanes("acceleration", ls, *meas["acc"])
    if roofline.DVL_AT(k):  # DVL 5 Hz
        ls, _ = puf.update_velocity_lanes(ls, params, *meas["dvl"])
    if roofline.PRESS_AT(k):  # pressure 2 Hz
        ls, _ = puf.update_model_lanes(
            "pressure", ls, *meas["press"], aux=(params.atmospheric_pressure, 0.0, 0.0, 0.0))
    if roofline.ADCP_AT(k):  # ADCP 1 Hz, χ²-95 gated
        ls, _ = puf.update_model_lanes("water_velocity", ls, *meas["adcp"], ukf.D2P95, aux=(0.5,))
    if roofline.EFF_AT(k):  # model-aided body efforts 10 Hz
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
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf

    return patched((pf, "_pose_predict_lanes", pf.predict_lanes_plain),
                   (puf, "_pose_update_model_lanes", puf.update_model_lanes_plain),
                   (pmf, "_pose_markers_lanes", pmf.pose_markers_lanes_plain))


def capture_operands(store: dict, counts: dict, keep=lambda key: True):
    """Record the operands of each kernel's last launch (K3's per model, K4's
    per m) in ``store`` where ``keep(key)``, and count launches per key in
    ``counts`` while the block runs; every launch still goes to the kernel."""
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

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
        (kernels, "sigma_deltas_cuda", recording(kernels.sigma_deltas_cuda, lambda a: "sigma_deltas[bank-first]")),
        (puf, "_pose_step_lanes", recording(puf._pose_step_lanes, lambda a: f"pose_step[{'+'.join(a[0])}]")),
        (vf, "_velocity_step_lanes",
         recording(vf._velocity_step_lanes, lambda a: f"velocity_step[{'+'.join(a[0]) or 'predict'}]")),
        (bf, "_bottom_step_lanes",
         recording(bf._bottom_step_lanes, lambda a: f"bottom_step[{'+'.join(('predict',) * a[1] + a[0])}]")),
        (kernels, "solve_spd_lanes_cuda", recording(kernels.solve_spd_lanes_cuda, lambda a: "solve_spd")),
        (kernels, "solve_spd_cuda", recording(kernels.solve_spd_cuda, lambda a: "solve_spd[bank-first]")),
        (ifu, "_indirect_predict_lanes", recording(ifu._indirect_predict_lanes, lambda a: "indirect_predict")),
        (ifu, "_indirect_markers_lanes",
         recording(ifu._indirect_markers_lanes, lambda a: f"indirect_markers[k={a[4].shape[0]}]")),
        (pmf, "_pose_markers_lanes", recording(pmf._pose_markers_lanes, lambda a: f"pose_markers[k={a[3].shape[0]}]")),
        (kernels, "cholesky_lanes_cuda", recording(kernels.cholesky_lanes_cuda, lambda a: "cholesky")),
        (kernels, "cholesky_cuda", recording(kernels.cholesky_cuda, lambda a: "cholesky[bank-first]")),
        (roofline, "fma_probe_cuda", recording(roofline.fma_probe_cuda, lambda a: "fma_probe")),
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
    """(kernel wrapper, plain version) of kernel ``name``; K1's, K8's and
    K12's bank-first wrappers under ``<name>[bank-first]``."""
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    return {
        "sigma_deltas[bank-first]": (kernels.sigma_deltas_cuda, kernels.sigma_deltas_plain),
        "solve_spd[bank-first]": (kernels.solve_spd_cuda, kernels.solve_spd_plain),
        "cholesky[bank-first]": (kernels.cholesky_cuda, kernels.cholesky_plain),
        "sigma_deltas": (kernels.sigma_deltas_lanes_cuda, kernels.sigma_deltas_lanes_plain),
        "pose_step": (puf.pose_step_lanes_cuda, puf.pose_step_lanes_plain),
        "velocity_step": (vf.velocity_step_lanes_cuda, vf.velocity_step_lanes_plain),
        "pose_predict": (pf.predict_lanes_cuda, pf.predict_lanes_plain),
        "pose_predict_full": (pf.predict_lanes_cuda, pf.predict_lanes_plain),
        "pose_update_model": (puf.update_model_lanes_cuda, puf.update_model_lanes_plain),
        "pose_update_tail": (puf.update_tail_cuda, puf.update_tail_plain),
        "bottom_step": (bf.bottom_step_lanes_cuda, bf.bottom_step_lanes_plain),
        "solve_spd": (kernels.solve_spd_lanes_cuda, kernels.solve_spd_lanes_plain),
        "indirect_predict": (ifu.indirect_predict_lanes_cuda, ifu.indirect_predict_lanes_plain),
        "indirect_markers": (ifu.indirect_markers_lanes_cuda, ifu.indirect_markers_lanes_plain),
        "pose_markers": (pmf.pose_markers_lanes_cuda, pmf.pose_markers_lanes_plain),
        "cholesky": (kernels.cholesky_lanes_cuda, kernels.cholesky_lanes_plain),
        "fma_probe": (roofline.fma_probe_cuda, roofline.fma_probe_plain),
    }[name]


def _lanes_view(key: str, args: tuple) -> tuple:
    """K1's, K8's and K12's bank-first operands (``<name>[bank-first]``) as
    views in the lanes layout the checks, bounds and library calls read;
    other operands as they are."""
    if key in ("sigma_deltas[bank-first]", "cholesky[bank-first]"):
        return (args[0].permute(2, 1, 0),)
    if key == "solve_spd[bank-first]":
        return args[0].permute(2, 1, 0), args[1].permute(1, 2, 0)
    return args


def compare(name: str, label: str, args: tuple, stats: dict | None = None, kernel=None) -> None:
    """Run kernel ``name`` (K1, K8 and K12 also ``<name>[bank-first]``) and
    its plain version on ``args``, log the errors beside the limit and raise
    past it; keep the float32 max abs error per kernel in ``stats``.
    ``kernel``, where given, is called on ``args`` in the wrapper's place
    (the vmapped entry point, which reaches the kernel through its rule)."""
    kern, plain = _pair(name)
    kern = kernel or kern
    ko, po = kern(*args), plain(*args)
    torch.cuda.synchronize()
    if name.endswith("[bank-first]"):  # outputs (N, 2n+1, n), (N, n, k) or (N, n, n) as lanes views
        axes = (2, 1, 0) if name.startswith("cholesky") else (1, 2, 0)
        name, args, ko, po = name.split("[")[0], _lanes_view(name, args), ko.permute(*axes), po.permute(*axes)
    if name == "sigma_deltas":
        dtype = ko.dtype
        scale = po.abs().amax(dim=(0, 1), keepdim=True)
        errs = {"abs": (ko - po).abs().max().item(), "rel": ((ko - po).abs() / scale).max().item()}
    elif name == "cholesky":
        # |ΔL(r, c)| over √A_rr: row r of the factor scales with it; a matrix
        # whose factorization fails must be NaN in both, whole
        dtype = ko.dtype
        d = torch.sqrt(torch.diagonal(args[0], dim1=0, dim2=1).T)[None]
        failed_k, failed_p = torch.isnan(ko).all(dim=0).all(dim=0), torch.isnan(po).all(dim=0).all(dim=0)
        ok = ~failed_p
        n = ko.shape[0]
        upper = torch.tril(torch.ones(n, n, dtype=torch.bool, device=ko.device), -1)  # [c, r < c]
        any_ok = bool(ok.any())
        errs = {"abs": (ko - po)[..., ok].abs().max().item() if any_ok else 0.0,
                "rel": ((ko - po).abs() / d)[..., ok].max().item() if any_ok else 0.0,
                "failed_differ": float((failed_k != failed_p).sum().item()),
                "finite": 0.0 if bool(torch.isfinite(ko[..., ok]).all()) else float("inf"),
                "upper_nonzero": float((ko[..., ok][upper] != 0).sum().item())}
    elif name == "fma_probe":
        dtype = ko.dtype
        errs = {"abs": (ko - po).abs().max().item(), "rel": ((ko - po).abs().max() / po.abs().max()).item()}
    elif name == "solve_spd":
        # D·X against its largest entry per column and instance, D = √diag A:
        # the equilibrated solve is accurate relative to that
        dtype = ko.dtype
        d = torch.sqrt(torch.diagonal(args[0], dim1=0, dim2=1).T)[:, None, :]
        scale = (po * d).abs().amax(dim=0, keepdim=True)
        errs = {"abs": (ko - po).abs().max().item(), "rel": ((ko - po).abs() * d / scale).max().item(),
                "finite": 0.0 if bool(torch.isfinite(ko).all()) else float("inf")}
    elif name == "bottom_step":
        dtype = ko[0].dtype
        errs = {"abs": max((ko[0] - po[0]).abs().max().item(), (ko[1] - po[1]).abs().max().item()),
                "cov": _rel(ko[0], po[0]), "mu": _rel(ko[1], po[1])}
        flips = 0
        for (km2, kacc, knu), (pm2, pacc, pnu), thr in zip(ko[2], po[2], args[11]):
            near = (pm2 - thr).abs() <= 1e-3 * abs(thr)
            flips += int(((kacc != pacc) & ~near).sum().item())
            errs["m2"] = max(errs.get("m2", 0.0), _rel(km2, pm2))
            errs["nu"] = max(errs.get("nu", 0.0), _rel(knu, pnu))
        errs["gate_flips"] = float(flips)
    elif name in ("pose_predict", "pose_predict_full", "indirect_predict"):
        dtype = ko[0].dtype
        a, n_err = _cov_err(ko[0], po[0], po[0])
        errs = {"abs": a, "cov": n_err, "mu": _rel(ko[1], po[1])}
    elif name in ("indirect_markers", "pose_markers"):
        dtype = ko[0].dtype
        a, n_err = _cov_err(ko[0], po[0], args[0])  # normalized by the prior
        # K11 writes the valid half of its covariance only
        outs = (_valid(ko[0]) if name == "pose_markers" else ko[0], *ko[1:])
        errs = {"abs": max(a, (ko[1] - po[1]).abs().max().item()), "cov": n_err, "mu": _rel(ko[1], po[1]),
                "m2": _rel(ko[2], po[2]), "nu": _rel(ko[3], po[3]),
                "finite": 0.0 if all(bool(torch.isfinite(x).all()) for x in outs) else float("inf")}
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
    limit = PROBE_LIMIT if name == "fma_probe" else (MARKER_LIMITS if name == "pose_markers" else LIMITS)[dtype]
    ok = max(v for k, v in errs.items() if k != "abs") <= limit
    log(f"check {label} {str(dtype).split('.')[-1]}: "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" limit={limit:.1e} {'ok' if ok else 'FAIL'}")
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
        compare("sigma_deltas[bank-first]", "sigma_deltas[bank-first]", (bs.cov,))
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


def _time(fn, reps: int, hold_cycles: int = 0) -> float:
    """Milliseconds per call from CUDA events, after one warm call. With
    ``hold_cycles``, a spin kernel of that many cycles holds the stream while
    the host enqueues the calls, so that they run back to back."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold_cycles:
        torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps: int = 20, cycles: int = 200_000):
    """Milliseconds per call on the card alone, without the host's time to
    enqueue each call (which :func:`_time` includes where it is the longer):
    ``reps`` calls held behind ``cycles`` of spin per call (~0.1 ms at ~2
    GHz by default), the median of three rounds. None where PyTorch has no
    spin kernel."""
    if not hasattr(torch.cuda, "_sleep"):
        return None
    return sorted(_time(fn, reps, hold_cycles=cycles * reps) for _ in range(3))[1]


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
        # n from the operands: the mission's 53, the delayed fix's 55
        nb, n = args[0].shape[-1], args[0].shape[0]
        half, chol = n * (n + 1) // 2, n**3 / 3 + 2 * n * n
        elems, ops = half + (2 * n + 1) * n, chol + (2 * n + 1) * n
    elif name == "cholesky":
        # the lower half read, the whole factor written (zeros above the
        # diagonal); the factorization, its equilibration and the back-scaling
        nb, n = args[0].shape[-1], args[0].shape[0]
        elems = n * (n + 1) // 2 + n * n
        ops = n**3 / 3 + 2 * n * n + n * (n + 1) // 2
    elif name == "fma_probe":
        # a and b read, out written; 2·CHAIN for the chains, 3 to start them,
        # 4 for the sum and its scale
        from slam_uwv_kalman_filters_tpu_torch.tools.roofline import CHAIN

        nb = args[0].numel()
        elems, ops = 3, 2 * CHAIN + 7
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
    elif name == "bottom_step":
        # per instance: cov (lower half), mu, velocity and per update z, R
        # (and a range's beam direction and origin) in; cov, mu and per update
        # m2, acc, nu out. Operations (estimate): the 3x3 factor ~20, the 7
        # sigma normals ~40 each (sin, cos, sqrt), one 4-iteration Karcher
        # mean ~1600 (7 log maps with atan2 ~50, an exp map, a basis per
        # iteration), 7 log maps ~350 and ~100 of sums for a predict; per
        # update the redraw ~300, then the range's 7 ray/plane ratios ~90, or
        # the normal's Karcher mean, 8 log maps ~2000, and the tail ~150
        nb = args[2].shape[-1]
        ups = args[0]
        elems = 6 + 4 + 3 + 9 + 4 + sum((1 + 1 + 6 if u == "range" else 3 + 4) + 2 + (1 if u == "range" else 2)
                                        for u in ups)
        ops = (20 + 280 + 1600 + 350 + 100 if args[1] else 0)
        ops += sum(300 + 150 + (90 if u == "range" else 2000) for u in ups)
    elif name == "solve_spd":
        # the system's valid half and the right-hand sides in, the solution
        # out; equilibration 2n², the factor n³/3, two substitutions 2n²k
        n, k, nb = args[1].shape
        elems = n * (n + 1) // 2 + 2 * n * k
        ops = 2 * n * n + n**3 / 3 + 2 * n * n * k
    elif name == "indirect_predict":
        # per instance: cov (lower half) and mu in, cov and mu out (the 38
        # shared scalars are negligible). Operations (estimate): the 6x6
        # factor ~100; 13 sigma orientations, each ⊞ (exp with sin, cos,
        # sqrt; a product; renormalization ~65), log (atan2 ~25) and the
        # decay ⊞ ~65; 4 Karcher iterations of 13 products and log maps plus
        # an exp map ~750 each; 13 deviations ~690; ½ΣDDᵀ over 21 entries
        # ~550; the rotated Q and the means ~160
        nb = args[0].shape[-1]
        elems = 21 + 7 + 36 + 7
        ops = 100 + 13 * 155 + 4 * 750 + 690 + 550 + 160
    elif name == "indirect_markers":
        # per instance: cov (lower half), mu, the pose reference, the marker
        # pose and per corner z, R in; cov, mu and per corner m2, nu out.
        # Operations per corner (estimate): the 12x12 factor ~700; 25 sigma
        # points, each two ⊞ maps ~130, two products ~56, three rotations
        # ~90 and the normalization ~30; 4 Karcher iterations of 25 S² log
        # maps (cross product, two sqrt, atan2 ~45) plus a basis and an exp
        # map ~60; 25 deviations ~1125 and the S, C sums ~1500; the tail
        # ~450 and the corrections ~150
        nb, k = args[0].shape[-1], args[4].shape[0]
        elems = 21 + 7 + 7 + 7 + 7 * k + 36 + 7 + 3 * k
        ops = k * (700 + 25 * 306 + 4 * (25 * 45 + 60) + 1125 + 1500 + 450 + 150)
    elif name == "pose_markers":
        # per instance: cov (valid half), mu, the marker pose and per corner
        # z, R in; cov (valid half), mu and per corner m2, nu out (the 43 +
        # 3k shared scalars are negligible). Operations per corner: the
        # equilibrated 59x59 factor 59³/3 + 2·59²; 119 bearing evaluations,
        # each two ⊞ maps ~130, a product ~28, three rotations ~90 and the
        # normalization ~20 (estimate); 4 Karcher iterations of 119 S² log
        # maps ~45 plus a basis and an exp map ~60, then 119 deviations ~45
        # and the S sums ~6 each (estimate); C 2·59·60 and the gain ~4·59;
        # the correction ~4·59 + two ⊞ ~130; the downdate 2·59·60
        nb, k = args[0].shape[-1], args[3].shape[0]
        m_n = 59
        elems = half + 54 + 7 + 7 * k + half + 54 + 3 * k
        ops = k * (m_n**3 / 3 + 2 * m_n * m_n + 119 * 268 + 4 * (119 * 45 + 60) + 119 * 51
                   + 2 * m_n * (m_n + 1) + 8 * m_n + 130 + 2 * m_n * (m_n + 1))
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
    esize = next(a for a in args if isinstance(a, torch.Tensor) and a.ndim in (1, 3)).element_size()
    t_bytes = elems * nb * esize / HBM_BYTES_PER_S
    t_ops = ops * nb / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# the figures phase_mission_shapes returns for each kernel, in order
TIME_FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")


def _median_ms(label: str, fn, reps: int, rounds: int = 5) -> float:
    """Median of ``rounds`` timings of ``reps`` calls each, after three warm
    calls; logs the spread beside it."""
    for _ in range(3):
        fn()
    ms = sorted(_time(fn, reps) for _ in range(rounds))
    log(f"library {label}: median {ms[rounds // 2]:.3f} ms of {rounds} rounds of {reps} calls "
        f"(min {ms[0]:.3f}, max {ms[-1]:.3f})")
    return ms[rounds // 2]


def _library_ms(name: str, args: tuple):
    """Time of the PyTorch calls that compute the same function, where there
    are: for K1, ``torch.linalg.cholesky_ex`` of the equilibrated matrix plus
    the ± stack of its columns; for K8, ``torch.linalg.cholesky_ex`` and
    ``torch.cholesky_solve`` on the same equilibrated operands (D⁻¹AD⁻¹,
    D⁻¹B). The median of several warm rounds: a batched factorization's
    first calls include the library's own set-up. K2 … K7 have none: no
    PyTorch call computes a filter's predict or update."""
    if name == "solve_spd":
        from slam_uwv_kalman_filters_tpu_torch.models.pose_fused import _mirror_half

        spd = _mirror_half(args[0]).permute(2, 1, 0)
        d = torch.sqrt(torch.clamp(torch.diagonal(spd, dim1=-2, dim2=-1), min=torch.finfo(spd.dtype).tiny))
        corr = (spd / (d[..., :, None] * d[..., None, :])).contiguous()
        rhs = (args[1].permute(2, 0, 1) / d[..., :, None]).contiguous()
        del spd
        return _median_ms("solve_spd", lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky_ex(corr)[0]), 10)
    if name == "cholesky":
        # the same function as one library factorization: equilibrate,
        # cholesky_ex, scale back (the bank-first matrices, lower half valid)
        from slam_uwv_kalman_filters_tpu_torch.models.pose_fused import _mirror_half

        cov = _mirror_half(args[0]).permute(2, 1, 0).contiguous()
        tiny = torch.finfo(cov.dtype).tiny

        def library():
            d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=tiny))
            return torch.linalg.cholesky_ex(cov / (d[:, :, None] * d[:, None, :]))[0] * d[:, :, None]

        ms = _median_ms("cholesky", library, 3)
        del cov
        return ms
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

    ms = _median_ms("sigma_deltas", library, 3)
    del corr
    return ms


def phase_mission_shapes(path: str, captured: dict, counts: dict, mission_counts: dict, mission_ms: float,
                         stats: dict):
    """Each kernel against its plain version on the operands that main path
    ``path`` gave it (K3 once per model, K4 once per m, K1 and K8 per
    layout), at LIMITS; then both timed in turns plain, kernel, kernel,
    plain, and the library call where there is one; a kernel under 1 ms also
    by :func:`_device_ms`. A kernel's time in the table is the
    launch-weighted mean over its keys; ``mission_counts`` are the launches
    of each key in the path's timed run of ``mission_ms``. Returns {kernel:
    (ms, plain_ms, bound_ms, bound_by, library_ms, device_ms)}."""
    per_key = {}
    for key, args in captured.items():
        name = key.split("[")[0]
        lanes = _lanes_view(key, args)
        nb = next(a.shape[-1] for a in lanes if isinstance(a, torch.Tensor) and a.ndim in (1, 3))
        pair = key if key.endswith("[bank-first]") else name  # K3's and K4's keys name one kernel
        compare(pair, f"{key} main path bank={nb}", args, stats)
        kern, plain = _pair(pair)
        p1, k1, k2, p2 = _time(lambda: plain(*args), 2), _time(lambda: kern(*args), 3), \
            _time(lambda: kern(*args), 3), _time(lambda: plain(*args), 2)
        device = _device_ms(lambda: kern(*args)) if k1 < 1.0 else None
        bound_ms, bound_by = _bound(name, lanes)
        lib = _library_ms(name, lanes)
        per_key[key] = ((k1 + k2) / 2, (p1 + p2) / 2, bound_ms, bound_by, lib, device)
        log(f"time {key}: kernel {k1:.3f}/{k2:.3f} ms" + ("" if device is None else f" (device {device:.4f} ms)")
            + f", plain {p1:.3f}/{p2:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})"
            + ("" if lib is None else f", library {lib:.3f} ms")
            + f" (f32, bank {nb}, {counts[key]} launches in the recorded pass)")
    times = {}
    for name in {k.split("[")[0] for k in per_key}:
        keys = [k for k in per_key if k.split("[")[0] == name]
        w = sum(counts[k] for k in keys)
        mean = lambda i: sum(counts[k] * per_key[k][i] for k in keys) / w
        by = max(keys, key=lambda k: counts[k] * per_key[k][2])
        times[name] = (mean(0), mean(1), mean(2), per_key[by][3], per_key[keys[0]][4], per_key[keys[0]][5])
    kernel_ms = sum(mission_counts[k] * per_key[k][0] for k in mission_counts if k in per_key)
    log(f"kernels of the {path} {kernel_ms:.1f} ms of {mission_ms:.1f} ms measured "
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
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    z, r = meas["acc"]
    dev, dtype = z.device, z.dtype
    ones = torch.ones(nb, dtype=torch.bool, device=dev)
    stream = lambda key, on: (meas[key][0], meas[key][1].expand(nb, *meas[key][1].shape), ones) if on \
        else (None, None, None)
    dvl, press, adcp, eff = (stream("dvl", roofline.DVL_AT(k)), stream("press", roofline.PRESS_AT(k)),
                             stream("adcp", roofline.ADCP_AT(k)), stream("eff", roofline.EFF_AT(k)))
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


def phase_checks_steps(device):
    """K5 and K6 against their plain versions at bank 300, float32 and
    float64; K5 on the six-model chain (a rejected gate, NaN in the invalid
    covariance half) and against the K2 → K3 chain on the same operands; K6
    predict-only, update-only and predict + [DVL, pressure] with a rejected
    gate."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.tools import small_kernel_times as skt

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
        vs, vp = skt.velocity_setup(nb, dtype, device, gen)
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
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    ups = [puf.StepUpdate("acceleration", *meas["acc"])]
    if roofline.DVL_AT(k):
        ups.append(puf.StepUpdate("velocity", *meas["dvl"]))
    if roofline.PRESS_AT(k):
        ups.append(puf.StepUpdate("pressure", *meas["press"], None, (params.atmospheric_pressure, 0.0, 0.0, 0.0)))
    if roofline.ADCP_AT(k):
        ups.append(puf.StepUpdate("water_velocity", *meas["adcp"], ukf.D2P95, (0.5,)))
    ls, _ = puf.step_lanes(ls, params, DT, ups)
    if roofline.EFF_AT(k):
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


def phase_k2_k5_alone(device) -> dict:
    """K2 (both modes) at bank 1 and 256 and K5 (the online chain
    [acceleration, velocity]) at bank 1 and 128 on the card alone
    (:func:`_device_ms`), float32, on perturbed mission states (a banked
    parameter draw for the full mode), each first held to its plain version
    on the same operands. Returns {"<kernel>_bank_<N>": ms}."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf

    gen = torch.Generator(device=device).manual_seed(71)
    out = {}
    for nb in (1, 128, 256):
        bs, params, meas = mission_setup(nb, torch.float32, device, gen, spread=1.0)
        ls = pf.to_lanes(bs)
        calls = {}
        if nb != 128:
            bo = pf.banked_predict_operands(banked_params(params, nb, torch.float32, every_operand=True), DT,
                                            torch.float32)
            calls["pose_predict"] = (ls.cov_t, ls.mu_t, ls.rr_t, *pf._predict_operands_shared(params, DT, torch.float32))
            calls["pose_predict_full"] = (ls.cov_t, ls.mu_t, ls.rr_t, bo.coeff, bo.offs, bo.q0m_t, bo.scal, bo.aux_t)
        if nb != 256:
            z_ts = [meas[k][0].T.contiguous() for k in ("acc", "dvl")]
            r_ts = [meas[k][1][..., None].expand(3, 3, nb).contiguous() for k in ("acc", "dvl")]
            s6 = torch.cat([puf._scal_block(None, (), torch.float32, device).T] * 2).contiguous()
            calls["pose_step"] = (("acceleration", "velocity"), ls.cov_t, ls.mu_t, ls.rr_t,
                                  *pf._predict_operands_shared(params, DT, torch.float32), z_ts, r_ts, s6)
        for name, args in calls.items():
            compare(name, f"alone bank={nb}", args)
            out[f"{name}_bank_{nb}"] = _device_ms(lambda: _pair(name)[0](*args))
    log("K2 and K5 on the card alone, float32: "
        + " ".join(f"{k}={'not measured' if v is None else f'{v:.4f} ms'}" for k, v in out.items()))
    return out


def phase_op_dispatch(device, calls: int = 500) -> dict:
    """The host's cost of each way to a kernel
    (``tools.host_paths.dispatch_us``): K5 at bank 1 on the online chain,
    ``calls`` calls straight to the CUDA wrapper, through the entry point
    (which eagerly goes straight to the wrapper) and through the op
    ``slam_uwv::pose_step`` (what an exported program calls). Returns the
    host µs a call each way."""
    from slam_uwv_kalman_filters_tpu_torch.tools import host_paths

    out = host_paths.dispatch_us(device, calls)
    log(f"op dispatch: K5 at bank 1, host µs a call straight to the wrapper {out['direct_us']:.1f}, through the "
        f"entry point {out['entry_us']:.1f} ({out['entry_us'] - out['direct_us']:+.1f}), through the op "
        f"{out['op_us']:.1f} ({out['op_us'] - out['direct_us']:+.1f}); runs {out.pop('runs')}")
    return out


def tail_check_operands(nb: int, dtype, device, gen: torch.Generator, m: int):
    """K4 operands at bank ``nb``: perturbed mission states, their sigma
    deltas (K1's plain version), measurement deviations of 0.1 about their
    mean, ν of 0.3, R = 0.05·I, every 7th ν far out of a χ² gate."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels

    bs, _, _ = mission_setup(nb, torch.float64, device, gen, spread=1.0)
    ls = pf.to_lanes(bs)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64, device=device)
    dz = 0.1 * rn(pf.NSIG, m, nb)
    nu = 0.3 * rn(m, nb)
    nu[:, ::7] += 10.0
    r = (0.05 * torch.eye(m, dtype=torch.float64, device=device))[..., None].repeat(1, 1, nb)
    to = lambda x: x.to(dtype).contiguous()
    return (to(kernels.sigma_deltas_lanes_plain(ls.cov_t)), to(dz - dz.mean(0)), to(nu), to(r), to(ls.mu_t),
            to(ls.cov_t), 5.991)


def phase_k11_k4_alone(device) -> dict:
    """K11 (4 corners, shared marker data) and K4 (m = 6, χ² gate) at bank 1
    and 256 on the card alone (:func:`_device_ms`), float32, each first held
    to its plain version on the same operands. Returns {"<kernel>_bank_<N>":
    ms}."""
    gen = torch.Generator(device=device).manual_seed(73)
    out = {}
    for nb in (1, 256):
        calls = {"pose_markers": marker_check_operands(nb, torch.float32, device, gen, 4, False),
                 "pose_update_tail": tail_check_operands(nb, torch.float32, device, gen, 6)}
        for name, args in calls.items():
            compare(name, f"alone bank={nb}", args)
            out[f"{name}_bank_{nb}"] = _device_ms(lambda: _pair(name)[0](*args))
    log("K11 and K4 on the card alone, float32: "
        + " ".join(f"{k}={'not measured' if v is None else f'{v:.4f} ms'}" for k, v in out.items()))
    return out


def phase_small_alone(device) -> dict:
    """K6 (predict + DVL), K7 (predict + one range), K9 and K10 (1 and 4
    corners) at banks ``SMALL_ALONE_BANKS`` on the card alone
    (:func:`_device_ms`, ~0.5 ms of spin a call: K6's and K7's wrappers pack
    their chains on the host), float32, on the VelocityUKF, BottomUKF and
    IndirectPoseUKF banks' own operands (one step of each bank's entry
    points, ``tools/small_kernel_times.py``), each first held to its plain
    version on the same operands; with the warps a block the design picked
    at each bank launches (its group size: 4 × 32 / warps for a group of
    lanes; 128 one thread an instance). Returns {"<kernel>_bank_<N>": ms}."""
    from slam_uwv_kalman_filters_tpu_torch.tools import small_kernel_times as skt

    out = {}
    for nb in SMALL_ALONE_BANKS:
        calls = {"velocity_step": skt.velocity_operands(nb, torch.float32, device),
                 "bottom_step": skt.bottom_operands(nb, torch.float32, device),
                 "indirect_predict": skt.indirect_predict_operands(nb, torch.float32, device)}
        for k in (1, 4):
            calls[f"indirect_markers[k={k}]"] = skt.indirect_operands(nb, k, torch.float32, device)
        for label, args in calls.items():
            name = label.split("[")[0]
            compare(name, f"alone bank={nb} {label} ({_warps(name, torch.float32, nb)} warps a block)", args)
            out[f"{label}_bank_{nb}"] = _device_ms(lambda: _pair(name)[0](*args), cycles=1_000_000)
        del calls
    log("K6, K7, K9 and K10 on the card alone, float32: "
        + " ".join(f"{k}={'not measured' if v is None else f'{v:.5f} ms'}" for k, v in out.items()))
    return out


def phase_online_estimator(device, nb: int = 128, seconds: int = 10, rate: float = 100.0):
    """The ported examples/online_estimator.py --fused-step
    (``slam_uwv_kalman_filters_tpu_torch/examples/online_estimator.py``): a
    seeded irregular, shuffled event stream (gyro 100 Hz, DVL 10 Hz, pressure
    20 Hz) through the port's StreamPacker one second at a time, forward-filled
    gyro, one K5 step per tick that has a DVL or pressure sample and one K2
    predict per tick that has neither, float32, with the counters zeroed just
    before and read just after. The example holds the final velocity error
    to 0.02 m/s; the real-time factor is over the seconds after the first.
    Returns the figures (with the final state) and the launches."""
    from slam_uwv_kalman_filters_tpu_torch.examples import online_estimator
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    figures = online_estimator.main(["--bank", str(nb), "--seconds", str(seconds), "--rate", str(rate),
                                     "--fused-step"])
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    log(f"online estimator: bank={nb} {rate:.0f} Hz {seconds} s float32 native_packer={figures['native_packer']} "
        f"{figures['events']} events, {figures['dropped']} dropped; steady state {figures['real_time_factor']:.3f}x "
        f"real time (first second {figures['first_second_s']:.3f} s); final velocity error "
        f"{figures['velocity_error_m_s']:.4f} m/s (limit 0.02) launches={launches}")
    return figures, launches


def phase_online_estimator_aot(device, live: dict, seconds: int = 10, rate: float = 100.0):
    """The online estimator --fused-step --aot at banks 128 and 1: every tick
    function exported (``utils.aot``), round-tripped through bytes, loaded,
    captured as a CUDA graph on its first call and replayed after. Its final
    state must equal the live run's at the same bank bit for bit (bank 128:
    ``live``, the run of ``phase_online_estimator``; bank 1: a live run made
    here). Counters zeroed just before the exported runs and read just after
    (the warm-up and capture calls; a replay moves no counter). Returns the
    figures and the launches."""
    from slam_uwv_kalman_filters_tpu_torch.examples import online_estimator
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    argv = lambda nb: ["--bank", str(nb), "--seconds", str(seconds), "--rate", str(rate), "--fused-step"]
    lives = {128: live, 1: online_estimator.main(argv(1))}
    out, launches = {}, dict.fromkeys(cuda_lib.KERNELS, 0)
    for nb in (128, 1):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        exported = online_estimator.main(argv(nb) + ["--aot"])
        wall = time.perf_counter() - t0
        bank_launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
        launches = {k: launches[k] + n for k, n in bank_launches.items()}
        leaves = lambda st: torch.utils._pytree.tree_leaves(st)
        same = all(torch.equal(a, b) for a, b in zip(leaves(exported["state"]), leaves(lives[nb]["state"])))
        # one loaded step alone: host ms a call (flatten, copies in, replay,
        # clones out) against device ms a replay (events around the replays)
        step, ls = exported["loaded"]["step_dvl"], exported["lanes"]
        rr, zv = (torch.zeros((nb, 3), dtype=torch.float32, device=device) for _ in range(2))
        step(ls, rr, zv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(200):
            step(ls, rr, zv)
        torch.cuda.synchronize()
        call_ms = 1e3 * (time.perf_counter() - t1) / 200
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            step.graph.replay()
        stop.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(stop) / 200
        out[f"bank_{nb}"] = {
            "real_time_factor_live": lives[nb]["real_time_factor"], "real_time_factor_aot": exported["real_time_factor"],
            "export_s": exported["export_s"], "artifact_bytes": exported["artifact_bytes"],
            "capture_s": exported["capture_s"], "captures": exported["captures"], "replays": exported["replays"],
            "first_second_s": exported["first_second_s"], "velocity_error_m_s": exported["velocity_error_m_s"],
            "bit_equal_to_live": same, "wall_s": wall, "step_dvl_call_ms": call_ms, "step_dvl_replay_ms": replay_ms,
        }
        log(f"online estimator --aot: bank={nb} float32 real time {exported['real_time_factor']:.3f}x (live "
            f"{lives[nb]['real_time_factor']:.3f}x); export {exported['export_s']:.2f} s, "
            f"{exported['artifact_bytes']} bytes; capture {exported['capture_s']:.3f} s; "
            f"{exported['captures']} captures, {exported['replays']} replays; final state bit-equal to the live "
            f"run: {same}; launches (warm-up and capture) {bank_launches}; one step_dvl call {call_ms:.4f} ms on "
            f"the host clock, one replay {replay_ms:.4f} ms by events")
        if not same:
            raise AssertionError(f"online estimator --aot at bank {nb}: the final state differs from the live run's")
        if exported["captures"] < 1 or exported["replays"] < int(rate) * (seconds - 1):
            raise AssertionError(f"online estimator --aot at bank {nb}: {exported['captures']} captures, "
                                 f"{exported['replays']} replays")
    return out, launches


def phase_example(name: str, argv: list):
    """One ported example (``slam_uwv_kalman_filters_tpu_torch/examples/<name>``)
    run through its ``main`` with its own checks, the counters zeroed just
    before and read just after. Returns the figures and the launches."""
    import importlib

    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    example = importlib.import_module(f"slam_uwv_kalman_filters_tpu_torch.examples.{name}")
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    figures = example.main(argv)
    torch.cuda.synchronize()
    figures["phase_s"] = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    log(f"example {name} {' '.join(argv)}: {json.dumps(figures)} launches={launches}")
    return figures, launches


def phase_velocity_bank(device, nb: int, captured: dict, counts: dict, steps: int = 30):
    """The fourth main path: bench.py's small-filter step (VelocityUKF
    predict(0.05) + DVL z = [0.3, 0, 0], R = 1e-3·I) as one K6 launch per step
    on lanes state at bank ``nb``, float32 (``velocity_fused.params_block``
    keeps the parameter block from step to step;
    ``tools/small_kernel_times.velocity_bank``): one warm step that records K6's
    operands, then ``steps`` timed steps between a zeroing and a reading of
    the counters."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.tools import small_kernel_times as skt

    bs, ls, step = skt.velocity_bank(nb, torch.float32, device)
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



# ---------------------------------------------------------------------------
# K7 (the BottomUKF step) and K8 (the banked SPD solve) and their paths
# ---------------------------------------------------------------------------


def bottom_check_operands(nb: int, dtype, device, gen: torch.Generator):
    """K7 operands at bank ``nb``: correlated covariances, velocities, normals
    tilted at random plus one 1e-3 off the pole and two at x₂ = ±1e-3 (where
    the basis changes sides), a shared symmetric Q; a range (per-instance
    beams and origins) that instance 3 fails at χ²(1) 3.841 by 500 m, and an
    S² normal observation. Returns {case: args}."""
    f64 = torch.float64
    rn = lambda *shape: torch.randn(*shape, generator=gen, dtype=f64, device=device)
    unit = lambda v: v / v.norm(dim=-1, keepdim=True)
    normals = unit(0.2 * rn(nb, 3) + torch.tensor([0.0, 0.0, 1.0], dtype=f64, device=device))
    normals[0] = unit(torch.tensor([1e-3, -2e-3, 1.0], dtype=f64, device=device))
    normals[1] = unit(torch.tensor([0.3, 0.2, 1e-3], dtype=f64, device=device))
    normals[2] = unit(torch.tensor([0.3, -0.2, -1e-3], dtype=f64, device=device))
    g = 0.1 * rn(nb, 3, 3)
    cov = g @ g.transpose(1, 2) + torch.diag(torch.tensor([0.5, 0.02, 0.02], dtype=f64, device=device))
    mu = torch.cat([12.0 + rn(nb, 1), normals], dim=1)
    to = lambda a: a.to(dtype).contiguous()
    cov_t, mu_t, vel_t = to(cov.permute(2, 1, 0)), to(mu.T), to(0.5 * rn(3, nb))
    beams = unit(rn(nb, 3) * torch.tensor([0.2, 0.2, 0.1], dtype=f64, device=device)
                 + torch.tensor([0.0, 0.0, -1.0], dtype=f64, device=device))
    origins = 0.1 * rn(nb, 3)
    # ranges near the ones the means predict: h = ((0, 0, −d) − o)·n / (dir·n)
    h = ((torch.cat([torch.zeros(nb, 2, dtype=f64, device=device), -mu[:, :1]], 1) - origins) * normals).sum(1)
    z = (h / (beams * normals).sum(1) + 0.05 * rn(nb))[None]
    z[0, 3] += 500.0
    zn = unit(normals + 0.05 * rn(nb, 3))
    eye = lambda m, v: (torch.eye(m, dtype=dtype, device=device) * v)[..., None].expand(m, m, nb).contiguous()
    qa = 0.3 * torch.randn(3, 3, generator=gen, dtype=f64, device=device)
    q9 = tuple((qa @ qa.T + torch.eye(3, dtype=f64, device=device)).reshape(9).tolist())
    base = (cov_t, mu_t, vel_t, 0.1, q9)
    rng_ops = ([to(z)], [eye(1, 0.04)], [to(beams.T)], [to(origins.T)], [3.841])
    nrm_ops = ([to(zn.T)], [eye(2, 0.01)], [None], [None], [5.991])
    return {
        "predict": ((), True, *base, [], [], [], [], []),
        "predict+range+normal": (("range", "normal"), True, *base, *(a + b for a, b in zip(rng_ops, nrm_ops))),
    }


def solve_check_operands(nb: int, dtype, device, gen: torch.Generator, ill: bool, k: int = 53):
    """K8 operands at bank ``nb``, n = 53: the ill-conditioned systems of the
    JAX package's smoother test (aaᵀ + 53·I scaled by 10^U(-5.5, 0.5)) or
    random correlated ones with variances from 1e-11 to 10; NaN in the
    unread half."""
    f64, n = torch.float64, 53
    a = torch.randn(nb, n, n, generator=gen, dtype=f64, device=device)
    u = torch.rand(n, generator=gen, dtype=f64, device=device)
    if ill:
        base, d = a @ a.transpose(1, 2) + n * torch.eye(n, dtype=f64, device=device), 10.0 ** (6.0 * u - 5.5)
    else:
        base = a @ a.transpose(1, 2) / n + torch.eye(n, dtype=f64, device=device)
        s = torch.sqrt(torch.diagonal(base, dim1=1, dim2=2))
        base, d = base / (s[:, :, None] * s[:, None, :]), torch.sqrt(10.0 ** (12.0 * u - 11.0))
    a_t = (base * d[None, :, None] * d[None, None, :]).permute(2, 1, 0)
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)[..., None]
    b_t = torch.randn(n, k, nb, generator=gen, dtype=f64, device=device)
    return torch.where(lower, float("nan"), a_t).to(dtype).contiguous(), b_t.to(dtype).contiguous()


def phase_checks_bottom_solve(device):
    """K7 and K8 against their plain versions at bank 300, float32 and
    float64: K7 predict alone and predict + [range, normal] with instance 3
    rejected by the gate; K8 on random and on
    ill-conditioned 53x53 systems with 53 right-hand sides."""
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf

    nb = 300
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(31)
        ops = bottom_check_operands(nb, dtype, device, gen)
        for label, args in ops.items():
            compare("bottom_step", f"bottom_step[{label}]", args)
        acc = bf.bottom_step_lanes_cuda(*ops["predict+range+normal"])[2][0][1][0]
        if not (acc[3] == 0.0 and int(acc.sum().item()) == nb - 1):
            raise AssertionError("K7's χ² gate did not reject exactly instance 3")
        for ill in (False, True):
            a_t, b_t = solve_check_operands(nb, dtype, device, gen, ill)
            label = f"{'ill-conditioned' if ill else 'random'} 53x53, k=53"
            compare("solve_spd", f"solve_spd[{label}]", (a_t, b_t))
            # bank-first, the right-hand side a transposed view as the smoother hands it
            rhs = b_t.permute(2, 1, 0).contiguous().transpose(1, 2)
            compare("solve_spd[bank-first]", f"solve_spd[{label}, bank-first, Bᵀ view]", (a_t.permute(2, 1, 0), rhs))


def bottom_bank(nb: int, device):
    """The BottomUKF bank's float32 (bank state, lanes state, step): bench.py's
    step, predict(0.1) + one range, one K7 launch
    (``tools/small_kernel_times.bottom_bank``)."""
    from slam_uwv_kalman_filters_tpu_torch.tools import small_kernel_times as skt

    return skt.bottom_bank(nb, torch.float32, device)


def phase_bottom_bank(device, nb: int, captured: dict, counts: dict, steps: int = 30):
    """The fifth main path: the BottomUKF bank's step (:func:`bottom_bank`,
    bench.py's) as one K7 launch per step on lanes state at bank ``nb``,
    float32: one warm step that records K7's operands, then ``steps`` timed
    steps between a zeroing and a reading of the counters."""
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    bs, ls, step = bottom_bank(nb, device)
    with capture_operands(captured, counts, keep=lambda key: key.startswith("bottom_step")):
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
    log(f"BottomUKF bank: bank={nb} float32 {steps} steps filter-steps/s={rate:.6e} seconds={seconds:.6f} "
        f"launches={launches}")
    if launches != {**_NONE, "bottom_step": steps}:
        raise AssertionError(f"BottomUKF bank launched {launches}")
    out = bf.from_lanes(ls, bs)
    unit = (out.mu.normal.norm(dim=1) - 1.0).abs().max().item()
    if not (bool(torch.isfinite(out.cov).all()) and bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all())
            and unit < 1e-5):
        raise AssertionError(f"BottomUKF bank: non-finite or non-positive covariance, or |n| − 1 = {unit:.1e}")
    return launches, rate, {k: steps for k in counts if k.startswith("bottom_step")}


# ---------------------------------------------------------------------------
# K9 and K10 (the IndirectPoseUKF's predict and marker update) and their path
# ---------------------------------------------------------------------------


def indirect_check_operands(nb: int, dtype, device, gen: torch.Generator, k: int, per_instance: bool,
                            lanes: int | None = None):
    """K9 and K10 operands at bank ``nb``: error means moved (orientation
    errors up to ~0.3 rad), random correlated covariances, pose references
    and a shared process noise with cross terms; k marker corners 3 m ahead
    seen from ref ∘ a true bias with 1 px of noise (bearings near the
    camera's axis, far from the S² equator), shared pixels and marker pose
    or per instance. ``lanes`` > nb pads in the JAX package's convention.
    Returns (K9 args, K10 args)."""
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

    f64 = torch.float64
    rn = lambda *shape: torch.randn(*shape, generator=gen, dtype=f64, device=device)
    t = lambda v: torch.tensor(v, dtype=f64, device=device)
    a = 0.1 * rn(nb, 6, 6)
    state = ipu.IndirectPoseUKFState(
        mu=ipu.PoseErrorState(0.2 * rn(nb, 3), mf.quat_exp(0.15 * rn(nb, 3))),
        cov=a @ a.transpose(1, 2) + torch.diag(t([0.05, 0.04, 0.06, 0.003, 0.002, 0.004])),
        pose_ref_position=0.5 * rn(nb, 3), pose_ref_orientation=mf.quat_exp(0.1 * rn(nb, 3)))
    _, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, device=device)
    qa = 0.01 * rn(6, 6)
    params = params._replace(process_noise=params.process_noise + qa @ qa.T)
    corners = t([[-0.15, -0.15, 0.0], [0.15, -0.15, 0.0], [0.15, 0.15, 0.0], [-0.15, 0.15, 0.0]])[:k]
    mpos, mrot = t([0.3, -0.2, 3.0]), mf.quat_exp(t([0.02, -0.05, 0.1]))
    if per_instance:
        mpos, mrot = mpos + 0.05 * rn(nb, 3), mf.so3_boxplus(mrot.expand(nb, 4), 0.02 * rn(nb, 3))
    cam_p, cam_q, cam = t([0.1, 0.0, 0.05]), mf.quat_exp(t([0.01, -0.02, 0.03])), CameraConfiguration()
    qi, pi = mf.affine_inv(*mf.affine_mul(state.pose_ref_orientation,
                                          state.pose_ref_position + t([0.1, -0.05, 0.08]), cam_q, cam_p))
    f_cam = mf.affine_apply(qi[:, None], pi[:, None], mf.affine_apply(mrot[..., None, :], mpos[..., None, :], corners))
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1) + rn(nb, k, 2)
    to = lambda tree: bank.tree_map(lambda x: x.to(dtype), tree)
    ls = ifu.to_lanes(to(state), lanes=lanes)
    _, ops = ifu.marker_operands(ls, px if per_instance else px[0], 4.0 * torch.eye(2, dtype=f64, device=device),
                                 corners, mpos, mrot, 1e-3 * torch.eye(6, dtype=f64, device=device), cam, cam_p, cam_q,
                                 nb=nb)
    return (ls.cov_t, ls.mu_t, ifu.predict_scalars(to(params), 0.1, dtype)), ops


def phase_checks_indirect(device):
    """K9 and K10 against their plain versions at bank 300, float32 and
    float64: K9 on perturbed error states; K10 with 1 and 4 corners, shared
    and per-instance pixels and marker poses. Then 28 pad lanes (to 328):
    both kernels' outputs on the bank's 300 lanes are those of the unpadded
    bank bit for bit, and the pad lanes stay finite."""
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu

    nb = 300
    for dtype in (torch.float32, torch.float64):
        for k, per_instance in ((1, False), (1, True), (4, False), (4, True)):
            gen = torch.Generator(device=device).manual_seed(41)
            k9, k10 = indirect_check_operands(nb, dtype, device, gen, k, per_instance)
            form = "per-instance" if per_instance else "shared"
            if (k, per_instance) == (1, False):
                compare("indirect_predict", "indirect_predict", k9)
            compare("indirect_markers", f"indirect_markers[k={k},{form}]", k10)
        gen = torch.Generator(device=device).manual_seed(41)
        padded = indirect_check_operands(nb, dtype, device, gen, 4, True, lanes=nb + 28)
        outs = {"predict": (ifu.indirect_predict_lanes_cuda(*k9), ifu.indirect_predict_lanes_cuda(*padded[0])),
                "markers": (ifu.indirect_markers_lanes_cuda(*k10), ifu.indirect_markers_lanes_cuda(*padded[1]))}
        torch.cuda.synchronize()
        for label, (plain_bank, pad_bank) in outs.items():
            same = all(torch.equal(a, b[..., :nb]) for a, b in zip(plain_bank, pad_bank))
            finite = all(bool(torch.isfinite(b[..., nb:]).all()) for b in pad_bank)
            log(f"check indirect_{label} pad lanes {str(dtype).split('.')[-1]}: bank unchanged={same} "
                f"pads finite={finite}")
            if not (same and finite):
                raise AssertionError(f"indirect_{label}: pad lanes changed the bank or went non-finite")


def indirect_bank(nb: int, device):
    """The IndirectPoseUKF bank's float32 (bank state, lanes state, step):
    bench.py's step, predict(0.1) + one marker corner, one K9 and one K10
    launch (``tools/small_kernel_times.indirect_bank``)."""
    from slam_uwv_kalman_filters_tpu_torch.tools import small_kernel_times as skt

    return skt.indirect_bank(nb, torch.float32, device)


def phase_small_bank_profile(device, steps: int = 30) -> dict:
    """Where the BottomUKF and IndirectPoseUKF banks' steps spend their time
    outside the kernels: ``steps`` steps of each bank (65 536, float32) after
    a warm one, under ``torch.profiler``. Per step: the host wall time, the
    device's busy time (the union of its event intervals) and idle share,
    the device events by kind (the port's kernels, PyTorch's kernels, copies
    and sets) with their time, and the host operators with the most self
    time. Measures only; returns {bank: {...}}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, make, nb in (("bottom", bottom_bank, BOTTOM_BANK), ("indirect", indirect_bank, INDIRECT_BANK)):
        _, ls, step = make(nb, device)
        ls = step(ls)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                ls = step(ls)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, cur = 0.0, None
        for s, e in sorted((e.time_range.start, e.time_range.end) for e in ev):
            if cur is None or s > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        busy += 0.0 if cur is None else cur[1] - cur[0]
        kinds = {}
        for e in ev:
            kind = ("port kernel" if "_kernel" in e.name and any(n in e.name for n in TPU_KERNELS)
                    else "copy" if "memcpy" in e.name.lower() else "set" if "memset" in e.name.lower()
                    else "PyTorch kernel")
            n, us = kinds.get(kind, (0, 0.0))
            kinds[kind] = (n + 1, us + e.time_range.end - e.time_range.start)
        host = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda a: -a.self_cpu_time_total)[:10]
        out[label] = {
            "bank": nb, "steps": steps, "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps, "idle_share": 1.0 - busy / wall_us if ev else None,
            "device_events_per_step": {k: {"count": n / steps, "ms": us / 1e3 / steps} for k, (n, us) in kinds.items()},
            "host_self_ms_per_step": {a.key: {"count": a.count / steps, "ms": a.self_cpu_time_total / 1e3 / steps}
                                      for a in host},
        }
        log(f"profile {label} bank {nb}: {json.dumps(out[label])}")
        del ls, step
    return out


def phase_indirect_bank(device, nb: int, captured: dict, counts: dict, steps: int = 30):
    """The seventh main path: the IndirectPoseUKF bank's step
    (:func:`indirect_bank`, bench.py's) as one K9 and one K10 launch per step
    on lanes state at bank ``nb``, float32: one warm step that records the
    operands, then ``steps`` timed steps between a zeroing and a reading of
    the counters."""
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    bs, ls, step = indirect_bank(nb, device)
    with capture_operands(captured, counts, keep=lambda key: key.startswith("indirect_")):
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
    log(f"IndirectPoseUKF bank: bank={nb} float32 {steps} steps filter-steps/s={rate:.6e} seconds={seconds:.6f} "
        f"launches={launches}")
    if launches != {**_NONE, "indirect_predict": steps, "indirect_markers": steps}:
        raise AssertionError(f"IndirectPoseUKF bank launched {launches}")
    out = ifu.from_lanes(ls, bs)
    unit = (out.mu.orientation_error.norm(dim=1) - 1.0).abs().max().item()
    if not (bool(torch.isfinite(out.cov).all()) and bool(torch.isfinite(out.mu.position_error).all())
            and bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all()) and unit < 1e-5):
        raise AssertionError(f"IndirectPoseUKF bank: non-finite or non-positive covariance, or |q| − 1 = {unit:.1e}")
    return launches, rate, {k: steps for k in counts if k.startswith("indirect_")}


# ---------------------------------------------------------------------------
# K11 (the PoseUKF visual-marker update) and its paths
# ---------------------------------------------------------------------------


def marker_pixels(pos, q, gen: torch.Generator, noise: float, mpos, mrot, cam_p, cam_q):
    """(..., 4, 2) pinhole pixels of the four marker corners seen from the
    body poses ``pos`` (..., 3) / ``q`` (..., 4) through the camera
    extrinsics, plus ``noise`` px of Gaussian noise drawn from ``gen``."""
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

    cam = CameraConfiguration()
    corners = torch.tensor(MARKER_CORNERS, dtype=pos.dtype, device=pos.device)
    qi, pi = mf.affine_inv(*mf.affine_mul(q, pos, cam_q, cam_p))
    f_cam = mf.affine_apply(qi[..., None, :], pi[..., None, :], mf.affine_apply(mrot[..., None, :], mpos[..., None, :],
                                                                                 corners))
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1)
    return px + noise * torch.randn(px.shape, generator=gen, dtype=px.dtype, device=px.device)


def marker_setup(dtype, device, cov: float = 1e-6, cam_p=(0.0, 0.0, 0.0)):
    """The marker of tests/test_full_mission.py 6 m ahead of the mission's
    start pose, facing back: (position, orientation, pose covariance, camera,
    camera-in-IMU position, orientation)."""
    from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return (t([6.0, 0.0, 0.0]), t(MARKER_CAM_Q), cov * torch.eye(6, dtype=dtype, device=device), CameraConfiguration(),
            t(cam_p), t(MARKER_CAM_Q))


def marker_check_operands(nb: int, dtype, device, gen: torch.Generator, k: int, per_instance: bool,
                          lanes: int | None = None):
    """K11 operands at bank ``nb``: perturbed mission states (positions moved
    by 0.5 m, orientations by ~0.15 rad, correlated covariances at half the
    initial per-field scales), k corners of the marker seen from each
    instance's own pose with 1 px of noise (bearings near the camera's axis,
    far from the S² equator), pixel covariance 4·I, a 1e-3·I pose prior,
    shared pixels and marker pose or per instance. ``lanes`` > nb pads in
    the JAX package's convention (identity covariances, copies of instance
    0)."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf

    f64 = torch.float64
    bs, _, _ = mission_setup(nb, f64, device, gen, spread=0.5)
    mpos, mrot, cov, cam, cam_p, cam_q = marker_setup(f64, device, 1e-3, (0.1, -0.05, 0.02))
    if per_instance:
        mpos = mpos + 0.05 * torch.randn(nb, 3, generator=gen, dtype=f64, device=device)
        mrot = mf.so3_boxplus(mrot.expand(nb, 4), 0.02 * torch.randn(nb, 3, generator=gen, dtype=f64, device=device))
    px = marker_pixels(bs.mu.position, bs.mu.orientation, gen, 1.0, mpos, mrot, cam_p, cam_q)[:, :k]
    ls = pf.to_lanes(bs)
    if lanes is not None:
        pad = lanes - nb
        ls = ls._replace(cov_t=torch.cat([ls.cov_t, torch.eye(53, dtype=f64, device=device)[..., None].expand(
            53, 53, pad)], -1), mu_t=torch.cat([ls.mu_t, ls.mu_t[:, :1].expand(54, pad)], -1))
    ls = ls._replace(cov_t=ls.cov_t.to(dtype).contiguous(), mu_t=ls.mu_t.to(dtype).contiguous())
    corners = torch.tensor(MARKER_CORNERS[:k], dtype=f64, device=device)
    return pmf.marker_operands(ls, px if per_instance else px[0], 4.0 * torch.eye(2, dtype=f64, device=device),
                               corners, mpos, mrot, cov, cam, cam_p, cam_q, nb=nb)[1]


def phase_checks_pose_markers(device):
    """K11 against its plain version at bank 300, float32 and float64, with 1
    and 4 corners, shared and per-instance pixels and marker poses; then 28
    pad lanes (to 328): the bank's 300 lanes are those of the unpadded bank
    bit for bit, and the pad lanes stay finite."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf

    nb = 300
    for dtype in (torch.float32, torch.float64):
        for k, per_instance in ((1, False), (1, True), (4, False), (4, True)):
            args = marker_check_operands(nb, dtype, device, torch.Generator(device=device).manual_seed(43), k,
                                         per_instance)
            compare("pose_markers", f"pose_markers[k={k},{'per-instance' if per_instance else 'shared'}]", args)
        padded = marker_check_operands(nb, dtype, device, torch.Generator(device=device).manual_seed(43), 4, True,
                                       lanes=nb + 28)
        plain_bank, pad_bank = pmf.pose_markers_lanes_cuda(*args), pmf.pose_markers_lanes_cuda(*padded)
        torch.cuda.synchronize()
        same = torch.equal(_valid(plain_bank[0]), _valid(pad_bank[0][..., :nb])) and all(
            torch.equal(a, b[..., :nb]) for a, b in zip(plain_bank[1:], pad_bank[1:]))
        finite = bool(torch.isfinite(_valid(pad_bank[0][..., nb:])).all()) and all(
            bool(torch.isfinite(b[..., nb:]).all()) for b in pad_bank[1:])
        log(f"check pose_markers pad lanes {str(dtype).split('.')[-1]}: bank unchanged={same} pads finite={finite}")
        if not (same and finite):
            raise AssertionError("pose_markers: pad lanes changed the bank or went non-finite")


def phase_marker_mission(device, nb, captured: dict, counts: dict):
    """The marker-aided mission second: the shared mission second (K2 → K3)
    plus one 4-corner marker tick at its end through
    ``pose_marker_fused.update_visual_features_lanes`` (1 Hz, one K11
    launch), bank ``nb``, float32. The marker of tests/test_full_mission.py
    6 m ahead of the start pose; each instance's pixels projected from its
    own state at the marker tick with 0.5 px of noise, covariance 0.25·I.
    A warm second records K11's operands, then a timed second runs between
    a zeroing and a reading of the counters."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

    dtype = torch.float32
    bs, params, meas = mission_setup(nb, dtype, device)
    mpos, mrot, cov, cam, cam_p, cam_q = marker_setup(dtype, device)
    gen = torch.Generator(device=device).manual_seed(47)
    corners = torch.tensor(MARKER_CORNERS, dtype=dtype, device=device)
    fcov = 0.25 * torch.eye(2, dtype=dtype, device=device).expand(4, 2, 2)
    ls = pf.to_lanes(bs)
    like = tree_map(lambda a: a[0].clone(), bs)
    del bs

    def second(ls):
        for k in range(100):
            ls = mission_tick(ls, params, meas, k)
        # the camera's detections: each instance's corners seen from its own
        # pose at the marker tick, 0.5 px of noise
        px = marker_pixels(ls.mu_t[0:3].T, ls.mu_t[3:7].T, gen, 0.5, mpos, mrot, cam_p, cam_q)
        return pmf.update_visual_features_lanes(ls, px, fcov, corners, mpos, mrot, cov, cam, cam_p, cam_q)

    with capture_operands(captured, counts, keep=lambda key: key.startswith("pose_markers")):
        ls, _ = second(ls)
    mission_counts = {key: n for key, n in counts.items() if key.startswith("pose_markers")}
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    ls, info = second(ls)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    rate = nb * 100 / seconds
    nis = info.mahalanobis2.double()
    log(f"marker-aided mission second: bank={nb} float32 ticks/s={rate:.6e} seconds={seconds:.6f} "
        f"marker NIS mean={nis.mean().item():.4f} max={nis.max().item():.4f} launches={launches}")
    if launches != MARKER_SECOND:
        raise AssertionError(f"marker-aided mission second launched {launches}, expected {MARKER_SECOND}")
    out = pf.from_lanes(ls, like)
    for name, t in (("cov", out.cov), ("mu", pf._pack_storage(out.mu)), ("marker NIS", nis)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"marker-aided mission second produced non-finite {name}")
    if not bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all()):
        raise AssertionError("marker-aided mission second produced a non-positive variance")
    return launches, rate, mission_counts


def marker_trajectory_runs(device, ticks: int, nb: int = 256):
    """The marker trajectory from perturbed mission starts (position 0.1 m,
    velocity 0.05 m/s): bench.py's mission schedule (acceleration every
    tick, DVL 5 Hz, pressure 2 Hz, ADCP 1 Hz, body efforts 10 Hz) plus a
    4-corner marker sighting every 100 ticks (0.5 px of noise) from a
    vehicle that moves at 0.3 m/s along body +x while it turns at 0.01 rad/s,
    through ``pose_driver.run_trajectory_bank_lanes`` in float32 (the
    kernels on the card) and float64 (the plain versions). Returns (worst
    |Δposition| m, worst |Δorientation| rad over every tick, the f32 run's
    launches, the two runs' marker NIS (T, B, 4), the marker flags (T,))."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as drv
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

    f64 = torch.float64
    gen = torch.Generator(device=device).manual_seed(13)
    bs64, params64, meas = mission_setup(nb, f64, device)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=f64, device=device)
    start = bs64.mu.position + 0.1 * rn(nb, 3)
    bs64 = bs64._replace(mu=bs64.mu._replace(position=start, velocity=0.05 * rn(nb, 3)))
    k = torch.arange(ticks, device=device)
    on = lambda period: (k % period == period - 1)[:, None].expand(ticks, nb)
    # the true path: yaw 0.01 rad/s, 0.3 m/s along body +x
    yaw = 0.01 * DT * k.to(f64)
    step = 0.3 * DT * torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], -1)
    pos = start[None] + (torch.cumsum(step, 0) - step)[:, None]
    q = torch.stack([torch.cos(0.5 * yaw), torch.zeros_like(yaw), torch.zeros_like(yaw), torch.sin(0.5 * yaw)], -1)
    mpos, mrot, cov, cam, cam_p, cam_q = marker_setup(f64, device)
    px = marker_pixels(pos, q[:, None].expand(ticks, nb, 4), gen, 0.5, mpos, mrot, cam_p, cam_q)
    stream = lambda key, period: dict(zip(("z", "cov", "valid"), (
        meas[key][0].expand(ticks, nb, *meas[key][0].shape[1:]),
        meas[key][1].expand(ticks, nb, *meas[key][1].shape), on(period))))
    acc, dvl, press, adcp, eff = (stream("acc", 1), stream("dvl", 20), stream("press", 50), stream("adcp", 100),
                                  stream("eff", 10))
    inputs = drv.PoseInputs(
        dt=torch.full((ticks, nb), DT, dtype=f64, device=device),
        rotation_rate=torch.tensor([0.0, 0.0, 0.01], dtype=f64, device=device).expand(ticks, nb, 3),
        acc=acc["z"], acc_cov=acc["cov"], acc_valid=acc["valid"],
        dvl=dvl["z"], dvl_cov=dvl["cov"], dvl_valid=dvl["valid"],
        pressure=press["z"], pressure_cov=press["cov"], pressure_valid=press["valid"],
        xy=None, xy_cov=None, xy_valid=None,
        adcp=adcp["z"], adcp_cov=adcp["cov"], adcp_cell_weighting=torch.full((ticks, nb), 0.5, dtype=f64, device=device),
        adcp_valid=adcp["valid"],
        efforts=eff["z"], efforts_cov=eff["cov"], efforts_valid=eff["valid"],
        marker_features=px, marker_feature_covs=0.25 * torch.eye(2, dtype=f64, device=device).expand(ticks, nb, 4, 2, 2),
        marker_valid=on(100),
    )
    consts = drv.PoseStepConstants(marker=drv.MarkerSetup(
        torch.tensor(MARKER_CORNERS, dtype=f64, device=device), mpos, mrot, cov, cam, cam_p, cam_q))
    f32 = lambda tree: tree_map(lambda a: a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a,
                                tree)
    cuda_lib.reset_launch_counts()
    _, out32 = drv.run_trajectory_bank_lanes(f32(bs64), f32(params64), f32(inputs), f32(consts))
    launches = {name: kern.launches for name, kern in cuda_lib.KERNELS.items()}
    with plain_route():
        _, out64 = drv.run_trajectory_bank_lanes(bs64, params64, inputs, consts)
    for name, out in (("f32 kernels", out32), ("f64 plain", out64)):
        if not all(bool(torch.isfinite(t).all()) for t in (out.position, out.orientation, out.cov_trace)):
            raise AssertionError(f"marker trajectory: non-finite {name} state")
        if not bool((out.cov_trace > 0).all()):
            raise AssertionError(f"marker trajectory: non-positive covariance trace in {name}")
    dpos = (out32.position.double() - out64.position).norm(dim=-1).max().item()
    dang = mf.so3_boxminus(out32.orientation.double(), out64.orientation).norm(dim=-1).max().item()
    return dpos, dang, launches, (out32.marker_nis, out64.marker_nis), on(100)[:, 0]


def phase_marker_trajectory(device, ticks: int):
    """The marker trajectory guard (:func:`marker_trajectory_runs`, bank 256):
    the float32 kernels within 3× the float32-vs-float64 drift of the plain
    path on the CPU; the marker NIS finite on the sighting ticks and 0 on
    every other tick, in both runs. Returns the float32 run's launches."""
    t0 = time.perf_counter()
    dpos, dang, launches, nis, on = marker_trajectory_runs(device, ticks)
    torch.cuda.synchronize()
    # 3x the float32 plain path's drift from its float64 one over the same
    # 1000-tick marker trajectory at bank 256 on the CPU (6.70e-3 m, 5.73e-4
    # rad, the largest over every tick: marker_trajectory_runs on CPU
    # tensors). It is ~40x the marker-free trajectory's: the first sighting
    # moves the float32 and float64 states apart by ~4e-5 m, and the
    # difference then grows between sightings with the heading difference
    limits = {"position_m": 2.0e-2, "orientation_rad": 1.7e-3}
    nis_ok = all(bool(torch.isfinite(n[on]).all()) and bool((n[on] > 0).all()) and bool((n[~on] == 0).all())
                 for n in nis)
    log(f"marker trajectory: bank=256 ticks={ticks} max|Δposition|={dpos:.3e} m (limit {limits['position_m']:.1e}) "
        f"max|Δorientation|={dang:.3e} rad (limit {limits['orientation_rad']:.1e}) marker NIS on the "
        f"{int(on.sum())} sighting ticks: f32 mean {nis[0][on].double().mean().item():.4f}, f64 mean "
        f"{nis[1][on].mean().item():.4f}, 0 elsewhere={nis_ok} wall={time.perf_counter() - t0:.1f}s "
        f"launches={launches}")
    if dpos > limits["position_m"] or dang > limits["orientation_rad"] or not nis_ok:
        raise AssertionError("the f32 marker trajectory left the f64 plain trajectory, or its marker NIS is wrong")
    if launches["pose_markers"] != int(on.sum()):
        raise AssertionError(f"marker trajectory launched {launches['pose_markers']} K11, expected {int(on.sum())}")
    return launches


def phase_smoother(device, nb: int, seconds: float, captured: dict, counts: dict):
    """The sixth main path: survey post-processing. The fleet survey of
    ``fleet_setup.build_fleet_setup`` (surface fixes every 30 s) at 50 Hz
    for ``seconds`` over a bank of ``nb`` trajectories in float32, each with
    its own start perturbation and sensor noise, through
    ``pose_smoother.run_trajectory_smoothed``: the forward pass
    (``pose_step_bank``: K2, K3) stores every posterior on the card, the
    backward pass runs K1 and K8 each tick. Counters zeroed just before and
    read just after; K1's and K8's operands of the last backward tick are
    recorded, and K3's of the forward pass. Holds the smoothed covariance
    trace to no more than the filtered one at every tick (relative slack
    1e-4) and both outputs to finite values; prints the two passes' times
    and the filtered and smoothed ATE."""
    import numpy as np

    from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup, monte_carlo
    from slam_uwv_kalman_filters_tpu_torch.models import pose_smoother as sm
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.tools.float32_drift import survey_inputs

    state, params, spec = fleet_setup.build_fleet_setup(minutes=seconds / 60.0, rate=50.0, dtype_name="f32",
                                                        device=device)
    n = spec.gyro.shape[0]
    gen = torch.Generator(device=device).manual_seed(17)
    bs = monte_carlo.perturb_initial_bank(bank.replicate(state, nb), gen, pos_sigma=0.05, vel_sigma=0.05,
                                          yaw_sigma=3e-3)
    inputs = survey_inputs(spec, nb, gen)
    if seconds < 60.0:
        log(f"survey smoother: the survey is cut to {seconds:g} s ({n} ticks) from the one-minute survey")
    marks = {}

    def backward(*args):
        torch.cuda.synchronize()
        marks["backward"] = time.perf_counter()
        return smooth_backward(*args)

    smooth_backward = sm.smooth_backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with capture_operands(captured, counts,
                          keep=lambda key: key.split("[")[0] in ("solve_spd", "sigma_deltas", "pose_update_model")), \
            patched((sm, "smooth_backward", backward)):
        out = sm.run_trajectory_smoothed(bs, params, inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    fwd, bwd = marks["backward"] - t0, t1 - marks["backward"]
    truth = spec.truth_pos.double()[:, None]
    ate = {name: torch.sqrt(((mu.position.double() - truth) ** 2).sum(-1).mean(0)).cpu().numpy()
           for name, mu in (("filtered", out.filtered_mu), ("smoothed", out.smoothed_mu))}
    ftr = torch.diagonal(out.filtered_cov, dim1=-2, dim2=-1).sum(-1)
    st = torch.diagonal(out.smoothed_cov, dim1=-2, dim2=-1).sum(-1)
    finite = all(bool(torch.isfinite(x).all()) for x in (out.filtered_cov, out.smoothed_cov,
                                                          out.filtered_mu.position, out.smoothed_mu.position))
    excess = ((st - ftr) / ftr).max().item()
    stats = {name: {"p50_m": float(np.percentile(a, 50)), "max_m": float(a.max())} for name, a in ate.items()}
    log(f"survey smoother: bank={nb} {n} ticks float32 forward={fwd:.3f} s backward={bwd:.3f} s "
        f"({1e3 * bwd / (n - 1):.3f} ms per backward tick) ATE filtered p50={stats['filtered']['p50_m']:.4f} "
        f"max={stats['filtered']['max_m']:.4f} m, smoothed p50={stats['smoothed']['p50_m']:.4f} "
        f"max={stats['smoothed']['max_m']:.4f} m; max (tr Pˢ − tr P)/tr P = {excess:.3e} (limit 1e-4) "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB launches={launches}")
    if not finite or excess > 1e-4:
        raise AssertionError(f"survey smoother: finite={finite}, smoothed trace above filtered by {excess:.3e}")
    if launches["solve_spd"] != n - 1 or launches["sigma_deltas"] < n - 1:
        raise AssertionError(f"survey smoother: expected {n - 1} K8 and K1 launches, got {launches}")
    del out, inputs
    torch.cuda.empty_cache()
    return launches, {"ticks": n, "bank": nb, "forward_s": fwd, "backward_s": bwd, "ate": stats}


# ---------------------------------------------------------------------------
# torch.func.vmap over the solo filter functions: the vmap rules of K1, K8
# and K12 (phase_vmap)
# ---------------------------------------------------------------------------

# (a) the rules at the mission bank (K1, K12) and at the smoother's bank of
# systems (K8); (b) the PoseUKF bank of vmapped solo functions, held to a CPU
# float64 run of its first instances, and the VelocityUKF bank of vmapped
# solo predicts; (c) the smoother bank whose dt differs across trajectories
VMAP_RULE_BANK = 131072
VMAP_SOLVE_SYSTEMS = 256
VMAP_POSE_BANK = 4096
VMAP_POSE_TICKS = 100
VMAP_REFERENCE = 64
VMAP_VELOCITY_BANK = 65536
VMAP_VELOCITY_STEPS = 100
VMAP_SMOOTHER_BANK = 64
VMAP_SMOOTHER_SECONDS = 10.0
# the trajectory guard's bounds (phase_trajectory): two float32 paths each
# within them of float64
VMAP_POSE_LIMITS = {"position_m": 1.0e-3, "orientation_rad": 2.6e-5}
# the smoother bank's shared-dt half, the vmapped generic passes against the
# bank form (K2, K3 forward; K1, K8 backward), both float32: 3x what the
# plain path drifts in float32 from its float64 self over the same 10-s
# survey from the same start distribution at bank 32 on the CPU
# (``tools/float32_drift.py``: 1.07e-2 m, 2.84e-5 rad), as phase_trajectory's
# bounds are set; the mission guard's bounds above are for a 100 Hz mission
# near the origin, this survey runs 50 Hz dead reckoning up to 20 m out
# after one fix
VMAP_SMOOTHER_LIMITS = {"position_m": 3.2e-2, "orientation_rad": 8.5e-5}
# the vmapped generic VelocityUKF predict against K6, both float32, after 100
# steps, as |Δ|/(1 + |ref|) of the velocity, the depth and the covariance:
# two float32 paths that round each step in another order drift apart by a
# few ε (1.19e-7) a step, so 1e-4 is 100 steps of ~8 ε (the plain path's own
# drift from float64: ``tools/float32_drift.py``; K6's is measured beside it
# in the phase)
VMAP_VELOCITY_LIMIT = 1e-4


def _launch_counts() -> dict:
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    return {k: v.launches for k, v in cuda_lib.KERNELS.items()}


def vmap_rule_checks(device, gen: torch.Generator, total: dict) -> dict:
    """(a) Each rule, bit for bit: ``torch.func.vmap`` of the solo entry
    point (``sigma_deltas_fast`` and ``cholesky_fast`` on one 53×53 matrix,
    ``solve_spd_fast`` on one 53×53 system with 53 right-hand sides, batched
    and then shared) against one banked call on the same stack; each vmapped
    call counted alone (one launch of its kernel and none other), held to
    the kernel's plain version as the checks of 1 hold the kernels, and
    timed beside the banked call. Adds the vmapped calls' launches to
    ``total``."""
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, kernels

    f32, out = torch.float32, {}
    cov = cholesky_check_operands(53, VMAP_RULE_BANK, f32, device, gen).permute(2, 1, 0).contiguous()
    a_t, b_t = solve_check_operands(VMAP_SOLVE_SYSTEMS, f32, device, gen, ill=False)
    spd, rhs = a_t.permute(2, 1, 0).contiguous(), b_t.permute(2, 0, 1).contiguous()
    shared = rhs[0]
    cases = (
        ("sigma_deltas", "K1 sigma deltas", torch.func.vmap(kernels.sigma_deltas_fast), kernels.sigma_deltas_banked,
         (cov,), (cov,)),
        ("cholesky", "K12 Cholesky", torch.func.vmap(kernels.cholesky_fast), kernels.cholesky_banked, (cov,), (cov,)),
        ("solve_spd", "K8 solve, right-hand sides batched", torch.func.vmap(kernels.solve_spd_fast),
         kernels.solve_spd_banked, (spd, rhs), (spd, rhs)),
        ("solve_spd", "K8 solve, right-hand sides shared", torch.func.vmap(kernels.solve_spd_fast, in_dims=(0, None)),
         kernels.solve_spd_banked, (spd, shared), (spd, shared.expand(VMAP_SOLVE_SYSTEMS, 53, 53))),
    )
    for name, label, vmapped, banked, args, stacked in cases:
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        got = vmapped(*args)
        torch.cuda.synchronize()
        launches = _launch_counts()
        for k, v in launches.items():
            total[k] += v
        ref = banked(*stacked)
        torch.cuda.synchronize()
        same = _bits_equal(got, ref)
        nb = stacked[0].shape[0]
        log(f"vmap rule {label}: bank {nb} float32, vmapped call bit-equal to the banked call: {same}; "
            f"launches {launches}")
        if not same or launches != {**_NONE, name: 1}:
            raise AssertionError(f"vmap rule {label}: bits equal {same}, launches {launches}")
        lifted = vmapped if len(args) == 1 or args[1].ndim == 3 else (lambda a, b: vmapped(a, b[0]))
        compare(f"{name}[bank-first]", f"{name} under vmap ({label}) at bank {nb}", stacked, kernel=lifted)
        del got, ref
        ms_v, ms_b = _time(lambda: vmapped(*args), 5), _time(lambda: banked(*stacked), 5)
        log(f"vmap rule {label}: {ms_v:.3f} ms vmapped against {ms_b:.3f} ms banked (bank {nb}, the call's wall "
            f"time from CUDA events)")
        out[label] = {"bank": nb, "bits_equal": same, "launches": launches[name], "vmapped_ms": ms_v,
                      "banked_ms": ms_b}
    del cov, spd, rhs
    torch.cuda.empty_cache()
    return out


def _pose_vmap_updates():
    """The five mission-tick updates: (stream, firing rule, the solo update,
    its extra arguments, the bank update of the same measurement)."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    return (
        ("acc", lambda k: True, pukf.update_acceleration, (), pukf.update_acceleration_bank),
        ("dvl", roofline.DVL_AT, pukf.update_velocity, (), pukf.update_velocity_bank),
        ("press", roofline.PRESS_AT, pukf.update_pressure, (), pukf.update_pressure_bank),
        ("adcp", roofline.ADCP_AT, pukf.update_water_velocity, (0.5,),
         lambda s, p, z, r, cw: pukf.update_water_velocity_bank(s, p, z, r, cw)),
        ("eff", roofline.EFF_AT, pukf.update_body_efforts, (),
         lambda s, p, z, r: pukf.update_body_efforts_bank(s, p, z, r, pukf.get_rotation_rate_bank(s, p))),
    )


def vmap_pose_bank(device, seed: int, total: dict) -> dict:
    """(b) The PoseUKF's solo functions vmapped over a bank: bench.py's
    mission schedule (acceleration every tick, DVL 5 Hz, pressure 2 Hz, ADCP
    1 Hz χ²-gated, body efforts 10 Hz) for ``VMAP_POSE_TICKS`` ticks at bank
    ``VMAP_POSE_BANK``, float32, through ``vmap_filter(pose_ukf.predict)``
    and ``masked(vmap_filter(update))`` from perturbed mission starts, each
    measurement with its own noise (its covariance's σ) and its own validity
    (90% of the instances) per firing, from the trajectory guard's starts;
    counted (one K1 launch per sigma-point draw and
    nothing else), timed against the generic bank forms on the card at the
    same bank (the fused route switched off), and its first
    ``VMAP_REFERENCE`` instances held to the same ticks through the generic
    bank forms on the CPU in float64 within the trajectory guard's bounds."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank

    nb, ticks, f64 = VMAP_POSE_BANK, VMAP_POSE_TICKS, torch.float64
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    bs64, params64, meas64 = mission_setup(nb, f64, device)
    # the trajectory guard's starts: the initial covariance, the mean moved
    # by a draw from it (position 0.1 m, velocity 0.05 m/s)
    rn = lambda *shape: torch.randn(*shape, generator=gen, dtype=f64, device=device)
    bs64 = bs64._replace(mu=bs64.mu._replace(position=bs64.mu.position + 0.1 * rn(nb, 3), velocity=0.05 * rn(nb, 3)))
    sigma = {"acc": 2e-3, "dvl": 0.03, "press": 50.0, "adcp": 0.03, "eff": 1.0}
    updates = _pose_vmap_updates()
    draws = []
    for k in range(ticks):
        tick = {}
        for key, fires, *_ in updates:
            if fires(k):
                z0 = meas64[key][0]
                tick[key] = (z0 + sigma[key] * torch.randn(z0.shape, generator=gen, dtype=f64, device=device),
                             torch.rand(nb, generator=gen, device=device) < 0.9)
        draws.append(tick)
    to = lambda tree, dtype, dev: bank.tree_map(lambda a: a.to(dev, dtype), tree)
    cov_of = {key: meas64[key][1] for key in meas64}

    def run(state, params, predict, update, sl, dtype, dev):
        for k in range(ticks):
            state = predict(state, params, DT)
            for key, fires, solo, extra, banked in updates:
                if key in draws[k]:
                    z, valid = draws[k][key]
                    state, _ = update[key](state, valid[sl].to(dev), params, z[sl].to(dev, dtype),
                                           cov_of[key].to(dev, dtype), *extra)
        return state

    vmapped = ({key: bank.masked(bank.vmap_filter(solo, data_axes=(0, None) + (None,) * len(extra)))
                for key, fires, solo, extra, banked in updates})
    banked = {key: bank.masked(fn) for key, fires, solo, extra, fn in updates}
    vpredict = bank.vmap_filter(pukf.predict, data_axes=None)
    bs32, params32 = to(bs64, torch.float32, device), to(params64, torch.float32, device)
    all_ = slice(None)
    draws_count = ticks + sum(len(t) for t in draws)
    run(bs32, params32, vpredict, vmapped, all_, torch.float32, device)  # warm
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    out32 = run(bs32, params32, vpredict, vmapped, all_, torch.float32, device)
    torch.cuda.synchronize()
    vmap_ms = 1e3 * (time.perf_counter() - t0) / ticks
    launches = _launch_counts()
    for k, v in launches.items():
        total[k] += v
    with patched((pukf, "_fused_route", lambda bs: False)):
        run(bs32, params32, pukf.predict_bank, banked, all_, torch.float32, device)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generic32 = run(bs32, params32, pukf.predict_bank, banked, all_, torch.float32, device)
        torch.cuda.synchronize()
        generic_ms = 1e3 * (time.perf_counter() - t0) / ticks
    cpu = torch.device("cpu")
    sl = slice(0, VMAP_REFERENCE)
    t0 = time.perf_counter()
    ref = run(bank.tree_map(lambda a: a[sl].to(cpu), bs64), to(params64, f64, cpu), pukf.predict_bank, banked, sl,
              f64, cpu)
    cpu_s = time.perf_counter() - t0
    mine = bank.tree_map(lambda a: a[sl].to(cpu, f64), out32)
    finite = all(bool(torch.isfinite(x).all()) for x in (out32.cov, out32.mu.position, generic32.cov))
    dpos = (mine.mu.position - ref.mu.position).norm(dim=1).max().item()
    dang = mf.so3_boxminus(mine.mu.orientation, ref.mu.orientation).norm(dim=1).max().item()
    gpos = (generic32.mu.position[sl].to(cpu, f64) - ref.mu.position).norm(dim=1).max().item()
    per_tick = launches["sigma_deltas"] / ticks
    log(f"vmap PoseUKF bank: bank {nb} float32 {ticks} ticks, vmapped solo functions {vmap_ms:.3f} ms a tick "
        f"against the generic bank forms' {generic_ms:.3f} ms ({vmap_ms / generic_ms:.2f}x); K1 launches "
        f"{launches['sigma_deltas']} ({per_tick:.2f} a tick, one per sigma-point draw: {draws_count} draws); "
        f"instances 0-{VMAP_REFERENCE - 1} against the CPU float64 bank forms ({cpu_s:.1f} s): "
        f"max|Δposition| {dpos:.3e} m (limit {VMAP_POSE_LIMITS['position_m']:.1e}), max|Δorientation| {dang:.3e} "
        f"rad (limit {VMAP_POSE_LIMITS['orientation_rad']:.1e}); the generic bank forms' {gpos:.3e} m; "
        f"launches {launches}")
    if launches != {**_NONE, "sigma_deltas": draws_count}:
        raise AssertionError(f"vmap PoseUKF bank: expected {draws_count} K1 launches and nothing else: {launches}")
    if not finite or dpos > VMAP_POSE_LIMITS["position_m"] or dang > VMAP_POSE_LIMITS["orientation_rad"]:
        raise AssertionError(f"vmap PoseUKF bank left the CPU float64 run: finite {finite}, {dpos:.3e} m, "
                             f"{dang:.3e} rad")
    return {"bank": nb, "ticks": ticks, "vmapped_ms_per_tick": vmap_ms, "generic_bank_ms_per_tick": generic_ms,
            "k1_launches": launches["sigma_deltas"], "k1_per_tick": per_tick, "sigma_draws": draws_count,
            "max_position_m": dpos, "max_orientation_rad": dang, "generic_max_position_m": gpos}


def vmap_velocity_bank(device, seed: int, total: dict) -> dict:
    """(b) The VelocityUKF's solo ``integrate_body_efforts`` and ``predict``
    vmapped over bank ``VMAP_VELOCITY_BANK`` (perturbed means, covariances,
    tracker poses; new efforts per instance each step) for
    ``VMAP_VELOCITY_STEPS`` steps of 0.05 s, float32, against
    ``velocity_ukf.predict_bank`` (K6) on the same efforts; counted (K1
    once a step) and timed beside it; both float32 paths' distance from the
    vmapped path in float64 is printed beside."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.tools import small_kernel_times as skt

    nb, steps = VMAP_VELOCITY_BANK, VMAP_VELOCITY_STEPS
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    bs, params = skt.velocity_setup(nb, torch.float32, device, gen)
    efforts = [30.0 * torch.randn(nb, 6, generator=gen, device=device) for _ in range(steps)]
    integrate = torch.func.vmap(vu.integrate_body_efforts)
    predict = bank.vmap_filter(vu.predict, data_axes=None)

    def run_vmapped(s):
        for e in efforts:
            s = predict(integrate(s, e), params, 0.05)
        return s

    def run_kernel(s):
        for e in efforts:
            s = vu.predict_bank(s._replace(body_efforts=e), params, 0.05)
        return s

    to64 = lambda tree: bank.tree_map(lambda a: a.double(), tree)
    params64 = to64(params)
    predict64 = bank.vmap_filter(vu.predict, data_axes=None)

    def run_float64(s):
        for e in efforts:
            s = predict64(integrate(s, e.double()), params64, 0.05)
        return s

    run_vmapped(bs)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    mine = run_vmapped(bs)
    torch.cuda.synchronize()
    vmap_ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = _launch_counts()
    for k, v in launches.items():
        total[k] += v
    run_kernel(bs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = run_kernel(bs)
    torch.cuda.synchronize()
    kernel_ms = 1e3 * (time.perf_counter() - t0) / steps
    f64 = run_float64(to64(bs))

    def diffs(a, b):
        return {"velocity": _rel(a.mu.velocity.double(), b.mu.velocity.double()),
                "z": _rel(a.mu.z_position.double(), b.mu.z_position.double()),
                "cov": _rel(a.cov.double(), b.cov.double())}

    d, d_vmap64, d_k6_64 = diffs(mine, ref), diffs(mine, f64), diffs(ref, f64)
    finite = bool(torch.isfinite(mine.cov).all()) and bool(torch.isfinite(mine.mu.velocity).all())
    fmt = lambda x: ", ".join(f"{k} {v:.3e}" for k, v in x.items())
    log(f"vmap VelocityUKF bank: bank {nb} float32 {steps} steps, vmapped solo predict {vmap_ms:.3f} ms a step "
        f"against predict_bank (K6) {kernel_ms:.3f} ms; |Δ|/(1 + |K6|) {fmt(d)} (limit {VMAP_VELOCITY_LIMIT:.1e}); "
        f"from the vmapped float64 path: vmapped float32 {fmt(d_vmap64)}, K6 {fmt(d_k6_64)}; launches {launches}")
    if launches != {**_NONE, "sigma_deltas": steps}:
        raise AssertionError(f"vmap VelocityUKF bank: expected {steps} K1 launches and nothing else: {launches}")
    if not finite or max(d.values()) > VMAP_VELOCITY_LIMIT:
        raise AssertionError(f"vmap VelocityUKF bank left K6: finite {finite}, {d}")
    return {"bank": nb, "steps": steps, "vmapped_ms_per_step": vmap_ms, "kernel_ms_per_step": kernel_ms,
            "rel_to_k6": d, "vmapped_rel_to_float64": d_vmap64, "k6_rel_to_float64": d_k6_64,
            "k1_launches": launches["sigma_deltas"]}


def vmap_smoother_bank(device, seed: int, total: dict) -> dict:
    """(c) The survey smoother over a bank whose dt differs across its
    trajectories: the fleet survey's schedule (``tools.float32_drift.survey_inputs``) for
    ``VMAP_SMOOTHER_SECONDS`` at 50 Hz over ``VMAP_SMOOTHER_BANK``
    trajectories, float32; the first half at dt 0.02 s, the second with a
    ±1% jitter per tick and trajectory from ``seed``, so both passes of
    ``run_trajectory_smoothed`` run vmapped over the trajectories (K1 per
    sigma-point draw, K8 once a backward tick). Holds both passes finite,
    every trajectory's mean smoothed covariance trace to no more than its
    mean filtered trace, and the first half to the shared-dt bank form's
    output for it (``pose_step_bank``, then one banked smooth step a tick)
    within ``VMAP_SMOOTHER_LIMITS``; prints both passes' seconds."""
    from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup, monte_carlo
    from slam_uwv_kalman_filters_tpu_torch.models import pose_smoother as sm
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.tools.float32_drift import survey_inputs

    nb, half = VMAP_SMOOTHER_BANK, VMAP_SMOOTHER_BANK // 2
    state, params, spec = fleet_setup.build_fleet_setup(minutes=VMAP_SMOOTHER_SECONDS / 60.0, rate=50.0,
                                                        dtype_name="f32", device=device)
    n = spec.gyro.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    bs = monte_carlo.perturb_initial_bank(bank.replicate(state, nb), gen, pos_sigma=0.05, vel_sigma=0.05,
                                          yaw_sigma=3e-3)
    inputs = survey_inputs(spec, nb, gen)
    jitter = 1.0 + 0.01 * (2.0 * torch.rand(n, nb - half, generator=gen, device=device) - 1.0)
    dt = torch.cat([inputs.dt[:, :half], inputs.dt[:, half:] * jitter], dim=1)
    inputs = inputs._replace(dt=dt)
    marks = {}
    solo_backward = sm._smooth_backward_solo

    def timed_backward(*args):
        torch.cuda.synchronize()
        marks["backward"] = time.perf_counter()
        return solo_backward(*args)

    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with patched((sm, "_smooth_backward_solo", timed_backward)):
        out = sm.run_trajectory_smoothed(bs, params, inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _launch_counts()
    for k, v in launches.items():
        total[k] += v
    fwd, bwd = marks["backward"] - t0, t1 - marks["backward"]
    streams = sum(getattr(inputs, f) is not None for f in ("acc", "dvl", "pressure", "xy", "adcp", "efforts", "z",
                                                          "gps", "delayed_xy", "marker_features"))
    expect = {**_NONE, "sigma_deltas": n * (1 + streams) + n - 1, "solve_spd": n - 1}
    finite = all(bool(torch.isfinite(x).all()) for x in (out.filtered_cov, out.smoothed_cov,
                                                          out.filtered_mu.position, out.smoothed_mu.position))
    ftr = torch.diagonal(out.filtered_cov, dim1=-2, dim2=-1).sum(-1).mean(0)
    st = torch.diagonal(out.smoothed_cov, dim1=-2, dim2=-1).sum(-1).mean(0)
    first = lambda tree: bank.tree_map(lambda a: a[:, :half], tree)
    shared_in = type(inputs)(*(None if x is None else x[:, :half] for x in inputs))
    t2 = time.perf_counter()
    ref = sm.run_trajectory_smoothed(bank.tree_map(lambda a: a[:half], bs), params, shared_in)
    torch.cuda.synchronize()
    shared_s = time.perf_counter() - t2
    diffs = {}
    for name in ("filtered", "smoothed"):
        a, b = first(getattr(out, f"{name}_mu")), getattr(ref, f"{name}_mu")
        diffs[f"{name}_position_m"] = (a.position.double() - b.position.double()).norm(dim=-1).max().item()
        diffs[f"{name}_orientation_rad"] = mf.so3_boxminus(a.orientation.double(), b.orientation.double()).norm(
            dim=-1).max().item()
    worst_pos = max(diffs["filtered_position_m"], diffs["smoothed_position_m"])
    worst_ang = max(diffs["filtered_orientation_rad"], diffs["smoothed_orientation_rad"])
    excess = ((st - ftr) / ftr).max().item()
    log(f"vmap survey smoother: bank {nb} ({half} at dt 0.02 s, {nb - half} jittered ±1%) {n} ticks float32, "
        f"vmapped forward {fwd:.3f} s, backward {bwd:.3f} s ({1e3 * fwd / n:.3f} / {1e3 * bwd / (n - 1):.3f} ms a "
        f"tick); the shared-dt half through the bank form {shared_s:.3f} s; max over trajectories of (mean tr Pˢ − "
        f"mean tr P)/mean tr P = {excess:.3e} (limit 0); shared-dt half against the bank form: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (limits {VMAP_SMOOTHER_LIMITS['position_m']:.1e} m, {VMAP_SMOOTHER_LIMITS['orientation_rad']:.1e} rad); "
        f"launches {launches}")
    if launches != expect:
        raise AssertionError(f"vmap survey smoother: expected launches {expect}, got {launches}")
    if not finite or excess > 0.0:
        raise AssertionError(f"vmap survey smoother: finite {finite}, smoothed trace above filtered by {excess:.3e}")
    if worst_pos > VMAP_SMOOTHER_LIMITS["position_m"] or worst_ang > VMAP_SMOOTHER_LIMITS["orientation_rad"]:
        raise AssertionError(f"vmap survey smoother: the shared-dt half left the bank form: {diffs}")
    del out, ref
    torch.cuda.empty_cache()
    return {"bank": nb, "ticks": n, "forward_s": fwd, "backward_s": bwd, "shared_bank_form_s": shared_s,
            "trace_excess": excess, **diffs, "k1_launches": launches["sigma_deltas"],
            "k8_launches": launches["solve_spd"]}


def phase_vmap(device, seed: int):
    """``torch.func.vmap`` over the port's solo filter functions, through the
    vmap rules of K1, K8 and K12: (a) :func:`vmap_rule_checks`, (b)
    :func:`vmap_pose_bank` and :func:`vmap_velocity_bank`, (c)
    :func:`vmap_smoother_bank`. Returns the launches of the vmapped runs
    (each counted alone, the counters zeroed just before it and read just
    after) and the figures."""
    total = dict(_NONE)
    gen = torch.Generator(device=device).manual_seed(seed)
    figures = {}
    t0 = time.perf_counter()
    figures["rules"] = vmap_rule_checks(device, gen, total)
    log(f"phase vmap (a) rules: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    figures["pose_bank"] = vmap_pose_bank(device, seed, total)
    log(f"phase vmap (b) PoseUKF bank: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    figures["velocity_bank"] = vmap_velocity_bank(device, seed, total)
    log(f"phase vmap (b) VelocityUKF bank: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    figures["smoother"] = vmap_smoother_bank(device, seed, total)
    log(f"phase vmap (c) smoother: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return total, figures


# ---------------------------------------------------------------------------
# the banked Cholesky K12, the roofline probe K13, the delayed fixes and the
# PoseUKF class
# ---------------------------------------------------------------------------


def cholesky_check_operands(n: int, nb: int, dtype, device, gen: torch.Generator):
    """(n, n, nb) SPD matrices in the lanes layout with the 53-DOF
    covariance's spread (variances 1e-11 … 10, random correlations), NaN in
    the unread upper half."""
    f64 = torch.float64
    g = torch.randn(nb, n, n, generator=gen, dtype=f64, device=device)
    base = g @ g.transpose(1, 2) / n + torch.eye(n, dtype=f64, device=device)
    s = torch.sqrt(torch.diagonal(base, dim1=1, dim2=2))
    d = torch.sqrt(10.0 ** (12.0 * torch.rand(n, generator=gen, dtype=f64, device=device) - 11.0))
    a_t = (base / (s[:, :, None] * s[:, None, :]) * d[None, :, None] * d[None, None, :]).permute(2, 1, 0)
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)[..., None]
    return torch.where(lower, float("nan"), a_t).to(dtype).contiguous()


def phase_checks_cholesky_probe(device):
    """K12 against its plain version for n = 9, 53, 55, 59, 64 at banks 1,
    127 and 300, float32 and float64 (explicit zeros above the diagonal; one
    non-SPD matrix NaN in both, whole), at n = 53 also bank-first and on a
    bank-first view; n = 65 refused. K13 against its plain version on random
    operands at the probe's size."""
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(37)
        for n in (9, 53, 55, 59, 64):
            for nb in (1, 127, 300):
                a_t = cholesky_check_operands(n, nb, dtype, device, gen)
                if nb == 127:
                    a_t[n // 2, n // 2, 5] = -1.0  # not SPD
                compare("cholesky", f"cholesky[n={n}, bank {nb}{', one non-SPD' if nb == 127 else ''}]", (a_t,))
                if nb == 127 and not bool(torch.isnan(kernels.cholesky_lanes_cuda(a_t)[..., 5]).all()):
                    raise AssertionError("K12 did not give NaN for a matrix that is not SPD")
                if n == 53 and nb > 1:  # bank-first, and a bank-first view of the lanes tensor
                    compare("cholesky[bank-first]", f"cholesky[bank-first, n={n}, bank {nb}]",
                            (a_t.permute(2, 1, 0).contiguous(),))
                    compare("cholesky[bank-first]", f"cholesky[bank-first view, n={n}, bank {nb}]",
                            (a_t.permute(2, 1, 0),))
    try:
        kernels.cholesky_banked(torch.eye(65, device=device).expand(2, 65, 65))
    except ValueError as err:
        log(f"check cholesky n=65: refused ({err})")
    else:
        raise AssertionError("K12 took n = 65")
    gen = torch.Generator(device=device).manual_seed(39)
    a = 0.75 + 0.5 * torch.rand(roofline.ELEMENTS, generator=gen, device=device)
    b = 0.9 + 0.1 * torch.rand(roofline.ELEMENTS, generator=gen, device=device)
    compare("fma_probe", f"fma_probe[{roofline.ELEMENTS} random elements]", (a, b))


def phase_cholesky_bank(ls, like, captured: dict, counts: dict):
    """The Cholesky path: ``ops.kernels.cholesky_banked`` on the covariance
    bank the shared mission second leaves (bank-first, float32), with the
    counters zeroed just before it and read just after; the factor finite,
    zero above the diagonal, positive on it."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, kernels

    cov = pf.from_lanes(ls, like).cov
    nb = cov.shape[0]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with capture_operands(captured, counts):
        L = kernels.cholesky_banked(cov)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    log(f"Cholesky bank: bank={nb} n=53 float32 seconds={seconds:.6f} (wall time of the call) launches={launches}")
    if launches != {**_NONE, "cholesky": 1}:
        raise AssertionError(f"the Cholesky bank launched {launches}, expected one K12")
    diag = torch.diagonal(L, dim1=1, dim2=2)
    if not (bool(torch.isfinite(L).all()) and bool((L.triu(1) == 0).all()) and bool((diag > 0).all())):
        raise AssertionError("the Cholesky bank's factor is not finite lower-triangular with a positive diagonal")
    del L, cov
    return launches, 1e3 * seconds


def phase_roofline(device, captured: dict, counts: dict):
    """The roofline path: ``tools.roofline.measure_fma`` (chained K13
    launches) and ``measure_hbm`` (the streaming triad), with the counters
    zeroed just before and read just after, logged beside the data sheet's
    peaks; then ``measure_mxu`` (cuBLAS float32 products, TF32 off) and
    ``count_tick_flops`` (a mission tick's matrix products on the generic
    bank path, on the CPU). Returns the launches, both rates, the K13
    milliseconds of the run at the measured rate, the matrix rate and the
    tick's count."""
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with capture_operands(captured, counts):
        fma = roofline.measure_fma(device=device)
    hbm = roofline.measure_hbm(device=device)
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    log(f"roofline: float32 FMA {fma / 1e12:.3f} TFLOP/s ({100 * fma / F32_OPS_PER_S:.1f}% of the data sheet's "
        f"{F32_OPS_PER_S / 1e12:.0f}), streaming triad {hbm / 1e12:.3f} TB/s ({100 * hbm / HBM_BYTES_PER_S:.1f}% of "
        f"{HBM_BYTES_PER_S / 1e12:.2f}) launches={launches}")
    if launches != {**_NONE, "fma_probe": counts["fma_probe"]} or counts["fma_probe"] < 2:
        raise AssertionError(f"the roofline launched {launches}")
    probe_ms = 1e3 * 2 * roofline.CHAIN * roofline.ELEMENTS * launches["fma_probe"] / fma
    mxu = roofline.measure_mxu(device=device)
    t0 = time.perf_counter()
    tick_flops = roofline.count_tick_flops()
    log(f"roofline: cuBLAS float32 4096^3 products, TF32 off, {mxu / 1e12:.3f} TFLOP/s ({100 * mxu / F32_OPS_PER_S:.1f}% "
        f"of the data sheet's {F32_OPS_PER_S / 1e12:.0f}); a mission tick's matrix products on the generic bank path "
        f"(FlopCounterMode, CPU, {time.perf_counter() - t0:.1f} s) {tick_flops:.6e} FLOP per instance")
    return launches, fma, hbm, probe_ms, mxu, tick_flops


def phase_delayed_fixes(ls, like, params, captured: dict, counts: dict):
    """The delayed fixes at the mission bank, float32: from the shared
    second's end state (bank-first), 200 states pushed at 100 Hz into
    per-instance delayed-state buffers of 256 (horizon 2 s) while each
    instance moves at its own known velocity; then a USBL-style fix 1 s late
    (the true position at that time plus 0.1 m of noise, R = 0.01·I) through
    ``update_delayed_position_buffered_bank`` (one K3: XY, χ²95) and through
    ``update_delayed_position_with_augmentation_bank`` (one K1 at n = 55,
    the delayed position's covariance 0.01·I), each timed between a zeroing
    and a reading of the counters. Returns the launches of both and the
    figures of the kernels line."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank
    from slam_uwv_kalman_filters_tpu_torch.utils import delayed_states as ds

    bs = pf.from_lanes(ls, like)
    nb, dtype, device = bs.cov.shape[0], bs.cov.dtype, bs.cov.device
    gen = torch.Generator(device=device).manual_seed(53)
    vel = 0.3 * torch.randn(nb, 3, generator=gen, dtype=dtype, device=device)
    vel[:, 2] = 0.0
    buf = bank.replicate(ds.make_buffer(256, 2, 2.0, dtype, device), nb)
    t0 = time.perf_counter()
    start = bs.mu.position
    for k in range(200):
        bs = bs._replace(mu=bs.mu._replace(position=start + vel * (DT * k)))
        buf = pukf.push_delayed_state_bank(buf, bs, ds.from_seconds(DT * (k + 1)))
    torch.cuda.synchronize()
    push_s = time.perf_counter() - t0
    now = ds.from_seconds(DT * 200)
    truth = (start + vel * (DT * 99))[:, :2]  # where each instance was 1 s before the last push
    z = truth + 0.1 * torch.randn(nb, 2, generator=gen, dtype=dtype, device=device)
    r = 0.01 * torch.eye(2, dtype=dtype, device=device)
    results = {}
    for name in ("buffered", "augmented"):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        with capture_operands(captured, counts):
            if name == "buffered":
                out, info, found = pukf.update_delayed_position_buffered_bank(bs, params, buf, now, z, r, 1.0)
            else:
                out, info = pukf.update_delayed_position_with_augmentation_bank(bs, params, z, r, truth, r)
                found = torch.ones(nb, dtype=torch.bool, device=device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
        expected = {**_NONE, "pose_update_model" if name == "buffered" else "sigma_deltas": 1}
        shares = {"found": found.double().mean().item(), "accepted": info.accepted.double().mean().item()}
        log(f"delayed fixes ({name}): bank={nb} float32 {ms:.3f} ms found={shares['found']:.4f} "
            f"accepted={shares['accepted']:.4f} NIS mean={info.mahalanobis2.double().mean().item():.4f} "
            f"launches={launches}")
        if launches != expected:
            raise AssertionError(f"the {name} delayed fix launched {launches}, expected {expected}")
        if not (bool(torch.isfinite(out.cov).all()) and bool(torch.isfinite(pf._pack_storage(out.mu)).all())
                and bool((torch.diagonal(out.cov, dim1=1, dim2=2) > 0).all())):
            raise AssertionError(f"the {name} delayed fix produced a non-finite state or a non-positive variance")
        if shares["found"] != 1.0 or shares["accepted"] < 0.9:
            raise AssertionError(f"the {name} delayed fix found or accepted too few fixes: {shares}")
        results[name] = (launches, {"ms": ms, **shares})
        del out, info
    log(f"delayed fixes: 200 pushes into 256-slot buffers {1e3 * push_s:.1f} ms")
    total = {k: results["buffered"][0][k] + results["augmented"][0][k] for k in _NONE}
    return total, {"bank": nb, "push_200_ms": 1e3 * push_s, **{k: v[1] for k, v in results.items()}}


def phase_pose_class(device, ticks: int, captured: dict, counts: dict):
    """The class path: ``tools.host_paths.class_run`` on the card in float32 with the
    counters zeroed just before and read just after and K1's operands
    recorded, per-tick p50 and p99, and its final pose against the same ticks
    through the class on the CPU in float64."""
    import numpy as np

    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.tools.host_paths import class_run

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with capture_operands(captured, counts, keep=lambda key: key.startswith("sigma_deltas")):
        pos32, q32, tick_ms, found = class_run(device, torch.float32, ticks)
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
    card_s = time.perf_counter() - t0
    pos64, q64, _, found64 = class_run("cpu", torch.float64, ticks)
    dpos = (pos32 - pos64).norm().item()
    dang = mf.so3_boxminus(q32, q64).norm().item()
    # 3x the class's own float32-vs-float64 drift over these 1000 ticks on the
    # CPU (class_run on CPU tensors: 4.36e-4 m, 1.82e-5 rad)
    limits = {"position_m": 1.31e-3, "orientation_rad": 5.5e-5}
    p50, p99 = float(np.percentile(tick_ms, 50)), float(np.percentile(tick_ms, 99))
    updates = ticks * 2 + ticks // 20 + ticks // 50 + ticks // 10 + ticks // 200
    log(f"PoseUKF class: bank=1 float32 {ticks} ticks per-tick p50={p50:.3f} ms p99={p99:.3f} ms "
        f"card run {card_s:.1f} s, |Δposition| against the CPU float64 class={dpos:.3e} m "
        f"(limit {limits['position_m']:.1e}) |Δorientation|={dang:.3e} rad (limit {limits['orientation_rad']:.1e}) "
        f"fixes found {sum(found)}/{len(found)} launches={launches} wall={time.perf_counter() - t0:.1f}s")
    if launches != {**_NONE, "sigma_deltas": updates}:
        raise AssertionError(f"the class launched {launches}, expected {updates} K1")
    if found != found64 or not all(found):
        raise AssertionError(f"the class's delayed fixes: found {found} on the card, {found64} on the CPU")
    if not (dpos <= limits["position_m"] and dang <= limits["orientation_rad"]):
        raise AssertionError("the float32 class on the card left the float64 class on the CPU")
    return launches, {"ticks": ticks, "tick_ms_p50": p50, "tick_ms_p99": p99, "card_ms": 1e3 * card_s,
                      "position_diff_m": dpos, "orientation_diff_rad": dang}


def _bits_equal(a, b) -> bool:
    """Bit-for-bit equality of two trees of tensors (dtype, shape and bytes)."""
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)) for x, y in zip(la, lb))


def phase_fleet_ops(device, nb: int = FLEET_OPS_BANK):
    """The fleet-operations layer at bank ``nb``, float32: (a) the ported
    fleet example (``examples.fleet_monte_carlo.main``, 2 timed seconds
    after a first one, then the heal of 1% poisoned instances) with the
    counters zeroed just before and read just after (301 K2, 16 K3), after
    holding its lanes-layout second to the bank-first route's bits; (b) 100
    ticks of the heal's bank-first step plain and 100 under
    ``failover.guarded`` in turns (50 plain, 50 guarded, 50 guarded, 50
    plain), and ``health_mask``, ``select_where``, ``mask_rows`` and
    ``reseed_where`` under ``torch.cuda.set_sync_debug_mode("error")``; (c)
    the bank through ``checkpoint.save`` and ``restore`` in a temporary
    directory, bit for bit, then the poisoned instances restarted from the
    restored snapshot by ``self_healing_step``; (d) a one-rank NCCL group
    (file rendezvous) whose ``ensemble_moments``, ``ensemble_mean`` and
    ``acceptance_rate`` must equal the local reductions bit for bit; (e) 5
    ticks under ``tracing.trace``, whose trace file must name K2's and K3's
    kernels, with ``Throughput``'s rate beside the host clock's. Returns
    (the launches of (a), the figures)."""
    import glob
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from slam_uwv_kalman_filters_tpu_torch.examples import fleet_monte_carlo as fleet
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank, checkpoint, failover, sharding
    from slam_uwv_kalman_filters_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    dtype, out = torch.float32, {"bank": nb}
    params_rate, dt = 100.0, 0.01
    meas_cov = torch.eye(3, dtype=dtype, device=device) * fleet.DVL_VAR
    z = torch.tensor(fleet.TRUE_VELOCITY, dtype=dtype, device=device).expand(nb, 3).contiguous()

    # the example's lanes second against the bank-first route, 3 ticks with
    # the DVL on ticks 0 and 2: the same bits
    bs, params, _ = fleet.fleet_setup(nb, params_rate, 7, device, dtype)
    lanes, _ = fleet.second_of_steps(bs, params, z, z[0], dt=dt, n_ticks=3, dvl_every=2, meas_cov=meas_cov)
    for k in range(3):
        bs = pukf.predict_bank(bs, params, dt)
        if k % 2 == 0:
            bs, _ = pukf.update_velocity_bank(bs, params, z, meas_cov)
    if not _bits_equal(lanes, bs):
        raise AssertionError("the example's lanes second differs from the bank-first route")
    del lanes, bs
    torch.cuda.empty_cache()

    # (a) the example, counted
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    figures = fleet.main(["--bank", str(nb), "--seconds", "2"])
    launches = {name: k.launches for name, k in cuda_lib.KERNELS.items()}
    a_s = time.perf_counter() - t0
    expected = {**_NONE, "pose_predict": 3 * 100 + 1, "pose_update_model": 3 * 5 + 1}
    log(f"fleet ops (a) example: bank={nb} {figures['filter_steps_per_s']:.6e} filter-steps/s over "
        f"{figures['seconds']} s ({figures['wall_s']:.3f} s; first second {figures['first_second_s']:.3f} s) "
        f"position NEES={figures['position_nees']:.4f} spread={figures['spread_m']:.4f} m worst velocity error="
        f"{figures['worst_velocity_error']:.3e} m/s restarted {figures['n_reseeded']}/{figures['n_poisoned']} "
        f"healthy after heal {figures['healthy_after_heal']}; K2 launches {launches['pose_predict']}, K3 "
        f"{launches['pose_update_model']} (expected {expected['pose_predict']}, {expected['pose_update_model']}); "
        f"{a_s:.1f} s")
    if launches != expected:
        raise AssertionError(f"the fleet example launched {launches}, expected {expected}")
    if not (figures["worst_velocity_error"] < 0.05 and figures["n_reseeded"] == nb // 100 == figures["n_poisoned"]
            and figures["healthy_after_heal"]):
        raise AssertionError(f"the fleet example's checks failed: {figures}")
    out["example"] = {**figures, "launches": {"pose_predict": launches["pose_predict"],
                                              "pose_update_model": launches["pose_update_model"]}, "phase_s": a_s}
    torch.cuda.empty_cache()

    # (b) the guard's cost, and no host read in the selects
    t0 = time.perf_counter()
    bs, params, rng = fleet.fleet_setup(nb, params_rate, 11, device, dtype)
    step = fleet.bank_step(params, dt, meas_cov)
    guarded = failover.guarded(step)
    bs, info = step(bs, z)
    bs, healthy, info = guarded(bs, z)
    plain_s = guard_s = 0.0
    for turn in ("plain", "guarded", "guarded", "plain"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(50):
            if turn == "plain":
                bs, info = step(bs, z)
            else:
                bs, healthy, info = guarded(bs, z)
        torch.cuda.synchronize()
        if turn == "plain":
            plain_s += time.perf_counter() - t1
        else:
            guard_s += time.perf_counter() - t1
    plain_ms, guard_ms = 10 * plain_s, 10 * guard_s  # per tick: 100 ticks each
    prev = step(bs, z)[0]
    donor = bank.tree_map(lambda a: a[0], prev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mask = failover.health_mask(bs, max_cov_trace=1e6)
        picked = bank.select_where(mask, bs, prev)
        scrubbed = bank.mask_rows(mask, info)
        reseeded = failover.reseed_where(bs, ~mask, donor)
        reseeded_bank = failover.reseed_where(bs, ~mask, prev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (bool(mask.all()) and _bits_equal(picked, bs) and _bits_equal(reseeded, bs)
            and _bits_equal(reseeded_bank, bs) and _bits_equal(scrubbed, info)):
        raise AssertionError("the selects on a healthy bank changed it")
    b_s = time.perf_counter() - t0
    log(f"fleet ops (b) guard: bank={nb} bank-first step (K2 + K3) {plain_ms:.3f} ms a tick plain, "
        f"{guard_ms:.3f} ms under failover.guarded (100 ticks each, in turns): overhead "
        f"{100 * (guard_ms / plain_ms - 1):+.2f}%; health_mask, select_where, mask_rows, reseed_where (single and "
        f"bank donor) ran under set_sync_debug_mode('error'): no synchronizing call; {b_s:.1f} s")
    out["guard"] = {"plain_ms_per_tick": plain_ms, "guarded_ms_per_tick": guard_ms,
                    "overhead_pct": 100 * (guard_ms / plain_ms - 1), "no_host_read": True, "phase_s": b_s}
    del picked, scrubbed, reseeded, reseeded_bank, prev, donor
    torch.cuda.empty_cache()

    # (c) checkpoint round trip, then restart the poisoned from the snapshot
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fleet_ops_")
    try:
        path = os.path.join(tmp, "bank.msgpack")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        checkpoint.save(path, bs)
        save_s = time.perf_counter() - t1
        nbytes = os.path.getsize(path)
        t1 = time.perf_counter()
        snap = checkpoint.restore(path, bs)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        leftovers = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not _bits_equal(snap, bs) or leftovers != ["bank.msgpack"]:
        raise AssertionError(f"the checkpoint round trip is not bit for bit (files {leftovers})")
    poisoned, dead_idx = fleet.poison(bs, rng)
    healed, heal_info, _ = failover.self_healing_step(step)(poisoned, snap, z)
    n_reseeded, healthy_all = int(heal_info.n_reseeded), bool(failover.health_mask(healed).all())
    dead = torch.as_tensor(dead_idx, device=device)
    if not (n_reseeded == len(dead_idx) == nb // 100 and healthy_all
            and _bits_equal(bank.tree_map(lambda a: a[dead], healed), bank.tree_map(lambda a: a[dead], snap))):
        raise AssertionError(f"the heal from the restored snapshot restarted {n_reseeded}/{len(dead_idx)}, "
                             f"healthy {healthy_all}")
    c_s = time.perf_counter() - t0
    log(f"fleet ops (c) checkpoint: bank={nb} {nbytes} bytes; save {save_s:.3f} s "
        f"({nbytes / save_s / 1e9:.3f} GB/s), restore {restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s) "
        f"onto the card, bit for bit; self_healing_step restarted {n_reseeded}/{len(dead_idx)} poisoned instances "
        f"from the restored snapshot, health all true; {c_s:.1f} s")
    out["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s, "n_reseeded": n_reseeded,
                         "phase_s": c_s}
    del snap, poisoned, healed
    torch.cuda.empty_cache()

    # (d) a one-rank NCCL group: the all_reduce path equals the local one
    t0 = time.perf_counter()
    pos, accepted = bs.mu.position, info.accepted
    local = (sharding.ensemble_moments(pos), sharding.ensemble_mean(bs.mu), sharding.acceptance_rate(accepted))
    tmp = tempfile.mkdtemp(prefix="fleet_rdzv_")
    ifname = os.environ.get("NCCL_SOCKET_IFNAME")
    os.environ["NCCL_SOCKET_IFNAME"] = "lo"  # the group's one rank talks to itself
    try:
        rank = sharding.init_multihost(f"file://{tmp}/rendezvous", 1, 0)
        backend = dist.get_backend()
        grouped = (sharding.ensemble_moments(pos), sharding.ensemble_mean(bs.mu), sharding.acceptance_rate(accepted))
        torch.cuda.synchronize()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if ifname is None:
            os.environ.pop("NCCL_SOCKET_IFNAME", None)
        else:
            os.environ["NCCL_SOCKET_IFNAME"] = ifname
        shutil.rmtree(tmp, ignore_errors=True)
    if rank != 0 or backend != "nccl" or not _bits_equal(grouped, local):
        raise AssertionError(f"the one-rank {backend} group's reductions differ from the local ones")
    d_s = time.perf_counter() - t0
    log(f"fleet ops (d) collective: one-rank {backend} group (file rendezvous): ensemble_moments, ensemble_mean "
        f"and acceptance_rate ({local[2].item():.6f}) through all_reduce equal the local reductions bit for bit; "
        f"{d_s:.1f} s")
    out["collective"] = {"backend": backend, "acceptance_rate": local[2].item(), "phase_s": d_s}

    # (e) a trace of 5 ticks
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fleet_trace_")
    try:
        tp = tracing.Throughput()
        with tracing.trace(tmp):
            tp.start(sync_on=bs)
            t1 = time.perf_counter()
            for _ in range(5):
                with tracing.annotate("fleet_tick"):
                    bs, info = step(bs, z)
            tp.add(5 * nb)
            tp_rate = tp.rate(sync_on=bs)
            host_rate = 5 * nb / (time.perf_counter() - t1)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        trace_bytes = len(text)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = {k: f"{k}_kernel" in text for k in ("pose_predict", "pose_update_model")}
    if len(files) != 1 or not all(names.values()) or "fleet_tick" not in text:
        raise AssertionError(f"the trace ({len(files)} files) does not name K2's and K3's kernels: {names}")
    e_s = time.perf_counter() - t0
    log(f"fleet ops (e) trace: 5 ticks at bank {nb}, one trace file of {trace_bytes} bytes naming "
        f"pose_predict_kernel and pose_update_model_kernel; Throughput {tp_rate:.6e} filter-steps/s, host clock "
        f"{host_rate:.6e} (both under the profiler); {e_s:.1f} s")
    out["trace"] = {"trace_bytes": trace_bytes, "throughput_rate": tp_rate, "host_rate": host_rate, "phase_s": e_s}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase fleet ops: {out['phase_s']:.1f} s")
    del bs, info, healthy
    torch.cuda.empty_cache()
    return launches, out


def phase_k3_alone(forward: dict, mission_ms: float, mission_bank: int) -> dict:
    """K3 on the card alone (:func:`_device_ms`) on the survey smoother's
    forward operands (bank 256, float32), one model at a time, beside its
    launch-weighted mean on the shared mission second's operands; each held
    to its plain version first on the same operands in float64 (in float32
    the pressure innovation of a state near its prediction sits within a few
    ulps of 1e5 Pa, ~0.02 Pa, of either version). Returns {model: ms}."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf

    out = {}
    for key, args in sorted(forward.items()):
        args64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
        compare("pose_update_model", f"{key} survey forward bank={args[1].shape[-1]}", args64)
        out[args[0]] = _device_ms(lambda: puf.update_model_lanes_cuda(*args))
    log(f"K3 alone on the survey forward's operands (bank {SMOOTHER_BANK}, float32, "
        f"{_warps('pose_update_model', torch.float32, 0, SMOOTHER_BANK)} warp a block): "
        + " ".join(f"{m}={'not measured' if v is None else f'{v:.4f} ms'}" for m, v in out.items())
        + f"; at bank {mission_bank} {mission_ms:.3f} ms (events, launch-weighted over the shared second's models)")
    return out


def phase_k1_latency(device):
    """K1 on the card alone (:func:`_device_ms`), float32, bank-first, at
    bank 1 for n = 1 … 64 and at bank 256 for n = 53: how one warp's time
    grows with n (~n²/2 column steps, n pivots, ~n² loads and (2n+1)·n
    stores) shows what holds a small bank back. Returns {"bank_<N>_n_<n>": ms}."""
    from slam_uwv_kalman_filters_tpu_torch.ops import kernels

    gen = torch.Generator(device=device).manual_seed(61)
    out = {}
    for nb, n in ((1, 1), (1, 8), (1, 16), (1, 32), (1, 53), (1, 64), (256, 53)):
        cov = cholesky_check_operands(n, nb, torch.float32, device, gen).permute(2, 1, 0).contiguous()
        out[f"bank_{nb}_n_{n}"] = _device_ms(lambda: kernels.sigma_deltas_cuda(cov))
    log("K1 on the card alone, float32, bank-first: "
        + " ".join(f"{k}={'not measured' if v is None else f'{v:.4f} ms'}" for k, v in out.items()))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--bank", type=int, default=131072, help="mission-second bank (default 131072)")
    parser.add_argument("--ticks", type=int, default=1000, help="trajectory ticks (default 1000)")
    parser.add_argument("--fleet-bank", type=int, default=1024, help="fleet ATE replay bank (default 1024)")
    parser.add_argument("--fleet-minutes", type=float, default=1.0, help="fleet ATE replay minutes (default 1)")
    parser.add_argument("--velocity-bank", type=int, default=65536, help="VelocityUKF bank (default 65536)")
    parser.add_argument("--online-seconds", type=int, default=10, help="online estimator seconds (default 10)")
    parser.add_argument("--icra-minutes", type=float, default=3.0, help="ICRA'18 example minutes (default 3)")
    parser.add_argument("--icra-smooth-minutes", type=float, default=1.0,
                        help="ICRA'18 example minutes with --smooth (default 1: the generic forward and backward "
                             "passes take ~27 ms a tick; the 0.10 m ATE bound holds from 1 minute on)")
    parser.add_argument("--full-stack-seconds", type=float, default=10.0,
                        help="four-filter example seconds at 50 Hz (default 10, cut from the example's 30, which took "
                             "71 s on an H100 80GB HBM3)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the vmap phase's draws (starts, measurement noise, validity, dt jitter)")
    parser.add_argument("--smoother-seconds", type=float, default=60.0,
                        help="survey smoother seconds at 50 Hz (default 60; 40 still spans the fixes at 0 s and "
                             "30 s)")
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
    entry = ""
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line or "stack frame" in line:
            log("ptxas: " + line.strip())
        entry = line.split("'")[1] if "Compiling entry" in line and "'" in line else entry
        if any(k in entry for k in WARP_KERNELS) and ("registers" in line or "stack frame" in line):
            log(f"ptxas warp kernel {entry}: {line.strip()}")
    from slam_uwv_kalman_filters_tpu_torch.models.pose_update_fused import MODEL_ID

    for dtype in (torch.float32, torch.float64):
        log(f"warps a block, {str(dtype).split('.')[-1]}: K12 n=53 bank {args.bank}: "
            f"{_warps('cholesky', dtype, 53, args.bank)}; K3 at bank {args.bank} / {SMOOTHER_BANK}: "
            + ", ".join(f"{model} {_warps('pose_update_model', dtype, i, args.bank)} / "
                        f"{_warps('pose_update_model', dtype, i, SMOOTHER_BANK)}" for model, i in MODEL_ID.items()))
        log(f"warps a block / resident an SM, {str(dtype).split('.')[-1]}: "
            + "; ".join(f"{name} " + ", ".join(f"bank {nb} {_warps(name, dtype, nb)} / {_resident(name, dtype, nb)}"
                                               for nb in (args.bank, 256, 128, 1))
                        for name in ("pose_predict", "pose_predict_full", "pose_step")))
        log(f"warps a block / resident an SM, {str(dtype).split('.')[-1]}: "
            + "; ".join(f"{name} " + ", ".join(f"bank {nb} {_warps(name, dtype, *sizes, nb)} / "
                                               f"{_resident(name, dtype, *sizes, nb)}"
                                               for nb in (args.bank, 256, 1))
                        for name, sizes in (("pose_markers", ()), ("pose_update_tail", (6,)))))
        log(f"warps a block / resident an SM (the design picked for the bank), {str(dtype).split('.')[-1]}: "
            + "; ".join(f"{name} " + ", ".join(f"bank {nb} {_warps(name, dtype, nb)} / {_resident(name, dtype, nb)}"
                                               for nb in (BOTTOM_BANK, 16384, 4096, 256, 1))
                        for name in ("velocity_step", "bottom_step", "indirect_predict", "indirect_markers")))

    phase_checks(device)
    phase_mean_accuracy(device)
    phase_checks_banked(device)
    phase_checks_steps(device)
    phase_checks_bottom_solve(device)
    phase_checks_indirect(device)
    t0 = time.perf_counter()
    phase_checks_pose_markers(device)
    log(f"phase pose_markers checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_checks_cholesky_probe(device)
    log(f"phase cholesky and fma_probe checks: {time.perf_counter() - t0:.1f} s")
    captured, counts, stats = {}, {}, {}
    ls, like, params, meas, shared, rate, mission_counts = phase_mission(device, args.bank, captured, counts)
    generic = phase_generic(ls, like, params, meas, captured, counts)
    times = phase_mission_shapes("mission second (shared parameters)", captured, counts, mission_counts,
                                 1e3 * args.bank * 100 / rate, stats)
    del captured
    t0 = time.perf_counter()
    captured, counts = {}, {}
    cholesky_launches, cholesky_ms = phase_cholesky_bank(ls, like, captured, counts)
    times.update(phase_mission_shapes("Cholesky bank", captured, counts, {"cholesky[bank-first]": 1}, cholesky_ms,
                                      stats))
    log(f"Cholesky bank: wall {cholesky_ms:.3f} ms for the call against K12's {times['cholesky'][0]:.3f} ms "
        f"(events, the same operands; {100 * (1 - times['cholesky'][0] / cholesky_ms):.1f}% outside the kernel, "
        f"{_warps('cholesky', torch.float32, 53, args.bank)} warps a block)")
    log(f"phase Cholesky bank: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    captured, counts = {}, {}
    delayed_launches, delayed = phase_delayed_fixes(ls, like, params, captured, counts)
    # K1 at n = 55 and K3's XY model on these operands; the table keeps the
    # mission's times of K1 and K3
    delayed["kernel_times_ms"] = {
        name: dict(zip(TIME_FIELDS, v))
        for name, v in phase_mission_shapes(
            "delayed fixes", captured, counts, {"pose_update_model[xy_position]": 1, "sigma_deltas[bank-first]": 1},
            delayed["buffered"]["ms"] + delayed["augmented"]["ms"], stats).items()}
    log(f"phase delayed fixes: {time.perf_counter() - t0:.1f} s")
    del captured
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    captured, counts = {}, {}
    probe_launches, fma, hbm, probe_ms, mxu, tick_flops = phase_roofline(device, captured, counts)
    times.update(phase_mission_shapes("roofline", captured, counts, {"fma_probe": counts["fma_probe"]}, probe_ms,
                                      stats))
    log(f"phase roofline: {time.perf_counter() - t0:.1f} s")
    del captured
    torch.cuda.empty_cache()
    idle = phase_profile(ls, params, meas)
    chain_ls = ls  # the chain's state after its two mission seconds
    del ls, like, params, meas
    captured, counts = {}, {}
    banked, rate_banked, mission_counts = phase_banked_mission(device, args.bank, captured, counts)
    times.update(phase_mission_shapes("mission second (banked parameters)", captured, counts, mission_counts,
                                      1e3 * args.bank * 100 / rate_banked, stats))
    del captured
    torch.cuda.empty_cache()
    captured, counts = {}, {}
    stepped, rate_stepped, mission_counts = phase_stepped_mission(device, args.bank, chain_ls, captured, counts)
    del chain_ls
    times.update(phase_mission_shapes("stepped mission second", captured, counts, mission_counts,
                                      1e3 * args.bank * 100 / rate_stepped, stats))
    del captured
    torch.cuda.empty_cache()
    latency, latency_launches = phase_online_latency(device)
    k2_k5_alone = phase_k2_k5_alone(device)
    op_dispatch = phase_op_dispatch(device)
    k11_k4_alone = phase_k11_k4_alone(device)
    small_alone = phase_small_alone(device)
    small_profile = phase_small_bank_profile(device)
    estimator, estimator_launches = phase_online_estimator(device, seconds=args.online_seconds)
    t0 = time.perf_counter()
    estimator_aot, estimator_aot_launches = phase_online_estimator_aot(device, estimator, seconds=args.online_seconds)
    estimator = {k: v for k, v in estimator.items() if k not in ("lanes", "state", "loaded")}
    log(f"phase online estimator --aot: {time.perf_counter() - t0:.1f} s")
    captured, counts = {}, {}
    velocity, rate_velocity, mission_counts = phase_velocity_bank(device, args.velocity_bank, captured, counts)
    times.update(phase_mission_shapes("VelocityUKF bank's 30 steps", captured, counts, mission_counts,
                                      1e3 * args.velocity_bank * 30 / rate_velocity, stats))
    del captured
    torch.cuda.empty_cache()
    captured, counts = {}, {}
    bottom, rate_bottom, mission_counts = phase_bottom_bank(device, BOTTOM_BANK, captured, counts)
    times.update(phase_mission_shapes("BottomUKF bank's 30 steps", captured, counts, mission_counts,
                                      1e3 * BOTTOM_BANK * 30 / rate_bottom, stats))
    del captured
    captured, counts = {}, {}
    indirect, rate_indirect, mission_counts = phase_indirect_bank(device, INDIRECT_BANK, captured, counts)
    times.update(phase_mission_shapes("IndirectPoseUKF bank's 30 steps", captured, counts, mission_counts,
                                      1e3 * INDIRECT_BANK * 30 / rate_indirect, stats))
    del captured
    torch.cuda.empty_cache()
    captured, counts = {}, {}
    t0 = time.perf_counter()
    marker, rate_marker, mission_counts = phase_marker_mission(device, args.bank, captured, counts)
    times.update(phase_mission_shapes("marker-aided mission second", captured, counts, mission_counts,
                                      1e3 * args.bank * 100 / rate_marker, stats))
    log(f"marker-aided mission second: {rate_marker:.6e} ticks/s against the shared second's {rate:.6e} "
        f"({100 * (rate_marker / rate - 1):+.2f}%); phase {time.perf_counter() - t0:.1f} s")
    del captured
    torch.cuda.empty_cache()
    captured, counts = {}, {}
    smoother_launches, smoother = phase_smoother(device, SMOOTHER_BANK, args.smoother_seconds, captured, counts)
    forward_k3 = {k: captured.pop(k) for k in [k for k in captured if k.startswith("pose_update_model")]}
    smoother["k3_alone_ms"] = phase_k3_alone(forward_k3, times["pose_update_model"][0], args.bank)
    del forward_k3
    # K1 and K8 on the backward pass's operands; the table keeps K1's time on
    # the mission's operands above and K8's from here
    backward = phase_mission_shapes("survey smoother's backward pass", captured, counts,
                                    {k: smoother_launches[k.split("[")[0]] for k in captured},
                                    1e3 * smoother["backward_s"], stats)
    times["solve_spd"] = backward["solve_spd"]
    for name in ("sigma_deltas", "solve_spd"):
        smoother[f"{name}_times_ms"] = dict(zip(TIME_FIELDS, backward[name]))
    del captured
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vmap_launches, vmap_figures = phase_vmap(device, args.seed)
    log(f"phase vmap: {time.perf_counter() - t0:.1f} s")
    fleet = phase_fleet_ate(device, args.fleet_bank, args.fleet_minutes)
    phase_trajectory(device, args.ticks)
    t0 = time.perf_counter()
    marker_trajectory = phase_marker_trajectory(device, args.ticks)
    log(f"phase marker trajectory: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    captured, counts = {}, {}
    class_launches, pose_class = phase_pose_class(device, args.ticks, captured, counts)
    # K1 at bank 1 on the class's operands; the table keeps the mission's time
    class_k1 = phase_mission_shapes("PoseUKF class", captured, counts,
                                    {"sigma_deltas[bank-first]": class_launches["sigma_deltas"]},
                                    pose_class["card_ms"], stats)["sigma_deltas"]
    pose_class["sigma_deltas_times_ms"] = dict(zip(TIME_FIELDS, class_k1))
    del captured
    pose_class["k1_latency_ms"] = phase_k1_latency(device)
    log(f"phase PoseUKF class: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    fleet_ops_launches, fleet_ops = phase_fleet_ops(device)
    icra, icra_launches = phase_example("icra18_mission", ["--minutes", str(args.icra_minutes)])
    icra_smooth, icra_smooth_launches = phase_example(
        "icra18_mission", ["--minutes", str(args.icra_smooth_minutes), "--smooth"])
    sweep, sweep_launches = phase_example("noise_tuning_sweep", [])
    full_stack, full_stack_launches = phase_example("full_stack_auv", ["--seconds", str(args.full_stack_seconds)])

    # launches of each main path: the counters zeroed just before it, read just after
    paths = {
        "shared_mission_second": shared, "banked_mission_second": banked, "stepped_mission_second": stepped,
        "online_latency": latency_launches, "online_estimator": estimator_launches,
        "velocity_bank": velocity, "bottom_bank": bottom, "survey_smoother": smoother_launches,
        "indirect_bank": indirect, "marker_mission_second": marker, "marker_trajectory": marker_trajectory,
        "cholesky_bank": cholesky_launches, "roofline": probe_launches, "delayed_fixes": delayed_launches,
        "pose_class": class_launches, "fleet_ops": fleet_ops_launches,
        "online_estimator_aot": estimator_aot_launches, "icra18_mission": icra_launches,
        "icra18_mission_smoothed": icra_smooth_launches,
        "noise_tuning_sweep": sweep_launches, "full_stack_auv": full_stack_launches, "vmap": vmap_launches,
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
        "k2_k5_alone_ms": k2_k5_alone, "op_dispatch": op_dispatch, "k11_k4_alone_ms": k11_k4_alone,
        "small_kernels_alone_ms": small_alone, "small_bank_profile": small_profile,
        "online_estimator": estimator, "online_estimator_aot": estimator_aot,
        "examples": {"icra18_mission": icra, "icra18_mission_smoothed": icra_smooth, "noise_tuning_sweep": sweep,
                     "full_stack_auv": full_stack},
        "measured_mxu_flops_per_s": mxu, "tick_flops_matrix_products": tick_flops,
        "velocity_filter_steps_per_s": rate_velocity,
        "velocity_bank": args.velocity_bank, "bottom_filter_steps_per_s": rate_bottom,
        "bottom_bank": BOTTOM_BANK, "indirect_filter_steps_per_s": rate_indirect, "indirect_bank": INDIRECT_BANK,
        "marker_mission_ticks_per_s": rate_marker,
        "survey_smoother": smoother, "vmap": vmap_figures,
        "measured_fma_flops_per_s": fma, "measured_hbm_bytes_per_s": hbm,
        "cholesky_bank_ms": cholesky_ms, "delayed_fixes": delayed, "pose_class": pose_class, "fleet_ops": fleet_ops,
        "dtype": "float32", "device_idle_share": idle, "fleet_ate": fleet, "card": smi,
        "wall_s": time.perf_counter() - t_start}
    log(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
