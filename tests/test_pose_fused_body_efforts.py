"""PoseUKF fused paths of the JAX package, in Pallas interpret mode on the CPU:
the model-aided body-efforts update on the lanes and in the kernel against the bank
and generic paths, and its parameter block.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_fused, pose_ukf as pukf

from pose_fused_bank import make_bank

RNG = np.random.default_rng(77)
_make_bank = functools.partial(make_bank, RNG)


@pytest.mark.time_limit(200)
def test_update_body_efforts_lanes_matches_bank():
    """update_body_efforts_lanes computes each instance's own compensated
    body rate (getRotationRate, PoseUKF.cpp:693-699) — identical to feeding
    get_rotation_rate_bank into the public per-instance efforts update."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    nb = 3
    bstate, params = _make_bank(nb)
    eff = jnp.asarray(RNG.normal(scale=0.5, size=(nb, 6)), jnp.float32)
    r_eff = jnp.eye(6, dtype=jnp.float32) * 1.0

    rr = pukf.get_rotation_rate_bank(bstate, params)
    ref, ref_info = pukf.update_body_efforts_bank(
        bstate, params, eff, r_eff, rr, use_fused="interpret"
    )

    ls = pose_fused.to_lanes(bstate)
    ls, info = puf.update_body_efforts_lanes(ls, params, eff, r_eff, interpret=True)
    out = pose_fused.from_lanes(ls, bstate)

    np.testing.assert_array_equal(np.asarray(out.cov), np.asarray(ref.cov))
    np.testing.assert_array_equal(np.asarray(out.mu.position), np.asarray(ref.mu.position))
    np.testing.assert_array_equal(
        np.asarray(info.mahalanobis2), np.asarray(ref_info.mahalanobis2)
    )


@pytest.mark.time_limit(210)
def test_body_efforts_in_kernel_model_matches_generic():
    """The in-kernel Fossen inverse-dynamics model (FUSED_MODELS
    ["body_efforts"]: per-sigma-point (x,y,psi) inertia/damping substitution,
    coriolis, quadratic damping, restoring term, per-instance body rates on
    the aux lanes) matches the generic deltas -> XLA-h -> fused-tail route at
    f32 roundoff, through both public dispatchers."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    nb = 3
    bstate, params = _make_bank(nb)
    eff = jnp.asarray(RNG.normal(scale=0.5, size=(nb, 6)), jnp.float32)
    r_eff = jnp.eye(6, dtype=jnp.float32) * 1.0
    rr = pukf.get_rotation_rate_bank(bstate, params)

    ref, ref_info = puf.update_fused_banked(
        bstate, params, eff, r_eff,
        lambda chi, rr_one: pukf._efforts_measurement(chi, params, rr_one),
        pukf._EFFORTS_DEPS, h_aux=rr, interpret=True,
    )

    # public bank dispatcher (per-instance rr + shared params -> in-kernel)
    out, info = pukf.update_body_efforts_bank(
        bstate, params, eff, r_eff, rr, use_fused="interpret"
    )
    np.testing.assert_allclose(
        np.asarray(out.cov), np.asarray(ref.cov), rtol=5e-3, atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.mu.position), np.asarray(ref.mu.position), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(info.innovation), np.asarray(ref_info.innovation),
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(info.accepted), np.asarray(ref_info.accepted)
    )

    # lanes dispatcher computes its own per-instance getRotationRate and
    # takes the same in-kernel route
    ls = pose_fused.to_lanes(bstate)
    ls, linfo = puf.update_body_efforts_lanes(ls, params, eff, r_eff, interpret=True)
    lout = pose_fused.from_lanes(ls, bstate)
    np.testing.assert_array_equal(np.asarray(lout.cov), np.asarray(out.cov))
    np.testing.assert_array_equal(
        np.asarray(linfo.mahalanobis2), np.asarray(info.mahalanobis2)
    )


def test_body_efforts_model_requires_param_block():
    """The in-kernel body_efforts model validates its shared-parameter SMEM
    block up front (a clear error instead of a kernel-trace failure)."""
    import pytest
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    bstate, params = _make_bank(2)
    ls = pose_fused.to_lanes(bstate)
    z = jnp.zeros((2, 6), jnp.float32)
    r = jnp.eye(6, dtype=jnp.float32)
    with pytest.raises(ValueError, match="model-parameter block"):
        puf.update_model_lanes("body_efforts", ls, z, r, interpret=True)

