"""The port's failure detection and elastic recovery (``parallel/failover.py``)
and the rest of its bank helpers (``bank_size``, ``masked``).

The seven tests of tests/test_failover.py, mirrored on the port's PoseUKF
bank (CPU, float64; the checkpoint snapshot through the port's
``parallel.checkpoint``); then ``health_mask``, ``guarded``,
``reseed_where``, ``self_healing_step``, ``masked`` and ``bank_size``
against the JAX package's on a bank of 8 perturbed mission states, with a
step that is the same elementwise arithmetic in both packages (so both give
the same bits): equal masks and equal states, bit for bit.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.ops.ukf import UpdateInfo as JUpdateInfo
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu.parallel import failover as jfo
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.ops.ukf import UpdateInfo
from slam_uwv_kalman_filters_tpu_torch.parallel import bank, checkpoint, failover
from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config
from slam_uwv_kalman_filters_tpu_torch.utils.convert import to_numpy

from torch_parity import jx, mission_init, np_tree, pt, random_bank

CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters(device="cpu")
F64 = torch.float64


def pose_filter():
    return pukf.init_from_pose(
        torch.zeros(3, dtype=F64), torch.eye(3, dtype=F64) * 0.01, mf.quat_identity(device="cpu"),
        torch.eye(3, dtype=F64) * 1e-4, CFG, MODEL, device="cpu",
    )


def corrupt(bstate, *, nan_at=(), neg_var_at=(), blowup_at=()):
    cov = bstate.cov.clone()
    vel = bstate.mu.velocity.clone()
    for i in nan_at:
        vel[i, 0] = float("nan")
    for i in neg_var_at:
        cov[i, 5, 5] = -1e-6
    for i in blowup_at:
        cov[i] *= 1e9
    return bstate._replace(mu=bstate.mu._replace(velocity=vel), cov=cov)


def velocity_step(params):
    def step(bs, z):
        bs = pukf.predict_bank(bs, params, 0.01)
        return pukf.update_velocity_bank(bs, params, z, torch.eye(3, dtype=F64) * 1e-3)

    return step


def test_public_names_match_the_jax_modules():
    assert set(failover.__all__) == set(jfo.__all__) | {"SelfHealInfo"}
    assert set(jbank.__all__) <= set(bank.__all__)  # vmap_filter too, on torch.func.vmap


def test_health_mask_detects_nan_negvar_blowup():
    state, _ = pose_filter()
    b = corrupt(bank.replicate(state, 6), nan_at=(1,), neg_var_at=(3,), blowup_at=(4,))
    np.testing.assert_array_equal(failover.health_mask(b).numpy(), [True, False, True, False, True, True])
    # the blow-up only trips the optional trace cap
    mask_cap = failover.health_mask(b, max_cov_trace=1e6).numpy()
    np.testing.assert_array_equal(mask_cap, [True, False, True, False, False, True])
    assert bool(failover.instance_health(state)) and not bool(failover.instance_health(bank.tree_map(
        lambda a: a[1], b)))


def test_guarded_step_rolls_back_only_dead_instances():
    state, params = pose_filter()
    n = 4
    bstate = bank.replicate(state, n)
    step = velocity_step(params)
    z = torch.tensor([0.3, 0.0, 0.0], dtype=F64).repeat(n, 1)
    z[2, 0] = float("nan")  # instance 2 receives a NaN measurement → NaN state

    out_raw, _ = step(bstate, z)
    assert not torch.isfinite(out_raw.mu.velocity[2]).all()

    out, healthy, info = failover.guarded(step)(bstate, z)
    np.testing.assert_array_equal(healthy.numpy(), [True, True, False, True])
    # the dead instance froze at its pre-step state
    assert torch.equal(out.cov[2], bstate.cov[2]) and torch.equal(out.mu.velocity[2], bstate.mu.velocity[2])
    # healthy instances are bit-identical to the unguarded step
    for i in (0, 1, 3):
        assert torch.equal(out.cov[i], out_raw.cov[i])
    assert not bool(info.accepted[2]) and float(info.mahalanobis2[2]) == 0.0


def test_reseed_where_single_donor_and_bank_donor():
    state, _ = pose_filter()
    b = corrupt(bank.replicate(state, 4), nan_at=(1, 3))
    dead = ~failover.health_mask(b)

    # single-instance donor (construct-from-state resume semantics)
    healed = failover.reseed_where(b, dead, state)
    assert bool(failover.health_mask(healed).all())
    assert torch.equal(healed.mu.velocity[1], state.mu.velocity)
    # untouched instances keep their values
    assert torch.equal(healed.cov[0], b.cov[0])

    # bank-snapshot donor (checkpoint-based restart)
    snap = bank.replicate(state, 4)
    snap = snap._replace(mu=snap.mu._replace(position=snap.mu.position + 7.0))
    healed2 = failover.reseed_where(b, dead, snap)
    assert torch.equal(healed2.mu.position[3], snap.mu.position[3])
    assert torch.equal(healed2.mu.position[0], b.mu.position[0])


def test_self_healing_step_with_checkpoint_snapshot(tmp_path):
    """Save a healthy snapshot, poison a later step, and watch the dead
    instance restart from the restored snapshot."""
    state, params = pose_filter()
    n = 3
    bstate = bank.replicate(state, n)

    checkpoint.save(tmp_path / "bank.msgpack", bstate)
    snapshot = checkpoint.restore(tmp_path / "bank.msgpack", bstate)

    healing = failover.self_healing_step(velocity_step(params))
    z = torch.tensor([0.3, 0.0, 0.0], dtype=F64).repeat(n, 1)

    bstate2, info, _ = healing(bstate, snapshot, z)
    assert info.n_reseeded.dtype == torch.int32 and int(info.n_reseeded) == 0

    z_bad = z.clone()
    z_bad[1] = float("nan")
    bstate3, info, _ = healing(bstate2, snapshot, z_bad)
    assert int(info.n_reseeded) == 1
    np.testing.assert_array_equal(info.healthy.numpy(), [True, False, True])
    assert bool(failover.health_mask(bstate3).all())
    # the restarted instance is exactly the snapshot
    assert torch.equal(bstate3.cov[1], snapshot.cov[1])
    # survivors kept stepping
    assert float(torch.linalg.norm(bstate3.mu.velocity[0])) > 0.0


def test_guarded_accepts_bare_state_step():
    """A step returning a bare filter state (a NamedTuple, which IS a tuple)
    must not be mistaken for a (state, aux) pair."""
    state, params = pose_filter()
    bstate = bank.replicate(state, 2)
    out, healthy = failover.guarded(lambda bs: pukf.predict_bank(bs, params, 0.01))(bstate)
    np.testing.assert_array_equal(healthy.numpy(), [True, True])
    assert out.cov.shape == (2, 53, 53)
    # the same contract in bank.masked
    masked_out = bank.masked(lambda bs: pukf.predict_bank(bs, params, 0.01))(bstate, torch.tensor([True, False]))
    assert torch.equal(masked_out.cov[1], bstate.cov[1])
    assert float((masked_out.cov[0] - bstate.cov[0]).abs().max()) > 0.0


def test_guarded_scrubs_aux_rows_of_dead_instances():
    """aux of a rolled-back instance must not leak the diverged step's NaN
    telemetry (numbers → 0, booleans → False)."""

    class TinyState(NamedTuple):
        mu: torch.Tensor  # (B, 2)
        cov: torch.Tensor  # (B, 2, 2)

    bs0 = TinyState(mu=torch.zeros(3, 2, dtype=F64), cov=torch.eye(2, dtype=F64).repeat(3, 1, 1))

    def step(bs):
        mu = bs.mu.clone()
        mu[1] = float("nan")  # instance 1 diverges: NaN state, NaN metric, accepted=True
        return bs._replace(mu=mu), (torch.tensor([1.0, float("nan"), 3.0]), torch.tensor([True, True, True]))

    out, healthy, (metric, accepted) = failover.guarded(step)(bs0)
    np.testing.assert_array_equal(healthy.numpy(), [True, False, True])
    np.testing.assert_allclose(metric.numpy(), [1.0, 0.0, 3.0])
    np.testing.assert_array_equal(accepted.numpy(), [True, False, True])
    assert torch.isfinite(out.mu).all()

    def step2(bs):  # a scalar (non-banked) aux leaf passes through untouched
        mu = bs.mu.clone()
        mu[0] = float("nan")
        return bs._replace(mu=mu), torch.tensor(7.0)

    _, _, aux2 = failover.guarded(step2)(bs0)
    assert float(aux2) == 7.0


def test_masked_update_scrubs_info_of_invalid_instances():
    """bank.masked masks the info record too: a discarded update's accepted
    flag and NaN NIS must not surface."""

    def update(state, z):
        info = UpdateInfo(
            mahalanobis2=torch.tensor([0.5, float("nan")]),
            accepted=torch.tensor([True, True]),
            innovation=torch.full((2, 3), float("nan")),
        )
        return state + z, info

    out, info = bank.masked(update)(torch.zeros(2, 4), torch.tensor([True, False]), torch.ones(2, 4))
    np.testing.assert_allclose(out[1].numpy(), 0.0)  # state rolled back
    np.testing.assert_allclose(out[0].numpy(), 1.0)
    assert not bool(info.accepted[1]) and bool(info.accepted[0])
    assert float(info.mahalanobis2[1]) == 0.0
    assert torch.isfinite(info.innovation[1]).all()


# ---------------------------------------------------------------------------
# against the JAX package, a bank of 8 PoseUKFStates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bank8():
    state, _ = mission_init()
    b = random_bank(np.random.default_rng(8), state, 8)
    cov, vel = b.cov.copy(), b.mu.velocity.copy()
    vel[1, 0] = np.nan
    cov[3, 5, 5] = -1e-6
    cov[4] *= 1e9
    return state, b._replace(mu=b.mu._replace(velocity=vel), cov=cov)


def _equal(port_tree, ref_tree):
    """Bit-for-bit equality of a port tree and a JAX tree (NaN equal to NaN)."""
    for a, b in zip(bank.tree_leaves(to_numpy(port_tree)), bank.tree_leaves(np_tree(ref_tree))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t_step(bs, z):
    vel = bs.mu.velocity + z
    info = UpdateInfo(mahalanobis2=(z * z).sum(-1), accepted=torch.isfinite(z).all(-1), innovation=z * 2.0)
    return bs._replace(mu=bs.mu._replace(velocity=vel), cov=bs.cov * 1.5), info


def _j_step(bs, z):
    vel = bs.mu.velocity + z
    info = JUpdateInfo(mahalanobis2=(z * z).sum(-1), accepted=jnp.isfinite(z).all(-1), innovation=z * 2.0)
    return bs._replace(mu=bs.mu._replace(velocity=vel), cov=bs.cov * 1.5), info


def _z8():
    z = np.random.default_rng(3).normal(size=(8, 3))
    z[6, 2] = np.nan
    return z


def test_health_mask_equals_jax(bank8):
    _, b = bank8
    for cap in (None, 1e6):
        ref = np.asarray(jfo.health_mask(jx(b), max_cov_trace=cap))
        np.testing.assert_array_equal(failover.health_mask(pt(b), max_cov_trace=cap).numpy(), ref)
    assert bank.bank_size(pt(b)) == jbank.bank_size(jx(b)) == 8


def test_guarded_and_masked_equal_jax(bank8):
    _, b = bank8
    z = _z8()
    out, healthy, info = failover.guarded(_t_step)(pt(b), torch.as_tensor(z))
    jout, jhealthy, jinfo = jfo.guarded(_j_step)(jx(b), jnp.asarray(z))
    np.testing.assert_array_equal(healthy.numpy(), np.asarray(jhealthy))
    _equal(out, jout)
    _equal(info, jinfo)
    valid = np.array([True, False, True, True, False, True, True, True])
    mout, minfo = bank.masked(_t_step)(pt(b), torch.as_tensor(valid), torch.as_tensor(z))
    jmout, jminfo = jbank.masked(_j_step)(jx(b), jnp.asarray(valid), jnp.asarray(z))
    _equal(mout, jmout)
    _equal(minfo, jminfo)


def test_reseed_and_self_healing_equal_jax(bank8):
    state, b = bank8
    dead = ~np.asarray(jfo.health_mask(jx(b)))
    snap = random_bank(np.random.default_rng(9), state, 8)
    for donor in (state, snap):
        _equal(failover.reseed_where(pt(b), torch.as_tensor(dead), pt(donor)),
               jfo.reseed_where(jx(b), jnp.asarray(dead), jx(donor)))
    z = _z8()
    out, info, aux = failover.self_healing_step(_t_step)(pt(b), pt(snap), torch.as_tensor(z))
    jout, jinfo, jaux = jfo.self_healing_step(_j_step)(jx(b), jx(snap), jnp.asarray(z))
    _equal(out, jout)
    _equal(aux, jaux)
    np.testing.assert_array_equal(info.healthy.numpy(), np.asarray(jinfo.healthy))
    assert info.n_reseeded.dtype == torch.int32 and int(info.n_reseeded) == int(jinfo.n_reseeded) == 3
