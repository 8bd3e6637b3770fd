"""The port's bank sharding over ``torch.distributed``
(``parallel/sharding.py``), on the CPU with gloo:

* the single-process path: a mesh of one, ``shard_bank`` and
  ``bank_shard_map`` as the identity placement, and the ensemble statistics
  against the JAX package's (float64; acceptance rate float32);
* a 2-process gloo group (file init): each process takes its rows of a
  bank of 8 perturbed mission states, reduces the ensemble statistics by
  ``all_reduce`` and steps its shard (the generic PoseUKF prediction); the
  statistics equal one process over the whole bank, and the shards' steps
  the whole bank's rows, float64 to 1e-12;
* ``init_multihost``'s failure handling: loud where a job asked for or
  looks like several processes, a warning and rank 0 otherwise.
"""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from slam_uwv_kalman_filters_tpu.parallel import sharding as jsh
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.parallel import bank, sharding

from torch_parity import mission_init, pt, random_bank

ROOT = Path(__file__).resolve().parents[1]
F64 = dict(rtol=1e-12, atol=1e-15)
DT = 0.01

WORKER = """
import sys
import torch
import torch.distributed as dist
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf
from slam_uwv_kalman_filters_tpu_torch.parallel import sharding

rank, tmp = int(sys.argv[1]), sys.argv[2]
assert sharding.init_multihost(f"file://{tmp}/rendezvous", 2, rank) == rank
assert sharding.init_multihost() == rank  # idempotent
mesh = sharding.make_mesh("cpu")
assert (mesh.size, mesh.rank) == (2, rank)
inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
local = sharding.shard_bank(inp["bank"], mesh)
params = inp["params"]
stepped = sharding.bank_shard_map(lambda bs: pose_ukf.predict_bank(bs, params, inp["dt"]), mesh)(local)
rows = sharding.shard_bank((inp["x"], inp["accepted"]), mesh)
out = {
    "rows": local.mu.position,
    "stepped": stepped,
    "mean": sharding.ensemble_mean(local.mu),
    "moments": sharding.ensemble_moments(rows[0]),
    "acceptance": sharding.acceptance_rate(rows[1]),
}
torch.save(out, f"{tmp}/out{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def inputs():
    state, params = mission_init()
    rng = np.random.default_rng(12)
    b = random_bank(rng, state, 8)
    x = rng.normal(size=(8, 5)) * np.arange(1, 6)
    accepted = rng.uniform(size=8) > 0.4
    return b, params, x, accepted


def close(out, ref, **tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **(tol or F64))


def test_single_process_path_and_ensemble_statistics_against_jax(inputs):
    b, params, x, accepted = inputs
    assert not dist.is_initialized()
    mesh = sharding.make_mesh("cpu")
    assert mesh == sharding.BankMesh(1, 0, torch.device("cpu"))
    tb = pt(b)
    local = sharding.shard_bank(tb, mesh)
    for a, c in zip(bank.tree_leaves(local), bank.tree_leaves(tb)):
        assert torch.equal(a, c)
    step = lambda bs: pukf.predict_bank(bs, pt(params), DT)
    out = sharding.bank_shard_map(step, mesh)(local)
    assert torch.equal(out.cov, step(tb).cov)

    jmu = jax.tree.map(jnp.asarray, b.mu)
    for got, ref in zip(sharding.ensemble_mean(tb.mu), jsh.ensemble_mean(jmu)):
        close(got, ref)
    mean, cov = sharding.ensemble_moments(torch.as_tensor(x))
    jmean, jcov = jsh.ensemble_moments(jnp.asarray(x))
    close(mean, jmean)
    close(cov, jcov)
    rate = sharding.acceptance_rate(torch.as_tensor(accepted))
    assert rate.dtype == torch.float32
    assert rate.item() == float(jsh.acceptance_rate(jnp.asarray(accepted)))


def test_mesh_refusals():
    tree = (torch.zeros(8, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="does not split evenly"):
        sharding.shard_bank(tree, sharding.BankMesh(3, 0, torch.device("cpu")))
    half = sharding.shard_bank((torch.arange(8.0),), sharding.BankMesh(2, 1, torch.device("cpu")))
    assert half[0].tolist() == [4.0, 5.0, 6.0, 7.0]
    mesh = sharding.make_mesh("cpu")
    with pytest.raises(ValueError, match="local bank size"):
        sharding.bank_shard_map(lambda a, c: a, mesh)(torch.zeros(4), torch.zeros(5))


def test_two_process_gloo_group_equals_one_process(tmp_path, inputs):
    b, params, x, accepted = inputs
    tb, tparams = pt(b), pt(params)
    torch.save({"bank": tb, "params": tparams, "x": torch.as_tensor(x), "accepted": torch.as_tensor(accepted),
                "dt": DT}, tmp_path / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in (0, 1)]

    assert torch.equal(torch.cat([o["rows"] for o in outs]), tb.mu.position)
    whole = pukf.predict_bank(tb, tparams, DT)
    for leaf, *shards in zip(bank.tree_leaves(whole), *(bank.tree_leaves(o["stepped"]) for o in outs)):
        close(torch.cat(shards), leaf)
    mean = sharding.ensemble_mean(tb.mu)
    moments = sharding.ensemble_moments(torch.as_tensor(x))
    rate = sharding.acceptance_rate(torch.as_tensor(accepted))
    for o in outs:
        for got, ref in zip(bank.tree_leaves(o["mean"]), bank.tree_leaves(mean)):
            close(got, ref)
        close(o["moments"][0], moments[0])
        close(o["moments"][1], moments[1])
        assert o["acceptance"].item() == rate.item()


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_init_multihost_failure_handling(clean_env):
    # nothing requested, one process: a warning, rank 0, no group
    with pytest.warns(RuntimeWarning, match="continuing single-process"):
        assert sharding.init_multihost() == 0
    assert not dist.is_initialized()
    # explicit arguments: a failed bootstrap raises
    with pytest.raises((ValueError, RuntimeError)):
        sharding.init_multihost(num_processes=2, process_id=0)
    # the environment says several processes: raises too
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises((ValueError, RuntimeError)):
        sharding.init_multihost()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        clean_env.setenv("WORLD_SIZE", "1")
        with pytest.raises(RuntimeWarning):
            sharding.init_multihost()
    assert not dist.is_initialized()
