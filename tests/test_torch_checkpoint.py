"""The port's checkpoints (``parallel/checkpoint.py``) against the JAX
package's flax msgpack format (CPU): the same bytes as flax's
``serialization.to_bytes`` for a bank of perturbed mission states with its
parameters in float32 and float64 and for a tree of every leaf kind flax
writes (numpy scalars, ints of each encoded width, floats, bools, None,
strings); a chunked leaf with ``MAX_CHUNK_SIZE`` made small in both; a
restore across the packages both ways; the atomic publish (no ``.tmp``
left behind); Orbax refused; and ``restore_sharded``'s shape check.
Equality throughout is bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from slam_uwv_kalman_filters_tpu.parallel import checkpoint as jck
from slam_uwv_kalman_filters_tpu_torch.parallel import bank, checkpoint
from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy, to_numpy

from torch_parity import mission_init, np_tree, random_bank


@pytest.fixture(scope="module")
def mission_bank():
    state, params = mission_init()
    return random_bank(np.random.default_rng(4), state, 5), params


def _port(tree, dtype):
    return from_numpy(tree, device="cpu", dtype=dtype)


def _assert_same_tree(a, b):
    la, lb = bank.tree_leaves(a), bank.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        else:
            assert x == y


def test_public_names_match_the_jax_module():
    assert set(checkpoint.__all__) == set(jck.__all__) | {"MAX_CHUNK_SIZE"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bytes_equal_flax_and_round_trip(tmp_path, mission_bank, dtype):
    b, params = mission_bank
    tree = (_port(b, dtype), _port(params, dtype))
    checkpoint.save(tmp_path / "bank.msgpack", tree)
    data = (tmp_path / "bank.msgpack").read_bytes()
    assert data == serialization.to_bytes(np_tree(to_numpy(tree)))
    assert os.listdir(tmp_path) == ["bank.msgpack"]  # published atomically, no .tmp left
    _assert_same_tree(checkpoint.restore(tmp_path / "bank.msgpack", tree), tree)


def test_every_leaf_kind_flax_writes(tmp_path):
    tree = (torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.tensor([True, False]), torch.tensor(2.5),
            np.float32(1.25), np.int64(-7), 0, 127, 128, 255, 256, 65536, 2**33, -1, -32, -33, -129, -40000,
            -(2**40), 1.5, True, None, "s" * 31, "t" * 32, "u" * 300, torch.zeros(0, 3))
    checkpoint.save(tmp_path / "x", tree)
    data = (tmp_path / "x").read_bytes()
    ref = tuple(x.numpy() if isinstance(x, torch.Tensor) else x for x in tree)
    assert data == serialization.to_bytes(ref)
    out = checkpoint.restore(tmp_path / "x", tree)
    for got, want in zip(out, tree):
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want) and got.dtype == want.dtype
        else:
            assert got == want and type(got) is type(want)


def test_chunked_leaf_equals_flax(tmp_path, mission_bank, monkeypatch):
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    b, _ = mission_bank
    tree = _port(b, torch.float32)  # cov 56 180 bytes: 57 chunks; mu.inertia 180 bytes: one piece
    checkpoint.save(tmp_path / "bank", tree)
    data = (tmp_path / "bank").read_bytes()
    assert b"__msgpack_chunked_array__" in data
    assert data == serialization.to_bytes(np_tree(to_numpy(tree)))
    _assert_same_tree(checkpoint.restore(tmp_path / "bank", tree), tree)
    back = serialization.from_bytes(np_tree(b), data)  # flax unchunks the port's file
    np.testing.assert_array_equal(back.cov, to_numpy(tree).cov)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restore_across_the_packages(tmp_path, mission_bank, dtype):
    b, _ = mission_bank
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    jtree = jax.tree.map(lambda a: np.asarray(a, np_dtype), b)
    # JAX saves, the port restores
    jck.save(tmp_path / "jax.msgpack", jtree)
    got = checkpoint.restore(tmp_path / "jax.msgpack", _port(b, dtype))
    _assert_same_tree(got, _port(jtree, dtype))
    # the port saves, JAX restores
    checkpoint.save(tmp_path / "port.msgpack", _port(jtree, dtype))
    back = jck.restore(tmp_path / "port.msgpack", jtree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)


def test_orbax_is_refused(tmp_path):
    tree = (torch.ones(3),)
    with pytest.raises(NotImplementedError, match="Not to port"):
        checkpoint.save(tmp_path / "ckpt", tree, backend="orbax")
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.restore(tmp_path / "orbax_dir", tree)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        checkpoint.save(tmp_path / "ckpt", tree, backend="zarr")


def test_restore_sharded_checks_shapes(tmp_path, mission_bank):
    b, _ = mission_bank
    tree = _port(b, torch.float64)
    checkpoint.save_sharded(tmp_path / "bank", tree)
    assert (tmp_path / "bank.shard0").exists()  # rank 0 without a process group
    _assert_same_tree(checkpoint.restore_sharded(tmp_path / "bank", tree), tree)
    wrong = bank.tree_map(lambda a: a[:3], tree)
    with pytest.raises(ValueError, match="does not match the template's local shape"):
        checkpoint.restore_sharded(tmp_path / "bank", wrong)
    with pytest.raises(ValueError, match="do not match"):
        checkpoint.restore(tmp_path / "bank.shard0", tree.mu)
