"""Sharding of filter banks over processes — the counterpart of
``slam_uwv_kalman_filters_tpu/parallel/sharding.py`` on ``torch.distributed``.

The bank axis is embarrassingly parallel: each rank (one card each) holds a
contiguous block of the global bank's rows and steps it with no
communication; ranks meet only at the ensemble-statistics reductions here,
which sum local sums and counts by ``all_reduce`` when a process group is up
and reduce locally when none is. There is no filter-internal axis worth
splitting (one instance's 107×53 sigma work fits a warp), so the mesh is
1-D.

JAX's ``bank_sharding``, ``replicated`` and ``with_bank_constraint`` are
GSPMD annotations for XLA's partitioner; eager PyTorch has no partitioner to
annotate for (:func:`shard_bank` places the rows, a replicated parameter is
a whole tensor on each rank, and nothing reshards between steps), so they
are not ported.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .bank import bank_size, tree_leaves, tree_map

__all__ = [
    "BankMesh",
    "init_multihost",
    "make_mesh",
    "shard_bank",
    "bank_shard_map",
    "ensemble_mean",
    "ensemble_moments",
    "acceptance_rate",
]


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the process group — NCCL where a card is present, gloo on the
    CPU — and return this process's rank. Idempotent.

    ``coordinator_address`` is an init method (``tcp://host:port``,
    ``file:///path``) or a bare ``host:port``; without arguments the group
    comes from torchrun's environment (``env://``). A failed bootstrap
    raises when anything was passed explicitly or the environment says the
    job has several processes (``WORLD_SIZE`` > 1): going on alone there
    would leave each process computing an independent full bank, all of
    them rank 0. With nothing requested and a one-process environment it
    warns and returns 0: a single process needs no group. With NCCL, the
    process's card is ``cuda:(rank mod cards)``."""
    if _group_up():
        return dist.get_rank()
    explicit = coordinator_address is not None or num_processes is not None or process_id is not None
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=-1 if num_processes is None
                                else num_processes, rank=-1 if process_id is None else process_id)
    except (ValueError, RuntimeError):
        if explicit or _env_is_multiprocess():
            raise
        warnings.warn(
            "torch.distributed.init_process_group failed and no multi-process environment was detected; "
            "continuing single-process. Pass coordinator_address/num_processes/process_id explicitly if "
            "this IS a multi-process job.",
            RuntimeWarning,
            stacklevel=2,
        )
        return 0
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_rank()


def _env_is_multiprocess() -> bool:
    """torchrun's marker of a job of more than one process."""
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


class BankMesh(NamedTuple):
    """A 1-D bank mesh over the group's ranks, one device each: this
    process's ``rank`` of ``size`` and its ``device``."""

    size: int
    rank: int
    device: torch.device


def make_mesh(device=None) -> BankMesh:
    """The bank mesh over every rank of the process group (a mesh of one
    without a group). ``device`` is this rank's: ``None`` means its card
    (the current CUDA device, which :func:`init_multihost` sets for NCCL),
    raising without one; pass ``"cpu"`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if _group_up():
        return BankMesh(dist.get_world_size(), dist.get_rank(), dev)
    return BankMesh(1, 0, dev)


def _local_rows(nb: int, mesh: BankMesh) -> slice:
    if nb % mesh.size:
        raise ValueError(f"a bank of {nb} does not split evenly over a mesh of {mesh.size}")
    per = nb // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_bank(tree: Any, mesh: BankMesh) -> Any:
    """This rank's contiguous rows of a global bank tree (every leaf's
    leading axis the bank), copied to the rank's device."""
    rows = _local_rows(bank_size(tree), mesh)
    return tree_map(lambda a: a[rows].to(mesh.device).contiguous(), tree)


def bank_shard_map(fn: Callable, mesh: BankMesh) -> Callable:
    """Run a bank→bank step on this rank's shard, with no communication:
    the shard of :func:`shard_bank` in, this rank's rows of the result out.
    ``fn``'s inputs and outputs must all carry the bank as their leading
    axis (ensemble reductions belong outside the step); the wrapper checks
    that every input leaf is a shard of one size on the mesh's device."""

    def wrapped(*bank_args):
        leaves = tree_leaves(bank_args)
        sizes = {leaf.shape[0] for leaf in leaves}
        if len(sizes) != 1:
            raise ValueError(f"bank_shard_map: inputs disagree on the local bank size: {sorted(sizes)}")
        off = [leaf.device for leaf in leaves if leaf.device != mesh.device]
        if off:
            raise ValueError(f"bank_shard_map: an input is on {off[0]}, not on this rank's {mesh.device}")
        return fn(*bank_args)

    return wrapped


def _all_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the group's ranks (``t`` itself without a group)."""
    if _group_up():
        dist.all_reduce(t)
    return t


def _count(n: int, device) -> torch.Tensor:
    return _all_sum(torch.full((), n, dtype=torch.int64, device=device))


def ensemble_mean(tree: Any) -> Any:
    """Mean over the (global) bank axis of every leaf: local sums and the
    local count, summed over the group."""

    def mean(a):
        return _all_sum(a.sum(dim=0)) / _count(a.shape[0], a.device)

    return tree_map(mean, tree)


def ensemble_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, population covariance /N) of a (N, d) bank statistic across
    every instance of every rank, two passes (the mean, then the centred
    products)."""
    n = _count(x.shape[0], x.device)
    mean = _all_sum(x.sum(dim=0)) / n
    centered = x - mean[None]
    cov = _all_sum(centered.T @ centered) / n
    return mean, cov


def acceptance_rate(accepted: torch.Tensor) -> torch.Tensor:
    """Fraction (float32) of bank instances whose last χ²-gated update was
    applied."""
    return _all_sum(accepted.to(torch.float32).sum()) / _count(accepted.shape[0], accepted.device)
