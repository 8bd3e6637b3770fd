"""Failure detection and elastic recovery for filter banks — the
counterpart of ``slam_uwv_kalman_filters_tpu/parallel/failover.py``.

After every step a bank is checked per instance (NaN/Inf anywhere in the
state, non-positive variances, optionally a covariance trace cap); instances
that diverged during the step roll back by a masked select, and dead ones
restart from a healthy snapshot (a single state or a bank saved by
``parallel.checkpoint``). Every decision is a select on the bank's device:
nothing here reads a tensor to the host, so a bank never branches and a step
never waits for the card.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .bank import mask_rows, select_where, tree_leaves, tree_map

__all__ = [
    "instance_health",
    "health_mask",
    "guarded",
    "reseed_where",
    "SelfHealInfo",
    "self_healing_step",
]


def health_mask(bank_state: Any, *, max_cov_trace: Optional[float] = None) -> torch.Tensor:
    """(B,) bool: is each instance of a bank (leading-axis) state
    numerically alive? Every leaf finite over its non-bank axes, the
    covariance diagonal positive (a symptom of the float32 cancellation
    failure otherwise), and the covariance trace at most ``max_cov_trace``
    where one is given (a slow divergence that never NaNs). ``bank_state``
    is any filter state NamedTuple (all carry ``.cov``)."""
    cov = bank_state.cov
    nb = cov.shape[0]
    ok = torch.ones(nb, dtype=torch.bool, device=cov.device)
    for leaf in tree_leaves(bank_state):
        ok = ok & torch.isfinite(leaf).reshape(nb, -1).all(dim=1)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    ok = ok & (diag > 0).all(dim=-1)
    if max_cov_trace is not None:
        ok = ok & (diag.sum(-1) <= max_cov_trace)
    return ok


def instance_health(state: Any, *, max_cov_trace: Optional[float] = None) -> torch.Tensor:
    """Scalar bool :func:`health_mask` of one filter instance."""
    return health_mask(tree_map(lambda a: a[None], state), max_cov_trace=max_cov_trace)[0]


def guarded(step_fn: Callable, *, max_cov_trace: Optional[float] = None) -> Callable:
    """Wrap a bank step so instances that diverge DURING the step roll back.

    ``step_fn(bank_state, *args, **kw)`` returns ``new_bank`` or
    ``(new_bank, aux)``. The wrapper returns ``(bank_out, healthy, [aux])``:
    ``healthy`` is the (B,) post-step health mask, ``bank_out`` keeps the
    pre-step state where it is False, and ``aux`` rows of rolled-back
    instances are scrubbed (numbers 0, booleans False) so the diverged
    step's NaN telemetry cannot poison reductions. A rolled-back instance is
    frozen, not fixed: pair with :func:`reseed_where` to restart it."""

    def wrapped(bank_state, *args, **kw):
        out = step_fn(bank_state, *args, **kw)
        # plain tuple = (state, aux); anything else (incl. NamedTuple filter
        # states, which ARE tuples) is a bare state
        new_state, aux = out if type(out) is tuple else (out, None)
        healthy = health_mask(new_state, max_cov_trace=max_cov_trace)
        bank_out = select_where(healthy, new_state, bank_state)
        if aux is None:
            return bank_out, healthy
        return bank_out, healthy, mask_rows(healthy, aux)

    return wrapped


def reseed_where(bank_state: Any, dead: torch.Tensor, donor: Any) -> Any:
    """Restart the instances marked ``dead`` from ``donor``: a
    single-instance state (one leaf rank less than the bank's; broadcast to
    every dead slot as a view, the reference's construct-from-state resume)
    or a bank snapshot of the same layout (per-instance restart from a
    ``parallel.checkpoint`` save)."""
    b_leaf = tree_leaves(bank_state)[0]
    if tree_leaves(donor)[0].ndim == b_leaf.ndim - 1:
        nb = b_leaf.shape[0]
        donor = tree_map(lambda a: a.expand(nb, *a.shape), donor)
    return select_where(dead, donor, bank_state)


class SelfHealInfo(NamedTuple):
    healthy: torch.Tensor  # (B,) post-step, pre-reseed health mask
    n_reseeded: torch.Tensor  # () int32 on the bank's device: instances restarted this step


def self_healing_step(step_fn: Callable, *, max_cov_trace: Optional[float] = None) -> Callable:
    """Step, detect, restart the dead from a snapshot.

    Returns ``wrapped(bank_state, snapshot, *args, **kw) -> (bank_out,
    info)`` (plus ``aux`` if ``step_fn`` returned one); ``snapshot`` is the
    known-good donor, typically the bank restored from the last
    checkpoint."""
    g = guarded(step_fn, max_cov_trace=max_cov_trace)

    def wrapped(bank_state, snapshot, *args, **kw):
        out = g(bank_state, *args, **kw)
        bank_out, healthy = out[0], out[1]
        bank_out = reseed_where(bank_out, ~healthy, snapshot)
        info = SelfHealInfo(healthy=healthy, n_reseeded=(~healthy).sum().to(torch.int32))
        if len(out) == 3:
            return bank_out, info, out[2]
        return bank_out, info

    return wrapped
