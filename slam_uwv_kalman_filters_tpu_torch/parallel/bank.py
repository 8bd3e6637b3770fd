"""Filter-bank helpers — the counterpart of
``slam_uwv_kalman_filters_tpu/parallel/bank.py``. A bank of N independent
filters is one NamedTuple whose leaves carry a leading bank axis; per-instance
gating is a masked select, so the bank never diverges in control flow.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves", "replicate", "bank_size", "select_where", "mask_rows", "masked"]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over nested NamedTuples/tuples of tensors."""
    if isinstance(tree, tuple):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested NamedTuples/tuples, in field order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def replicate(tree: Any, n: int) -> Any:
    """Tile a single filter state/params tree into an N-instance bank
    (contiguous copies, so the bank can be updated per instance)."""
    return tree_map(lambda a: a[None].expand(n, *a.shape).contiguous(), tree)


def bank_size(tree: Any) -> int:
    """Size of the leading (bank) axis of a bank tree."""
    return tree_leaves(tree)[0].shape[0]


def select_where(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Tree select with a per-instance boolean mask broadcast from the left."""

    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)

    return tree_map(sel, a, b)


def mask_rows(mask: torch.Tensor, tree: Any) -> Any:
    """Scrub per-instance rows where ``mask`` is False: booleans become
    False, numbers 0. Leaves whose leading shape does not match pass
    through."""

    def sel(x):
        if x.ndim < mask.ndim or x.shape[: mask.ndim] != mask.shape:
            return x
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        if x.dtype == torch.bool:
            return x & m
        return torch.where(m, x, torch.zeros_like(x))

    return tree_map(sel, tree)


def masked(update_fn: Callable) -> Callable:
    """Wrap a bank update so instances with ``valid=False`` keep their state;
    the info record is masked alongside (``accepted`` False, numbers 0), so a
    discarded update surfaces no phantom acceptance or NaN statistic.

    usage: ``state, info = masked(update_velocity_bank)(state, valid, params, z, R)``
    """

    def wrapped(state, valid, *args, **kw):
        out = update_fn(state, *args, **kw)
        # plain tuple = (state, info); a NamedTuple filter state is also a
        # tuple, so the check must be on the exact type
        if type(out) is tuple:
            new_state, info = out
            return select_where(valid, new_state, state), mask_rows(valid, info)
        return select_where(valid, out, state)

    return wrapped
