"""Filter-bank helpers — the counterpart of
``slam_uwv_kalman_filters_tpu/parallel/bank.py``. A bank of N independent
filters is one NamedTuple whose leaves carry a leading bank axis; per-instance
gating is a masked select, so the bank never diverges in control flow.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["tree_map", "replicate", "select_where", "mask_rows"]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over nested NamedTuples/tuples of tensors."""
    if isinstance(tree, tuple):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def replicate(tree: Any, n: int) -> Any:
    """Tile a single filter state/params tree into an N-instance bank
    (contiguous copies, so the bank can be updated per instance)."""
    return tree_map(lambda a: a[None].expand(n, *a.shape).contiguous(), tree)


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
