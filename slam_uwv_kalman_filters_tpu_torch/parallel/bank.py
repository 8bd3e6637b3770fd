"""Filter-bank helpers — the counterpart of
``slam_uwv_kalman_filters_tpu/parallel/bank.py``. A bank of N independent
filters is one NamedTuple whose leaves carry a leading bank axis; per-instance
gating is a masked select, so the bank never diverges in control flow.
:func:`vmap_filter` maps a function written for one filter over a bank with
``torch.func.vmap``, as JAX's ``vmap_filter`` does with ``jax.vmap``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import torch
from torch.utils import _pytree

__all__ = ["tree_map", "tree_leaves", "replicate", "bank_size", "vmap_tree", "vmap_filter", "select_where",
           "mask_rows", "masked"]


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


def vmap_tree(fn: Callable, in_dims: tuple, out_dims=0) -> Callable:
    """``torch.func.vmap(fn, in_dims, out_dims)`` over arguments and results
    that are trees with leaves other than tensors (``None`` for a sensor
    stream that is absent, Python numbers), as ``jax.vmap`` takes them: such
    a leaf is passed unmapped (``in_dims`` entry ``None`` for it) and
    returned as ``fn`` gave it. ``in_dims`` has one entry per argument, an
    int or ``None``; ``out_dims`` is one int for every tensor of the
    result."""

    def run(*args):
        dims = tuple(None if d is None else _pytree.tree_map(lambda x: d if isinstance(x, torch.Tensor) else None, a)
                     for a, d in zip(args, in_dims))
        spec = {}

        def tensors_only(*a):
            leaves, spec["tree"] = _pytree.tree_flatten(fn(*a))
            spec["other"] = [None if isinstance(x, torch.Tensor) else (x,) for x in leaves]
            return tuple(x for x in leaves if isinstance(x, torch.Tensor))

        out = iter(torch.func.vmap(tensors_only, in_dims=dims, out_dims=out_dims)(*args))
        return _pytree.tree_unflatten([next(out) if o is None else o[0] for o in spec["other"]], spec["tree"])

    return run


def vmap_filter(fn: Callable, *, state_axis=0, params_axis=None, data_axes=0) -> Callable:
    """``torch.func.vmap`` of a filter function ``fn(state, params, *data)``
    over the bank axis. ``params_axis=None`` shares one parameter set across
    the bank (a fleet of identical vehicles); ``params_axis=0`` sweeps a
    parameter set per instance (Monte-Carlo tuning). ``data_axes`` is one
    axis (or ``None``) for every data argument, or a tuple of them, one per
    argument; keyword arguments are passed unmapped. The kernels the solo
    function reaches (K1, K8, K12) launch once per call for the whole bank,
    through their ops' vmap rules (``ops/kernels.py``)."""

    def in_dims_for(nargs):
        extra = data_axes if isinstance(data_axes, tuple) else (data_axes,) * nargs
        return (state_axis, params_axis, *extra)

    def wrapped(state, params, *data, **kw):
        return vmap_tree(partial(fn, **kw), in_dims_for(len(data)))(state, params, *data)

    return wrapped


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

    usage: ``state, info = masked(update_velocity_bank)(state, valid, params, z, R)``,
    or ``masked(vmap_filter(update_velocity))`` for the solo update
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
