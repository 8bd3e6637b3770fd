"""The reference's measurement models, one module a model, found by the
name a traffic mix gives its update (``portbench/traffic/<mix>.json``).

A module defines ``h(x, p, aux)`` on (K, S, 54) sigma points. It may define
``GATE`` (the χ² threshold above which the update keeps the prior),
``aux(mu, rr, p)`` where the model reads an operand worked out from the
state, and ``AUX_OPERANDS``, the per-vehicle operands beside z and R that
the update reads (for ``portbench/work``)."""

import importlib


def load(name: str):
    """The measurement model ``name`` (``portbench/reference/models/<name>.py``)."""
    return importlib.import_module(f"{__name__}.{name}")
