"""Shared helpers of the benchmark's tests: a cell cut to a size the CPU
holds (the port's plain path on CPU tensors), run for a fixed number of
ticks."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_spec(name: str, bank: int = 6, dtype: str = "float64", stream_ticks: int = 300) -> dict:
    """Cell ``name`` at ``bank`` vehicles, all of them sampled."""
    from portbench import run as R

    spec = copy.deepcopy(R.load_cell(name))
    spec["config"]["bank"] = bank
    spec["config"]["dtype"] = dtype
    spec["check"]["sample"] = bank
    spec["mix"]["stream_ticks"] = stream_ticks
    return spec
