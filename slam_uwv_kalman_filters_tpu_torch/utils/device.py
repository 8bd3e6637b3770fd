"""Where the port's constructors put their tensors.

The port runs on the card: a constructor called without ``device`` builds on
``cuda``. A machine without a card has to ask for the CPU by name
(``device="cpu"``); there is no quiet fallback. Functions that take tensors
follow their inputs' device and never consult this.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``torch.device("cuda")``, raising where no card is present;
    anything else (``"cpu"``, ``"cuda:1"``, a ``torch.device``) as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card by default; "
            "pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda")
