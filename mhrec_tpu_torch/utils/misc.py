"""Seeding (reference ``REC/utils/utils.py:140-158``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int, reproducibility: bool = True) -> None:
    """Seed python, numpy and torch. Parameter initialisation draws from an
    explicit ``torch.Generator`` seeded from ``config["seed"]``
    (``Trainer.setup_model``); this only pins the global streams."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if reproducibility:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True


def resolve_device(device=None) -> torch.device:
    """The device to run on: the card unless the caller names another one.
    Raises when no CUDA device is present and none was named — the port
    never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' (run.py --device cpu) "
                "to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
