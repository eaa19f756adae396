"""Seeding, device choice, early stopping and the validation score
(reference ``REC/utils/utils.py``)."""

from __future__ import annotations

import random
from typing import Any, Dict, Optional, Tuple

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


def early_stopping(
    value: float,
    best: Optional[float],
    cur_step: int,
    max_step: int,
    bigger: bool = True,
) -> Tuple[float, int, bool, bool]:
    """Best-score tracking with patience (reference utils.py:60-102).
    Returns (best, cur_step, stop_flag, update_flag)."""
    if best is None:
        return value, 0, False, True
    improved = value > best if bigger else value < best
    if improved:
        return value, 0, False, True
    cur_step += 1
    return best, cur_step, cur_step > max_step, False


def calculate_valid_score(
    valid_result: Dict[str, Any],
    valid_metric: Optional[str] = None,
    eval_pred_len: int = 1,
) -> float:
    """The model-selection scalar of a nested eval-result dict: the metric
    under ``pred_{eval_pred_len-1}`` (reference utils.py:104-125)."""
    key = f"pred_{eval_pred_len - 1}"
    inner = valid_result[key] if key in valid_result else valid_result
    if valid_metric and valid_metric in inner:
        return float(inner[valid_metric])
    lowered = {k.lower(): v for k, v in inner.items()}
    if valid_metric and valid_metric.lower() in lowered:
        return float(lowered[valid_metric.lower()])
    raise KeyError(f"valid_metric {valid_metric!r} not in result keys {list(inner)[:8]}")
