"""Thin wandb wrapper (a copy of ``mhrec_tpu/utils/wandblogger.py``; the
reference's ``REC/utils/wandblogger.py``): namespaced
metric logging, run grouping by model name; degrades to a no-op when wandb
is unavailable or ``log_wandb`` is false."""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


class WandbLogger:
    def __init__(self, config, enabled: Optional[bool] = None):
        self.enabled = bool(config["log_wandb"]) if enabled is None else enabled
        self._run = None
        if not self.enabled:
            return
        try:
            import wandb

            self._run = wandb.init(
                project=config["wandb_project"] or "mhrec_tpu",
                group=str(config["model"]),
                config={k: config[k] for k in config.keys()},
                reinit=True,
            )
        except Exception as e:  # wandb not installed / offline
            logger.warning("wandb unavailable (%s); disabling", e)
            self.enabled = False

    def log_metrics(self, metrics, step=None, head: str = "train"):
        if not self.enabled or self._run is None:
            return
        payload = {f"{head}/{k}": v for k, v in metrics.items()}
        self._run.log(payload, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
