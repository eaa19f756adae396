"""Console + file logging (reference REC/utils/logger.py behavior).

Rank 0 logs at the configured level; non-zero host processes log at WARNING.
The file handler strips ANSI color codes.
"""

from __future__ import annotations

import logging
import os
import re
import time

_ANSI_RE = re.compile(r"\033\[[0-9;]*m")

_COLORS = {
    "black": "30", "red": "31", "green": "32", "yellow": "33",
    "blue": "34", "pink": "35", "cyan": "36", "white": "37",
}


def set_color(text: str, color: str, highlight: bool = True) -> str:
    code = _COLORS.get(color, "37")
    prefix = "1;" if highlight else ""
    return f"\033[{prefix}{code}m{text}\033[0m"


class _StripAnsiFormatter(logging.Formatter):
    def format(self, record):
        return _ANSI_RE.sub("", super().format(record))


def init_logger(config, process_index: int = 0) -> logging.Logger:
    level = getattr(logging, str(config["state"] or "INFO").upper(), logging.INFO)
    if process_index != 0:
        level = logging.WARNING

    logger = logging.getLogger()
    for h in list(logger.handlers):
        logger.removeHandler(h)
    logger.setLevel(level)

    fmt = "%(asctime)s %(levelname)s %(message)s"
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(fmt))
    logger.addHandler(sh)

    ckpt_dir = config["checkpoint_dir"] or "./saved"
    model = config["model"] or "model"
    log_dir = os.path.join(ckpt_dir, str(model))
    # log_path overrides the default dir (reference logger.py:72-73)
    if config["log_path"]:
        log_dir = os.path.join(ckpt_dir, str(config["log_path"]))
    try:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%b-%d-%Y_%H-%M-%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"{stamp}.log"))
        fh.setFormatter(_StripAnsiFormatter(fmt))
        logger.addHandler(fh)
        config["log_file"] = os.path.join(log_dir, f"{stamp}.log")
    except OSError:
        pass
    return logger
