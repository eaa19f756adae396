"""TensorBoard, device-memory reporting, profiler traces and eval dumps (port
of ``mhrec_tpu/utils/observability.py``).

* ``get_tensorboard`` — a tensorboardX writer named after the log file, or
  None when tensorboardX is absent;
* ``get_device_usage`` — the CUDA cards' memory: what the caching allocator
  holds (``torch.cuda.memory_stats``) against the card's total
  (``torch.cuda.mem_get_info``);
* ``profile_trace`` — a ``torch.profiler`` trace of a block, written as a
  Chrome trace (``chrome://tracing`` or Perfetto);
* ``save_log_dict`` / ``load_log_dict`` — the per-user top-K recommendation
  dumps with head provenance (``log_detailed_results``);
* ``save_eval_chunk`` — the ``save_for_eval`` export of each eval batch's
  top-k and embeddings.

The dump formats are the JAX package's (``.npz`` arrays beside ``.json.gz``
metadata, ``eval_chunk_{i:05d}.npz``), so a dump written by either package
loads with the other's loader.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


def get_tensorboard(config):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    base = config["log_file"] if "log_file" in config.keys() else None
    name = os.path.splitext(os.path.basename(base))[0] if base else "run"
    log_dir = os.path.join(config["checkpoint_dir"] or "./saved", "tensorboard", name)
    os.makedirs(log_dir, exist_ok=True)
    return SummaryWriter(log_dir)


def get_device_usage() -> str:
    if not torch.cuda.is_available():
        return "no device memory stats"
    parts = []
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_stats(i).get("reserved_bytes.all.current", 0) / 2**30
        _, total = torch.cuda.mem_get_info(i)
        parts.append(f"{torch.cuda.get_device_name(i)}: {used:.2f}/{total / 2**30:.2f} GiB")
    return "; ".join(parts)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the block (host and, when there is a card,
    device activity), written to ``log_dir/trace.json`` as a Chrome trace."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def save_log_dict(path: str, log_dict: Dict[str, np.ndarray]):
    """Per-user eval dump: npz for arrays + gzip json for metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in log_dict.items()
              if isinstance(v, np.ndarray) or hasattr(v, "shape")}
    meta = {k: v for k, v in log_dict.items() if k not in arrays}
    np.savez_compressed(path + ".npz", **arrays)
    with gzip.open(path + ".json.gz", "wt") as fh:
        json.dump(meta, fh)


def load_log_dict(path: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    npz = path + ".npz"
    if os.path.isfile(npz):
        with np.load(npz, allow_pickle=False) as data:
            out.update({k: data[k] for k in data.files})
    meta = path + ".json.gz"
    if os.path.isfile(meta):
        with gzip.open(meta, "rt") as fh:
            out.update(json.load(fh))
    return out


def save_eval_chunk(
    out_dir: str, chunk_idx: int, *, user_ids, topk_values, topk_indices,
    user_embs=None, head_embs=None,
):
    """The ``save_for_eval`` export of one eval batch (reference
    trainer.py:939-966): ``eval_chunk_{chunk_idx:05d}.npz`` under
    ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {
        "user_ids": np.asarray(user_ids),
        "topk_values": np.asarray(topk_values),
        "topk_indices": np.asarray(topk_indices),
    }
    if user_embs is not None:
        payload["user_embs"] = np.asarray(user_embs)
    if head_embs is not None:
        payload["head_embs"] = np.asarray(head_embs)
    np.savez_compressed(os.path.join(out_dir, f"eval_chunk_{chunk_idx:05d}.npz"), **payload)
