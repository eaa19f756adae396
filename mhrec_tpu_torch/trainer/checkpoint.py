"""Checkpoint writes on a writer thread (the JAX package's asynchronous
orbax saves, trainer.py:201 and :863-872).

``start_write`` takes a payload already copied to host memory, so the
training loop may change the parameters at once, and a writer thread
``torch.save``s it to a temporary file and renames that over the
checkpoint. In-flight writes are kept in one registry for the whole
process, keyed by the checkpoint's path: ``wait_for_write(path)`` waits for
the write of that path whoever started it (a second ``Trainer`` that loads
the same directory waits for the first one's write), and raises the
writer's exception there. A write stays in the registry until it has
succeeded and been joined, so every waiter waits for it; a failed one stays
until a new write of its path replaces it, so every waiter raises its error.
Interpreter exit waits for every write; a failure that no waiter has raised
then ends the process with exit code 1.
"""

from __future__ import annotations

import atexit
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

_writes: Dict[str, "_Write"] = {}
_lock = threading.Lock()


def host_copy(obj, keep=()):
    """``obj`` with every tensor copied to host memory (a new copy even
    when it is there already), except the host tensors of ``keep``, which
    nothing else writes (they go in as they are); returns (copy, bytes
    copied). Pageable memory, freed when the write is done: nothing stays
    pinned."""
    total = 0
    keep_ids = {id(t) for t in keep}

    def copy(x):
        nonlocal total
        if isinstance(x, torch.Tensor) and id(x) in keep_ids and x.device.type == "cpu":
            return x
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
            return x.detach().to("cpu", copy=True)
        if isinstance(x, dict):
            return type(x)((k, copy(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    return copy(obj), total


def write_checkpoint(payload: Any, path: str) -> int:
    """``torch.save`` through a temporary file renamed over ``path``, so a
    crash never leaves a torn checkpoint; returns the file's bytes."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return os.path.getsize(path)


class _Write:
    def __init__(self, path: str, payload: Any, stats: Optional[dict]):
        self.path, self.payload, self.stats = path, payload, stats
        self.error: Optional[BaseException] = None
        self.reported = False  # its error was raised to a waiter
        self.thread = threading.Thread(target=self._run, name="checkpoint-writer")

    def _run(self):
        t0 = time.perf_counter()
        try:
            nbytes = write_checkpoint(self.payload, self.path)
            if self.stats is not None:
                self.stats.update(bytes=nbytes, save_s=time.perf_counter() - t0)
            logger.info("checkpoint written: %d bytes in %.1fs (writer thread)", nbytes,
                        time.perf_counter() - t0)
        except BaseException as e:  # raised again by whoever waits
            self.error = e
        finally:
            self.payload = None  # the host copy goes as soon as it is written

    def raise_error(self):
        self.reported = True
        raise RuntimeError(f"writing the checkpoint {self.path} failed") from self.error


def _join(path: str) -> Optional[_Write]:
    """Wait for the write of ``path`` in the registry, if any, and drop it
    from there once it has succeeded; returns it."""
    with _lock:
        w = _writes.get(path)
    if w is None:
        return None
    w.thread.join()
    with _lock:
        if w.error is None and _writes.get(path) is w:
            del _writes[path]
    return w


def wait_to_replace(path: str) -> Optional[_Write]:
    """Wait for the write of ``path`` in flight before a new write of it. A
    failed one raises here, unless its error has been raised already."""
    prev = _join(path)
    if prev is not None and prev.error is not None and not prev.reported:
        prev.raise_error()
    return prev


def start_write(path: str, payload: Any, stats: Optional[dict] = None) -> None:
    """Write ``payload`` to ``path`` on a writer thread, after any write of
    that path still in flight (``wait_to_replace``). ``stats`` gets the
    file's ``bytes`` and the writer's ``save_s`` when it is done."""
    w = _Write(path, payload, stats)
    while True:
        prev = wait_to_replace(path)
        with _lock:
            if _writes.get(path) in (None, prev):  # no other write began meanwhile
                _writes[path] = w
                w.thread.start()
                return


def wait_for_write(path: str) -> None:
    """Wait for the write of ``path`` in flight, if any; a failed write's
    error is raised here, to every waiter until a new write replaces it."""
    w = _join(path)
    if w is not None and w.error is not None:
        w.raise_error()


def _wait_at_exit():
    try:
        for path in list(_writes):
            w = _join(path)
            if w is not None and w.error is not None and not w.reported:
                w.raise_error()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


atexit.register(_wait_at_exit)
