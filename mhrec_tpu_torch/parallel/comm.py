"""Host-level and tensor communication on ``torch.distributed`` (port of
``mhrec_tpu/parallel/comm.py``).

One process per rank. Without an initialized process group every function
here answers for a world of one at once (the JAX package's single-process
fast paths); inside a group every call is a collective, also at world size
1, so a one-rank group runs the same communication as a larger one.

* ``process_count`` / ``process_index`` / ``broadcast_object`` /
  ``all_gather_objects`` / ``sync_hosts``: picklable metadata across ranks
  (``broadcast_object_list``, ``all_gather_object``, ``barrier``);
* ``all_reduce`` (SUM, in place), ``broadcast``, ``all_gather`` (the list
  form) and ``all_gather_rows``, the differentiable all-gather of the reference's
  ``basemodel.py:11-22``: rank order along dim 0 forward, and backward each
  rank gets the gradient of its own block summed over the ranks (an
  ``all_reduce`` of the whole gathered gradient, then the rank's slice), or,
  where the caller has summed that gradient itself, its own slice;
* ``SharedArray`` — POSIX shared-memory numpy arrays for sibling processes
  of one machine (reference ``SharedList``, shareables.py:94-173).

The tensor collectives are ``all_reduce``, ``broadcast`` and the list
form of ``all_gather``, which NCCL and gloo both run on CUDA tensors (gloo
stages them through host memory). ``reduce_scatter``,
``all_gather_into_tensor`` and the coalesced forms are not used: torch's
backend table gives gloo no CUDA ``reduce_scatter``, so a reduce-scatter
here is an all-reduce and the rank's slice.

``traffic`` counts the bytes of every tensor collective by the ``tag`` its
caller gives: an all-reduce's and a broadcast's tensor, an all-gather's
gathered result (what each rank holds after the call). The tags in use:
``grad_all_reduce`` and ``zero_broadcast`` (the dense gradients and ZeRO-2's
parameters), ``pool_gather`` and ``pool_gather_grad`` (the negative pool and
its gradient), ``loss_counts`` and ``step_scalars``, ``dedup_gather``,
``table_lookup``, ``table_chunk`` (an evaluation's item chunks),
``table_save`` (rank 0's host assembly for the checkpoint) and ``checksum``
(the row-sharded table), ``corpus_gather`` (HLLM's corpus pass) and
``metric_reduce``.
"""

from __future__ import annotations

from collections import Counter
from multiprocessing import shared_memory
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist


traffic: Counter = Counter()


def _count(tag: str, nbytes: int) -> None:
    traffic[tag] += nbytes


def initialized() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """Broadcast a picklable object from ``root`` to every rank."""
    if not initialized():
        return obj
    buf = [obj if process_index() == root else None]
    dist.broadcast_object_list(buf, src=root)
    return buf[0]


def all_gather_objects(obj: Any) -> List[Any]:
    """Gather one picklable object per rank; returns a list in rank order."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def sync_hosts(name: str = "barrier") -> None:
    """Wait until every rank has reached this call (``name`` documents the
    call site, as in the JAX package)."""
    if initialized():
        dist.barrier()


def all_reduce(t: torch.Tensor, tag: str = "all_reduce") -> torch.Tensor:
    """SUM ``t`` over the ranks, in place; returns ``t``."""
    if initialized():
        _count(tag, t.numel() * t.element_size())
        dist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, root: int, tag: str = "broadcast") -> torch.Tensor:
    """``t`` of rank ``root`` into ``t`` of every rank, in place."""
    if initialized():
        _count(tag, t.numel() * t.element_size())
        dist.broadcast(t, src=root)
    return t


def all_gather(t: torch.Tensor, tag: str = "all_gather") -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order."""
    if not initialized():
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(process_count())]
    _count(tag, len(out) * t.numel() * t.element_size())
    dist.all_gather(out, t)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tag, reduce_grad):
        ctx.n, ctx.tag, ctx.reduce_grad = x.shape[0], tag, reduce_grad
        return torch.cat(all_gather(x, tag), dim=0)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = all_reduce(grad.contiguous().clone(), f"{ctx.tag}_grad")
        r = process_index()
        return grad[r * ctx.n:(r + 1) * ctx.n], None, None


def all_gather_rows(x: torch.Tensor, tag: str = "all_gather_rows",
                    reduce_grad: bool = True) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order,
    differentiably: the gradient of a rank's block is summed over the ranks
    and handed back to that rank (counted as ``{tag}_grad``). With
    ``reduce_grad`` false the rank takes its block of its own gradient: the
    caller's operations have summed it over the ranks already (the loss's
    products against the negative pool, ``models/losses.py``)."""
    return _AllGatherRows.apply(x, tag, reduce_grad)


class SharedArray:
    """A numpy array in POSIX shared memory, attachable by sibling processes
    on the same machine by name (reference SharedList equivalent for the
    dense-array case — the flat interaction storage is arrays, not pickled
    object lists, so zero-copy attach needs no serialization)."""

    def __init__(self, array: Optional[np.ndarray] = None, name: Optional[str] = None,
                 shape=None, dtype=None):
        if array is not None:
            self._shm = shared_memory.SharedMemory(create=True, size=array.nbytes)
            self.array = np.ndarray(array.shape, array.dtype, buffer=self._shm.buf)
            self.array[...] = array
            self.owner = True
        else:
            assert name and shape is not None and dtype is not None
            self._shm = shared_memory.SharedMemory(name=name)
            self.array = np.ndarray(shape, dtype, buffer=self._shm.buf)
            self.owner = False

    @property
    def name(self) -> str:
        return self._shm.name

    def handle(self):
        """(name, shape, dtype-str) tuple to send to sibling processes."""
        return (self._shm.name, self.array.shape, str(self.array.dtype))

    @classmethod
    def attach(cls, handle) -> "SharedArray":
        name, shape, dtype = handle
        return cls(name=name, shape=tuple(shape), dtype=np.dtype(dtype))

    def close(self, unlink: Optional[bool] = None):
        self._shm.close()
        if self.owner if unlink is None else unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
