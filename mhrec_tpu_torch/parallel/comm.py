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
  form), ``reduce_scatter`` and ``all_gather_flat`` (FSDP's flat blocks,
  ``parallel/fsdp.py``) and ``all_gather_rows``, the differentiable all-gather of the reference's
  ``basemodel.py:11-22``: rank order along dim 0 forward, and backward each
  rank gets the gradient of its own block summed over the ranks (an
  ``all_reduce`` of the whole gathered gradient, then the rank's slice), or,
  where the caller has summed that gradient itself, its own slice;
* ``SharedArray`` — POSIX shared-memory numpy arrays for sibling processes
  of one machine (reference ``SharedList``, shareables.py:94-173).

Every collective takes a ``group`` (a ``dist.new_group`` of some ranks;
None: the default group) and runs over its ranks; a ``root`` and the
gather orders are ranks within that group. Under tensor parallelism
(``parallel/mesh.py::make_mesh``) the data-parallel collectives run over
this rank's data group and ``parallel/tensor.py``'s over its model group.

The tensor collectives are ``all_reduce``, ``broadcast``, the list form
of ``all_gather`` and torch's single-tensor reduce-scatter and all-gather
(``reduce_scatter_tensor`` / ``all_gather_into_tensor``, named
``reduce_scatter_single`` / ``all_gather_single`` from torch 2.13), which
NCCL and gloo both run, gloo on CPU tensors (torch 2.13) and on CUDA
tensors staged through host memory (torch 2.11). The coalesced forms are
not used.

``traffic`` counts the bytes of every tensor collective by the ``tag`` its
caller gives: an all-reduce's and a broadcast's tensor, an all-gather's
gathered result (what each rank holds after the call). The tags in use:
``grad_all_reduce`` and ``zero_broadcast`` (the dense gradients and ZeRO-2's
parameters), ``pool_gather`` and ``pool_gather_grad`` (the negative pool and
its gradient), ``loss_counts`` and ``step_scalars``, ``dedup_gather``,
``table_lookup``, ``table_chunk`` (an evaluation's item chunks),
``table_save`` (rank 0's host assembly for the checkpoint) and ``checksum``
(the row-sharded table and the FSDP blocks), ``corpus_gather`` (HLLM's
corpus pass), ``metric_reduce``, and FSDP's ``fsdp_gather`` (a layer's
parameters before its forward and its backward; the gathered result),
``fsdp_reduce_scatter`` (their gradients; the whole flat input a rank
sends), ``grad_norm`` (the clip's sum of squares) and ``fsdp_save``. The
model group's tags begin with ``tp_``: ``tp_reduce`` (the row-parallel
products' float32 partials), ``tp_input_grad`` (the gradient of a
column-parallel product's input), ``tp_whole_grad`` (the gradients of the
projections that stay whole inside a split block), ``tp_grad_norm``,
``tp_checksum`` and ``tp_save`` (rank 0's assembly of the split
parameters and their moments).
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


def group_size(group=None) -> int:
    """The ranks of ``group`` (None: the default group)."""
    return process_count() if group is None else dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank within ``group`` (None: the default group)."""
    return process_index() if group is None else dist.get_rank(group)


def _global(group, r: int) -> int:
    """The default group's rank of rank ``r`` of ``group``."""
    return r if group is None else dist.get_global_rank(group, r)


def broadcast_object(obj: Any, root: int = 0, group=None) -> Any:
    """Broadcast a picklable object from ``root`` (a rank of ``group``) to
    every rank of the group."""
    if not initialized():
        return obj
    buf = [obj if group_rank(group) == root else None]
    dist.broadcast_object_list(buf, src=_global(group, root), group=group)
    return buf[0]


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """Gather one picklable object per rank of ``group``; returns a list in
    the group's rank order."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def sync_hosts(name: str = "barrier") -> None:
    """Wait until every rank has reached this call (``name`` documents the
    call site, as in the JAX package)."""
    if initialized():
        dist.barrier()


def all_reduce(t: torch.Tensor, tag: str = "all_reduce", group=None) -> torch.Tensor:
    """SUM ``t`` over the ranks of ``group``, in place; returns ``t``."""
    if initialized():
        _count(tag, t.numel() * t.element_size())
        dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, root: int, tag: str = "broadcast", group=None) -> torch.Tensor:
    """``t`` of rank ``root`` (of ``group``) into ``t`` of every rank of the
    group, in place."""
    if initialized():
        _count(tag, t.numel() * t.element_size())
        dist.broadcast(t, src=_global(group, root), group=group)
    return t


def all_gather(t: torch.Tensor, tag: str = "all_gather", group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in the rank order of ``group``."""
    if not initialized():
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    _count(tag, len(out) * t.numel() * t.element_size())
    dist.all_gather(out, t, group=group)
    return out


# torch 2.13 renamed the single-tensor forms (the old names warn there)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_ALL_GATHER_FLAT = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reduce_scatter(flat: torch.Tensor, tag: str = "reduce_scatter", group=None) -> torch.Tensor:
    """``flat`` [W·n] SUM-reduced over the W ranks of ``group``; returns this
    rank's block [n] of the sum, rows [r·n, (r+1)·n) for its rank r in the
    group (``flat`` itself without a process group)."""
    if not initialized():
        return flat
    flat = flat.contiguous()
    out = flat.new_empty(flat.numel() // group_size(group))
    _count(tag, flat.numel() * flat.element_size())
    _REDUCE_SCATTER(out, flat, group=group)
    return out


def all_gather_flat(block: torch.Tensor, tag: str = "all_gather_flat",
                    group=None) -> torch.Tensor:
    """Every rank's ``block`` [n] (equal sizes) in one flat tensor [W·n],
    in the rank order of ``group`` (``block`` itself without a process
    group)."""
    if not initialized():
        return block
    block = block.contiguous()
    out = block.new_empty(group_size(group) * block.numel())
    _count(tag, out.numel() * out.element_size())
    _ALL_GATHER_FLAT(out, block, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tag, reduce_grad, group):
        ctx.n, ctx.tag, ctx.reduce_grad, ctx.group = x.shape[0], tag, reduce_grad, group
        return torch.cat(all_gather(x, tag, group), dim=0)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = all_reduce(grad.contiguous().clone(), f"{ctx.tag}_grad", ctx.group)
        r = group_rank(ctx.group)
        return grad[r * ctx.n:(r + 1) * ctx.n], None, None, None


def all_gather_rows(x: torch.Tensor, tag: str = "all_gather_rows",
                    reduce_grad: bool = True, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in the rank order of
    ``group``, differentiably: the gradient of a rank's block is summed over
    the ranks and handed back to that rank (counted as ``{tag}_grad``). With
    ``reduce_grad`` false the rank takes its block of its own gradient: the
    caller's operations have summed it over the ranks already (the loss's
    products against the negative pool, ``models/losses.py``)."""
    return _AllGatherRows.apply(x, tag, reduce_grad, group)


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
