"""Process groups, ranks and row-sharded tables (port of
``mhrec_tpu/parallel/mesh.py`` in torch's idiom).

The JAX package runs one SPMD program over a device mesh: the train step
sees the global batch sharded over ``data`` and XLA inserts the gradient
psum. Here each rank is a process that holds its own rows of the global
batch and calls the collectives itself (``parallel/comm.py``):

* ``init_distributed`` joins the process group (the counterpart of
  ``jax.distributed.initialize``): NCCL for a CUDA device, gloo for the
  CPU, device ``cuda:{local_rank % device_count}``;
* ``make_mesh`` gives this process's rank and the world size
  (``DataMesh``), which also carries the collectives a model calls (the
  pool gather, the loss counts' sum); tensor parallelism (``tp_size > 1``)
  is not ported;
* ``shard_identical`` is this rank's slice of dim 0 of data that every
  rank holds alike (a corpus chunk each rank built for itself);
* ``zero_owners`` is the counterpart of ``zero_sharded_opt_state``: it
  assigns each dense parameter's optimizer state to one rank
  (``trainer/optim.py::ZeroShardedOptimizer``);
* ``RowShard`` is the row-sharded item table (``shard_item_embedding``, JAX
  ``hstu.py:249-252``): rank r owns rows [r·R, (r+1)·R), R = ⌈n / W⌉.

``shard_batch``, ``local_shard`` and ``put_replicated`` have no
counterpart: each rank holds its own rows of a batch (the batchers'
``host_id`` / ``num_hosts`` stride), and a tensor the ranks hold alike is
simply held by each.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from mhrec_tpu_torch.parallel import comm


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, its store at ``coordinator_address`` (host:port). What
    is not given comes from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). ``device``:
    None or "cuda" for card ``local_rank % device_count``, or an explicit
    device ("cpu"). ``backend``: NCCL on a CUDA device and gloo on the CPU
    unless given. Returns this rank's device."""
    env = os.environ
    try:
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
        rank = int(env["RANK"]) if process_id is None else int(process_id)
    except KeyError as exc:
        raise ValueError(
            f"init_distributed: {exc.args[0]} is not set; pass coordinator_address, "
            "num_processes and process_id (run.py --coordinator_address host:port "
            "--num_processes W --process_id r) or launch with torchrun") from None
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' "
                               "(run.py --device cpu) for gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return dev


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel group: ``rank`` of
    ``world`` ranks, each holding ``1/world`` of every global batch. A
    model's collectives go through it (``comm``'s), so that a caller may
    hand the model another group of the same interface."""

    rank: int
    world: int

    def all_gather_rows(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every rank's ``x`` along dim 0 in rank order; backward, this
        rank's block of its own gradient (``comm.all_gather_rows`` without
        its all-reduce): the loss's products against the gathered pool sum
        that gradient over the ranks (``models/losses.py``)."""
        return comm.all_gather_rows(x, tag, reduce_grad=False)

    def all_reduce(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """``t`` summed over the ranks, in place (``comm.all_reduce``)."""
        return comm.all_reduce(t, tag)


def make_mesh(tp_size: int = 1) -> DataMesh:
    """The data-parallel group of this process (rank 0 of 1 without a
    process group)."""
    if tp_size > 1:
        raise NotImplementedError(
            "tp_size > 1 (tensor-parallel towers) is not ported yet: tensor parallelism is "
            "ROADMAP.md Queue 1 item 6, after FSDP")
    return DataMesh(comm.process_index(), comm.process_count())


def shard_identical(x, mesh: Optional[DataMesh]):
    """This rank's contiguous slice of dim 0 of ``x`` (a numpy array or a
    tensor) that every rank holds alike: rows [r·B/W, (r+1)·B/W) (JAX
    ``shard_identical``, mesh.py:91-103); ``x`` itself without a group.
    B must divide by W."""
    if mesh is None or mesh.world == 1:
        return x
    B = x.shape[0]
    assert B % mesh.world == 0, (B, mesh.world)
    n = B // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def zero_owners(sizes: Sequence[int], world: int) -> List[int]:
    """The rank that holds the optimizer state of each of the parameters of
    ``sizes`` elements: the largest first, each to the rank with the fewest
    elements so far (the lowest rank on ties). The same on every rank."""
    load = [0] * world
    owners = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        r = min(range(world), key=lambda r: load[r])
        owners[i] = r
        load[r] += sizes[i]
    return owners


class RowShard:
    """A table of ``num_rows`` rows split over the ranks of ``mesh`` in
    contiguous blocks of ``rows`` = ⌈num_rows / world⌉; the last block is
    padded with zero rows. Every method is a collective except ``block``
    and ``local_ids``.

    Lookup pattern: each rank all-gathers the ids of every rank, fills the
    rows it owns (zeros elsewhere) into a [world, n, D] block and the block
    is SUM-all-reduced, so each id's row comes from its owner exactly
    (x + 0 = x); a rank keeps its own slice. Gradients return to the owner
    through the trainer's gathered row update (each rank applies the rows it
    owns of the deduped union), and evaluation gathers the whole table once
    (``gather``)."""

    def __init__(self, num_rows: int, mesh: DataMesh):
        self.num_rows = num_rows
        self.rank, self.world = mesh.rank, mesh.world
        self.rows = -(-num_rows // self.world)
        self.start = self.rank * self.rows

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the full table ``full`` [num_rows, ...],
        zero-padded to ``rows``."""
        part = full[self.start:self.start + self.rows]
        pad = self.rows - part.shape[0]
        if pad:
            part = torch.cat([part, part.new_zeros((pad,) + tuple(part.shape[1:]))])
        return part.contiguous()

    def local_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Global row ids → rows of this rank's block, −1 where another
        rank owns them (or the id is −1)."""
        owned = (ids >= self.start) & (ids < self.start + self.rows)
        return torch.where(owned, ids - self.start, torch.full_like(ids, -1))

    def lookup(self, local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (global, any shape, the same count on every rank) of
        the table whose block this rank holds as ``local``."""
        D = local.shape[1]
        parts = comm.all_gather(ids.reshape(-1), "table_lookup")
        rows = torch.stack([
            torch.where((loc >= 0)[:, None], local[loc.clamp(min=0)],
                        torch.zeros((), dtype=local.dtype, device=local.device))
            for loc in (self.local_ids(p) for p in parts)])
        comm.all_reduce(rows, "table_lookup")
        return rows[self.rank].reshape(*ids.shape, D)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full table [num_rows, ...] from every rank's block."""
        return torch.cat(comm.all_gather(local, "table_gather"), dim=0)[:self.num_rows]
