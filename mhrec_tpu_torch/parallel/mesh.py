"""Process groups, ranks and row-sharded tables (port of
``mhrec_tpu/parallel/mesh.py`` in torch's idiom).

The JAX package runs one SPMD program over a device mesh: the train step
sees the global batch sharded over ``data`` and XLA inserts the gradient
psum. Here each rank is a process that holds its own rows of the global
batch and calls the collectives itself (``parallel/comm.py``):

* ``init_distributed`` joins the process group (the counterpart of
  ``jax.distributed.initialize``): NCCL for a CUDA device, gloo for the
  CPU, device ``cuda:{local_rank % device_count}``;
* ``make_mesh`` gives this process's place in the grid of data ranks ×
  model ranks (``DataMesh``: the data rank and world, the model rank and
  ``tp``, the two process groups), which also carries the collectives a
  model calls over the data group (the pool gather, the loss counts' sum);
  ``tp_size > 1`` splits the LLM towers over the model group
  (``parallel/tensor.py``), whose ranks hold the same rows of every batch;
* ``shard_identical`` is this rank's slice of dim 0 of data that every
  rank holds alike (a corpus chunk each rank built for itself);
* ``zero_owners`` is the counterpart of ``zero_sharded_opt_state``: it
  assigns each dense parameter's optimizer state to one rank
  (``trainer/optim.py::ZeroShardedOptimizer``);
* ``fsdp_params`` picks the parameters that FSDP / ZeRO-3 shards (JAX
  ``place`` / ``fsdp_spec``, trainer.py:284-330; ``parallel/fsdp.py``
  stores them);
* ``RowShard`` is the row-sharded item table over the data group
  (``shard_item_embedding``, JAX ``hstu.py:249-252``): rank r owns rows
  [r·R, (r+1)·R), R = ⌈n / W⌉, and
  no rank's device ever holds the whole table (JAX's ``data``-sharded
  global array, whose chunks XLA moves one at a time).

``shard_batch``, ``local_shard`` and ``put_replicated`` have no
counterpart: each rank holds its own rows of a batch (the batchers'
``host_id`` / ``num_hosts`` stride), and a tensor the ranks hold alike is
simply held by each.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mhrec_tpu_torch.parallel import comm
from mhrec_tpu_torch.parallel.tensor import TPGroup


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
    """This process's place in the rank grid: data rank ``rank`` of
    ``world`` data ranks, each holding ``1/world`` of every global batch,
    and model rank ``model_rank`` of ``tp`` (tensor parallelism; 0 of 1
    without it). Global rank = rank · tp + model_rank, the JAX package's
    ``devices.reshape(W / tp, tp)``. ``group`` is the data group (the ranks
    of this model rank across the data rows; None, the default group, at
    ``tp`` 1) and ``model_group`` the model group (the ``tp`` ranks of this
    data row, which hold the same rows of every batch). A model's
    collectives go through it (``comm``'s, over the data group), so that a
    caller may hand the model another group of the same interface."""

    rank: int
    world: int
    model_rank: int = 0
    tp: int = 1
    group: Any = None
    model_group: Any = None

    @property
    def tp_group(self) -> Optional[TPGroup]:
        """This rank's model group (``parallel/tensor.py``), None without
        tensor parallelism."""
        return TPGroup(self.model_rank, self.tp, self.model_group) if self.tp > 1 else None

    def all_gather_rows(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every data rank's ``x`` along dim 0 in rank order; backward, this
        rank's block of its own gradient (``comm.all_gather_rows`` without
        its all-reduce): the loss's products against the gathered pool sum
        that gradient over the ranks (``models/losses.py``)."""
        return comm.all_gather_rows(x, tag, reduce_grad=False, group=self.group)

    def all_reduce(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """``t`` summed over the data ranks, in place (``comm.all_reduce``)."""
        return comm.all_reduce(t, tag, group=self.group)


# one mesh per tp_size and process group (the group object itself, which a
# destroyed and re-made group does not reuse): the groups are made once
_MESHES: Dict[Tuple[int, Any], DataMesh] = {}


def make_mesh(tp_size: int = 1) -> DataMesh:
    """This process's place in the grid of W / ``tp_size`` data ranks ×
    ``tp_size`` model ranks (rank 0 of 1 without a process group). At
    ``tp_size`` > 1 every rank makes every data group and every model group
    (``dist.new_group``, in the same order on every rank), once per process
    group. W must divide by ``tp_size`` (JAX mesh.py:36): else a ValueError
    names (W, T)."""
    tp_size = max(int(tp_size or 1), 1)
    W, r = comm.process_count(), comm.process_index()
    if tp_size == 1:
        return DataMesh(r, W)
    if W % tp_size:
        # the JAX assert's numbers (mesh.py:36)
        raise ValueError(f"the world does not divide by tp_size: {(W, tp_size)}")
    key = (tp_size, dist.group.WORLD)
    if key not in _MESHES:
        d, m = divmod(r, tp_size)
        rows = W // tp_size
        data_group = model_group = None
        for mm in range(tp_size):
            g = dist.new_group([dd * tp_size + mm for dd in range(rows)])
            if mm == m:
                data_group = g
        for dd in range(rows):
            g = dist.new_group(list(range(dd * tp_size, (dd + 1) * tp_size)))
            if dd == d:
                model_group = g
        _MESHES[key] = DataMesh(d, rows, m, tp_size, data_group, model_group)
    return _MESHES[key]


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


def fsdp_params(named_params, world: int, min_size: int, split=None) -> List[str]:
    """The names of the parameters that FSDP shards over ``world`` ranks,
    in ``named_params``' order: JAX's rule (trainer.py:296-330), at least
    ``min_size`` elements and some dimension that divides by ``world`` and
    is at least ``world`` (``fsdp_spec`` finds a dimension to put ``data``
    on); none at one rank (JAX's ``dp > 1``). ``split`` maps the names of
    tensor-parallel shards to (their split dimension, T)
    (``parallel/tensor.py``): such a parameter counts its whole elements,
    and its split dimension is not free for ``data``. How a chosen parameter is split is
    ``parallel/fsdp.py``'s: a flat block each rank of its (local) shard,
    where JAX puts its largest free such dimension over the ranks; the
    numbers are the same."""
    if world <= 1:
        return []
    split = split or {}
    out = []
    for name, p in named_params:
        dim, T = split.get(name, (None, 1))
        if p.numel() * T >= min_size and any(
                s % world == 0 and s >= world for i, s in enumerate(p.shape) if i != dim):
            out.append(name)
    return out


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
    padded with zero rows. No method makes the whole table on the device:
    ``lookup`` and ``fetch`` move only the rows asked for, ``gather_to_host``
    assembles the whole table in host memory on rank 0 alone. Every method
    is a collective except ``block`` and ``local_ids``, and every rank calls
    the collectives in the same order with the same arguments.

    Lookup pattern: each rank all-gathers the ids of every rank, fills the
    rows it owns (zeros elsewhere) into a [world, n, D] block and the block
    is SUM-all-reduced, so each id's row comes from its owner exactly
    (x + 0 = x); a rank keeps its own slice. Gradients return to the owner
    through the trainer's gathered row update (each rank applies the rows it
    owns of the deduped union). Evaluation fetches the table chunk by chunk
    (``fetch``: rows [a, b), a broadcast from each owner of a piece, so the
    bytes travel once and no zero-filled block is summed)."""

    def __init__(self, num_rows: int, mesh: DataMesh):
        self.num_rows = num_rows
        self.rank, self.world, self.group = mesh.rank, mesh.world, mesh.group
        self.rows = -(-num_rows // self.world)
        self.start = self.rank * self.rows

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the full table ``full`` [num_rows, ...],
        zero-padded to ``rows`` (in ``full``'s memory: a checkpoint mapped
        in host memory gives a host block)."""
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
        parts = comm.all_gather(ids.reshape(-1), "table_lookup", self.group)
        rows = torch.stack([
            torch.where((loc >= 0)[:, None], local[loc.clamp(min=0)],
                        torch.zeros((), dtype=local.dtype, device=local.device))
            for loc in (self.local_ids(p) for p in parts)])
        comm.all_reduce(rows, "table_lookup", self.group)
        return rows[self.rank].reshape(*ids.shape, D)

    @torch.no_grad()
    def fetch(self, local: torch.Tensor, a: int, b: int, tag: str = "table_chunk"
              ) -> torch.Tensor:
        """Rows [a, b) of the table (0 ≤ a < b ≤ num_rows; the chunk may
        straddle blocks) on every rank, each piece broadcast by the rank
        that owns it (counted as ``tag``)."""
        out = local.new_empty((b - a,) + tuple(local.shape[1:]))
        for r in range(a // self.rows, (b - 1) // self.rows + 1):
            lo, hi = max(a, r * self.rows), min(b, (r + 1) * self.rows)
            piece = out[lo - a:hi - a]
            if r == self.rank:
                piece.copy_(local[lo - self.start:hi - self.start])
            comm.broadcast(piece, r, tag, self.group)
        return out

    @torch.no_grad()
    def gather_to_host(self, local: torch.Tensor, chunk: int,
                       tag: str = "table_save") -> Optional[torch.Tensor]:
        """The whole table [num_rows, ...] in host memory on rank 0, filled
        ``chunk`` rows at a time through ``fetch``; None on the other ranks,
        which only send their rows (and receive each chunk, a buffer of
        ``chunk`` rows). No device holds more than a chunk beside its
        block."""
        full = None
        if self.rank == 0:
            full = torch.empty((self.num_rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                               device="cpu")
        for a in range(0, self.num_rows, chunk):
            b = min(a + chunk, self.num_rows)
            part = self.fetch(local, a, b, tag)
            if full is not None:
                full[a:b].copy_(part)
            del part  # one chunk at a time
        return full
