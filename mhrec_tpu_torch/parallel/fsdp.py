"""Fully sharded data parallelism, ZeRO-3 (the JAX package's ``fsdp`` or
``zero_stage >= 3`` with ``fsdp_min_size``, trainer.py:284-330; the
reference's DeepSpeed stage 3).

Each parameter that ``mesh.fsdp_params`` picks is stored as this rank's
block over the W ranks of its data group: the parameter (under tensor
parallelism this rank's shard of it, JAX's "the 'data' axis takes a dim
the TP spec left free") flattened, padded with zeros to a multiple of W
elements, and elements [r·n, (r+1)·n) of that, a ``Parameter`` of n
elements under the parameter's own name. So the optimizer's groups, the
freeze and learning-rate prefixes and the state dict's keys stay as they
were, and the optimizer steps the blocks: a sharded parameter's moments
are 1/W of it on each rank, as JAX's optimizer state inherits the
parameter's sharding.

A *unit* is what is gathered at once. Each layer of a stack is one: the
elements of a module list named ``layers``, ``stu_layers`` or ``blocks``
(HSTU's STU layers, the llama, BERT and vision towers' layers, the
baselines' trunks). The model is the unit of every other sharded parameter
(the embedding tables, the heads), since its forward reads them. A unit is
split further by dtype (one flat buffer a collective).

* Forward: a pre-hook all-gathers the unit's blocks in one collective
  (``fsdp_gather``) through ``_Gather`` and puts each whole parameter where
  its module reads it; a post-hook puts the blocks back. While the model's
  forward runs, a ``saved_tensors_hooks`` pair stores a token in place of
  every saved whole parameter (or view of one), so nothing holds a whole
  parameter after its module's forward.
* Backward: the first token of a gather that autograd unpacks gathers the
  unit again, once for all its tokens. A layer under gradient
  checkpointing saves nothing of it (the checkpoint's hooks are innermost);
  its recompute runs the layer's forward again to its end (the
  checkpoint's early stop is off while the model's forward runs), pre-hook,
  gather and post-hook included. ``_Gather``'s backward runs once the
  unit's whole gradients are complete: it reduce-scatters them (SUM, one
  collective, ``fsdp_reduce_scatter``) into the blocks' gradients and drops
  the second gather. So no whole gradient of a sharded parameter outlives its unit's
  backward.
* ``gathered()``: every unit whole at once, without gradients, for an
  evaluation, which runs no collective per layer: the ranks' evaluations
  may take different numbers of batches.
* ``assemble`` / ``block_of``: a whole parameter (or moment) in rank 0's host
  memory from the ranks' blocks, one block at a time (a broadcast from each
  rank, ``fsdp_save``), and this rank's block of a whole one.
* ``live_whole()``: how many whole parameters and whole gradients that a
  gather or a backward made are alive (0 between steps).
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.autograd.function import once_differentiable

from mhrec_tpu_torch.parallel import comm
from mhrec_tpu_torch.parallel.mesh import DataMesh, fsdp_params

# the module lists whose elements are units of their own
LAYER_LISTS = ("layers", "stu_layers", "blocks")


@dataclass
class _Entry:
    """One sharded parameter: its name, the (module, attribute) pairs that
    hold it, its whole shape and its block."""

    name: str
    owners: List[Tuple[torch.nn.Module, str]]
    shape: torch.Size
    numel: int
    n: int  # the block's elements
    block: torch.nn.Parameter = None


@dataclass
class _Unit:
    """The entries that one module's forward gathers at once (one
    dtype)."""

    fsdp: "FSDP"
    module: torch.nn.Module
    entries: List[_Entry]
    whole: Optional[list] = None  # set inside gathered()
    calls: list = field(default_factory=list)  # the forwards in flight

    def blocks(self):
        return [e.block for e in self.entries]

    def gather_whole(self, blocks) -> List[torch.Tensor]:
        """The whole parameters from every rank's blocks (one collective)."""
        W = self.fsdp.world
        flat = blocks[0] if len(blocks) == 1 else torch.cat(list(blocks))
        grid = comm.all_gather_flat(flat.detach(), "fsdp_gather", self.fsdp.group).view(W, -1)
        fulls, off = [], 0
        for e in self.entries:
            # one entry: a view of the gathered tensor; several: a copy each
            part = grid[:, off:off + e.n].reshape(-1)
            fulls.append(part[:e.numel].view(e.shape))
            off += e.n
        for t in fulls:
            self.fsdp.track(t)
        return fulls

    def scatter_grads(self, grads) -> List[torch.Tensor]:
        """The blocks' gradients: the whole gradients ``grads`` (None: zero)
        SUM-reduce-scattered over the ranks (one collective)."""
        W = self.fsdp.world
        parts = []
        for e, g in zip(self.entries, grads):
            if g is None:
                g = e.block.new_zeros(e.shape)
            self.fsdp.track(g)
            flat = F.pad(g.reshape(-1), (0, W * e.n - e.numel))
            parts.append(flat.view(W, e.n))
        flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        block = comm.reduce_scatter(flat.reshape(-1), "fsdp_reduce_scatter", self.fsdp.group)
        return list(block.split([e.n for e in self.entries]))

    def put(self, fulls):
        """The whole parameters where the modules read them."""
        for e, f in zip(self.entries, fulls):
            for m, attr in e.owners:
                m._parameters[attr] = None  # keeps the key's place
                m.__dict__[attr] = f

    def restore(self):
        for e in self.entries:
            for m, attr in e.owners:
                m.__dict__.pop(attr, None)
                m._parameters[attr] = e.block


class _Call:
    """One forward of a unit: its second gather for the backward, made at
    the first unpack and dropped by ``_Gather``'s backward."""

    def __init__(self, unit: _Unit):
        self.unit = unit
        self.again = None

    def regather(self) -> List[torch.Tensor]:
        if self.again is None:
            with torch.no_grad():
                self.again = self.unit.gather_whole(self.unit.blocks())
        return self.again


class _Gather(torch.autograd.Function):
    """Blocks → whole parameters (all-gather); whole gradients → the blocks'
    (reduce-scatter)."""

    @staticmethod
    def forward(ctx, call, *blocks):
        ctx.call = call
        return tuple(call.unit.gather_whole(blocks))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        call = ctx.call
        out = call.unit.scatter_grads(grads)
        call.again = None
        return (None, *out)


@dataclass
class _Token:
    """A saved whole parameter, by the gather that made it and its view."""

    call: _Call
    index: int
    size: torch.Size
    stride: tuple
    offset: int


class FSDP:
    """The sharded parameters of ``model`` over the ranks of ``mesh``:
    ``names`` (``mesh.fsdp_params``'s choice) become blocks, hooked into
    their units' forwards. Every method that moves data is a collective,
    called by every rank in the same order."""

    def __init__(self, model: torch.nn.Module, names: List[str], mesh: DataMesh):
        self.model = model
        self.rank, self.world, self.group = mesh.rank, mesh.world, mesh.group
        self._live: Dict[int, weakref.ref] = {}
        self._saved: Dict[int, Tuple[_Call, int]] = {}  # storage address → gather
        self._packing = None
        params = dict(model.named_parameters())
        holders: Dict[int, list] = {}
        for m in model.modules():
            for attr, p in m._parameters.items():
                if p is not None and (m, attr) not in holders.setdefault(id(p), []):
                    holders[id(p)].append((m, attr))
        modules = dict(model.named_modules())
        units: Dict[tuple, _Unit] = {}
        self.entries: Dict[str, _Entry] = {}
        for name in names:
            p = params[name]
            numel = p.numel()
            e = _Entry(name, holders[id(p)], p.shape, numel, -(-numel // self.world))
            flat = F.pad(p.detach().reshape(-1), (0, self.world * e.n - numel))
            e.block = torch.nn.Parameter(flat[self.rank * e.n:(self.rank + 1) * e.n].clone(),
                                         requires_grad=p.requires_grad)
            path = self._unit_path(name)
            for m, attr in e.owners:
                m._parameters[attr] = e.block
            key = (path, p.dtype)
            if key not in units:
                units[key] = _Unit(self, modules[path], [])
            units[key].entries.append(e)
            self.entries[name] = e
        del params, p
        self.units = list(units.values())
        self._by_block = {id(e.block): e for e in self.entries.values()}
        # the root's packing hooks around every unit's: pushed first, popped last
        model.register_forward_pre_hook(self._push_packing, prepend=True)
        for u in self.units:
            u.module.register_forward_pre_hook(self._pre(u))
            u.module.register_forward_hook(self._post(u))
        model.register_forward_hook(self._pop_packing)

    @staticmethod
    def _unit_path(name: str) -> str:
        """The module path of the unit of parameter ``name``: the outermost
        element of a layer list on its path, else the model ("")."""
        parts = name.split(".")
        for i in range(len(parts) - 2):
            if parts[i] in LAYER_LISTS and parts[i + 1].isdigit():
                return ".".join(parts[:i + 2])
        return ""

    # -- the forward and the backward ---------------------------------------
    def _pre(self, u: _Unit):
        def hook(module, args):
            if u.whole is not None:
                return
            call = _Call(u)
            fulls = _Gather.apply(call, *u.blocks())
            u.put(fulls)
            ptrs = []
            if self._packing is not None:
                for i, f in enumerate(fulls):
                    ptr = f.untyped_storage().data_ptr()
                    self._saved[ptr] = (call, i)
                    ptrs.append(ptr)
            u.calls.append(ptrs)
        return hook

    def _post(self, u: _Unit):
        def hook(module, args, output):
            if u.whole is not None:
                return
            for ptr in u.calls.pop():
                self._saved.pop(ptr, None)
            u.restore()
        return hook

    def _push_packing(self, module, args):
        if torch.is_grad_enabled() and self._packing is None and not self.whole:
            # a checkpointed layer's recompute runs to its end, post-hook
            # included (the early stop would leave its parameters whole)
            self._packing = (torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack),
                             torch.utils.checkpoint.set_checkpoint_early_stop(False))
            for cm in self._packing:
                cm.__enter__()

    def _pop_packing(self, module, args, output):
        if self._packing is not None:
            for cm in reversed(self._packing):
                cm.__exit__(None, None, None)
            self._packing = None

    def _pack(self, t):
        if t.layout == torch.strided and t.device.type != "meta":
            hit = self._saved.get(t.untyped_storage().data_ptr())
            if hit is not None:
                return _Token(hit[0], hit[1], t.size(), t.stride(), t.storage_offset())
        return t

    @staticmethod
    def _unpack(x):
        if isinstance(x, _Token):
            return x.call.regather()[x.index].as_strided(x.size, x.stride, x.offset)
        return x

    # -- evaluation ---------------------------------------------------------
    @property
    def whole(self) -> bool:
        return any(u.whole is not None for u in self.units)

    @contextlib.contextmanager
    def gathered(self):
        """Every sharded parameter whole, in place, without gradients, for
        the block (nested calls: the outermost gathers)."""
        if self.whole:
            yield
            return
        with torch.no_grad():
            for u in self.units:
                u.whole = u.gather_whole(u.blocks())
                u.put(u.whole)
        try:
            yield
        finally:
            for u in self.units:
                u.restore()
                u.whole = None

    # -- state --------------------------------------------------------------
    def is_block(self, p: torch.Tensor) -> bool:
        return id(p) in self._by_block

    def entry_of(self, p: torch.Tensor) -> _Entry:
        return self._by_block[id(p)]

    @torch.no_grad()
    def assemble(self, entry: _Entry, block: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole tensor of ``entry``'s shape whose block on each rank is
        ``block`` (the parameter's, or a moment's), in rank 0's host memory;
        None on the other ranks. One block at a time: rank r broadcasts its
        own, so no device holds more than a block beside its own."""
        full = None
        if self.rank == 0:
            full = torch.empty(self.world * entry.n, dtype=block.dtype, device="cpu")
        for r in range(self.world):
            buf = block.detach().clone() if r == self.rank else torch.empty_like(block)
            comm.broadcast(buf, r, "fsdp_save", self.group)
            if full is not None:
                full[r * entry.n:(r + 1) * entry.n].copy_(buf)
            del buf
        return None if full is None else full[:entry.numel].view(entry.shape)

    def block_of(self, entry: _Entry, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``whole`` (in its memory)."""
        flat = F.pad(whole.reshape(-1), (0, self.world * entry.n - entry.numel))
        return flat[self.rank * entry.n:(self.rank + 1) * entry.n]

    def track(self, t: torch.Tensor) -> None:
        key = id(t)
        self._live[key] = weakref.ref(t, lambda _, k=key: self._live.pop(k, None))

    def live_whole(self) -> int:
        """Whole parameters and gradients that a gather or a backward made
        and that are still alive."""
        return sum(1 for r in list(self._live.values()) if r() is not None)


def shard_model(model: torch.nn.Module, mesh: Optional[DataMesh], min_size: int,
                exclude=(), split=None) -> Optional[FSDP]:
    """FSDP over the data ranks of ``mesh`` of ``model``'s parameters that
    JAX's rule picks (``fsdp_params`` at ``min_size``; ``split``: the
    tensor-parallel shards, name → (dimension, model group), whose blocks
    are cut from this rank's shard), leaving out the names of ``exclude``;
    None when it picks none (one rank, or nothing large enough)."""
    if mesh is None:
        return None
    split = {n: (dim, tp.size) for n, (dim, tp) in (split or {}).items()}
    names = [n for n in fsdp_params(model.named_parameters(), mesh.world, min_size, split)
             if n not in exclude]
    return FSDP(model, names, mesh) if names else None
