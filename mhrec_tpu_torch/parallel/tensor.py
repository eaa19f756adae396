"""Tensor parallelism of the Llama towers (``tp_size > 1``) over a model
group of T ranks (``parallel/mesh.py::make_mesh``).

The JAX package has no counterpart: there the towers' kernels carry
``'model'`` partition annotations (``mhrec_tpu/models/llm/llama.py``
``_maybe_tp``: Megatron's column / row split) and GSPMD inserts the
collectives. Here each rank holds its shards and calls them itself:

* ``copy_to_model`` / ``reduce_from_model``, the autograd functions of a
  column / row-parallel pair: the first is the identity forward and sums
  its input's gradient over the model group backward; the second sums the
  row-parallel product's partials over the model group forward and is the
  identity backward. Both sum in float32 (``sum_over_model``: an
  all-reduce, which leaves every rank of the group the same bits), and the
  caller rounds to the compute type once, as one process's product does;
* ``tp_params``, JAX's rule (``trainer.py`` ``spec_ok`` / ``divisible``)
  applied to each projection of a Llama layer: a kernel is split where its
  annotated dimension divides by T and stays whole otherwise ("GQA kv heads
  (or other small dims) may not divide the mesh axis"), e.g. Qwen2-1.5B's 2
  KV heads at T = 4 keep ``k_proj`` / ``v_proj`` whole, and its 12 query
  heads at T = 8 keep ``q_proj`` whole;
* ``split_params`` (the split parameters of a model and their dimension),
  ``whole_in_split`` (the projections that stay whole inside a split
  block, whose gradients are each rank's share and are summed over the
  model group by ``sum_grads``), ``local_shard`` (a whole tensor's shard of
  this rank) and ``assemble_to_host`` (the shards of the model group into
  one whole tensor in host memory on its rank 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from mhrec_tpu_torch.parallel import comm


@dataclass(frozen=True)
class TPGroup:
    """Model rank ``rank`` of ``size`` ranks in the process group
    ``group``."""

    rank: int
    size: int
    group: Any = None


def sum_over_model(t: torch.Tensor, tp: TPGroup, tag: str) -> torch.Tensor:
    """``t`` summed over the model group in float32: an all-reduce of a
    contiguous float32 copy (a gradient may come strided), whose sum every
    rank of the group receives to the same bit (each element is reduced
    once, then sent to every rank)."""
    return comm.all_reduce(t.to(torch.float32, memory_format=torch.contiguous_format,
                                copy=True), tag, tp.group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return sum_over_model(grad, ctx.tp, "tp_input_grad").to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, tp):
        return sum_over_model(partial, tp, "tp_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` itself, its gradient
    the sum of the model ranks' (counted as ``tp_input_grad``)."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(partial: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """A row-parallel product: the ranks' float32 partials summed
    (``tp_reduce``), float32; the gradient passes through unchanged."""
    return _ReduceFromModel.apply(partial, tp)


# a Llama layer's projections: (name in the layer, the torch dimension that
# the JAX annotation splits, the config size that must divide by T)
_LLAMA_SPECS = (
    ("self_attn.q_proj.weight", 0, "heads"), ("self_attn.q_proj.bias", 0, "heads"),
    ("self_attn.k_proj.weight", 0, "kv_heads"), ("self_attn.k_proj.bias", 0, "kv_heads"),
    ("self_attn.v_proj.weight", 0, "kv_heads"), ("self_attn.v_proj.bias", 0, "kv_heads"),
    ("self_attn.o_proj.weight", 1, "hidden"),
    ("mlp.gate_proj.weight", 0, "intermediate"), ("mlp.up_proj.weight", 0, "intermediate"),
    ("mlp.down_proj.weight", 1, "intermediate"),
)


def tp_params(config, T: int) -> Dict[str, int]:
    """The projections of a Llama layer of ``config`` (an LLMConfig) that
    JAX's rule splits over T model ranks, by their name in the layer → the
    torch dimension split: q/k/v (kernel ``[D, h, dh]`` annotated ``(None,
    'model', None)``, bias ``('model', None)``) where their head count
    divides by T, ``o_proj`` (``('model', None)`` on its input) where the
    hidden width does, ``gate`` / ``up`` (``(None, 'model')``) and ``down``
    (``('model', None)``) where the intermediate width does. Biases only
    where the config has them. Empty at T = 1."""
    if T <= 1:
        return {}
    sizes = {"heads": config.num_attention_heads, "kv_heads": config.num_key_value_heads,
             "hidden": config.hidden_size, "intermediate": config.intermediate_size}
    return {name: dim for name, dim, size in _LLAMA_SPECS
            if sizes[size] % T == 0 and (config.attention_bias or not name.endswith(".bias"))}


def local_shard(whole: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    """This model rank's shard of ``whole`` along ``dim`` (a view)."""
    n = whole.shape[dim] // tp.size
    return whole.narrow(dim, tp.rank * n, n)


def split_params(model: torch.nn.Module) -> Dict[str, Tuple[int, TPGroup]]:
    """The tensor-parallel shards among ``model``'s parameters, by name →
    (the dimension split, the model group)."""
    out = {}
    for prefix, m in model.named_modules():
        for name, dim in getattr(m, "tp_split", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = (dim, m.tp)
    return out


def whole_in_split(model: torch.nn.Module) -> Dict[str, TPGroup]:
    """The parameters that stay whole inside a split block (a projection
    whose dimension JAX's rule leaves whole, before a row-parallel product
    that is split): each rank's gradient is its share of the whole one."""
    out = {}
    for prefix, m in model.named_modules():
        for name in getattr(m, "tp_whole", ()):
            out[f"{prefix}.{name}" if prefix else name] = m.tp
    return out


@torch.no_grad()
def sum_grads(params: List[torch.nn.Parameter], tp: TPGroup) -> None:
    """Each gradient of ``params`` summed over the model group (in float32;
    ``tp_whole_grad``), in place."""
    for p in params:
        if p.grad is not None:
            p.grad.copy_(sum_over_model(p.grad, tp, "tp_whole_grad"))


@torch.no_grad()
def assemble_to_host(shard: Optional[torch.Tensor], dim: int, tp: TPGroup,
                     device=None, tag: str = "tp_save") -> Optional[torch.Tensor]:
    """The whole tensor whose shard on each model rank is ``shard``,
    concatenated along ``dim`` in host memory on model rank 0 (None on the
    others): each rank broadcasts its shard in turn (on ``device``, the
    parameters' device, so that any backend carries it), so no device holds
    more than one shard beside its own."""
    parts = []
    for r in range(tp.size):
        if r == tp.rank:
            buf = shard.detach().to(device).clone()
        else:
            buf = torch.empty(shard.shape, dtype=shard.dtype, device=device)
        comm.broadcast(buf, r, tag, tp.group)
        if tp.rank == 0:
            parts.append(buf.cpu())
        del buf
    return torch.cat(parts, dim) if tp.rank == 0 else None
