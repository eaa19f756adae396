"""Dense optimizer construction (port of ``mhrec_tpu/trainer/optim.py``
without optax).

* ``freeze_prefix`` — parameters whose dotted name starts with a prefix get
  no update (reference trainer.py:185-203);
* the modal / rec split, when ``optim_args`` holds ``modal_lr``,
  ``modal_decay``, ``rec_lr`` and ``rec_decay``: parameters whose dotted
  name holds ``decay_check_name`` (default ``visual_encoder``) take the
  modal learning rate and weight decay, the rest the rec ones
  (trainer.py:226-267);
* ``lr_mult_prefix`` × ``lr_mult_rate`` — a high-learning-rate group
  (trainer.py:270-291);
* under ``sparse_item_adam`` the item-embedding table is left out: the
  trainer row-updates it (``trainer/sparse_adam.py``), so no dense moments
  exist for it (matched as a dotted-name component, as in the JAX package);
* AdamW otherwise (b1 0.9, b2 0.999, eps 1e-8): ``torch.optim.AdamW``
  computes optax.adamw's update ``−lr·(mhat / (sqrt(vhat) + eps) + wd·p)``;
  each group's learning rate is set from its schedule before every step.
  On the card it is the fused implementation: one multi-tensor kernel per
  step and no temporaries the size of the parameters (the default foreach
  step allocates some, which at the HLLM towers' 2B parameters is 8 GB a
  set).

With ``adam_mu_dtype`` / ``adam_nu_dtype`` set (``bfloat16`` halves that
moment's memory) the optimizer is ``AdamWCast``: the JAX package's AdamW
with moment storage types (optax's ``mu_dtype``, and its own
``_scale_by_adam_cast`` once ``nu`` has a type, optim.py:41-83), the math in
float32 and each moment rounded to its type when stored. The JAX package
computes it in XLA with no kernel; here it is ``torch._foreach`` arithmetic
over buckets of parameters, which bounds the float32 temporaries.

Global-norm gradient clipping (``clip_grad_norm``) is ``clip_grad_norm``
below, applied to the dense gradients only (the row-sparse table gradients
bypass it, as in the JAX package).

In a process group of more than one rank (``shard_optimizer_state``, on by
default there, as in the JAX package) the optimizer is a
``ZeroShardedOptimizer``: ZeRO-2's sharded optimizer state, each
parameter's moments on one rank. Under FSDP (``parallel/fsdp.py``) the
sharded parameters are blocks and every rank steps its own: their moments
are blocks too, and ZeRO-2's owners and broadcasts cover only the
parameters that stay replicated (JAX applies ZeRO to the still-replicated
leaves, trainer.py:337-350).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from mhrec_tpu_torch.parallel import comm
from mhrec_tpu_torch.parallel.mesh import zero_owners

Schedule = Callable[[int], float]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _moment_dtype(name) -> Optional[torch.dtype]:
    if not name:
        return None
    name = str(name)
    if name not in _DTYPES:
        raise ValueError(f"adam moment dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


# the most elements of one bucket of AdamWCast._update
BUCKET_NUMEL = 1 << 26


class AdamWCast(torch.optim.Optimizer):
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) whose first and second moments are
    stored in ``mu_dtype`` / ``nu_dtype`` (None: float32), with the JAX
    package's arithmetic and rounding order:

    * ``nu_dtype`` None (optax ``adamw(mu_dtype=...)``): m = (1 − b1)·g +
      b1·m_stored, the product b1·m_stored in m's stored type;
    * otherwise (``_scale_by_adam_cast``): m = b1·float(m_stored) + (1 − b1)·g,
      v = b2·float(v_stored) + (1 − b2)·g², bias corrections in float32;

    then u = m̂ / (√v̂ + eps) + wd·p and p ← p + (−lr)·u. Parameters in
    buckets of at most ``BUCKET_NUMEL`` elements go through ``_foreach``
    calls together, so the float32 temporaries stay that small."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None, nu_dtype: Optional[torch.dtype] = None,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps))
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    def load_state_dict(self, state_dict):
        """As ``Optimizer.load_state_dict``, but each moment arrives in its
        storage type: the base class would cast it to the parameter's
        float32 first, holding a float32 set of moments at once."""
        moments = ("exp_avg", "exp_avg_sq")
        rest = {k: {n: v for n, v in s.items() if n not in moments}
                for k, s in state_dict["state"].items()}
        super().load_state_dict({"state": rest, "param_groups": state_dict["param_groups"]})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            saved = state_dict["state"].get(i)
            if saved:
                for name, dtype in zip(moments, (self.mu_dtype, self.nu_dtype)):
                    self.state[p][name] = saved[name].to(p.device, dtype or torch.float32)

    def _buckets(self, params):
        bucket, n = [], 0
        for p in params:
            if bucket and n + p.numel() > BUCKET_NUMEL:
                yield bucket
                bucket, n = [], 0
            bucket.append(p)
            n += p.numel()
        if bucket:
            yield bucket

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=self.mu_dtype or torch.float32,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.nu_dtype or torch.float32,
                        memory_format=torch.preserve_format)
                st["step"] += 1
            for bucket in self._buckets(params):
                self._update(bucket, group, b1, b2)

    def _update(self, params, group, b1, b2):
        state = [self.state[p] for p in params]
        # every parameter of a group steps together
        count = state[0]["step"]
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(one - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(one - torch.tensor(b2, dtype=torch.float32) ** count)
        g = [p.grad.float() for p in params]
        ms = [s["exp_avg"] for s in state]
        vs = [s["exp_avg_sq"] for s in state]
        if self.nu_dtype is None:
            # optax: (1 - b1)·g + b1·m in m's stored type, b1 rounded to
            # that type first (a Python scalar takes the array's type in JAX);
            # v in float32
            b1_m = float(torch.tensor(b1).to(ms[0].dtype))
            m = torch._foreach_mul(g, 1.0 - b1)
            torch._foreach_add_(m, [x.float() for x in torch._foreach_mul(ms, b1_m)])
            v = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2)
            torch._foreach_add_(v, torch._foreach_mul(vs, b2))
        else:
            m = torch._foreach_mul([x.float() for x in ms], b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
            v = torch._foreach_mul([x.float() for x in vs], b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        del g
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, group["eps"])
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, denom)
        del denom
        for dst, src in ((ms, m), (vs, v)):
            for d, s in zip(dst, src):
                d.copy_(s)
        del m, v
        if group["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(params, group["weight_decay"]))
        torch._foreach_mul_(u, -group["lr"])
        torch._foreach_add_(params, u)


def _buckets(tensors, numel: int = BUCKET_NUMEL):
    """``tensors`` in runs of one dtype and at most ``numel`` elements (a
    larger tensor alone)."""
    bucket, n = [], 0
    for t in tensors:
        if bucket and (n + t.numel() > numel or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, n = [], 0
        bucket.append(t)
        n += t.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """SUM the gradients of ``params`` over the ranks, in flat buckets (one
    ``all_reduce`` each). The trainer leaves out FSDP's blocks, whose
    gradients were reduce-scattered in the backward."""
    grads = [p.grad for p in params]
    for bucket in _buckets(grads):
        flat = comm.all_reduce(_flatten_dense_tensors(bucket), "grad_all_reduce")
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)


class ZeroShardedOptimizer:
    """ZeRO-2 optimizer-state sharding over the ranks of ``mesh`` (DeepSpeed
    stage 2's sharded optimizer state; the JAX package's
    ``zero_sharded_opt_state``, trainer.py:341-350): each dense parameter's
    state lives on the one rank ``zero_owners`` gives it, whose optimizer
    (``make_optimizer`` over the groups' owned parameters) steps it on the
    SUM-all-reduced gradient and then broadcasts it to the others. The
    update is the replicated optimizer's, element for element: the same
    kernel on the same gradients. A replicated parameter's gradient is held
    whole on every rank.

    Under FSDP (``fsdp``, a ``parallel/fsdp.py::FSDP``) each rank steps
    its blocks of the sharded parameters itself, with no broadcast; so does
    it every replicated parameter when ``shard_replicated`` is false
    (``shard_optimizer_state: false``).

    ``param_groups`` are this rank's groups (the trainer sets each group's
    learning rate); ``params`` every dense parameter. ``state_dict`` (a
    collective) returns a host copy of the whole state in the replicated
    optimizer's layout, on every rank, but for the sharded parameters'
    moments, which rank 0 alone assembles (None elsewhere); so a checkpoint
    written at one world size loads at another. ``load_state_dict`` takes
    this rank's part of such a state."""

    EVERY = -1  # the owner of a parameter that every rank steps

    def __init__(self, groups, make_optimizer, mesh, fsdp=None, shard_replicated=True):
        self.mesh, self.fsdp = mesh, fsdp
        self.params = [p for g in groups for p in g["params"]]
        self.group_sizes = [len(g["params"]) for g in groups]
        self.owner = [self.EVERY] * len(self.params)
        rep = [i for i, p in enumerate(self.params) if not self._sharded(p)]
        if shard_replicated:
            for i, r in zip(rep, zero_owners([self.params[i].numel() for i in rep], mesh.world)):
                self.owner[i] = r
        mine = {id(p) for p, r in zip(self.params, self.owner) if r in (mesh.rank, self.EVERY)}
        self.optim = make_optimizer(
            [dict(g, params=[p for p in g["params"] if id(p) in mine]) for g in groups])

    def _sharded(self, p) -> bool:
        return self.fsdp is not None and self.fsdp.is_block(p)

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def state(self):
        return self.optim.state

    @torch.no_grad()
    def step(self):
        self.optim.step()
        for r in range(self.mesh.world):
            owned = [p for p, o in zip(self.params, self.owner) if o == r]
            for bucket in _buckets(owned):
                flat = comm.broadcast(_flatten_dense_tensors(bucket), r, "zero_broadcast")
                if r != self.mesh.rank:
                    for p, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                        p.copy_(v)

    def _local_params(self):
        return [p for g in self.optim.param_groups for p in g["params"]]

    def state_dict(self):
        local = self.optim.state_dict()
        index = {id(p): i for i, p in enumerate(self.params)}
        mine, blocks = {}, {}
        for li, p in enumerate(self._local_params()):
            if li not in local["state"]:
                continue
            i = index[id(p)]
            if self._sharded(p):
                blocks[i] = (p, local["state"][li])
            elif self.owner[i] == self.mesh.rank or (self.owner[i] == self.EVERY
                                                     and self.mesh.rank == 0):
                mine[i] = {k: v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v
                           for k, v in local["state"][li].items()}
        state = {}
        for part in comm.all_gather_objects(mine):
            state.update(part)
        for i in sorted(blocks):  # the same order on every rank
            p, st = blocks[i]
            entry = self.fsdp.entry_of(p)
            state[i] = {k: (self.fsdp.assemble(entry, v) if torch.is_tensor(v)
                            and v.shape == p.shape else v) for k, v in st.items()}
        groups, start = [], 0
        for g, n in zip(local["param_groups"], self.group_sizes):
            groups.append(dict(g, params=list(range(start, start + n))))
            start += n
        return {"state": dict(sorted(state.items())), "param_groups": groups}

    def load_state_dict(self, state_dict):
        index = {id(p): i for i, p in enumerate(self.params)}
        local = self._local_params()
        state = {}
        for li, p in enumerate(local):
            saved = state_dict["state"].get(index[id(p)])
            if saved is None:
                continue
            if self._sharded(p):
                entry = self.fsdp.entry_of(p)
                saved = {k: (self.fsdp.block_of(entry, v) if torch.is_tensor(v)
                             and v.shape == entry.shape else v) for k, v in saved.items()}
            state[li] = saved
        groups, li = [], 0
        for g, mine in zip(state_dict["param_groups"], self.optim.param_groups):
            groups.append(dict(g, params=list(range(li, li + len(mine["params"])))))
            li += len(mine["params"])
        self.optim.load_state_dict({"state": state, "param_groups": groups})


def _is_frozen(name: str, freeze_prefix: List[str], sparse_table: bool) -> bool:
    if any(name.startswith(p) for p in freeze_prefix):
        return True
    return sparse_table and "item_embedding" in name.split(".")


def build_optimizer(config, model: torch.nn.Module,
                    schedule_factory: Callable[[float], Schedule], mesh=None, fsdp=None,
                    shard_replicated: bool = True
                    ) -> Tuple[torch.optim.Optimizer, List[Schedule], List[torch.nn.Parameter]]:
    """Returns (optimizer, one schedule per parameter group, the frozen
    parameters). ``schedule_factory(lr)`` builds the configured schedule at
    base learning rate ``lr``. With ``mesh`` (a DataMesh) the optimizer is
    a ``ZeroShardedOptimizer`` over its ranks: the replicated parameters'
    state sharded ZeRO-2 style unless ``shard_replicated`` is false, FSDP's
    blocks (``fsdp``) stepped by each rank."""
    optim_args = dict(config["optim_args"] or {})
    split_modal = {"modal_lr", "modal_decay", "rec_lr", "rec_decay"} <= set(optim_args)
    mu_dtype = _moment_dtype(config.get("adam_mu_dtype"))
    nu_dtype = _moment_dtype(config.get("adam_nu_dtype"))
    base_lr = float(optim_args.get("learning_rate", 1e-3))
    wd = float(optim_args.get("weight_decay", 0.0))
    freeze_prefix = list(config.get("freeze_prefix", []) or [])
    sparse_table = bool(config.get("sparse_item_adam", False))
    lr_mult_prefix = list(config.get("lr_mult_prefix", []) or [])
    lr_mult_rate = config.get("lr_mult_rate", None)
    split = bool(lr_mult_prefix and lr_mult_rate)

    check = config.get("decay_check_name") or "visual_encoder"

    # (learning rate, weight decay) of each group; the modal split wins over
    # the high-learning-rate prefixes, as in the JAX package
    if split_modal:
        specs = {"modal": (float(optim_args["modal_lr"]), float(optim_args["modal_decay"])),
                 "rec": (float(optim_args["rec_lr"]), float(optim_args["rec_decay"]))}
    else:
        specs = {"normal": (base_lr, wd),
                 "high": (base_lr * float(lr_mult_rate or 1.0), wd)}
    members = {k: [] for k in specs}
    frozen = []
    for name, p in model.named_parameters():
        if _is_frozen(name, freeze_prefix, sparse_table):
            frozen.append(p)
        elif split_modal:
            members["modal" if check in name else "rec"].append(p)
        elif split and any(name.startswith(pre) for pre in lr_mult_prefix):
            members["high"].append(p)
        else:
            members["normal"].append(p)
    groups, schedules = [], []
    for key, (lr, decay) in specs.items():
        if members[key]:
            groups.append({"params": members[key], "lr": lr, "weight_decay": decay})
            schedules.append(schedule_factory(lr))
    on_card = all(p.is_cuda for g in groups for p in g["params"])

    def make(groups):
        if mu_dtype is not None or nu_dtype is not None:
            return AdamWCast(groups, lr=base_lr, weight_decay=wd, mu_dtype=mu_dtype,
                             nu_dtype=nu_dtype)
        return torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd, fused=True if on_card else None)

    opt = make(groups) if mesh is None else ZeroShardedOptimizer(
        groups, make, mesh, fsdp=fsdp, shard_replicated=shard_replicated)
    return opt, schedules, frozen


@torch.no_grad()
def clip_grad_norm(params, max_norm: float, blocks=()) -> None:
    """optax.clip_by_global_norm on the gradients of ``params``, without a
    host synchronisation: scaled by ``max_norm / norm`` when the global norm
    reaches ``max_norm``. ``blocks``: those of ``params`` that are FSDP
    blocks, whose squares are summed over the ranks (an all-reduce) before
    the replicated gradients' are added."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if not blocks:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
    else:
        ids = {id(p) for p in blocks}
        sq = [torch.stack([torch.linalg.vector_norm(p.grad) for p in group]).square().sum()
              if group else grads[0].new_zeros(())
              for group in ([p for p in params if p.grad is not None and id(p) in ids],
                            [p for p in params if p.grad is not None and id(p) not in ids])]
        norm = (comm.all_reduce(sq[0], "grad_norm") + sq[1]).sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
