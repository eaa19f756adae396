"""Dense optimizer construction (port of ``mhrec_tpu/trainer/optim.py``
without optax).

* ``freeze_prefix`` — parameters whose dotted name starts with a prefix get
  no update (reference trainer.py:185-203);
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

Global-norm gradient clipping (``clip_grad_norm``) is ``clip_grad_norm``
below, applied to the dense gradients only (the row-sparse table gradients
bypass it, as in the JAX package). Not ported yet: the modal / rec split
(``modal_lr`` …) and the moment storage types ``adam_mu_dtype`` /
``adam_nu_dtype``.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

Schedule = Callable[[int], float]


def _is_frozen(name: str, freeze_prefix: List[str], sparse_table: bool) -> bool:
    if any(name.startswith(p) for p in freeze_prefix):
        return True
    return sparse_table and "item_embedding" in name.split(".")


def build_optimizer(config, model: torch.nn.Module,
                    schedule_factory: Callable[[float], Schedule]
                    ) -> Tuple[torch.optim.AdamW, List[Schedule], List[torch.nn.Parameter]]:
    """Returns (optimizer, one schedule per parameter group, the frozen
    parameters). ``schedule_factory(lr)`` builds the configured schedule at
    base learning rate ``lr``."""
    optim_args = dict(config["optim_args"] or {})
    if {"modal_lr", "modal_decay", "rec_lr", "rec_decay"} <= set(optim_args):
        raise NotImplementedError("the modal / rec learning-rate split is not ported yet")
    if config.get("adam_mu_dtype") or config.get("adam_nu_dtype"):
        raise NotImplementedError("adam_mu_dtype / adam_nu_dtype are not ported yet")
    base_lr = float(optim_args.get("learning_rate", 1e-3))
    wd = float(optim_args.get("weight_decay", 0.0))
    freeze_prefix = list(config.get("freeze_prefix", []) or [])
    sparse_table = bool(config.get("sparse_item_adam", False))
    lr_mult_prefix = list(config.get("lr_mult_prefix", []) or [])
    lr_mult_rate = config.get("lr_mult_rate", None)
    split = bool(lr_mult_prefix and lr_mult_rate)

    normal, high, frozen = [], [], []
    for name, p in model.named_parameters():
        if _is_frozen(name, freeze_prefix, sparse_table):
            frozen.append(p)
        elif split and any(name.startswith(pre) for pre in lr_mult_prefix):
            high.append(p)
        else:
            normal.append(p)
    groups, schedules = [], []
    for params, lr in ((normal, base_lr), (high, base_lr * float(lr_mult_rate or 1.0))):
        if params:
            groups.append({"params": params, "lr": lr})
            schedules.append(schedule_factory(lr))
    on_card = all(p.is_cuda for g in groups for p in g["params"])
    opt = torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd, fused=True if on_card else None)
    return opt, schedules, frozen


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients of ``params``, without a
    host synchronisation: scaled by ``max_norm / norm`` when the global norm
    reaches ``max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
