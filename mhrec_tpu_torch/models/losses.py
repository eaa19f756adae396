"""Multi-horizon InfoNCE with false-negative masking (port of
``mhrec_tpu/models/losses.py``).

Math of the reference loss (``hstu.py:600-872``): per token a cosine
positive logit and ``out·negᵀ`` negative logits, negatives whose similarity
to the target exceeds ``nce_thres`` removed (false negatives), a learnable
temperature clamped to ``[0, ln 100]``, token cross-entropy with the
positive at index 0; per prediction offset ``p`` a masked mean over valid
tokens, then a normalized geometric horizon discount. Empty masks
contribute zero.

Two formulations, as in the JAX package: ``banded`` (default) computes every
offset's partition sum with one banded product against the complement of
the false-negative indicator; ``per_offset`` runs one masked logsumexp per
offset. The large ``[B, L, M]`` logit tables are bfloat16 products with
float32 sums rounded to bfloat16, as in the JAX package; the banded
partition-sum product keeps float32 sums (here: float32 products of the
bfloat16 values, which are exact). ``multi_horizon_nce_stacked`` is the
category-stacked banded form of the prior loss (``prior_loss_impl:
stacked``), each category's slice computed as ``_banded_nce`` computes it.

Over W > 1 ranks (``mesh``) the negatives are the gathered global pool and
the products against it are ``_PoolProduct``'s: the pool's gradient of each
product is summed over the ranks in float32 and then rounded to bfloat16,
as one process rounds the global batch's sum once. Summing the ranks'
rounded partial gradients instead would put a bfloat16 rounding between
the data-parallel run and one process over the composed batch (JAX's one
SPMD program), which Adam turns into steps of its learning rate wherever a
gradient is near zero. The model's gather (``DataMesh.all_gather_rows``)
hands each rank its block of the summed gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mhrec_tpu_torch.models.layers import cosine_normalize

_LN100 = 4.605170185988092  # np.log(100)
_BF16 = torch.bfloat16
_F32_MIN = torch.finfo(torch.float32).min


def logit_scale_param(module: torch.nn.Module, fix_temp: bool, init: float):
    """Give ``module`` its NCE temperature's log ``logit_scale``: a buffer at
    ln(1/0.05) under ``fix_temp`` (the clamp of it is its ``exp``), else a
    parameter at ``init``."""
    if fix_temp:
        module.register_buffer("logit_scale", torch.tensor(np.log(1 / 0.05), dtype=torch.float32))
    else:
        module.logit_scale = torch.nn.Parameter(torch.tensor(init))


def clamp_logit_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """Straight-through clamp to [0, ln 100] then exp (hstu.py:600-603): the
    forward uses the clamped value, the gradient passes as if unclamped."""
    ste = logit_scale + (torch.clamp(logit_scale, 0.0, _LN100) - logit_scale).detach()
    return torch.exp(ste)


def global_count(cnt: torch.Tensor, mesh=None) -> torch.Tensor:
    """``cnt`` summed over the ranks of ``mesh`` (a detached copy, one
    collective); ``cnt`` itself without one."""
    return cnt if mesh is None else mesh.all_reduce(cnt.detach().clone(), "loss_counts")


class _SumGrad(torch.autograd.Function):
    """The identity; backward, the gradient summed over the ranks of
    ``mesh`` (one all-reduce, ``pool_gather_grad``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone(), "pool_gather_grad"), None


def gathered_pool(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The global batch's negative pool from this rank's rows ``x`` [n, ...]:
    every rank's rows in rank order (``x`` itself without ``mesh``).
    Backward, the pool's float32 gradient is summed over the ranks before
    this rank takes its block, as one process's products over the global
    batch sum it. The baselines' pools take it, which float32 products
    consume; HSTU's and HLLM's bfloat16 products sum the gradient
    themselves (``_PoolProduct``)."""
    if mesh is None:
        return x
    return _SumGrad.apply(mesh.all_gather_rows(x, "pool_gather"), mesh)


def _bf16_product(a, b):
    """``a @ b`` of the bfloat16-rounded operands with float32 sums, rounded
    to bfloat16 (JAX: bf16 einsum with ``preferred_element_type=f32``, then
    ``.astype(bf16)``)."""
    return torch.matmul(a.to(_BF16), b.to(_BF16))


class _PoolProduct(torch.autograd.Function):
    """``einsum(eq, a, pool)`` of the bfloat16-rounded operands, rounded to
    bfloat16 (``_bf16_product``'s forward), against the negative pool
    gathered over the ranks of ``mesh``. Backward, ``a`` takes the bf16
    gradient autograd gives it; the pool takes its float32 gradient summed
    over the ranks (one all-reduce, ``pool_gather_grad``) and then rounded
    to bfloat16, the sum one process rounds."""

    @staticmethod
    def forward(ctx, a, pool, eq, mesh):
        a16, p16 = a.to(_BF16), pool.to(_BF16)
        ctx.save_for_backward(a16, p16)
        ins, out = eq.split("->")
        sa, sp = ins.split(",")
        ctx.eqs = (f"{out},{sp}->{sa}", f"{out},{sa}->{sp}")
        ctx.mesh, ctx.a_dtype = mesh, a.dtype
        return torch.einsum(eq, a16, p16)

    @staticmethod
    def backward(ctx, grad):
        a16, p16 = ctx.saved_tensors
        eq_a, eq_pool = ctx.eqs
        g_a = torch.einsum(eq_a, grad, p16).to(ctx.a_dtype)
        g_pool = torch.einsum(eq_pool, grad.float(), a16.float()).contiguous()
        g_pool = ctx.mesh.all_reduce(g_pool, "pool_gather_grad")
        return g_a, g_pool.to(_BF16).float(), None, None


def _neg_product(a, pool, eq, mesh, plain):
    """The bf16 logit product of ``a`` against the negative pool: ``plain()``
    in one process (and in a group of one rank), ``_PoolProduct`` over W > 1
    ranks."""
    if mesh is None or mesh.world == 1:
        return plain()
    return _PoolProduct.apply(a, pool, eq, mesh)


def multi_horizon_nce(
    head_embs: torch.Tensor,        # [B, H, L, D] raw head outputs
    target_embs: torch.Tensor,      # [B, L+P, D] item embeddings of the window
    neg_embs_norm: torch.Tensor,    # [M, D], already L2-normalized
    base_mask: torch.Tensor,        # [B, P, L] bool: valid (non-pad) tokens
    head_for_pred,                  # [P] int: which head serves offset p
    horizon_discount: torch.Tensor,  # [P] float, normalized
    logit_scale: torch.Tensor,      # scalar param (pre-exp)
    nce_thres: float,
    loss_weight: float = 1.0,
    extra_mask: Optional[torch.Tensor] = None,  # [B, P, L] e.g. category mask
    compute_topk_log: bool = False,
    impl: str = "banded",
    inputs_normalized: bool = False,
    mesh=None,                      # the data-parallel group, or None
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, per_pred_loss [P], log_dict)."""
    if inputs_normalized:
        heads_norm, tgt_norm = head_embs.float(), target_embs.float()
    else:
        heads_norm = cosine_normalize(head_embs.float())
        tgt_norm = cosine_normalize(target_embs.float())
    args = (heads_norm, tgt_norm, neg_embs_norm, base_mask,
            [int(h) for h in head_for_pred], horizon_discount, logit_scale, nce_thres,
            loss_weight, extra_mask, compute_topk_log, mesh)
    if impl == "banded":
        return _banded_nce(*args)
    if impl == "per_offset":
        return _per_offset_nce(*args)
    raise ValueError(f"nce_impl must be banded | per_offset, got {impl!r}")


def _per_offset_nce(heads_norm, tgt_norm, neg_embs_norm, base_mask, head_for_pred,
                    horizon_discount, logit_scale, nce_thres, loss_weight, extra_mask,
                    compute_topk_log, mesh=None):
    L = heads_norm.shape[2]
    P = base_mask.shape[1]
    scale = clamp_logit_scale(logit_scale).float()
    neg_T = neg_embs_norm.to(_BF16).t()
    raw_neg = {h: _neg_product(heads_norm[:, h], neg_embs_norm, "bld,md->blm", mesh,
                               lambda h=h: _bf16_product(heads_norm[:, h], neg_T))
               for h in sorted(set(head_for_pred))}
    # false-negative table for all offsets at once: tgt[l+1 .. L+P-1] · negᵀ
    tgt_neg = _bf16_product(tgt_norm[:, 1:], neg_T)          # [B, L+P-1, M]
    mask_full = base_mask if extra_mask is None else (base_mask & extra_mask)
    per_pred_loss = []
    log_dict: Dict[str, torch.Tensor] = {}
    for p in range(P):
        h = head_for_pred[p]
        pos_logit = (heads_norm[:, h] * tgt_norm[:, p + 1: p + 1 + L]).sum(-1)  # [B, L]
        fix = tgt_neg[:, p: p + L]                            # [B, L, M]
        m = mask_full[:, p].float()
        neg_logits = torch.where(fix > nce_thres, _F32_MIN, raw_neg[h].float())
        lse = torch.logaddexp(pos_logit * scale, torch.logsumexp(neg_logits * scale, dim=-1))
        tok_ce = lse - pos_logit * scale
        cnt = torch.clamp(global_count(m.sum(), mesh), min=1.0)
        mean_p = (tok_ce * m).sum() / cnt
        per_pred_loss.append(horizon_discount[p] * loss_weight * mean_p)
        if compute_topk_log and p == 0:
            with torch.no_grad():
                masked = torch.where(fix > nce_thres, _F32_MIN, raw_neg[h].float())
                n_unmasked = (masked > _F32_MIN / 100).sum(-1).float() + 1.0
                log_dict["nce_samples"] = (n_unmasked * m).sum() / cnt
                beaten = (masked > pos_logit[:, :, None]).sum(-1)
                for kk in (1, 5, 10, 50, 100):
                    if kk > masked.shape[-1] + 1:
                        break
                    log_dict[f"nce_top{kk}_acc"] = ((beaten < kk).float() * m).sum() / cnt
    per_pred = torch.stack(per_pred_loss)
    return per_pred.sum(), per_pred, log_dict


def _banded_nce(heads_norm, tgt_norm, neg_embs_norm, base_mask, head_for_pred,
                horizon_discount, logit_scale, nce_thres, loss_weight, extra_mask,
                compute_topk_log, mesh=None):
    """One-product multi-horizon NCE (the JAX package's ``_banded_nce``,
    losses.py:148-298, whose docstring derives it): masking only removes
    terms from the partition sum, and every offset's false-negative mask is
    a shifted slice of one indicator ``G[b, j, m] = (tgt_j · neg_m >
    thres)``, so ``kept[b, h, l, j] = Σ_m exp(scaled − shift)·(1 − G)`` gives
    every offset's partition sum at ``j = l + p``. The shift is the row max
    lowered by a headroom that keeps ``M·e^C`` finite in float32."""
    B, _, L, _ = heads_norm.shape
    P = base_mask.shape[1]
    scale = clamp_logit_scale(logit_scale).float()
    neg_T = neg_embs_norm.to(_BF16).t()                       # [D, M]
    tgtJ = tgt_norm[:, 1:]                                    # [B, J, D]
    with torch.no_grad():  # no gradient flows through a mask
        keep_ind = (_bf16_product(tgtJ, neg_T) <= nce_thres).float()  # [B, J, M]
    band = (torch.arange(L, device=heads_norm.device)[:, None]
            + torch.arange(P, device=heads_norm.device)[None, :])       # [L, P]
    M = neg_embs_norm.shape[0]
    headroom = min(70.0, 86.7 - float(np.log(max(M, 1))))

    distinct = sorted(set(head_for_pred))
    Hd = len(distinct)
    outs = heads_norm[:, distinct]                            # [B, Hd, L, D]
    raw_all = _neg_product(outs, neg_embs_norm, "bhld,md->bhlm", mesh,
                           lambda: _bf16_product(outs, neg_T))  # [B, Hd, L, M]
    scaled = raw_all.float() * scale
    shift = scaled.max(dim=-1).values.detach() - headroom     # [B, Hd, L]
    s = torch.exp(scaled - shift[..., None]).to(_BF16)
    J = tgtJ.shape[1]
    kept = torch.bmm(s.float().reshape(B, Hd * L, M),
                     keep_ind.transpose(1, 2)).reshape(B, Hd, L, J)
    kept_b_all = torch.gather(kept, 3, band.expand(B, Hd, L, P))        # [B, Hd, L, P]
    lse_neg_h = shift[..., None] + torch.log(torch.clamp(kept_b_all, min=1e-30))
    if L <= 7 * P:
        pos_full = torch.bmm(outs.reshape(B, Hd * L, -1),
                             tgtJ.transpose(1, 2)).reshape(B, Hd, L, J)
        pos_band_h = torch.gather(pos_full, 3, band.expand(B, Hd, L, P))
    else:
        pos_band_h = torch.stack(
            [(outs * tgtJ[:, None, p: p + L]).sum(-1) for p in range(P)], dim=-1)
    slot = {h: i for i, h in enumerate(distinct)}

    mask_full = base_mask if extra_mask is None else (base_mask & extra_mask)
    m = mask_full.float()                                     # [B, P, L]
    lse_neg_all = torch.stack([lse_neg_h[:, slot[h], :, p] for p, h in enumerate(head_for_pred)], 1)
    pos_all = torch.stack([pos_band_h[:, slot[h], :, p] for p, h in enumerate(head_for_pred)], 1)
    lse = torch.logaddexp(pos_all * scale, lse_neg_all)
    tok_ce = lse - pos_all * scale
    cnt = global_count(m.sum(dim=(0, 2)), mesh)
    per_pred_mean = (tok_ce * m).sum(dim=(0, 2)) / torch.clamp(cnt, min=1.0)
    per_pred = horizon_discount * loss_weight * per_pred_mean

    log_dict: Dict[str, torch.Tensor] = {}
    if compute_topk_log:
        with torch.no_grad():
            h0 = slot[head_for_pred[0]]
            raw0 = raw_all[:, h0].float()
            k0 = keep_ind[:, :L].bool()                       # offset p=0 slice
            m0 = m[:, 0]
            cnt0 = torch.clamp(global_count(m0.sum(), mesh), min=1.0)
            n_unmasked = k0.sum(-1).float() + 1.0
            log_dict["nce_samples"] = (n_unmasked * m0).sum() / cnt0
            under = ((kept_b_all[:, h0, :, 0] <= 0.0) & (n_unmasked > 1.0)).float()
            log_dict["nce_underflow_rate"] = (under * m0).sum() / cnt0
            beaten = ((raw0 > pos_all[:, 0, :, None]) & k0).sum(-1)
            for kk in (1, 5, 10, 50, 100):
                if kk > raw0.shape[-1] + 1:
                    break
                log_dict[f"nce_top{kk}_acc"] = ((beaten < kk).float() * m0).sum() / cnt0
    return per_pred.sum(), per_pred, log_dict


def multi_horizon_nce_stacked(
    heads_norm: torch.Tensor,       # [B, H, L, D] L2-normalized head outputs
    tgt_norm: torch.Tensor,         # [B, L+P, D] L2-normalized targets
    neg_stack: torch.Tensor,        # [C, M, D] per-category negatives, or [1, M, D] shared
    base_mask: torch.Tensor,        # [B, P, L] bool
    extra_masks: torch.Tensor,      # [C, B, P, L] bool per-category windows
    head_for_cat,                   # [C] int: the one head serving category c
    horizon_discount: torch.Tensor,  # [P]
    logit_scale: torch.Tensor,
    nce_thres: float,
    loss_weights,                   # [C]
    compute_topk_log: bool = False,
    mesh=None,                      # the data-parallel group, or None
):
    """Category-stacked banded NCE (the JAX package's
    ``multi_horizon_nce_stacked``, losses.py:301-432). When every category
    is served by one head (additive interaction), the prior loss's
    per-category raw, false-negative and kept products become three
    category-batched ones with each slice's math that of ``_banded_nce``;
    with shared negatives ([1, M, D]) the false-negative indicator is
    computed once. Returns (total, per_pred [P], per_cat [C], log_dict),
    per_cat[c] the discounted, weighted loss of category c (the loop's
    ``loss_c``)."""
    B, _, L, _ = heads_norm.shape
    P = base_mask.shape[1]
    shared_negs = neg_stack.shape[0] == 1
    scale = clamp_logit_scale(logit_scale).float()
    dev = heads_norm.device
    tgtJ = tgt_norm[:, 1:]                                    # [B, J, D]
    outs = heads_norm[:, [int(h) for h in head_for_cat]].transpose(0, 1)  # [C, B, L, D]
    # einsums, not broadcast matmuls: a broadcast batch operand would be
    # copied once per category (or per batch row)
    negs = neg_stack.to(_BF16)                                # [C|1, M, D]
    if shared_negs:
        raw = _neg_product(outs, neg_stack[0], "cbld,md->cblm", mesh,
                           lambda: torch.einsum("cbld,md->cblm", outs.to(_BF16), negs[0]))
    else:
        raw = _neg_product(outs, neg_stack, "cbld,cmd->cblm", mesh,
                           lambda: torch.einsum("cbld,cmd->cblm", outs.to(_BF16),
                                                negs))        # [C, B, L, M]
    with torch.no_grad():  # no gradient flows through a mask
        if shared_negs:
            tgt_neg = torch.einsum("bjd,md->bjm", tgtJ.to(_BF16), negs[0])
        else:
            tgt_neg = torch.einsum("bjd,cmd->cbjm", tgtJ.to(_BF16), negs)
        keep_ind = (tgt_neg <= nce_thres).float()             # [B|C,B, J, M]
    M = neg_stack.shape[1]
    headroom = min(70.0, 86.7 - float(np.log(max(M, 1))))
    scaled = raw.float() * scale
    shift = scaled.max(dim=-1).values.detach() - headroom     # [C, B, L]
    s = torch.exp(scaled - shift[..., None]).to(_BF16)
    kept = torch.einsum("cblm,bjm->cblj" if shared_negs else "cblm,cbjm->cblj",
                        s.float(), keep_ind)                  # [C, B, L, J]
    band = (torch.arange(L, device=dev)[:, None] + torch.arange(P, device=dev)[None, :])
    C = outs.shape[0]
    kept_b = torch.gather(kept, 3, band.expand(C, B, L, P))   # [C, B, L, P]
    lse_neg = shift[..., None] + torch.log(torch.clamp(kept_b, min=1e-30))
    if L <= 7 * P:
        pos_full = torch.einsum("cbld,bjd->cblj", outs, tgtJ)
        pos_band = torch.gather(pos_full, 3, band.expand(C, B, L, P))
    else:
        pos_band = torch.stack(
            [(outs * tgtJ[None, :, p: p + L]).sum(-1) for p in range(P)], dim=-1)
    lse = torch.logaddexp(pos_band * scale, lse_neg)
    tok_ce = lse - pos_band * scale                           # [C, B, L, P]
    m = (base_mask[None] & extra_masks).float().transpose(2, 3)  # [C, B, L, P]
    cnt = global_count(m.sum(dim=(1, 2)), mesh)               # [C, P]
    per_cp = (tok_ce * m).sum(dim=(1, 2)) / torch.clamp(cnt, min=1.0)
    lw = torch.as_tensor(np.asarray(loss_weights, np.float32), device=dev)
    per_cp = horizon_discount[None, :] * lw[:, None] * per_cp  # [C, P]
    per_cat = per_cp.sum(dim=1)
    per_pred = per_cp.sum(dim=0)

    log_dict: Dict[str, torch.Tensor] = {}
    if compute_topk_log:
        with torch.no_grad():
            raw0 = raw[0].float()
            k0 = (keep_ind if shared_negs else keep_ind[0])[:, :L].bool()
            m0 = m[0, :, :, 0]                                # [B, L]
            cnt0 = torch.clamp(global_count(m0.sum(), mesh), min=1.0)
            n_unmasked = k0.sum(-1).float() + 1.0
            log_dict["nce_samples"] = (n_unmasked * m0).sum() / cnt0
            under = ((kept_b[0, :, :, 0] <= 0.0) & (n_unmasked > 1.0)).float()
            log_dict["nce_underflow_rate"] = (under * m0).sum() / cnt0
            beaten = ((raw0 > pos_band[0, :, :, 0, None]) & k0).sum(-1)
            for kk in (1, 5, 10, 50, 100):
                if kk > raw0.shape[-1] + 1:
                    break
                log_dict[f"nce_top{kk}_acc"] = ((beaten < kk).float() * m0).sum() / cnt0
    return per_cp.sum(), per_pred, per_cat, log_dict


def horizon_discount(medusa_lambda: float, pred_len: int, device=None) -> torch.Tensor:
    """Normalized geometric discount over the prediction offsets
    (reference hstu.py:436-438)."""
    d = torch.tensor([medusa_lambda ** p for p in range(pred_len)], dtype=torch.float32,
                     device=device)
    return d / d.sum()

