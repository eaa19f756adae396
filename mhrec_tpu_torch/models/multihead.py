"""Multi-head ("medusa") decoding and the prior losses (port of
``mhrec_tpu/models/multihead.py``): ``compute_multihead_losses`` and
``_switch_loss`` for training, ``predict_switch_and_heads`` at eval time.

The model is duck-typed as in the JAX package: attributes loss_type,
head_interaction, num_segment_head, num_prior_head, seg_len, pred_len,
max_seq_length, nce_thres, nce_impl, prior_loss_impl, neg_sample_by_cat,
pos_sample_mix_ratio, prior_loss_weight, prior_switch,
prior_switch_loss_weight, use_asym_switch_loss, gamma_pos, gamma_neg,
switch_last_only, master_switch, detach_aux_in, int_to_category; methods
compute_heads, horizon_discount; logit_scale (parameter or buffer);
aux_cat_head[c] when a prior switch is configured; ``mesh``, the
data-parallel group or None: with one, every mean of the loss becomes this
rank's share of the global batch's mean (masked means divide by counts
summed over the ranks, fixed-size means by the world size), so the ranks'
losses and gradients sum to the composed batch's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mhrec_tpu_torch.models.layers import (
    asymmetric_loss,
    batch_rows,
    cosine_normalize,
    weighted_bce_with_logits,
)
from mhrec_tpu_torch.models.losses import multi_horizon_nce, multi_horizon_nce_stacked


def compute_multihead_losses(
    model,
    output_embs: torch.Tensor,      # [B, L, D] trunk outputs
    pos_items_embs: torch.Tensor,   # [B, L+P, D] target-item embeddings
    user_mask: torch.Tensor,        # [B, L+P] bool
    tag_categories,                 # [B, L+P, C] int8/bool or None
    neg_norm_fn: Callable[[int], torch.Tensor],  # col → [M, D] normalized negs
    generator: Optional[torch.Generator] = None,  # draws of pos_sample_mix_ratio
) -> Dict[str, torch.Tensor]:
    """The training loss dict: 'loss' and detached logging scalars
    (reference hstu.py:631-872, the JAX package's multihead.py:29-210)."""
    L, P = model.max_seq_length, model.pred_len
    # the heads run in float32, as flax's Dense promotes the bf16 trunk
    # output to its float32 kernel
    head_embs = model.compute_heads(output_embs.float())  # [B, H, L, D]
    heads_n = cosine_normalize(head_embs)
    tgts_n = cosine_normalize(pos_items_embs.float())
    base_mask = torch.stack(
        [user_mask[:, :L] & user_mask[:, p + 1: p + 1 + L] for p in range(P)], dim=1)
    lam = model.horizon_discount().to(output_embs.device)
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=output_embs.device)
    logit_scale, impl = model.logit_scale, model.nce_impl
    mesh = getattr(model, "mesh", None)

    run_nce = model.loss_type == "nce" or (
        model.loss_type == "prior" and model.head_interaction == "additive")
    if run_nce:
        loss_nce, per_pred, logs = multi_horizon_nce(
            heads_n, tgts_n, neg_norm_fn(-1), base_mask, np.arange(P) // model.seg_len, lam,
            logit_scale, model.nce_thres, compute_topk_log=True, impl=impl,
            inputs_normalized=True, mesh=mesh)
        total = total + loss_nce
        out.update(logs)
        if model.loss_type == "nce":
            seg = per_pred.reshape(model.num_segment_head, model.seg_len).sum(dim=1)
            for s in range(model.num_segment_head):
                out[f"seg_{s}_loss"] = seg[s].detach()

    if model.loss_type == "prior":
        tags = tag_categories.bool()
        additive = model.head_interaction == "additive"
        seg_len = P if additive else model.seg_len
        if not additive and model.num_segment_head * seg_len != P:
            raise ValueError(
                "prior loss with num_segment_head > 1 requires medusa_num_layers >= 1 "
                "(the reference builds segment heads only under medusa_num_layers > 0)")
        segment_for_pred = np.arange(P) // seg_len
        per_pred_accum = torch.zeros(P, dtype=torch.float32, device=output_embs.device)
        global_neg = neg_norm_fn(-1) if (not model.neg_sample_by_cat or additive) else None

        def cat_name(c):
            return model.int_to_category[c] if c < len(model.int_to_category) else str(c)

        def prior_window(c):
            full = tags[:, :, c]
            win = torch.stack([full[:, p + 1: p + 1 + L] for p in range(P)], dim=1)
            if model.pos_sample_mix_ratio > 0.0:
                draw = batch_rows(win.shape, mesh, lambda shape: torch.rand(
                    shape, generator=generator, device=win.device))
                win = win | (draw < model.pos_sample_mix_ratio)
            return win

        if model.prior_switch is not None:
            for c in range(1 if model.master_switch else model.num_prior_head):
                total = _switch_loss(model, total, out, output_embs, head_embs, tags, c,
                                     cat_name(c), mesh)

        # the category-stacked path (JAX multihead.py:126-170): under additive
        # heads one head serves each category, so the per-category products
        # batch over the categories
        use_stacked = additive and impl == "banded" and model.prior_loss_impl == "stacked"
        C = model.num_prior_head
        if use_stacked:
            extra_masks = torch.stack([prior_window(c) for c in range(C)], 0)
            neg_stack = (torch.stack([neg_norm_fn(c) for c in range(C)], 0)
                         if model.neg_sample_by_cat else global_neg[None])
            loss_p, per_pred, per_cat, logs = multi_horizon_nce_stacked(
                heads_n, tgts_n, neg_stack, base_mask, extra_masks,
                model.num_segment_head + np.arange(C), lam, logit_scale, model.nce_thres,
                np.asarray(model.prior_loss_weight, np.float32), compute_topk_log=True,
                mesh=mesh)
            total = total + loss_p
            per_pred_accum = per_pred_accum + per_pred
            for c in range(C):
                out[f"head_nce_{cat_name(c)}_loss"] = per_cat[c].detach()
            out.update(logs)
        else:
            for c in range(C):
                neg_norm = neg_norm_fn(c) if model.neg_sample_by_cat else global_neg
                if additive:
                    head_for_pred = np.full(P, model.num_segment_head + c)
                else:
                    head_for_pred = segment_for_pred * model.num_prior_head + c
                loss_c, per_pred, logs = multi_horizon_nce(
                    heads_n, tgts_n, neg_norm, base_mask, head_for_pred, lam, logit_scale,
                    model.nce_thres, loss_weight=float(model.prior_loss_weight[c]),
                    extra_mask=prior_window(c), compute_topk_log=(c == 0), impl=impl,
                    inputs_normalized=True, mesh=mesh)
                total = total + loss_c
                per_pred_accum = per_pred_accum + per_pred
                out[f"head_nce_{cat_name(c)}_loss"] = loss_c.detach()
                if c == 0:
                    out.update(logs)

        if not additive:
            seg = per_pred_accum.reshape(model.num_segment_head, model.seg_len).sum(dim=1)
            for s in range(model.num_segment_head):
                out[f"seg_{s}_loss"] = seg[s].detach()
        else:
            total = total / 2.0

    out["loss"] = total
    return out


def _switch_loss(model, total, out, output_embs, head_embs, tags, c: int, cat_name: str,
                 mesh=None):
    """Prior-switch classifier loss of category c (reference
    hstu.py:757-805); adds its logging scalars to ``out`` and returns the
    new total. With ``mesh`` its means over this rank's equal share of the
    global batch are divided by the world size."""
    L, P = model.max_seq_length, model.pred_len
    full = tags[:, :, c]
    tgt = torch.stack([full[:, p + 1: p + 1 + L] for p in range(P)], dim=-1).any(dim=-1).float()
    if model.switch_last_only:
        tgt = tgt[:, -1:]
    if model.prior_switch == "in":
        aux_in = output_embs.float()
    elif model.prior_switch == "in_out":
        h = model.num_segment_head + c if model.head_interaction == "additive" else c
        aux_in = torch.cat([output_embs.float(), head_embs[:, h]], dim=-1)
    else:
        raise ValueError(f"prior_switch={model.prior_switch} not recognized")
    if model.switch_last_only:
        aux_in = aux_in[:, -1:]
    if model.detach_aux_in:
        aux_in = aux_in.detach()
    logits = model.aux_cat_head[c](aux_in).squeeze(-1)
    if model.use_asym_switch_loss:
        loss = asymmetric_loss(logits[..., None], tgt[..., None],
                               gamma_pos=model.gamma_pos, gamma_neg=model.gamma_neg)
    else:
        p = float(np.clip(model.prior_loss_weight[c], 1e-6, 1 - 1e-6))
        pos_w = torch.tensor((1.0 - p) / p, dtype=torch.float32, device=logits.device)
        loss = weighted_bce_with_logits(logits, tgt, pos_w)
    with torch.no_grad():
        acc = ((logits >= 0) == (tgt > 0.5)).float().mean()
    if mesh is not None:
        loss, acc = loss / mesh.world, acc / mesh.world
    out[f"head_cat_{cat_name}_acc"] = acc
    weighted = model.prior_switch_loss_weight * loss
    out[f"head_cat_{cat_name}_loss"] = weighted.detach()
    return total + weighted


def predict_switch_and_heads(model, last_hidden, target_tags) -> Dict[str, torch.Tensor]:
    """Eval-time head embeddings + prior-switch predictions (reference HSTU
    predict, hstu.py:874-971).

    Returns head_embs [B, H, D] and user_emb [B, D], both L2-normalized f32;
    with a prior switch also switch_pred [B, switch_range] bool and, given
    target_tags [B, P, C], switch_correct [B, switch_range] f32 per row."""
    out: Dict[str, torch.Tensor] = {}
    last = last_hidden.float()
    heads = cosine_normalize(model.compute_heads(last).float())
    out["head_embs"] = heads
    out["user_emb"] = cosine_normalize(last)

    if model.loss_type == "prior" and model.prior_switch is not None:
        switch_range = 1 if model.master_switch else model.num_prior_head
        preds = []
        for c in range(switch_range):
            if model.prior_switch == "in":
                aux = last
            elif model.head_interaction == "additive":
                aux = torch.cat([last, heads[:, model.num_segment_head + c]], dim=-1)
            else:
                aux = torch.cat([last, heads[:, c]], dim=-1)
            preds.append(model.aux_cat_head[c](aux).squeeze(-1) >= 0)
        switch_pred = torch.stack(preds, dim=1)
        out["switch_pred"] = switch_pred
        if target_tags is not None:
            labels = target_tags.sum(dim=1) > 0
            out["switch_correct"] = (labels[:, :switch_range] == switch_pred).float()
    return out
