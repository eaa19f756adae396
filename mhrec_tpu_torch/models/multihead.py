"""Multi-head decoding at eval time (port of
``mhrec_tpu/models/multihead.py::predict_switch_and_heads``). The training
losses come with the training slice."""

from __future__ import annotations

from typing import Dict

import torch

from mhrec_tpu_torch.models.layers import cosine_normalize


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
