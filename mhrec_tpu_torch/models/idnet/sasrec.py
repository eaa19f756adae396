"""SASRec — softmax-attention sequential baseline (port of
``mhrec_tpu/models/idnet/sasrec.py``).

Reference ``code/REC/model/IDNet/sasrec.py``: a post-LN transformer over
item + position embeddings (input LayerNorm and dropout), NCE with
per-position uniform negatives (``num_negatives`` drawn in the model from
the step's generator, sasrec.py:80-88; or the batch's ``pos_neg_items``,
which the batcher draws under ``sparse_item_adam``) or the shared pool,
false negatives masked at ``nce_thres``, cross-entropy over valid
positions; one head at prediction, scored against the whole item table.
Computes in float32, as the JAX model does."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mhrec_tpu_torch.models.layers import (
    ItemEmbed,
    LayerNorm,
    TransformerEncoder,
    additive_causal_mask,
    batch_rows,
    cosine_normalize,
    dropout,
    trunc_normal_init,
)
from mhrec_tpu_torch.models.losses import (
    clamp_logit_scale,
    gathered_pool,
    global_count,
    logit_scale_param,
)
from mhrec_tpu_torch.utils.enums import InputType

_MIN = torch.finfo(torch.float32).min


def position_nce(model, out, tgt, neg, user_mask, L, scaled_ranks: bool, mesh=None):
    """SASRec's and LLMIDRec's NCE: ``out``/``tgt`` [B, L, D] normalized,
    ``neg`` [B, L, K, D] per-position or [M, D] shared negatives (the
    global pool over the ranks of ``mesh``). ``scaled_ranks``: the
    accuracies compare scaled logits (SASRec) rather than cosines
    (LLMIDRec), as each JAX model does. With ``mesh`` the means divide by
    the global batch's count of valid positions."""
    scale = clamp_logit_scale(model.logit_scale)
    pos_logits = torch.einsum("bld,bld->bl", out, tgt)[..., None]
    if neg.dim() == 4:
        neg_logits = torch.einsum("bld,blkd->blk", out, neg)
        fix_logits = torch.einsum("bld,blkd->blk", tgt, neg)
    else:
        neg_logits = torch.einsum("bld,md->blm", out, neg)
        fix_logits = torch.einsum("bld,md->blm", tgt, neg)
    neg_logits = torch.where(fix_logits > model.nce_thres, _MIN, neg_logits)
    logits = torch.cat([pos_logits, neg_logits], dim=-1) * scale
    valid = (user_mask[:, :L] & user_mask[:, 1:]).float()
    # the cross-entropy over valid positions, the unmasked sample count and
    # the top-k accuracies (JAX sasrec.py:126-142)
    ce = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    cnt = torch.clamp(global_count(valid.sum(), mesh), min=1.0)
    res = {"loss": torch.sum(ce * valid) / cnt}
    n_unmasked = (logits > _MIN / 100).sum(dim=-1).float()
    res["nce_samples"] = (torch.sum(n_unmasked * valid) / cnt).detach()
    if scaled_ranks:
        beaten = (neg_logits * scale > pos_logits * scale).sum(dim=-1)
    else:
        beaten = (neg_logits > pos_logits).sum(dim=-1)
    for k in (1, 5, 10, 50, 100):
        if k > logits.shape[-1]:
            break
        res[f"nce_top{k}_acc"] = (torch.sum((beaten < k).float() * valid) / cnt).detach()
    return res


def position_draws(model, B, L, generator, device):
    """The in-model per-position negatives [B, L, num_negatives], uniform
    over [1, item_num) (reference sasrec.py:80-88), drawn over the global
    batch with ``model.mesh`` (``batch_rows``)."""
    return batch_rows((B, L, model.num_negatives), model.mesh, lambda shape: torch.randint(
        1, model.item_num, shape, generator=generator, device=device))


class SASRec(nn.Module):
    input_type = InputType.SEQ
    medusa_num_heads = 1

    def __init__(self, item_num: int, hidden_size: int, inner_size: int, n_layers: int,
                 n_heads: int, max_seq_length: int, hidden_dropout_prob: float = 0.1,
                 attn_dropout_prob: float = 0.1, hidden_act: str = "gelu",
                 layer_norm_eps: float = 1e-12, initializer_range: float = 0.02,
                 nce_thres: float = 0.99, fix_temp: bool = False,
                 num_negatives: Optional[int] = None):
        super().__init__()
        self.item_num = item_num
        self.hidden_dropout_prob = hidden_dropout_prob
        self.initializer_range = initializer_range
        self.nce_thres = nce_thres
        self.fix_temp = fix_temp
        self.num_negatives = num_negatives
        self.item_embedding = ItemEmbed(item_num, hidden_size)
        self.position_embedding = nn.Embedding(max_seq_length, hidden_size)
        self.trm_encoder = TransformerEncoder(
            n_layers, n_heads, hidden_size, inner_size, layer_norm_eps,
            hidden_dropout_prob, attn_dropout_prob, hidden_act)
        self.input_norm = LayerNorm(hidden_size, eps=layer_norm_eps)
        # init ln(1/0.07) trainable, ln(1/0.05) fixed (sasrec.py:51-56)
        logit_scale_param(self, fix_temp, math.log(1 / 0.07))
        # the data-parallel group (a DataMesh) in a process group: draws
        # over the global batch, the global pool, global counts
        self.mesh = None

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """flax's initialisers: normal(initializer_range) tables, lecun-normal
        kernels (truncated normal of std 1/sqrt(fan in)), zero biases, unit
        LayerNorms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_init(m.weight, gen, std=m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for table in (self.item_embedding.weight, self.position_embedding.weight):
            table.normal_(0.0, self.initializer_range, generator=gen)
        if not self.fix_temp:
            self.logit_scale.fill_(math.log(1 / 0.07))

    def _embed(self, ids, sub=None):
        # a bf16 table's rows are read in float32
        return self.item_embedding(ids, sub).float()

    def encode(self, items, sub=None, generator=None):
        L = items.shape[1]
        x = self._embed(items, sub) + self.position_embedding.weight[:L][None]
        x = dropout(self.input_norm(x), self.hidden_dropout_prob, generator, self.mesh)
        return self.trm_encoder(x, additive_causal_mask(items), generator, self.mesh)

    def forward(self, batch, sub=None, generator=None):
        """Training forward (JAX ``SASRec.__call__``): items [B, L+1]
        (pred_len 1). ``generator`` draws the dropout masks and the
        in-model negatives."""
        items = batch["items"]
        user_mask = batch["masked_index"].bool()
        B, W = items.shape
        L = W - 1
        inputs = torch.where(user_mask[:, :L], items[:, :L], torch.zeros_like(items[:, :L]))
        targets = items[:, 1:]
        if "pos_neg_items" in batch:
            # the batcher's per-position draws (the same uniform [1, item_num)
            # law; required under sparse_item_adam)
            neg = cosine_normalize(self._embed(batch["pos_neg_items"], sub))
        elif self.num_negatives:
            neg = cosine_normalize(self._embed(position_draws(self, B, L, generator,
                                                              items.device), sub))
        else:
            neg = gathered_pool(cosine_normalize(
                self._embed(batch["neg_items"][:, -1].reshape(-1), sub)), self.mesh)
        out = cosine_normalize(self.encode(inputs, sub, generator).float())
        tgt = cosine_normalize(self._embed(targets, sub))
        return position_nce(self, out, tgt, neg, user_mask, L, scaled_ranks=True,
                            mesh=self.mesh)

    # -- eval interface -------------------------------------------------
    def predict_embeddings(self, item_seq, target_tags=None):
        last = cosine_normalize(self.encode(item_seq)[:, -1].float())
        return {"head_embs": last[:, None, :], "user_emb": last}

    def score_items(self, head_embs, item_feats, item_tags, target_tags, switch_pred):
        return torch.matmul(head_embs, item_feats.t())

    def compute_item_all(self):
        return cosine_normalize(self.item_embedding.weight[: self.item_num].float())


def sasrec_from_config(config, dataload) -> SASRec:
    hidden = config["embedding_size"]
    return SASRec(
        item_num=dataload.item_num,
        hidden_size=hidden,
        inner_size=(config["inner_size"] or 1) * hidden,
        n_layers=config["n_layers"],
        n_heads=config["n_heads"],
        max_seq_length=config["MAX_ITEM_LIST_LENGTH"],
        hidden_dropout_prob=config["hidden_dropout_prob"] or 0.1,
        attn_dropout_prob=config["attn_dropout_prob"] or 0.1,
        hidden_act=config["hidden_act"] or "gelu",
        layer_norm_eps=config["layer_norm_eps"] or 1e-12,
        initializer_range=config["initializer_range"] or 0.02,
        nce_thres=config["nce_thres"] or 0.99,
        fix_temp=bool(config["fix_temp"]),
        num_negatives=config["num_negatives"],
    )
