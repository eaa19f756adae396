"""LLMIDRec — item-ID embeddings through an LLM user tower, NCE loss (port of
``mhrec_tpu/models/idnet/llmidrec.py``).

Reference ``code/REC/model/IDNet/llmidrec.py``: the item-ID embedding (with
a projection to the LLM width when they differ) feeds a Llama-family user
tower through ``inputs_embeds``; NCE with per-position uniform negatives
(drawn in the model from the step's generator, or the batch's
``pos_neg_items`` under ``sparse_item_adam``) or the shared pool,
cross-entropy over valid positions; one head at prediction. The user tower
computes in ``dtype`` (bfloat16 by default, as in JAX) over float32
parameters and starts at random, as the JAX package's does (it loads no
tower weights for this model); ``logit_scale`` starts at ln(1/0.07)."""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn

from mhrec_tpu_torch.models.idnet.sasrec import position_draws, position_nce
from mhrec_tpu_torch.models.layers import ItemEmbed, cosine_normalize
from mhrec_tpu_torch.models.llm.config import LLMConfig
from mhrec_tpu_torch.models.llm.dummy import DummyLLM
from mhrec_tpu_torch.models.llm.llama import LlamaBackbone
from mhrec_tpu_torch.models.losses import gathered_pool, logit_scale_param
from mhrec_tpu_torch.utils.enums import InputType


class LLMIDRec(nn.Module):
    input_type = InputType.SEQ
    medusa_num_heads = 1

    def __init__(self, item_num: int, item_embed_dim: int, llm_config: LLMConfig,
                 dummy_llm: bool = False, gradient_checkpointing: bool = False,
                 nce_thres: float = 0.99, fix_temp: bool = False,
                 num_negatives: Optional[int] = None, dtype=torch.bfloat16):
        super().__init__()
        D = llm_config.hidden_size
        self.item_num = item_num
        self.nce_thres = nce_thres
        self.fix_temp = fix_temp
        self.num_negatives = num_negatives
        self.dtype = dtype
        self.item_embedding = ItemEmbed(item_num, item_embed_dim)
        self.item_id_proj_tower = (None if item_embed_dim == D
                                   else nn.Linear(item_embed_dim, D, bias=False))
        # the user tower reads item embeddings, never token ids
        if dummy_llm:
            self.user_llm = DummyLLM(llm_config.vocab_size, D, token_embeddings=False)
        else:
            self.user_llm = LlamaBackbone(llm_config, dtype=dtype,
                                          gradient_checkpointing=gradient_checkpointing,
                                          token_embeddings=False)
        logit_scale_param(self, fix_temp, math.log(1 / 0.07))
        # the data-parallel group (a DataMesh) in a process group: draws
        # over the global batch, the global pool, global counts (the tower
        # is dense: the gradient all-reduce and ZeRO-2 cover it)
        self.mesh = None

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """normal(0.02) for the item table and its projection, the tower's
        own initialisers, logit scale ln(1/0.07)."""
        self.item_embedding.weight.normal_(0.0, 0.02, generator=gen)
        if self.item_id_proj_tower is not None:
            self.item_id_proj_tower.weight.normal_(0.0, 0.02, generator=gen)
        self.user_llm.init_parameters(gen)
        if not self.fix_temp:
            self.logit_scale.fill_(math.log(1 / 0.07))

    def _embed(self, items, sub=None):
        # a bf16 table's rows are read in float32
        e = self.item_embedding(items, sub).float()
        if self.item_id_proj_tower is not None:
            e = self.item_id_proj_tower(e)
        return e

    def forward(self, batch, sub=None, generator=None):
        """Training forward (JAX ``LLMIDRec.__call__``): items [B, L+1].
        ``generator`` draws the in-model negatives."""
        items = batch["items"]
        user_mask = batch["masked_index"].bool()
        B, W = items.shape
        L = W - 1
        pos_embs = self._embed(items, sub)
        tgt = cosine_normalize(pos_embs[:, 1:])
        if "pos_neg_items" in batch:
            # the batcher's per-position draws (the same uniform law;
            # required under sparse_item_adam)
            neg = cosine_normalize(self._embed(batch["pos_neg_items"], sub))
        elif self.num_negatives:
            neg = cosine_normalize(self._embed(position_draws(self, B, L, generator,
                                                              items.device), sub))
        else:
            neg = gathered_pool(cosine_normalize(
                self._embed(batch["neg_items"][:, -1].reshape(-1), sub)), self.mesh)
        attn = user_mask[:, :L].int()
        out = self.user_llm(inputs_embeds=pos_embs[:, :L].to(self.dtype), attention_mask=attn)
        out = cosine_normalize(out.float())
        return position_nce(self, out, tgt, neg, user_mask, L, scaled_ranks=False,
                            mesh=self.mesh)

    def predict_embeddings(self, item_seq, target_tags=None):
        attn = (item_seq > 0).int()
        out = self.user_llm(inputs_embeds=self._embed(item_seq).to(self.dtype),
                            attention_mask=attn)
        last = cosine_normalize(out[:, -1].float())
        return {"head_embs": last[:, None, :], "user_emb": last}

    def score_items(self, head_embs, item_feats, item_tags, target_tags, switch_pred):
        return torch.matmul(head_embs, item_feats.t())

    def compute_item_all(self):
        return cosine_normalize(self._embed(
            torch.arange(self.item_num, device=self.item_embedding.weight.device)))


def llmidrec_from_config(config, dataload, dtype=torch.bfloat16) -> LLMIDRec:
    """No user pretrain directory (or ``dummy_llm``): the dummy tower at
    ``dummy_hidden_size``; else the tower of the directory's config.json."""
    dummy = bool(config.get("dummy_llm", False))
    user_dir = config.get("user_pretrain_dir")
    if dummy or not user_dir or not os.path.isdir(str(user_dir)):
        cfg = LLMConfig.tiny(config.get("dummy_vocab_size", 1024),
                             config.get("dummy_hidden_size", 64))
        dummy = True
    else:
        cfg = LLMConfig.from_pretrained_dir(user_dir)
    return LLMIDRec(
        item_num=dataload.item_num,
        item_embed_dim=config.get("item_embed_dim", 512),
        llm_config=cfg,
        dummy_llm=dummy,
        gradient_checkpointing=bool(config.get("gradient_checkpointing", False)),
        nce_thres=config["nce_thres"] or 0.99,
        fix_temp=bool(config["fix_temp"]),
        num_negatives=config["num_negatives"],
        dtype=dtype,
    )
