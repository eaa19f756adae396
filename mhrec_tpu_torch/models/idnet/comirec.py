"""ComiRec — multi-interest baseline on the HSTU backbone (port of
``mhrec_tpu/models/idnet/comirec.py``).

Reference ``code/REC/model/IDNet/comirec.py``: an HSTU trunk, then per
position a *causal* self-attentive extraction of K interests over the
prefix window, a hard readout for training (the interest most similar to
each target), and per-interest retrieval scores ``[B, K, I]`` at
prediction. The per-window masked softmax telescopes into cumulative sums
(``causal_interest_state``), as in the JAX package:

    interest[b, l, k] = Σ_{j≤l} softmax_j(w[b,j,k]) · out[b,j]
                      = cumsum(e·out)[l] / cumsum(e)[l],  e = exp(w)·mask

The trunk's STU layers run the port's fused STU block (``hstu_stu_gated_fwd``
and its backward on the card) in float32, as the JAX trunk does; the dense
mask ``non_pad & causal`` of the JAX trunk is what the kernels compute from
``nonpad``. REMI (``remi.py``) is this module with ``lambda_rr`` and
``beta_ihn`` active.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from mhrec_tpu_torch.models.idnet.hstu import STULayer
from mhrec_tpu_torch.models.layers import ItemEmbed, cosine_normalize, dropout, trunc_normal_init
from mhrec_tpu_torch.models.losses import (
    clamp_logit_scale,
    gathered_pool,
    global_count,
    horizon_discount,
    logit_scale_param,
)
from mhrec_tpu_torch.utils.enums import InputType

_MIN = torch.finfo(torch.float32).min


def causal_interest_state(attn_logits, output_embs, mask):
    """Cumulative-sum causal multi-interest extraction.

    attn_logits: [B, L, K]; output_embs: [B, L, D]; mask: [B, L] bool.
    Returns (interests [B, L, K, D], S1 [B, L, K], S2 [B, L, K], cnt [B, L]);
    ``interests[b, l]`` attends over valid positions j ≤ l."""
    logits = attn_logits.float()
    m = torch.where(mask[..., None], logits, float("-inf")).amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask[..., None], torch.exp(logits - m), torch.zeros_like(logits))
    S1 = torch.cumsum(e, dim=1)
    S2 = torch.cumsum(e * e, dim=1)
    num = torch.cumsum(e[..., None] * output_embs.float()[:, :, None, :], dim=1)
    denom = torch.clamp(S1, min=1e-20)[..., None]
    interests = torch.where(S1[..., None] > 0, num / denom, torch.zeros_like(num))
    cnt = torch.cumsum(mask.float(), dim=1)
    return interests, S1, S2, cnt


def routing_regularization(S1, S2, cnt, hidden_dim):
    """REMI's RR loss per position from the cumulative statistics: per
    window Σ_j dev² = Σ_j A² − 1/cnt with A = e/S1, variance = Σ dev² /
    hidden_dim, loss = ‖variances‖² per (b, l) (reference remi.py:156-199,
    telescoped)."""
    sum_A2 = torch.where(S1 > 0, S2 / torch.clamp(S1 * S1, min=1e-30), torch.zeros_like(S1))
    inv_cnt = torch.where(cnt > 0, 1.0 / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    sum_dev2 = torch.clamp(sum_A2 - inv_cnt[..., None], min=0.0)
    variances = sum_dev2 / hidden_dim
    return torch.sum(variances * variances, dim=-1)


class InterestTrunk(nn.Module):
    """The HSTU trunk and interest attention net that ComiRec and REMI
    share (the JAX package's ``_InterestTrunk``)."""

    def __init__(self, item_num: int, item_embedding_size: int, hstu_embedding_size: int,
                 max_seq_length: int, n_layers: int, n_heads: int, hidden_act: str,
                 hidden_dropout_prob: float, num_interest: int, interest_hidden: int,
                 attention_net_bias: bool = True, skip_hstu: bool = False,
                 use_input_dropout: bool = False, dtype=torch.float32):
        super().__init__()
        D = hstu_embedding_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.skip_hstu = skip_hstu
        self.use_input_dropout = use_input_dropout
        self.dtype = dtype
        self.item_embedding = ItemEmbed(item_num, item_embedding_size)
        self.item_id_proj_tower = (nn.Linear(item_embedding_size, D, bias=False)
                                   if item_embedding_size != D else None)
        self.position_embedding = nn.Embedding(max_seq_length + 1, D)
        self.stu_layers = nn.ModuleList(
            STULayer(D, D // n_heads, D // n_heads, n_heads, linear_activation=hidden_act,
                     dtype=dtype, dropout_ratio=hidden_dropout_prob)
            for _ in range(n_layers))
        self.attn_hidden = nn.Linear(D, interest_hidden, bias=attention_net_bias)
        self.attn_out = nn.Linear(interest_hidden, num_interest, bias=False)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """Truncated normal 0.02 on the tables and the interest net (biases
        too), the STU layers' own initialisers."""
        for layer in self.stu_layers:
            layer.init_parameters(gen)
        for t in (self.item_embedding.weight, self.position_embedding.weight,
                  self.attn_hidden.weight, self.attn_out.weight):
            trunc_normal_init(t, gen)
        if self.item_id_proj_tower is not None:
            trunc_normal_init(self.item_id_proj_tower.weight, gen)
        if self.attn_hidden.bias is not None:
            trunc_normal_init(self.attn_hidden.bias, gen)

    def embed(self, items, sub=None):
        # a bf16 table's rows are read in float32
        e = self.item_embedding(items, sub).float()
        if self.item_id_proj_tower is not None:
            e = self.item_id_proj_tower(e)
        return e

    def encode(self, items_ctx, sub=None, generator=None, shard=None):
        """``shard`` (a DataMesh): the dropout masks cover the global
        batch."""
        L = items_ctx.shape[1]
        x = self.embed(items_ctx, sub) + self.position_embedding.weight[:L][None]
        if self.skip_hstu:
            if self.use_input_dropout:
                x = dropout(x, self.hidden_dropout_prob, generator, shard)
            return x.to(self.dtype)
        nonpad = items_ctx != 0
        x = x.to(self.dtype)
        for layer in self.stu_layers:
            x = layer(x, nonpad, generator=generator, shard=shard)
        return x

    def interest_logits(self, output_embs, generator=None, shard=None):
        h = torch.tanh(self.attn_hidden(output_embs.float()))
        return self.attn_out(dropout(h, self.hidden_dropout_prob, generator, shard))  # [B, L, K]


class ComiRec(nn.Module):
    input_type = InputType.SEQ

    def __init__(self, item_num: int, item_embedding_size: int, hstu_embedding_size: int,
                 max_seq_length: int, pred_len: int, n_layers: int, n_heads: int,
                 hidden_act: str = "silu", hidden_dropout_prob: float = 0.1,
                 num_interest: int = 4, interest_hidden: int = 0,
                 attention_net_bias: bool = True, skip_hstu: bool = False,
                 use_input_dropout: bool = False, medusa_lambda: float = 0.99,
                 nce_thres: float = 0.99, fix_temp: bool = False,
                 lambda_rr: float = 0.0, beta_ihn: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.item_num = item_num
        self.hstu_embedding_size = hstu_embedding_size
        self.max_seq_length = max_seq_length
        self.pred_len = pred_len
        self.num_interest = num_interest
        self.medusa_lambda = medusa_lambda
        self.nce_thres = nce_thres
        self.fix_temp = fix_temp
        self.lambda_rr = lambda_rr
        self.beta_ihn = beta_ihn
        self.trunk = InterestTrunk(
            item_num, item_embedding_size, hstu_embedding_size, max_seq_length, n_layers,
            n_heads, hidden_act, hidden_dropout_prob, num_interest,
            interest_hidden or hstu_embedding_size // 2, attention_net_bias, skip_hstu,
            use_input_dropout, dtype)
        logit_scale_param(self, fix_temp, math.log(1 / 0.05))
        # the data-parallel group (a DataMesh) in a process group: the
        # shared negatives are the global pool, the loss means divide by
        # global counts and the dropout masks cover the global batch
        self.mesh = None

    @property
    def medusa_num_heads(self) -> int:
        return self.num_interest

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.trunk.init_parameters(gen)
        if not self.fix_temp:
            self.logit_scale.fill_(math.log(1 / 0.05))

    # ------------------------------------------------------------------
    def forward(self, batch, sub=None, generator=None):
        """Training forward (JAX ``ComiRec.__call__``): items [B, L+P];
        under ``sparse_item_adam`` the ids index ``sub``. ``generator``
        draws the dropout masks."""
        items = batch["items"]
        user_mask = batch["masked_index"].bool()
        L, P = self.max_seq_length, self.pred_len
        pos_items_embs = self.trunk.embed(items, sub)                    # [B, L+P, D]
        ctx_mask = user_mask[:, :L]
        ctx_items = torch.where(ctx_mask, items[:, :L], torch.zeros_like(items[:, :L]))
        mesh = self.mesh
        output_embs = self.trunk.encode(ctx_items, sub, generator, mesh)
        attn_logits = self.trunk.interest_logits(output_embs, generator, mesh)
        interests, S1, S2, cnt = causal_interest_state(attn_logits, output_embs, ctx_mask)

        model_out = {}
        total = torch.zeros((), device=items.device)
        if self.lambda_rr > 0:
            rr = routing_regularization(S1, S2, cnt, self.hstu_embedding_size)  # [B, L]
            valid_steps = torch.clamp(global_count(ctx_mask.float().sum(), mesh), min=1.0)
            rr_loss = torch.sum(rr * ctx_mask.float()) / valid_steps
            model_out["rr_loss"] = rr_loss.detach()
            total = total + self.lambda_rr * rr_loss

        neg_flat = batch["neg_items"][:, -1].reshape(-1)
        # the global batch's shared pool (JAX flattens neg_items of the
        # global batch), its gradient summed over the ranks
        neg_T = gathered_pool(cosine_normalize(self.trunk.embed(neg_flat, sub)), mesh).t()
        lam = horizon_discount(self.medusa_lambda, P, device=items.device)
        scale = clamp_logit_scale(self.logit_scale)
        per_pred = []
        for p in range(P):
            tgt_raw = pos_items_embs[:, p + 1: p + 1 + L]               # [B, L, D]
            # hard readout: the interest most similar to the target
            sim = torch.einsum("blkd,bld->blk", interests, tgt_raw)
            best = sim.argmax(dim=-1)                                   # [B, L]
            cur = torch.gather(
                interests, 2, best[..., None, None].expand(-1, -1, 1, interests.shape[-1])
            ).squeeze(2)                                                # [B, L, D]
            out_n = cosine_normalize(cur)
            tgt_n = cosine_normalize(tgt_raw)
            pos_logit = torch.einsum("bld,bld->bl", out_n, tgt_n)
            neg_logits = torch.matmul(out_n, neg_T)
            fix = torch.matmul(tgt_n, neg_T)
            neg_logits = torch.where(fix > self.nce_thres, _MIN, neg_logits)

            m = (ctx_mask & user_mask[:, p + 1: p + 1 + L]).float()
            cnt_p = torch.clamp(global_count(m.sum(), mesh), min=1.0)
            if self.beta_ihn > 0:
                tok = self._ihn_token_loss(pos_logit, neg_logits, scale)
            else:
                lse = torch.logaddexp(pos_logit * scale,
                                      torch.logsumexp(neg_logits * scale, dim=-1))
                tok = lse - pos_logit * scale
            per_pred.append(lam[p] * (torch.sum(tok * m) / cnt_p))

            if p == 0:
                n_unmasked = (neg_logits > _MIN / 100).sum(-1).float() + 1
                model_out["nce_samples"] = (torch.sum(n_unmasked * m) / cnt_p).detach()
                beaten = (neg_logits > pos_logit[..., None]).sum(-1)
                for kk in (1, 5, 10, 50, 100):
                    if kk > neg_logits.shape[-1] + 1:
                        break
                    model_out[f"nce_top{kk}_acc"] = (
                        torch.sum((beaten < kk).float() * m) / cnt_p).detach()
        model_out["loss"] = total + torch.stack(per_pred).sum()
        return model_out

    def _ihn_token_loss(self, pos_logit, neg_logits, scale):
        """Interest-aware hard-negative loss in log space (reference
        remi.py:201-278)."""
        beta = self.beta_ihn
        pos = pos_logit * scale
        neg = neg_logits * scale
        log_num = torch.logsumexp((beta + 1.0) * neg, dim=-1)
        log_Z = torch.logsumexp(beta * neg, dim=-1) - math.log(float(neg.shape[-1]))
        return torch.logaddexp(pos, log_num - log_Z) - pos

    # ------------------------------------------------------------------
    def predict_embeddings(self, item_seq, target_tags=None):
        out = self.trunk.encode(item_seq)
        mask = item_seq != 0
        logits = self.trunk.interest_logits(out)                        # [B, L, K]
        w = torch.where(mask[..., None], logits.float(), float("-inf"))
        probs = torch.nan_to_num(torch.softmax(w, dim=1), nan=0.0)
        interests = torch.einsum("blk,bld->bkd", probs, out.float())
        return {"head_embs": cosine_normalize(interests),
                "user_emb": cosine_normalize(out[:, -1].float())}

    def score_items(self, head_embs, item_feats, item_tags, target_tags, switch_pred):
        return torch.matmul(head_embs, item_feats.t())

    def compute_item_all(self):
        w = self.trunk.item_embedding.weight[: self.item_num].float()
        if self.trunk.item_id_proj_tower is not None:
            w = self.trunk.item_id_proj_tower(w)
        return cosine_normalize(w)


def comirec_from_config(config, dataload, dtype=torch.float32) -> ComiRec:
    return ComiRec(
        item_num=dataload.item_num,
        item_embedding_size=config["item_embedding_size"],
        hstu_embedding_size=config["hstu_embedding_size"],
        max_seq_length=config["MAX_ITEM_LIST_LENGTH"],
        pred_len=config["pred_len"],
        n_layers=config["n_layers"],
        n_heads=config["n_heads"],
        hidden_act=config["hidden_act"] or "silu",
        hidden_dropout_prob=config["hidden_dropout_prob"] or 0.1,
        num_interest=config.get("interest_num", config.get("num_interest", 4)),
        interest_hidden=config.get("interest_hidden", 0) or 0,
        skip_hstu=config.get("skip_hstu", False),
        use_input_dropout=config.get("input_dropout", False),
        medusa_lambda=config["medusa_lambda"],
        nce_thres=config["nce_thres"] or 0.99,
        fix_temp=bool(config["fix_temp"]),
        dtype=dtype,
    )
