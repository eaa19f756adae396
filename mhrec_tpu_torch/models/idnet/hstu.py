"""HSTU — Hierarchical Sequential Transduction Unit, PyTorch port.

Port of ``mhrec_tpu/models/idnet/hstu.py``: the STU trunk with dropout
after the gate, the multi-head "medusa" decoding with prior-switch
classifiers, the training forward (multi-horizon NCE / prior / switch
losses, ``models/multihead.py``), and full-corpus cosine scoring with
per-head category masks. The trunk runs in ``dtype`` (bfloat16 by default)
over float32 parameters; heads, losses and retrieval scores are float32
(hstu.py:21-22).

Parameter names follow the JAX package's flax tree closely enough for
``mhrec_tpu_torch/convert.py`` to carry its weights across.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mhrec_tpu_torch.models.layers import (
    ItemEmbed,
    LayerNorm,
    ResBlock,
    cosine_normalize,
    dropout,
    trunc_normal_init,
    xavier_uniform_init,
)
from mhrec_tpu_torch.models.losses import horizon_discount
from mhrec_tpu_torch.models.multihead import (
    compute_multihead_losses,
    predict_switch_and_heads,
)
from mhrec_tpu_torch.ops.hstu_attention import hstu_attention
from mhrec_tpu_torch.ops.hstu_attention_cuda import hstu_stu_gated_fwd
from mhrec_tpu_torch.parallel.mesh import RowShard, make_mesh
from mhrec_tpu_torch.utils.enums import InputType

_NEG_INF = float("-inf")  # predict-time masks use -inf (reference hstu.py:987-1015)


class STULayer(nn.Module):
    """One Sequential Transduction Unit (reference hstu.py:163-290)."""

    def __init__(self, embedding_dim: int, linear_dim: int, attention_dim: int,
                 num_heads: int, linear_activation: str = "silu",
                 attn_impl: str = "auto", dtype=torch.bfloat16, dropout_ratio: float = 0.0):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.num_heads = num_heads
        self.linear_dim = linear_dim
        self.attention_dim = attention_dim
        self.linear_activation = linear_activation
        self.attn_impl = attn_impl
        self.dtype = dtype
        h, D = num_heads, embedding_dim
        self.input_norm = LayerNorm(D, eps=1e-6, dtype=dtype)
        self.uvqk = nn.Parameter(torch.empty(D, 2 * h * linear_dim + 2 * h * attention_dim))
        # the fused kernel reads the same γ/β, so checkpoints serve both paths
        self.attn_norm = LayerNorm(h * linear_dim, eps=1e-6, dtype=dtype)
        self.o_proj = nn.Linear(h * linear_dim, D)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        for norm in (self.input_norm, self.attn_norm):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        self.uvqk.normal_(0.0, 0.02, generator=gen)
        xavier_uniform_init(self.o_proj.weight, gen)
        self.o_proj.bias.zero_()

    def forward(self, x, nonpad, attn_bias=None, generator=None, shard=None):
        """``generator`` turns on dropout after the gate (training) and
        draws its mask (over the global batch with ``shard``, a DataMesh);
        without one the layer is deterministic."""
        B, L, D = x.shape
        h, dqk, dv = self.num_heads, self.attention_dim, self.linear_dim
        mixed = torch.matmul(self.input_norm(x), self.uvqk.to(self.dtype))
        if self.linear_activation == "silu":
            mixed = F.silu(mixed)
        u, v, q, k = torch.split(mixed, [dv * h, dv * h, dqk * h, dqk * h], dim=-1)
        fused_ok = attn_bias is None and (dv * h) % 128 == 0 and (dqk * h) % 128 == 0
        # 'auto' takes the fused STU kernel wherever its preconditions hold.
        # The JAX package's 'auto' rule was fitted to TPU timings, which do
        # not carry over to the H100; this choice is to be revisited from
        # measurements on the card.
        impl = self.attn_impl
        if impl in ("auto", "fused") and fused_ok:
            gated = hstu_stu_gated_fwd(q, k, v, u, self.attn_norm.weight,
                                       self.attn_norm.bias, nonpad, h)
        else:
            attn = hstu_attention(
                q.reshape(B, L, h, dqk), k.reshape(B, L, h, dqk),
                v.reshape(B, L, h, dv), nonpad, impl=impl, bias=attn_bias,
            ).reshape(B, L, h * dv)
            gated = u * self.attn_norm(attn)
        gated = dropout(gated, self.dropout_ratio, generator, shard)
        out = F.linear(gated, self.o_proj.weight.to(self.dtype), self.o_proj.bias.to(self.dtype))
        return x + out


class MedusaHead(nn.Module):
    """Stack of ResBlocks; identity when num_layers == 0."""

    def __init__(self, hidden_size: int, num_layers: int, use_norm: bool = False):
        super().__init__()
        self.res = nn.ModuleList(ResBlock(hidden_size, use_norm) for _ in range(num_layers))

    def forward(self, x):
        for block in self.res:
            x = block(x)
        return x


class _CatBottleneck(nn.Module):
    """LayerNorm → down-proj → SiLU → up-proj (hierarchical cat head option,
    reference hstu.py:453-464)."""

    def __init__(self, dim: int, bottleneck_dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.down = nn.Linear(dim, bottleneck_dim)
        self.up = nn.Linear(bottleneck_dim, dim)

    def forward(self, x):
        return self.up(F.silu(self.down(self.norm(x))))


class MedusaHeads:
    """The multi-head ("medusa") decoding that HSTU and HLLM share: the head
    modules (hierarchical category → segment heads or a flat list, the
    prior-switch classifiers), ``compute_heads`` and ``score_items`` with
    the per-head category masks. A model mixes it in before ``nn.Module``,
    sets loss_type, medusa_num_layers, num_segment_head, num_prior_head,
    head_interaction, prior_switch, master_switch, pred_len, medusa_lambda,
    prior_given_at_test, given_prior_len and use_prior_switch_test, then
    calls ``_build_heads``."""

    def _build_heads(self, D: int, head_norm: bool = False, cat_bottleneck: bool = False,
                     cat_bottleneck_dim: int = 0, share_seg_weights: bool = False,
                     use_seg_embed: bool = False):
        S, C, layers = self.num_segment_head, self.num_prior_head, self.medusa_num_layers
        self.share_seg_weights = share_seg_weights
        self.use_seg_embed = use_seg_embed
        self.hierarchical = self.head_interaction == "hierarchical" and layers > 0
        if self.hierarchical:
            if use_seg_embed:
                self.segment_emb = nn.Embedding(S, D)
            cat_heads = []
            for _ in range(C):
                blocks: List[nn.Module] = []
                if cat_bottleneck:
                    blocks.append(_CatBottleneck(D, cat_bottleneck_dim or D // 2))
                blocks.append(MedusaHead(D, layers, use_norm=head_norm))
                cat_heads.append(nn.ModuleList(blocks))
            self.medusa_cat_head = nn.ModuleList(cat_heads)
            if share_seg_weights:
                self.medusa_seg_head = nn.ModuleList(
                    MedusaHead(D, layers, use_norm=head_norm) for _ in range(C)
                )
            else:
                self.medusa_seg_head = nn.ModuleList(
                    nn.ModuleList(MedusaHead(D, layers, use_norm=head_norm)
                                  for _ in range(S))
                    for _ in range(C)
                )
        else:
            self.medusa_head = nn.ModuleList(
                MedusaHead(D, layers) for _ in range(self.medusa_num_heads)
            )
        if self.loss_type == "prior" and self.prior_switch is not None:
            # one classifier per category, or the master switch's one (the
            # JAX tree holds only the classifiers that are ever called)
            in_dim = D if self.prior_switch == "in" else 2 * D
            self.aux_cat_head = nn.ModuleList(
                nn.Linear(in_dim, 1) for _ in range(1 if self.master_switch else C))

    @torch.no_grad()
    def _init_head_parameters(self, gen: torch.Generator):
        """Truncated normal 0.02 on the segment embedding, the bottleneck
        and the switch classifiers (the res blocks initialise themselves)."""
        linears = []
        if self.hierarchical:
            if self.use_seg_embed:
                trunc_normal_init(self.segment_emb.weight, gen)
            for blocks in self.medusa_cat_head:
                for b in blocks:
                    if isinstance(b, _CatBottleneck):
                        linears += [b.down, b.up]
        if hasattr(self, "aux_cat_head"):
            linears += list(self.aux_cat_head)
        for lin in linears:
            trunc_normal_init(lin.weight, gen)
            trunc_normal_init(lin.bias, gen)

    @property
    def medusa_num_heads(self) -> int:
        if self.head_interaction in ("multiplicative", "hierarchical"):
            return self.num_segment_head * self.num_prior_head
        if self.head_interaction == "additive":
            return self.num_segment_head + self.num_prior_head
        raise ValueError(f"Unknown head_interaction: {self.head_interaction}")

    @property
    def seg_len(self) -> int:
        if self.medusa_num_layers > 0:
            if self.pred_len % self.num_segment_head:
                raise ValueError("pred_len must divide by num_segment_head")
            return self.pred_len // self.num_segment_head
        return self.pred_len

    def horizon_discount(self) -> torch.Tensor:
        return horizon_discount(self.medusa_lambda, self.pred_len)

    def _seg_head(self, c: int, s: int) -> MedusaHead:
        if self.share_seg_weights:
            return self.medusa_seg_head[c]
        return self.medusa_seg_head[c][s]

    def compute_heads(self, output_embs):
        """Apply medusa heads. [..., D] → [batch-dims, H, ..., D]."""
        if self.hierarchical:
            cat_embs = []
            for blocks in self.medusa_cat_head:
                h = output_embs
                for block in blocks:
                    h = block(h)
                cat_embs.append(h)
            outs = []
            for s in range(self.num_segment_head):
                seg_bias = self.segment_emb.weight[s] if self.use_seg_embed else None
                for c in range(self.num_prior_head):
                    seg_in = cat_embs[c] if seg_bias is None else cat_embs[c] + seg_bias
                    outs.append(self._seg_head(c, s)(seg_in))
            return torch.stack(outs, dim=1)
        return torch.stack([h(output_embs) for h in self.medusa_head], dim=1)

    def score_items(self, head_embs, item_feats, item_tags, target_tags, switch_pred):
        """Cosine scores + prior masks for a (chunk of the) item corpus.

        head_embs [B, H, D] and item_feats [I, D] normalized f32, item_tags
        [I, C] bool, target_tags [B, P, C], switch_pred [B, switch_range]
        bool → [B, H, I] f32. Mask semantics per reference predict
        (hstu.py:982-1015)."""
        scores = torch.matmul(head_embs, item_feats.t())
        if self.loss_type != "prior":
            return scores
        S, C = self.num_segment_head, self.num_prior_head
        additive = self.head_interaction == "additive"

        def keep_only(on):  # on: [B|1, C, 1|I] bool
            if additive:
                scores[:, S:].masked_fill_(~on, _NEG_INF)
            else:
                scores.masked_fill_(~on.repeat(1, S, 1), _NEG_INF)

        if self.prior_given_at_test and target_tags is not None:
            given = target_tags[:, : self.given_prior_len].bool().any(dim=1)  # [B, C]
            keep_only(given[:, :, None])
        if item_tags is not None:
            keep_only(item_tags.bool().t()[None])                          # [1, C, I]
        if self.prior_switch is not None and self.use_prior_switch_test \
                and switch_pred is not None:
            if self.master_switch:
                first = switch_pred[:, :1]
                on = torch.cat([~first, first.repeat(1, C - 1)], dim=1)  # [B, C]
            else:
                on = switch_pred
            keep_only(on[:, :, None])
        return scores


class HSTU(MedusaHeads, nn.Module):
    """Multi-head prior-aware HSTU model. ``forward`` is the training
    forward (a dict with 'loss'); ``predict_embeddings`` and ``score_items``
    serve."""

    input_type = InputType.SEQ

    def __init__(
        self,
        item_num: int,
        item_embedding_size: int,
        hstu_embedding_size: int,
        max_seq_length: int,
        n_layers: int,
        n_heads: int,
        hidden_act: str = "silu",
        enable_relative_attention_bias: bool = False,
        apply_relative_attention_bias: bool = False,
        loss_type: str = "nce",
        fix_temp: bool = False,
        medusa_num_layers: int = 0,
        num_segment_head: int = 1,
        num_prior_head: int = 1,
        head_interaction: str = "multiplicative",
        prior_switch: Optional[str] = None,
        master_switch: bool = False,
        pred_len: int = 1,
        hidden_dropout_prob: float = 0.0,
        nce_thres: float = 0.99,
        medusa_lambda: float = 0.99,
        neg_sample_by_cat: bool = False,
        pos_sample_mix_ratio: float = 0.0,
        prior_loss_weight: Tuple[float, ...] = (1.0,),
        prior_switch_loss_weight: float = 0.0,
        use_asym_switch_loss: bool = False,
        gamma_pos: float = 4.0,
        gamma_neg: float = 0.0,
        switch_last_only: bool = False,
        detach_aux_in: bool = False,
        nce_impl: str = "banded",
        prior_loss_impl: str = "loop",
        eval_pred_len: int = 1,
        prior_given_at_test: bool = False,
        given_prior_len: int = 1,
        use_prior_switch_test: bool = False,
        int_to_category: Tuple[str, ...] = (),
        head_norm: bool = False,
        cat_bottleneck: bool = False,
        cat_bottleneck_dim: int = 0,
        share_seg_weights: bool = False,
        use_seg_embed: bool = False,
        attn_impl: str = "auto",
        scan_layers: bool = False,
        dtype=torch.bfloat16,
        table_shard=None,
    ):
        super().__init__()
        # JAX's ScannedSTUStack (hstu.py:126-178) runs the layers under
        # lax.scan to shorten XLA's compile; eager PyTorch has no such
        # compile, so the scanned model is the unrolled one, with one
        # checkpoint layout for both (convert.py maps the scanned flax tree)
        if scan_layers and enable_relative_attention_bias:
            raise ValueError("scan_layers is incompatible with per-layer relative bias")
        self.item_num = item_num
        self.max_seq_length = max_seq_length
        self.enable_relative_attention_bias = enable_relative_attention_bias
        self.apply_relative_attention_bias = apply_relative_attention_bias
        self.loss_type = loss_type
        self.fix_temp = fix_temp
        self.medusa_num_layers = medusa_num_layers
        self.num_segment_head = num_segment_head
        self.num_prior_head = num_prior_head
        self.head_interaction = head_interaction
        self.prior_switch = prior_switch
        self.master_switch = master_switch
        self.pred_len = pred_len
        self.nce_thres = nce_thres
        self.medusa_lambda = medusa_lambda
        self.neg_sample_by_cat = neg_sample_by_cat
        self.pos_sample_mix_ratio = pos_sample_mix_ratio
        self.prior_loss_weight = tuple(prior_loss_weight)
        self.prior_switch_loss_weight = prior_switch_loss_weight
        self.use_asym_switch_loss = use_asym_switch_loss
        self.gamma_pos = gamma_pos
        self.gamma_neg = gamma_neg
        self.switch_last_only = switch_last_only
        self.detach_aux_in = detach_aux_in
        self.nce_impl = nce_impl
        self.prior_loss_impl = prior_loss_impl
        self.eval_pred_len = eval_pred_len
        self.prior_given_at_test = prior_given_at_test
        self.given_prior_len = given_prior_len
        self.use_prior_switch_test = use_prior_switch_test
        self.int_to_category = int_to_category
        self.dtype = dtype
        # the data-parallel group (a DataMesh) when the trainer runs in a
        # process group: the negative pool is gathered over the ranks, the
        # loss means divide by global counts and random draws cover the
        # global batch
        self.mesh = None
        D = hstu_embedding_size

        # ``table_shard`` (a RowShard, ``shard_item_embedding``): the table
        # is this rank's block of rows from the start
        self.item_embedding = ItemEmbed(item_num, item_embedding_size, table_shard)
        self.item_proj = (
            nn.Linear(item_embedding_size, D, bias=False)
            if item_embedding_size != D else None
        )
        self.position_embedding = nn.Embedding(max_seq_length + 1, D)
        self.stu_layers = nn.ModuleList(
            STULayer(D, D // n_heads, D // n_heads, n_heads,
                     linear_activation=hidden_act or "silu", attn_impl=attn_impl,
                     dtype=dtype, dropout_ratio=hidden_dropout_prob)
            for _ in range(n_layers)
        )
        if enable_relative_attention_bias:
            from mhrec_tpu_torch.models.idnet.rel_bias import (
                RelativeBucketedTimeAndPositionBasedBias,
            )

            self.rel_bias = nn.ModuleList(
                RelativeBucketedTimeAndPositionBasedBias(2 * max_seq_length)
                for _ in range(n_layers)
            )
        if fix_temp:
            self.register_buffer("logit_scale", torch.tensor(math.log(1 / 0.05)))
        else:
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.05)))

        self._build_heads(D, head_norm, cat_bottleneck, cat_bottleneck_dim,
                          share_seg_weights, use_seg_embed)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """Random initialisation from ``gen``, with the JAX package's
        initialiser families (truncated normal 0.02 outside the trunk,
        normal 0.02 for uvqk, xavier-uniform o_proj, identity norms)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_parameters"):
                m.init_parameters(gen)  # STU layers, res blocks, rel-bias
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.item_embedding.trunc_normal_rows(gen)
        trunc_normal_init(self.position_embedding.weight, gen)
        if self.item_proj is not None:
            trunc_normal_init(self.item_proj.weight, gen)
        if not self.fix_temp:
            self.logit_scale.fill_(math.log(1 / 0.05))
        self._init_head_parameters(gen)

    # ------------------------------------------------------------------
    def _embed_items(self, items, sub=None):
        """Under ``sparse_item_adam`` the trainer passes the gathered
        per-batch sub-table ``sub`` and the ids are local indices into it."""
        # a bf16 table's rows are read in float32, as JAX promotes them
        # against the float32 position table and item_proj kernel
        emb = self.item_embedding(items, sub).float()
        if self.item_proj is not None:
            emb = self.item_proj(emb)
        return emb

    def encode(self, items_ctx, sub=None, generator=None):
        """Trunk forward over the context window.

        items_ctx: [B, L] int. Returns output_embs [B, L, D] (model dtype).
        ``generator`` turns on the STU layers' dropout (training).
        """
        B, L = items_ctx.shape
        emb = self._embed_items(items_ctx, sub)
        x = (emb + self.position_embedding.weight[:L][None]).to(self.dtype)
        nonpad = items_ctx != 0
        for i, layer in enumerate(self.stu_layers):
            bias = None
            if self.enable_relative_attention_bias and self.apply_relative_attention_bias:
                bias = self.rel_bias[i](None)[:, :L, :L]
            x = layer(x, nonpad, attn_bias=bias, generator=generator, shard=self.mesh)
        return x

    def forward(self, batch, sub=None, generator=None):
        """Training forward → dict with 'loss' and detached logging scalars
        (JAX ``HSTU.__call__``, hstu.py:484-507).

        batch: items [B, L+P], neg_items [B, NC, K], masked_index [B, L+P],
        tag_categories [B, L+P, C] (prior loss only); under
        ``sparse_item_adam`` the ids index ``sub`` [U, D]. ``generator``
        draws the dropout masks and the positive-mix draws."""
        items = batch["items"]
        neg_items = batch["neg_items"]
        user_mask = batch["masked_index"].bool()
        L = self.max_seq_length
        pos_items_embs = self._embed_items(items, sub)  # [B, L+P, D]
        ctx_items = torch.where(user_mask[:, :L], items[:, :L], torch.zeros_like(items[:, :L]))
        output_embs = self.encode(ctx_items, sub=sub, generator=generator)

        def neg_norm(col):
            neg = cosine_normalize(self._embed_items(neg_items[:, col], sub).float())
            neg = neg.reshape(-1, neg.shape[-1])
            # the global batch's pool (JAX _neg_norm flattens neg_items of
            # the global batch): every rank's rows, in rank order; the
            # loss's products sum its gradient over the ranks
            return neg if self.mesh is None else self.mesh.all_gather_rows(neg, "pool_gather")

        return compute_multihead_losses(self, output_embs, pos_items_embs, user_mask,
                                        batch.get("tag_categories"), neg_norm, generator)

    def predict_embeddings(self, item_seq, target_tags=None):
        """Eval-time user/head embeddings (reference hstu.py:874-971); see
        ``predict_switch_and_heads`` for the returned dict."""
        output_embs = self.encode(item_seq)
        return predict_switch_and_heads(self, output_embs[:, -1], target_tags)

    def item_features(self, w):
        """Scoring features of raw table rows ``w`` [..., D]: projected
        (``item_proj``) and normalized, row by row."""
        w = w.float()
        if self.item_proj is not None:
            w = self.item_proj(w)
        return cosine_normalize(w)

    def compute_item_all(self):
        """Normalized full item-embedding matrix (reference hstu.py:1018-1021)
        of an unsharded table; a sharded one is scored chunk by chunk
        (``compute_item_rows``)."""
        return self.item_features(self.item_embedding.weight[: self.item_num])

    def compute_item_rows(self, a: int, b: int):
        """Rows [a, b) of ``compute_item_all``'s matrix; a sharded table's
        rows come from their owners (a collective)."""
        return self.item_features(self.item_embedding.rows(a, b))


# ----------------------------------------------------------------------
def hstu_from_config(config, dataload, dtype=torch.bfloat16, mesh=None) -> HSTU:
    """Build an HSTU from a Config + InteractionData (the JAX package's
    ``hstu_from_config``, hstu.py:604-670). Under ``shard_item_embedding``
    the item table is built as the block of rows of this rank of ``mesh``
    (a DataMesh; one rank of one without it)."""
    table_shard = None
    if config.get("shard_item_embedding", False):
        table_shard = RowShard(dataload.item_num, mesh or make_mesh())
    loss = config["loss"]
    num_prior = config["num_prior_head"] or 1
    if loss == "prior" and config["weighted_prior_loss"]:
        all_counts = sum(dataload.category_counts.values())
        weights = [0.0] * num_prior
        for cat, cnt in dataload.category_counts.items():
            weights[dataload.category_to_int[cat]] = cnt / all_counts
    else:
        weights = [1.0 / num_prior] * num_prior
    i2c = config["int_to_category"] or {}
    eval_pred_len = config["eval_pred_len"]
    prior_given = bool(config.get("prior_given_at_test", False))
    return HSTU(
        item_num=dataload.item_num,
        item_embedding_size=config["item_embedding_size"],
        hstu_embedding_size=config["hstu_embedding_size"],
        max_seq_length=config["MAX_ITEM_LIST_LENGTH"],
        n_layers=config["n_layers"],
        n_heads=config["n_heads"],
        hidden_act=config["hidden_act"] or "silu",
        enable_relative_attention_bias=bool(config["enable_relative_attention_bias"]),
        apply_relative_attention_bias=bool(config.get("apply_relative_attention_bias", False)),
        loss_type=loss,
        fix_temp=bool(config["fix_temp"]),
        pred_len=config["pred_len"],
        hidden_dropout_prob=config["hidden_dropout_prob"] or 0.0,
        nce_thres=config["nce_thres"] or 0.99,
        medusa_lambda=config["medusa_lambda"],
        neg_sample_by_cat=bool(config["neg_sample_by_cat"]) and loss == "prior",
        pos_sample_mix_ratio=config["pos_sample_mix_ratio"] or 0.0,
        prior_loss_weight=tuple(weights),
        prior_switch_loss_weight=config["prior_switch_loss_weight"] or 0.0,
        use_asym_switch_loss=config.get("asym_switch_loss", False),
        gamma_pos=config.get("gamma_pos", 4.0),
        gamma_neg=config.get("gamma_neg", 0.0),
        switch_last_only=config.get("switch_last_only", False),
        detach_aux_in=config.get("detach_aux_in", False),
        nce_impl=str(config.get("nce_impl") or "banded"),
        prior_loss_impl=str(config.get("prior_loss_impl") or "loop"),
        medusa_num_layers=config["medusa_num_layers"] or 0,
        num_segment_head=config["num_segment_head"] or 1,
        num_prior_head=num_prior,
        head_interaction=config["head_interaction"],
        prior_switch=config["prior_switch"],
        master_switch=config.get("master_switch", False),
        eval_pred_len=eval_pred_len,
        prior_given_at_test=prior_given,
        given_prior_len=(config.get("given_prior_len", eval_pred_len)
                         if prior_given else eval_pred_len),
        use_prior_switch_test=config.get("use_prior_switch_test", False),
        int_to_category=tuple(i2c.get(i, str(i)) for i in range(num_prior)),
        head_norm=config.get("head_norm", False),
        cat_bottleneck=config.get("cat_bottleneck", False),
        cat_bottleneck_dim=config.get("cat_bottleneck_dim", 0) or 0,
        share_seg_weights=config.get("share_seg_weights", False),
        use_seg_embed=config.get("segment_embed", False),
        attn_impl=config.get("attn_impl", "auto"),
        scan_layers=bool(config.get("scan_layers", False)),
        dtype=dtype,
        table_shard=table_shard,
    )
