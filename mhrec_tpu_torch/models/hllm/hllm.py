"""HLLM — two-tower LLM recommender (port of
``mhrec_tpu/models/hllm/hllm.py``).

* the **item tower** encodes each item's text into one embedding: the hidden
  state at the trailing learnable ``item_emb_tokens`` slot
  (``item_emb_token_n`` ≥ 1) or masked mean pooling (0, and the dummy
  backend), over a dense padded batch (``encode_items``) or packed chunk
  rows (``encode_items_packed``, through the packed attention kernel);
* the **user tower** runs over the sequence of item embeddings
  (``inputs_embeds``) with the user attention mask; its last hidden state
  feeds the same multi-head machinery as HSTU (``MedusaHeads``), and
  ``score_items`` is HSTU's;
* ``freeze_item_llm`` swaps the item tower for a precomputed table;
* ``forward`` is the training forward: the items of a batch (positives and
  negatives) through the item tower — packed, deduplicated or dense, as the
  text train batcher lays them out — or the frozen table, the positives
  through the user tower, then ``compute_multihead_losses`` as for HSTU; in
  a process group (``mesh``) each rank encodes its own rows' items and the
  negative pool is gathered over the ranks in rank order;
* the towers are Llama-family decoders (RoPE or ALiBi) or BERT encoders,
  as each pretrain directory's ``config.json`` says, and
  ``load_pretrained_towers`` reads their weights from that directory;
* under ``tp_size > 1`` each rank of a model group holds its shards of the
  Llama towers' projections (``models/llm/llama.py``, ``parallel/tensor.py``)
  and the ranks of the group hold the same rows of every batch; the item
  tower's pool is gathered over the data group;
* ``use_image`` / ``use_video`` add a ``visual`` tower (Qwen2-VL's, or a
  CLIP / LLaVA one, as the item directory's ``vision_config`` says) whose
  tokens the item tower splices over each item's image-pad span, with
  M-RoPE positions for a Qwen2-VL item tower; the dense item tower only.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mhrec_tpu_torch.models.idnet.hstu import MedusaHeads
from mhrec_tpu_torch.models.layers import LayerNorm, cosine_normalize
from mhrec_tpu_torch.models.llm import loader
from mhrec_tpu_torch.models.llm.bert import BertBackbone
from mhrec_tpu_torch.models.llm.config import LLMConfig
from mhrec_tpu_torch.models.llm.dummy import DummyLLM
from mhrec_tpu_torch.models.llm.llama import LlamaBackbone
from mhrec_tpu_torch.models.llm.vision import (ClipVisionTower, VisionConfig, VisionTower,
                                               has_vision_weights, load_any_vision_params)
from mhrec_tpu_torch.models.multihead import compute_multihead_losses, predict_switch_and_heads
from mhrec_tpu_torch.parallel.tensor import TPGroup, local_shard, split_params
from mhrec_tpu_torch.utils.enums import InputType

logger = logging.getLogger(__name__)

# the dynamic-resolution keys of one item group (data/textset.py
# _emit_image_keys), beside its pixel_patches
IMAGE_EXTRA_KEYS = ("patch_valid", "patch_hw", "img_src", "img_pos", "tok_src")


def batch_image_extra(batch, prefix: str):
    """The dynamic-resolution image arrays of one item group, or None."""
    p = f"{prefix}_" if prefix else ""
    if batch.get(f"{p}img_src") is None:
        return None
    return {k: batch[f"{p}{k}"] for k in IMAGE_EXTRA_KEYS if f"{p}{k}" in batch}


class HLLM(MedusaHeads, nn.Module):
    input_type = InputType.SEQ
    needs_item_corpus_pass = True  # the trainer runs the text-encode pass

    def __init__(
        self,
        item_config: LLMConfig,
        user_config: LLMConfig,
        max_seq_length: int,
        pred_len: int,
        dummy_llm: bool = False,
        freeze_item_llm: bool = False,
        packed_item_tower: bool = False,
        item_num: int = 0,
        item_emb_token_n: int = 1,
        gradient_checkpointing: bool = False,
        use_image: bool = False,
        vision_config: Optional[VisionConfig] = None,
        img_grid: Tuple[int, int] = (16, 16),
        image_span_start: int = 1,
        vid_grid_t: int = 1,
        remat_policy: str = "full",
        nce_impl: str = "banded",
        prior_loss_impl: str = "loop",
        loss_type: str = "nce",
        nce_thres: float = 0.99,
        fix_temp: bool = False,
        medusa_lambda: float = 0.99,
        medusa_num_layers: int = 0,
        num_segment_head: int = 1,
        num_prior_head: int = 1,
        head_interaction: str = "multiplicative",
        neg_sample_by_cat: bool = False,
        pos_sample_mix_ratio: float = 0.0,
        prior_loss_weight: Tuple[float, ...] = (1.0,),
        prior_switch: Optional[str] = None,
        prior_switch_loss_weight: float = 0.0,
        use_asym_switch_loss: bool = False,
        gamma_pos: float = 4.0,
        gamma_neg: float = 0.0,
        switch_last_only: bool = False,
        master_switch: bool = False,
        detach_aux_in: bool = False,
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
        dtype=torch.bfloat16,
        tp: Optional[TPGroup] = None,
    ):
        super().__init__()
        self.item_config, self.user_config = item_config, user_config
        self.max_seq_length = max_seq_length
        self.pred_len = pred_len
        self.dummy_llm = dummy_llm
        self.freeze_item_llm = freeze_item_llm
        self.packed_item_tower = packed_item_tower
        self.item_num = item_num
        self.item_emb_token_n = item_emb_token_n
        self.nce_impl = nce_impl
        self.prior_loss_impl = prior_loss_impl
        self.loss_type = loss_type
        self.nce_thres = nce_thres
        self.fix_temp = fix_temp
        self.medusa_lambda = medusa_lambda
        self.medusa_num_layers = medusa_num_layers
        self.num_segment_head = num_segment_head
        self.num_prior_head = num_prior_head
        self.head_interaction = head_interaction
        self.neg_sample_by_cat = neg_sample_by_cat
        self.pos_sample_mix_ratio = pos_sample_mix_ratio
        self.prior_loss_weight = tuple(prior_loss_weight)
        self.prior_switch = prior_switch
        self.prior_switch_loss_weight = prior_switch_loss_weight
        self.use_asym_switch_loss = use_asym_switch_loss
        self.gamma_pos = gamma_pos
        self.gamma_neg = gamma_neg
        self.switch_last_only = switch_last_only
        self.master_switch = master_switch
        self.detach_aux_in = detach_aux_in
        self.eval_pred_len = eval_pred_len
        self.prior_given_at_test = prior_given_at_test
        self.given_prior_len = given_prior_len
        self.use_prior_switch_test = use_prior_switch_test
        self.int_to_category = int_to_category
        self.dtype = dtype
        # the data-parallel group (a DataMesh) when the trainer runs in a
        # process group: the negative pool is gathered over its data ranks, the
        # loss means divide by global counts and random draws cover the
        # global batch
        self.mesh = None
        # image branch: a vision tower whose tokens are spliced over the
        # image-pad span of each item's text (reference hllm.py:399-464);
        # vid_grid_t > 1: that span holds vid_grid_t temporal groups of
        # gh·gw patches, attended block-diagonally, M-RoPE's t advancing
        self.vision_config = vision_config
        self.img_grid = tuple(img_grid)
        self.image_span_start = image_span_start
        self.vid_grid_t = vid_grid_t

        def make_llm(cfg: LLMConfig, token_embeddings: bool):
            if dummy_llm:
                return DummyLLM(cfg.vocab_size, cfg.hidden_size,
                                token_embeddings=token_embeddings)
            if cfg.model_type == "bert":
                return BertBackbone(cfg, dtype=dtype, token_embeddings=token_embeddings)
            # llama / mistral / qwen2 / tinyllama / baichuan share the
            # decoder topology (RMSNorm + RoPE + GQA + SwiGLU)
            return LlamaBackbone(cfg, dtype=dtype, gradient_checkpointing=gradient_checkpointing,
                                 token_embeddings=token_embeddings, remat_policy=remat_policy,
                                 tp=tp)

        if freeze_item_llm:
            # the precomputed table, filled by the trainer from
            # ``all_item_embeds_path``
            self.register_buffer("all_item_embeds",
                                 torch.zeros(item_num, item_config.hidden_size))
        else:
            self.item_llm = make_llm(item_config, token_embeddings=True)
            if use_image and not dummy_llm:
                vcfg = vision_config or VisionConfig.tiny(item_config.hidden_size)
                if vcfg.arch == "clip":
                    if vid_grid_t > 1:
                        raise NotImplementedError(
                            "video inputs need the Qwen2-VL tower (temporal patch pairs); "
                            "CLIP towers are image-only")
                    self.visual = ClipVisionTower(vcfg, *self.img_grid, dtype=dtype,
                                                  gradient_checkpointing=gradient_checkpointing)
                else:
                    self.visual = VisionTower(vcfg, *self.img_grid, dtype=dtype,
                                              gradient_checkpointing=gradient_checkpointing,
                                              grid_t=vid_grid_t)
        # the user tower reads item embeddings, never token ids
        self.user_llm = make_llm(user_config, token_embeddings=False)
        D = user_config.hidden_size
        if item_emb_token_n > 0 and not freeze_item_llm:
            self.item_emb_tokens = nn.Parameter(
                torch.empty(1, item_emb_token_n, item_config.hidden_size))
        if fix_temp:
            self.register_buffer("logit_scale", torch.tensor(math.log(1 / 0.07)))
        else:
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self._build_heads(D, head_norm, cat_bottleneck, cat_bottleneck_dim,
                          share_seg_weights, use_seg_embed)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """Random initialisation from ``gen`` with the JAX package's
        initialiser families: normal 0.02 for the towers and the emb-token
        slots, truncated normal 0.02 for the heads, logit scale ln(1/0.07)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_parameters"):
                m.init_parameters(gen)  # towers, res blocks
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if hasattr(self, "item_emb_tokens"):
            self.item_emb_tokens.normal_(0.0, 0.02, generator=gen)
        if not self.fix_temp:
            self.logit_scale.fill_(math.log(1 / 0.07))
        self._init_head_parameters(gen)

    # ------------------------------------------------------------------
    def _image_mrope_positions(self, T: int) -> np.ndarray:
        """[3, T] (t, h, w) M-RoPE positions of the fixed item layout
        [prefix][image / video pads][text...]: the pads at (t, h, w) of their
        post-merger grid, offset by the span start; the text after the span
        continues at start + max(grid_t, gh/m, gw/m) (the JAX package's
        layout, hllm.py:284-299, one image or grid_t temporal groups an item)."""
        m = (self.vision_config or VisionConfig.tiny()).spatial_merge_size
        gt = max(self.vid_grid_t, 1)
        hm, wm = self.img_grid[0] // m, self.img_grid[1] // m
        s, n = self.image_span_start, gt * hm * wm
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (3, T)).copy()
        j = np.arange(n)
        pos[0, s:s + n] = s + j // (hm * wm)
        pos[1, s:s + n] = s + (j % (hm * wm)) // wm
        pos[2, s:s + n] = s + j % wm
        pos[:, s + n:] = s + max(gt, hm, wm) + np.arange(T - s - n, dtype=np.int32)
        return pos

    def _image_kwargs(self, tokens, pixel_patches, image_extra=None):
        """The vision tower's call and the item backbone's splice and
        position arguments. ``image_extra`` (dynamic resolution,
        data/textset.py ``dynamic_image_arrays``): patch_valid, patch_hw,
        img_src and img_pos, or tok_src (LLaVA AnyRes) and img_src."""
        if pixel_patches is None or self.dummy_llm or self.freeze_item_llm:
            return {}
        N, T = tokens.shape
        if image_extra and image_extra.get("img_src") is not None:
            if image_extra.get("tok_src") is not None:
                img_tokens = self.visual(pixel_patches, tok_src=image_extra["tok_src"])
            else:
                img_tokens = self.visual(pixel_patches, patch_valid=image_extra["patch_valid"],
                                         patch_hw=image_extra["patch_hw"])
            extra = {"image_embeds": img_tokens, "image_src": image_extra["img_src"]}
            if self.item_config.mrope_section:
                # the host's per-item (t, h, w) positions [N, 3, T]
                extra["position_ids"] = image_extra["img_pos"].permute(1, 0, 2)
            return extra
        img_tokens = self.visual(pixel_patches)  # [N, n_img, D]
        extra = {"image_embeds": img_tokens,
                 "image_span": (self.image_span_start, img_tokens.shape[1])}
        if self.item_config.mrope_section:
            pos = torch.from_numpy(self._image_mrope_positions(T)).to(tokens.device)
            extra["position_ids"] = pos[:, None, :].expand(3, N, T)
        return extra

    def encode_items(self, tokens: torch.Tensor, lens: torch.Tensor,
                     pixel_patches: Optional[torch.Tensor] = None,
                     image_extra=None) -> torch.Tensor:
        """Item tower over a padded token batch [N, T + n_emb] (and the
        items' patches under use_image) → [N, D_item] float32."""
        N, T = tokens.shape
        col = torch.arange(T, device=tokens.device)[None, :]
        extra = self._image_kwargs(tokens, pixel_patches, image_extra)
        if self.item_emb_token_n > 0 and not self.dummy_llm:
            n_emb = self.item_emb_token_n
            # the n trailing emb slots attend; the embedding is read from
            # the last one (it attends to the text and the earlier slots)
            attn_mask = (col < lens[:, None] + n_emb).int()
            hidden = self.item_llm(input_ids=tokens, attention_mask=attn_mask,
                                   emb_tokens=self.item_emb_tokens, emb_pos=lens, **extra)
            emb = hidden[torch.arange(N, device=tokens.device), lens + (n_emb - 1)]
        else:  # mean pooling over the real tokens
            attn_mask = (col < lens[:, None]).int()
            hidden = self.item_llm(input_ids=tokens, attention_mask=attn_mask, **extra)
            m = attn_mask[..., None].to(hidden.dtype)
            emb = (hidden * m).sum(dim=1) / torch.clamp(lens[:, None].to(hidden.dtype), min=1)
        return emb.float()

    def encode_items_packed(self, packed_tokens, segment_ids, positions, emb_slots):
        """Packed item tower: chunk rows [C, chunk] (or one flat stream [S])
        of tokens, segment ids and within-segment positions; ``emb_slots``
        [N] flat index of each item's first trailing emb slot → [N, D_item]
        float32 read from each item's last slot."""
        if self.item_emb_token_n <= 0:
            raise ValueError("the packed item tower reads the emb-token slot "
                             "(item_emb_token_n >= 1)")
        flat_mode = packed_tokens.dim() == 1
        if flat_mode:
            packed_tokens, positions = packed_tokens[None], positions[None]
        hidden = self.item_llm(input_ids=packed_tokens, position_ids=positions,
                               segment_ids=segment_ids, emb_tokens=self.item_emb_tokens,
                               emb_pos=emb_slots)
        flat = hidden.reshape(-1, hidden.shape[-1])
        return flat[emb_slots + (self.item_emb_token_n - 1)].float()

    def compute_item_chunk(self, tokens, lens, pixel_patches=None, image_extra=None):
        """Corpus-embedding pass chunk (reference compute_item)."""
        return self.encode_items(tokens, lens, pixel_patches, image_extra)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        """Training forward → dict with 'loss' and detached logging scalars
        (JAX ``HLLM.__call__``, hllm.py:411-493).

        batch: items [B, L+P], neg_items [B, NC, K], masked_index [B, L+P],
        tag_categories [B, L+P, C] (prior loss), and the items' texts in the
        text train batcher's layout — packed (packed_tokens,
        packed_segment_ids, packed_positions [C, chunk] and emb_slots over
        the B·(L+P) positives, then the B·NC·K negatives), deduplicated
        (uniq_tokens, uniq_token_lens, uniq_inverse) or dense (pos_tokens,
        pos_token_lens, neg_tokens, neg_token_lens) — or none of them under
        ``freeze_item_llm``; under use_image each dense or deduplicated group
        also carries its patches and dynamic maps ({pos,neg,uniq}_
        pixel_patches, ...). ``generator`` draws the positive-mix draws."""
        user_mask = batch["masked_index"].bool()
        L = self.max_seq_length
        B, W = batch["items"].shape
        if self.freeze_item_llm:
            table = self.all_item_embeds
            pos_items_embs = table[batch["items"]]

            def neg_of(col):
                return table[batch["neg_items"][:, col]]
        else:
            if self.packed_item_tower:
                all_embs = self.encode_items_packed(
                    batch["packed_tokens"], batch["packed_segment_ids"],
                    batch["packed_positions"], batch["emb_slots"])
            elif "uniq_tokens" in batch:
                # each distinct item encoded once, gathered per occurrence
                all_embs = self.encode_items(
                    batch["uniq_tokens"], batch["uniq_token_lens"],
                    batch.get("uniq_pixel_patches"),
                    batch_image_extra(batch, "uniq"))[batch["uniq_inverse"]]
            else:
                all_embs = torch.cat([
                    self.encode_items(batch[f"{g}_tokens"], batch[f"{g}_token_lens"],
                                      batch.get(f"{g}_pixel_patches"),
                                      batch_image_extra(batch, g))
                    for g in ("pos", "neg")])
            pos_items_embs = all_embs[:B * W].reshape(B, W, -1)
            neg_embs = all_embs[B * W:].reshape(B, batch["neg_items"].shape[1], -1,
                                                 all_embs.shape[-1])

            def neg_of(col):
                return neg_embs[:, col]

        def neg_norm(col):
            neg = neg_of(col)
            neg = cosine_normalize(neg.float()).reshape(-1, neg.shape[-1])
            # the global batch's pool (JAX _neg_norm over the global
            # neg_items): every rank's rows, in rank order; the loss's
            # products sum its gradient over the ranks
            return neg if self.mesh is None else self.mesh.all_gather_rows(neg, "pool_gather")

        user_hidden = self.user_llm(inputs_embeds=pos_items_embs[:, :L].to(self.dtype),
                                    attention_mask=user_mask[:, :L].int()).float()
        return compute_multihead_losses(self, user_hidden, pos_items_embs.float(), user_mask,
                                        batch.get("tag_categories"), neg_norm, generator)

    # ------------------------------------------------------------------
    def predict_embeddings(self, item_seq, target_tags=None, item_feature_table=None,
                           seq_embeds=None):
        """Eval path: the user tower over the raw item-embedding table's rows
        of ``item_seq`` (or the given ``seq_embeds`` [B, L, D]); see
        ``predict_switch_and_heads`` for the returned dict."""
        attn = (item_seq > 0).int()
        if seq_embeds is None:
            if item_feature_table is None:
                raise ValueError("HLLM predict needs the item table")
            seq_embeds = item_feature_table[item_seq]
        hidden = self.user_llm(inputs_embeds=seq_embeds.to(self.dtype), attention_mask=attn)
        return predict_switch_and_heads(self, hidden[:, -1], target_tags)


def load_tower_weights(tower: nn.Module, path: str) -> Optional[dict]:
    """The weights of a local HF checkpoint directory into one tower (its
    ``config.json`` says Llama-family or BERT), cast to the tower's
    parameter dtype on its device. Returns the bytes read and the seconds
    taken, or None when the directory holds no weight files and no index;
    a missing shard, a file that does not parse, or a checkpoint that does
    not cover the tower, raises."""
    t0 = time.perf_counter()
    try:
        sd = loader.load_state_dict(path)
    except loader.NoWeightFiles:
        return None
    cfg = LLMConfig.from_pretrained_dir(path)
    to_tower = (loader.bert_state_dict_from_hf if cfg.model_type == "bert"
                else loader.llama_state_dict_from_hf)
    has_table = hasattr(tower, "embed_tokens") or hasattr(tower, "word_embeddings")
    state = to_tower(sd, cfg, token_embeddings=has_table)
    for name, (dim, tp) in split_params(tower).items():
        state[name] = local_shard(state[name], dim, tp)  # a tensor-parallel shard
    loader.load_into(tower, state)
    return {"bytes": sum(t.numel() * t.element_size() for t in state.values()),
            "seconds": time.perf_counter() - t0}


def vision_config_for(config, path: str) -> VisionConfig:
    """The item directory's ``vision_config`` with the run's AnyRes
    settings: ``anyres_grid`` (fixed grid) and ``dynamic_image_res`` on a
    CLIP tower (dynamic AnyRes)."""
    vcfg = VisionConfig.from_pretrained_dir(path)
    anyres = config.get("anyres_grid") or None
    if anyres:
        vcfg = dataclasses.replace(vcfg, anyres_grid=tuple(int(x) for x in anyres))
    if config.get("dynamic_image_res") and vcfg.arch == "clip":
        vcfg = dataclasses.replace(vcfg, dynamic_anyres=True)
    return vcfg


def load_vision_weights(visual: nn.Module, path: str, config) -> Optional[dict]:
    """The ``visual.*`` (Qwen2-VL) or ``vision_tower.*`` and
    ``multi_modal_projector.*`` (LLaVA) weights of the item checkpoint into
    the vision tower (JAX hllm.py:549-570). Returns the bytes read and the
    seconds taken, or None when the checkpoint holds no vision weights."""
    t0 = time.perf_counter()
    try:
        sd = loader.load_state_dict(path)
    except loader.NoWeightFiles:
        return None
    if not has_vision_weights(sd):
        return None
    state = load_any_vision_params(sd, vision_config_for(config, path))
    loader.load_into(visual, state)
    return {"bytes": sum(t.numel() * t.element_size() for t in state.values()),
            "seconds": time.perf_counter() - t0}


def load_pretrained_towers(model: HLLM, config) -> HLLM:
    """Local HF checkpoint weights for the towers (reference create_llm
    from_pretrained, hllm.py:294-376; JAX hllm.py:520-587), and the vision
    tower's from the item checkpoint. A tower keeps its random
    initialisation when ``*_llm_init`` is false or its pretrain directory
    holds only a ``config.json`` (or, for the vision tower, no vision
    weights). What each tower read is kept in ``model.tower_load_stats``.
    ``item_emb_pretrain`` warm-starts the emb-token slots from a ``.npy``
    file or a saved tensor."""
    model.tower_load_stats = {}
    for tower, dir_key, init_key in (("item_llm", "item_pretrain_dir", "item_llm_init"),
                                     ("user_llm", "user_pretrain_dir", "user_llm_init")):
        path = config.get(dir_key)
        if not hasattr(model, tower) or not path or not os.path.isdir(str(path)):
            continue
        if config.get(init_key, True) is False:
            continue
        stats = load_tower_weights(getattr(model, tower), str(path))
        if stats is not None:
            model.tower_load_stats[tower] = stats
            logger.info("loaded %s from %s: %d bytes in %.2fs", tower, path, stats["bytes"],
                        stats["seconds"])
            if tower == "item_llm" and hasattr(model, "visual"):
                vstats = load_vision_weights(model.visual, str(path), config)
                if vstats is not None:
                    model.tower_load_stats["visual"] = vstats
                    logger.info("loaded visual from %s: %d bytes in %.2fs", path,
                                vstats["bytes"], vstats["seconds"])
    pre = config.get("item_emb_pretrain")
    if pre and hasattr(model, "item_emb_tokens"):
        if str(pre).endswith(".npy"):
            arr = torch.from_numpy(np.load(pre))
        else:
            arr = torch.load(pre, map_location="cpu", weights_only=True)
        cur = model.item_emb_tokens
        with torch.no_grad():
            cur.copy_(arr.float().reshape(cur.shape))
        logger.info("loaded item_emb_tokens from %s with %s", pre, tuple(arr.shape))
    return model


def compute_dtype(config) -> torch.dtype:
    """The towers' compute type from the reference's ``precision`` key
    (bf16-mixed by default; '32' / 'fp32' give float32), hllm.py:677-681."""
    prec = str(config.get("precision") or "bf16-mixed")
    return torch.float32 if "32" in prec and "bf16" not in prec else torch.bfloat16


def hllm_from_config(config, dataload, dtype=None, mesh=None) -> HLLM:
    """Build an HLLM from a Config + InteractionData (the JAX package's
    ``hllm_from_config``, hllm.py:592-730). ``dtype`` overrides the compute
    type that ``precision`` selects. ``mesh`` (a DataMesh): under
    ``tp_size > 1`` the Llama towers hold this rank's shards of its model
    group; without one they stay whole."""
    loss = config["loss"]
    num_prior = config["num_prior_head"] or 1
    if loss == "prior" and config["weighted_prior_loss"]:
        total_count = sum(dataload.category_counts.values())
        weights = [0.0] * num_prior
        for cat, cnt in dataload.category_counts.items():
            weights[dataload.category_to_int[cat]] = cnt / total_count
    else:
        weights = [1.0 / num_prior] * num_prior

    dummy = bool(config.get("dummy_llm", False))
    item_dir = config.get("item_pretrain_dir")
    user_dir = config.get("user_pretrain_dir")
    if dummy or not item_dir:
        vs = config.get("dummy_vocab_size", 1024)
        hs = config.get("dummy_hidden_size", 64)
        item_cfg = LLMConfig.tiny(vs, hs)
        user_cfg = LLMConfig.tiny(vs, hs)
        # random_init_towers: real (tiny) Llama towers without checkpoints;
        # the default keeps the reference's dummy_llm semantics
        dummy = not bool(config.get("random_init_towers", False)) or dummy
    else:
        item_cfg = LLMConfig.from_pretrained_dir(item_dir)
        user_cfg = LLMConfig.from_pretrained_dir(user_dir or item_dir)

    if int(config.get("tp_size", 1) or 1) > 1:
        # the Llama towers' projections split over the model group (JAX
        # hllm.py:621-623); BERT, the vision tower, the emb slots and the
        # heads stay whole
        item_cfg = dataclasses.replace(item_cfg, tp_shard=True)
        user_cfg = dataclasses.replace(user_cfg, tp_shard=True)
    if config.get("packed_item_tower", False):
        # bound the packed attention to a causal band of the max segment
        # length: the text and its emb slots
        window = int(config.get("MAX_TEXT_LENGTH", 64)) + int(
            config.get("item_emb_token_n", 1) or 0)
        item_cfg = dataclasses.replace(item_cfg, packed_window=window)

    use_image = bool(config.get("use_image", False))
    use_video = bool(config.get("use_video", False))
    if use_image and use_video:
        raise ValueError("use_image and use_video are mutually exclusive")
    use_image = use_image or use_video  # the video span rides the image plumbing
    vision_cfg, img_grid, vid_grid_t = None, (16, 16), 1
    if use_image:
        if config.get("packed_item_tower"):
            raise ValueError("use_image/use_video is incompatible with packed_item_tower "
                             "(dense padded batches carry the vision span)")
        if item_dir and os.path.isdir(str(item_dir)):
            try:
                vision_cfg = vision_config_for(config, str(item_dir))
            except (ValueError, FileNotFoundError):
                vision_cfg = None
        if vision_cfg is None:
            vision_cfg = VisionConfig.tiny(item_cfg.hidden_size)
        if config.get("anyres_grid") and vision_cfg.arch != "clip":
            raise ValueError("anyres_grid is a LLaVA-family (CLIP tower) feature; the "
                             "Qwen2-VL tower uses its own native grid")
        img_grid = (int(config.get("img_height", 224)) // vision_cfg.patch_size,
                    int(config.get("img_width", 224)) // vision_cfg.patch_size)
        if use_video:
            vid_grid_t = max(int(config.get("video_nframes", 4) or 4)
                             // vision_cfg.temporal_patch_size, 1)

    i2c = config["int_to_category"] or {}
    eval_pred_len = config["eval_pred_len"]
    prior_given = bool(config.get("prior_given_at_test", False))
    return HLLM(
        dtype=dtype or compute_dtype(config),
        item_config=item_cfg,
        user_config=user_cfg,
        max_seq_length=config["MAX_ITEM_LIST_LENGTH"],
        pred_len=config["pred_len"],
        dummy_llm=dummy,
        freeze_item_llm=bool(config.get("freeze_item_llm", False)),
        packed_item_tower=bool(config.get("packed_item_tower", False)),
        item_num=dataload.item_num,
        item_emb_token_n=config.get("item_emb_token_n", 1) or 0,
        gradient_checkpointing=bool(config.get("gradient_checkpointing", False)),
        remat_policy=str(config.get("remat_policy") or "full"),
        nce_impl=str(config.get("nce_impl") or "banded"),
        prior_loss_impl=str(config.get("prior_loss_impl") or "loop"),
        use_image=use_image,
        vision_config=vision_cfg,
        img_grid=img_grid,
        vid_grid_t=vid_grid_t,
        loss_type=loss,
        nce_thres=config["nce_thres"] or 0.99,
        fix_temp=bool(config["fix_temp"]),
        medusa_lambda=config["medusa_lambda"],
        medusa_num_layers=config["medusa_num_layers"] or 0,
        num_segment_head=config["num_segment_head"] or 1,
        num_prior_head=num_prior,
        head_interaction=config["head_interaction"],
        neg_sample_by_cat=bool(config["neg_sample_by_cat"]) and loss == "prior",
        pos_sample_mix_ratio=config["pos_sample_mix_ratio"] or 0.0,
        prior_loss_weight=tuple(weights),
        prior_switch=config["prior_switch"],
        prior_switch_loss_weight=config["prior_switch_loss_weight"] or 0.0,
        use_asym_switch_loss=config.get("asym_switch_loss", False),
        gamma_pos=config.get("gamma_pos", 4.0),
        gamma_neg=config.get("gamma_neg", 0.0),
        switch_last_only=config.get("switch_last_only", False),
        master_switch=config.get("master_switch", False),
        detach_aux_in=config.get("detach_aux_in", False),
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
        tp=mesh.tp_group if mesh is not None else None,
    )
