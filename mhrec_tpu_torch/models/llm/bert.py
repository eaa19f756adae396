"""BERT-style bidirectional encoder tower (port of
``mhrec_tpu/models/llm/bert.py``; the reference's patched
``modeling_bert.py``, an alternative HLLM item / user tower): learned
absolute position embeddings, the embedding LayerNorm, post-LN transformer
blocks with an exact-GELU feed-forward, attention over non-pad tokens
(bidirectional unless ``causal``).

As in the JAX package, the embedding LayerNorm's output is rounded to the
compute type ``dtype`` and the encoder then runs in float32 (flax's
``Dense`` promotes to its float32 parameters). The attention is dense: no
kernel computes it in either package. The tower takes no packed
(``segment_ids``) batch, and no gradient checkpointing: the flax module
takes the flag and never applies it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mhrec_tpu_torch.models.layers import LayerNorm, TransformerEncoder, trunc_normal_init
from mhrec_tpu_torch.models.llm.config import LLMConfig


class BertBackbone(nn.Module):
    def __init__(self, config: LLMConfig, dtype=torch.bfloat16, token_embeddings: bool = True):
        """``token_embeddings=False`` leaves out the word table of a tower
        that only takes ``inputs_embeds`` (the user tower), as flax creates
        it only when token ids arrive."""
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        if token_embeddings:
            self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.embeddings_ln = LayerNorm(c.hidden_size, eps=c.rms_norm_eps, dtype=torch.float32)
        self.encoder = TransformerEncoder(
            n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
            hidden_size=c.hidden_size, inner_size=c.intermediate_size,
            layer_norm_eps=c.rms_norm_eps)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """flax's initialisers: normal(0.02) embeddings, lecun-normal
        kernels (truncated normal of std 1/sqrt(fan in)), zero biases, unit
        LayerNorm scales."""
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, nn.Linear):
                trunc_normal_init(m.weight, gen, std=m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        causal: bool = False,
        emb_tokens: Optional[torch.Tensor] = None,  # [1, 1, D] learnable slot
        emb_pos: Optional[torch.Tensor] = None,     # [B] slot index per row
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if segment_ids is not None:
            raise NotImplementedError(
                "a BERT tower takes dense padded batches only (the JAX BertBackbone has "
                "no packed route): set packed_item_tower / packed_corpus_pass false")
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        if emb_tokens is not None and emb_pos is not None:
            if emb_tokens.shape[1] != 1:
                raise ValueError("a BERT tower takes one emb-token slot (item_emb_token_n 1)")
            # the learnable token replaces each row's slot emb_pos
            B, T, D = inputs_embeds.shape
            flat = inputs_embeds.reshape(B * T, D).clone()
            flat[torch.arange(B, device=emb_pos.device) * T + emb_pos] = \
                emb_tokens[0, 0].to(flat.dtype)
            inputs_embeds = flat.reshape(B, T, D)
        B, T, _ = inputs_embeds.shape
        if position_ids is None:
            position_ids = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
        x = self.embeddings_ln(inputs_embeds + self.position_embeddings(position_ids))
        x = x.to(self.dtype)
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=x.device)
        keep = attention_mask.bool()[:, None, None, :]
        if causal:
            keep = keep & torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        bias = torch.where(keep, 0.0, -1e9)
        return self.encoder(x, bias)
