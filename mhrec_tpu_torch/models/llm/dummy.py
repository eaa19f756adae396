"""DummyLLM — embedding + linear debug backend (port of
``mhrec_tpu/models/llm/dummy.py``; reference layers.py:94-114): lets the
HLLM pipeline run without checkpoint-scale towers."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class DummyLLM(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, dtype=torch.float32,
                 token_embeddings: bool = True):
        super().__init__()
        self.dtype = dtype
        if token_embeddings:  # left out of a tower that only takes inputs_embeds
            self.input_layer = nn.Embedding(vocab_size, hidden_size)
        self.embed_layer = nn.Linear(hidden_size, hidden_size)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        if hasattr(self, "input_layer"):
            self.input_layer.weight.normal_(0.0, 0.02, generator=gen)
        self.embed_layer.weight.normal_(0.0, 0.02, generator=gen)
        self.embed_layer.bias.zero_()

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None, **_unused) -> torch.Tensor:
        """The masks, positions and emb-token slots the towers take are
        accepted and unused, as in the JAX package."""
        if input_ids is not None:
            if inputs_embeds is not None:
                raise ValueError("provide input_ids or inputs_embeds, not both")
            out = self.input_layer(input_ids)
        elif inputs_embeds is not None:
            out = inputs_embeds
        else:
            raise ValueError("provide input_ids or inputs_embeds")
        d = self.dtype
        return F.linear(out.to(d), self.embed_layer.weight.to(d), self.embed_layer.bias.to(d))
