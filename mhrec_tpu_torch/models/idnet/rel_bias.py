"""Relative position / bucketed-time attention bias (port of
``mhrec_tpu/models/idnet/rel_bias.py``, reference hstu.py:53-131).

As in the reference and the JAX package, ``HSTU`` constructs one module per
layer under ``enable_relative_attention_bias`` but applies it only when
``apply_relative_attention_bias`` is set; by default the parameters exist so
checkpoints keep the same surface.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class RelativeBucketedTimeAndPositionBasedBias(nn.Module):
    def __init__(self, max_seq_len: int, num_buckets: int = 128):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.num_buckets = num_buckets
        self.ts_w = nn.Parameter(torch.empty(num_buckets + 1))
        self.pos_w = nn.Parameter(torch.empty(2 * max_seq_len - 1))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.ts_w.normal_(0.0, 0.02, generator=gen)
        self.pos_w.normal_(0.0, 0.02, generator=gen)

    def forward(self, timestamps=None):  # [B, N]
        n = self.max_seq_len
        if timestamps is None:
            # zero spans land in bucket 0
            timestamps = torch.zeros(1, n, dtype=torch.int64, device=self.ts_w.device)
        idx = torch.arange(n, device=self.ts_w.device)
        rel = idx[None, :] - idx[:, None] + n - 1
        pos_bias = self.pos_w[rel][None]  # [1, N, N]
        ext = torch.cat([timestamps, timestamps[:, n - 1: n]], dim=1)
        span = ext[:, 1:, None] - ext[:, None, :-1]
        bucket = torch.clamp(
            (torch.log(torch.clamp(span.abs(), min=1).float()) / 0.301).long(),
            0, self.num_buckets,
        )
        return pos_bias + self.ts_w[bucket]
