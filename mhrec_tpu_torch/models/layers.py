"""Shared model building blocks (port of ``mhrec_tpu/models/layers.py``).

Initialisers take an explicit ``torch.Generator``; the JAX package's
initialisers have torch counterparts here so a randomly initialised port
model draws from the same distributions (not the same numbers).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax truncated_normal(stddev, lower=-2, upper=2) rescales so the truncated
# distribution has the requested std: std / 0.87962566103423978
_TRUNC_STD_CORRECTION = 0.87962566103423978


@torch.no_grad()
def trunc_normal_init(t: torch.Tensor, gen: torch.Generator, std: float = 0.02):
    """Counterpart of the JAX package's ``trunc_normal_init`` (reference
    truncated_normal(std=0.02) on everything outside the HSTU trunk)."""
    s = std / _TRUNC_STD_CORRECTION
    return nn.init.trunc_normal_(t, mean=0.0, std=s, a=-2 * s, b=2 * s, generator=gen)


@torch.no_grad()
def xavier_uniform_init(t: torch.Tensor, gen: torch.Generator):
    """flax ``xavier_uniform`` on a [in, out] kernel; torch stores Linear
    weights as [out, in], and the bound is symmetric in fan in/out."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    return t.uniform_(-bound, bound, generator=gen)


def cosine_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, eps) — NaN-safe on all-zero rows (see the JAX
    package's docstring for the reference forms this unifies)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm(dtype=...)``: statistics in float32 with the
    fast variance E[x²] − E[x]² (clipped at 0), affine in float32, result
    cast to ``dtype`` (the input's dtype when None)."""

    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__(dim, eps=eps)
        self.out_dtype = dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.out_dtype or x.dtype)


class ItemEmbed(nn.Module):
    """Item-embedding table (plain lookup; the JAX package's per-batch
    sub-table hook belongs to the training slice)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class ResBlock(nn.Module):
    """Linear + SiLU residual block (reference llm_heads.py:5-40)."""

    def __init__(self, hidden_size: int, use_norm: bool = False):
        super().__init__()
        self.norm = LayerNorm(hidden_size, eps=1e-5) if use_norm else None
        self.linear = nn.Linear(hidden_size, hidden_size)

    def init_parameters(self, gen: torch.Generator):
        trunc_normal_init(self.linear.weight, gen)
        trunc_normal_init(self.linear.bias, gen)

    def forward(self, x):
        if self.norm is not None:
            x = self.norm(x)
        return x + F.silu(self.linear(x))
