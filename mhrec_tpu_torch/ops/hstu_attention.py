"""HSTU pointwise attention: ``silu(q·kᵀ)/n * mask`` — no softmax.

Port of ``mhrec_tpu/ops/hstu_attention.py`` (reference
``_hstu_attention_maybe_from_cache``, code/REC/model/IDNet/hstu.py:137-160).

* ``hstu_attention_plain`` — the einsum formulation, computed in the input
  dtype like the JAX package's ``hstu_attention_xla``;
* ``hstu_attention`` — the dispatcher: ``impl='pallas'`` takes the pointwise
  attention kernel (``hstu_attention_cuda.hstu_attention_v2``, which runs its
  plain version on CPU tensors); every other choice, and any relative bias,
  takes the plain path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mhrec_tpu_torch.ops import hstu_attention_cuda


def attention_mask(nonpad: torch.Tensor) -> torch.Tensor:
    """[B, L] key flags → [B, 1, L, L] bool mask, causal & non-pad key
    (reference get_attention_mask, hstu.py:1023-1030)."""
    L = nonpad.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=nonpad.device).tril()
    return nonpad[:, None, None, :] & causal


def hstu_attention_plain(
    q: torch.Tensor,       # [B, L, H, Dqk]
    k: torch.Tensor,       # [B, L, H, Dqk]
    v: torch.Tensor,       # [B, L, H, Dv]
    nonpad: torch.Tensor,  # [B, L] bool
    bias: Optional[torch.Tensor] = None,  # optional [B|1, L, L] relative bias
) -> torch.Tensor:         # [B, L, H, Dv]
    n = q.shape[1]
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k)
    if bias is not None:
        scores = scores + bias[:, None].to(scores.dtype)
    scores = F.silu(scores) * (1.0 / n)
    scores = scores * attention_mask(nonpad).to(scores.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", scores, v)


def hstu_attention(q, k, v, nonpad, impl: str = "auto", bias=None):
    """Dispatching entry point. ``impl``: 'auto' | 'xla' | 'pallas'.

    The names are the JAX package's: 'pallas' selects the attention kernel
    (the CUDA port of the Pallas kernel), 'xla' and 'auto' the plain path.
    The STU layer sends 'auto' and 'fused' to the fused kernel before it
    gets here (models/idnet/hstu.py)."""
    if bias is None and impl == "pallas":
        return hstu_attention_cuda.hstu_attention_v2(q, k, v, nonpad)
    return hstu_attention_plain(q, k, v, nonpad, bias)
