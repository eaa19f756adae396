"""Packed (varlen) attention for the item tower (port of
``mhrec_tpu/models/llm/packed.py``).

Items are concatenated into token rows with **segment ids**; attention is
causal *within* each segment and zero across segments — the
``flash_attn_varlen`` semantics of the reference. Chunked packing puts the
items first-fit into rows of ``chunk`` tokens ([C, chunk] arrays).

* ``pack_items`` / ``round_chunk_rows`` — host-side packing, copied;
* ``packed_attention_plain`` — the plain version: the math of the JAX
  package's ``packed_attention_dense`` per chunk row; ``packed_lse_plain``
  and ``packed_attn_bwd_plain`` — its log-sum-exp and its gradients (torch's
  autograd of it), the plain versions of what the CUDA kernels add for
  training;
* ``PackedAttention`` — the ``torch.autograd.Function`` around the kernels:
  the forward ``packed_attn_fwd`` saves its log-sum-exp, the backward runs
  ``packed_attn_bwd`` (the splash kernel's ``custom_vjp`` on the TPU);
* the plain versions and the kernels take whatever heads the caller
  passes: under tensor parallelism a rank's own query heads over its KV
  heads (a strided view, or gathered ones);
* ``packed_attention`` — the dispatch: the hand-written CUDA kernels
  (``ops/packed_attention_cuda.py``) on CUDA tensors, through
  ``PackedAttention`` where a gradient is wanted; the plain version under
  torch's own autograd on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def packed_attention_plain(q, k, v, segment_ids, window: Optional[int] = None):
    """q [C, S, H, dh], k/v [C, S, Hkv, dh], segment_ids [C, S] (0 = padding)
    → [C, S, H, dh] in q's dtype.

    Query i attends to key j when j ≤ i, both hold the same segment id > 0,
    and i − j ≤ ``window`` (LocalMask semantics; None = no band). Per chunk
    row this is ``packed_attention_dense`` (packed.py:26-41): KV heads
    repeated for GQA, scores rounded to the input type and divided by √dh in
    float32, softmax in float32, probabilities cast to v's type before the
    product. Rows of segment 0 come back as zeros (the dense oracle leaves
    a uniform average there; no caller reads them)."""
    C, S, H, dh = q.shape
    rep = H // k.shape[2]
    idx = torch.arange(S, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    if window is not None:
        causal = causal & (idx[:, None] - idx[None, :] <= window)
    out = torch.empty_like(q)
    for c in range(C):  # one [H, S, S] score block at a time
        seg = segment_ids[c]
        mask = (seg[:, None] == seg[None, :]) & (seg > 0)[None, :] & causal
        qh = q[c].transpose(0, 1)
        kh = k[c].repeat_interleave(rep, dim=1).transpose(0, 1)
        vh = v[c].repeat_interleave(rep, dim=1).transpose(0, 1)
        scores = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(dh)
        scores = torch.where(mask[None], scores, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.matmul(probs, vh).transpose(0, 1)
        out[c] = torch.where((seg > 0)[:, None, None], ctx, torch.zeros((), dtype=ctx.dtype))
    return out


def _band_mask(segment_ids, window: Optional[int]):
    """[C, S, S] bool: key j ≤ query i, both of the same segment > 0,
    i − j ≤ ``window``."""
    S = segment_ids.shape[1]
    idx = torch.arange(S, device=segment_ids.device)
    causal = idx[:, None] >= idx[None, :]
    if window is not None:
        causal = causal & (idx[:, None] - idx[None, :] <= window)
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    return same & (segment_ids > 0)[:, None, :] & causal


def packed_lse_plain(q, k, segment_ids, window: Optional[int] = None):
    """[C, H, S] float32 log-sum-exp over each query's keys of its float32
    scores scaled by 1/√dh (−inf on rows of segment 0): the residual the
    forward kernel saves for the backward."""
    C, S, H, dh = q.shape
    rep = H // k.shape[2]
    out = torch.empty((C, H, S), dtype=torch.float32, device=q.device)
    for c in range(C):
        mask = _band_mask(segment_ids[c:c + 1], window)[0]
        qh = q[c].float().transpose(0, 1)
        kh = k[c].float().repeat_interleave(rep, dim=1).transpose(0, 1)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
        out[c] = torch.logsumexp(scores.masked_fill(~mask[None], -math.inf), dim=-1)
    return out


def packed_attn_bwd_plain(q, k, v, dout, segment_ids, window: Optional[int] = None):
    """(dq, dk, dv): torch's autograd of ``packed_attention_plain`` for the
    cotangent ``dout``."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = packed_attention_plain(*leaves, segment_ids, window)
        return torch.autograd.grad(out, leaves, dout)


class PackedAttention(torch.autograd.Function):
    """The packed attention with a backward of its own: the forward kernel
    also returns each row's log-sum-exp, which is saved with q, k, v, the
    output and the segment ids; the backward kernel recomputes the
    probabilities from them. On CPU tensors both wrappers run their plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, window):
        from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

        out, lse = packed_attn_fwd(q, k, v, segment_ids, window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd

        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = packed_attn_bwd(q, k, v, out, dout, lse, segment_ids, ctx.window)
        return dq, dk, dv, None, None


def packed_attention(q, k, v, segment_ids, window: Optional[int] = None):
    """[C, S, H, dh] queries over [C, S, Hkv, dh] keys/values and [C, S]
    segment ids → [C, S, H, dh]. On the card the CUDA kernels: through
    ``PackedAttention`` when a gradient is wanted (training, and its
    recompute under gradient checkpointing), else the forward kernel alone
    (serving). On the CPU the plain version, differentiated by torch."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, segment_ids, window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return PackedAttention.apply(q, k, v, segment_ids, window)
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    return packed_attn_fwd(q, k, v, segment_ids, window)


def round_chunk_rows(rows: int, chunk_round: int = 0, min_rows: int = 0) -> int:
    """Compiled-shape policy for the chunked-packing row count: round up to
    a quantum of ``max(8, chunk_round)`` and never below ``min_rows`` — the
    caller's high-water mark, so steady-state batches keep one shape.

    The port runs on one card, so its callers pass ``chunk_round = 1``
    (the device count); the JAX package's tests run on 8 virtual CPU
    devices. Both give a quantum of 8, so the two packages pack the same
    batch into the same number of chunk rows."""
    r = max(8, chunk_round or 0)
    return max(((max(rows, 1) + r - 1) // r) * r, min_rows)


def pack_items(tokens: np.ndarray, lens: np.ndarray, bucket: int = 2048,
               n_emb: int = 1, chunk: int = 0, chunk_round: int = 0,
               min_rows: int = 0):
    """Host-side packing: padded [N, T] token rows (+``n_emb`` emb slots per
    item) → flat stream.

    ``chunk=0`` (legacy): ONE flat stream. Returns packed_tokens [S],
    segment_ids [S] (1-based, 0 = pad), positions [S] (within-segment),
    emb_slots [N] (flat index of each item's FIRST trailing emb slot); S
    rounded up to a multiple of ``bucket``.

    ``chunk>0``: first-fit items into rows of exactly ``chunk`` tokens →
    [C, chunk] arrays, C per ``round_chunk_rows``. Attention then runs per
    chunk row, and ``emb_slots`` index the flattened [C·chunk] stream.
    """
    N = len(lens)
    seg_lens = lens + n_emb  # trailing emb slots
    if chunk:
        assert int(seg_lens.max(initial=0)) <= chunk, (
            f"pack_chunk={chunk} smaller than longest item "
            f"{int(seg_lens.max(initial=0))}"
        )
        rows: list = []          # per chunk: list of item indices
        space: list = []         # remaining tokens per chunk
        # items arrive pre-padded to one width; first-fit keeps host cost
        # linear and wastes <1 item-length per chunk
        for i in range(N):
            need = int(seg_lens[i])
            for r in range(len(rows)):
                if space[r] >= need:
                    rows[r].append(i)
                    space[r] -= need
                    break
            else:
                rows.append([i])
                space.append(chunk - need)
        C = round_chunk_rows(len(rows), chunk_round, min_rows)
        packed = np.zeros((C, chunk), dtype=np.int32)
        seg = np.zeros((C, chunk), dtype=np.int32)
        pos = np.zeros((C, chunk), dtype=np.int32)
        emb_slots = np.zeros(N, dtype=np.int32)
        for r, items in enumerate(rows):
            off = 0
            for i in items:
                n = int(lens[i])
                packed[r, off : off + n] = tokens[i, :n]
                seg[r, off : off + n + n_emb] = i + 1
                pos[r, off : off + n + n_emb] = np.arange(n + n_emb)
                emb_slots[i] = r * chunk + off + n
                off += n + n_emb
        return {
            "packed_tokens": packed,
            "packed_segment_ids": seg,
            "packed_positions": pos,
            "emb_slots": emb_slots,
        }
    total = int(seg_lens.sum())
    S = ((total + bucket - 1) // bucket) * bucket
    packed = np.zeros(S, dtype=np.int32)
    seg = np.zeros(S, dtype=np.int32)
    pos = np.zeros(S, dtype=np.int32)
    emb_slots = np.zeros(N, dtype=np.int32)
    off = 0
    for i in range(N):
        n = int(lens[i])
        packed[off : off + n] = tokens[i, :n]
        seg[off : off + n + n_emb] = i + 1
        pos[off : off + n + n_emb] = np.arange(n + n_emb)
        emb_slots[i] = off + n
        off += n + n_emb
    return {
        "packed_tokens": packed,
        "packed_segment_ids": seg,
        "packed_positions": pos,
        "emb_slots": emb_slots,
    }
