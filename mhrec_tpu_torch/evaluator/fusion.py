"""Multi-head top-k fusion ("combine" split mode), fully vectorized.

The reference deduplicates the per-head top-k lists with a Python loop over
all ``H * K`` rank positions (collector.py:241-282) — a CPU hot spot at eval
time. Here the same result is produced with three stable sorts, so it can run
vectorized in numpy:

1. flatten per-head (value, item, head) triples and stable-sort by value desc;
2. mark the first occurrence of each item id in that order (sort by id with
   score-rank as tiebreak, diff against neighbor, scatter back);
3. stable-compact the unique entries to the front and take the first ``k``.

Produces exactly the reference's output: the top-k *unique* items across
heads, ordered by score, each tagged with the head it came from.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fuse_topk_combine(
    values: np.ndarray,  # [B, H, K] scores of per-head top-k
    indices: np.ndarray,  # [B, H, K] item ids of per-head top-k
    top_k: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (fused_values[B,k], fused_items[B,k], fused_head_source[B,k])."""
    B, H, K = values.shape
    flat_vals = values.reshape(B, H * K)
    flat_idx = indices.reshape(B, H * K)
    flat_src = np.broadcast_to(np.arange(H)[None, :, None], (B, H, K)).reshape(B, H * K)

    # stable sort by score descending
    order = np.argsort(-flat_vals, axis=-1, kind="stable")
    s_vals = np.take_along_axis(flat_vals, order, axis=-1)
    s_idx = np.take_along_axis(flat_idx, order, axis=-1)
    s_src = np.take_along_axis(flat_src, order, axis=-1)

    # first occurrence of each item id in score-desc order
    by_id = np.argsort(s_idx, axis=-1, kind="stable")
    grouped = np.take_along_axis(s_idx, by_id, axis=-1)
    first = np.ones_like(grouped, dtype=bool)
    first[:, 1:] = grouped[:, 1:] != grouped[:, :-1]
    is_unique = np.zeros_like(first)
    np.put_along_axis(is_unique, by_id, first, axis=-1)

    # stable-compact unique entries to the front, keep first top_k
    compact = np.argsort(~is_unique, axis=-1, kind="stable")[:, :top_k]
    return (
        np.take_along_axis(s_vals, compact, axis=-1),
        np.take_along_axis(s_idx, compact, axis=-1),
        np.take_along_axis(s_src, compact, axis=-1),
    )


def fuse_topk_combine_reference(values, indices, top_k):
    """Sequential reimplementation of the dedup loop, for testing only."""
    B, H, K = values.shape
    out_v = np.empty((B, top_k), dtype=values.dtype)
    out_i = np.empty((B, top_k), dtype=indices.dtype)
    out_s = np.empty((B, top_k), dtype=np.int64)
    for b in range(B):
        triples = sorted(
            (
                (-values[b, h, k], indices[b, h, k], h)
                for h in range(H)
                for k in range(K)
            ),
        )
        seen = set()
        n = 0
        for neg_v, idx, h in triples:
            if idx in seen:
                continue
            seen.add(idx)
            out_v[b, n], out_i[b, n], out_s[b, n] = -neg_v, idx, h
            n += 1
            if n == top_k:
                break
        assert n == top_k, "not enough unique items to fill top_k"
    return out_v, out_i, out_s


def unique_positive_counts(positive_i: np.ndarray) -> np.ndarray:
    """Cumulative distinct counts over the *sorted* positives of each user.

    Matches collector.py:300-305: sort each row, mark first occurrences,
    cumulative-sum. Entry ``p`` is the number of distinct values among the
    ``p+1`` smallest targets (exact parity, including the intermediate-horizon
    quirk of counting over sorted rather than temporal order).
    """
    sorted_full = np.sort(positive_i, axis=1)
    first = np.ones_like(sorted_full, dtype=bool)
    first[:, 1:] = sorted_full[:, 1:] != sorted_full[:, :-1]
    return first.cumsum(axis=1).astype(np.int32)
