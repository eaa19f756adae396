"""Vectorized negative sampling (a copy of ``mhrec_tpu/data/samplers.py``).

Semantics follow the reference per-sample sampler (``trainset.py:70-108``):

* uniform mode draws without replacement from the pool (all items, or a
  per-category pool chosen unless a ``neg_sample_mix_ratio`` coin flip says
  otherwise), excluding a per-row blacklist (the user's window items);
* weighted mode (``neg_sample_mode`` set) draws WITH replacement from the
  popularity CDF, excluding the blacklist.

The reference runs this per sample in Python dataloader workers; here whole
batches are drawn at once with numpy, using a sort-based first-occurrence
pass for the without-replacement guarantee and a top-up redraw for the rare
rows that come up short.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _first_occurrence_mask(x: np.ndarray) -> np.ndarray:
    """Per-row mask marking the first occurrence of each value."""
    order = np.argsort(x, axis=-1, kind="stable")
    grouped = np.take_along_axis(x, order, axis=-1)
    first = np.ones_like(grouped, dtype=bool)
    first[:, 1:] = grouped[:, 1:] != grouped[:, :-1]
    out = np.zeros_like(first)
    np.put_along_axis(out, order, first, axis=-1)
    return out


class NegativeSampler:
    def __init__(
        self,
        item_num: int,
        pools: Optional[List[np.ndarray]] = None,  # per-category candidate pools
        global_cdf: Optional[np.ndarray] = None,  # popularity CDF over items 1..item_num-1
        cat_cdfs: Optional[List[np.ndarray]] = None,
        neg_sample_mix_ratio: float = 0.0,
        use_native: bool = True,
    ):
        self.item_num = item_num
        self.all_items = np.arange(1, item_num, dtype=np.int64)
        self.pools = pools
        self.global_cdf = global_cdf
        self.cat_cdfs = cat_cdfs
        self.mix_ratio = float(neg_sample_mix_ratio)
        if use_native:
            from mhrec_tpu_torch import native

            self.native = native if native.available() else None
        else:
            self.native = None

    # ------------------------------------------------------------------
    def sample(
        self,
        rng: np.random.Generator,
        blacklist: np.ndarray,  # [B, Lb] item ids (0 = ignore)
        k: int,
        cat_idx: Optional[int] = None,
    ) -> np.ndarray:
        """Returns [B, k] negatives."""
        B = blacklist.shape[0]
        use_cat = cat_idx is not None
        if use_cat and self.mix_ratio > 0.0:
            # per-row coin flip falls back to the global pool
            mix = rng.random(B) <= self.mix_ratio
        else:
            mix = np.zeros(B, dtype=bool) if use_cat else np.ones(B, dtype=bool)

        out = np.empty((B, k), dtype=np.int64)
        if use_cat and not mix.all():
            rows = np.where(~mix)[0]
            out[rows] = self._draw(
                rng, blacklist[rows], k,
                pool=self.pools[cat_idx],
                cdf=self.cat_cdfs[cat_idx] if self.cat_cdfs is not None else None,
            )
        if mix.any():
            rows = np.where(mix)[0]
            out[rows] = self._draw(
                rng, blacklist[rows], k, pool=self.all_items, cdf=self.global_cdf
            )
        return out

    # ------------------------------------------------------------------
    def _draw(self, rng, blacklist, k, pool, cdf):
        B = blacklist.shape[0]
        if self.native is not None and k + blacklist.shape[1] < len(pool) // 2:
            # native OpenMP rejection sampler (mhrec_tpu_torch/native); identical
            # semantics, different (but seeded) random stream
            seed = int(rng.integers(0, 2**63 - 1))
            if cdf is not None:
                return self.native.sample_negatives_weighted(
                    blacklist, k, pool, cdf, seed
                )
            if pool is self.all_items:
                return self.native.sample_negatives_uniform(
                    blacklist, k, self.item_num, seed
                )
            return self.native.sample_negatives_pool(blacklist, k, pool, seed)
        if cdf is not None:
            # weighted: with replacement, reject blacklisted only
            cand = self._weighted_candidates(rng, cdf, pool, (B, k))
            bad = self._in_blacklist(cand, blacklist)
            for _ in range(4):
                if not bad.any():
                    break
                redraw = self._weighted_candidates(rng, cdf, pool, (B, k))
                cand = np.where(bad, redraw, cand)
                bad = bad & self._in_blacklist(cand, blacklist)
            return cand

        # uniform: without replacement, reject blacklisted
        n_pool = len(pool)
        if n_pool <= 65536 or k + blacklist.shape[1] >= n_pool // 4:
            # small pool: exact per-row random permutation of the whole pool
            keys = rng.random((B, n_pool))
            order = np.argsort(keys, axis=-1)
            cand = pool[order]
            ok = ~self._in_blacklist(cand, blacklist)
            compact = np.argsort(~ok, axis=-1, kind="stable")[:, :k]
            out = np.take_along_axis(cand, compact, axis=-1)
            filled = np.take_along_axis(ok, compact, axis=-1)
            if out.shape[1] < k:  # pool itself smaller than k
                pad = k - out.shape[1]
                out = np.concatenate([out, np.zeros((B, pad), dtype=out.dtype)], axis=1)
                filled = np.concatenate([filled, np.zeros((B, pad), dtype=bool)], axis=1)
            if not filled.all():
                # pool minus blacklist smaller than k: repeat non-blacklisted
                # items rather than leak blacklisted ones (the reference
                # would error in this degenerate case)
                for row in np.where(~filled.all(axis=1))[0]:
                    avail = np.setdiff1d(pool, blacklist[row])
                    if avail.size == 0:
                        avail = pool
                    need = int((~filled[row]).sum())
                    out[row, ~filled[row]] = rng.choice(avail, size=need, replace=True)
            return out

        # large pool: rejection sampling with a margin; shortfall is rare
        margin = k + blacklist.shape[1] + 8
        cand = pool[rng.integers(0, n_pool, size=(B, margin))]
        ok = _first_occurrence_mask(cand) & ~self._in_blacklist(cand, blacklist)
        order = np.argsort(~ok, axis=-1, kind="stable")
        cand = np.take_along_axis(cand, order, axis=-1)[:, :k]
        ok = np.take_along_axis(ok, order, axis=-1)[:, :k]
        for row in np.where(~ok.all(axis=1))[0]:
            forbidden = np.union1d(blacklist[row], cand[row][ok[row]])
            draw = rng.choice(pool, size=min(n_pool, 2 * k + len(forbidden)), replace=False)
            draw = draw[~np.isin(draw, forbidden)]
            need = int((~ok[row]).sum())
            cand[row, ~ok[row]] = draw[:need]
        return cand

    @staticmethod
    def _weighted_candidates(rng, cdf, pool, shape):
        u = rng.random(shape)
        idx = np.searchsorted(cdf, u, side="left")
        idx = np.minimum(idx, len(pool) - 1)
        return pool[idx]

    @staticmethod
    def _in_blacklist(cand: np.ndarray, blacklist: np.ndarray) -> np.ndarray:
        # [B, K] vs [B, Lb] membership; Lb and K are small (~10-100)
        return (cand[:, :, None] == blacklist[:, None, :]).any(axis=-1)


def make_negative_sampler(config, data) -> NegativeSampler:
    use_weights = config.get("neg_sample_mode", None) is not None
    # global weighted CDF indexes items 1..item_num-1
    global_cdf = data.item_interact_weights if use_weights else None
    cat_cdfs = data.item_weights_by_cat if use_weights else None
    return NegativeSampler(
        item_num=data.item_num,
        pools=data.int_category_to_item_id,
        global_cdf=global_cdf,
        cat_cdfs=cat_cdfs,
        neg_sample_mix_ratio=config["neg_sample_mix_ratio"] or 0.0,
        use_native=config.get("use_native_sampler", True),
    )
