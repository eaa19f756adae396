"""Eval-resource collector: accumulates per-batch top-k hit rows, subgroup
masks and recommended-item categories per prediction horizon.

Behavior parity with reference ``REC/evaluator/collector.py``:

* one ``DataStruct`` per horizon in ``metrics_pred_len_list`` plus ``-1`` for
  shared (pred-len-independent) resources;
* ``eval_batch_collect`` fuses multi-head scores — single-head squeeze,
  ``average`` (finite-mean over heads), or ``combine`` (per-head top-k →
  global dedup; vectorized here, see fusion.py) — then builds per-horizon
  ``[hits(K) | unique_pos_count]`` rows with hits accumulated over widening
  target slices (collector.py:300-316);
* per-target category masks are any-over-horizon (collector.py:178-183);
* outlier-user flags attach to the final horizon only;
* recommended-item tags are collected for the shared Entropy metric;
* ``eval_each_head`` collects per-head hit rows.

This collector consumes *host* numpy arrays; device-side top-k/scoring lives
in the trainer's streamed scorer.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np

from mhrec_tpu_torch.evaluator.fusion import fuse_topk_combine, unique_positive_counts
from mhrec_tpu_torch.evaluator.registry import Register


class DataStruct:
    def __init__(self):
        self._array_lists: Dict[str, list] = {}
        self._data: Dict[str, object] = {}

    def __getitem__(self, name):
        return self._data[name]

    def __setitem__(self, name, value):
        self._data[name] = value

    def __delitem__(self, name):
        self._data.pop(name)

    def __contains__(self, key):
        return key in self._data

    def get(self, name):
        if name not in self._data:
            raise IndexError(f"Resource {name!r} was not collected")
        return self._data[name]

    def set(self, name, value):
        self._data[name] = value

    def update_array(self, name, value: np.ndarray):
        self._array_lists.setdefault(name, []).append(np.asarray(value))

    def finalize(self):
        for name, chunks in self._array_lists.items():
            if chunks:
                self._data[name] = np.concatenate(chunks, axis=0)
        self._array_lists.clear()


class Collector:
    def __init__(self, config):
        self.config = config
        self.metrics_pred_len_list = config["metrics_pred_len_list"]
        self.eval_pred_len = config["eval_pred_len"]
        self.data_struct: Dict[int, DataStruct] = {
            p: DataStruct() for p in self.metrics_pred_len_list
        }
        self.data_struct[-1] = DataStruct()
        self.register = Register(config)
        self.topk = config["topk"]
        hi = config["head_interaction"]
        if hi in ("multiplicative", "hierarchical"):
            self.medusa_num_heads = config["num_segment_head"] * config["num_prior_head"]
        elif hi == "additive":
            self.medusa_num_heads = config["num_segment_head"] + config["num_prior_head"]
        else:
            raise ValueError(f"Unknown head_interaction: {hi}")
        self.split_mode = config["split_mode"]
        self.all_tags: Optional[np.ndarray] = None
        self.eval_each_head = config.get("eval_each_head", False)
        # when True, the trainer streams per-user mean-rank rows itself via
        # meanrank_rows_collect (chunked count-above-target accumulation) and
        # eval_batch_collect must not demand the full score tensor
        self.external_meanrank = False
        # same for the per-target sigmoid scores the VALUE metrics consume
        # (trainer tgt_score_collect; VERDICT r4 #5)
        self.external_tgt_score = False
        self.logit_scale_value = 1.0

    def set_logit_scale(self, scale: float):
        """The model's exp(logit_scale) NCE temperature — maps cosine target
        scores to the calibrated sigmoid probabilities the VALUE metrics
        (MAE/RMSE/LogLoss) measure."""
        self.logit_scale_value = float(scale)

    def set_all_tags(self, item_tags: np.ndarray):
        self.all_tags = np.asarray(item_tags)

    def reset_all_tags(self):
        self.all_tags = None

    def data_collect(self, train_data):
        ds = train_data.dataset if hasattr(train_data, "dataset") else train_data
        if self.register.need("data.num_items"):
            for p in self.metrics_pred_len_list:
                self.data_struct[p].set("data.num_items", ds.item_num)
        if self.register.need("data.num_users"):
            for p in self.metrics_pred_len_list:
                self.data_struct[p].set("data.num_users", ds.user_num)
        if self.register.need("data.count_items"):
            for p in self.metrics_pred_len_list:
                self.data_struct[p].set("data.count_items", ds.item_counter)
        if self.register.need("data.count_users"):
            for p in self.metrics_pred_len_list:
                self.data_struct[p].set("data.count_users", ds.user_counter)

    # ------------------------------------------------------------------
    def eval_batch_collect(
        self,
        scores: Optional[np.ndarray] = None,  # [B, H, I] full scores (small corpora)
        positive_i: Optional[np.ndarray] = None,  # [B, eval_pred_len]
        tag_category: Optional[np.ndarray] = None,  # [B, pred_len, C]
        outlier_users: Optional[np.ndarray] = None,  # [B]
        topk_values: Optional[np.ndarray] = None,  # [B, H, K] pre-computed per-head topk
        topk_indices: Optional[np.ndarray] = None,
        log_detailed_results: bool = False,
    ):
        """Collect one eval batch.

        Either full ``scores`` or streamed per-head (``topk_values``,
        ``topk_indices``) must be given. The streamed form is how the
        eval loop avoids materializing (B, H, 8M) score tensors — per-chunk
        top-k results are merged on device and handed over here.
        """
        if tag_category is not None:
            for p in self.metrics_pred_len_list:
                self.data_struct[p].update_array(
                    "rec.tgt_tags", np.any(tag_category[:, : p + 1], axis=1)
                )

        if outlier_users is not None:
            self.data_struct[self.eval_pred_len - 1].update_array(
                "rec.outlier_users", np.asarray(outlier_users, dtype=bool)
            )

        top_k = max(self.topk)
        detailed = {}

        if scores is not None:
            scores = np.asarray(scores, dtype=np.float32)
            B, H = scores.shape[0], scores.shape[1]
            per_head_k = min(top_k, scores.shape[-1])
            part = np.argpartition(-scores, per_head_k - 1, axis=-1)[..., :per_head_k]
            part_vals = np.take_along_axis(scores, part, axis=-1)
            inner = np.argsort(-part_vals, axis=-1, kind="stable")
            topk_indices = np.take_along_axis(part, inner, axis=-1)
            topk_values = np.take_along_axis(part_vals, inner, axis=-1)
        else:
            assert topk_values is not None and topk_indices is not None
            topk_values = np.asarray(topk_values, dtype=np.float32)
            topk_indices = np.asarray(topk_indices)
            B, H = topk_values.shape[0], topk_values.shape[1]

        if H == 1:
            fused_idx = topk_indices[:, 0, :top_k]
            fused_vals = topk_values[:, 0, :top_k]
            fused_src = np.zeros_like(fused_idx)
        elif self.split_mode == "average":
            if scores is None:
                raise ValueError("split_mode='average' needs full scores")
            finite = np.isfinite(scores)
            avg = np.where(finite, scores, 0.0).sum(axis=1) / (finite.sum(axis=1) + 1e-8)
            order = np.argsort(-avg, axis=-1, kind="stable")[:, :top_k]
            fused_idx = order
            fused_vals = np.take_along_axis(avg, order, axis=-1)
            fused_src = np.zeros_like(fused_idx)
        elif self.split_mode == "combine":
            fused_vals, fused_idx, fused_src = fuse_topk_combine(
                topk_values, topk_indices, top_k
            )
        else:
            raise ValueError(f"Unknown split_mode: {self.split_mode}")

        # uniqueness invariant (reference collector.py:290-293)
        sorted_idx = np.sort(fused_idx, axis=1)
        assert (sorted_idx[:, 1:] != sorted_idx[:, :-1]).all(), (
            "Duplicated items in fused top-k"
        )

        if self.register.need("rec.items"):
            for p in self.metrics_pred_len_list:
                self.data_struct[p].update_array("rec.items", fused_idx)

        if self.register.need("rec.topk"):
            if self.all_tags is not None:
                self.data_struct[-1].update_array("rec.rec_tags", self.all_tags[fused_idx])

            positive_i = np.asarray(positive_i)
            pos_len_full = unique_positive_counts(positive_i)

            hit_mask = np.zeros((B, top_k), dtype=bool)
            for p in self.metrics_pred_len_list:
                pos_slice = positive_i[:, : p + 1]
                hit_mask |= (fused_idx[:, :, None] == pos_slice[:, None, :]).any(axis=-1)
                row = np.concatenate(
                    [hit_mask.astype(np.int32), pos_len_full[:, p : p + 1]], axis=1
                )
                self.data_struct[p].update_array("rec.topk", row)

            if self.eval_each_head:
                last_p = self.metrics_pred_len_list[-1]
                for h in range(H):
                    head_idx = topk_indices[:, h, :top_k]
                    hits = (head_idx[:, :, None] == positive_i[:, None, :]).any(axis=-1)
                    row = np.concatenate(
                        [hits.astype(np.int32), pos_len_full[:, -1:]], axis=1
                    )
                    self.data_struct[last_p].update_array(f"rec.topk_{h}", row)

        if log_detailed_results:
            log_topk = min(200, fused_idx.shape[1])
            detailed = {
                "values": fused_vals[:, :log_topk],
                "head_source": fused_src[:, :log_topk],
                "idx": fused_idx[:, :log_topk].tolist(),
                "values_by_head": topk_values,
                "idx_by_head": topk_indices.tolist(),
            }

        if self.register.need("rec.meanrank") and not self.external_meanrank:
            if scores is None:
                raise ValueError("rec.meanrank needs full scores")
            self._collect_meanrank(scores, positive_i)

        if self.register.need("rec.tgt_score") and not self.external_tgt_score:
            if scores is None:
                raise ValueError("rec.tgt_score needs full scores")
            self._collect_tgt_score(scores, positive_i)

        if self.register.need("rec.score"):
            for p in self.metrics_pred_len_list:
                self.data_struct[p].update_array("rec.score", scores)

        return detailed if log_detailed_results else None

    def _collect_tgt_score(self, scores: np.ndarray, positive_i: np.ndarray):
        """Per-target sigmoid probabilities for the VALUE metrics from the
        full masked score tensor (head 0, like meanrank): σ(scale·s_target)
        for each unique finite-scored target per horizon. The streamed path
        (trainer ``_finalize_meanrank``) computes the identical quantity
        without the [B, H, I] tensor."""
        sq = scores[:, 0] if scores.ndim == 3 else scores
        B = sq.shape[0]
        positive_i = np.asarray(positive_i)
        P = positive_i.shape[1]
        tgt_s = np.take_along_axis(
            sq, positive_i, axis=1).astype(np.float64)  # [B, P]
        first = np.ones(positive_i.shape, bool)
        for j in range(1, P):
            first[:, j] = ~(
                positive_i[:, :j] == positive_i[:, j : j + 1]
            ).any(axis=1)
        keep = first & np.isfinite(tgt_s)
        for p in self.metrics_pred_len_list:
            m = keep[:, : p + 1]
            preds = 1.0 / (1.0 + np.exp(
                -self.logit_scale_value * tgt_s[:, : p + 1][m]))
            self.data_struct[p].update_array("rec.tgt_score", preds)

    def tgt_score_collect(self, preds_by_p: Dict[int, np.ndarray]):
        """Accept externally computed per-target sigmoid scores per horizon
        (the trainer's streamed VALUE-metric path)."""
        for p, preds in preds_by_p.items():
            self.data_struct[p].update_array("rec.tgt_score", np.asarray(preds))

    def _collect_meanrank(self, scores: np.ndarray, positive_i: np.ndarray):
        """Average-rank resource for GAUC (reference collector.py:327-344)."""
        sq = scores[:, 0] if scores.ndim == 3 else scores
        B, n_items = sq.shape
        desc_index = np.argsort(-sq, axis=-1, kind="stable")
        desc_scores = np.take_along_axis(sq, desc_index, axis=-1)
        # average 1-based rank within each tie group of the sorted row
        pos = np.arange(n_items)[None, :]
        obs = np.ones_like(desc_scores, dtype=bool)  # True at each group start
        obs[:, 1:] = desc_scores[:, 1:] != desc_scores[:, :-1]
        start = np.maximum.accumulate(np.where(obs, pos, 0), axis=1)
        nxt = np.where(obs, pos, n_items)
        suffix_min = np.flip(np.minimum.accumulate(np.flip(nxt, axis=1), axis=1), axis=1)
        end_excl = np.concatenate(
            [suffix_min[:, 1:], np.full((B, 1), n_items)], axis=1
        )
        avg_rank = 0.5 * (start + 1 + end_excl)
        user_len = np.argmin(desc_scores, axis=1)

        for p in self.metrics_pred_len_list:
            pos_matrix = np.zeros_like(sq)
            for cur in range(p + 1):
                pos_matrix[np.arange(B), positive_i[:, cur]] = 1
            pos_index = np.take_along_axis(pos_matrix, desc_index, axis=-1)
            pos_rank_sum = np.where(pos_index == 1, avg_rank, 0.0).sum(axis=-1)
            pos_len = pos_matrix.sum(axis=1)
            row = np.stack([pos_rank_sum, user_len, pos_len], axis=1)
            self.data_struct[p].update_array("rec.meanrank", row)

    def meanrank_rows_collect(self, rows_by_p: Dict[int, np.ndarray]):
        """Accept externally computed ``[pos_rank_sum, user_len, pos_len]``
        rows per horizon (the trainer's streamed GAUC path — counts of
        corpus scores above/equal to each target's score accumulated chunk
        by chunk, so no [B, H, I] tensor ever exists)."""
        for p, row in rows_by_p.items():
            self.data_struct[p].update_array("rec.meanrank", np.asarray(row))

    def eval_collect(self, eval_pred: np.ndarray, data_label: np.ndarray):
        """CTR-style direct (pred, label) collection — the reference's
        pointwise VALUE path (reference collector.py eval_collect). Collected
        unconditionally: callers invoke this explicitly, and the VALUE
        metrics fall back to (rec.score, data.label) when rec.tgt_score was
        not collected."""
        for p in self.metrics_pred_len_list:
            self.data_struct[p].update_array("rec.score", eval_pred)
            self.data_struct[p].update_array("data.label", data_label)

    def get_data_struct(self, pred_idx=0) -> DataStruct:
        self.data_struct[pred_idx].finalize()
        out = copy.deepcopy(self.data_struct[pred_idx])
        keys = [
            "rec.rec_tags", "rec.tgt_tags", "rec.outlier_users", "rec.topk",
            "rec.meanrank", "rec.score", "rec.items", "data.label",
            "rec.tgt_score",
        ]
        if self.eval_each_head:
            keys += [f"rec.topk_{h}" for h in range(self.medusa_num_heads)]
        for k in keys:
            if k in self.data_struct[pred_idx]:
                del self.data_struct[pred_idx][k]
        return out
