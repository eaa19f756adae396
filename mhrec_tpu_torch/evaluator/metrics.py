"""Retrieval / ranking / value metrics, pure numpy.

Behavior parity with the reference metric inventory
(``code/REC/evaluator/metrics.py``, ``base_metric.py``):

* Top-k metrics consume ``rec.topk`` — per-user ``[hits(K) | unique_pos_count]``
  rows — and return per-user **sums** (the trainer divides by the cross-host
  summed sample count after a psum, reference trainer.py:1107-1123).
* ``Recall``/``NDCG`` additionally emit per-category (``rec.tgt_tags`` mask)
  and outlier-user subgroup variants as ``(value, num_samples)`` tuples.
* ``Entropy`` is a *shared* metric over the categories of recommended items
  (``rec.rec_tags``), computed once over the fused top-k list.
* CTR/value metrics (GAUC, AUC, MAE, RMSE, LogLoss) and diversity metrics
  (ItemCoverage, AveragePopularity, ShannonEntropy, GiniIndex,
  TailPercentage) complete the inventory.
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np

from mhrec_tpu_torch.utils.enums import EvaluatorType

logger = logging.getLogger(__name__)


def _binary_clf_curve(trues: np.ndarray, preds: np.ndarray):
    """Cumulative (fps, tps) counts per descending-score threshold."""
    trues = trues == 1
    order = np.argsort(preds, kind="stable")[::-1]
    preds = preds[order]
    trues = trues[order]
    distinct = np.where(np.diff(preds))[0]
    threshold_idxs = np.r_[distinct, trues.size - 1]
    tps = np.cumsum(trues)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps


def _trapezoid_auc(x: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(x, kind="stable")
    return float(np.trapezoid(y[order], x[order]))


class AbstractMetric:
    smaller = False

    def __init__(self, config):
        self.num_prior_categories = config["eval_num_cats"]
        self.eval_by_cat = config.get("eval_by_cat", True)
        self.eval_pred_len = config["eval_pred_len"]
        self.outlier_user_metrics = config["outlier_user_metrics"]
        self.int_to_category = config["int_to_category"]
        self.decimal_place = (
            config["metric_decimal_place"] + 2 if config["metric_decimal_place"] else 7
        )

    def calculate_metric(self, dataobject, pred_len=1):
        raise NotImplementedError


class TopkMetric(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.topk"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def used_info(self, dataobject):
        rec_mat = np.asarray(dataobject.get("rec.topk"))
        k = max(self.topk)
        return rec_mat[:, :k].astype(bool), rec_mat[:, k]

    def topk_result(self, metric, value, num_samples=None, prefix=None):
        out = {}
        summed = value.sum(axis=0)  # divided by user count after cross-host psum
        for k in self.topk:
            key = f"{metric}@{k}" if prefix is None else f"{prefix}-{metric}@{k}"
            out[key] = (summed[k - 1], num_samples) if num_samples is not None else summed[k - 1]
        return out

    def metric_info(self, pos_index, pos_len=None):
        raise NotImplementedError

    def _subgroup_results(self, metric, dataobject, pos_index, pos_len, pred_len):
        """Per-category and outlier-user subgroup variants (Recall/NDCG)."""
        out = {}
        if self.num_prior_categories > 1 and self.eval_by_cat:
            tags = np.asarray(dataobject.get("rec.tgt_tags")).astype(bool)
            for tag_idx in range(self.num_prior_categories):
                mask = tags[:, tag_idx]
                res = self.metric_info(pos_index[mask], pos_len[mask])
                out.update(
                    self.topk_result(
                        metric, res, num_samples=int(mask.sum()),
                        prefix=self.int_to_category[tag_idx],
                    )
                )
        if self.outlier_user_metrics is not None and pred_len == self.eval_pred_len - 1:
            outliers = np.asarray(dataobject.get("rec.outlier_users")).astype(bool)
            res = self.metric_info(pos_index[outliers], pos_len[outliers])
            out.update(
                self.topk_result(
                    metric, res, num_samples=int(outliers.sum()),
                    prefix=f"outlier_{self.outlier_user_metrics}",
                )
            )
        return out


class LossMetric(AbstractMetric):
    """VALUE metrics (reference base_metric.py:97-132).

    Two input forms:

    * full-sort retrieval (the only reachable path in the reference
      protocols — its own ``data.label`` collection is commented out,
      reference collector.py:351-353): ``rec.tgt_score`` holds the
      per-(user, target) sigmoid probabilities σ(exp(logit_scale)·cos) of
      each unique finite-scored target (labels are all 1 by construction).
      Collected streamed (any process count, host-table included) or from
      the full tensor — identical values. Returns the ``(sum, count)``
      tuple form so the trainer's cross-host SUM-reduce is exact.
    * CTR-style ``eval_collect`` (pointwise preds + labels): scalar result,
      the reference semantics.
    """

    metric_type = EvaluatorType.VALUE
    metric_need = ["rec.tgt_score"]

    def used_info(self, dataobject):
        preds = np.asarray(dataobject.get("rec.score")).squeeze(-1)
        trues = np.asarray(dataobject.get("data.label")).squeeze(-1)
        return preds, trues

    def output_metric(self, metric, dataobject):
        if "rec.tgt_score" in dataobject:
            preds = np.asarray(dataobject.get("rec.tgt_score"))
            trues = np.ones_like(preds)
            return {metric: self.sum_info(preds, trues)}
        preds, trues = self.used_info(dataobject)
        return {metric: round(self.metric_info(preds, trues), self.decimal_place)}

    def metric_info(self, preds, trues):
        raise NotImplementedError

    def sum_info(self, preds, trues):
        """(statistic sum, sample count[, post-reduce transform]) tuple —
        reduced exactly across hosts by the trainer."""
        raise NotImplementedError


# --------------------------------------------------------------------------
# Shared (pred-len-independent) diversity metric over recommended categories
# --------------------------------------------------------------------------
class Entropy(AbstractMetric):
    """Entropy of the category distribution of the fused top-k list."""

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.topk"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject, pred_len=1):
        rec_tags = np.asarray(dataobject.get("rec.rec_tags"), dtype=np.float64)
        tag_counts = np.cumsum(rec_tags, axis=1)  # [users, K, num_cats]
        out = {}
        for k in self.topk:
            counts = tag_counts[:, k - 1, :]
            p = counts / counts.sum(axis=1, keepdims=True)
            ent = -np.sum(np.where(p > 0, p * np.log2(p, where=p > 0), 0.0), axis=1)
            out[f"Entropy@{k}"] = ent.sum(axis=0)
        return out


# --------------------------------------------------------------------------
# Top-k metrics
# --------------------------------------------------------------------------
class Hit(TopkMetric):
    def calculate_metric(self, dataobject, pred_len=1):
        pos_index, _ = self.used_info(dataobject)
        return self.topk_result("hit", self.metric_info(pos_index))

    def metric_info(self, pos_index, pos_len=None):
        return (np.cumsum(pos_index, axis=1) > 0).astype(int)


class MRR(TopkMetric):
    def calculate_metric(self, dataobject, pred_len=1):
        pos_index, _ = self.used_info(dataobject)
        return self.topk_result("mrr", self.metric_info(pos_index))

    def metric_info(self, pos_index, pos_len=None):
        n_users, k = pos_index.shape
        first = pos_index.argmax(axis=1)
        has_hit = pos_index[np.arange(n_users), first] > 0
        ranks = np.arange(k)[None, :]
        rr = np.where(has_hit[:, None] & (ranks >= first[:, None]), 1.0 / (first[:, None] + 1), 0.0)
        return rr


class MAP(TopkMetric):
    def calculate_metric(self, dataobject, pred_len=1):
        pos_index, pos_len = self.used_info(dataobject)
        return self.topk_result("map", self.metric_info(pos_index, pos_len))

    def metric_info(self, pos_index, pos_len=None):
        k = pos_index.shape[1]
        pre = pos_index.cumsum(axis=1) / np.arange(1, k + 1)
        sum_pre = np.cumsum(pre * pos_index.astype(np.float64), axis=1)
        actual_len = np.minimum(pos_len, k)
        # denominator at rank j is min(j+1, actual_len) but frozen past actual_len
        ranges = np.tile(np.arange(1, k + 1), (pos_index.shape[0], 1)).astype(np.float64)
        cap = np.maximum(actual_len, 1)[:, None]
        ranges = np.minimum(ranges, cap)
        return sum_pre / ranges


class Recall(TopkMetric):
    def calculate_metric(self, dataobject, pred_len=1):
        pos_index, pos_len = self.used_info(dataobject)
        out = self.topk_result("recall", self.metric_info(pos_index, pos_len))
        out.update(self._subgroup_results("recall", dataobject, pos_index, pos_len, pred_len))
        return out

    def metric_info(self, pos_index, pos_len=None):
        assert pos_len is not None
        return np.cumsum(pos_index, axis=1) / np.maximum(pos_len, 1).reshape(-1, 1)


class NDCG(TopkMetric):
    def calculate_metric(self, dataobject, pred_len=1):
        pos_index, pos_len = self.used_info(dataobject)
        out = self.topk_result("ndcg", self.metric_info(pos_index, pos_len))
        out.update(self._subgroup_results("ndcg", dataobject, pos_index, pos_len, pred_len))
        return out

    def metric_info(self, pos_index, pos_len=None):
        assert pos_len is not None
        k = pos_index.shape[1]
        idcg_len = np.minimum(pos_len, k)
        gains = 1.0 / np.log2(np.arange(2, k + 2))
        idcg_all = np.cumsum(gains)
        # ideal cumulative DCG at rank j is frozen once j exceeds the positive count
        rank_cap = np.minimum(np.arange(1, k + 1)[None, :], np.maximum(idcg_len, 1)[:, None])
        idcg_mat = idcg_all[rank_cap - 1]
        dcg = np.cumsum(np.where(pos_index, gains[None, :], 0.0), axis=1)
        return dcg / idcg_mat


class Precision(TopkMetric):
    def calculate_metric(self, dataobject, pred_len=1):
        pos_index, _ = self.used_info(dataobject)
        return self.topk_result("precision", self.metric_info(pos_index))

    def metric_info(self, pos_index, pos_len=None):
        return pos_index.cumsum(axis=1) / np.arange(1, pos_index.shape[1] + 1)


# --------------------------------------------------------------------------
# Rank / CTR metrics
# --------------------------------------------------------------------------
class GAUC(AbstractMetric):
    """Grouped AUC from per-user mean-rank rows (reference metrics.py:269-344).

    Returns the ``(weighted_sum, weight)`` tuple form so the trainer's
    cross-host SUM-reduce + divide yields the EXACT global positive-weighted
    mean — the reference all_reduces the per-rank final GAUC scalar and
    divides by the user count (trainer.py:1059-1075), which is only correct
    for sum-form metrics; the tuple form is exact on any process count.
    """

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.meanrank"]

    def calculate_metric(self, dataobject, pred_len=1):
        mean_rank = np.asarray(dataobject.get("rec.meanrank"))
        pos_rank_sum, user_len, pos_len = (
            mean_rank[:, 0], mean_rank[:, 1], mean_rank[:, 2],
        )
        return {"gauc": self.metric_info(pos_rank_sum, user_len, pos_len)}

    def metric_info(self, pos_rank_sum, user_len_list, pos_len_list):
        """(sum of pos_len-weighted per-user AUCs, sum of pos_len weights)."""
        neg_len_list = user_len_list - pos_len_list
        ok = (pos_len_list != 0) & (neg_len_list != 0)
        if not ok.all():
            logger.warning("GAUC: removed users without positive or negative samples")
            pos_rank_sum, user_len_list, pos_len_list, neg_len_list = (
                pos_rank_sum[ok], user_len_list[ok], pos_len_list[ok], neg_len_list[ok],
            )
        pair_num = (
            (user_len_list + 1) * pos_len_list
            - pos_len_list * (pos_len_list + 1) / 2
            - pos_rank_sum
        )
        user_auc = pair_num / (neg_len_list * pos_len_list)
        return (float((user_auc * pos_len_list).sum()), float(pos_len_list.sum()))


class AUC(LossMetric):
    """Full-sort mode: the unweighted mean over users of the per-user
    corpus AUC (positives = that horizon's unique targets, negatives = the
    rest of the finite-scored corpus) — computed exactly from the same
    mean-rank rows GAUC streams, so it works on any process count and in
    host-table mode. GAUC weights users by positive count; AUC weights them
    equally. CTR mode (rec.score + data.label via ``eval_collect``): the
    reference's pooled ROC-curve AUC."""

    metric_need = ["rec.meanrank"]

    def calculate_metric(self, dataobject, pred_len=1):
        if "rec.meanrank" in dataobject:
            mean_rank = np.asarray(dataobject.get("rec.meanrank"))
            pos_rank_sum, user_len, pos_len = (
                mean_rank[:, 0], mean_rank[:, 1], mean_rank[:, 2],
            )
            neg_len = user_len - pos_len
            ok = (pos_len != 0) & (neg_len != 0)
            pos_rank_sum, user_len, pos_len, neg_len = (
                pos_rank_sum[ok], user_len[ok], pos_len[ok], neg_len[ok],
            )
            pair_num = (
                (user_len + 1) * pos_len
                - pos_len * (pos_len + 1) / 2
                - pos_rank_sum
            )
            user_auc = pair_num / (neg_len * pos_len)
            return {"auc": (float(user_auc.sum()), float(ok.sum()))}
        return self.output_metric("auc", dataobject)

    def metric_info(self, preds, trues):
        fps, tps = _binary_clf_curve(trues, preds)
        if len(fps) > 2:
            keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
            fps, tps = fps[keep], tps[keep]
        tps = np.r_[0, tps]
        fps = np.r_[0, fps]
        if fps[-1] <= 0 or tps[-1] <= 0:
            logger.warning("AUC: no negative or positive samples in y_true")
            return float("nan")
        return _trapezoid_auc(fps / fps[-1], tps / tps[-1])


# --------------------------------------------------------------------------
# Value metrics
# --------------------------------------------------------------------------
class MAE(LossMetric):
    smaller = True

    def calculate_metric(self, dataobject, pred_len=1):
        return self.output_metric("mae", dataobject)

    def metric_info(self, preds, trues):
        return float(np.abs(preds - trues).mean())

    def sum_info(self, preds, trues):
        return (float(np.abs(preds - trues).sum()), float(preds.size))


class RMSE(LossMetric):
    smaller = True

    def calculate_metric(self, dataobject, pred_len=1):
        return self.output_metric("rmse", dataobject)

    def metric_info(self, preds, trues):
        return float(np.sqrt(np.mean((preds - trues) ** 2)))

    def sum_info(self, preds, trues):
        return (float(((preds - trues) ** 2).sum()), float(preds.size), "sqrt")


class LogLoss(LossMetric):
    smaller = True

    def calculate_metric(self, dataobject, pred_len=1):
        return self.output_metric("logloss", dataobject)

    def metric_info(self, preds, trues):
        eps = 1e-15
        p = np.clip(preds.astype(np.float64), eps, 1 - eps)
        return float(np.mean(-trues * np.log(p) - (1 - trues) * np.log(1 - p)))

    def sum_info(self, preds, trues):
        eps = 1e-15
        p = np.clip(preds.astype(np.float64), eps, 1 - eps)
        ll = -trues * np.log(p) - (1 - trues) * np.log(1 - p)
        return (float(ll.sum()), float(preds.size))


# --------------------------------------------------------------------------
# Diversity / coverage metrics
# --------------------------------------------------------------------------
class ItemCoverage(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items", "data.num_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject, pred_len=1):
        items = np.asarray(dataobject.get("rec.items"))
        num_items = dataobject.get("data.num_items")
        return {
            f"itemcoverage@{k}": round(
                np.unique(items[:, :k]).shape[0] / num_items, self.decimal_place
            )
            for k in self.topk
        }


class AveragePopularity(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    smaller = True
    metric_need = ["rec.items", "data.count_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject, pred_len=1):
        items = np.asarray(dataobject.get("rec.items"))
        counter = dict(dataobject.get("data.count_items"))
        max_id = int(items.max()) + 1
        lut = np.zeros(max_id, dtype=np.float64)
        for iid, cnt in counter.items():
            if 0 <= iid < max_id:
                lut[iid] = cnt
        pops = lut[items]
        vals = pops.cumsum(axis=1) / np.arange(1, pops.shape[1] + 1)
        mean = vals.mean(axis=0)
        return {f"averagepopularity@{k}": round(mean[k - 1], self.decimal_place) for k in self.topk}


class ShannonEntropy(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject, pred_len=1):
        items = np.asarray(dataobject.get("rec.items"))
        out = {}
        for k in self.topk:
            flat = items[:, :k].ravel()
            _, counts = np.unique(flat, return_counts=True)
            p = counts / flat.size
            out[f"shannonentropy@{k}"] = round(float((-p * np.log(p)).sum() / len(counts)), self.decimal_place)
        return out


class GiniIndex(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    smaller = True
    metric_need = ["rec.items", "data.num_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject, pred_len=1):
        items = np.asarray(dataobject.get("rec.items"))
        num_items = dataobject.get("data.num_items")
        out = {}
        for k in self.topk:
            flat = items[:, :k].ravel()
            _, counts = np.unique(flat, return_counts=True)
            sorted_count = np.sort(counts)
            n_rec = sorted_count.shape[0]
            total = flat.size
            idx = np.arange(num_items - n_rec + 1, num_items + 1)
            gini = np.sum((2 * idx - num_items - 1) * sorted_count) / total / num_items
            out[f"giniindex@{k}"] = round(float(gini), self.decimal_place)
        return out


class TailPercentage(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items", "data.count_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]
        tail = config["tail_ratio"]
        self.tail = tail if tail and tail > 0 else 0.1

    def calculate_metric(self, dataobject, pred_len=1):
        items = np.asarray(dataobject.get("rec.items"))
        counter = dict(dataobject.get("data.count_items"))
        if self.tail > 1:
            tail_items = {i for i, c in counter.items() if c <= self.tail}
        else:
            ranked = sorted(counter.items(), key=lambda kv: (kv[1], kv[0]))
            cut = max(int(len(ranked) * self.tail), 1)
            tail_items = {i for i, _ in ranked[:cut]}
        is_tail = np.isin(items, np.fromiter(tail_items, dtype=items.dtype, count=len(tail_items)))
        vals = is_tail.cumsum(axis=1) / np.arange(1, items.shape[1] + 1)
        mean = vals.mean(axis=0)
        return {f"tailpercentage@{k}": round(mean[k - 1], self.decimal_place) for k in self.topk}
