"""Evaluation batcher.

Per-user eval samples (reference ``evalset.py``): ``valid`` targets are
``user_seq[train_seq_len : train_seq_len + eval_pred_len]``; ``test`` targets
are the last ``eval_pred_len`` items. History is left-padded/truncated to
``MAX_ITEM_LIST_LENGTH_TEST or MAX_ITEM_LIST_LENGTH``. Each sample carries
per-target category multi-hots and the outlier-user flag (target
category/tag/event unseen in the history window).

Users are rank-strided across hosts (reference
``NonConsecutiveSequentialDistributedSampler``, data/utils.py:95-121). The
last batch is padded up to the static batch size with repeats, flagged via
``sample_weight`` so metrics ignore them.

Batch dict:
  user_ids         [B] int64
  item_seq         [B, Lt] int32    (left-padded history)
  item_target      [B, eval_pred_len] int32
  target_tags      [B, eval_pred_len, C] int8
  outlier_users    [B] bool
  sample_weight    [B] bool         (False = padding duplicate)
  history_row/col  flat arrays for history-score suppression
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SeqEvalBatcher:
    def __init__(self, config, dataload, phase: str = "valid",
                 host_id: int = 0, num_hosts: int = 1):
        self.dataload = dataload
        self.config = config
        self.phase = phase
        self.eval_pred_len = config["eval_pred_len"]
        self.max_len = config["MAX_ITEM_LIST_LENGTH_TEST"] or config["MAX_ITEM_LIST_LENGTH"]
        # eval_batch_size is GLOBAL like train_batch_size: each host builds
        # global/num_hosts rows of its strided users per step
        self.global_batch_size = config["eval_batch_size"]
        if self.global_batch_size % num_hosts:
            raise ValueError(
                f"eval_batch_size {self.global_batch_size} must divide by "
                f"num_hosts {num_hosts}"
            )
        self.batch_size = self.global_batch_size // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.user_num = dataload.user_num - 1  # excluding pad user
        # static history-suppression buffer size: the B_local longest user
        # sequences bound any batch's total history; one fixed size per run
        # keeps every host on the SAME compiled program (SPMD lockstep) and
        # kills the per-batch rebucketing recompiles
        lens = np.diff(dataload.seq_offsets).astype(np.int64)
        top = np.sort(lens)[::-1][: self.batch_size]
        cap = int(top.sum()) if len(top) else 1
        self.hist_bucket = 1 << max(int(cap - 1).bit_length(), 0) if cap > 1 else 1
        self.item_num = dataload.item_num
        self.return_tag_mask = config["eval_num_cats"] > 1
        self.category_by = config["category_by"]
        self.eval_num_cats = config["eval_num_cats"]
        self.outlier_user_metrics = config["outlier_user_metrics"]
        # outlier test's category view of every item, built once per batcher
        # (items tagged with ALL categories count as uncategorized)
        tags = dataload.item_tag_matrix
        self._outlier_tags = None
        if tags is not None:
            all_cats = tags.sum(axis=1) == tags.shape[1]
            self._outlier_tags = np.where(all_cats[:, None], False, tags)
        if self.category_by == "user" and self.return_tag_mask:
            n_clusters = max(dataload.category_to_int.values()) + 1
            self.one_hot_user_cluster = np.eye(n_clusters, dtype=np.int8)[
                dataload.user_cluster_list
            ]

    def __len__(self):
        return self.user_num

    @property
    def num_batches(self) -> int:
        """Identical on every host (SPMD lockstep): the batch count of the
        host with the most strided users; hosts with fewer pad with empty
        (sample_weight=False) batches."""
        max_users = -(-self.user_num // self.num_hosts)
        return -(-max_users // self.batch_size)

    # ------------------------------------------------------------------
    def _user_sample(self, uid: int):
        d = self.dataload
        seq = d.seq_of(uid)
        if self.phase == "valid":
            last = int(d.train_seq_len[uid])
            history = seq[:last]
            target = seq[last : last + self.eval_pred_len]
        else:
            history = seq[: -self.eval_pred_len]
            target = seq[-self.eval_pred_len :]
        return history, target

    def _outlier_flag(self, uid: int, history: np.ndarray, target: np.ndarray) -> bool:
        d = self.dataload
        mode = self.outlier_user_metrics
        if mode is None or self.category_by == "user":
            return False
        if self.category_by == "event":
            if mode != "event":
                return False
            ev = d.events_of(uid)
            if self.phase == "valid":
                last = int(d.train_seq_len[uid])
                hist_ev, tgt_ev = ev[:last], ev[last : last + self.eval_pred_len]
            else:
                hist_ev, tgt_ev = ev[: -self.eval_pred_len], ev[-self.eval_pred_len :]
            if len(hist_ev) > self.max_len:
                hist_ev = hist_ev[-self.max_len :]
            return bool(np.setdiff1d(tgt_ev, hist_ev).size > 0)
        if mode == "category":
            # "fix_miscellaneous": items tagged with ALL categories are treated
            # as uncategorized for the outlier test (reference evalset.py:53-61)
            eff = self._outlier_tags
            if eff is None:  # no category structure loaded (eval_num_cats == 1)
                return False
            cover = eff[history].any(axis=0)
            tgt = eff[target]
            return bool((tgt & ~cover[None, :]).any())
        if mode == "tag":
            fine = d.item_fine_tag
            hist_tags = set(fine[history][fine[history] >= 0].tolist())
            for t in fine[target]:
                if t >= 0 and int(t) not in hist_tags:
                    return True
            return False
        return False

    # ------------------------------------------------------------------
    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        d = self.dataload
        Lt, P, C = self.max_len, self.eval_pred_len, self.eval_num_cats
        my_uids = np.arange(1 + self.host_id, self.user_num + 1, self.num_hosts)
        for b in range(self.num_batches):
            s = b * self.batch_size
            uids = my_uids[s : s + self.batch_size]
            n_real = len(uids)
            if n_real < self.batch_size:  # pad to static shape with repeats
                uids = np.concatenate(
                    [uids, np.full(self.batch_size - n_real, uids[-1] if n_real else 1)]
                )
            B = len(uids)
            item_seq = np.zeros((B, Lt), dtype=np.int32)
            item_target = np.zeros((B, P), dtype=np.int32)
            target_tags = np.zeros((B, P, C), dtype=np.int8)
            outliers = np.zeros(B, dtype=bool)
            hist_rows, hist_cols = [], []
            for i, uid in enumerate(uids):
                history, target = self._user_sample(int(uid))
                h = history[-Lt:]
                item_seq[i, Lt - len(h):] = h
                item_target[i, : len(target)] = target
                if self.return_tag_mask:
                    if self.category_by == "item":
                        target_tags[i] = d.item_tag_matrix[target].astype(np.int8)
                    elif self.category_by == "user":
                        target_tags[i] = self.one_hot_user_cluster[uid][None, :]
                    else:
                        ev = d.events_of(int(uid))
                        tgt_ev = (
                            ev[int(d.train_seq_len[uid]) : int(d.train_seq_len[uid]) + P]
                            if self.phase == "valid"
                            else ev[-P:]
                        )
                        for j, e in enumerate(tgt_ev):
                            target_tags[i, j, int(e)] = 1
                outliers[i] = self._outlier_flag(int(uid), history, target)
                if i < n_real:  # pad repeats carry no history to suppress
                    hist_rows.append(np.full(len(history), i, dtype=np.int64))
                    hist_cols.append(history.astype(np.int64))
            # fixed-size history buffers (col == -1 → no-op in the scorer's
            # masked scatter): one static shape per run
            hr = np.concatenate(hist_rows) if hist_rows else np.zeros(0, np.int64)
            hc = np.concatenate(hist_cols) if hist_cols else np.zeros(0, np.int64)
            assert len(hr) <= self.hist_bucket, (len(hr), self.hist_bucket)
            hist_r = np.zeros(self.hist_bucket, np.int32)
            hist_c = np.full(self.hist_bucket, -1, np.int32)
            hist_r[: len(hr)] = hr
            hist_c[: len(hc)] = hc
            yield {
                "user_ids": uids.astype(np.int64),
                "item_seq": item_seq,
                "item_target": item_target,
                "target_tags": target_tags,
                "outlier_users": outliers,
                "sample_weight": np.arange(B) < n_real,
                "history_row": hist_r,
                "history_col": hist_c,
            }
