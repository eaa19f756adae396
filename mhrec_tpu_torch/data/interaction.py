"""Interaction & item-metadata loader.

Behavior parity with the reference data layer (``REC/data/dataload.py``):

* parquet interactions: one row per user with ``item_id`` as a list column;
  users with ``<= max(min_seq_len, 2 * eval_pred_len)`` interactions dropped
  (dataload.py:107-113);
* string↔int token maps with index 0 = ``[PAD]``; item tokens sorted
  (dataload.py:134-152);
* ``train_seq_len[uid] = len(seq) - 2*eval_pred_len - train_test_gap`` and
  the non-overlapping training-window policy with stride
  ``MAX_ITEM_LIST_LENGTH + 1`` (dataload.py:164-195) — this defines the
  training set;
* item info parquet → fine-tag → coarse-category multi-hot, per-category
  candidate pools, popularity-weighted negative-sampling CDFs
  (``neg_sample_mode`` identity/sqrt/log), ``random_tags``/``all_tags``
  ablations (dataload.py:197-345).

Unlike the reference (Python lists + POSIX-shm pickle broadcast), sequences
are stored as flat numpy arrays + offsets so training windows are batched
gathers; one process per card has no local sibling ranks to broadcast to,
so the shared-memory layer is unnecessary by construction.

pandas (with pyarrow) is imported only inside the parquet readers below:
the serving path on the card runs on in-memory data
(``data/synthetic.py::InMemoryInteractionData``) and never loads it.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from mhrec_tpu_torch.data.tag_dicts import load_prior_dict

logger = logging.getLogger(__name__)


class InteractionData:
    def __init__(self, config):
        self.config = config
        self.pred_len = config["pred_len"]
        self.eval_pred_len = config["eval_pred_len"]
        self.max_item_list_len = config["MAX_ITEM_LIST_LENGTH"] + 1
        self.dataset_name = config["dataset"]
        self.timestamp_required = bool(config["timestamp_required"])
        self.sample_last_only = config.get("sample_last_only", False)
        self.category_by = config["category_by"]
        self.eval_num_cats = config["eval_num_cats"]
        self.train_test_gap = int(config.get("train_test_gap", 0))
        self.subset_user = config.get("subset_user", False)
        self.subset_user_div = config.get("subset_user_div", 10)
        self.subset_user_rmd = config.get("subset_user_rmd", 0)
        self.cluster_as_tag = config.get("cluster_as_tag", False)
        if self.eval_num_cats > 1 and self.category_by == "item":
            self.tag_col = (
                f"cluster_{config['tag_version']}" if self.cluster_as_tag else "tag"
            )
        elif self.eval_num_cats > 1 and self.category_by == "user":
            assert self.cluster_as_tag, "cluster_as_tag must be True for user category"
            self.tag_col = f"user_cluster_{config['tag_version']}"
        else:
            self.tag_col = None

        self.uid_field = "user_id"
        self.iid_field = "item_id"

        # flat sequence storage
        self.flat_items: Optional[np.ndarray] = None
        self.flat_times: Optional[np.ndarray] = None
        self.flat_events: Optional[np.ndarray] = None
        self.seq_offsets: Optional[np.ndarray] = None  # [user_num + 1]
        self.train_seq_len: Optional[np.ndarray] = None
        self.valid_sample_locations: Optional[np.ndarray] = None  # [N, 2]

        self.id2token: Dict[str, List[str]] = {"user_id": [], "item_id": []}
        self.user_cluster_list: Optional[np.ndarray] = None
        self.item_tag_matrix: Optional[np.ndarray] = None  # bool [item_num, C]
        self.item_orig_tag_matrix: Optional[np.ndarray] = None  # pre-ablation
        self.item_fine_tag: Optional[np.ndarray] = None  # int id of fine tag, -1 = none
        self.item_text = None  # pandas DataFrame  # per-item text fields
        self.int_category_to_item_id: Optional[List[np.ndarray]] = None
        self.item_interact_weights: Optional[np.ndarray] = None  # CDF
        self.item_weights_by_cat: Optional[List[np.ndarray]] = None  # CDFs

        self.category_counts: Dict[str, int] = {}
        self.tag_to_category: Dict[str, List[str]] = {}
        self.category_to_int: Dict[str, int] = {}

        self.user_num = 0
        self.item_num = 0
        self.interact_num = 0
        self.counter: Dict[str, Counter] = {}

    # ------------------------------------------------------------------
    def build(self) -> "InteractionData":
        if self.config["eval_num_cats"] > 1:
            self._load_prior_dicts()
        self._load_interactions()
        self._compute_train_windows()
        self._load_item_feat()
        self.counter = {
            "user_id": Counter(
                {u: int(self.seq_offsets[u + 1] - self.seq_offsets[u]) for u in range(self.user_num)}
            ),
            "item_id": Counter(self.flat_items.tolist()),
        }
        logger.info(
            "dataset=%s users=%d items=%d interactions=%d train_windows=%d",
            self.dataset_name, self.user_num, self.item_num, self.interact_num,
            len(self.valid_sample_locations),
        )
        return self

    # ------------------------------------------------------------------
    def _load_prior_dicts(self):
        if self.cluster_as_tag:
            kind = "user_cluster_dict" if self.category_by == "user" else "cluster_dict"
        elif self.category_by == "event":
            kind = "event_dict"
        else:
            kind = "tag_dict"
        raw = load_prior_dict(self.config["data_path"], self.dataset_name, kind)
        if self.category_by in ("item", "user"):
            entry = raw[self.config["tag_version"]]
            self.category_counts = dict(entry["category_counts"])
            self.tag_to_category = {k: list(v) for k, v in entry["tag_to_category"].items()}
            cats = sorted(self.category_counts.keys())
            self.category_to_int = {c: i for i, c in enumerate(cats)}
        elif self.category_by == "event":
            self.category_counts = dict(raw["category_counts"])
            self.category_to_int = dict(raw["category_to_int"])
        else:
            raise ValueError(f"category_by={self.category_by} is not defined")
        self.config["int_to_category"] = {v: k for k, v in self.category_to_int.items()}

    # ------------------------------------------------------------------
    def _load_interactions(self):
        path = os.path.join(self.config["data_path"], f"{self.dataset_name}.parquet")
        if not os.path.isfile(path):
            raise ValueError(f"File {path} does not exist")
        cols = ["item_id", "user_id", "timestamp"]
        if self.category_by == "event" and self.eval_num_cats > 1:
            cols.append("event_id")
        if self.category_by == "user" and self.eval_num_cats > 1:
            cols.append(self.tag_col)
        import pandas as pd

        df = pd.read_parquet(path, columns=cols)

        lens = df["item_id"].map(len).to_numpy()
        min_len = self.eval_pred_len * 2
        if self.config["min_seq_len"] is not None:
            min_len = max(self.config["min_seq_len"], min_len)
        df = df[lens > min_len].reset_index(drop=True)

        user_tokens = df["user_id"].astype(str).tolist()
        self.id2token["user_id"] = ["[PAD]"] + user_tokens

        all_items = sorted({str(it) for seq in df["item_id"] for it in seq})
        self.id2token["item_id"] = ["[PAD]"] + all_items
        item_token_to_id = {t: i + 1 for i, t in enumerate(all_items)}

        self.user_num = len(self.id2token["user_id"])
        self.item_num = len(self.id2token["item_id"])

        seq_lists = df["item_id"].tolist()
        seq_lens = np.fromiter((len(s) for s in seq_lists), dtype=np.int64, count=len(seq_lists))
        self.seq_offsets = np.zeros(self.user_num + 1, dtype=np.int64)
        self.seq_offsets[2:] = np.cumsum(seq_lens)
        self.seq_offsets[1] = 0  # uid 0 is the empty pad user
        total = int(seq_lens.sum())
        self.interact_num = total

        self.flat_items = np.empty(total, dtype=np.int64)
        pos = 0
        get = item_token_to_id.__getitem__
        for s in seq_lists:
            n = len(s)
            self.flat_items[pos : pos + n] = [get(str(x)) for x in s]
            pos += n

        if self.timestamp_required:
            self.flat_times = np.concatenate(
                [np.asarray(t, dtype=np.int64) for t in df["timestamp"]]
            )
        if self.category_by == "event" and self.eval_num_cats > 1:
            self.flat_events = np.concatenate(
                [np.asarray(e, dtype=np.int64) for e in df["event_id"]]
            )
        if self.category_by == "user" and self.eval_num_cats > 1:
            self.user_cluster_list = np.concatenate(
                [[0], df[self.tag_col].to_numpy(dtype=np.int64)]
            )

    # ------------------------------------------------------------------
    def seq_of(self, uid: int) -> np.ndarray:
        return self.flat_items[self.seq_offsets[uid] : self.seq_offsets[uid + 1]]

    def events_of(self, uid: int) -> np.ndarray:
        return self.flat_events[self.seq_offsets[uid] : self.seq_offsets[uid + 1]]

    def times_of(self, uid: int) -> np.ndarray:
        return self.flat_times[self.seq_offsets[uid] : self.seq_offsets[uid + 1]]

    def seq_len_of(self, uid: int) -> int:
        return int(self.seq_offsets[uid + 1] - self.seq_offsets[uid])

    # ------------------------------------------------------------------
    def _compute_train_windows(self):
        """Exact window policy of reference dataload.py:164-195."""
        lens = np.diff(self.seq_offsets)
        self.train_seq_len = lens - self.eval_pred_len * 2 - self.train_test_gap
        locs = []
        stride = self.max_item_list_len
        for uid in range(self.user_num):
            tlen = int(self.train_seq_len[uid])
            if self.subset_user and uid % self.subset_user_div != self.subset_user_rmd:
                continue
            if tlen <= 1:
                continue
            if self.sample_last_only:
                if tlen < self.pred_len + 3:
                    locs.append((uid, tlen - 1))
                else:
                    locs.append((uid, tlen - self.pred_len))
            elif tlen <= stride:
                locs.append((uid, tlen - 1))
            else:
                offset = (tlen - 1) % stride
                locs.extend((uid, end) for end in range(offset, tlen, stride))
        self.valid_sample_locations = np.asarray(locs, dtype=np.int64).reshape(-1, 2)

    # ------------------------------------------------------------------
    def _load_item_feat(self):
        text_path = self.config["text_path"]
        if not str(text_path).endswith(".parquet"):
            raise ValueError(f"Unsupported item-feature format: {text_path}")
        import pandas as pd

        df = pd.read_parquet(text_path)
        keys = list(self.config["text_keys"] or []) + ["item_id"]
        if self.tag_col is not None and self.category_by == "item" and self.tag_col not in keys:
            keys.append(self.tag_col)
        if self.config.get("use_image") and self.config.get("use_image_online"):
            # online mode: per-item image path/URL comes from the item
            # parquet's ``image`` column (reference dataload.py:205) instead
            # of being derived as {image_dir}/{item_id}.jpg
            keys.append("image")
        if self.config.get("neg_sample_mode", None) is not None:
            keys.append("interact_count")
        df = df[[k for k in keys if k in df.columns]]
        known = set(self.id2token["item_id"])
        df = df[df["item_id"].astype(str).isin(known)].reset_index(drop=True)
        token_to_id = {t: i for i, t in enumerate(self.id2token["item_id"])}
        df["int_item_id"] = df["item_id"].astype(str).map(token_to_id)

        self.item_text = df.set_index("int_item_id", drop=False)

        C = self.eval_num_cats
        if C > 1 and self.category_by in ("event", "user"):
            # every item belongs to every category for event/user priors
            # (reference batchset.py:36-38: tag_category all-True per item)
            self.item_tag_matrix = np.ones((self.item_num, C), dtype=bool)
            self.item_tag_matrix[0] = False
            self.item_orig_tag_matrix = self.item_tag_matrix.copy()
        if C > 1 and self.category_by == "item":
            ordered_cats = [self.config["int_to_category"][i] for i in range(C)]
            cat_pos = {c: i for i, c in enumerate(ordered_cats)}
            tag_matrix = np.zeros((self.item_num, C), dtype=bool)
            fine_tags = sorted({str(t) for t in df[self.tag_col]})
            fine_tag_to_int = {t: i for i, t in enumerate(fine_tags)}
            self.item_fine_tag = np.full(self.item_num, -1, dtype=np.int64)
            for iid, tag in zip(df["int_item_id"].to_numpy(), df[self.tag_col]):
                self.item_fine_tag[iid] = fine_tag_to_int[str(tag)]
                for cat in self.tag_to_category.get(str(tag), self.tag_to_category.get(tag, [])):
                    if cat in cat_pos:
                        tag_matrix[iid, cat_pos[cat]] = True
            self.item_orig_tag_matrix = tag_matrix.copy()
            if self.config.get("random_tags", False):
                logger.info("*** Ablation: randomly assigning items to categories ***")
                rng = np.random.default_rng(seed=42)
                tag_matrix = rng.integers(0, 2, size=(self.item_num, C)).astype(bool)
                tag_matrix[0] = False
            elif self.config.get("all_tags", False):
                logger.info("*** Ablation: assigning each item to all categories ***")
                tag_matrix = np.ones((self.item_num, C), dtype=bool)
                tag_matrix[0] = False
            self.item_tag_matrix = tag_matrix

            # per-category pools come from the ORIGINAL tag→category mapping,
            # independent of the random_tags/all_tags ablations
            # (reference dataload.py:287-340 reuses tag_to_category directly)
            pools = [np.where(self.item_orig_tag_matrix[:, c])[0] for c in range(C)]
            pools = [p[p > 0] for p in pools]
            self.int_category_to_item_id = pools

        mode = self.config.get("neg_sample_mode", None)
        if mode is not None:
            counts = np.zeros(self.item_num - 1, dtype=np.float64)
            if "interact_count" in df.columns:
                for iid, c in zip(df["int_item_id"].to_numpy(), df["interact_count"].to_numpy()):
                    if iid >= 1:
                        counts[iid - 1] = c
            w = self._weight_transform(counts, mode)
            cdf = np.cumsum(w)
            self.item_interact_weights = cdf / max(cdf[-1], 1e-12)
            if self.int_category_to_item_id is not None:
                self.item_weights_by_cat = []
                full_counts = np.concatenate([[0.0], counts])
                for pool in self.int_category_to_item_id:
                    wc = self._weight_transform(full_counts[pool], mode)
                    cdfc = np.cumsum(wc)
                    self.item_weights_by_cat.append(cdfc / max(cdfc[-1] if len(cdfc) else 1.0, 1e-12))

    @staticmethod
    def _weight_transform(counts: np.ndarray, mode: str) -> np.ndarray:
        if mode == "identity":
            return counts
        if mode == "sqrt":
            return np.sqrt(counts)
        if mode == "log":
            return np.log(counts + 1)
        raise ValueError(f"Unsupported neg_sample_mode: {mode}")

    # ------------------------------------------------------------------
    @property
    def user_counter(self):
        return self.counter["user_id"]

    @property
    def item_counter(self):
        return self.counter["item_id"]

    @property
    def avg_actions_of_users(self):
        return self.interact_num / self.user_num

    @property
    def avg_actions_of_items(self):
        return self.interact_num / self.item_num

    @property
    def sparsity(self):
        return 1 - self.interact_num / self.user_num / self.item_num
