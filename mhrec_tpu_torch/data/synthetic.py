"""In-memory synthetic interaction data.

Port of ``InMemoryInteractionData`` (``mhrec_tpu/data/synthetic.py``): a
duck-typed ``InteractionData`` fabricated directly from numpy with the same
rng stream, so a serving run at corpus scale needs no parquet round-trip (and
no pandas). The parquet fixture generator stays with the JAX package; the
port's tests read its files through ``data/interaction.py``.
"""

from __future__ import annotations

import numpy as np


class InMemoryInteractionData:
    """Duck-typed InteractionData fabricated directly from numpy — used by
    benchmarks to build corpus-scale fixtures in O(interactions) without a
    parquet round-trip."""

    def __init__(
        self,
        num_users: int,
        num_items: int,
        seq_len: int,
        num_categories: int = 0,
        eval_pred_len: int = 1,
        max_item_list_length: int = 50,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.user_num = num_users + 1
        self.item_num = num_items
        lens = np.full(num_users, seq_len, dtype=np.int64)
        self.seq_offsets = np.zeros(self.user_num + 1, dtype=np.int64)
        self.seq_offsets[2:] = np.cumsum(lens)
        total = int(lens.sum())
        self.interact_num = total
        self.flat_items = rng.integers(1, num_items, size=total, dtype=np.int64)
        self.flat_times = None
        self.flat_events = None
        self.train_seq_len = np.diff(self.seq_offsets) - eval_pred_len * 2
        stride = max_item_list_length + 1
        locs = []
        for uid in range(1, self.user_num):
            tlen = int(self.train_seq_len[uid])
            if tlen <= 1:
                continue
            if tlen <= stride:
                locs.append((uid, tlen - 1))
            else:
                off = (tlen - 1) % stride
                locs.extend((uid, e) for e in range(off, tlen, stride))
        self.valid_sample_locations = np.asarray(locs, dtype=np.int64).reshape(-1, 2)
        self.id2token = {
            "user_id": ["[PAD]"] + [f"u{i}" for i in range(num_users)],
            "item_id": ["[PAD]"] + [f"i{i}" for i in range(num_items - 1)],
        }
        self.category_counts = {}
        self.category_to_int = {}
        self.user_cluster_list = None
        self.item_interact_weights = None
        self.item_weights_by_cat = None
        self.item_fine_tag = None
        self.item_text = None  # text batchers render "unknown item"
        self.counter = {"user_id": {}, "item_id": {}}
        if num_categories > 1:
            cat = rng.integers(0, num_categories, size=num_items)
            self.item_tag_matrix = np.zeros((num_items, num_categories), dtype=bool)
            self.item_tag_matrix[np.arange(num_items), cat] = True
            self.item_tag_matrix[0] = False
            self.item_orig_tag_matrix = self.item_tag_matrix.copy()
            self.int_category_to_item_id = [
                np.where(self.item_tag_matrix[:, c])[0] for c in range(num_categories)
            ]
            self.category_counts = {
                f"cat_{c}": int(self.item_tag_matrix[:, c].sum())
                for c in range(num_categories)
            }
            self.category_to_int = {f"cat_{c}": c for c in range(num_categories)}
        else:
            self.item_tag_matrix = None
            self.item_orig_tag_matrix = None
            self.int_category_to_item_id = None

    def seq_of(self, uid):
        return self.flat_items[self.seq_offsets[uid] : self.seq_offsets[uid + 1]]

    def seq_len_of(self, uid):
        return int(self.seq_offsets[uid + 1] - self.seq_offsets[uid])

    @property
    def item_counter(self):
        return self.counter["item_id"]

    @property
    def user_counter(self):
        return self.counter["user_id"]
