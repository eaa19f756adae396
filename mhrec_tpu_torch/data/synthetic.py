"""In-memory synthetic interaction data.

Port of ``InMemoryInteractionData`` (``mhrec_tpu/data/synthetic.py``): a
duck-typed ``InteractionData`` fabricated directly from numpy with the same
rng stream, so a serving run at corpus scale needs no parquet round-trip (and
no pandas). The parquet fixture generator stays with the JAX package; the
port's tests read its files through ``data/interaction.py``.

``item_texts=True`` adds item texts for the HLLM item tower, a test fixture
rather than a feature: the columns ``generate_synthetic_dataset`` writes
(title, tag, description with filler words), with each item's filler word
count drawn from the seed so that token lengths spread over about 16-256
and packing the corpus is real varlen work. Without texts every item
renders the bare prompt.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class ItemTextTable:
    """Item text columns held in memory, read as the text renderer reads the
    parquet reader's DataFrame: ``item_id in table.index`` and
    ``table.loc[item_id][column]``."""

    def __init__(self, item_ids, columns: Dict[str, List[str]]):
        self.index = frozenset(int(i) for i in item_ids)
        self.loc = {int(i): {k: col[n] for k, col in columns.items()}
                    for n, i in enumerate(item_ids)}


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
        item_texts: bool = False,
        max_filler_words: int = 240,
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
        self.item_text = None  # text batchers render the bare prompt
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
        if item_texts:
            self.item_text = self._texts(num_items, num_categories, seed, max_filler_words)

    def _texts(self, num_items: int, num_categories: int, seed: int, max_filler: int):
        """Texts of items 1..num_items-1 (item x is token ``i{x-1}``), drawn
        from a stream of their own so the interactions stay as without."""
        rng = np.random.default_rng((seed, 1))
        fillers = rng.integers(0, max_filler + 1, size=num_items)
        cats = (self.item_tag_matrix.argmax(axis=1) if self.item_tag_matrix is not None
                else np.zeros(num_items, dtype=np.int64))
        ids = np.arange(1, num_items)
        x = ids - 1
        columns = {
            "title": [f"Item number {i}" for i in x],
            "tag": [f"tag_{int(cats[i])}" for i in ids],
            "description": [
                " ".join([f"Synthetic item {i} description."]
                         + [f"w{(i * 37 + j) % 9973}" for j in range(int(fillers[n]))])
                for n, i in zip(ids, x)
            ],
        }
        return ItemTextTable(ids, columns)

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
