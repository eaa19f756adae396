"""In-memory synthetic interaction data.

Port of ``InMemoryInteractionData`` (``mhrec_tpu/data/synthetic.py``): a
duck-typed ``InteractionData`` fabricated directly from numpy with the same
rng stream, so a serving run at corpus scale needs no parquet round-trip (and
no pandas). ``generate_synthetic_dataset`` and
``generate_synthetic_dataset_fast`` are copies of the JAX package's parquet
fixture writers (the interactions, the item info and the tag dictionary in
the loader's layout; pandas is imported inside them), which
``data/interaction.py`` reads.

``item_texts=True`` adds item texts for the HLLM item tower, a test fixture
rather than a feature: the columns ``generate_synthetic_dataset`` writes
(title, tag, description with filler words), with each item's filler word
count drawn from the seed so that token lengths spread over about 16-256
and packing the corpus is real varlen work. Without texts every item
renders the bare prompt.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


def generate_synthetic_dataset(
    data_path: str,
    name: str = "SynthRec",
    num_users: int = 200,
    num_items: int = 500,
    num_categories: int = 4,
    tags_per_category: int = 3,
    mean_seq_len: int = 40,
    min_seq_len: int = 12,
    max_seq_len: int = 120,
    category_stickiness: float = 0.7,
    with_events: bool = False,
    with_user_clusters: bool = False,
    seed: int = 0,
    text_words: int = 4,
) -> dict:
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(data_path, exist_ok=True)

    num_tags = num_categories * tags_per_category
    tag_names = [f"tag_{t}" for t in range(num_tags)]
    cat_names = [f"cat_{c}" for c in range(num_categories)]
    tag_to_cat = {tag_names[t]: [cat_names[t % num_categories]] for t in range(num_tags)}

    item_tags = rng.integers(0, num_tags, size=num_items)
    item_cat = item_tags % num_categories
    # popularity: zipf-ish
    pop = 1.0 / (1.0 + np.arange(num_items)) ** 0.8
    rng.shuffle(pop)

    users, seqs, times, events, clusters = [], [], [], [], []
    interact_count = np.zeros(num_items, dtype=np.int64)
    items_by_cat = [np.where(item_cat == c)[0] for c in range(num_categories)]
    pop_by_cat = [pop[idx] / pop[idx].sum() for idx in items_by_cat]

    for u in range(num_users):
        L = int(np.clip(rng.poisson(mean_seq_len), min_seq_len, max_seq_len))
        cat = int(rng.integers(num_categories))
        seq = np.empty(L, dtype=np.int64)
        ev = np.empty(L, dtype=np.int64)
        for i in range(L):
            if rng.random() > category_stickiness:
                cat = int(rng.integers(num_categories))
            seq[i] = rng.choice(items_by_cat[cat], p=pop_by_cat[cat])
            ev[i] = cat
        interact_count += np.bincount(seq, minlength=num_items)
        users.append(f"u{u}")
        seqs.append([f"i{x}" for x in seq])
        t0 = 1_600_000_000 + int(rng.integers(0, 10_000_000))
        times.append((t0 + np.arange(L) * 3600).tolist())
        events.append(ev.tolist())
        clusters.append(int(rng.integers(num_categories)))

    inter = {"user_id": users, "item_id": seqs, "timestamp": times}
    if with_events:
        inter["event_id"] = events
    if with_user_clusters:
        inter["user_cluster_v1"] = clusters
    pd.DataFrame(inter).to_parquet(os.path.join(data_path, f"{name}.parquet"))

    info = pd.DataFrame(
        {
            "item_id": [f"i{x}" for x in range(num_items)],
            "title": [f"Item number {x}" for x in range(num_items)],
            "tag": [tag_names[item_tags[x]] for x in range(num_items)],
            # text_words > 4 pads descriptions with distinct filler words so
            # protocol-scale benches (MAX_TEXT_LENGTH=256) see real-length
            # token streams instead of 6-token titles
            "description": [
                " ".join([f"Synthetic item {x} description."]
                         + [f"w{(x * 37 + j) % 9973}" for j in range(max(0, text_words - 4))])
                for x in range(num_items)
            ],
            "interact_count": interact_count,
        }
    )
    info.to_parquet(os.path.join(data_path, f"{name}-info.parquet"))

    cat_counts = {
        cat_names[c]: int((item_cat == c).sum()) for c in range(num_categories)
    }
    tag_dict = {"v1": {"category_counts": cat_counts, "tag_to_category": tag_to_cat},
                "v2": {"category_counts": cat_counts, "tag_to_category": tag_to_cat}}
    with open(os.path.join(data_path, f"{name}_tag_dict.json"), "w") as fh:
        json.dump(tag_dict, fh)
    if with_events:
        event_dict = {
            "category_counts": {cat_names[c]: 1 for c in range(num_categories)},
            "category_to_int": {cat_names[c]: c for c in range(num_categories)},
        }
        with open(os.path.join(data_path, f"{name}_event_dict.json"), "w") as fh:
            json.dump(event_dict, fh)
    if with_user_clusters:
        cluster_dict = {"v1": {"category_counts": cat_counts,
                               "tag_to_category": {str(c): [cat_names[c]] for c in range(num_categories)}}}
        with open(os.path.join(data_path, f"{name}_user_cluster_dict.json"), "w") as fh:
            json.dump(cluster_dict, fh)

    return {
        "name": name,
        "data_path": data_path,
        "text_path": os.path.join(data_path, f"{name}-info.parquet"),
        "num_users": num_users,
        "num_items": num_items,
        "num_categories": num_categories,
    }


def generate_synthetic_dataset_fast(
    data_path: str,
    name: str = "SynthRec",
    num_users: int = 10_000,
    num_items: int = 200_000,
    num_categories: int = 8,
    tags_per_category: int = 3,
    mean_seq_len: int = 160,
    min_seq_len: int = 60,
    max_seq_len: int = 400,
    category_stickiness: float = 0.7,
    seed: int = 0,
    text_words: int = 4,
) -> dict:
    """Vectorized variant of :func:`generate_synthetic_dataset` for
    protocol-scale fixtures (200k items × millions of interactions): the
    per-interaction Python loop is replaced by one flat sticky-Markov pass
    (last-draw scatter + ``maximum.accumulate``) and per-category CDF
    ``searchsorted`` draws. Same distributional family — category-sticky
    sequences over a zipf-skewed catalog — but a DIFFERENT rng stream, so
    it is a separate function rather than a flag (test fixtures pin seeds
    on the original)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(data_path, exist_ok=True)

    C = num_categories
    num_tags = C * tags_per_category
    tag_names = [f"tag_{t}" for t in range(num_tags)]
    cat_names = [f"cat_{c}" for c in range(C)]
    tag_to_cat = {tag_names[t]: [cat_names[t % C]] for t in range(num_tags)}

    item_tags = rng.integers(0, num_tags, size=num_items)
    item_cat = item_tags % C
    pop = 1.0 / (1.0 + np.arange(num_items)) ** 0.8
    rng.shuffle(pop)
    items_by_cat = [np.where(item_cat == c)[0] for c in range(C)]
    cdf_by_cat = []
    for idx in items_by_cat:
        w = pop[idx]
        cdf_by_cat.append(np.cumsum(w) / w.sum())

    lens = np.clip(
        rng.poisson(mean_seq_len, num_users), min_seq_len, max_seq_len
    ).astype(np.int64)
    total = int(lens.sum())
    offsets = np.concatenate([[0], np.cumsum(lens)])

    # sticky-Markov category chain over the flat stream with per-user resets
    pos = np.arange(total, dtype=np.int64)
    draw = rng.random(total) > category_stickiness
    draw[offsets[:-1]] = True  # every user's first position draws fresh
    new_cat = rng.integers(0, C, size=total)
    last_draw = np.maximum.accumulate(np.where(draw, pos, 0))
    cats = new_cat[last_draw]

    # popularity-weighted item draw inside the active category
    u = rng.random(total)
    flat_items = np.empty(total, dtype=np.int64)
    for c in range(C):
        m = cats == c
        flat_items[m] = items_by_cat[c][
            np.searchsorted(cdf_by_cat[c], u[m], side="right").clip(
                0, len(items_by_cat[c]) - 1
            )
        ]
    interact_count = np.bincount(flat_items, minlength=num_items)

    item_strs = np.char.add("i", np.arange(num_items).astype(str))
    seq_strs = item_strs[flat_items]
    t0s = 1_600_000_000 + rng.integers(0, 10_000_000, size=num_users)
    inter = {
        "user_id": [f"u{u_}" for u_ in range(num_users)],
        "item_id": [
            seq_strs[offsets[k]:offsets[k + 1]].tolist()
            for k in range(num_users)
        ],
        "timestamp": [
            (t0s[k] + np.arange(lens[k]) * 3600).tolist()
            for k in range(num_users)
        ],
    }
    pd.DataFrame(inter).to_parquet(os.path.join(data_path, f"{name}.parquet"))

    info = pd.DataFrame(
        {
            "item_id": item_strs,
            "title": np.char.add("Item number ", np.arange(num_items).astype(str)),
            "tag": [tag_names[t] for t in item_tags],
            "description": [
                " ".join([f"Synthetic item {x} description."]
                         + [f"w{(x * 37 + j) % 9973}" for j in range(max(0, text_words - 4))])
                for x in range(num_items)
            ],
            "interact_count": interact_count,
        }
    )
    info.to_parquet(os.path.join(data_path, f"{name}-info.parquet"))

    cat_counts = {
        cat_names[c]: int((item_cat == c).sum()) for c in range(C)
    }
    tag_dict = {"v1": {"category_counts": cat_counts, "tag_to_category": tag_to_cat},
                "v2": {"category_counts": cat_counts, "tag_to_category": tag_to_cat}}
    with open(os.path.join(data_path, f"{name}_tag_dict.json"), "w") as fh:
        json.dump(tag_dict, fh)
    return {
        "name": name,
        "data_path": data_path,
        "text_path": os.path.join(data_path, f"{name}-info.parquet"),
        "num_users": num_users,
        "num_items": num_items,
        "num_categories": C,
        "interactions": total,
    }


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
