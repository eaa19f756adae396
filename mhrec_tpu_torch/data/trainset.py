"""Training batcher for ID sequence models (port of
``mhrec_tpu/data/trainset.py``).

One sample is a window of ``MAX_ITEM_LIST_LENGTH + pred_len`` item ids ending
at a precomputed ``(uid, context_end)`` location: left-padded context,
right-padded prediction slots, with padding drawn as random negatives when
``pad_random_sample`` (reference ``trainset.py:111-177``). Negatives are
``num_negatives / train_batch_size`` per sample (trainset.py:60), optionally
drawn per category. ``train_batch_size`` is GLOBAL: with ``num_hosts``
ranks each builds ``train_batch_size / num_hosts`` rows of its host-strided
share of every epoch, so the global pool keeps ``num_negatives``. A whole batch is one vectorized gather against the flat
interaction array plus one vectorized negative-sampling call; a background
thread keeps batches ready.

Batch dict (all numpy, static shapes):
  items            [B, L+P] int32
  neg_items        [B, num_cats+1 or 1, K] int32
  masked_index     [B, L+P] int32   (1 = real token)
  tag_categories   [B, L+P, C] int8 (only when loss == 'prior')
  pos_neg_items    [B, L+P-1, num_negatives] int32 (SASRec / LLMIDRec under
                   sparse_item_adam or batch_position_negatives)
  unique_ids       [U] int64        (only under sparse_item_adam; −1 = pad)

Under ``sparse_item_adam`` item ids in the batch are local indices into the
block of unique ids, whose pad slots hold −1 (the JAX package aliases them
to id 0 and adds a ``unique_mask``). With ``num_hosts > 1`` the indices
address the concatenation of every host's block, as in the JAX package:
host h's nonzero indices are shifted by ``h · unique_cap`` and index 0 (the
pad item) stays 0.
"""

from __future__ import annotations

import math
import queue as queue_mod
import threading
from typing import Dict, Iterator

import numpy as np

from mhrec_tpu_torch.data.samplers import make_negative_sampler


def _wants_position_negatives(config) -> bool:
    """SASRec and LLMIDRec draw [B, L, num_negatives] per-position negatives
    in the model (reference sasrec.py:79-86 ``torch.randint``). Under
    sparse_item_adam those draws cannot index the per-batch sub-table, so
    the batcher draws them (the same uniform [1, item_num) law) and remaps
    them like every other id; ``batch_position_negatives`` takes the batch
    path outside sparse mode too (for sparse / dense parity)."""
    return (
        str(config["model"]) in ("SASRec", "LLMIDRec")
        and bool(config["num_negatives"])
        and (bool(config.get("sparse_item_adam", False))
             or bool(config.get("batch_position_negatives", False)))
    )


def unique_id_cap(config, num_hosts: int = 1) -> int:
    """Static size of one host's unique-id block under sparse_item_adam:
    every id in its rows of the batch (the per-position negatives too) + 1
    forced pad id, rounded up to a multiple of 512 (JAX trainset.py:52-62)."""
    rows = config["train_batch_size"] // num_hosts
    window = config["MAX_ITEM_LIST_LENGTH"] + config["pred_len"]
    num_neg = config["num_negatives"]
    per_sample_negs = (math.ceil(num_neg / config["train_batch_size"]) if num_neg
                       else config["MAX_ITEM_LIST_LENGTH"])
    by_cat = (
        config["loss"] == "prior"
        and bool(config["neg_sample_by_cat"])
        and config["category_by"] == "item"
    )
    n_ids = rows * window
    n_ids += rows * per_sample_negs * ((config["eval_num_cats"] + 1) if by_cat else 1)
    if _wants_position_negatives(config):
        n_ids += rows * (window - 1) * num_neg
    return ((n_ids + 1 + 511) // 512) * 512


class SEQTrainBatcher:
    def __init__(self, config, dataload, host_id: int = 0, num_hosts: int = 1):
        self.dataload = dataload
        self.config = config
        self.item_num = dataload.item_num
        self.max_seq_length = config["MAX_ITEM_LIST_LENGTH"]
        self.pred_len = config["pred_len"]
        self.window_len = self.max_seq_length + self.pred_len
        self.global_batch_size = config["train_batch_size"]
        if self.global_batch_size % num_hosts:
            raise ValueError(f"train_batch_size {self.global_batch_size} must divide by "
                             f"num_hosts {num_hosts}")
        self.host_id, self.num_hosts = host_id, num_hosts
        self.batch_size = self.global_batch_size // num_hosts  # this host's rows

        self.return_tag_mask = config["loss"] == "prior"
        self.category_by = config["category_by"]
        self.eval_num_cats = config["eval_num_cats"]
        self.neg_sample_by_cat = (
            self.return_tag_mask
            and bool(config["neg_sample_by_cat"])
            and self.category_by == "item"
        )
        self.random_sample = bool(config["pad_random_sample"])

        num_neg = config["num_negatives"]
        # per sample, so that the GLOBAL pool holds about num_negatives
        self.num_negatives = (math.ceil(num_neg / self.global_batch_size) if num_neg
                              else self.max_seq_length)

        self.sampler = make_negative_sampler(config, dataload)
        self.locations = dataload.valid_sample_locations
        self.length = len(self.locations)
        self.seed = int(config["seed"] or 0)

        # sparse item-table updates: remap item ids in the batch to local
        # indices into a per-batch unique-id sub-table
        self.sparse_item_table = bool(config.get("sparse_item_adam", False))
        self._remap_lut = None  # lazy [item_num] int32
        self.position_negatives = _wants_position_negatives(config)
        self.num_position_negatives = int(config["num_negatives"] or 0)
        if self.sparse_item_table:
            self.unique_cap = unique_id_cap(config, num_hosts)

        if self.category_by == "user" and self.return_tag_mask:
            n_clusters = max(dataload.category_to_int.values()) + 1
            self.one_hot_user_cluster = np.eye(n_clusters, dtype=np.int8)[
                dataload.user_cluster_list
            ]

    def __len__(self):
        return self.length

    @property
    def steps_per_epoch(self) -> int:
        return max((self.length // self.num_hosts) // self.batch_size, 1)

    # ------------------------------------------------------------------
    def make_batch(self, rng: np.random.Generator, loc_idx: np.ndarray) -> Dict[str, np.ndarray]:
        d = self.dataload
        L, P, W = self.max_seq_length, self.pred_len, self.window_len
        uid = self.locations[loc_idx, 0]
        context_end = self.locations[loc_idx, 1]
        B = len(uid)

        context_start = np.maximum(0, context_end - L)
        context_pad = L - (context_end - context_start)
        pred_take = np.minimum(d.train_seq_len[uid] - context_end, P)
        pred_pad = P - pred_take

        col = np.arange(W)[None, :]
        src_pos = context_start[:, None] + (col - context_pad[:, None])
        valid = (col >= context_pad[:, None]) & (col < W - pred_pad[:, None])
        flat_idx = d.seq_offsets[uid][:, None] + np.clip(src_pos, 0, None)
        flat_idx = np.minimum(flat_idx, len(d.flat_items) - 1)
        items = np.where(valid, d.flat_items[flat_idx], 0)

        if self.random_sample:
            # pad slots drawn as random negatives excluding the real window
            # items (reference trainset.py:111-122)
            pad_draws = self.sampler.sample(rng, np.where(valid, items, 0), W)
            items = np.where(valid, items, pad_draws[:, :W])

        masked_index = valid.astype(np.int32)

        # negatives exclude everything in the (already padded) window row
        # (reference reconstruct_train_data, trainset.py:124-137)
        K = self.num_negatives
        if self.neg_sample_by_cat:
            negs = [
                self.sampler.sample(rng, items, K, cat_idx=c)
                for c in range(self.eval_num_cats)
            ]
            negs.append(self.sampler.sample(rng, items, K))
            neg_items = np.stack(negs, axis=1)
        else:
            neg_items = self.sampler.sample(rng, items, K)[:, None, :]

        batch = {
            "items": items.astype(np.int32),
            "neg_items": neg_items.astype(np.int32),
            "masked_index": masked_index,
        }

        if self.return_tag_mask:
            if self.category_by == "item":
                batch["tag_categories"] = d.item_tag_matrix[items].astype(np.int8)
            elif self.category_by == "user":
                batch["tag_categories"] = np.broadcast_to(
                    self.one_hot_user_cluster[uid][:, None, :], (B, W, self.eval_num_cats)
                ).astype(np.int8)
            else:  # event
                ev = np.where(valid, d.flat_events[flat_idx], -1)
                onehot = np.zeros((B, W, self.eval_num_cats), dtype=np.int8)
                rows, cols = np.nonzero(ev >= 0)
                onehot[rows, cols, ev[rows, cols]] = 1
                batch["tag_categories"] = onehot
        else:
            batch["tag_categories"] = np.zeros((B, 0, 0), dtype=np.int8)

        if self.position_negatives:
            # per-position uniform draws, the reference's in-model
            # torch.randint [1, item_num) (sasrec.py:79-86), drawn here so
            # that sparse mode can remap them to sub-table indices
            batch["pos_neg_items"] = rng.integers(
                1, self.item_num, size=(B, W - 1, self.num_position_negatives)
            ).astype(np.int32)

        if self.sparse_item_table:
            # AFTER all global-id lookups (tags above): remap items/neg_items
            # to local indices into the per-batch unique block. Index 0 is
            # always the pad item (id 0), so pad checks (== 0) keep working.
            remap_keys = ("items", "neg_items") + (
                ("pos_neg_items",) if self.position_negatives else ())
            uniq = np.unique(np.concatenate([[0]] + [batch[k].ravel() for k in remap_keys]))
            n = len(uniq)
            if n > self.unique_cap:
                raise ValueError(f"{n} unique ids exceed the block of {self.unique_cap}")
            ids = np.full(self.unique_cap, -1, np.int64)
            ids[:n] = uniq
            batch["unique_ids"] = ids
            # O(1)-per-lookup remap through a persistent [item_num] table;
            # stale entries from earlier batches are never read (every
            # remapped value is in this batch's uniq)
            if self._remap_lut is None:
                self._remap_lut = np.zeros(self.item_num, np.int32)
            self._remap_lut[uniq] = np.arange(n, dtype=np.int32)
            off = self.host_id * self.unique_cap
            for k in remap_keys:
                v = self._remap_lut[batch[k]]
                # this host's block in the concatenation of every host's;
                # index 0, the pad item, stays 0 (the `items != 0` checks)
                batch[k] = np.where(v > 0, v + off, 0).astype(np.int32) if off else v
        return batch

    # ------------------------------------------------------------------
    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled batches of this host's share of one epoch, the last
        partial batch dropped (DistributedSampler semantics: the same
        permutation on every host, rank-strided; JAX trainset.py:269-283)."""
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.length)
        shard = perm[self.host_id::self.num_hosts]
        # the same batch count on every host (lockstep): from the global
        # length, not this host's (possibly one longer) share
        n_batches = (self.length // self.num_hosts) // self.batch_size
        # the JAX package's per-host stream
        sample_rng = np.random.default_rng((self.seed + epoch) * 1_000_003 + self.host_id)
        for b in range(n_batches):
            idx = shard[b * self.batch_size : (b + 1) * self.batch_size]
            yield self.make_batch(sample_rng, idx)

    def infinite_batches(self, prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batch stream with background-thread prefetch."""
        if (self.length // self.num_hosts) // self.batch_size == 0:
            raise ValueError(f"{self.length} train windows over {self.num_hosts} hosts make no "
                             f"batch of {self.batch_size} rows")

        def gen():
            epoch = 0
            while True:
                yield from self.epoch_batches(epoch)
                epoch += 1

        return _prefetch_iterator(gen(), prefetch)


def _prefetch_iterator(it: Iterator, depth: int) -> Iterator:
    if depth <= 0:
        return it
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(stop)
        except BaseException as exc:  # propagate into the consumer — a
            # swallowed producer error would silently truncate the stream
            q.put((stop, exc))

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def drain():
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                raise item[1]
            yield item

    return drain()
