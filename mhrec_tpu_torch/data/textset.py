"""Text batching for the HLLM item tower (port of
``mhrec_tpu/data/textset.py``, one process).

Each item's text is rendered as ``{item_prompt}Title: .. Tag: ..
Description: ..`` and tokenized to at most ``MAX_TEXT_LENGTH`` tokens, with
one trailing slot per learnable item-embedding token. ``BatchTextBatcher``
walks the whole corpus for the item-embedding pass of an evaluation, as
dense padded token matrices or, under ``packed_corpus_pass``, packed into
chunk rows with segment ids (``models/llm/packed.py::pack_items``).
``TextSEQTrainBatcher`` adds the texts of every item of a training batch
(positives, then negatives) to ``SEQTrainBatcher``'s batch: dense padded
matrices, packed chunk rows (``packed_item_tower``) or, under
``dedup_items``, each distinct item once with the gather back.

The tokenizer resolves a pretrain directory as the JAX package's
``build_tokenizer`` does, without ``transformers`` or ``tokenizers``: a
``tokenizer.json``, or a BERT ``vocab.txt``, gives the HF tokenizer of
``data/hf_tokenizer.py`` (the same ids as ``AutoTokenizer``), unless its
vocabulary is larger than the model's, where the JAX package's guard takes
the hashing tokenizer over the model's vocabulary; a directory without a
tokenizer file, or no directory, gives the hashing tokenizer. Where the JAX
package loads the tokenizer through a library the port does not depend on
(SentencePiece's ``tokenizer.model``, tiktoken, a slow ``vocab.json`` /
``merges.txt`` BPE) or cannot load it at all and falls back to hashing, the
port raises instead of tokenizing differently. The image and video keys are
not ported yet (they raise), nor the multi-host batch layouts of the JAX
package.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, Iterator, Optional, Union

import numpy as np

from mhrec_tpu_torch.data.hf_tokenizer import HFTokenizer, load_tokenizer
from mhrec_tpu_torch.data.trainset import SEQTrainBatcher
from mhrec_tpu_torch.models.llm.packed import pack_items

logger = logging.getLogger(__name__)


class HashTokenizer:
    """Deterministic whitespace+hash tokenizer (no vocab files needed)."""

    kind = "hash"
    files_digest = None

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        self.bos_token_id = 1

    def encode(self, text: str, max_length: int):
        ids = [self.bos_token_id]
        for tok in text.lower().split():
            h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
            ids.append(2 + h % (self.vocab_size - 2))
            if len(ids) >= max_length:
                break
        return ids


def build_tokenizer(pretrain_dir: Optional[str],
                    vocab_size: int = 1024) -> Union[HashTokenizer, HFTokenizer]:
    """The pretrain directory's HF tokenizer (``hf_tokenizer.load_tokenizer``:
    ``tokenizer.json`` or a BERT ``vocab.txt``), or the hashing tokenizer over
    its model's vocabulary (``config.json``'s ``vocab_size``, or
    ``text_config``'s) where it holds no tokenizer file or where the
    tokenizer's vocabulary is larger than the model's (the JAX package's
    guard, ``mhrec_tpu/data/textset.py:80-87``), else over ``vocab_size``."""
    if not pretrain_dir:
        return HashTokenizer(vocab_size)
    model_vocab = None
    cfg_path = os.path.join(pretrain_dir, "config.json")
    if os.path.exists(cfg_path):
        try:
            with open(cfg_path) as fh:
                raw = json.load(fh)
            model_vocab = raw.get("vocab_size") or raw.get("text_config", {}).get("vocab_size")
        except (OSError, ValueError, AttributeError):
            pass
    tok = load_tokenizer(pretrain_dir)
    if tok is None:
        return HashTokenizer(model_vocab or vocab_size)
    if model_vocab and tok.vocab_size > model_vocab:
        # its ids would index past the embedding table
        logger.warning("%s: tokenizer vocabulary %d > model vocabulary %d: hashing tokenizer",
                       pretrain_dir, tok.vocab_size, model_vocab)
        return HashTokenizer(model_vocab)
    return tok


class ItemTextCache:
    """Per-item token arrays, computed once; optionally the whole corpus's
    token matrix persisted on disk."""

    # how many items the content digest samples; the first/last ids and an
    # even stride in between are always included
    _FP_SAMPLE = 4096

    def __init__(self, dataload, tokenizer, text_keys, item_prompt: str,
                 max_text_length: int, n_emb: int = 1):
        self.dataload = dataload
        self.tokenizer = tokenizer
        self.text_keys = list(text_keys or ["title", "tag", "description"])
        self.item_prompt = item_prompt or ""
        self.max_text_length = max_text_length
        self.n_emb = max(int(n_emb), 1)  # columns reserved for emb slots
        self._cache: Dict[int, np.ndarray] = {}
        # full-corpus token matrix (disk cache): [item_num, T] + lens
        self._matrix = None
        self._lens = None

    def render(self, item_id: int) -> str:
        """Reads any table with ``.index`` and ``.loc`` (the parquet
        reader's DataFrame, the in-memory fixture's ``ItemTextTable``)."""
        table = self.dataload.item_text
        parts = [self.item_prompt] if self.item_prompt else []
        if table is not None and item_id in table.index:
            row = table.loc[item_id]
            for key in self.text_keys:
                if key in row and row[key] is not None:
                    parts.append(f"{key.capitalize()}: {row[key]}")
        return " ".join(str(p) for p in parts) or "unknown item"

    def tokens(self, item_id: int) -> np.ndarray:
        if self._matrix is not None:
            return self._matrix[item_id, : self._lens[item_id]]
        arr = self._cache.get(item_id)
        if arr is None:
            budget = self.max_text_length
            ids = self.tokenizer.encode(self.render(item_id), budget)
            arr = self._cache[item_id] = np.asarray(ids[:budget], dtype=np.int32)
        return arr

    def batch(self, item_ids: np.ndarray):
        """→ (tokens [N, T+n_emb] with trailing emb slot(s), lens [N])."""
        T = self.max_text_length
        N = len(item_ids)
        out = np.zeros((N, T + self.n_emb), dtype=np.int32)
        if self._matrix is not None:
            ids = np.asarray(item_ids, dtype=np.int64)
            out[:, : self._matrix.shape[1]] = self._matrix[ids]
            return out, self._lens[ids].astype(np.int32)
        lens = np.empty(N, dtype=np.int32)
        for i, iid in enumerate(item_ids):
            ids = self.tokens(int(iid))
            out[i, : len(ids)] = ids
            lens[i] = len(ids)
        return out, lens

    # -- disk persistence: the corpus tokenization is static per dataset --
    def _fp_sample_ids(self, item_num: int):
        n = min(item_num, self._FP_SAMPLE)
        ids = np.unique(np.linspace(0, item_num - 1, n).astype(np.int64))
        return [int(i) for i in ids]

    def _fingerprint(self, dataset_name: str, item_num: int) -> str:
        """Content guard for the persisted token matrix: the rendered text of
        an evenly strided sample of items, the text settings (the JAX
        package's key without its image fields) and the tokenizer: its kind
        and a sha256 of its files' bytes, so that a matrix written under
        one tokenizer is not served under another of the same vocabulary
        size."""
        h = hashlib.sha256()
        for iid in self._fp_sample_ids(item_num):
            h.update(self.render(iid).encode("utf-8", "replace"))
            h.update(b"\x00")
        spec = dict(
            dataset=dataset_name, item_num=item_num,
            text_keys=self.text_keys, prompt=self.item_prompt,
            T=self.max_text_length, n_emb=self.n_emb,
            vocab=getattr(self.tokenizer, "vocab_size", None),
            tokenizer=getattr(self.tokenizer, "kind", None),
            tokenizer_files=getattr(self.tokenizer, "files_digest", None),
            static_prefix=None, images=None, content=h.hexdigest(),
        )
        return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]

    def _cache_path(self, cache_dir: str, dataset_name: str, item_num: int):
        return os.path.join(
            cache_dir, f"tokens_{dataset_name}_{self._fingerprint(dataset_name, item_num)}.npz")

    def load_disk_cache(self, cache_dir: str, dataset_name: str, item_num: int) -> bool:
        """Attach a previously persisted full-corpus token matrix."""
        path = self._cache_path(cache_dir, dataset_name, item_num)
        if not os.path.exists(path):
            return False
        z = np.load(path)
        mat, lens = z["tokens"], z["lens"]
        if mat.shape[0] != item_num:
            return False
        self._matrix, self._lens = mat, lens
        logger.info("token cache hit: %s (%d items)", path, item_num)
        return True

    def build_disk_cache(self, cache_dir: str, dataset_name: str, item_num: int) -> str:
        """Tokenize the whole corpus once and persist it (atomic rename)."""
        if self.load_disk_cache(cache_dir, dataset_name, item_num):
            return self._cache_path(cache_dir, dataset_name, item_num)
        mat = np.zeros((item_num, self.max_text_length), dtype=np.int32)
        lens = np.empty(item_num, dtype=np.int32)
        for iid in range(item_num):
            ids = self.tokens(iid)
            mat[iid, : len(ids)] = ids
            lens[iid] = len(ids)
        os.makedirs(cache_dir, exist_ok=True)
        path = self._cache_path(cache_dir, dataset_name, item_num)
        tmp = path + f".tmp{os.getpid()}.npz"
        np.savez(tmp, tokens=mat, lens=lens)
        os.replace(tmp, path)
        self._matrix, self._lens = mat, lens
        self._cache.clear()
        return path


def token_cache_dir(config) -> Optional[str]:
    """The corpus token-cache directory: the ``token_cache_dir`` key,
    default ``{data_path}/.token_cache``; ``false`` disables it."""
    v = config.get("token_cache_dir")
    if v is False or (isinstance(v, str) and v.lower() == "false"):
        return None
    if isinstance(v, str) and v:
        return v
    if config.get("data_path"):
        return os.path.join(str(config["data_path"]), ".token_cache")
    return None


class TextSEQTrainBatcher(SEQTrainBatcher):
    """``SEQTrainBatcher`` + the token matrices of every item occurrence of
    a batch (JAX ``TextSEQTrainBatcher``, textset.py:425-560, one process).
    The keys it adds:

    * dense: pos_tokens [B·(L+P), T+n], pos_token_lens, neg_tokens
      [B·NC·K, T+n], neg_token_lens;
    * ``packed_item_tower``: the positives then the negatives packed into
      [C, pack_chunk] chunk rows (packed_tokens, packed_segment_ids,
      packed_positions, emb_slots, n_pos_items), C never below the largest
      C so far, so that steady batches keep one shape;
    * ``dedup_items`` (not packed): each distinct item once, uniq_tokens
      [U, T+n] with U padded to a multiple of ``dedup_bucket_quantum``,
      uniq_token_lens and uniq_inverse, when that is fewer rows than the
      occurrences; else the dense keys.

    None under ``freeze_item_llm``. The token cache is load-only here: the
    corpus pass writes it."""

    def __init__(self, config, dataload):
        if config.get("use_image", False) or config.get("use_video", False):
            raise NotImplementedError("the image and video item keys are not ported yet")
        super().__init__(config, dataload)
        self.freeze_item_llm = bool(config.get("freeze_item_llm", False))
        self.packed_item_tower = bool(config.get("packed_item_tower", False))
        self.dedup_items = bool(config.get("dedup_items", False))
        self.dedup_quantum = int(config.get("dedup_bucket_quantum", 256))
        self.pack_bucket = int(config.get("pack_bucket", 2048))
        self.pack_chunk = int(config.get("pack_chunk", 2048) or 0)
        self._chunk_rows_hw = 0
        self.max_text_length = int(config.get("MAX_TEXT_LENGTH", 64))
        tokenizer = build_tokenizer(config.get("item_pretrain_dir"),
                                    config.get("dummy_vocab_size", 1024))
        self.n_emb = max(int(config.get("item_emb_token_n", 1) or 0), 1)
        self.text_cache = ItemTextCache(
            dataload, tokenizer, config["text_keys"], config.get("item_prompt", ""),
            self.max_text_length, n_emb=self.n_emb,
        )
        cache_dir = token_cache_dir(config)
        if cache_dir is not None:
            # load-only: the batcher touches items lazily, so it never pays
            # for tokenizing the corpus, but uses a cache a corpus pass wrote
            self.text_cache.load_disk_cache(
                cache_dir, str(config.get("dataset") or "ds"), dataload.item_num)

    def make_batch(self, rng, loc_idx):
        batch = super().make_batch(rng, loc_idx)
        if self.freeze_item_llm:
            return batch
        if self.dedup_items and not self.packed_item_tower:
            ids_all = np.concatenate([batch["items"].ravel(), batch["neg_items"].ravel()])
            uniq, inv = np.unique(ids_all, return_inverse=True)
            q = self.dedup_quantum
            bucket = max(q, -(-len(uniq) // q) * q)
            if bucket < len(ids_all):
                uniq_p = np.zeros(bucket, dtype=uniq.dtype)
                uniq_p[: len(uniq)] = uniq
                batch["uniq_tokens"], batch["uniq_token_lens"] = self.text_cache.batch(uniq_p)
                batch["uniq_inverse"] = inv.astype(np.int32)
                return batch
        pos_tokens, pos_lens = self.text_cache.batch(batch["items"].ravel())
        neg_tokens, neg_lens = self.text_cache.batch(batch["neg_items"].ravel())
        if self.packed_item_tower:
            # one device: chunk_round = 1 (see round_chunk_rows)
            packed = pack_items(np.concatenate([pos_tokens, neg_tokens]),
                                np.concatenate([pos_lens, neg_lens]),
                                bucket=self.pack_bucket, n_emb=self.n_emb, chunk=self.pack_chunk,
                                chunk_round=1, min_rows=self._chunk_rows_hw)
            if self.pack_chunk:
                self._chunk_rows_hw = max(self._chunk_rows_hw, packed["packed_tokens"].shape[0])
            batch.update(packed)
            batch["n_pos_items"] = np.asarray(pos_tokens.shape[0], np.int32)
        else:
            batch["pos_tokens"], batch["pos_token_lens"] = pos_tokens, pos_lens
            batch["neg_tokens"], batch["neg_token_lens"] = neg_tokens, neg_lens
        return batch


class BatchTextBatcher:
    """All-items corpus iterator for the item-embedding pass (reference
    BatchTextDataset)."""

    def __init__(self, config, dataload, batch_size: Optional[int] = None):
        if config.get("use_image", False) or config.get("use_video", False):
            raise NotImplementedError("the image and video item keys are not ported yet")
        self.dataload = dataload
        self.max_text_length = int(config.get("MAX_TEXT_LENGTH", 64))
        tokenizer = build_tokenizer(config.get("item_pretrain_dir"),
                                    config.get("dummy_vocab_size", 1024))
        self.n_emb = max(int(config.get("item_emb_token_n", 1) or 0), 1)
        self.text_cache = ItemTextCache(
            dataload, tokenizer, config["text_keys"], config.get("item_prompt", ""),
            self.max_text_length, n_emb=self.n_emb,
        )
        self.batch_size = batch_size or (
            config["MAX_ITEM_LIST_LENGTH"] * config["train_batch_size"])
        self.packed = bool(config.get("packed_corpus_pass", False))
        self.pack_bucket = int(config.get("pack_bucket", 2048))
        self.pack_chunk = int(config.get("pack_chunk", 2048) or 0)
        self._chunk_rows_hw = 0
        cache_dir = token_cache_dir(config)
        if cache_dir is not None:
            # the corpus pass touches every item anyway: tokenize once,
            # persist, and every later process and evaluation starts warm
            self.text_cache.build_disk_cache(
                cache_dir, str(config.get("dataset") or "ds"), dataload.item_num)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        n = self.dataload.item_num
        bs = self.batch_size
        for s in range(0, n, bs):
            ids = np.arange(s, min(s + bs, n))
            n_real = len(ids)
            if n_real < bs:  # the last batch padded with item 0 to the batch size
                ids = np.concatenate([ids, np.zeros(bs - n_real, np.int64)])
            tokens, lens = self.text_cache.batch(ids)
            out = {"item_ids": ids, "n_real": n_real}
            if self.packed:
                # one device on the card: chunk_round = 1 (see round_chunk_rows)
                packed = pack_items(tokens, lens, bucket=self.pack_bucket, n_emb=self.n_emb,
                                    chunk=self.pack_chunk, chunk_round=1,
                                    min_rows=self._chunk_rows_hw)
                if self.pack_chunk:
                    self._chunk_rows_hw = max(self._chunk_rows_hw,
                                              packed["packed_tokens"].shape[0])
                out.update(packed)
            else:
                out["tokens"] = tokens
                out["lens"] = lens
            yield out
