"""Text batching for the HLLM item tower (port of
``mhrec_tpu/data/textset.py``).

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

Under ``use_image`` (or ``use_video``) every item's tokens start with a
``[vision_start][image_pad × n][vision_end]`` span the vision tower splices
over (reference chat-template layout, trainset.py:252-254), and the batches
carry the items' patches from ``data/vision.py``'s stores
(``{pos,neg,uniq}_pixel_patches``; under ``dynamic_image_res`` also the
per-image maps ``patch_valid``, ``patch_hw``, ``img_src``, ``img_pos`` or, for
a LLaVA tower, ``tok_src``). The image path takes the dense item tower.

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
port raises instead of tokenizing differently.
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
    token matrix persisted on disk.

    With ``image_prefix`` set (static image or video grid), every item's
    tokens start with that fixed span and the text budget shrinks by its
    length; with a dynamic ``image_store``, each item's span holds its own
    image-token count."""

    # how many items the content digest samples; the first/last ids and an
    # even stride in between are always included
    _FP_SAMPLE = 4096

    def __init__(self, dataload, tokenizer, text_keys, item_prompt: str,
                 max_text_length: int, n_emb: int = 1,
                 image_prefix: Optional[np.ndarray] = None, image_store=None):
        self.dataload = dataload
        self.tokenizer = tokenizer
        self.text_keys = list(text_keys or ["title", "tag", "description"])
        self.item_prompt = item_prompt or ""
        self.max_text_length = max_text_length
        self.n_emb = max(int(n_emb), 1)  # columns reserved for emb slots
        self.image_prefix = image_prefix
        # dynamic-resolution mode: per-item prefixes [vs][ip × n_i][ve]
        self.image_store = image_store if getattr(image_store, "dynamic", False) else None
        if self.image_store is not None:
            self._img_ids = image_special_ids(tokenizer)
        if image_prefix is not None and len(image_prefix) >= max_text_length:
            raise ValueError("MAX_TEXT_LENGTH too small for the image-pad span; raise it "
                             "or shrink img_height/img_width")
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
            prefix = self.image_prefix
            if self.image_store is not None:
                vs, ip, ve = self._img_ids
                n_i = self.image_store.n_tokens(item_id)
                prefix = np.asarray([vs] + [ip] * n_i + [ve], np.int32)
            budget = self.max_text_length - (0 if prefix is None else len(prefix))
            ids = self.tokenizer.encode(self.render(item_id), budget)
            arr = np.asarray(ids[:budget], dtype=np.int32)
            if prefix is not None:
                arr = np.concatenate([prefix, arr])
            self._cache[item_id] = arr
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
        an evenly strided sample of items, the text settings, the tokenizer
        (its kind and a sha256 of its files' bytes, so that a matrix written
        under one tokenizer is not served under another of the same
        vocabulary size) and, under images, the JAX package's image fields:
        each sampled item's resolved image path and stat (size, mtime), and
        the grid geometry (dyn_kind, min/max pixels, patch size, merge,
        temporal patch, static token count) that sets each item's span.
        A change confined to unsampled items can slip through: delete the
        cache directory after bulk edits."""
        h = hashlib.sha256()
        sample = self._fp_sample_ids(item_num)
        for iid in sample:
            h.update(self.render(iid).encode("utf-8", "replace"))
            h.update(b"\x00")
        img_spec = None
        store = self.image_store
        if store is not None or self.image_prefix is not None:
            stats = []
            if store is not None:
                for iid in sample:
                    p = store.path(iid)
                    if p:
                        try:
                            st = os.stat(p)
                            stats.append((iid, p, st.st_size, int(st.st_mtime)))
                        except OSError:
                            stats.append((iid, p, -1, -1))
                h.update(json.dumps(stats).encode())
                dyn = getattr(store, "dyn", None)
                prep = getattr(store, "prep", None)
                img_spec = dict(
                    dyn_kind=getattr(store, "dyn_kind", None),
                    min_pixels=getattr(dyn, "min_pixels", None),
                    max_pixels=getattr(dyn, "max_pixels", None),
                    anyres_P=getattr(dyn, "P", None),
                    token_cap=getattr(dyn, "token_cap", None),
                    patch_size=getattr(prep, "patch_size", None),
                    merge=getattr(prep, "merge_size", None),
                    tps=getattr(prep, "temporal_patch_size", None),
                    static_n_tokens=getattr(prep, "n_tokens", None),
                )
        spec = dict(
            dataset=dataset_name, item_num=item_num,
            text_keys=self.text_keys, prompt=self.item_prompt,
            T=self.max_text_length, n_emb=self.n_emb,
            vocab=getattr(self.tokenizer, "vocab_size", None),
            tokenizer=getattr(self.tokenizer, "kind", None),
            tokenizer_files=getattr(self.tokenizer, "files_digest", None),
            static_prefix=(None if self.image_prefix is None
                           else self.image_prefix.tolist()),
            images=img_spec, content=h.hexdigest(),
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


def _token_id(tokenizer, content: str) -> Optional[int]:
    """transformers' ``convert_tokens_to_ids`` for one token: its id, else
    the unknown token's id, else None."""
    tid = tokenizer.token_to_id(content)
    if tid is None and getattr(tokenizer, "unk_token", None) is not None:
        tid = tokenizer.token_to_id(tokenizer.unk_token)
    return tid


def image_special_ids(tokenizer):
    """(vision_start, image_pad, vision_end) token ids: the HF tokenizer's,
    else (hashing tokenizer, or one without all three) the top three ids of
    the vocabulary."""
    if isinstance(tokenizer, HFTokenizer):
        trip = [_token_id(tokenizer, t)
                for t in ("<|vision_start|>", "<|image_pad|>", "<|vision_end|>")]
        if all(isinstance(x, int) and x >= 0 for x in trip):
            return tuple(trip)
    V = tokenizer.vocab_size
    return (V - 3, V - 2, V - 1)


def build_image_prefix(tokenizer, n_tokens: int) -> np.ndarray:
    """``[vision_start][image_pad × n][vision_end]`` token ids: the fixed
    span the vision tower splices over (reference chat-template layout)."""
    vs, ip, ve = image_special_ids(tokenizer)
    return np.asarray([vs] + [ip] * n_tokens + [ve], np.int32)


def _setup_image_store(config, dataload, tokenizer):
    """→ (ItemImageStore | ItemVideoStore | None, image_prefix | None).
    Dynamic-resolution images give prefix None: ``ItemTextCache`` builds
    each item's span from the store's per-item token counts. Video is
    always a static grid: a fixed ``[vision_start][pad × grid_t·gh·gw/m²]
    [vision_end]`` span (``<|video_pad|>`` when the tokenizer has it)."""
    from mhrec_tpu_torch.data.vision import ItemImageStore, ItemVideoStore

    if config.get("use_video", False):
        store = ItemVideoStore(config, dataload)
        vs, ip, ve = image_special_ids(tokenizer)
        if isinstance(tokenizer, HFTokenizer):
            vp = _token_id(tokenizer, "<|video_pad|>")
            if isinstance(vp, int) and vp >= 0:
                ip = vp
        return store, np.asarray([vs] + [ip] * store.prep.n_tokens + [ve], np.int32)
    if not config.get("use_image", False):
        return None, None
    store = ItemImageStore(config, dataload)
    if store.dynamic:
        return store, None
    return store, build_image_prefix(tokenizer, store.prep.n_tokens)


def dynamic_image_arrays(ids, image_store, token_width: int) -> Dict[str, np.ndarray]:
    """The host-side dynamic-image maps of a batch of item ids, so the
    device work keeps static shapes (reference: the varlen vision path and
    the per-image ``get_rope_index`` of modeling_qwen2_vl.py):

      img_src [N, T]     j where the position holds the item's j-th image
                         token, else -1: the splice's gather map
      img_pos [N, 3, T]  the (t, h, w) M-RoPE positions of each row (not for
                         a LLaVA tower, whose positions stay sequential)

    with the store's fixed-capacity arrays (patches and valid / hw, or
    tok_src)."""
    out = image_store.dynamic_batch(ids)
    N, T = len(ids), token_width
    s = 1  # span start: position 0 is vision_start
    img_src = np.full((N, T), -1, np.int32)
    if image_store.dyn_kind == "anyres":
        for row in range(N):
            n = int(out["n_tokens"][row])
            img_src[row, s:s + n] = np.arange(n, dtype=np.int32)
        out["img_src"] = img_src
        del out["n_tokens"]
        return out
    m = image_store.dyn.merge_size
    img_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (N, 3, T)).copy()
    for row in range(N):
        n = int(out["n_tokens"][row])
        # the post-merger token grid of this item (hw rows are patch-level)
        gw_m = (int(out["hw"][row, :, 1].max()) + 1) // m if n else 1
        hm = n // max(gw_m, 1)
        j = np.arange(n, dtype=np.int32)
        img_src[row, s:s + n] = j
        img_pos[row, 0, s:s + n] = s
        img_pos[row, 1, s:s + n] = s + j // max(gw_m, 1)
        img_pos[row, 2, s:s + n] = s + j % max(gw_m, 1)
        # text after the span continues at s + max(grid), as the JAX package
        img_pos[row, :, s + n:] = s + max(hm, gw_m) + np.arange(T - (s + n), dtype=np.int32)
    out["img_src"] = img_src
    out["img_pos"] = img_pos
    del out["n_tokens"]
    return out


def _emit_image_keys(batch, prefix: str, ids, tokens, image_store):
    """The image arrays of one item group; dynamic mode adds the validity,
    position and gather-map keys beside the patches."""
    p = f"{prefix}_" if prefix else ""
    if image_store.dynamic:
        arrs = dynamic_image_arrays(ids, image_store, tokens.shape[1])
        batch[f"{p}pixel_patches"] = arrs.pop("patches")
        rename = {"valid": "patch_valid", "hw": "patch_hw"}
        for k, v in arrs.items():  # valid / hw / tok_src / img_src / img_pos
            batch[f"{p}{rename.get(k, k)}"] = v
    else:
        batch[f"{p}pixel_patches"] = image_store.batch(ids)


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
    a batch (JAX ``TextSEQTrainBatcher``, textset.py:425-560). The keys it
    adds:

    * dense: pos_tokens [B·(L+P), T+n], pos_token_lens, neg_tokens
      [B·NC·K, T+n], neg_token_lens;
    * ``packed_item_tower``: the positives then the negatives packed into
      [C, pack_chunk] chunk rows (packed_tokens, packed_segment_ids,
      packed_positions, emb_slots, n_pos_items), C never below the largest
      C so far, so that steady batches keep one shape;
    * ``dedup_items`` (not packed): each distinct item once, uniq_tokens
      [U, T+n] with U padded to a multiple of ``dedup_bucket_quantum``,
      uniq_token_lens and uniq_inverse, when that is fewer rows than the
      occurrences; else the dense keys;
    * ``use_image`` / ``use_video``: the patches of each group
      ({pos,neg,uniq}_pixel_patches) and, under ``dynamic_image_res``, its
      maps (see ``_emit_image_keys``); refused with ``packed_item_tower``.

    None under ``freeze_item_llm``. The token cache is load-only here: the
    corpus pass writes it.

    ``host_id`` / ``num_hosts``: this rank's share of every global batch,
    ``SEQTrainBatcher``'s host-strided rows, and the texts and images of
    exactly those rows' items. Here the port departs from the JAX layout
    of the packed rows: JAX gives every host one worst-case chunk count C
    and shifts each host's ``emb_slots`` into one global array split into
    ``pos_emb_slots`` / ``neg_emb_slots`` (textset.py:517-543), because its
    item tower runs once over the global batch. Each rank here runs the
    item tower on its own chunk rows, packed as one process packs them,
    so it needs neither. The global order that JAX's gather gives still
    holds: a rank's positives stay with its user rows, and the model's
    negative pool is gathered in rank order, [h0-neg, h1-neg, ...]
    (``HLLM.forward``). ``dedup_items`` and the single-stream packing
    (``pack_chunk: 0``) are refused under several hosts, as in JAX."""

    def __init__(self, config, dataload, host_id: int = 0, num_hosts: int = 1):
        super().__init__(config, dataload, host_id=host_id, num_hosts=num_hosts)
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
        self.image_store, image_prefix = _setup_image_store(config, dataload, tokenizer)
        if self.image_store is not None and self.packed_item_tower:
            raise ValueError("use_image is incompatible with packed_item_tower")
        if self.num_hosts > 1 and self.dedup_items:
            # the JAX package's refusals and messages (textset.py:450-463)
            raise ValueError(
                "dedup_items is single-process only; use the dense or "
                "packed item tower under multi-host"
            )
        if self.num_hosts > 1 and self.packed_item_tower \
                and not int(config.get("pack_chunk", 2048) or 0):
            raise ValueError(
                "multi-host packed_item_tower requires chunked packing "
                "(pack_chunk > 0): the legacy flat stream has a per-host "
                "data-dependent length"
            )
        self.n_emb = max(int(config.get("item_emb_token_n", 1) or 0), 1)
        self.text_cache = ItemTextCache(
            dataload, tokenizer, config["text_keys"], config.get("item_prompt", ""),
            self.max_text_length, n_emb=self.n_emb, image_prefix=image_prefix,
            image_store=self.image_store,
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
                tokens, lens = self.text_cache.batch(uniq_p)
                batch["uniq_tokens"], batch["uniq_token_lens"] = tokens, lens
                batch["uniq_inverse"] = inv.astype(np.int32)
                if self.image_store is not None:
                    _emit_image_keys(batch, "uniq", uniq_p, tokens, self.image_store)
                return batch
        pos_tokens, pos_lens = self.text_cache.batch(batch["items"].ravel())
        neg_tokens, neg_lens = self.text_cache.batch(batch["neg_items"].ravel())
        if self.packed_item_tower:
            # one device a rank: chunk_round = 1 (see round_chunk_rows)
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
            if self.image_store is not None:
                _emit_image_keys(batch, "pos", batch["items"].ravel(), pos_tokens,
                                 self.image_store)
                _emit_image_keys(batch, "neg", batch["neg_items"].ravel(), neg_tokens,
                                 self.image_store)
        return batch


class BatchTextBatcher:
    """All-items corpus iterator for the item-embedding pass (reference
    BatchTextDataset)."""

    def __init__(self, config, dataload, batch_size: Optional[int] = None):
        self.dataload = dataload
        self.max_text_length = int(config.get("MAX_TEXT_LENGTH", 64))
        tokenizer = build_tokenizer(config.get("item_pretrain_dir"),
                                    config.get("dummy_vocab_size", 1024))
        self.image_store, image_prefix = _setup_image_store(config, dataload, tokenizer)
        self.n_emb = max(int(config.get("item_emb_token_n", 1) or 0), 1)
        self.text_cache = ItemTextCache(
            dataload, tokenizer, config["text_keys"], config.get("item_prompt", ""),
            self.max_text_length, n_emb=self.n_emb, image_prefix=image_prefix,
            image_store=self.image_store,
        )
        self.batch_size = batch_size or (
            config["MAX_ITEM_LIST_LENGTH"] * config["train_batch_size"])
        # the image spans ride the dense item tower
        self.packed = bool(config.get("packed_corpus_pass", False)) and self.image_store is None
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
                if self.image_store is not None:
                    _emit_image_keys(out, "", ids, tokens, self.image_store)
            yield out
