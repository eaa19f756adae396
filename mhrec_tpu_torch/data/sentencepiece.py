"""SentencePiece ``tokenizer.model`` files in plain Python (the port depends
on none of ``sentencepiece``, ``google.protobuf`` or ``transformers``).

* ``read_model`` parses the ``ModelProto`` by hand (varints,
  length-delimited fields, fixed32 floats; unknown fields are skipped by
  wire type and absent ones take the proto's defaults): the pieces (piece,
  score, type), the trainer spec's ``model_type``, ``byte_fallback``, the
  special ids and ``unk_piece``, and the normalizer spec's ``name``,
  ``precompiled_charsmap``, ``add_dummy_prefix``,
  ``remove_extra_whitespaces`` and ``escape_whitespaces``. A file in
  tiktoken's text format (Llama-3's ``original/tokenizer.model``) is told
  apart by ``is_tiktoken``.
* ``Charsmap`` reads a precompiled charsmap: a little-endian u32 with the
  byte size of a darts-clone double array, the array, then the normalized
  strings, NUL-separated. ``longest`` is sentencepiece's longest-prefix
  lookup and ``shortest`` the first match of ``tokenizers``'
  ``spm_precompiled``.
* ``converted_spec`` builds the ``tokenizer.json`` spec that
  ``transformers`` 4.57's ``LlamaConverter`` / ``GemmaConverter`` build
  from the slow tokenizer (``convert_slow_tokenizer.py``): the vocabulary
  with the slow tokenizer's first tokens, merges ordered by piece score
  (``generate_merges``), byte fallback and ``fuse_unk``, the normalizer or
  the Metaspace pre-tokenizer that ``legacy`` and ``add_prefix_space``
  choose, and the control and user-defined pieces as added tokens. It is
  cached per file digest and settings, so a 32,000-piece model is
  converted once per process.
* ``Processor`` is sentencepiece's own encode (``normalizer.cc``,
  ``bpe_model.cc``, ``unigram_model.cc``): the charsmap, then
  ``remove_extra_whitespaces``, ``add_dummy_prefix`` and
  ``escape_whitespaces``; user-defined pieces split out and frozen; BPE
  merging the pair whose merged piece scores highest (the leftmost among
  equals), UNUSED pieces resegmented; or the Unigram Viterbi in float32
  with its unknown penalty; unknown pieces to ``<unk>``, or to byte pieces
  under ``byte_fallback``.
* ``SlowSpmTokenizer`` wraps it as ``transformers``' slow
  ``PreTrainedTokenizer`` runs the Baichuan / Baichuan2 remote-code class
  (``tokenization_baichuan.BaichuanTokenizer``): added tokens split out
  first (``lstrip`` / ``rstrip`` / ``single_word``), ids from
  ``piece_to_id``, the ``add_bos_token`` / ``add_eos_token`` template, and
  the slow truncation. The directory's Python is never executed.
"""

from __future__ import annotations

import hashlib
import heapq
import re
import struct
from array import array
from typing import Dict, List, Optional, Tuple

# ModelProto.SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
UNIGRAM, BPE = 1, 2

_FLT_MIN = struct.unpack("<f", struct.pack("<I", 0x00800000))[0]
_UNK_PENALTY = 10.0


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


# -- the protobuf wire format ----------------------------------------------------
def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a message: an int for varints and
    fixed32 / fixed64, bytes for length-delimited fields."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            val, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            if pos + size > n:
                raise ValueError("truncated length-delimited field")
            val, pos = buf[pos:pos + size], pos + size
        elif wire == 5:
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            val, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"wire type {wire}")
        if num == 0:
            raise ValueError("field number 0")
        yield num, wire, val


def _int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _float(v: int) -> float:
    return struct.unpack("<f", struct.pack("<I", v & 0xFFFFFFFF))[0]


def _str(v) -> str:
    return v.decode("utf-8")


class Model:
    """What the port reads of a ``ModelProto``."""

    def __init__(self):
        self.pieces: List[Tuple[str, float, int]] = []
        self.model_type = UNIGRAM
        self.byte_fallback = False
        self.treat_whitespace_as_suffix = False
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = 0, 1, 2, -1
        self.unk_piece = "<unk>"
        self.normalizer_name = ""
        self.charsmap = b""
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.escape_whitespaces = True
        self.digest = ""


def _piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, kind = "", 0.0, NORMAL
    for num, wire, v in _fields(buf):
        if num == 1 and wire == 2:
            piece = _str(v)
        elif num == 2 and wire == 5:
            score = _float(v)
        elif num == 3 and wire == 0:
            kind = _int32(v)
    return piece, score, kind


def _trainer_spec(m: Model, buf: bytes):
    for num, wire, v in _fields(buf):
        if wire == 0:
            if num == 3:
                m.model_type = _int32(v)
            elif num == 24:
                m.treat_whitespace_as_suffix = bool(v)
            elif num == 35:
                m.byte_fallback = bool(v)
            elif num in (40, 41, 42, 43):
                setattr(m, {40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}[num],
                        _int32(v))
        elif wire == 2 and num == 45:
            m.unk_piece = _str(v)


def _normalizer_spec(m: Model, buf: bytes):
    for num, wire, v in _fields(buf):
        if wire == 2 and num == 1:
            m.normalizer_name = _str(v)
        elif wire == 2 and num == 2:
            m.charsmap = bytes(v)
        elif wire == 0 and num in (3, 4, 5):
            setattr(m, {3: "add_dummy_prefix", 4: "remove_extra_whitespaces",
                        5: "escape_whitespaces"}[num], bool(v))


def is_tiktoken(data: bytes) -> bool:
    """A tiktoken rank file: lines of ``<base64 token> <rank>``."""
    head = data[:4096].split(b"\n")
    lines = [ln for ln in (head[:-1] if len(head) > 1 else head) if ln.strip()]
    return bool(lines) and all(re.fullmatch(rb"[A-Za-z0-9+/=]+ \d+\r?", ln) for ln in lines)


def parse_model(data: bytes, where: str) -> Model:
    """A ``ModelProto`` from its bytes; ``NotImplementedError`` naming
    ``where`` when they are not one."""
    m = Model()
    try:
        for num, wire, v in _fields(data):
            if wire != 2:
                continue
            if num == 1:
                m.pieces.append(_piece(v))
            elif num == 2:
                _trainer_spec(m, v)
            elif num == 3:
                _normalizer_spec(m, v)
    except (ValueError, UnicodeDecodeError) as e:
        raise NotImplementedError(f"{where}: not a SentencePiece model ({e})") from None
    if not m.pieces:
        raise NotImplementedError(f"{where}: not a SentencePiece model (no pieces)")
    if not any(k == UNKNOWN for _, _, k in m.pieces):
        raise NotImplementedError(f"{where}: SentencePiece model without an unknown piece")
    m.digest = hashlib.sha256(data).hexdigest()
    return m


def read_model(path: str) -> Model:
    with open(path, "rb") as fh:
        data = fh.read()
    if is_tiktoken(data):
        raise NotImplementedError(f"{path}: a tiktoken rank file, not a SentencePiece model")
    return parse_model(data, path)


# -- the precompiled charsmap ----------------------------------------------------
class Charsmap:
    """A darts-clone double array over UTF-8 keys, values pointing into the
    NUL-separated normalized strings."""

    def __init__(self, blob: bytes, where: str):
        if len(blob) < 4:
            raise NotImplementedError(f"{where}: precompiled charsmap of {len(blob)} bytes")
        size = int.from_bytes(blob[:4], "little")
        if size % 4 or 4 + size > len(blob):
            raise NotImplementedError(f"{where}: precompiled charsmap with a trie of {size} "
                                      f"bytes in {len(blob)}")
        units = array("I")
        units.frombytes(blob[4:4 + size])
        if units.itemsize != 4:
            raise NotImplementedError("array('I') is not 32-bit here")
        import sys
        if sys.byteorder != "little":
            units.byteswap()
        self.units = units
        self.strings = blob[4 + size:]
        try:
            self.strings.decode("utf-8")
        except UnicodeDecodeError:
            raise NotImplementedError(f"{where}: precompiled charsmap strings are not UTF-8") \
                from None
        self.removes = any(self.value(v) == b"" for _, v in self._all_values())
        self._shortest: Dict[str, Optional[str]] = {}
        self._starts: Dict[str, bool] = {}

    def _all_values(self):
        u = self.units
        for pos in range(len(u)):
            if u[pos] >> 31:
                yield pos, u[pos] & 0x7FFFFFFF

    def value(self, v: int) -> bytes:
        end = self.strings.find(b"\x00", v)
        return self.strings[v:end if end >= 0 else len(self.strings)]

    def prefixes(self, key: bytes, start: int = 0) -> List[Tuple[int, int]]:
        """(length, value) of every key that prefixes ``key[start:]``,
        shortest first (darts-clone's commonPrefixSearch)."""
        u, out = self.units, []
        n = len(u)
        unit = u[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for i in range(start, len(key)):
            c = key[i]
            pos ^= c
            if pos >= n:
                break
            unit = u[pos]
            if (unit & ((1 << 31) | 0xFF)) != c:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append((i + 1 - start, u[pos] & 0x7FFFFFFF))
        return out

    def starts(self, ch: str) -> bool:
        """Whether some key starts with ``ch``."""
        hit = self._starts.get(ch)
        if hit is None:
            u, n = self.units, len(self.units)
            pos = (u[0] >> 10) << ((u[0] & (1 << 9)) >> 6)
            hit = True
            for c in ch.encode("utf-8"):
                pos ^= c
                if pos >= n or (u[pos] & ((1 << 31) | 0xFF)) != c:
                    hit = False
                    break
                pos ^= (u[pos] >> 10) << ((u[pos] & (1 << 9)) >> 6)
            self._starts[ch] = hit
        return hit

    def longest(self, key: bytes, start: int) -> Optional[Tuple[int, bytes]]:
        """sentencepiece's rule: the longest key at ``start``."""
        found = self.prefixes(key, start)
        if not found:
            return None
        length, v = found[-1]
        return length, self.value(v)

    def shortest(self, text: str) -> Optional[str]:
        """``spm_precompiled``'s transform: the normalized string of the
        first (shortest) key that prefixes ``text``."""
        if text in self._shortest:
            return self._shortest[text]
        found = self.prefixes(text.encode("utf-8"))
        out = self.value(found[0][1]).decode("utf-8") if found else None
        if len(self._shortest) < 1_000_000:
            self._shortest[text] = out
        return out


# -- the Llama / Gemma conversion (transformers 4.57) ----------------------------
def generate_merges(vocab: Dict[str, int], vocab_scores: Dict[str, float]):
    """``convert_slow_tokenizer.generate_merges`` with ``vocab_scores``: every
    split of every piece into two pieces of ``vocab``, ordered by the piece's
    score (highest first), then the left and right lengths (longest first),
    then the pieces' ids."""
    merges = []
    for merge, score in vocab_scores.items():
        local = []
        for i in range(1, len(merge)):
            left, right = merge[:i], merge[i:]
            if left in vocab and right in vocab:
                local.append((left, right, score))
        local.sort(key=lambda x: (vocab[x[0]], vocab[x[1]]))
        merges.extend(local)
    merges.sort(key=lambda v: (v[2], len(v[0]), len(v[1])), reverse=True)
    return [[a, b] for a, b, _ in merges]


_SPEC_CACHE: Dict[tuple, dict] = {}


def converted_spec(model: Model, family: str, first_tokens: Tuple[str, str, str],
                   legacy: bool = True, add_prefix_space=True) -> dict:
    """The ``tokenizer.json`` spec of ``LlamaConverter`` (``family``
    ``"llama"``) or ``GemmaConverter`` (``"gemma"``). ``first_tokens`` are
    the slow tokenizer's tokens for ids 0-2 (Llama: ``convert_ids_to_tokens``;
    Gemma: its pad, eos and bos tokens). Returns a fresh copy of a spec
    cached per (file digest, settings)."""
    key = (model.digest, family, tuple(first_tokens), bool(legacy), add_prefix_space)
    spec = _SPEC_CACHE.get(key)
    if spec is None:
        spec = _SPEC_CACHE[key] = _convert(model, family, first_tokens, legacy, add_prefix_space)
    out = dict(spec)
    out["model"] = dict(spec["model"])
    out["added_tokens"] = [dict(t) for t in spec["added_tokens"]]
    return out


def _convert(model: Model, family: str, first_tokens, legacy, add_prefix_space) -> dict:
    pieces = model.pieces
    vocab_scores = [(t, 0.0) for t in first_tokens] + [(p, s) for p, s, _ in pieces[3:]]
    specials = set()
    if family == "gemma":
        specials = {"<start_of_turn>", "<end_of_turn>"}
        if not any(p == "\t" for p, _ in vocab_scores):
            for i, (p, _) in enumerate(vocab_scores):
                if p == "<0x09>":
                    vocab_scores[i] = ("\t", 0.0)
                    break
    if model.model_type == BPE:
        sp_vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
        if family == "gemma" and "\t" not in sp_vocab:
            sp_vocab["\t"] = sp_vocab.get("<0x09>")
        merges = generate_merges(sp_vocab, dict(vocab_scores))
        spec_model = {"type": "BPE", "dropout": None, "unk_token": model.unk_piece,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": {w: i for i, (w, _) in enumerate(vocab_scores)},
                      "merges": merges}
    elif model.model_type == UNIGRAM:
        spec_model = {"type": "Unigram", "unk_id": 3 if family == "gemma" else 0,
                      "vocab": [[w, s] for w, s in vocab_scores], "byte_fallback": True}
    else:
        raise NotImplementedError(f"SentencePiece model_type {model.model_type} (a "
                                  "Unigram or BPE model is converted)")
    added = [{"id": None, "content": p, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False,
              "special": kind == CONTROL or p in specials}
             for p, _, kind in pieces if kind in (CONTROL, USER_DEFINED)]
    if family == "gemma":
        normalizer = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
        pre = {"type": "Split", "pattern": {"String": " "}, "behavior": "MergedWithPrevious",
               "invert": False}
    elif legacy:
        seq = [{"type": "Prepend", "prepend": "▁"}] if add_prefix_space else []
        seq.append({"type": "Replace", "pattern": {"String": " "}, "content": "▁"})
        normalizer, pre = {"type": "Sequence", "normalizers": seq}, None
    else:
        normalizer = None
        pre = {"type": "Metaspace", "replacement": "▁", "split": False,
               "prepend_scheme": "first" if add_prefix_space else "never"}
    return {"model": spec_model, "normalizer": normalizer, "pre_tokenizer": pre,
            "post_processor": None, "added_tokens": added}


# -- sentencepiece's own encode ----------------------------------------------------
class Processor:
    """``SentencePieceProcessor.encode`` of a BPE or Unigram model."""

    def __init__(self, model: Model, where: str):
        if model.model_type not in (BPE, UNIGRAM):
            raise NotImplementedError(f"{where}: SentencePiece model_type {model.model_type}")
        self.model = model
        self.pieces: Dict[str, int] = {}     # NORMAL, USER_DEFINED, UNUSED
        self.reserved: Dict[str, int] = {}   # CONTROL, UNKNOWN, BYTE
        self.kinds = [k for _, _, k in model.pieces]
        self.scores = [s for _, s, _ in model.pieces]
        user = []
        self.unk_id = -1
        for i, (p, _, kind) in enumerate(model.pieces):
            target = self.pieces if kind in (NORMAL, USER_DEFINED, UNUSED) else self.reserved
            if p in target:
                raise NotImplementedError(f"{where}: piece {p!r} is defined twice")
            target[p] = i
            if kind == USER_DEFINED:
                user.append(p)
            if kind == UNKNOWN:
                if self.unk_id >= 0:
                    raise NotImplementedError(f"{where}: two unknown pieces")
                self.unk_id = i
        # the longest user-defined piece first: over the text, and over its
        # UTF-8 in the normalizer
        user.sort(key=len, reverse=True)
        self.user_rx = re.compile("|".join(map(re.escape, user))) if user else None
        self._user_brx = (re.compile(b"|".join(re.escape(p.encode("utf-8")) for p in user))
                          if user else None)
        self.charsmap = Charsmap(model.charsmap, where) if model.charsmap else None
        self.max_len = max((len(p) for p in self.pieces), default=1)
        if model.model_type == UNIGRAM:
            normal = [s for _, s, k in model.pieces if k == NORMAL]
            lo = min(normal, default=float("inf"))
            hi = max([_FLT_MIN] + normal)
            self.min_score = 0.0 if lo == float("inf") else lo
            self.max_score = 0.0 if hi == _FLT_MIN else hi
        # as HFTokenizer's word split: no merge crosses the start of a ▁-run
        # when no piece holds ▁ after another character, and no unknown
        # piece joins across it when ▁ is a piece
        self._words = None
        if (model.model_type == BPE and model.escape_whitespaces and "▁" in self.pieces
                and not model.treat_whitespace_as_suffix
                and not any(map(re.compile("[^▁]▁").search, self.pieces))):
            self._words = re.compile("(?<=[^▁])(?=▁)")
        self._cache: Dict[str, List[Tuple[str, int]]] = {}

    def piece_to_id(self, piece: str) -> int:
        i = self.reserved.get(piece)
        if i is None:
            i = self.pieces.get(piece, self.unk_id)
        return i

    # -- normalizer.cc -----------------------------------------------------------
    def normalize(self, text: str) -> str:
        m = self.model
        if self.charsmap is None and self.user_rx is None:
            s = text
            if m.remove_extra_whitespaces:
                s = re.sub(" +", " ", s).strip(" ")
            if not s:
                return ""
            if m.add_dummy_prefix:
                s = s + " " if m.treat_whitespace_as_suffix else " " + s
            return s.replace(" ", "▁") if m.escape_whitespaces else s
        return self._normalize_bytes(text.encode("utf-8")).decode("utf-8")

    def _prefix(self, data: bytes, pos: int) -> Tuple[bytes, int]:
        """NormalizePrefix: (normalized bytes, bytes consumed) at ``pos``."""
        if self._user_brx is not None:
            hit = self._user_brx.match(data, pos)
            if hit:
                return hit.group(), hit.end() - pos
        if self.charsmap is not None:
            hit = self.charsmap.longest(data, pos)
            if hit is not None:
                return hit[1], hit[0]
        b = data[pos]
        n = 1 if b < 0x80 else 2 if b < 0xE0 else 3 if b < 0xF0 else 4
        return data[pos:pos + n], n

    def _normalize_bytes(self, data: bytes) -> bytes:
        m = self.model
        space = "▁".encode("utf-8") if m.escape_whitespaces else b" "
        pos, n = 0, len(data)
        if m.remove_extra_whitespaces:
            while pos < n:
                sp, used = self._prefix(data, pos)
                if sp != b" ":
                    break
                pos += used
        if pos >= n:
            return b""
        out = bytearray()
        if m.add_dummy_prefix and not m.treat_whitespace_as_suffix:
            out += space
        prev_space = m.remove_extra_whitespaces
        while pos < n:
            sp, used = self._prefix(data, pos)
            while prev_space and sp.startswith(b" "):
                sp = sp[1:]
            if sp:
                out += sp.replace(b" ", space) if m.escape_whitespaces else sp
                prev_space = sp.endswith(b" ")
            pos += used
            if not m.remove_extra_whitespaces:
                prev_space = False
        if m.remove_extra_whitespaces:
            while out.endswith(space):
                del out[len(out) - len(space):]
        if m.add_dummy_prefix and m.treat_whitespace_as_suffix:
            out += space
        return bytes(out)

    # -- the models --------------------------------------------------------------
    def encode(self, text: str) -> List[Tuple[str, int]]:
        """(piece, id) pairs of ``sp.encode(text, out_type=str)`` and
        ``sp.encode(text)``."""
        norm = self.normalize(text)
        if not norm:
            return []
        if self._words is None:
            return self._encode_normalized(norm)
        out: List[Tuple[str, int]] = []
        for w in self._words.split(norm):
            got = self._cache.get(w)
            if got is None:
                got = self._encode_normalized(w)
                if len(self._cache) >= 1_000_000:
                    self._cache.clear()
                self._cache[w] = got
            out.extend(got)
        return out

    def _encode_normalized(self, norm: str) -> List[Tuple[str, int]]:
        result = self._bpe(norm) if self.model.model_type == BPE else self._unigram(norm)
        out = []
        # consecutive unknown pieces are one unknown piece
        merged: List[Tuple[str, int]] = []
        for w, i in result:
            if i == self.unk_id and merged and merged[-1][1] == self.unk_id:
                merged[-1] = (merged[-1][0] + w, i)
            else:
                merged.append((w, i))
        for w, i in merged:  # PopulateSentencePieceText
            if i == self.unk_id and self.model.byte_fallback:
                for b in w.encode("utf-8"):
                    piece = f"<0x{b:02X}>"
                    out.append((piece, self.piece_to_id(piece)))
            else:
                out.append((w, i))
        return out

    def _symbols(self, s: str) -> List[Tuple[str, bool]]:
        """(symbol, frozen): user-defined pieces, else single characters."""
        if self.user_rx is None:
            return [(ch, False) for ch in s]
        out, pos = [], 0
        while pos < len(s):
            m = self.user_rx.match(s, pos)
            if m:
                out.append((m.group(), True))
                pos = m.end()
            else:
                out.append((s[pos], False))
                pos += 1
        return out

    def _bpe(self, s: str) -> List[Tuple[str, int]]:
        syms = self._symbols(s)
        piece = [p for p, _ in syms]
        frozen = [f for _, f in syms]
        n = len(piece)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        heap: list = []
        rev: Dict[str, Tuple[str, str]] = {}
        pieces, kinds, scores = self.pieces, self.kinds, self.scores

        def add(left, right):
            if left == -1 or right == -1 or frozen[left] or frozen[right]:
                return
            merged = piece[left] + piece[right]
            pid = pieces.get(merged)
            if pid is None:
                return
            heapq.heappush(heap, (-scores[pid], left, right, len(merged)))
            if kinds[pid] == UNUSED:
                rev[merged] = (piece[left], piece[right])

        for i in range(1, n):
            add(i - 1, i)
        while heap:
            _, left, right, size = heapq.heappop(heap)
            if not piece[left] or not piece[right] or len(piece[left]) + len(piece[right]) != size:
                continue
            piece[left] += piece[right]
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            piece[right] = ""
            add(prev[left], left)
            add(left, nxt[left])

        out: List[Tuple[str, int]] = []

        def resegment(w):
            pid = self.piece_to_id(w)
            if pid == -1 or kinds[pid] != UNUSED or w not in rev:
                out.append((w, pid))
                return
            resegment(rev[w][0])
            resegment(rev[w][1])

        i = 0
        while i != -1:
            resegment(piece[i])
            i = nxt[i]
        return out

    def _unigram(self, s: str) -> List[Tuple[str, int]]:
        n = len(s)
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        pieces, kinds, scores = self.pieces, self.kinds, self.scores
        unk_score = _f32(self.min_score - _UNK_PENALTY)
        for a in range(n):
            till = best[a]
            single = False
            for b in range(a + 1, min(n, a + self.max_len) + 1):
                pid = pieces.get(s[a:b])
                if pid is None or kinds[pid] == UNUSED:
                    continue
                # a double: the user-defined bonus (length · max_score − 0.1)
                # makes both branches double in unigram_model.cc
                if kinds[pid] == USER_DEFINED:
                    cand = (_f32(len(s[a:b].encode("utf-8")) * self.max_score) - 0.1) + till
                else:
                    cand = scores[pid] + till
                if start[b] == -1 or cand > best[b]:
                    best[b], start[b], ids[b] = _f32(cand), a, pid
                if b == a + 1:
                    single = True
            if not single:
                cand = _f32(unk_score + till)  # float + float
                if start[a + 1] == -1 or cand > best[a + 1]:
                    best[a + 1], start[a + 1], ids[a + 1] = cand, a, self.unk_id
        out = []
        end = n
        while end > 0:
            a = start[end]
            out.append((s[a:end], ids[end]))
            end = a
        out.reverse()
        return out


# -- the slow PreTrainedTokenizer around it (BaichuanTokenizer) ----------------------
class SlowAddedToken:
    __slots__ = ("content", "lstrip", "rstrip", "single_word")

    def __init__(self, content, lstrip=False, rstrip=False, single_word=False):
        self.content, self.lstrip, self.rstrip = content, bool(lstrip), bool(rstrip)
        self.single_word = bool(single_word)


class SlowSpmTokenizer:
    """``transformers``' slow ``PreTrainedTokenizer.encode(text,
    truncation=True, max_length=n)`` over ``Processor``, as the Baichuan
    classes define it (``_tokenize``: ``sp_model.encode(text,
    out_type=str)``; ``_convert_token_to_id``: ``piece_to_id``;
    ``build_inputs_with_special_tokens``: BOS / EOS by ``add_bos_token`` /
    ``add_eos_token``)."""

    kind = "spm"
    files_digest: Optional[str] = None

    def __init__(self, proc: Processor, added: Dict[str, Tuple[int, SlowAddedToken]],
                 before: List[int], after: List[int], unk_token: Optional[str] = None,
                 truncation_side: str = "right"):
        self.proc = proc
        self.vocab_size = len(proc.model.pieces)
        self.added = added
        self.before, self.after = before, after
        self.unk_token = unk_token
        self.truncation_side = truncation_side
        keys = sorted((k for k in added if k), key=len, reverse=True)
        self.added_rx = re.compile("|".join(map(re.escape, keys))) if keys else None

    def token_to_id(self, content: str) -> Optional[int]:
        """``convert_tokens_to_ids`` without the unknown fallback."""
        if content in self.added:
            return self.added[content][0]
        pid = self.proc.piece_to_id(content)
        return None if pid == self.proc.unk_id and content != self.proc.model.pieces[
            self.proc.unk_id][0] else pid

    def _split(self, text: str) -> List[str]:
        """``Trie.split``: the added tokens, leftmost and longest first."""
        if self.added_rx is None:
            return [text]
        out, last = [], 0
        for m in self.added_rx.finditer(text):
            if m.start() > last:
                out.append(text[last:m.start()])
            out.append(m.group())
            last = m.end()
        if last < len(text):
            out.append(text[last:])
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        tokens = self._split(text)
        for i, tok in enumerate(tokens):
            if tok not in self.added:
                continue
            ext = self.added[tok][1]
            left = tokens[i - 1] if i > 0 else None
            right = tokens[i + 1] if i < len(tokens) - 1 else None
            if ext.rstrip and right:
                tokens[i + 1] = right.lstrip()
            if ext.lstrip and left:
                tokens[i - 1] = left.rstrip()
            if ext.single_word and left and left[-1] != " ":
                tokens[i - 1] += tok
                tokens[i] = ""
            elif ext.single_word and right and right[0] != " ":
                tokens[i + 1] = tok + right
                tokens[i] = ""
        ids: List[int] = []
        for tok in tokens:
            if not tok:
                continue
            if tok in self.added:
                ids.append(self.added[tok][0])
                continue
            for piece, pid in self.proc.encode(tok):
                hit = self.added.get(piece)
                ids.append(hit[0] if hit is not None else pid)
        return ids

    def encode(self, text: str, max_length: int) -> List[int]:
        ids = self.tokenize_ids(text)
        remove = len(ids) + len(self.before) + len(self.after) - max_length
        if remove > 0 and len(ids) > remove:  # else transformers logs and keeps all
            ids = ids[remove:] if self.truncation_side == "left" else ids[:-remove]
        return self.before + ids + self.after
