"""The port's SentencePiece readers (``mhrec_tpu_torch/data/sentencepiece.py``
and the ``tokenizer.model`` paths of ``data/hf_tokenizer.py``) against
``transformers`` and ``tokenizers``, on the CPU without ``sentencepiece``.

The ``tokenizer.model`` files are written from a seed by
``chip_smoke.spm_model_bytes`` (a protobuf writer by hand, held here to the
``ModelProto`` that ``transformers``' protobuf module parses): the pieces of
a BPE or Unigram that ``tokenizers`` trains on the seeded corpus, with
Llama's <unk> <s> </s> and byte pieces, or Gemma's <pad> <eos> <bos> <unk>.

* **The Llama / Gemma conversion** (a directory with ``tokenizer.model``
  and no ``tokenizer.json``; a Llama config's ``add_prefix_space`` beside a
  ``tokenizer.json``) is held to ``transformers``' own ``LlamaConverter`` /
  ``GemmaConverter`` wrapped in ``LlamaTokenizerFast`` /
  ``GemmaTokenizerFast`` with the directory's config, in the JAX package's
  ``_HFTokenizerWrapper``. The converters read the pieces through
  ``SentencePieceExtractor``, which needs ``sentencepiece``: the tests give
  it a stub that lists the pieces of the protobuf-parsed model (its
  ``extract`` and ``generate_merges`` stay ``transformers``' own), and the
  slow tokenizer they are handed carries what ``LlamaTokenizer.__init__``
  would set (``legacy``, ``add_prefix_space``, ``convert_ids_to_tokens``,
  the special tokens).
* **Baichuan's remote-code tokenizer** (``auto_map`` →
  ``tokenization_baichuan.BaichuanTokenizer``) goes through the JAX
  package's ``build_tokenizer`` itself: the test writes a
  ``tokenization_baichuan.py`` of Baichuan2's class into the directory, its
  ``sp_model`` the port's ``Processor``, so that ``transformers``' slow
  ``PreTrainedTokenizer`` (the added-token trie, ``lstrip`` / ``rstrip`` /
  ``single_word``, the template, the truncation) is the oracle of the
  port's wrapper. ``tests/test_torch_cuda.py`` holds ``Processor`` to
  ``sentencepiece`` on the card's machine; here hand-worked cases hold it to
  the rules of ``bpe_model.cc``, ``unigram_model.cc`` and
  ``normalizer.cc``.
* **The Precompiled charsmap** is held to
  ``tokenizers.normalizers.Precompiled`` on a blob written by a small
  double-array writer, at every key between neighbours that join
  graphemes or not, and on random strings of those characters.

Ids are integers, so the tolerance is exact equality.
"""

import base64
import json
import os
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_tokenizer import (CHARSMAP, LENGTHS, _write_config, charsmap_blob,
                                  make_corpus, make_texts)
from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers
from transformers import GemmaTokenizerFast, LlamaTokenizerFast
import importlib

import chip_smoke
from mhrec_tpu.data.textset import HashTokenizer as JaxHashTokenizer
from mhrec_tpu.data.textset import _HFTokenizerWrapper
from mhrec_tpu.data.textset import build_tokenizer as jax_build_tokenizer
from mhrec_tpu_torch.data import hf_tokenizer, sentencepiece
from mhrec_tpu_torch.data.textset import HashTokenizer, build_tokenizer

# the module (transformers' top level also exports a function of that name)
cst = importlib.import_module("transformers.convert_slow_tokenizer")
PB = cst.import_protobuf()
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
BYTES = [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]


# -- models written from a seed ------------------------------------------------
def _learned(kind="bpe", size=300):
    """(piece, score) that tokenizers learns on the seeded corpus, ▁-led as
    SentencePiece's; BPE pieces scored by merge rank."""
    if kind == "bpe":
        tok = Tokenizer(models.BPE())
        trainer = trainers.BpeTrainer(vocab_size=size, show_progress=False,
                                      initial_alphabet=list("▁abcdefghijklmnopqrstuvwxyz"))
    else:
        tok = Tokenizer(models.Unigram())
        trainer = trainers.UnigramTrainer(vocab_size=size, show_progress=False,
                                          special_tokens=["<unk>"], unk_token="<unk>")
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always")
    tok.train_from_iterator(make_corpus(), trainer)
    spec = json.loads(tok.to_str())["model"]
    if kind == "bpe":
        order = sorted(spec["vocab"], key=spec["vocab"].get)
        return [(t, -float(i)) for i, t in enumerate(order)]
    return [(t, float(s)) for t, s in spec["vocab"] if t != "<unk>"]


def llama_pieces(kind="bpe", user=(), unused=()):
    """Llama's layout: <unk> <s> </s>, the byte pieces, the learned pieces
    (``user`` as user-defined pieces, ``unused`` marked unused)."""
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)] + BYTES
    pieces += [(u, 0.0, USER_DEFINED) for u in user]
    pieces += [(t, s, UNUSED if t in unused else NORMAL) for t, s in _learned(kind)]
    return pieces


def gemma_pieces():
    """Gemma's layout: <pad> <eos> <bos> <unk>, two turn markers, the byte
    pieces (``<0x09>`` stands for the missing tab), the learned pieces."""
    pieces = [("<pad>", 0.0, CONTROL), ("<eos>", 0.0, CONTROL), ("<bos>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN), ("<start_of_turn>", 0.0, USER_DEFINED),
              ("<end_of_turn>", 0.0, USER_DEFINED)] + BYTES
    return pieces + [(t, s, NORMAL) for t, s in _learned("bpe")]


def write_spm_dir(d, pieces, tcfg=None, model_type=2, model_kind="llama", **model_kw):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.model"), "wb") as fh:
        fh.write(chip_smoke.spm_model_bytes(pieces, model_type=model_type, **model_kw))
    _write_config(d, model_kind, 1024)
    if tcfg is not None:
        with open(os.path.join(d, "tokenizer_config.json"), "w") as fh:
            json.dump(tcfg, fh)
    return d


# -- the converter oracle ----------------------------------------------------------
def _proto(path):
    m = PB.ModelProto()
    with open(path, "rb") as fh:
        m.ParseFromString(fh.read())
    return m


def oracle(d, family="llama"):
    """transformers' LlamaConverter / GemmaConverter over the directory's
    tokenizer.model (the extractor given the protobuf-parsed pieces), in the
    fast class with the directory's config, in the JAX package's wrapper."""
    path = os.path.join(d, "tokenizer.model")
    proto = _proto(path)
    pieces = [p.piece for p in proto.pieces]
    tcfg_path = os.path.join(d, "tokenizer_config.json")
    tcfg = json.load(open(tcfg_path)) if os.path.exists(tcfg_path) else {}

    def extractor_init(self, model):
        self.sp = types.SimpleNamespace(GetPieceSize=lambda: len(pieces),
                                        id_to_piece=lambda i: pieces[i])

    legacy = tcfg.get("legacy")
    slow = types.SimpleNamespace(
        vocab_file=path, legacy=True if legacy is None else legacy,
        add_prefix_space=tcfg.get("add_prefix_space", True),
        convert_ids_to_tokens=lambda i: pieces[i],
        pad_token="<pad>", eos_token="<eos>", bos_token="<bos>")
    orig = cst.SentencePieceExtractor.__init__
    cst.SentencePieceExtractor.__init__ = extractor_init
    try:
        conv = cst.GemmaConverter if family == "gemma" else cst.LlamaConverter
        obj = conv(slow).converted()
    finally:
        cst.SentencePieceExtractor.__init__ = orig
    kw = {k: tcfg[k] for k in ("add_bos_token", "add_eos_token", "legacy", "bos_token",
                               "eos_token", "unk_token") if k in tcfg}
    cls = GemmaTokenizerFast if family == "gemma" else LlamaTokenizerFast
    return _HFTokenizerWrapper(cls(tokenizer_object=obj, **kw))


def _tokenizer_json_dir(d):
    """A Llama tokenizer.json directory (chip_smoke's TinyLlama layout)."""
    os.makedirs(d, exist_ok=True)
    chip_smoke.write_llama_tokenizer(d, make_corpus(), 600)
    return d


SPM_DIRS = {
    "llama": lambda d: write_spm_dir(d, llama_pieces()),
    "llama_legacy_false": lambda d: write_spm_dir(d, llama_pieces(), {"legacy": False}),
    "llama_no_prefix_space_legacy": lambda d: write_spm_dir(
        d, llama_pieces(), {"legacy": True, "add_prefix_space": False}),
    "llama_no_prefix_space_metaspace": lambda d: write_spm_dir(
        d, llama_pieces(), {"legacy": False, "add_prefix_space": False}),
    "llama_bos_eos": lambda d: write_spm_dir(d, llama_pieces(), {"add_eos_token": True}),
    "llama_no_bos": lambda d: write_spm_dir(
        d, llama_pieces(), {"add_bos_token": False, "legacy": False}),
    "llama_user_defined": lambda d: write_spm_dir(
        d, llama_pieces(user=("<sep>", "hello world"))),
    "llama_unigram": lambda d: write_spm_dir(d, llama_pieces("unigram"), model_type=1),
    "gemma": lambda d: write_spm_dir(d, gemma_pieces(), model_kind="gemma"),
    # add_prefix_space rebuilds the tokenizer from tokenizer.model beside a
    # tokenizer.json (from_slow)
    "llama_add_prefix_space_rebuild": lambda d: write_spm_dir(
        _tokenizer_json_dir(d), llama_pieces(),
        {"tokenizer_class": "LlamaTokenizer", "add_prefix_space": False, "legacy": False}),
}


@pytest.fixture(scope="module")
def spm_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spm")
    return {name: make(str(root / name)) for name, make in SPM_DIRS.items()}


def _pair(d, family="llama"):
    ref, ours = oracle(d, family), build_tokenizer(d, 1024)
    assert ours.kind == ("hf:GemmaTokenizerFast" if family == "gemma"
                         else "hf:LlamaTokenizerFast")
    return ref, ours


@pytest.mark.parametrize("name", list(SPM_DIRS))
def test_tokenizer_model_matches_the_converter(spm_dirs, name):
    """Every seeded text at every length, id for id."""
    ref, ours = _pair(spm_dirs[name], "gemma" if name == "gemma" else "llama")
    assert ours.vocab_size == ref.vocab_size
    for text in make_texts():
        for n in LENGTHS:
            assert ours.encode(text, n) == ref.encode(text, n), (name, text, n)


@pytest.mark.parametrize("name", ["llama", "gemma"])
def test_tokenizer_model_matches_the_converter_on_random_unicode(spm_dirs, name):
    ref, ours = _pair(spm_dirs[name], name)

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(st.text(max_size=40))
    def check(text):
        for n in (5, 256):
            assert ours.encode(text, n) == ref.encode(text, n), (name, text, n)

    check()


def test_conversion_is_cached_per_file(spm_dirs, tmp_path):
    """The converted spec is built once per file digest and settings: a
    second load reuses it, a changed file does not."""
    sentencepiece._SPEC_CACHE.clear()
    build_tokenizer(spm_dirs["llama"], 1024)
    assert len(sentencepiece._SPEC_CACHE) == 1
    build_tokenizer(spm_dirs["llama"], 1024)
    assert len(sentencepiece._SPEC_CACHE) == 1
    build_tokenizer(spm_dirs["llama_legacy_false"], 1024)  # the same file, legacy false
    assert len(sentencepiece._SPEC_CACHE) == 2
    other = write_spm_dir(str(tmp_path / "other"), llama_pieces()[:-1])
    build_tokenizer(other, 1024)
    assert len(sentencepiece._SPEC_CACHE) == 3


# -- what the port refused before, now read ------------------------------------------
def _formerly_refused(case, d):
    """The cases the refusal test once held, each as a directory the port
    now reads: (the directory, the oracle)."""
    from test_torch_tokenizer import (precompiled_blob, write_qwen2, write_tiktoken,
                                      write_unigram, write_wordlevel)

    if case == "tokenizer_model":
        return oracle(write_spm_dir(d, llama_pieces())), d
    if case == "tiktoken":
        write_tiktoken(d)
    elif case == "vocab_json_merges":
        os.remove(os.path.join(write_qwen2(d), "tokenizer.json"))
    elif case == "unigram":
        write_unigram(d)
    elif case == "wordlevel":
        write_wordlevel(d)
    else:  # the Precompiled normalizer
        write_unigram(d, precompiled=precompiled_blob())
    ref = jax_build_tokenizer(d, 1024)
    assert not isinstance(ref, JaxHashTokenizer), "the oracle fell back to hashing"
    return ref, d


@pytest.mark.parametrize("case", ["tokenizer_model", "tiktoken", "vocab_json_merges",
                                  "unigram", "wordlevel", "unknown_normalizer"])
def test_what_the_port_refused_now_matches(case, tmp_path):
    """tests/test_torch_tokenizer.py's refusal test held these 6 cases to a
    NotImplementedError until the port read them: each is now held to its
    oracle (transformers' LlamaConverter, or the JAX package's
    build_tokenizer), id for id."""
    ref, d = _formerly_refused(case, str(tmp_path / case))
    ours = build_tokenizer(d, 1024)
    assert not isinstance(ours, HashTokenizer) and ours.vocab_size == ref.vocab_size
    for text in make_texts(seed=5):
        for n in LENGTHS:
            assert ours.encode(text, n) == ref.encode(text, n), (case, text, n)


def test_token_cache_key_names_the_tokenizer_model(tmp_path):
    """A corpus token matrix written under one tokenizer.model is not served
    once the file changes (one piece's score: the same vocabulary size); a
    repeat with the same file hits."""
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.data.textset import ItemTextCache

    data = InMemoryInteractionData(num_users=4, num_items=50, seq_len=8, seed=0,
                                   item_texts=True, max_filler_words=8)
    pieces = llama_pieces()
    d = write_spm_dir(str(tmp_path / "tower"), pieces)
    cache_dir = str(tmp_path / "cache")

    def cache():
        return ItemTextCache(data, build_tokenizer(d, 1024), ["title", "description"], "", 24)

    first = cache()
    assert first.tokenizer.kind == "hf:LlamaTokenizerFast"
    first.build_disk_cache(cache_dir, "ds", 50)
    assert cache().load_disk_cache(cache_dir, "ds", 50)
    piece, score, kind = pieces[-1]
    write_spm_dir(d, pieces[:-1] + [(piece, score - 1.0, kind)])
    changed = cache()
    assert changed.tokenizer.vocab_size == first.tokenizer.vocab_size
    assert changed.tokenizer.files_digest != first.tokenizer.files_digest
    assert not changed.load_disk_cache(cache_dir, "ds", 50)


# -- the protobuf reader -------------------------------------------------------------
def test_hand_written_model_is_the_proto_transformers_parses():
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("▁a", -1.5, NORMAL),
              ("<sep>", 0.0, USER_DEFINED), ("ab", -2.25, UNUSED), ("<0x41>", 0.0, BYTE)]
    blob = chip_smoke.spm_model_bytes(pieces, model_type=1, byte_fallback=False,
                                      add_dummy_prefix=False, remove_extra_whitespaces=True,
                                      charsmap=b"\x04\x00\x00\x00\x00\x00\x00\x00",
                                      normalizer="nmt_nfkc")
    m = PB.ModelProto.FromString(blob)
    assert [(p.piece, p.score, p.type) for p in m.pieces] == pieces
    assert (m.trainer_spec.model_type, m.trainer_spec.vocab_size,
            m.trainer_spec.byte_fallback) == (1, 6, False)
    ns = m.normalizer_spec
    assert (ns.name, ns.precompiled_charsmap, ns.add_dummy_prefix, ns.remove_extra_whitespaces,
            ns.escape_whitespaces) == ("nmt_nfkc", b"\x04" + b"\x00" * 7, False, True, True)


def test_reader_reads_every_field_and_skips_the_rest():
    """A model written by the protobuf library with every field the port
    reads away from its default, beside fields it skips (every wire type:
    repeated strings, floats, varints, a nested message)."""
    m = PB.ModelProto()
    for piece, score, kind in (("<pad>", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN),
                               ("▁x", -3.5, NORMAL), ("y", -7.0, NORMAL)):
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    t = m.trainer_spec
    t.input.extend(["a.txt", "b.txt"])
    t.model_type, t.vocab_size, t.character_coverage = 2, 4, 0.5
    t.byte_fallback, t.treat_whitespace_as_suffix = True, True
    t.unk_id, t.bos_id, t.eos_id, t.pad_id = 1, -1, -1, 0
    t.unk_piece = "[UNK]"
    m.normalizer_spec.name = "nfkc_cf"
    m.normalizer_spec.precompiled_charsmap = b"\x01\x02"
    m.normalizer_spec.add_dummy_prefix = False
    m.normalizer_spec.remove_extra_whitespaces = False
    m.normalizer_spec.escape_whitespaces = False
    s = m.self_test_data.samples.add()
    s.input, s.expected = "x", "▁x"
    m.denormalizer_spec.name = "identity"
    r = sentencepiece.parse_model(m.SerializeToString(), "m")
    assert r.pieces == [("<pad>", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN), ("▁x", -3.5, NORMAL),
                        ("y", -7.0, NORMAL)]
    assert (r.model_type, r.byte_fallback, r.treat_whitespace_as_suffix) == (2, True, True)
    assert (r.unk_id, r.bos_id, r.eos_id, r.pad_id, r.unk_piece) == (1, -1, -1, 0, "[UNK]")
    assert (r.normalizer_name, r.charsmap, r.add_dummy_prefix, r.remove_extra_whitespaces,
            r.escape_whitespaces) == ("nfkc_cf", b"\x01\x02", False, False, False)
    # the defaults where the fields are absent
    bare = PB.ModelProto()
    p = bare.pieces.add()
    p.piece, p.type = "<unk>", UNKNOWN
    r = sentencepiece.parse_model(bare.SerializeToString(), "m")
    assert (r.model_type, r.byte_fallback, r.unk_id, r.bos_id, r.eos_id, r.pad_id,
            r.unk_piece) == (1, False, 0, 1, 2, -1, "<unk>")
    assert (r.add_dummy_prefix, r.remove_extra_whitespaces, r.escape_whitespaces) == (
        True, True, True)
    assert r.pieces == [("<unk>", 0.0, UNKNOWN)]


@pytest.mark.parametrize("data", [b"", b"\x00", b"\x0a\x05ab", b"\xff\xff\xff",
                                  b"\x0a\x02\x0a\x00", "not a model\n".encode()])
def test_what_is_not_a_model_raises_naming_the_file(data, tmp_path):
    path = tmp_path / "tokenizer.model"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="tokenizer.model"):
        sentencepiece.read_model(str(path))


def test_tiktoken_file_is_told_apart(tmp_path):
    path = tmp_path / "tokenizer.model"
    path.write_text("".join(f"{base64.b64encode(bytes([b])).decode()} {b}\n" for b in range(256)))
    assert sentencepiece.is_tiktoken(path.read_bytes())
    with pytest.raises(NotImplementedError, match="tiktoken"):
        sentencepiece.read_model(str(path))
    assert not sentencepiece.is_tiktoken(chip_smoke.spm_model_bytes(llama_pieces()[:10]))


# -- sentencepiece's own encode, by hand -------------------------------------------
def _proc(pieces, model_type=2, **kw):
    m = sentencepiece.parse_model(chip_smoke.spm_model_bytes(pieces, model_type=model_type, **kw),
                                  "m")
    return sentencepiece.Processor(m, "m")


BASE = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
        ("▁", -10.0, NORMAL), ("a", -10.0, NORMAL), ("b", -10.0, NORMAL), ("c", -10.0, NORMAL)]

# (pieces beyond BASE, model flags, text, expected pieces)
BPE_CASES = {
    # the merged piece with the highest score first: bc before ab
    "score_order": ([("ab", -2.0, NORMAL), ("bc", -1.0, NORMAL)], {}, "abc",
                    ["▁", "a", "bc"]),
    # equal scores: the leftmost pair
    "tie_leftmost": ([("ab", -1.0, NORMAL), ("bc", -1.0, NORMAL)], {}, "abc",
                     ["▁", "ab", "c"]),
    "merges_chain": ([("ab", -1.0, NORMAL), ("abc", -2.0, NORMAL), ("▁abc", -3.0, NORMAL)],
                     {}, "abc", ["▁abc"]),
    # an unused piece merges, then splits back into what made it
    "unused_resegmented": ([("ab", -1.0, NORMAL), ("abc", -0.5, UNUSED)], {}, "abc",
                           ["▁", "ab", "c"]),
    "unused_nested": ([("ab", -1.0, UNUSED), ("abc", -0.5, UNUSED), ("▁abc", -0.1, NORMAL)],
                      {}, "abc", ["▁abc"]),
    # unknown characters: consecutive ones are one <unk>, or their bytes
    # under byte_fallback
    "unknown": ([], {"byte_fallback": False}, "aééaé", ["▁", "a", "éé", "a", "é"]),
    "byte_fallback": (BYTES, {"byte_fallback": True}, "aé",
                      ["▁", "a", "<0xC3>", "<0xA9>"]),
    "byte_fallback_missing_byte": ([("<0xC3>", 0.0, BYTE)], {"byte_fallback": True}, "é",
                                   ["▁", "<0xC3>", "<0xA9>"]),
    # a user-defined piece is split out and never merges nor normalizes
    "user_defined": ([("<sep>", 0.0, USER_DEFINED), ("a<", -1.0, NORMAL),
                      ("▁a", -1.0, NORMAL)], {}, "a<sep>a", ["▁a", "<sep>", "a"]),
    "user_defined_longest": ([("<s", 0.0, USER_DEFINED), ("<sep>", 0.0, USER_DEFINED)], {},
                             "<sep><s", ["▁", "<sep>", "<s"]),
    # the whitespace flags
    "extra_whitespace_removed": ([("▁▁", -1.0, NORMAL)], {"remove_extra_whitespaces": True},
                                 "  a   b  ", ["▁", "a", "▁", "b"]),
    "extra_whitespace_kept": ([("▁▁", -1.0, NORMAL)], {"remove_extra_whitespaces": False},
                              " a  b ", ["▁▁", "a", "▁▁", "b", "▁"]),
    "no_dummy_prefix": ([], {"add_dummy_prefix": False}, "a b", ["a", "▁", "b"]),
    "only_spaces": ([], {"remove_extra_whitespaces": True}, "   ", []),
    "tab_is_not_a_space": ([], {"byte_fallback": False}, "a\tb", ["▁", "a", "\t", "b"]),
}


@pytest.mark.parametrize("case", list(BPE_CASES))
def test_native_bpe_follows_bpe_model_cc(case):
    extra, flags, text, want = BPE_CASES[case]
    flags = dict({"byte_fallback": False}, **flags)
    proc = _proc(BASE + extra, **flags)
    got = proc.encode(text)
    assert [p for p, _ in got] == want
    assert [i for _, i in got] == [proc.piece_to_id(p) for p in want]


def test_native_unknown_pieces_take_the_unknown_id():
    proc = _proc(BASE, byte_fallback=False)
    assert proc.encode("é") == [("▁", 3), ("é", 0)]


UNIGRAM_CASES = {
    # the best path by summed score
    "best_path": ([("ab", -1.0, NORMAL), ("abc", -12.0, NORMAL), ("bc", -1.5, NORMAL)], "abc",
                  ["▁", "ab", "c"]),
    "whole_piece": ([("▁abc", -1.0, NORMAL)], "abc", ["▁abc"]),
    # an unused piece is never on the path
    "unused_skipped": ([("▁abc", -1.0, UNUSED), ("ab", -3.0, NORMAL)], "abc",
                       ["▁", "ab", "c"]),
    # a character no piece holds alone is unknown, at the lowest score - 10
    "unknown": ([("é", -50.0, UNUSED)], "aé", ["▁", "a", "é"]),
    # a user-defined piece scores length · max score - 0.1 (max score 0
    # where no normal piece scores above 0)
    "user_defined": ([("bc", -30.0, USER_DEFINED), ("abc", -25.0, NORMAL)], "abc",
                     ["▁", "a", "bc"]),
}


@pytest.mark.parametrize("case", list(UNIGRAM_CASES))
def test_native_unigram_follows_unigram_model_cc(case):
    extra, text, want = UNIGRAM_CASES[case]
    proc = _proc(BASE + extra, model_type=1, byte_fallback=False)
    assert [p for p, _ in proc.encode(text)] == want


def test_native_normalizer_uses_the_longest_charsmap_key():
    """sentencepiece's NormalizePrefix takes the longest key (tokenizers'
    Precompiled the shortest, grapheme-wise)."""
    blob = charsmap_blob({"ｶ": "カ", "ｶﾞ": "ガ", "Ａ": "A", "　": " "})
    proc = _proc(BASE + [("カ", -1.0, NORMAL), ("ガ", -1.0, NORMAL), ("A", -1.0, NORMAL)],
                 byte_fallback=False, charsmap=blob, remove_extra_whitespaces=True)
    assert [p for p, _ in proc.encode("ｶﾞｶ　　Ａ")] == ["▁", "ガ", "カ", "▁", "A"]
    cm = sentencepiece.Charsmap(blob, "blob")
    assert cm.shortest("ｶﾞ") == "カ" and cm.longest("ｶﾞ".encode(), 0)[1] == "ガ".encode()


# -- Baichuan, through transformers' slow tokenizer ---------------------------------
BAICHUAN_PY = '''
"""Baichuan2's BaichuanTokenizer, its sp_model the port's sentencepiece
Processor (the test's oracle for the slow wrapper)."""
from transformers import PreTrainedTokenizer
from transformers.tokenization_utils import AddedToken

from mhrec_tpu_torch.data import sentencepiece as _port


class _SentencePiece:
    def __init__(self, **kwargs):
        self.proc = None

    def Load(self, path):
        self.proc = _port.Processor(_port.read_model(path), path)

    def encode(self, text, out_type=str):
        return [p for p, _ in self.proc.encode(text)]

    def piece_to_id(self, piece):
        return self.proc.piece_to_id(piece)

    def get_piece_size(self):
        return len(self.proc.model.pieces)

    def IdToPiece(self, index):
        return self.proc.model.pieces[index][0]


class BaichuanTokenizer(PreTrainedTokenizer):
    vocab_files_names = {"vocab_file": "tokenizer.model"}
    model_input_names = ["input_ids", "attention_mask"]

    def __init__(self, vocab_file, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
                 pad_token=None, sp_model_kwargs=None, add_bos_token=True,
                 add_eos_token=False, clean_up_tokenization_spaces=False, **kwargs):
        self.sp_model_kwargs = {} if sp_model_kwargs is None else sp_model_kwargs
        bos_token = (AddedToken(bos_token, lstrip=False, rstrip=False)
                     if isinstance(bos_token, str) else bos_token)
        eos_token = (AddedToken(eos_token, lstrip=False, rstrip=False)
                     if isinstance(eos_token, str) else eos_token)
        unk_token = (AddedToken(unk_token, lstrip=False, rstrip=False)
                     if isinstance(unk_token, str) else unk_token)
        pad_token = (AddedToken(pad_token, lstrip=False, rstrip=False)
                     if isinstance(pad_token, str) else pad_token)
        self.vocab_file = vocab_file
        self.add_bos_token = add_bos_token
        self.add_eos_token = add_eos_token
        self.sp_model = _SentencePiece(**self.sp_model_kwargs)
        self.sp_model.Load(vocab_file)
        super().__init__(bos_token=bos_token, eos_token=eos_token, unk_token=unk_token,
                         pad_token=pad_token, add_bos_token=add_bos_token,
                         add_eos_token=add_eos_token, sp_model_kwargs=self.sp_model_kwargs,
                         clean_up_tokenization_spaces=clean_up_tokenization_spaces, **kwargs)

    @property
    def vocab_size(self):
        return self.sp_model.get_piece_size()

    def get_vocab(self):
        vocab = {self.convert_ids_to_tokens(i): i for i in range(self.vocab_size)}
        vocab.update(self.added_tokens_encoder)
        return vocab

    def _tokenize(self, text):
        return self.sp_model.encode(text, out_type=str)

    def _convert_token_to_id(self, token):
        return self.sp_model.piece_to_id(token)

    def _convert_id_to_token(self, index):
        return self.sp_model.IdToPiece(index)

    def build_inputs_with_special_tokens(self, token_ids_0, token_ids_1=None):
        bos = [self.bos_token_id] if self.add_bos_token else []
        eos = [self.eos_token_id] if self.add_eos_token else []
        out = bos + token_ids_0 + eos
        if token_ids_1 is not None:
            out = out + bos + token_ids_1 + eos
        return out
'''


def write_baichuan_dir(d, add_bos=False, add_eos=False, single_word=True, extra=None):
    """chip_smoke's Baichuan2 tokenizer_config.json (``add_bos_token`` and
    ``add_eos_token`` set here) over a small model with a user-defined piece,
    and the class file."""
    write_spm_dir(d, llama_pieces(user=("<reserved_1>",)), model_kind="baichuan")
    chip_smoke.write_baichuan_config(d)
    path = os.path.join(d, "tokenizer_config.json")
    tcfg = json.load(open(path))
    tcfg.update(add_bos_token=add_bos, add_eos_token=add_eos, **(extra or {}))
    for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
        tcfg[key]["single_word"] = single_word
    json.dump(tcfg, open(path, "w"))
    with open(os.path.join(d, "tokenization_baichuan.py"), "w") as fh:
        fh.write(BAICHUAN_PY)
    return d


BAICHUAN_DIRS = {
    "no_bos": lambda d: write_baichuan_dir(d),
    "bos": lambda d: write_baichuan_dir(d, add_bos=True),
    "bos_eos_not_single_word": lambda d: write_baichuan_dir(d, True, True, single_word=False),
    "added_tokens_decoder": lambda d: write_baichuan_dir(d, True, extra={
        "added_tokens_decoder": {"600": {"content": "<|user|>", "lstrip": True,
                                         "rstrip": True, "single_word": False,
                                         "normalized": False, "special": True}},
        "additional_special_tokens": ["<|user|>", "<|bot|>"]}),
}


@pytest.fixture(scope="module")
def baichuan_dirs(tmp_path_factory):
    import transformers.dynamic_module_utils as dmu

    root = tmp_path_factory.mktemp("baichuan")
    old = dmu.HF_MODULES_CACHE
    dmu.HF_MODULES_CACHE = str(root / "modules")  # the remote code's copy, under the test's tmp
    try:
        dirs = {name: make(str(root / name)) for name, make in BAICHUAN_DIRS.items()}
        yield {name: (jax_build_tokenizer(d, 1024), d) for name, d in dirs.items()}
    finally:
        dmu.HF_MODULES_CACHE = old


@pytest.mark.parametrize("name", list(BAICHUAN_DIRS))
def test_baichuan_matches_the_slow_tokenizer(baichuan_dirs, name):
    ref, d = baichuan_dirs[name]
    assert not isinstance(ref, JaxHashTokenizer), "the oracle fell back to hashing"
    assert type(ref.tok).__name__ == "BaichuanTokenizer"
    ours = build_tokenizer(d, 1024)
    assert ours.kind == "spm:BaichuanTokenizer" and ours.vocab_size == ref.vocab_size
    texts = make_texts() + ["<|user|>hi  <|bot|> x", "a<s>b", "a <s> b", "<s>x</s>", "x <unk>"]
    for text in texts:
        for n in LENGTHS:
            assert ours.encode(text, n) == ref.encode(text, n), (name, text, n)


def test_baichuan_matches_the_slow_tokenizer_on_random_unicode(baichuan_dirs):
    ref, d = baichuan_dirs["bos"]
    ours = build_tokenizer(d, 1024)

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(st.text(max_size=40))
    def check(text):
        for n in (5, 256):
            assert ours.encode(text, n) == ref.encode(text, n), (text, n)

    check()


# -- the Precompiled normalizer --------------------------------------------------------
NEIGHBOURS = ["a", "́", "‍", "️", " ", "\U0001F3FD", "Ａ", "ﾞ", "é", "\r", "\n",
              "؀", "ᄀ", "ᅡ", "\U0001F1EF", "\U0001F1F5", "ः", "ำ",
              "가", "\x07", "❤", "ｶ"]


def test_precompiled_matches_tokenizers_at_every_key():
    blob = charsmap_blob(CHARSMAP)
    oracle_norm = normalizers.Precompiled(blob)
    port = hf_tokenizer._Normalizer({"type": "Precompiled",
                                     "precompiled_charsmap": base64.b64encode(blob).decode()})
    assert port.removes
    for key in CHARSMAP:
        for x in NEIGHBOURS:
            for y in NEIGHBOURS:
                s = x + key + y
                assert port(s) == oracle_norm.normalize_str(s), [hex(ord(c)) for c in s]
    rng = np.random.default_rng(0)
    alphabet = sorted(set("".join(CHARSMAP)) | set("".join(NEIGHBOURS)))
    for _ in range(3000):
        s = "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet),
                                                             size=int(rng.integers(1, 9))))
        assert port(s) == oracle_norm.normalize_str(s), [hex(ord(c)) for c in s]


@pytest.mark.parametrize("blob", [b"", b"\x08\x00\x00\x00\x00", "x".encode()])
def test_broken_charsmap_raises(blob):
    with pytest.raises(NotImplementedError, match="charsmap"):
        hf_tokenizer._Normalizer({"type": "Precompiled",
                                  "precompiled_charsmap": base64.b64encode(blob).decode()})


# -- the chip run's directories --------------------------------------------------------
def test_chip_smoke_tokenizer_model_digest_matches_the_converter(tmp_path):
    """The TinyLlama-layout tokenizer.model that chip_smoke.py writes
    (32,000 pieces), converted by transformers' LlamaConverter over the
    hllm_tokenizer phase's texts, gives the digest the script holds the
    card's run to; so does the port."""
    d = str(tmp_path / "spm")
    os.makedirs(d)
    _write_config(d, "llama", chip_smoke.TINYLLAMA_1B["vocab_size"])
    cfg = chip_smoke.hllm_config(d, str(tmp_path))
    n = chip_smoke.PRETRAINED_ITEMS
    texts = chip_smoke.rendered_texts(cfg, chip_smoke.tokenizer_item_table(n, seed=0), n)
    chip_smoke.write_llama_spm_tokenizer(d, texts, chip_smoke.TINYLLAMA_1B["vocab_size"], seed=0)
    assert not os.path.exists(os.path.join(d, "tokenizer.json"))
    assert len(_proto(os.path.join(d, "tokenizer.model")).pieces) == 32_000
    ref = oracle(d)
    T = cfg["MAX_TEXT_LENGTH"]
    want = [ref.encode(t, T) for t in texts]
    ours = build_tokenizer(d, 32_000)
    assert ours.kind == "hf:LlamaTokenizerFast"
    assert [ours.encode(t, T) for t in texts] == want
    assert chip_smoke.ids_digest(want) == chip_smoke.TOKENIZER_MODEL_DIGEST
    assert any(3 <= i < 259 for ids in want for i in ids)  # byte fallback runs


def test_chip_smoke_baichuan_digest(tmp_path):
    """The Baichuan2-layout directory the hllm_towers phase gives its
    Baichuan-13B-shaped tower (64,000 pieces), over that phase's item
    texts, through the port's native encoder: the digest the script holds
    the card's run to (tests/test_torch_cuda.py holds the encoder to
    sentencepiece on the card's machine)."""
    texts, T = chip_smoke.towers_texts()
    d = str(tmp_path / "baichuan")
    os.makedirs(d)
    _write_config(d, "baichuan", 64_000)
    chip_smoke.write_baichuan_tokenizer(d, texts, 64_000, seed=0)
    tok = build_tokenizer(d, 64_000)
    assert tok.kind == "spm:BaichuanTokenizer" and tok.vocab_size == 64_000
    ids = [tok.encode(t, T) for t in texts]
    assert chip_smoke.ids_digest(ids) == chip_smoke.BAICHUAN_TOKENIZER_DIGEST
    assert not isinstance(tok, HashTokenizer) and max(max(x) for x in ids) < 64_000
