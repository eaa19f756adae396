"""The port's HF tokenizers (``mhrec_tpu_torch/data/hf_tokenizer.py``)
against the JAX package's ``build_tokenizer``, which loads the same
directories through ``transformers``' ``AutoTokenizer``.

The directories are small tokenizers (a few hundred entries) that
``tokenizers`` trains here from a seeded corpus and the ``transformers``
classes save with ``save_pretrained``, beside a ``config.json``:

* Llama BPE with byte fallback in both ``▁`` layouts (the older
  ``Prepend``/``Replace`` normalizer without a pre-tokenizer, TinyLlama's;
  the newer ``Metaspace`` pre-tokenizer with ``prepend_scheme: first``),
  ``legacy`` true and false, ``add_bos_token`` / ``add_eos_token`` on and
  off;
* Qwen2 byte-level BPE (NFC, the Qwen2 split regex, GPT-2's byte map);
* BERT WordPiece, lower-cased and cased, and a ``vocab.txt``-only BERT
  directory.

Ids are integers, so the tolerance is exact equality. The texts come from a
seed with numpy and cover ASCII, accents, CJK, emoji, digit runs, runs of
spaces, leading and trailing spaces, tabs, newlines and control characters,
contractions, embedded special-token strings and the empty string; a
hypothesis test adds random Unicode text. The Unicode tables the port
carries are held to ``tokenizers`` at every code point.
"""

import json
import os
import shutil

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)
from transformers import (BertTokenizerFast, GemmaTokenizerFast, GPT2TokenizerFast,
                          GPTNeoXTokenizerFast, LlamaTokenizerFast, PreTrainedTokenizerFast,
                          Qwen2TokenizerFast)

import chip_smoke
from mhrec_tpu.data.textset import HashTokenizer as JaxHashTokenizer
from mhrec_tpu.data.textset import build_tokenizer as jax_build_tokenizer
from mhrec_tpu_torch.data import hf_tokenizer
from mhrec_tpu_torch.data.textset import HashTokenizer, build_tokenizer

LENGTHS = (1, 2, 3, 17, 256)
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+"
              r"[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

FRAGMENTS = [
    "hello", "world", "Title:", "Item", "number", "Description:", "tag_3", "synthetic",
    "café", "naïve", "Ångström", "résumé", "Crème brûlée", "ÉCOLE",
    "日本語", "中文字符", "한국어", "ひらがな", "Ελληνικά", "русский", "עברית", "مرحبا",
    "😀", "👍🏽", "🇯🇵", "❤️", "👩‍👩‍👧",
    "12345", "007", "3.14159", "٣٤٥", "²³", "Ⅻ", "½",
    "'S", "'ll", "don't", "I'M", "we've", "she'd", "IT'S",
    "<s>", "</s>", "<unk>", "[SEP]", "[CLS]", "[MASK]", "<|endoftext|>", "<|im_start|>",
    "hello world", "HELLO   World", "item", "items", "an item.", " [SEP] ",
    "a-b", "x_y", "(paren)", "\"quoted\"", "e-mail@host.com", "$9.99", "#tag", "50%",
    "\x00", "\x07", "\x1f", "​", "‍", "﻿", "�", "́", "é",
]
SEPARATORS = [" ", " ", " ", "  ", "   ", "\t", "\n", "\r\n", "", " \n ", "　", "\xa0"]


def make_texts(seed=0, n=60):
    """Seeded texts joining random fragments with random separators, with a
    leading or trailing space now and then, and the empty string."""
    rng = np.random.default_rng(seed)
    texts = ["", " ", "  leading", "trailing  ", "<s>", "<s>hello", "hello<s>", " <s> x",
             "[SEP]", "a [SEP] b", "<|endoftext|>", "x<|endoftext|>y"]
    for _ in range(n):
        k = int(rng.integers(1, 12))
        parts = [FRAGMENTS[int(i)] for i in rng.integers(0, len(FRAGMENTS), size=k)]
        seps = [SEPARATORS[int(i)] for i in rng.integers(0, len(SEPARATORS), size=k)]
        text = "".join(p + s for p, s in zip(parts, seps))
        if rng.random() < 0.2:
            text = " " + text
        texts.append(text)
    return texts


def make_corpus(seed=1, n=400):
    rng = np.random.default_rng(seed)
    frags = [f for f in FRAGMENTS if f.strip() and f.isprintable()]
    return [" ".join(frags[int(i)] for i in rng.integers(0, len(frags), size=8))
            for _ in range(n)]


def _write_config(dirpath, model_type, vocab_size):
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump({"model_type": model_type, "vocab_size": vocab_size, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2}, fh)


def _llama_object(layout, n_bytes=256):
    """A Llama BPE: <unk> <s> </s>, the first ``n_bytes`` byte tokens (all
    256 in Llama's; fewer, and the bytes without a token fall back to a
    fused <unk>), then what the trainer learns on the corpus (tokens start
    with ▁, as SentencePiece's)."""
    trained = Tokenizer(models.BPE())
    trained.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always")
    trained.train_from_iterator(make_corpus(), trainers.BpeTrainer(
        vocab_size=300, show_progress=False,
        initial_alphabet=list("▁abcdefghijklmnopqrstuvwxyz")))
    spec = json.loads(trained.to_str())
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(n_bytes)]
    learned = sorted(spec["model"]["vocab"], key=spec["model"]["vocab"].get)
    vocab = {t: i for i, t in enumerate(specials + [t for t in learned if t not in specials])}
    spec["model"].update(vocab=vocab, unk_token="<unk>", byte_fallback=True, fuse_unk=True)
    spec["added_tokens"] = [{"id": i, "content": t, "single_word": False, "lstrip": False,
                             "rstrip": False, "normalized": False, "special": True}
                            for i, t in enumerate(specials[:3])]
    if layout == "legacy":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
        spec["pre_tokenizer"] = None
    else:
        spec["normalizer"] = None
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                 "prepend_scheme": "first", "split": False}
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    return tok


def write_llama(dirpath, layout="legacy", legacy=False, add_bos=True, add_eos=False,
                n_bytes=256):
    tok = LlamaTokenizerFast(tokenizer_object=_llama_object(layout, n_bytes), legacy=legacy,
                             add_bos_token=add_bos, add_eos_token=add_eos,
                             bos_token="<s>", eos_token="</s>", unk_token="<unk>")
    tok.save_pretrained(dirpath)
    _write_config(dirpath, "llama", 1024)
    return dirpath


def write_qwen2(dirpath):
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(make_corpus(), trainers.BpeTrainer(
        vocab_size=400, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    fast = Qwen2TokenizerFast(tokenizer_object=tok, unk_token=None,
                              additional_special_tokens=["<|im_start|>", "<|im_end|>"])
    fast.save_pretrained(dirpath)
    _write_config(dirpath, "qwen2", 1024)
    return dirpath


def write_bert(dirpath, lower=True, vocab_only=False):
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=lower)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(make_corpus(), trainers.WordPieceTrainer(
        vocab_size=300, show_progress=False,
        special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    fast = BertTokenizerFast(tokenizer_object=tok, do_lower_case=lower)
    fast.save_pretrained(dirpath)
    _write_config(dirpath, "bert", 1024)
    if vocab_only:
        os.remove(os.path.join(dirpath, "tokenizer.json"))
        os.remove(os.path.join(dirpath, "special_tokens_map.json"))
    return dirpath


def _gpt2_object():
    """GPT-2's byte-level BPE (the ByteLevel pre-tokenizer's own regex)."""
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(make_corpus(), trainers.BpeTrainer(
        vocab_size=400, show_progress=False, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok


def write_gpt2(dirpath, add_prefix_space):
    """Saved by GPT2TokenizerFast, whose ``add_prefix_space`` rewrites the
    pre-tokenizer's."""
    fast = GPT2TokenizerFast(tokenizer_object=_gpt2_object(),
                             add_prefix_space=add_prefix_space)
    fast.save_pretrained(dirpath)
    _write_config(dirpath, "gpt2", 1024)
    return dirpath


def write_gpt_neox(dirpath):
    """GPT-2's BPE under GPTNeoXTokenizerFast with ``add_bos_token`` and
    ``add_eos_token``: the class rebuilds the template from them."""
    fast = GPTNeoXTokenizerFast(tokenizer_object=_gpt2_object(), add_bos_token=True,
                                add_eos_token=True)
    fast.save_pretrained(dirpath)
    _write_config(dirpath, "gpt_neox", 1024)
    return dirpath


def write_gemma(dirpath):
    """The Metaspace Llama BPE under GemmaTokenizerFast, with no
    tokenizer_config.json: the class comes from config.json's model_type
    and its special tokens (<bos>, <eos>, <pad>) are not in the vocabulary,
    so they are added after it and <bos> starts every sequence."""
    GemmaTokenizerFast(tokenizer_object=_llama_object("metaspace")).save_pretrained(dirpath)
    os.remove(os.path.join(dirpath, "tokenizer_config.json"))
    os.remove(os.path.join(dirpath, "special_tokens_map.json"))
    path = os.path.join(dirpath, "tokenizer.json")
    with open(path) as fh:
        spec = json.load(fh)
    size = len(spec["model"]["vocab"])
    spec["added_tokens"] = [t for t in spec["added_tokens"] if t["id"] < size]
    with open(path, "w") as fh:
        json.dump(spec, fh)
    _write_config(dirpath, "gemma", 1024)
    return dirpath


def write_generic(dirpath):
    """A PreTrainedTokenizerFast over what the other families leave out:
    NFKD, StripAccents, Lowercase and a regex Replace; the
    Whitespace, Digits and Punctuation pre-tokenizers; BPE with a
    continuing-subword prefix and an end-of-word suffix; RoBERTa's
    post-processor; an added token with lstrip and rstrip, a normalized
    one, and a single-word one."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", continuing_subword_prefix="##",
                               end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFKD(), normalizers.StripAccents(), normalizers.Lowercase(),
        normalizers.Replace(Regex(r"\s+"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Whitespace(), pre_tokenizers.Digits(individual_digits=True),
        pre_tokenizers.Punctuation(behavior="merged_with_previous")])
    tok.train_from_iterator(make_corpus(), trainers.BpeTrainer(
        vocab_size=400, show_progress=False, special_tokens=["<unk>", "<s>", "</s>"],
        continuing_subword_prefix="##", end_of_word_suffix="</w>"))
    tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 1))
    tok.add_tokens([AddedToken("[SEP]", lstrip=True, rstrip=True),
                    AddedToken("hello world", normalized=True),
                    AddedToken("item", single_word=True)])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   unk_token="<unk>")
    fast.save_pretrained(dirpath)
    _write_config(dirpath, "llama", 1024)
    return dirpath


def _drop_config_key(dirpath, key):
    """tokenizer_config.json without ``key``: the class default takes over
    (GPT2TokenizerFast's add_prefix_space false rewrites the ByteLevel
    pre-tokenizer's true)."""
    path = os.path.join(dirpath, "tokenizer_config.json")
    with open(path) as fh:
        cfg = json.load(fh)
    del cfg[key]
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return dirpath


DIRS = {
    "llama_legacy_layout": lambda d: write_llama(d, "legacy", legacy=True),
    "llama_legacy_layout_legacy_false": lambda d: write_llama(d, "legacy", legacy=False),
    "llama_metaspace": lambda d: write_llama(d, "metaspace", legacy=False),
    "llama_metaspace_legacy_true": lambda d: write_llama(d, "metaspace", legacy=True),
    "llama_no_bos": lambda d: write_llama(d, add_bos=False),
    "llama_bos_eos": lambda d: write_llama(d, add_eos=True),
    "llama_eos_only": lambda d: write_llama(d, "metaspace", add_bos=False, add_eos=True),
    "llama_ascii_bytes_only": lambda d: write_llama(d, n_bytes=128),
    "gpt2": lambda d: write_gpt2(d, False),
    "gpt2_prefix_space": lambda d: write_gpt2(d, True),
    "gpt2_config_overrides_json": lambda d: _drop_config_key(write_gpt2(d, True),
                                                             "add_prefix_space"),
    "generic": write_generic,
    "gpt_neox": write_gpt_neox,
    "gemma": write_gemma,
    "qwen2": write_qwen2,
    "bert_uncased": lambda d: write_bert(d, lower=True),
    "bert_cased": lambda d: write_bert(d, lower=False),
    "bert_vocab_txt": lambda d: write_bert(d, vocab_only=True),
}


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {name: make(str(root / name)) for name, make in DIRS.items()}


def _pair(path):
    ref = jax_build_tokenizer(path, 1024)
    ours = build_tokenizer(path, 1024)
    assert not isinstance(ref, JaxHashTokenizer), "the oracle fell back to hashing"
    assert not isinstance(ours, HashTokenizer)
    return ref, ours


@pytest.mark.parametrize("name", list(DIRS))
def test_encode_matches_jax(tok_dirs, name):
    """Every seeded text at every length, id for id."""
    ref, ours = _pair(tok_dirs[name])
    assert ours.vocab_size == ref.vocab_size
    for text in make_texts():
        for n in LENGTHS:
            assert ours.encode(text, n) == ref.encode(text, n), (name, text, n)


FAMILIES = ("llama_legacy_layout", "llama_metaspace", "qwen2", "bert_uncased", "gpt2",
            "generic")


@pytest.mark.parametrize("name", FAMILIES)
def test_encode_matches_jax_on_random_unicode(tok_dirs, name):
    """Random Unicode text (hypothesis), at two lengths."""
    ref, ours = _pair(tok_dirs[name])

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(st.text(max_size=40))
    def check(text):
        for n in (5, 256):
            assert ours.encode(text, n) == ref.encode(text, n), (name, text, n)

    check()


def test_legacy_flag_changes_nothing_tokenizer_json_defines(tok_dirs):
    """``legacy: false`` in tokenizer_config.json leaves a tokenizer that
    tokenizer.json defines as it is, in both packages."""
    texts = make_texts(seed=3)
    for a, b in (("llama_legacy_layout", "llama_legacy_layout_legacy_false"),
                 ("llama_metaspace_legacy_true", "llama_metaspace")):
        for name, legacy in ((a, True), (b, False)):
            with open(os.path.join(tok_dirs[name], "tokenizer_config.json")) as fh:
                assert json.load(fh)["legacy"] is legacy
        ta, tb = build_tokenizer(tok_dirs[a]), build_tokenizer(tok_dirs[b])
        assert [ta.encode(t, 64) for t in texts] == [tb.encode(t, 64) for t in texts]


def test_the_template_follows_add_bos_and_add_eos(tok_dirs):
    text = "hello world"
    bos = build_tokenizer(tok_dirs["llama_legacy_layout"]).encode(text, 64)
    none = build_tokenizer(tok_dirs["llama_no_bos"]).encode(text, 64)
    both = build_tokenizer(tok_dirs["llama_bos_eos"]).encode(text, 64)
    assert bos[0] == 1 and bos[1:] == none and both == bos + [2]
    # BERT keeps [SEP] when it cuts; Llama keeps <s>
    bert = build_tokenizer(tok_dirs["bert_uncased"])
    assert bert.encode(text, 3)[0] == 2 and bert.encode(text, 3)[-1] == 3
    assert len(build_tokenizer(tok_dirs["llama_bos_eos"]).encode(text, 2)) == 2


def test_config_add_prefix_space_rewrites_byte_level(tok_dirs):
    """GPT2TokenizerFast's add_prefix_space (false unless the config says)
    replaces the ByteLevel pre-tokenizer's, in both packages."""
    with open(os.path.join(tok_dirs["gpt2_config_overrides_json"], "tokenizer.json")) as fh:
        assert json.load(fh)["pre_tokenizer"]["add_prefix_space"] is True
    text = "hello world"
    spaced = build_tokenizer(tok_dirs["gpt2_prefix_space"]).encode(text, 64)
    rewritten = build_tokenizer(tok_dirs["gpt2_config_overrides_json"]).encode(text, 64)
    plain = build_tokenizer(tok_dirs["gpt2"]).encode(text, 64)
    assert rewritten == plain != spaced


@pytest.mark.parametrize("case", ["guard", "no_tokenizer_file", "tokenizer_config_only"])
def test_hash_tokenizer_where_jax_hashes(tok_dirs, tmp_path, case):
    """The vocabulary guard (a tokenizer larger than config.json's
    vocabulary) and a directory without a tokenizer file give the hash
    tokenizer over the model's vocabulary in both packages."""
    d = tmp_path / case
    if case == "guard":
        shutil.copytree(tok_dirs["qwen2"], d)
        _write_config(str(d), "qwen2", 100)
    else:
        d.mkdir()
        _write_config(str(d), "llama", 500)
        if case == "tokenizer_config_only":
            (d / "tokenizer_config.json").write_text(
                json.dumps({"tokenizer_class": "LlamaTokenizer"}))
    ref, ours = jax_build_tokenizer(str(d), 1024), build_tokenizer(str(d), 1024)
    assert isinstance(ref, JaxHashTokenizer) and isinstance(ours, HashTokenizer)
    assert ours.vocab_size == ref.vocab_size == (100 if case == "guard" else 500)
    assert ours.encode("hello world", 8) == ref.encode("hello world", 8)


@pytest.mark.parametrize("case", ["tokenizer_model", "tiktoken", "vocab_json_merges",
                                  "bad_json", "unigram", "wordlevel", "unknown_normalizer",
                                  "unknown_class", "regex_script_class"])
def test_what_the_port_cannot_tokenize_raises(tok_dirs, tmp_path, case):
    d = tmp_path / case
    d.mkdir()
    _write_config(str(d), "llama", 1024)
    spec = json.loads((open(os.path.join(tok_dirs["qwen2"], "tokenizer.json")).read()))
    match = case
    if case == "tokenizer_model":
        (d / "tokenizer.model").write_bytes(b"\x00")
        match = "tokenizer.model"
    elif case == "tiktoken":
        (d / "cl100k.tiktoken").write_text("")
        match = "tiktoken"
    elif case == "vocab_json_merges":
        (d / "vocab.json").write_text("{}")
        (d / "merges.txt").write_text("")
        match = "vocab.json"
    elif case == "bad_json":
        (d / "tokenizer.json").write_text("{")
        match = "not JSON"
    elif case in ("unigram", "wordlevel"):
        spec["model"] = {"type": "Unigram" if case == "unigram" else "WordLevel", "vocab": []}
        (d / "tokenizer.json").write_text(json.dumps(spec))
        match = "Unigram" if case == "unigram" else "WordLevel"
    elif case == "unknown_normalizer":
        spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": ""}
        (d / "tokenizer.json").write_text(json.dumps(spec))
        match = "Precompiled"
    elif case == "unknown_class":
        shutil.copy(os.path.join(tok_dirs["qwen2"], "tokenizer.json"), d)
        (d / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "T5Tokenizer"}))
        match = "T5TokenizerFast"
    else:
        spec["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = r"\p{Han}+"
        (d / "tokenizer.json").write_text(json.dumps(spec))
        match = "Han"
    with pytest.raises(NotImplementedError, match=match):
        build_tokenizer(str(d), 1024)


# -- the Unicode tables, at every code point -------------------------------------
CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


def _oracle_class(pattern):
    """The code points the Split regex of tokenizers matches alone."""
    split = pre_tokenizers.Split(Regex(pattern), "removed")
    kept = set()
    for i in range(0, len(CODE_POINTS), 4096):
        for piece, _ in split.pre_tokenize_str("".join(map(chr, CODE_POINTS[i:i + 4096]))):
            kept.update(map(ord, piece))
    return set(CODE_POINTS) - kept


def _port_class(pattern):
    rx = hf_tokenizer.translate_regex(pattern)
    return {c for c in CODE_POINTS if rx.fullmatch(chr(c))}


@pytest.mark.parametrize("pattern", [r"\p{L}", r"\p{N}", r"\p{M}", r"\p{P}", r"\p{S}", r"\s",
                                     r"\w", r"\d", r"[^\s\p{L}\p{N}]"])
def test_regex_classes_match_tokenizers(pattern):
    assert _port_class(pattern) == _oracle_class(pattern)


def _chunks(sep):
    """All code points in chunks of 4096, each joined by ``sep``."""
    cps = [c for c in CODE_POINTS if chr(c) not in sep]
    return [sep.join(map(chr, cps[i:i + 4096])) for i in range(0, len(cps), 4096)]


NORMALIZER_CASES = {
    name: dict(type=name) for name in ("NFC", "NFD", "NFKC", "NFKD", "Lowercase",
                                       "StripAccents")}
NORMALIZER_CASES.update({
    "Bert_clean": dict(type="BertNormalizer", clean_text=True, handle_chinese_chars=False,
                       strip_accents=False, lowercase=False),
    "Bert_chinese": dict(type="BertNormalizer", clean_text=False, handle_chinese_chars=True,
                         strip_accents=False, lowercase=False),
    "Bert_strip_accents": dict(type="BertNormalizer", clean_text=False,
                               handle_chinese_chars=False, strip_accents=True,
                               lowercase=False),
    "Bert_lowercase": dict(type="BertNormalizer", clean_text=True, handle_chinese_chars=True,
                           strip_accents=None, lowercase=True),
})


@pytest.mark.parametrize("name", list(NORMALIZER_CASES))
def test_normalizers_match_tokenizers_at_every_code_point(name):
    """Every code point between two ``|`` (a starter that nothing composes
    with and every normalizer keeps), then sequences of marks and bases
    (reordering, composition around the code points tokenizers keeps)."""
    spec = NORMALIZER_CASES[name]
    kw = {k: v for k, v in spec.items() if k != "type"}
    oracle = getattr(normalizers, spec["type"])(**kw)
    port = hf_tokenizer._Normalizer(spec)
    for chunk in _chunks("|"):
        want = oracle.normalize_str(chunk)
        if port(chunk) != want:
            bad = [hex(ord(c)) for c in chunk[::2] if port(c) != oracle.normalize_str(c)]
            pytest.fail(f"{name}: {bad[:20]}")
    rng = np.random.default_rng(0)
    marks = list(range(0x300, 0x370)) + [0x1DF6, 0x1E08F, 0x11930, 0x11935, 0x11938, 0x1715]
    bases = [ord(c) for c in "aeoAE"] + [0x11935, 0x1100, 0x1161, 0xAC00, 0x3099]
    for _ in range(2000):
        s = "".join(chr(int(rng.choice(bases if i == 0 else marks + bases)))
                    for i in range(int(rng.integers(1, 6))))
        assert port(s) == oracle.normalize_str(s), [hex(ord(c)) for c in s]


@pytest.mark.parametrize("name", ["BertPreTokenizer", "Punctuation", "Digits", "Whitespace",
                                  "Metaspace"])
def test_pre_tokenizers_match_tokenizers_at_every_code_point(name):
    """Every code point between two letters, all of a chunk in one string."""
    kw = {"Digits": {"individual_digits": True}}.get(name, {})
    oracle = getattr(pre_tokenizers, name)(**kw)
    port = hf_tokenizer._PreTokenizer(dict(type=name, **kw), False)
    cps = CODE_POINTS
    for i in range(0, len(cps), 4096):
        text = "".join("a" + chr(c) + "b" for c in cps[i:i + 4096])
        want = [p for p, _ in oracle.pre_tokenize_str(text)]
        assert [p for p, _ in port([(text, True)])] == want, (name, hex(cps[i]))


# -- the chip run's tokenizer ----------------------------------------------------
def test_chip_smoke_tokenizer_digest_matches_hf(tmp_path):
    """The TinyLlama-shaped tokenizer.json that chip_smoke.py writes (32,000
    entries), run through transformers over the hllm_tokenizer phase's
    PRETRAINED_ITEMS item texts, gives the digest the script holds the
    card's run to; so does the port."""
    d = str(tmp_path / "tok")
    os.makedirs(d)
    _write_config(d, "llama", chip_smoke.TINYLLAMA_1B["vocab_size"])
    cfg = chip_smoke.hllm_config(d, str(tmp_path))
    n = chip_smoke.PRETRAINED_ITEMS
    texts = chip_smoke.rendered_texts(cfg, chip_smoke.tokenizer_item_table(n, seed=0), n)
    chip_smoke.write_llama_tokenizer(d, texts, chip_smoke.TINYLLAMA_1B["vocab_size"], seed=0)
    with open(os.path.join(d, "tokenizer.json")) as fh:
        assert len(json.load(fh)["model"]["vocab"]) == 32_000
    ref = jax_build_tokenizer(d, 32_000)
    assert not isinstance(ref, JaxHashTokenizer)
    T = cfg["MAX_TEXT_LENGTH"]
    assert T == chip_smoke.TOKENIZER_MAX_LENGTH
    want = [ref.encode(t, T) for t in texts]
    ours = build_tokenizer(d, 32_000)
    assert [ours.encode(t, T) for t in texts] == want
    assert chip_smoke.ids_digest(want) == chip_smoke.TOKENIZER_DIGEST
    # byte fallback runs (CJK, emoji, accented letters outside the alphabet)
    assert any(3 <= i < 259 for ids in want for i in ids)


def test_token_cache_key_names_the_tokenizer(tok_dirs, tmp_path):
    """A corpus token matrix written under the hash tokenizer is not served
    once a tokenizer.json of the same vocabulary size appears in the
    directory; a repeat with the same files hits."""
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.data.textset import ItemTextCache

    data = InMemoryInteractionData(num_users=4, num_items=50, seq_len=8, seed=0,
                                   item_texts=True, max_filler_words=8)
    d = tmp_path / "tower"
    d.mkdir()
    _write_config(str(d), "llama", 1024)
    cache_dir = str(tmp_path / "cache")

    def cache():
        return ItemTextCache(data, build_tokenizer(str(d), 1024), ["title", "description"],
                             "", 24)

    hashed = cache()
    assert isinstance(hashed.tokenizer, HashTokenizer)
    hashed.build_disk_cache(cache_dir, "ds", 50)
    assert cache().load_disk_cache(cache_dir, "ds", 50)  # the hash tokenizer again: a hit
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        shutil.copy(os.path.join(tok_dirs["llama_legacy_layout"], name), d)
    hf = cache()
    assert isinstance(hf.tokenizer, hf_tokenizer.HFTokenizer)
    assert hf.tokenizer.vocab_size < 1024
    assert not hf.load_disk_cache(cache_dir, "ds", 50)
    hf.build_disk_cache(cache_dir, "ds", 50)
    again = cache()
    assert again.load_disk_cache(cache_dir, "ds", 50)
    want = ItemTextCache(data, build_tokenizer(str(d), 1024), ["title", "description"], "", 24)
    for a, b in zip(again.batch(np.arange(50)), want.batch(np.arange(50))):
        np.testing.assert_array_equal(a, b)
    # another tokenizer.json of the same vocabulary: a miss
    spec = json.loads((d / "tokenizer.json").read_text())
    spec["normalizer"]["normalizers"][0]["prepend"] = "▁▁"
    (d / "tokenizer.json").write_text(json.dumps(spec))
    assert not cache().load_disk_cache(cache_dir, "ds", 50)
