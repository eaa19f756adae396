r"""HF tokenizers read from a pretrain directory, in plain Python (the
counterpart of what ``AutoTokenizer.from_pretrained(dir,
local_files_only=True, trust_remote_code=True)`` builds for
``mhrec_tpu/data/textset.py:74-88``).

The port depends on none of ``transformers``, ``tokenizers``, ``regex``,
``sentencepiece``, ``protobuf`` or ``tiktoken``, so this module reads the
tokenizer files itself and runs the ``tokenizer.json`` pipeline with the
standard library (``json``, ``re``, ``unicodedata``) only. ``encode(text,
max_length)`` gives the ids of HF's ``tok.encode(text, truncation=True,
max_length=max_length)``:

1. added tokens split out of the raw text first, leftmost-longest, honouring
   ``normalized``, ``lstrip``, ``rstrip`` and ``single_word`` (tokens with
   ``normalized: true`` are matched in each piece after normalizing it);
2. normalizer: ``Sequence``, ``Prepend``, ``Replace``, ``NFC`` / ``NFD`` /
   ``NFKC`` / ``NFKD``, ``Lowercase``, ``StripAccents``, ``BertNormalizer``,
   ``Strip``, ``Precompiled`` (a SentencePiece charsmap, applied by extended
   grapheme clusters as ``tokenizers``' ``spm_precompiled`` does);
3. pre-tokenizer: ``Sequence``, ``Metaspace``, ``Split`` (string or regex),
   ``ByteLevel``, ``BertPreTokenizer``, ``Whitespace``, ``Punctuation``,
   ``Digits``;
4. model: ``BPE`` (merges by rank, byte fallback, ``fuse_unk``, the
   continuing-subword prefix and end-of-word suffix, ``ignore_merges``,
   GPT-2's byte map under ``ByteLevel``; merges as ``"a b"`` or as
   ``["a", "b"]``) with a per-word cache, ``WordPiece``, ``Unigram``
   (Viterbi over the scores, unknowns fused, byte fallback) or
   ``WordLevel``;
5. post-processor: ``TemplateProcessing``, ``BertProcessing``,
   ``RobertaProcessing``, ``ByteLevel``, ``Sequence`` (a single sequence).
   The content is cut to ``max_length`` less the specials the post-processor
   adds, keeping the first tokens; where ``max_length`` is below that count
   HF's unsigned subtraction wraps and nothing is cut.

``vocab_size`` is the model's vocabulary without the added tokens, what
HF's ``tok.vocab_size`` counts and the vocabulary guard compares.

``tokenizer_config.json`` is read as ``transformers`` 4.57 reads it. The
class comes from its ``tokenizer_class``, else from ``config.json``'s
``tokenizer_class`` or ``model_type``. The classes whose ``__init__``
rebuilds the template from ``add_bos_token`` / ``add_eos_token``
(``update_post_processor``) are the fast Llama, CodeLlama, Gemma, GPT-NeoX
and Cohere tokenizers; this module implements Llama, Gemma and GPT-NeoX
among them, with ``PreTrainedTokenizerFast``, Qwen2, GPT-2 and BERT, and
raises on any other class. Special tokens the config names and
``tokenizer.json`` lacks are added as HF adds them; a top-level
``ByteLevel`` pre-tokenizer takes the config's ``add_prefix_space`` (default
false); BERT's normalizer takes ``do_lower_case``, ``strip_accents`` and
``tokenize_chinese_chars``. ``legacy`` changes nothing when
``tokenizer.json`` defines the tokenizer. Without ``tokenizer.json`` (and
for Llama whenever the config sets ``add_prefix_space``, ``from_slow``) the
pipeline is the one ``transformers``' converters build from the slow
files: ``BertConverter`` from ``vocab.txt``, ``GPT2Converter`` /
``Qwen2Converter`` from ``vocab.json`` / ``merges.txt``, ``LlamaConverter``
/ ``GemmaConverter`` from a SentencePiece ``tokenizer.model``
(``sentencepiece.py``) and ``TikTokenConverter`` from a tiktoken one.
``added_tokens.json`` counts where the config has no
``added_tokens_decoder``. Baichuan's remote-code class is recognized by
name in ``auto_map`` and run natively (``sentencepiece.SlowSpmTokenizer``).

Unicode: ``re`` has no ``\p{..}``, so the regexes of ``Split`` and
``ByteLevel`` are translated with classes built once from ``unicodedata``.
``tokenizers`` 0.22 brings tables of its own: Unicode 16.0 for its regex
engine (Oniguruma), 17.0 for Rust's ``char`` methods, an older table
(``unicode_categories``) for BERT's punctuation, control and mark tests,
and an older normalization table. Python 3.12's ``unicodedata`` is 15.0.0,
so the tables below list where ``tokenizers`` differs from it;
``tests/test_torch_tokenizer.py`` holds every code point to ``tokenizers``.
A ``\p{..}`` other than a general category, or a regex construct the
translation does not know, raises and names the pattern.

What this module does not read raises ``NotImplementedError`` naming the
file or the component: BPE dropout, an unknown component, class or
remote-code class, a malformed file, a ``*.tiktoken`` file (which
``transformers`` reads for none of these families).
"""

from __future__ import annotations

import base64
import bisect
import functools
import hashlib
import heapq
import json
import os
import re
import string
import unicodedata
from typing import Dict, List, Optional, Tuple

from mhrec_tpu_torch.data import sentencepiece

# -- Unicode tables: where tokenizers 0.22 differs from Python 3.12's 15.0 ----
# general categories of Unicode 16.0 (Oniguruma, Rust's char methods) that
# Python's 15.0 lacks: (first, last, category)
_GC16 = (
    (0x00897, 0x00897, "Mn"), (0x01B4E, 0x01B4F, "Po"), (0x01B7F, 0x01B7F, "Po"),
    (0x01C89, 0x01C89, "Lu"), (0x01C8A, 0x01C8A, "Ll"), (0x02427, 0x02429, "So"),
    (0x02FFC, 0x02FFF, "So"), (0x031E4, 0x031E5, "So"), (0x031EF, 0x031EF, "So"),
    (0x0A7CB, 0x0A7CC, "Lu"), (0x0A7CD, 0x0A7CD, "Ll"), (0x0A7DA, 0x0A7DA, "Lu"),
    (0x0A7DB, 0x0A7DB, "Ll"), (0x0A7DC, 0x0A7DC, "Lu"), (0x105C0, 0x105F3, "Lo"),
    (0x10D40, 0x10D49, "Nd"), (0x10D4A, 0x10D4D, "Lo"), (0x10D4E, 0x10D4E, "Lm"),
    (0x10D4F, 0x10D4F, "Lo"), (0x10D50, 0x10D65, "Lu"), (0x10D69, 0x10D6D, "Mn"),
    (0x10D6E, 0x10D6E, "Pd"), (0x10D6F, 0x10D6F, "Lm"), (0x10D70, 0x10D85, "Ll"),
    (0x10D8E, 0x10D8F, "Sm"), (0x10EC2, 0x10EC4, "Lo"), (0x10EFC, 0x10EFC, "Mn"),
    (0x11380, 0x11389, "Lo"), (0x1138B, 0x1138B, "Lo"), (0x1138E, 0x1138E, "Lo"),
    (0x11390, 0x113B5, "Lo"), (0x113B7, 0x113B7, "Lo"), (0x113B8, 0x113BA, "Mc"),
    (0x113BB, 0x113C0, "Mn"), (0x113C2, 0x113C2, "Mc"), (0x113C5, 0x113C5, "Mc"),
    (0x113C7, 0x113CA, "Mc"), (0x113CC, 0x113CD, "Mc"), (0x113CE, 0x113CE, "Mn"),
    (0x113CF, 0x113CF, "Mc"), (0x113D0, 0x113D0, "Mn"), (0x113D1, 0x113D1, "Lo"),
    (0x113D2, 0x113D2, "Mn"), (0x113D3, 0x113D3, "Lo"), (0x113D4, 0x113D5, "Po"),
    (0x113D7, 0x113D8, "Po"), (0x113E1, 0x113E2, "Mn"), (0x116D0, 0x116E3, "Nd"),
    (0x1171E, 0x1171E, "Mc"), (0x11BC0, 0x11BE0, "Lo"), (0x11BE1, 0x11BE1, "Po"),
    (0x11BF0, 0x11BF9, "Nd"), (0x11F5A, 0x11F5A, "Mn"), (0x13460, 0x143FA, "Lo"),
    (0x16100, 0x1611D, "Lo"), (0x1611E, 0x16129, "Mn"), (0x1612A, 0x1612C, "Mc"),
    (0x1612D, 0x1612F, "Mn"), (0x16130, 0x16139, "Nd"), (0x16D40, 0x16D42, "Lm"),
    (0x16D43, 0x16D6A, "Lo"), (0x16D6B, 0x16D6C, "Lm"), (0x16D6D, 0x16D6F, "Po"),
    (0x16D70, 0x16D79, "Nd"), (0x18CFF, 0x18CFF, "Lo"), (0x1CC00, 0x1CCEF, "So"),
    (0x1CCF0, 0x1CCF9, "Nd"), (0x1CD00, 0x1CEB3, "So"), (0x1E5D0, 0x1E5ED, "Lo"),
    (0x1E5EE, 0x1E5EF, "Mn"), (0x1E5F0, 0x1E5F0, "Lo"), (0x1E5F1, 0x1E5FA, "Nd"),
    (0x1E5FF, 0x1E5FF, "Po"), (0x1F8B2, 0x1F8BB, "So"), (0x1F8C0, 0x1F8C1, "So"),
    (0x1FA89, 0x1FA89, "So"), (0x1FA8F, 0x1FA8F, "So"), (0x1FABE, 0x1FABE, "So"),
    (0x1FAC6, 0x1FAC6, "So"), (0x1FADC, 0x1FADC, "So"), (0x1FADF, 0x1FADF, "So"),
    (0x1FAE9, 0x1FAE9, "So"), (0x1FBCB, 0x1FBEF, "So"), (0x2EBF0, 0x2EE5D, "Lo"),
)

# BERT's punctuation test (unicode_categories, older than 15.0): P* of
# Python's table, less _OLD_P_DROP, plus _OLD_P_ADD, plus ASCII punctuation
_OLD_P_DROP = (
    (0x0061D, 0x0061D), (0x009FD, 0x009FD), (0x00A76, 0x00A76), (0x00C77, 0x00C77),
    (0x00C84, 0x00C84), (0x01B7D, 0x01B7E), (0x02E43, 0x02E4F), (0x02E52, 0x02E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89), (0x1144B, 0x1144F),
    (0x1145A, 0x1145B), (0x1145D, 0x1145D), (0x11660, 0x1166C), (0x116B9, 0x116B9),
    (0x1183B, 0x1183B), (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09), (0x11C41, 0x11C45),
    (0x11C70, 0x11C71), (0x11EF7, 0x11EF8), (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF),
    (0x12FF1, 0x12FF2), (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F),
)

_OLD_P_ADD = (
    (0x0166D, 0x0166D), (0x111C9, 0x111C9),
)

# BERT's control test: Cc, Cf, Co of Python's table less _OLD_C_DROP
_OLD_C_DROP = (
    (0x00890, 0x00891), (0x008E2, 0x008E2), (0x110CD, 0x110CD), (0x13430, 0x1343F),
)

# the mark test of the StripAccents normalizer: M* of Python's
# table less _OLD_M_DROP, plus _OLD_M_ADD
_OLD_M_DROP = (
    (0x007FD, 0x007FD), (0x00898, 0x0089F), (0x008CA, 0x008D3), (0x009FE, 0x009FE),
    (0x00AFA, 0x00AFF), (0x00B55, 0x00B55), (0x00C04, 0x00C04), (0x00C3C, 0x00C3C),
    (0x00CF3, 0x00CF3), (0x00D00, 0x00D00), (0x00D3B, 0x00D3C), (0x00D81, 0x00D81),
    (0x00EBA, 0x00EBA), (0x00ECE, 0x00ECE), (0x01715, 0x01715), (0x0180F, 0x0180F),
    (0x01ABF, 0x01ACE), (0x01CF7, 0x01CF7), (0x01DF6, 0x01DFA), (0x0A82C, 0x0A82C),
    (0x0A8FF, 0x0A8FF), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF),
    (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070), (0x11073, 0x11074),
    (0x110C2, 0x110C2), (0x11145, 0x11146), (0x111C9, 0x111C9), (0x111CE, 0x111CF),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x1145E, 0x1145E), (0x1182C, 0x1183A),
    (0x11930, 0x11935), (0x11937, 0x11938), (0x1193B, 0x1193E), (0x11940, 0x11940),
    (0x11942, 0x11943), (0x119D1, 0x119D7), (0x119DA, 0x119E0), (0x119E4, 0x119E4),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A39), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A5B), (0x11A8A, 0x11A99), (0x11D31, 0x11D36), (0x11D3A, 0x11D3A),
    (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D8A, 0x11D8E),
    (0x11D90, 0x11D91), (0x11D93, 0x11D97), (0x11EF3, 0x11EF6), (0x11F00, 0x11F01),
    (0x11F03, 0x11F03), (0x11F34, 0x11F3A), (0x11F3E, 0x11F42), (0x13440, 0x13440),
    (0x13447, 0x13455), (0x16F4F, 0x16F4F), (0x16F7F, 0x16F87), (0x16FE4, 0x16FE4),
    (0x16FF0, 0x16FF1), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46), (0x1E08F, 0x1E08F),
    (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),
)

_OLD_M_ADD = (
    (0x01CF2, 0x01CF3),
)

# the nonspacing-mark test of BERT's strip_accents (after NFD): Mn of
# Python's table less _BERT_MN_DROP, plus _BERT_MN_ADD
_BERT_MN_DROP = (
    (0x00340, 0x00341), (0x00343, 0x00344), (0x007FD, 0x007FD), (0x00898, 0x0089F),
    (0x008CA, 0x008E1), (0x009FE, 0x009FE), (0x00AFA, 0x00AFF), (0x00B55, 0x00B55),
    (0x00C04, 0x00C04), (0x00C3C, 0x00C3C), (0x00C48, 0x00C48), (0x00D00, 0x00D00),
    (0x00D3B, 0x00D3C), (0x00D81, 0x00D81), (0x00EBA, 0x00EBA), (0x00ECE, 0x00ECE),
    (0x00F73, 0x00F73), (0x00F75, 0x00F76), (0x00F78, 0x00F78), (0x00F81, 0x00F81),
    (0x00F93, 0x00F93), (0x00F9D, 0x00F9D), (0x00FA2, 0x00FA2), (0x00FA7, 0x00FA7),
    (0x00FAC, 0x00FAC), (0x00FB9, 0x00FB9), (0x0180F, 0x0180F), (0x01885, 0x01886),
    (0x01ABF, 0x01ACE), (0x01DF6, 0x01DFB), (0x0A82C, 0x0A82C), (0x0A8C5, 0x0A8C5),
    (0x0A8FF, 0x0A8FF), (0x0A9BD, 0x0A9BD), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070),
    (0x11073, 0x11074), (0x110C2, 0x110C2), (0x1112E, 0x1112F), (0x111C9, 0x111C9),
    (0x111CF, 0x111CF), (0x1123E, 0x1123E), (0x11241, 0x11241), (0x1133B, 0x1133B),
    (0x11438, 0x1143F), (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E),
    (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C), (0x1193E, 0x1193E),
    (0x11943, 0x11943), (0x119D4, 0x119D7), (0x119DA, 0x119DB), (0x119E0, 0x119E0),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A38), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96), (0x11A98, 0x11A99),
    (0x11C30, 0x11C36), (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7),
    (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6), (0x11D31, 0x11D36),
    (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45), (0x11D47, 0x11D47),
    (0x11D90, 0x11D91), (0x11D95, 0x11D95), (0x11D97, 0x11D97), (0x11EF3, 0x11EF4),
    (0x11F00, 0x11F01), (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F42),
    (0x13440, 0x13440), (0x13447, 0x13455), (0x16F4F, 0x16F4F), (0x16FE4, 0x16FE4),
    (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46), (0x1E000, 0x1E006), (0x1E008, 0x1E018),
    (0x1E01B, 0x1E021), (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F),
    (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),
    (0x1E944, 0x1E94A),
)

_BERT_MN_ADD = (
    (0x01734, 0x01734),
)

# lowercase mappings of Rust's char::to_lowercase that Python's lacks:
# (first, last, offset)
_LOWER16 = (
    (0x01C89, 0x01C89, 1), (0x0A7CB, 0x0A7CB, -42343), (0x0A7CC, 0x0A7CC, 1),
    (0x0A7CE, 0x0A7CE, 1), (0x0A7D2, 0x0A7D2, 1), (0x0A7D4, 0x0A7D4, 1),
    (0x0A7DA, 0x0A7DA, 1), (0x0A7DC, 0x0A7DC, -42561), (0x10D50, 0x10D65, 32),
    (0x16EA0, 0x16EB8, 27),
)

# code points the normalization table of tokenizers neither decomposes nor
# composes and treats as starters (combining class 0): kept as they are and
# normalized around, in every form
_NF_KEEP = (
    (0x007FD, 0x007FD), (0x00898, 0x0089F), (0x008CA, 0x008D3), (0x009FE, 0x009FE),
    (0x00C3C, 0x00C3C), (0x00D3B, 0x00D3C), (0x00EBA, 0x00EBA), (0x01715, 0x01715),
    (0x01ABF, 0x01ACE), (0x01DF6, 0x01DFA), (0x0A82C, 0x0A82C), (0x10D24, 0x10D27),
    (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x1133B, 0x1133B), (0x1145E, 0x1145E), (0x11839, 0x1183A),
    (0x11930, 0x11930), (0x11938, 0x11938), (0x1193D, 0x1193E), (0x11943, 0x11943),
    (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99),
    (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97), (0x11F41, 0x11F42),
    (0x16FF0, 0x16FF1), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),
)

# likewise, in the compatibility forms only
_NFK_KEEP = (
    (0x032FF, 0x032FF), (0x0A7F2, 0x0A7F4), (0x0AB69, 0x0AB69), (0x10781, 0x10785),
    (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x1E030, 0x1E06D), (0x1F16C, 0x1F16C),
    (0x1FBF0, 0x1FBF9),
)

# Rust's char::is_whitespace (White_Space) and Oniguruma's \s
_WS = frozenset(map(chr, (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
                         *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                         0x3000)))
# the word characters of Oniguruma's \w beyond L, M, Nd, Nl, Pc
_W_EXTRA = ((0x000B2, 0x000B3), (0x000B9, 0x000B9), (0x000BC, 0x000BE), (0x024B6, 0x024E9),
            (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))
# numeric code points of Rust's char::is_numeric (Unicode 17.0) beyond
# Unicode 16.0's N* (the Digits pre-tokenizer)
_NUMERIC17 = ((0x11DE0, 0x11DE9), (0x16FF4, 0x16FF6))
# BERT's CJK blocks (tokenizers' is_chinese_char)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _chars(ranges) -> frozenset:
    return frozenset(chr(c) for r in ranges for c in range(r[0], r[1] + 1))


class _Tables:
    """The per-character tests, built on first use."""

    def __init__(self):
        self.gc16 = {chr(c): g for a, b, g in _GC16 for c in range(a, b + 1)}
        self.lower16 = {chr(c): chr(c + d) for a, b, d in _LOWER16 for c in range(a, b + 1)}
        self.p_drop, self.p_add = _chars(_OLD_P_DROP), _chars(_OLD_P_ADD)
        self.c_drop = _chars(_OLD_C_DROP)
        self.m_drop, self.m_add = _chars(_OLD_M_DROP), _chars(_OLD_M_ADD)
        self.mn_drop, self.mn_add = _chars(_BERT_MN_DROP), _chars(_BERT_MN_ADD)
        self.nf_keep = _chars(_NF_KEEP)
        self.nfk_keep = self.nf_keep | _chars(_NFK_KEEP)
        self.numeric17 = _chars(_NUMERIC17)
        self._ranges = None

    def category(self, ch: str) -> str:
        """Unicode 16.0's general category."""
        return self.gc16.get(ch) or unicodedata.category(ch)

    def class_ranges(self, name: str) -> List[Tuple[int, int]]:
        """Code point ranges of a general category (``L``, ``Lu``, ...) or of
        ``\\w`` (``w``) under Unicode 16.0, built in one pass."""
        if self._ranges is None:
            by_cat: Dict[str, List[List[int]]] = {}
            for c in range(0x110000):
                g = self.category(chr(c))
                rs = by_cat.setdefault(g, [])
                if rs and rs[-1][1] == c - 1:
                    rs[-1][1] = c
                else:
                    rs.append([c, c])
            self._ranges = {k: [tuple(r) for r in v] for k, v in by_cat.items()}
            for major in "LMNPSZC":
                self._ranges[major] = _merge_ranges(
                    r for k, v in by_cat.items() if k[0] == major for r in v)
            word = [r for k in ("L", "M", "Nd", "Nl", "Pc") for r in self._ranges[k]]
            self._ranges["w"] = _merge_ranges(word + list(_W_EXTRA))
            # Rust regex's \w (Alphabetic, M, Nd, Pc, Join_Control)
            self._ranges["rust_w"] = _merge_ranges(
                word + [r for r in _W_EXTRA if r[0] > 0xFF] + [(0x200C, 0x200D)])
        return self._ranges[name]


def _merge_ranges(ranges) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(r) for r in out]


@functools.lru_cache(maxsize=1)
def _tables() -> _Tables:
    return _Tables()


@functools.lru_cache(maxsize=None)
def _is_bert_punc(ch: str) -> bool:
    if ch.isascii():
        return ch in string.punctuation
    t = _tables()
    return (unicodedata.category(ch)[0] == "P" and ch not in t.p_drop) or ch in t.p_add


@functools.lru_cache(maxsize=None)
def _is_bert_control(ch: str) -> bool:
    return (ch not in "\t\n\r" and unicodedata.category(ch) in ("Cc", "Cf", "Co")
            and ch not in _tables().c_drop)


@functools.lru_cache(maxsize=None)
def _is_old_mark(ch: str) -> bool:
    t = _tables()
    return (unicodedata.category(ch)[0] == "M" and ch not in t.m_drop) or ch in t.m_add


@functools.lru_cache(maxsize=None)
def _is_bert_mark(ch: str) -> bool:
    t = _tables()
    return (unicodedata.category(ch) == "Mn" and ch not in t.mn_drop) or ch in t.mn_add


@functools.lru_cache(maxsize=None)
def _is_numeric(ch: str) -> bool:
    return _tables().category(ch)[0] == "N" or ch in _tables().numeric17


@functools.lru_cache(maxsize=None)
def _lower(ch: str) -> str:
    return _tables().lower16.get(ch) or ch.lower()


@functools.lru_cache(maxsize=None)
def _is_cjk(ch: str) -> bool:
    c = ord(ch)
    return any(a <= c <= b for a, b in _CJK)


@functools.lru_cache(maxsize=None)
def _is_word_char(ch: str) -> bool:
    """Rust regex's ``\\w`` (the added tokens' ``single_word`` test)."""
    ranges, c = _tables().class_ranges("rust_w"), ord(ch)
    i = bisect.bisect_right(ranges, (c, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= c <= ranges[i][1]


def _normalize_form(form: str, s: str) -> str:
    """``unicodedata.normalize`` around the code points tokenizers' older
    table keeps (each a starter that composes with nothing)."""
    if s.isascii():
        return s
    keep = _tables().nfk_keep if form in ("NFKC", "NFKD") else _tables().nf_keep
    if not any(ch in keep for ch in s):
        return unicodedata.normalize(form, s)
    out, start = [], 0
    for i, ch in enumerate(s):
        if ch in keep:
            out.append(unicodedata.normalize(form, s[start:i]))
            out.append(ch)
            start = i + 1
    out.append(unicodedata.normalize(form, s[start:]))
    return "".join(out)


# -- regexes: Oniguruma syntax → Python's re ----------------------------------
_WS_RANGES = _merge_ranges((ord(c), ord(c)) for c in _WS)


def _complement(ranges) -> List[Tuple[int, int]]:
    out, nxt = [], 0
    for a, b in ranges:
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= 0x10FFFF:
        out.append((nxt, 0x10FFFF))
    return out


def _class_body(ranges) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges)


_GC_NAMES = frozenset("L Lu Ll Lt Lm Lo M Mn Mc Me N Nd Nl No P Pc Pd Ps Pe Pi Pf Po "
                      "S Sm Sc Sk So Z Zs Zl Zp C Cc Cf Co Cn".split())


def _escape_ranges(esc: str, name: Optional[str], pattern: str):
    """(ranges, negated) of a class escape."""
    if esc in "pP":
        if name not in _GC_NAMES or name in ("C", "Cn"):
            raise NotImplementedError(f"regex class \\{esc}{{{name}}} in {pattern!r}")
        return _tables().class_ranges(name), esc == "P"
    base = {"s": _WS_RANGES, "d": None, "w": None}[esc.lower()]
    if base is None:
        base = _tables().class_ranges("Nd" if esc.lower() == "d" else "w")
    return base, esc.isupper()


def translate_regex(pattern: str) -> "re.Pattern":
    """Compile an Oniguruma pattern of a ``tokenizer.json`` as Python's
    ``re``: ``\\p{..}`` / ``\\P{..}`` (general categories), ``\\s``, ``\\d``
    and ``\\w`` (and their negations) become explicit classes of the tables
    above; other escapes of letters, POSIX brackets, nested classes and
    what ``re`` rejects raise, naming the pattern."""
    out: List[str] = []
    i, n, in_class = 0, len(pattern), False
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            esc = pattern[i + 1]
            if esc in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    j = pattern.find("}", i + 3)
                    if j < 0:
                        raise NotImplementedError(f"regex {pattern!r}")
                    name, i = pattern[i + 3:j], j + 1
                else:
                    name, i = pattern[i + 2:i + 3], i + 3
                if name.startswith("^"):
                    esc, name = ("P" if esc == "p" else "p"), name[1:]
                ranges, neg = _escape_ranges(esc, name, pattern)
            elif esc in "sSdDwW":
                ranges, neg = _escape_ranges(esc, None, pattern)
                i += 2
            elif esc.isalnum() and esc not in "rntfvx":
                raise NotImplementedError(f"regex escape \\{esc} in {pattern!r}")
            elif esc == "x" and i + 2 < n and pattern[i + 2] == "{":
                raise NotImplementedError(f"regex escape \\x{{..}} in {pattern!r}")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                out.append(_class_body(_complement(ranges) if neg else ranges))
            else:
                out.append(("[^" if neg else "[") + _class_body(ranges) + "]")
            continue
        if ch == "[":
            if in_class or pattern.startswith("[:", i + (1 if not in_class else 0)):
                raise NotImplementedError(f"nested or POSIX class in {pattern!r}")
            in_class = True
            out.append("[")
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":  # a leading ] is literal
                out.append("\\]")
                i += 1
            continue
        if ch == "]" and in_class:
            in_class = False
        elif in_class and pattern.startswith("&&", i):
            raise NotImplementedError(f"class intersection in {pattern!r}")
        out.append(ch)
        i += 1
    try:
        return re.compile("".join(out))
    except re.error as e:
        raise NotImplementedError(f"regex {pattern!r}: {e}") from None


# -- splitting as tokenizers' NormalizedString::split --------------------------
def _regex_matches(rx, s: str):
    """[(start, end, is_match)] covering ``s``; an empty match right after
    the previous match is skipped, as Oniguruma's iterator does."""
    out, prev, last_end = [], 0, None
    for m in rx.finditer(s):
        a, b = m.span()
        if a == b and last_end == b:
            continue
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = last_end = b
    if prev != len(s):
        out.append((prev, len(s), False))
    return out


def _char_matches(pred, s: str):
    """Each character for which ``pred`` holds is a match of its own."""
    out, last = [], 0
    for i, ch in enumerate(s):
        if pred(ch):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(s):
        out.append((last, len(s), False))
    return out


def _apply_behavior(matches, behavior: str, invert: bool = False):
    """(start, end) pieces of tokenizers' SplitDelimiterBehavior."""
    if invert:
        matches = [(a, b, not m) for a, b, m in matches]
    if behavior == "Isolated":
        return [(a, b) for a, b, _ in matches]
    if behavior == "Removed":
        return [(a, b) for a, b, m in matches if not m]
    acc: List[List[int]] = []
    if behavior == "MergedWithPrevious":
        prev = False
        for a, b, m in matches:
            if m and not prev and acc:
                acc[-1][1] = b
            else:
                acc.append([a, b])
            prev = m
        return acc
    if behavior == "MergedWithNext":
        prev = False
        for a, b, m in reversed(matches):
            if m and not prev and acc:
                acc[-1][0] = a
            else:
                acc.append([a, b])
            prev = m
        acc.reverse()
        return acc
    if behavior == "Contiguous":
        prev = False
        for a, b, m in matches:
            if m == prev and acc:
                acc[-1][1] = b
            else:
                acc.append([a, b])
            prev = m
        return acc
    raise NotImplementedError(f"split behavior {behavior!r}")


def _split(pieces, fn):
    """Split every piece (text, at the start of the raw text?) by ``fn``:
    text → [(start, end)]; empty pieces are dropped."""
    out = []
    for text, first in pieces:
        for a, b in fn(text):
            if b > a:
                out.append((text[a:b], first and a == 0))
    return out


# -- components -----------------------------------------------------------------
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character map."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs, n = list(bs), 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_MAP = _bytes_to_unicode()
_GPT2_RE = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _pattern(spec, where: str):
    """A ``Split`` / ``Replace`` pattern: a compiled regex of the literal
    string or the translated Oniguruma regex."""
    if not isinstance(spec, dict) or len(spec) != 1:
        raise NotImplementedError(f"{where} pattern {spec!r}")
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return translate_regex(spec["Regex"])
    raise NotImplementedError(f"{where} pattern {spec!r}")


# -- extended grapheme clusters (UAX #29, what tokenizers' Precompiled walks) --
# Other_Grapheme_Extend, the Emoji_Modifier range and the tag characters
_GE_EXTRA = ((0x009BE, 0x009BE), (0x009D7, 0x009D7), (0x00B3E, 0x00B3E), (0x00B57, 0x00B57),
             (0x00BBE, 0x00BBE), (0x00BD7, 0x00BD7), (0x00CC2, 0x00CC2), (0x00CD5, 0x00CD6),
             (0x00D3E, 0x00D3E), (0x00D57, 0x00D57), (0x00DCF, 0x00DCF), (0x00DDF, 0x00DDF),
             (0x01B35, 0x01B35), (0x0200C, 0x0200C), (0x0302E, 0x0302F), (0x0FF9E, 0x0FF9F),
             (0x1133E, 0x1133E), (0x11357, 0x11357), (0x114B0, 0x114B0), (0x114BD, 0x114BD),
             (0x115AF, 0x115AF), (0x11930, 0x11930), (0x1D165, 0x1D165), (0x1D16E, 0x1D172),
             (0x1F3FB, 0x1F3FF), (0x0E0020, 0x0E007F))
# Mc that is not SpacingMark, and the two Lo that are
_SM_DROP = ((0x0102B, 0x0102C), (0x01038, 0x01038), (0x01062, 0x01064), (0x01067, 0x0106D),
            (0x01083, 0x01083), (0x01087, 0x0108C), (0x0108F, 0x0108F), (0x0109A, 0x0109C),
            (0x01A61, 0x01A61), (0x01A63, 0x01A64), (0x0AA7B, 0x0AA7B), (0x0AA7D, 0x0AA7D),
            (0x11720, 0x11721))
_SM_ADD = ((0x00E33, 0x00E33), (0x00EB3, 0x00EB3))
_PREPEND = ((0x00600, 0x00605), (0x006DD, 0x006DD), (0x0070F, 0x0070F), (0x00890, 0x00891),
            (0x008E2, 0x008E2), (0x00D4E, 0x00D4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD),
            (0x111C2, 0x111C3), (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A3A, 0x11A3A),
            (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02))
_EXT_PICT = (
    (0x000A9, 0x000A9), (0x000AE, 0x000AE), (0x0203C, 0x0203C), (0x02049, 0x02049),
    (0x02122, 0x02122), (0x02139, 0x02139), (0x02194, 0x02199), (0x021A9, 0x021AA),
    (0x0231A, 0x0231B), (0x02328, 0x02328), (0x02388, 0x02388), (0x023CF, 0x023CF),
    (0x023E9, 0x023F3), (0x023F8, 0x023FA), (0x024C2, 0x024C2), (0x025AA, 0x025AB),
    (0x025B6, 0x025B6), (0x025C0, 0x025C0), (0x025FB, 0x025FE), (0x02600, 0x02605),
    (0x02607, 0x02612), (0x02614, 0x02685), (0x02690, 0x02705), (0x02708, 0x02712),
    (0x02714, 0x02714), (0x02716, 0x02716), (0x0271D, 0x0271D), (0x02721, 0x02721),
    (0x02728, 0x02728), (0x02733, 0x02734), (0x02744, 0x02744), (0x02747, 0x02747),
    (0x0274C, 0x0274C), (0x0274E, 0x0274E), (0x02753, 0x02755), (0x02757, 0x02757),
    (0x02763, 0x02767), (0x02795, 0x02797), (0x027A1, 0x027A1), (0x027B0, 0x027B0),
    (0x027BF, 0x027BF), (0x02934, 0x02935), (0x02B05, 0x02B07), (0x02B1B, 0x02B1C),
    (0x02B50, 0x02B50), (0x02B55, 0x02B55), (0x03030, 0x03030), (0x0303D, 0x0303D),
    (0x03297, 0x03297), (0x03299, 0x03299), (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F),
    (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E),
    (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA),
    (0x1F400, 0x1F53D), (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F),
    (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945),
    (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _in(ranges, c: int) -> bool:
    return any(a <= c <= b for a, b in ranges)


@functools.lru_cache(maxsize=None)
def _gcb(ch: str) -> str:
    """Grapheme_Cluster_Break of a character (Extended_Pictographic as
    ``Pict`` where it has no other value)."""
    c = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if c == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= c <= 0x1F1FF:
        return "RI"
    if _in(_PREPEND, c):
        return "Prepend"
    g = _tables().category(ch)
    if g in ("Mn", "Me") or _in(_GE_EXTRA, c):
        return "Extend"
    if g in ("Cc", "Zl", "Zp", "Cf"):
        return "Control"
    if 0x1100 <= c <= 0x115F or 0xA960 <= c <= 0xA97C:
        return "L"
    if 0x1160 <= c <= 0x11A7 or 0xD7B0 <= c <= 0xD7C6:
        return "V"
    if 0x11A8 <= c <= 0x11FF or 0xD7CB <= c <= 0xD7FB:
        return "T"
    if 0xAC00 <= c <= 0xD7A3:
        return "LV" if (c - 0xAC00) % 28 == 0 else "LVT"
    if (g == "Mc" and not _in(_SM_DROP, c)) or _in(_SM_ADD, c):
        return "SpacingMark"
    if _in(_EXT_PICT, c):
        return "Pict"
    return "Other"


def _graphemes(s: str) -> List[str]:
    """The extended grapheme clusters of ``s`` (rules GB3-GB13)."""
    if not s:
        return []
    out, start = [], 0
    prev = _gcb(s[0])
    pict = prev == "Pict"          # Pict Extend* so far
    pict_zwj = False               # ... followed by ZWJ
    ri = 1 if prev == "RI" else 0  # regional indicators in the current run
    for i in range(1, len(s)):
        cur = _gcb(s[i])
        if prev == "CR" and cur == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cur in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cur == "T":
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif prev == "ZWJ" and cur == "Pict" and pict_zwj:
            join = True
        elif prev == "RI" and cur == "RI":
            join = ri % 2 == 1
        else:
            join = False
        if not join:
            out.append(s[start:i])
            start = i
        pict_zwj = pict and cur == "ZWJ"
        pict = cur == "Pict" or (pict and cur == "Extend")
        ri = ri + 1 if cur == "RI" and join else (1 if cur == "RI" else 0)
        prev = cur
    out.append(s[start:])
    return out


def _precompiled(charsmap, s: str) -> str:
    """tokenizers' Precompiled normalizer: a grapheme of fewer than 6 bytes
    that a key prefixes becomes the first (shortest) key's string, whole;
    otherwise each character that is a key becomes its string."""
    starts = charsmap.starts
    if not any(map(starts, s)):
        return s
    out = []
    for g in _graphemes(s):
        if len(g.encode("utf-8")) < 6 and starts(g[0]):
            norm = charsmap.shortest(g)
            if norm is not None:
                out.append(norm)
                continue
        for ch in g:
            norm = charsmap.shortest(ch) if starts(ch) else None
            out.append(ch if norm is None else norm)
    return "".join(out)


class _Normalizer:
    """str → str, and whether it can remove characters (what Metaspace's
    ``prepend_scheme: first`` cannot see through: tokenizers tests the
    original offset of a piece's first character)."""

    def __init__(self, spec):
        self.steps = []
        self.removes = False
        self._add(spec)

    def _add(self, spec):
        if spec is None:
            return
        kind = spec.get("type")
        if kind == "Sequence":
            for s in spec["normalizers"]:
                self._add(s)
        elif kind == "Prepend":
            p = spec["prepend"]
            self.steps.append(lambda s: p + s if s else s)
        elif kind == "Replace":
            rx, content = _pattern(spec["pattern"], "Replace"), spec["content"]
            self.steps.append(lambda s: rx.sub(lambda m: content, s))
            self.removes |= content == ""
        elif kind in ("NFC", "NFD", "NFKC", "NFKD"):
            self.steps.append(functools.partial(_normalize_form, kind))
        elif kind == "Lowercase":
            self.steps.append(lambda s: s.lower() if s.isascii() else "".join(map(_lower, s)))
        elif kind == "StripAccents":
            self.steps.append(lambda s: s if s.isascii() else
                              "".join(c for c in s if not _is_old_mark(c)))
            self.removes = True
        elif kind == "BertNormalizer":
            self.steps.append(_bert_normalizer(
                spec.get("clean_text", True), spec.get("handle_chinese_chars", True),
                spec.get("strip_accents"), spec.get("lowercase", True)))
            self.removes = True
        elif kind == "Strip":
            left, right = bool(spec.get("strip_left", True)), bool(spec.get("strip_right", True))
            ws = "".join(sorted(_WS))
            self.steps.append(lambda s: s.lstrip(ws) if left else s)
            self.steps.append(lambda s: s.rstrip(ws) if right else s)
            self.removes |= left
        elif kind == "Precompiled":
            blob = spec.get("precompiled_charsmap")
            try:
                blob = base64.b64decode(blob or "", validate=True)
            except (ValueError, TypeError):
                raise NotImplementedError("Precompiled normalizer: its charsmap is not base64") \
                    from None
            charsmap = sentencepiece.Charsmap(blob, "Precompiled normalizer")
            self.steps.append(functools.partial(_precompiled, charsmap))
            self.removes |= charsmap.removes
        else:
            raise NotImplementedError(f"normalizer {kind!r}")

    def __call__(self, s: str) -> str:
        for step in self.steps:
            s = step(s)
        return s


def _bert_normalizer(clean_text, handle_chinese_chars, strip_accents, lowercase):
    strip = lowercase if strip_accents is None else strip_accents

    def run(s: str) -> str:
        if clean_text:
            s = "".join(" " if (c in "\t\n\r" or c in _WS) else c for c in s
                        if c != "\x00" and c != "\ufffd" and not _is_bert_control(c))
        if handle_chinese_chars and not s.isascii():
            s = "".join(f" {c} " if _is_cjk(c) else c for c in s)
        if strip and not s.isascii():
            s = "".join(c for c in _normalize_form("NFD", s) if not _is_bert_mark(c))
        if lowercase:
            s = s.lower() if s.isascii() else "".join(map(_lower, s))
        return s

    return run


class _PreTokenizer:
    """[(text, first)] → [(text, first)]; ``byte_level`` tells the model to
    map each piece's bytes through GPT-2's map."""

    def __init__(self, spec, removes: bool):
        self.steps = []
        self.byte_level = False
        self._removes = removes
        self._add(spec)

    def _add(self, spec):
        if spec is None:
            return
        kind = spec.get("type")
        if kind == "Sequence":
            for s in spec["pretokenizers"]:
                self._add(s)
        elif kind == "Metaspace":
            self.steps.append(self._metaspace(spec))
        elif kind == "Split":
            rx = _pattern(spec["pattern"], "Split")
            behavior, invert = spec["behavior"], bool(spec.get("invert", False))
            self.steps.append(lambda ps: _split(
                ps, lambda t: _apply_behavior(_regex_matches(rx, t), behavior, invert)))
        elif kind == "ByteLevel":
            self.byte_level = True
            rx = translate_regex(_GPT2_RE) if spec.get("use_regex", True) else None
            prefix = bool(spec.get("add_prefix_space", True))

            def byte_level(ps):
                if prefix:
                    ps = [(t if t.startswith(" ") else " " + t, f) for t, f in ps]
                if rx is None:
                    return ps
                return _split(ps, lambda t: _apply_behavior(_regex_matches(rx, t), "Isolated"))

            self.steps.append(byte_level)
        elif kind == "BertPreTokenizer":
            self.steps.append(lambda ps: _split(_split(
                ps, lambda t: _apply_behavior(_char_matches(_WS.__contains__, t), "Removed")),
                lambda t: _apply_behavior(_char_matches(_is_bert_punc, t), "Isolated")))
        elif kind == "Whitespace":  # \w+|[^\w\s]+ of Rust's regex crate
            w = _class_body(_tables().class_ranges("rust_w"))
            rx = re.compile(f"[{w}]+|[^{w}{_class_body(_WS_RANGES)}]+")
            self.steps.append(lambda ps: _split(
                ps, lambda t: _apply_behavior(_regex_matches(rx, t), "Removed", invert=True)))
        elif kind == "Punctuation":
            behavior = spec.get("behavior", "Isolated")
            self.steps.append(lambda ps: _split(
                ps, lambda t: _apply_behavior(_char_matches(_is_bert_punc, t), behavior)))
        elif kind == "Digits":
            behavior = "Isolated" if spec.get("individual_digits", False) else "Contiguous"
            self.steps.append(lambda ps: _split(
                ps, lambda t: _apply_behavior(_char_matches(_is_numeric, t), behavior)))
        else:
            raise NotImplementedError(f"pre_tokenizer {kind!r}")

    def _metaspace(self, spec):
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # files written before prepend_scheme existed
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
        if scheme == "first" and self._removes:
            raise NotImplementedError(
                "Metaspace prepend_scheme 'first' after a normalizer that removes characters")
        split = bool(spec.get("split", True))

        def run(ps):
            out = []
            for t, first in ps:
                t = t.replace(" ", rep)
                if not t.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                    t = rep + t
                out.append((t, first))
            if not split:
                return out
            return _split(out, lambda t: _apply_behavior(
                _char_matches(rep.__eq__, t), "MergedWithNext"))

        return run

    def __call__(self, pieces):
        for step in self.steps:
            pieces = step(pieces)
        return pieces


class _BPE:
    def __init__(self, spec):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError("BPE dropout")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or None
        self.suffix = spec.get("end_of_word_suffix") or None
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        plen = len(self.prefix.encode()) if self.prefix else 0
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ") if isinstance(m, str) else m
            new = a + b.encode()[plen:].decode("utf-8", "ignore") if plen else a + b
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
            except KeyError as e:
                raise NotImplementedError(f"BPE merge {m!r} outside the vocabulary: {e}") from None
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        ids = self.cache.get(word)
        if ids is None:
            ids = self._tokenize(word)
            if len(self.cache) >= 1_000_000:
                self.cache.clear()
            self.cache[word] = ids
        return ids

    def _tokenize(self, w: str) -> List[int]:
        vocab = self.vocab
        if self.ignore_merges and w in vocab:
            return [vocab[w]]
        ids: List[int] = []
        lens: List[int] = []
        unk = None  # (id, byte length) of the pending unknown
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = ch
            if i > 0 and self.prefix:
                s = self.prefix + s
            if i == last and self.suffix:
                s = s + self.suffix
            nbytes = len(ch.encode())
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    ids.append(unk[0])
                    lens.append(unk[1])
                    unk = None
                ids.append(tid)
                lens.append(nbytes)
                continue
            if self.byte_fallback:
                fb = [vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if all(t is not None for t in fb):
                    ids.extend(fb)
                    lens.extend([1] * len(fb))
                    continue
            if self.unk is not None:
                if self.unk not in vocab:
                    raise ValueError(f"BPE unk token {self.unk!r} is not in the vocabulary")
                if unk is not None and self.fuse_unk:
                    unk = (unk[0], unk[1] + nbytes)
                else:
                    if unk is not None:
                        ids.append(unk[0])
                        lens.append(unk[1])
                    unk = (vocab[self.unk], nbytes)
        if unk is not None:
            ids.append(unk[0])
            lens.append(unk[1])
        return self._merge(ids, lens)

    def _merge(self, ids: List[int], lens: List[int]) -> List[int]:
        """tokenizers' Word::merge_all: the lowest-ranked pair first, the
        leftmost among equals, through a heap of candidate merges."""
        n = len(ids)
        if n < 2:
            return ids
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        heap = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new = heapq.heappop(heap)
            if lens[pos] == 0:
                continue
            right = nxt[pos]
            if right == -1:
                continue
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new:
                continue
            ids[pos] = new
            lens[pos] += lens[right]
            lens[right] = 0
            after = nxt[right]
            nxt[pos] = after
            if after != -1:
                prev[after] = pos
            p = prev[pos]
            if p >= 0:
                m = merges.get((ids[p], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if after != -1:
                m = merges.get((new, ids[after]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, k in zip(ids, lens) if k]


class _WordPiece:
    def __init__(self, vocab: Dict[str, int], unk: str = "[UNK]", prefix: str = "##",
                 max_chars: int = 100):
        self.vocab, self.unk, self.prefix, self.max_chars = vocab, unk, prefix, max_chars
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        ids = self.cache.get(word)
        if ids is None:
            ids = self.cache[word] = self._tokenize(word)
        return ids

    def _unk(self) -> List[int]:
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece unk token {self.unk!r} is not in the vocabulary")
        return [self.vocab[self.unk]]

    def _tokenize(self, w: str) -> List[int]:
        if len(w) > self.max_chars:
            return self._unk()
        out, start = [], 0
        while start < len(w):
            end, cur = len(w), None
            while start < end:
                sub = w[start:end] if start == 0 else self.prefix + w[start:end]
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return self._unk()
            out.append(cur)
            start = end
        return out


class _Unigram:
    """tokenizers' Unigram: the Viterbi path over the pieces' scores (an
    unknown character, where no piece is that character alone, at the
    lowest score less 10), consecutive unknowns fused, then byte fallback
    for an unknown piece whose bytes all have ``<0xNN>`` pieces."""

    def __init__(self, spec):
        pieces = spec.get("vocab") or []
        if not pieces:
            raise NotImplementedError("Unigram model with an empty vocabulary")
        self.pieces = [p for p, _ in pieces]
        self.scores = [float(s) for _, s in pieces]
        self.vocab = {p: i for i, p in enumerate(self.pieces)}
        self.size = len(pieces)
        self.unk_id = spec.get("unk_id")
        if self.unk_id is not None and not 0 <= self.unk_id < self.size:
            raise NotImplementedError(f"Unigram unk_id {self.unk_id} outside the vocabulary")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.unk_score = min(self.scores) - 10.0
        self.max_len = max(len(p) for p in self.pieces)
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        ids = self.cache.get(word)
        if ids is None:
            ids = self._tokenize(word)
            if len(self.cache) >= 1_000_000:
                self.cache.clear()
            self.cache[word] = ids
        return ids

    def _unk(self) -> int:
        if self.unk_id is None:
            raise ValueError("Unigram model without an unk_id met an unknown character")
        return self.unk_id

    def _tokenize(self, w: str) -> List[int]:
        n = len(w)
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        node = [0] * (n + 1)
        vocab, scores = self.vocab, self.scores
        for a in range(n):
            till = best[a]
            single = False
            for b in range(a + 1, min(n, a + self.max_len) + 1):
                pid = vocab.get(w[a:b])
                if pid is None:
                    continue
                cand = scores[pid] + till
                if start[b] == -1 or cand > best[b]:
                    best[b], start[b], node[b] = cand, a, pid
                if b == a + 1:
                    single = True
            if not single:
                cand = self.unk_score + till
                if start[a + 1] == -1 or cand > best[a + 1]:
                    best[a + 1], start[a + 1], node[a + 1] = cand, a, self._unk()
        strings: List[str] = []
        unk: List[str] = []
        end = n
        while end > 0:
            a = start[end]
            if self.unk_id is not None and node[end] == self.unk_id:
                unk.append(w[a:end])
            else:
                if unk:
                    strings.append("".join(reversed(unk)))
                    unk = []
                strings.append(w[a:end])
            end = a
        if unk:
            strings.append("".join(reversed(unk)))
        ids: List[int] = []
        for piece in reversed(strings):
            pid = vocab.get(piece)
            if pid is None and self.byte_fallback:
                fb = [vocab.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                if all(t is not None for t in fb):
                    ids.extend(fb)
                    continue
            ids.append(self._unk() if pid is None else pid)
        return ids


class _WordLevel:
    def __init__(self, spec):
        if not isinstance(spec.get("vocab"), dict):
            raise NotImplementedError("WordLevel model without a vocabulary map")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> List[int]:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk)
            if tid is None:
                raise ValueError(f"WordLevel unk token {self.unk!r} is not in the vocabulary")
        return [tid]


def _model(spec):
    kind = spec.get("type") or ("BPE" if "merges" in spec else None)
    if kind == "BPE":
        return _BPE(spec)
    if kind == "WordPiece":
        return _WordPiece(spec["vocab"], spec.get("unk_token", "[UNK]"),
                          spec.get("continuing_subword_prefix", "##"),
                          spec.get("max_input_chars_per_word", 100))
    if kind == "Unigram":
        return _Unigram(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    raise NotImplementedError(f"model {kind!r}")


def _post_processor(spec) -> Tuple[List[int], List[int]]:
    """(ids before, ids after) the single sequence."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind == "Sequence":
        before, after = [], []
        for s in spec["processors"]:
            b, a = _post_processor(s)
            before, after = b + before, after + a
        return before, after
    if kind == "ByteLevel":
        return [], []
    if kind in ("BertProcessing", "RobertaProcessing"):
        return [spec["cls"][1]], [spec["sep"][1]]
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        before, after, seen = [], [], 0
        for piece in spec["single"]:
            if "Sequence" in piece:
                if piece["Sequence"]["id"] != "A" or seen:
                    raise NotImplementedError(f"template {spec['single']!r}")
                seen = 1
            else:
                (after if seen else before).extend(specials[piece["SpecialToken"]["id"]]["ids"])
        if not seen:
            raise NotImplementedError(f"template {spec['single']!r}")
        return before, after
    raise NotImplementedError(f"post_processor {kind!r}")


class _AddedToken:
    __slots__ = ("content", "id", "single_word", "lstrip", "rstrip", "normalized", "special")

    def __init__(self, content, id, single_word=False, lstrip=False, rstrip=False,
                 normalized=None, special=False):
        self.content, self.id, self.special = content, id, bool(special)
        self.single_word, self.lstrip, self.rstrip = bool(single_word), bool(lstrip), bool(rstrip)
        self.normalized = (not self.special) if normalized is None else bool(normalized)

    def flags(self):
        return (self.content, self.single_word, self.lstrip, self.rstrip, self.normalized,
                self.special)


class HFTokenizer:
    """A ``tokenizer.json`` pipeline (see the module docstring). ``kind`` and
    ``files_digest`` (what ``load_tokenizer`` read) key the token cache."""

    kind = "hf"
    files_digest: Optional[str] = None
    unk_token: Optional[str] = None  # the config's unk_token (convert_tokens_to_ids' fallback)

    def __init__(self, spec: dict, template: Optional[Tuple[List[int], List[int]]] = None):
        if spec.get("model") is None:
            raise NotImplementedError("tokenizer.json without a model")
        self.model = _model(spec["model"])
        self.vocab_size = getattr(self.model, "size", None) or len(self.model.vocab)
        self.normalizer = _Normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _PreTokenizer(spec.get("pre_tokenizer"), self.normalizer.removes)
        self.before, self.after = (template if template is not None
                                   else _post_processor(spec.get("post_processor")))
        self.added: Dict[str, _AddedToken] = {}
        for t in spec.get("added_tokens") or []:
            self.add_token(_AddedToken(t["content"], t["id"], t.get("single_word", False),
                                       t.get("lstrip", False), t.get("rstrip", False),
                                       t.get("normalized"), t.get("special", False)))
        # where no token of the vocabulary holds ▁ after another character, no
        # merge crosses the start of a ▁-run: a word (a whole piece, when
        # there is no pre-tokenizer) splits there exactly, and the per-word
        # cache works
        self._words = None
        m = self.model
        if (isinstance(m, _BPE) and not m.prefix
                and not m.suffix and not m.ignore_merges and "▁" in m.vocab
                and not any(map(re.compile("[^▁]▁").search, m.vocab))):
            self._words = re.compile("(?<=[^▁])(?=▁)")
        self.added_rx = self.normalized_rx = None
        self._refresh()

    # -- added tokens ------------------------------------------------------
    def token_to_id(self, content: str) -> Optional[int]:
        t = self.added.get(content)
        return t.id if t is not None else self.model.vocab.get(content)

    def add_token(self, tok: _AddedToken):
        """tokenizers' AddedVocabulary::add_tokens for one token: a token the
        vocabulary or the added tokens hold keeps its id."""
        if not tok.content:
            return
        old = self.added.get(tok.content)
        if old is not None and old.flags() == tok.flags():
            return
        if tok.id is None:
            tid = self.token_to_id(tok.content)
            if tid is None:
                ids = [t.id for t in self.added.values()]
                size = self.vocab_size
                tid = (size if not ids else max(ids) + 1 if max(ids) >= size or size == 0
                       else size)
            tok.id = tid
        self.added[tok.content] = tok

    def _refresh(self):
        def rx(tokens):
            if not tokens:
                return None
            alts = sorted(tokens, key=lambda c: -len(c))
            return re.compile("|".join(map(re.escape, alts)))

        raw = [t.content for t in self.added.values() if not t.normalized]
        self.added_rx = rx(raw)
        self.normalized_map = {}
        for t in self.added.values():
            if t.normalized:
                key = self.normalizer(t.content)
                self.normalized_map.setdefault(key, t)
        self.normalized_rx = rx([k for k in self.normalized_map if k])

    def _find_added(self, s: str, rx, lookup):
        """[(start, end, token id or None)] as AddedVocabulary::find_matches."""
        if rx is None or not s:
            return [(0, len(s), None)]
        out, start_offset = [], 0
        for m in rx.finditer(s):
            start, stop = m.span()
            tok = lookup(m.group())
            if tok.single_word:
                start_space = start == 0 or not _is_word_char(s[start - 1])
                stop_space = stop == len(s) or not _is_word_char(s[stop])
                if not (start_space and stop_space):
                    continue
            if tok.lstrip:
                j = start
                while j > 0 and s[j - 1] in _WS:
                    j -= 1
                start = max(j, start_offset)
            if tok.rstrip:
                while stop < len(s) and s[stop] in _WS:
                    stop += 1
            if start_offset < start:
                out.append((start_offset, start, None))
            out.append((start, stop, tok.id))
            start_offset = stop
        if start_offset != len(s):
            out.append((start_offset, len(s), None))
        return out

    # -- encoding ------------------------------------------------------------
    def tokenize(self, text: str) -> List[int]:
        """The ids of ``text`` before the post-processor."""
        ids: List[int] = []
        pieces = ([(0, len(text), None)] if self.added_rx is None
                  else self._find_added(text, self.added_rx, self.added.__getitem__))
        for a, b, tid in pieces:
            if tid is not None:
                ids.append(tid)
                continue
            if b <= a:
                continue
            norm = self.normalizer(text[a:b])
            sub = ([(0, len(norm), None)] if self.normalized_rx is None
                   else self._find_added(norm, self.normalized_rx, self.normalized_map.__getitem__))
            for c, d, tid2 in sub:
                if tid2 is not None:
                    ids.append(tid2)
                elif d > c:
                    # the piece's first character is the raw text's first
                    # only when nothing precedes it (Metaspace "first")
                    self._model_ids(norm[c:d], a == 0 and c == 0, ids)
        return ids

    def _model_ids(self, text: str, first: bool, ids: List[int]):
        words = self.pre_tokenizer([(text, first)])
        model = self.model
        for w, _ in words:
            if self.pre_tokenizer.byte_level:
                w = "".join(_BYTE_MAP[b] for b in w.encode())
            if self._words is not None:
                for part in self._words.split(w):
                    ids.extend(model.tokenize(part))
            else:
                ids.extend(model.tokenize(w))

    def encode(self, text: str, max_length: int) -> List[int]:
        """HF's ``tok.encode(text, truncation=True, max_length=max_length)``."""
        ids = self.tokenize(text)
        keep = max_length - len(self.before) - len(self.after)
        if keep >= 0:  # below 0 HF's unsigned subtraction wraps: no cut
            ids = ids[:keep]
        return self.before + ids + self.after


# -- a pretrain directory, as transformers 4.57 resolves it ---------------------
# fast class → (its default special tokens, the (add_bos_token, add_eos_token)
# defaults of a class whose __init__ rebuilds the template, else None)
_EOT = "<|endoftext|>"
_CLASSES = {
    "PreTrainedTokenizerFast": ({}, None),
    "LlamaTokenizerFast": (dict(unk_token="<unk>", bos_token="<s>", eos_token="</s>"),
                           (True, False)),
    "GemmaTokenizerFast": (dict(unk_token="<unk>", bos_token="<bos>", eos_token="<eos>",
                                pad_token="<pad>"), (True, False)),
    "GPTNeoXTokenizerFast": (dict(unk_token=_EOT, bos_token=_EOT, eos_token=_EOT),
                             (False, False)),
    "Qwen2TokenizerFast": (dict(unk_token=_EOT, eos_token=_EOT, pad_token=_EOT), None),
    "GPT2TokenizerFast": (dict(unk_token=_EOT, bos_token=_EOT, eos_token=_EOT), None),
    "BertTokenizerFast": (dict(unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]",
                               cls_token="[CLS]", mask_token="[MASK]"), None),
}
# config.json's model_type → the fast class AutoTokenizer picks
_MODEL_TYPES = {
    **dict.fromkeys(("llama", "mistral", "mixtral"), "LlamaTokenizerFast"),
    **dict.fromkeys(("qwen2", "qwen2_vl", "qwen2_5_vl", "qwen2_moe", "qwen3"),
                    "Qwen2TokenizerFast"),
    **dict.fromkeys(("gemma", "gemma2"), "GemmaTokenizerFast"),
    "gpt_neox": "GPTNeoXTokenizerFast", "gpt2": "GPT2TokenizerFast", "bert": "BertTokenizerFast",
}
# transformers' SPECIAL_TOKENS_ATTRIBUTES, in its order
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token", "additional_special_tokens")
# the files a tokenizer is read from
_TOKENIZER_FILES = ("tokenizer.json", "vocab.txt", "tokenizer.model", "vocab.json", "merges.txt",
                    "tekken.json")
# the files whose bytes name a tokenizer (the token cache's key), with the
# directory's *.tiktoken
_FILES = _TOKENIZER_FILES + ("tokenizer_config.json", "special_tokens_map.json",
                             "added_tokens.json")
# the remote-code class run natively (auto_map's AutoTokenizer entry)
_BAICHUAN = "tokenization_baichuan.BaichuanTokenizer"
# the classes that read a tiktoken tokenizer.model: no slow class, or a
# SentencePiece one that transformers lacks where sentencepiece is not
# installed (PreTrainedTokenizerFast.__init__ then takes TikTokenConverter)
_TIKTOKEN_CLASSES = ("PreTrainedTokenizerFast", "LlamaTokenizerFast", "GemmaTokenizerFast",
                     "GPTNeoXTokenizerFast")
_TIKTOKEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                     r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _read_json(path: str, what: str):
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except ValueError as e:
        raise NotImplementedError(f"{what} {path} is not JSON: {e}") from None


def _tiktoken_files(pretrain_dir: str) -> List[str]:
    return sorted(n for n in os.listdir(pretrain_dir) if n.endswith(".tiktoken"))


def _class_name(pretrain_dir: str, tcfg: dict) -> str:
    """The fast class AutoTokenizer picks, or ``BaichuanTokenizer`` for
    Baichuan's remote code (recognized by name, never executed)."""
    name = tcfg.get("tokenizer_class")
    cfg_path = os.path.join(pretrain_dir, "config.json")
    cfg = _read_json(cfg_path, "config") if os.path.exists(cfg_path) else {}
    for src in (tcfg, cfg):
        auto = src.get("auto_map") or {}
        if isinstance(auto, (list, tuple)):  # the old format
            auto = {"AutoTokenizer": auto}
        if "AutoTokenizer" in auto:
            ref = auto["AutoTokenizer"]
            ref = ref[0] if isinstance(ref, (list, tuple)) and ref else ref
            if isinstance(ref, str) and ref.split("--")[-1] == _BAICHUAN:
                return "BaichuanTokenizer"
            raise NotImplementedError(
                f"{pretrain_dir}: a tokenizer class in remote code (auto_map {ref!r}); the port "
                f"runs only {_BAICHUAN}, natively")
    if not name:
        name = cfg.get("tokenizer_class") or _MODEL_TYPES.get(cfg.get("model_type"))
    if not name:
        raise NotImplementedError(
            f"{pretrain_dir}: no tokenizer class (tokenizer_config.json's tokenizer_class, "
            f"config.json's model_type {cfg.get('model_type')!r})")
    if not name.endswith("Fast"):
        name += "Fast"
    if name not in _CLASSES:
        raise NotImplementedError(f"{pretrain_dir}: tokenizer class {name}")
    return name


def _token_spec(v):
    """(content, flags or None) of a special-token value of the config."""
    if isinstance(v, dict):
        return v["content"], {k: v.get(k) for k in ("single_word", "lstrip", "rstrip",
                                                     "normalized")}
    return v, None


def _bert_spec(pretrain_dir: str, tcfg: dict, specials: dict) -> dict:
    """The pipeline transformers' BertConverter builds from ``vocab.txt``."""
    vocab: Dict[str, int] = {}
    with open(os.path.join(pretrain_dir, "vocab.txt"), encoding="utf-8") as fh:
        for i, line in enumerate(fh.readlines()):
            vocab[line.rstrip("\n")] = i
    basic = tcfg.get("do_basic_tokenize", True)
    cls, sep = _token_spec(specials["cls_token"])[0], _token_spec(specials["sep_token"])[0]

    def slow_id(tok):
        # the slow tokenizer numbers the specials vocab.txt lacks after it
        if tok in vocab:
            return vocab[tok]
        missing = [t for t in (_token_spec(specials.get(k))[0] for k in _SPECIAL_KEYS[:-1])
                   if t is not None and t not in vocab]
        return len(vocab) + list(dict.fromkeys(missing)).index(tok)

    return {
        "model": {"type": "WordPiece", "vocab": vocab,
                  "unk_token": str(_token_spec(specials["unk_token"])[0]),
                  "continuing_subword_prefix": "##", "max_input_chars_per_word": 100},
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": bool(basic and tcfg.get("tokenize_chinese_chars",
                                                                        True)),
                       "strip_accents": tcfg.get("strip_accents") if basic else False,
                       "lowercase": bool(basic and tcfg.get("do_lower_case", True))},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": cls, "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": sep, "type_id": 0}}],
                           "special_tokens": {cls: {"id": cls, "ids": [slow_id(cls)]},
                                              sep: {"id": sep, "ids": [slow_id(sep)]}}},
        "added_tokens": [],
    }


def _spm_spec(path: str, data: bytes, cls: str, tcfg: dict, specials: dict,
              from_slow: bool) -> dict:
    """``LlamaConverter`` / ``GemmaConverter`` over ``tokenizer.model``, with
    the slow tokenizer's settings: ``legacy`` (default true),
    ``add_prefix_space`` (default true), its tokens for ids 0-2."""
    model = sentencepiece.parse_model(data, path)
    if len(model.pieces) < 3:
        raise NotImplementedError(f"{path}: fewer than 3 pieces")
    if cls == "GemmaTokenizerFast":
        first = tuple(_token_spec(specials.get(k))[0]
                      for k in ("pad_token", "eos_token", "bos_token"))
        if None in first:
            raise NotImplementedError(f"{path}: GemmaConverter needs a pad, eos and bos token")
        return sentencepiece.converted_spec(model, "gemma", first)
    # the slow tokenizer's convert_ids_to_tokens(0..2); the one that
    # add_prefix_space builds in LlamaTokenizerFast.__init__ has no
    # added_tokens_decoder
    decoder = {} if from_slow else tcfg.get("added_tokens_decoder") or {}
    first = tuple((decoder.get(str(i)) or {}).get("content") or p
                  for i, (p, _, _) in enumerate(model.pieces[:3]))
    legacy = tcfg.get("legacy")
    return sentencepiece.converted_spec(model, "llama", first,
                                        True if legacy is None else bool(legacy),
                                        tcfg.get("add_prefix_space", True))


def _slow_bpe_spec(pretrain_dir: str, cls: str, tcfg: dict, specials: dict) -> dict:
    """``GPT2Converter`` / ``Qwen2Converter`` over ``vocab.json`` and
    ``merges.txt``, read as ``GPT2Tokenizer`` / ``Qwen2Tokenizer`` read them."""
    vpath, mpath = (os.path.join(pretrain_dir, n) for n in ("vocab.json", "merges.txt"))
    vocab = _read_json(vpath, "vocabulary")
    if not isinstance(vocab, dict):
        raise NotImplementedError(f"{vpath}: not a vocabulary")
    with open(mpath, encoding="utf-8") as fh:
        if cls == "GPT2TokenizerFast":
            merges = [tuple(m.split()) for m in fh.read().split("\n")[1:-1]]
        else:
            merges = []
            for i, line in enumerate(fh):
                line = line.strip()
                if (i == 0 and line.startswith("#version:")) or not line:
                    continue
                merges.append(tuple(line.split()))
    for m in merges:
        if len(m) != 2:
            raise NotImplementedError(f"{mpath}: merge {' '.join(m)!r} is not a pair")
    spec = {"model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False, "byte_fallback": False, "vocab": vocab,
                      "merges": [list(m) for m in dict.fromkeys(merges)]},
            "added_tokens": [], "post_processor": {"type": "ByteLevel"}}
    if cls == "Qwen2TokenizerFast":
        spec["normalizer"] = {"type": "NFC"}
        spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": _QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]}
        return spec
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "ByteLevel", "use_regex": True,
                             "add_prefix_space": bool(tcfg.get("add_prefix_space", False))}
    if tcfg.get("add_bos_token", False):
        bos = _token_spec(specials.get("bos_token"))[0]
        if bos not in vocab:
            raise NotImplementedError(f"{vpath}: add_bos_token with {bos!r} outside it")
        spec["post_processor"] = {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]]}}}
    return spec


def _tiktoken_spec(path: str, data: bytes, specials: dict) -> dict:
    """``TikTokenConverter``: byte-level BPE over the ranks (ids = ranks,
    ``ignore_merges``), each token's splits into two tokens as merges
    ordered by its rank, the cl100k pattern, the config's
    ``additional_special_tokens`` added after the vocabulary."""
    ranks: Dict[bytes, int] = {}
    for line in data.splitlines():
        if not line:
            continue
        try:
            tok, rank = line.split()
            ranks[base64.b64decode(tok, validate=True)] = int(rank)
        except ValueError:
            raise NotImplementedError(f"{path}: tiktoken line {line[:80]!r}") from None

    def text(b):
        return "".join(_BYTE_MAP[x] for x in b)

    merges = []
    for tok, rank in ranks.items():
        local = [(tok[:i], tok[i:], rank) for i in range(1, len(tok))
                 if tok[:i] in ranks and tok[i:] in ranks]
        local.sort(key=lambda x: (ranks[x[0]], ranks[x[1]]))
        merges.extend(local)
    merges.sort(key=lambda v: v[2])
    extra = [_token_spec(t)[0] for t in specials.get("additional_special_tokens") or []]
    return {
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": {text(t): r for t, r in ranks.items()},
                  "merges": [[text(a), text(b)] for a, b, _ in merges]},
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": _TIKTOKEN_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]},
        "post_processor": {"type": "ByteLevel"},
        "added_tokens": [{"id": None, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for c in extra],
    }


def _base_spec(pretrain_dir: str, cls: str, tcfg: dict, specials: dict) -> dict:
    """The ``tokenizer.json`` spec of the directory, from the file the class
    reads: ``tokenizer.model`` for Llama / Gemma without ``tokenizer.json``
    (and for Llama whenever the config sets ``add_prefix_space``:
    ``from_slow``), ``tokenizer.json``, BERT's ``vocab.txt``, GPT-2's /
    Qwen2's ``vocab.json`` + ``merges.txt``, or a tiktoken
    ``tokenizer.model``; else ``NotImplementedError`` naming the file."""
    path = functools.partial(os.path.join, pretrain_dir)
    has = lambda name: os.path.exists(path(name))  # noqa: E731
    from_slow = cls == "LlamaTokenizerFast" and tcfg.get("add_prefix_space") is not None
    spm_class = cls in ("LlamaTokenizerFast", "GemmaTokenizerFast")
    # without tokenizer.json transformers passes tokenizer.model as every
    # class's vocab_file
    if has("tokenizer.model") and (from_slow or not has("tokenizer.json")):
        with open(path("tokenizer.model"), "rb") as fh:
            data = fh.read()
        if sentencepiece.is_tiktoken(data):
            if from_slow:
                raise NotImplementedError(
                    f"{path('tokenizer.model')}: add_prefix_space rebuilds the Llama tokenizer "
                    "from a SentencePiece model; this is a tiktoken rank file")
            if cls in _TIKTOKEN_CLASSES:
                return _tiktoken_spec(path("tokenizer.model"), data, specials)
        elif spm_class:
            return _spm_spec(path("tokenizer.model"), data, cls, tcfg, specials, from_slow)
        raise NotImplementedError(f"{path('tokenizer.model')}: not read for {cls}")
    if from_slow:
        raise NotImplementedError(
            f"{pretrain_dir}: add_prefix_space rebuilds the Llama tokenizer from "
            "tokenizer.model, which the directory lacks")
    if has("tokenizer.json"):
        spec = _read_json(path("tokenizer.json"), "tokenizer")
        if not isinstance(spec, dict):
            raise NotImplementedError(f"{path('tokenizer.json')}: not a tokenizer")
        return spec
    if cls == "BertTokenizerFast" and has("vocab.txt"):
        return _bert_spec(pretrain_dir, tcfg, specials)
    if cls in ("GPT2TokenizerFast", "Qwen2TokenizerFast") and has("vocab.json") \
            and has("merges.txt"):
        return _slow_bpe_spec(pretrain_dir, cls, tcfg, specials)
    present = [n for n in _TOKENIZER_FILES if has(n)] + _tiktoken_files(pretrain_dir)
    raise NotImplementedError(f"{path(present[0])}: not read for {cls}")


def _baichuan(pretrain_dir: str, tcfg: dict, specials: dict) -> sentencepiece.SlowSpmTokenizer:
    """Baichuan's ``BaichuanTokenizer`` (slow): ``tokenizer.model`` through
    sentencepiece's encode, the added tokens as the slow tokenizer
    registers them (the config's ``added_tokens_decoder`` at its ids, then
    the special tokens at their piece ids, else after the vocabulary; the
    bos / eos / unk / pad tokens with their config flags), the
    ``add_bos_token`` (default true) / ``add_eos_token`` template."""
    path = os.path.join(pretrain_dir, "tokenizer.model")
    if not os.path.exists(path):
        raise NotImplementedError(f"{path}: BaichuanTokenizer reads it; the directory lacks it")
    proc = sentencepiece.Processor(sentencepiece.read_model(path), path)
    Tok = sentencepiece.SlowAddedToken
    decoder: Dict[int, Tuple[str, sentencepiece.SlowAddedToken]] = {}
    for k, t in (tcfg.get("added_tokens_decoder") or {}).items():
        decoder[int(k)] = (t["content"], Tok(t["content"], t.get("lstrip"), t.get("rstrip"),
                                             t.get("single_word")))
    encoder = {c: i for i, (c, _) in decoder.items()}
    current = {p: i for i, (p, _, _) in enumerate(proc.model.pieces)}
    current.update(encoder)
    new_idx, n_new, seen = len(current), 0, set()
    for key in _SPECIAL_KEYS:
        values = specials.get(key)
        values = values if key == "additional_special_tokens" and values else [values]
        for v in values:
            content, flags = _token_spec(v)
            if content is None or content in seen:
                continue
            seen.add(content)
            # the class makes bos / eos / unk / pad AddedTokens; a string
            # already registered is skipped
            as_token = flags is not None or key in ("bos_token", "eos_token", "unk_token",
                                                    "pad_token")
            if not as_token and content in encoder:
                continue
            if content in current:
                idx = current[content]
            else:
                idx = current[content] = new_idx + n_new
                n_new += 1
            decoder[idx] = (content, Tok(content, **{k: v for k, v in (flags or {}).items()
                                                     if k != "normalized" and v is not None}))
            encoder[content] = idx
    added = {c: (i, decoder[i][1]) for c, i in encoder.items()}

    def tid(key):
        content = _token_spec(specials.get(key))[0]
        if content is None:
            raise ValueError(f"{pretrain_dir}: add_{key} = True but {key} = None")
        return encoder[content] if content in encoder else proc.piece_to_id(content)

    before = [tid("bos_token")] if tcfg.get("add_bos_token", True) else []
    after = [tid("eos_token")] if tcfg.get("add_eos_token", False) else []
    tok = sentencepiece.SlowSpmTokenizer(proc, added, before, after,
                                         _token_spec(specials.get("unk_token"))[0],
                                         tcfg.get("truncation_side", "right"))
    tok.kind = "spm:BaichuanTokenizer"
    return tok


def files_digest(pretrain_dir: str) -> str:
    """sha256 over the bytes of the tokenizer files the directory holds."""
    h = hashlib.sha256()
    for name in _FILES + tuple(_tiktoken_files(pretrain_dir)):
        path = os.path.join(pretrain_dir, name)
        if os.path.exists(path):
            h.update(name.encode() + b"\x00")
            with open(path, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _specials(pretrain_dir: str, tcfg: dict, defaults: dict) -> dict:
    """The special tokens: class defaults, the config, and
    special_tokens_map.json where the config has no added_tokens_decoder."""
    specials = dict(defaults)
    specials.update({k: tcfg[k] for k in _SPECIAL_KEYS if k in tcfg})
    smap_path = os.path.join(pretrain_dir, "special_tokens_map.json")
    if "added_tokens_decoder" not in tcfg and os.path.exists(smap_path):
        smap = _read_json(smap_path, "special tokens map")
        specials.update({k: v for k, v in smap.items() if k in _SPECIAL_KEYS})
    return specials


def _legacy_added_tokens(pretrain_dir: str, specials: dict) -> dict:
    """``added_tokens.json`` as transformers turns it into an
    ``added_tokens_decoder`` where the config has none."""
    path = os.path.join(pretrain_dir, "added_tokens.json")
    if not os.path.exists(path):
        return {}
    special = set()
    for key in _SPECIAL_KEYS:
        v = specials.get(key)
        for t in (v if key == "additional_special_tokens" and v else [v]):
            if t is not None:
                special.add(_token_spec(t)[0])
    table = _read_json(path, "added tokens")
    return {str(i): {"content": c, "normalized": c not in special, "special": c in special}
            for c, i in table.items()}


def load_tokenizer(pretrain_dir: str):
    """The tokenizer of a pretrain directory: an ``HFTokenizer`` from
    ``tokenizer.json``, a SentencePiece or tiktoken ``tokenizer.model``, a
    BERT ``vocab.txt`` or GPT-2 / Qwen2 ``vocab.json`` + ``merges.txt``; a
    ``SlowSpmTokenizer`` for Baichuan's remote-code class; None when the
    directory holds no tokenizer file; ``NotImplementedError`` naming the
    file or the component for what the port does not read (among them
    ``*.tiktoken``, which transformers reaches for no directory of these
    families)."""
    has = lambda name: os.path.exists(os.path.join(pretrain_dir, name))  # noqa: E731
    if not any(map(has, _TOKENIZER_FILES)):
        tik = _tiktoken_files(pretrain_dir)
        if tik:
            raise NotImplementedError(f"{pretrain_dir}/{tik[0]}: transformers reads no "
                                      "*.tiktoken file for this directory")
        return None
    tcfg_path = os.path.join(pretrain_dir, "tokenizer_config.json")
    tcfg = _read_json(tcfg_path, "tokenizer config") if has("tokenizer_config.json") else {}
    cls = _class_name(pretrain_dir, tcfg)
    if cls == "BaichuanTokenizer":
        tok = _baichuan(pretrain_dir, tcfg, _specials(
            pretrain_dir, tcfg, dict(unk_token="<unk>", bos_token="<s>", eos_token="</s>")))
        tok.files_digest = files_digest(pretrain_dir)
        return tok
    if tcfg.get("split_special_tokens"):
        raise NotImplementedError(f"{pretrain_dir}: split_special_tokens")
    defaults, template = _CLASSES[cls]
    specials = _specials(pretrain_dir, tcfg, defaults)

    spec = dict(_base_spec(pretrain_dir, cls, tcfg, specials))
    if cls == "BertTokenizerFast":
        norm = spec.get("normalizer")
        if norm is None:
            raise NotImplementedError(f"{pretrain_dir}: BertTokenizerFast without a normalizer")
        if norm.get("type") == "BertNormalizer":
            spec["normalizer"] = dict(norm, lowercase=tcfg.get("do_lower_case", True),
                                      strip_accents=tcfg.get("strip_accents"),
                                      handle_chinese_chars=tcfg.get("tokenize_chinese_chars",
                                                                    True))
    pre = spec.get("pre_tokenizer")
    prefix_space = None if cls == "LlamaTokenizerFast" else tcfg.get("add_prefix_space", False)
    if (isinstance(pre, dict) and pre.get("type") == "ByteLevel"
            and isinstance(prefix_space, bool) and pre.get("add_prefix_space") != prefix_space):
        spec["pre_tokenizer"] = dict(pre, add_prefix_space=prefix_space)

    tok = HFTokenizer(spec)
    decoder = (tcfg["added_tokens_decoder"] if "added_tokens_decoder" in tcfg
               else _legacy_added_tokens(pretrain_dir, specials)) or {}
    for _, t in sorted(((int(k), v) for k, v in decoder.items()), key=lambda kv: kv[0]):
        tok.add_token(_AddedToken(t["content"], None, t.get("single_word", False),
                                  t.get("lstrip", False), t.get("rstrip", False),
                                  t.get("normalized"), t.get("special", False)))
    seen = set()
    for key in _SPECIAL_KEYS:
        values = specials.get(key)
        values = values if key == "additional_special_tokens" and values else [values]
        for v in values:
            content, flags = _token_spec(v)
            if content is None or content in seen:
                continue
            seen.add(content)
            if flags is not None:
                tok.add_token(_AddedToken(content, None, special=True, **{
                    k: v for k, v in flags.items() if v is not None}))
            elif content not in tok.added:
                tok.add_token(_AddedToken(content, None, special=True))
    tok._refresh()

    if template is not None:  # update_post_processor
        add_bos = tcfg.get("add_bos_token", template[0])
        add_eos = tcfg.get("add_eos_token", template[1])
        ids = []
        for want, key in ((add_bos, "bos_token"), (add_eos, "eos_token")):
            content = _token_spec(specials.get(key))[0]
            if want and content is None:
                raise ValueError(f"{pretrain_dir}: add_{key} = True but {key} = None")
            tid = tok.token_to_id(content) if want else None
            if want and tid is None:
                tid = tok.token_to_id(_token_spec(specials.get("unk_token"))[0])
            ids.append([tid] if want else [])
        tok.before, tok.after = ids
    tok.kind = f"hf:{cls}"
    tok.unk_token = _token_spec(specials.get("unk_token"))[0]
    tok.files_digest = files_digest(pretrain_dir)
    return tok
