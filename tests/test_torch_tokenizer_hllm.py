"""The HLLM slice through an HF tokenizer: the port against the JAX package
with both towers' pretrain directory holding a tokenizer.json of TinyLlama's
layout (``chip_smoke.write_llama_tokenizer``: BPE with byte fallback, the
Prepend/Replace ▁ normalizer, a BOS template, ``LlamaTokenizer`` in the
config; vocabulary 1024) beside a ``config.json`` of ``LLMConfig.tiny``'s
widths (2 layers, 64 wide, 4 heads over 2 KV heads, no weight file: the
towers start from parameters drawn with numpy and carried across by
``convert.py``). The JAX package tokenizes through ``transformers``.

On the parquet fixture of ``generate_synthetic_dataset`` (300 items), with
the tiny-HLLM settings of ``tests/test_torch_hllm_train.py`` but texts of 32
tokens (the item prompt and "Title:" take the first 16 of every item):

* every item's token row (``ItemTextCache.batch``) and the disk cache's
  matrix equal the JAX package's, id for id;
* the packed corpus batches and the packed train batch equal the JAX
  package's;
* the corpus pass's item embeddings to 1e-5 (``tests/test_torch_hllm.py``'s
  tolerance for float32 embeddings) and the train loss to rtol 1e-5
  (``tests/test_torch_hllm_train.py``'s).

The token rows, the disk cache and the item embeddings are held again
with the towers' tokenizer in two slow layouts: Qwen2's ``vocab.json`` /
``merges.txt`` (the JAX package loads it through ``transformers``'
``Qwen2Converter``) and TinyLlama's ``tokenizer.model`` alone (the JAX
side's ``AutoTokenizer`` answered by ``transformers``' ``LlamaConverter``
through a test monkeypatch, since its own path needs ``sentencepiece``;
``tests/test_torch_sentencepiece.py`` says how).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.textset import BatchTextBatcher as JaxBatchTextBatcher
from mhrec_tpu.data.textset import ItemTextCache as JaxItemTextCache
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.data.textset import _HFTokenizerWrapper
from mhrec_tpu.data.textset import build_tokenizer as jax_build_tokenizer
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data.hf_tokenizer import HFTokenizer, files_digest
from mhrec_tpu_torch.data.textset import (BatchTextBatcher, ItemTextCache, TextSEQTrainBatcher,
                                          build_tokenizer)
from mhrec_tpu_torch.trainer import Trainer

torch.set_num_threads(2)

YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
TOL = 1e-5
LOSS_TOL = 1e-5


def _overrides(synth_dir, tmp, tok_dir, **over):
    d = dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], precision="32",
        item_pretrain_dir=tok_dir, user_pretrain_dir=tok_dir, use_native_sampler=False,
        MAX_ITEM_LIST_LENGTH=6, MAX_TEXT_LENGTH=32, train_batch_size=4, eval_batch_size=32,
        num_negatives=16, tag_version="v1", loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="hierarchical", medusa_num_layers=1,
        segment_embed=True, prior_switch="in", prior_switch_loss_weight=0.1, pred_len=4,
        eval_pred_len=4, topk=[5, 10], packed_item_tower=True, packed_corpus_pass=True,
        pack_chunk=128, suppress_history=False, token_cache_dir=False,
        checkpoint_dir=str(tmp / "ckpt"), scheduler_args={"type": "constant"},
    )
    d.update(over)
    return d


def _random_params(jt, seed):
    """As ``tests/test_torch_hllm_train.py:_random_params``: unit-normal token
    embeddings and emb-token slots (so that items differ), normal 0.02
    elsewhere, 1 + 0.1·normal norm scales, logit scale ln(1/0.07)."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "mix", "neg"))}
    shapes = jax.eval_shape(lambda: jt.model.init(rngs, jt._example_batch(minimal=True),
                                                  deterministic=False))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        if "logit_scale" in key:
            return np.full(x.shape, np.log(1 / 0.07), np.float32)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if "norm" in key or key.endswith("['scale']"):
            return 1.0 + 0.1 * noise
        if "embed_tokens" in key or "item_emb_tokens" in key:
            return noise
        return 0.02 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def slice_setup(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tokenizer_hllm")
    tok_dir = str(tmp / "tiny_llama")
    os.makedirs(tok_dir)
    with open(os.path.join(tok_dir, "config.json"), "w") as fh:
        json.dump({"model_type": "llama", "vocab_size": 1024, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "rms_norm_eps": 1e-5}, fh)
    over = _overrides(synth_dir, tmp, tok_dir)
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
    jdata = JaxData(jcfg).build()
    texts = chip_smoke.rendered_texts(jcfg, jdata.item_text, jdata.item_num)
    chip_smoke.write_llama_tokenizer(tok_dir, texts, 1024)
    tcfg = Config(config_file_list=YAMLS, config_dict=over).finalize()
    return dict(tmp=tmp, tok_dir=tok_dir, over=over, jcfg=jcfg, tcfg=tcfg, jdata=jdata)


def _caches(s):
    jt, tt = jax_build_tokenizer(s["tok_dir"], 1024), build_tokenizer(s["tok_dir"], 1024)
    assert isinstance(jt, _HFTokenizerWrapper) and isinstance(tt, HFTokenizer)
    args = (s["tcfg"]["text_keys"], s["tcfg"]["item_prompt"], s["tcfg"]["MAX_TEXT_LENGTH"])
    return JaxItemTextCache(s["jdata"], jt, *args), ItemTextCache(s["jdata"], tt, *args)


def test_item_token_rows_and_disk_cache_match_jax(slice_setup):
    s = slice_setup
    ref, ours = _caches(s)
    ids = np.arange(s["jdata"].item_num)
    want = ref.batch(ids)
    got = ours.batch(ids)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (want[0] >= 4).sum() > 1000 and want[0].max() < 1024  # real ids, in range
    # the disk cache: written by the port, reloaded, equal to the JAX
    # package's own matrix
    ref.build_disk_cache(str(s["tmp"] / "jax_cache"), "SynthRec", len(ids))
    ours.build_disk_cache(str(s["tmp"] / "torch_cache"), "SynthRec", len(ids))
    again = _caches(s)[1]
    assert again.load_disk_cache(str(s["tmp"] / "torch_cache"), "SynthRec", len(ids))
    np.testing.assert_array_equal(again._matrix, ref._matrix)
    np.testing.assert_array_equal(again._lens, ref._lens)
    for a, b in zip(again.batch(ids), want):
        np.testing.assert_array_equal(a, b)


def test_packed_corpus_and_train_batches_match_jax(slice_setup):
    s = slice_setup
    ours = list(BatchTextBatcher(s["tcfg"], s["jdata"]).batches())
    ref = list(JaxBatchTextBatcher(s["jcfg"], s["jdata"]).batches())
    assert len(ours) == len(ref) > 1
    for b, r in zip(ours, ref):
        assert set(b) == set(r) and "packed_tokens" in r
        for key in r:
            np.testing.assert_array_equal(b[key], r[key], err_msg=key)
    b = next(TextSEQTrainBatcher(s["tcfg"], s["jdata"]).epoch_batches(0))
    r = next(JaxTextBatcher(s["jcfg"], s["jdata"]).epoch_batches(0))
    assert set(b) == set(r) and "packed_tokens" in r
    for key in r:
        np.testing.assert_array_equal(b[key], r[key], err_msg=key)


@pytest.fixture(scope="module")
def models(slice_setup):
    s = slice_setup
    jt = JaxTrainer(s["jcfg"], s["jdata"])
    params = _random_params(jt, seed=1)
    tt = Trainer(s["tcfg"], s["jdata"], device="cpu")
    tt.setup_model()
    tt.model.load_state_dict(state_dict_from_flax(params, s["tcfg"]), strict=True)
    return jt, tt, params


def test_item_embeddings_match_jax(slice_setup, models):
    """The packed corpus pass over every item (``compute_item_feature``)."""
    from types import SimpleNamespace

    s = slice_setup
    jt, tt, params = models
    jt.state = SimpleNamespace(params=jax.tree.map(jnp.asarray, params))
    jt.extra_vars = {}
    jt._corpus_batcher = JaxBatchTextBatcher(s["jcfg"], s["jdata"])
    tt._corpus_batcher = BatchTextBatcher(s["tcfg"], s["jdata"])
    assert isinstance(tt._corpus_batcher.text_cache.tokenizer, HFTokenizer)
    ref = np.asarray(jt.compute_item_feature(return_host=True))
    out = tt.compute_item_feature()
    assert out.shape == ref.shape == (300, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    spread = np.linalg.norm(ref[1:] - ref[1:].mean(0), axis=1)
    assert spread.min() > 100 * TOL * np.abs(ref).max(), spread.min()  # the items differ


def test_train_loss_matches_jax(slice_setup, models):
    """One packed train batch (the JAX batcher's, equal to the port's above)
    through ``HLLM.__call__`` and the port's ``HLLM.forward``."""
    s = slice_setup
    jt, tt, params = models
    batch = next(JaxTextBatcher(s["jcfg"], s["jdata"]).epoch_batches(0))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "mix", "neg"))}
    loss = jax.jit(lambda p: jt.model.apply(
        {"params": p}, {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=False,
        rngs=rngs)["loss"])(jax.tree.map(jnp.asarray, params))
    with torch.no_grad():
        out = tt.model(tt._train_device_batch(batch), generator=tt.step_generator(0))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=LOSS_TOL)


# -- the same slice through the slow layouts ------------------------------------------
LAYOUTS = ("qwen2_vocab_merges", "llama_tokenizer_model")


@pytest.fixture(scope="module")
def layouts(slice_setup):
    """The towers' directory twice more, its tokenizer in another layout:
    Qwen2's slow ``vocab.json`` / ``merges.txt`` (``Qwen2Tokenizer`` in the
    config), and TinyLlama's without ``tokenizer.json``: only the
    ``tokenizer.model`` of ``chip_smoke.write_llama_spm_tokenizer``
    (vocabulary 1024) beside the same ``config.json``."""
    from test_torch_tokenizer import write_qwen2

    s = slice_setup
    texts = chip_smoke.rendered_texts(s["jcfg"], s["jdata"].item_text, s["jdata"].item_num)
    out = {}
    for name in LAYOUTS:
        d = str(s["tmp"] / name)
        if name == "qwen2_vocab_merges":
            write_qwen2(d)
            os.remove(os.path.join(d, "tokenizer.json"))
        else:
            os.makedirs(d)
            chip_smoke.write_llama_spm_tokenizer(d, texts, 1024)
        shutil.copy(os.path.join(s["tok_dir"], "config.json"), d)
        over = dict(s["over"], item_pretrain_dir=d, user_pretrain_dir=d)
        out[name] = dict(dir=d, jcfg=JaxConfig(config_file_list=YAMLS, config_dict=over).finalize(),
                         tcfg=Config(config_file_list=YAMLS, config_dict=over).finalize())
    return out


@pytest.fixture
def jax_sees(monkeypatch):
    """The JAX package's AutoTokenizer, with the tokenizer.model layout
    answered by transformers' LlamaConverter (sentencepiece, which its own
    path needs, is not installed here): ``_HFTokenizerWrapper`` around it."""
    import transformers
    from test_torch_sentencepiece import oracle

    original = transformers.AutoTokenizer.from_pretrained

    def from_pretrained(path, *args, **kwargs):
        if str(path).endswith("llama_tokenizer_model"):
            return oracle(str(path)).tok
        return original(path, *args, **kwargs)

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", from_pretrained)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slow_layouts_token_rows_and_disk_cache_match_jax(slice_setup, layouts, jax_sees,
                                                          layout):
    s, lay = slice_setup, layouts[layout]
    jt, tt = jax_build_tokenizer(lay["dir"], 1024), build_tokenizer(lay["dir"], 1024)
    assert isinstance(jt, _HFTokenizerWrapper) and isinstance(tt, HFTokenizer)
    assert tt.kind == {"qwen2_vocab_merges": "hf:Qwen2TokenizerFast",
                       "llama_tokenizer_model": "hf:LlamaTokenizerFast"}[layout]
    args = (s["tcfg"]["text_keys"], s["tcfg"]["item_prompt"], s["tcfg"]["MAX_TEXT_LENGTH"])
    ref, ours = JaxItemTextCache(s["jdata"], jt, *args), ItemTextCache(s["jdata"], tt, *args)
    ids = np.arange(s["jdata"].item_num)
    want = ref.batch(ids)
    for a, b in zip(ours.batch(ids), want):
        np.testing.assert_array_equal(a, b)
    assert (want[0] >= 4).sum() > 1000 and want[0].max() < 1024
    ref.build_disk_cache(str(s["tmp"] / f"jax_cache_{layout}"), "SynthRec", len(ids))
    ours.build_disk_cache(str(s["tmp"] / f"torch_cache_{layout}"), "SynthRec", len(ids))
    again = ItemTextCache(s["jdata"], build_tokenizer(lay["dir"], 1024), *args)
    assert again.load_disk_cache(str(s["tmp"] / f"torch_cache_{layout}"), "SynthRec", len(ids))
    np.testing.assert_array_equal(again._matrix, ref._matrix)
    np.testing.assert_array_equal(again._lens, ref._lens)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slow_layouts_item_embeddings_match_jax(slice_setup, layouts, models, jax_sees, layout):
    """The packed corpus pass over every item through each layout, on the
    towers of ``models``."""
    from types import SimpleNamespace

    s, lay = slice_setup, layouts[layout]
    jt, tt, params = models
    jt.state = SimpleNamespace(params=jax.tree.map(jnp.asarray, params))
    jt.extra_vars = {}
    jt._corpus_batcher = JaxBatchTextBatcher(lay["jcfg"], s["jdata"])
    tt._corpus_batcher = BatchTextBatcher(lay["tcfg"], s["jdata"])
    used = tt._corpus_batcher.text_cache.tokenizer
    assert isinstance(used, HFTokenizer) and used.files_digest == files_digest(lay["dir"])
    ref = np.asarray(jt.compute_item_feature(return_host=True))
    out = tt.compute_item_feature()
    assert out.shape == ref.shape == (300, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
