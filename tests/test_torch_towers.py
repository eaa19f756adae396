"""The port's BERT and ALiBi towers and the ``remat_policy: dots``
checkpointing against the JAX package, and an HLLM whose towers load a
checkpoint, on the CPU.

* ``BertBackbone`` (token ids with the emb slot, and ``inputs_embeds`` as
  the user tower takes them; bidirectional and causal) and the ALiBi
  ``LlamaBackbone`` (Baichuan-13B's topology: 4 heads, and 6 to take the
  slopes' non-power-of-two branch; causal and bidirectional) against the JAX
  modules on weights carried across by ``convert.py``: float32, atol 1e-5,
  rtol 1e-4;
* an ALiBi tower on the packed route raises, in both packages;
* ``additive_causal_mask`` equals the JAX package's;
* ``remat_policy: dots`` gives ``full``'s gradients (float32, rtol 1e-6),
  dense and packed, RoPE and ALiBi, and reruns fewer products in the
  backward (it keeps them);
* an HLLM as ``tests/test_hllm.py:230-283`` sets it up (tiny Llama towers
  from a ``pytorch_model.bin``), at ``precision: 32``: the towers the port
  loads equal the JAX package's ``load_pretrained_towers`` bit for bit; on
  those weights and the JAX heads, the item embeddings of the corpus (atol
  1e-5) and one train batch's loss (rtol 1e-5) match.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.models.hllm.hllm import load_pretrained_towers as jax_load_pretrained_towers
from mhrec_tpu.models.llm import bert as jbert
from mhrec_tpu.models.llm import llama as jllama
from mhrec_tpu.models.llm.config import LLMConfig as JaxLLMConfig
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import (bert_state_dict_from_flax, llama_state_dict_from_flax,
                                     state_dict_from_flax)
from mhrec_tpu_torch.models.llm import packed as tpacked
from mhrec_tpu_torch.models.llm.bert import BertBackbone
from mhrec_tpu_torch.models.llm.config import LLMConfig
from mhrec_tpu_torch.models.llm.llama import LlamaBackbone
from mhrec_tpu_torch.trainer import Trainer
from tests.test_hllm import _write_tiny_llama_ckpt

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
GRAD_RTOL = 1e-6
BERT = dict(model_type="bert", vocab_size=96, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=40, rms_norm_eps=1e-12)


def _draw(shapes, seed):
    """normal 0.05 kernels, biases and embeddings; norm and LayerNorm scales
    1 + 0.1·normal (none of them trivially 0 or 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if "norm" in key or "_ln" in key:
            return 1.0 + 0.1 * noise
        return 0.05 * noise
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _items(rng, N, T, vocab):
    lens = rng.integers(1, T, size=N).astype(np.int64)
    tokens = rng.integers(1, vocab, size=(N, T + 1)).astype(np.int64)
    return tokens, lens


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("mode", ["tokens", "embeds"])
def test_bert_backbone_matches_flax(mode, causal):
    jcfg = JaxLLMConfig(**BERT)
    jmodel = jbert.BertBackbone(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    tokens, lens = _items(rng, 6, 12, BERT["vocab_size"])
    T = tokens.shape[1]
    mask = (np.arange(T)[None] < lens[:, None] + 1).astype(np.int32)
    if mode == "tokens":
        emb = (rng.normal(size=(1, 1, 32)) * 0.05).astype(np.float32)
        jargs = dict(input_ids=jnp.asarray(tokens), attention_mask=jnp.asarray(mask),
                     emb_tokens=jnp.asarray(emb), emb_pos=jnp.asarray(lens), causal=causal)
        targs = dict(input_ids=torch.from_numpy(tokens), attention_mask=torch.from_numpy(mask),
                     emb_tokens=torch.from_numpy(emb), emb_pos=torch.from_numpy(lens),
                     causal=causal)
    else:
        x = rng.normal(size=(6, T, 32)).astype(np.float32)
        jargs = dict(inputs_embeds=jnp.asarray(x), attention_mask=jnp.asarray(mask),
                     causal=causal)
        targs = dict(inputs_embeds=torch.from_numpy(x), attention_mask=torch.from_numpy(mask),
                     causal=causal)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), **jargs))["params"]
    params = _draw(shapes, seed=2)
    ref = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, **jargs))(params))
    model = BertBackbone(LLMConfig(**BERT), dtype=torch.float32,
                         token_embeddings=mode == "tokens")
    model.load_state_dict(bert_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        out = model(**targs).numpy()
    keep = mask.astype(bool)
    np.testing.assert_allclose(out[keep], ref[keep], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["causal", "bidirectional"])
def test_additive_causal_mask_matches_jax(bidirectional):
    from mhrec_tpu.models.layers import additive_causal_mask as jax_mask
    from mhrec_tpu_torch.models.layers import additive_causal_mask

    items = np.random.default_rng(9).integers(0, 3, size=(4, 7))
    ref = np.asarray(jax_mask(jnp.asarray(items), bidirectional=bidirectional))
    out = additive_causal_mask(torch.from_numpy(items), bidirectional=bidirectional).numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def _alibi_config(heads):
    return dataclasses.replace(JaxLLMConfig.tiny(vocab_size=96, hidden_size=8 * heads),
                               num_attention_heads=heads, num_key_value_heads=heads,
                               alibi=True, model_type="baichuan", rms_norm_eps=1e-6)


@pytest.fixture(scope="module", params=[4, 6], ids=["heads4", "heads6"])
def alibi_tower(request):
    jcfg = _alibi_config(request.param)
    jmodel = jllama.LlamaBackbone(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                input_ids=jnp.ones((1, 4), jnp.int32)))
    params = _draw(shapes["params"], seed=3)
    model = LlamaBackbone(LLMConfig(**dataclasses.asdict(jcfg)), dtype=torch.float32)
    model.load_state_dict(llama_state_dict_from_flax(params), strict=True)
    return jcfg, jmodel, params, model.eval()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_alibi_backbone_matches_flax(alibi_tower, causal):
    jcfg, jmodel, params, model = alibi_tower
    rng = np.random.default_rng(4)
    tokens, lens = _items(rng, 5, 11, 96)
    mask = (np.arange(12)[None] < lens[:, None] + 1).astype(np.int32)
    emb = (rng.normal(size=(1, 1, jcfg.hidden_size)) * 0.05).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p: jmodel.apply(
        {"params": p}, input_ids=jnp.asarray(tokens), attention_mask=jnp.asarray(mask),
        causal=causal, emb_tokens=jnp.asarray(emb), emb_pos=jnp.asarray(lens)))(params))
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(tokens), attention_mask=torch.from_numpy(mask),
                    causal=causal, emb_tokens=torch.from_numpy(emb),
                    emb_pos=torch.from_numpy(lens)).numpy()
    keep = mask.astype(bool)
    np.testing.assert_allclose(out[keep], ref[keep], atol=ATOL, rtol=RTOL)


def _packed_inputs(vocab=96, chunk=24):
    tokens, lens = _items(np.random.default_rng(5), 6, 9, vocab)
    p = tpacked.pack_items(tokens, lens, chunk=chunk, chunk_round=1)
    return {k: torch.from_numpy(p[k]) for k in
            ("packed_tokens", "packed_segment_ids", "packed_positions", "emb_slots")}, p


def test_alibi_on_the_packed_route_raises(alibi_tower):
    jcfg, jmodel, params, model = alibi_tower
    t, p = _packed_inputs()
    with pytest.raises(NotImplementedError, match="ALiBi"):
        model(input_ids=t["packed_tokens"].long(), position_ids=t["packed_positions"].long(),
              segment_ids=t["packed_segment_ids"])
    with pytest.raises(NotImplementedError, match="alibi"):
        jmodel.apply({"params": params}, input_ids=jnp.asarray(p["packed_tokens"]),
                     position_ids=jnp.asarray(p["packed_positions"]),
                     segment_ids=jnp.asarray(p["packed_segment_ids"]))


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products that run (forward reruns included)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads(model, policy, inputs):
    """Every gradient under ``policy`` (None: no checkpointing) and the
    products that ran in the backward."""
    model.gradient_checkpointing = policy is not None
    model.remat_policy = policy or "full"
    model.zero_grad(set_to_none=True)
    out = model(**inputs)
    cot = torch.from_numpy(np.random.default_rng(6).normal(size=tuple(out.shape))
                           .astype(np.float32))
    counter = _CountProducts()
    with counter:
        (out * cot).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}, counter.n


@pytest.mark.parametrize("route", ["dense", "packed", "alibi"])
def test_remat_dots_gives_full_gradients(route):
    cfg = dataclasses.replace(LLMConfig.tiny(vocab_size=96, hidden_size=32),
                              packed_window=10, attention_bias=True)
    if route == "alibi":
        cfg = dataclasses.replace(cfg, alibi=True, num_key_value_heads=4)
    model = LlamaBackbone(cfg, dtype=torch.float32)
    model.init_parameters(torch.Generator().manual_seed(7))
    if route == "packed":
        t, _ = _packed_inputs()
        inputs = dict(input_ids=t["packed_tokens"].long(),
                      position_ids=t["packed_positions"].long(),
                      segment_ids=t["packed_segment_ids"],
                      emb_tokens=torch.full((1, 1, 32), 0.1), emb_pos=t["emb_slots"].long())
    else:
        tokens, lens = _items(np.random.default_rng(8), 5, 10, 96)
        mask = (np.arange(11)[None] < lens[:, None] + 1).astype(np.int32)
        inputs = dict(input_ids=torch.from_numpy(tokens),
                      attention_mask=torch.from_numpy(mask))
    full, n_full = _grads(model, "full", inputs)
    dots, n_dots = _grads(model, "dots", inputs)
    _, n_none = _grads(model, None, inputs)
    for name, g in full.items():
        np.testing.assert_allclose(dots[name].numpy(), g.numpy(), rtol=GRAD_RTOL, atol=0,
                                   err_msg=name)
    # full reruns the layers' forward products in the backward; dots takes
    # every one of them from its cache, so its backward runs only the
    # products a backward without checkpointing runs
    assert n_dots == n_none < n_full, (n_none, n_dots, n_full)


# ----------------------------------------------------------------------------
def _over(synth_dir, tmp, ckpt_dir):
    """tests/test_hllm.py:_hllm_config's overrides with real towers from
    ``ckpt_dir``, at float32."""
    return dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], model="HLLM", dummy_llm=False,
        item_pretrain_dir=ckpt_dir, user_pretrain_dir=ckpt_dir, precision="32",
        MAX_ITEM_LIST_LENGTH=6, MAX_TEXT_LENGTH=16, train_batch_size=8, eval_batch_size=16,
        num_negatives=32, tag_version="v1", eval_pred_len=2, pred_len=2, topk=[5, 10],
        total_iters=2, eval_interval=100, use_native_sampler=False, token_cache_dir=False,
        checkpoint_dir=str(tmp / "ckpt"))


def test_hllm_with_pretrained_towers_matches_jax(synth_dir, tmp_path):
    ckpt_dir = str(tmp_path / "tiny_llama")
    os.makedirs(ckpt_dir)
    _write_tiny_llama_ckpt(ckpt_dir)
    over = _over(synth_dir, tmp_path, ckpt_dir)
    yamls = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
    jcfg = JaxConfig(config_file_list=yamls, config_dict=over).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "mix", "neg"))}
    shapes = jax.eval_shape(lambda: jt.model.init(rngs, jt._example_batch(minimal=True),
                                                  deterministic=False))["params"]
    params = jax_load_pretrained_towers(dict(_draw(shapes, seed=9)), jcfg)
    params["logit_scale"] = np.full((), np.log(1 / 0.07), np.float32)
    # the JAX loader hands the user tower the token table too, which a tower
    # fed only inputs_embeds never reads (and the port's does not have)
    params["user_llm"] = {k: v for k, v in params["user_llm"].items() if k != "embed_tokens"}

    tcfg = Config(config_file_list=yamls, config_dict=over).finalize()
    tt = Trainer(tcfg, jdata, device="cpu")
    tt.setup_model()  # random init, then the towers from the checkpoint
    want = state_dict_from_flax(params, tcfg)
    loaded = {k: v for k, v in tt.model.state_dict().items()
              if k.startswith(("item_llm.", "user_llm."))}
    assert loaded and set(loaded) <= set(want)
    for k, v in loaded.items():
        assert torch.equal(v, want[k]), k
    tt.model.load_state_dict(want, strict=True)  # the heads and the emb slot

    # the corpus' item embeddings
    tokens, lens = _corpus_batch(tt, jdata)
    ref = np.asarray(jax.jit(lambda p: jt.model.apply(
        {"params": p}, jnp.asarray(tokens), jnp.asarray(lens), method="encode_items"))(params))
    with torch.no_grad():
        out = tt.model.encode_items(torch.from_numpy(tokens).long(),
                                    torch.from_numpy(lens).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)

    # one train batch's loss
    batch = next(JaxTextBatcher(jcfg, jdata).epoch_batches(0))
    drngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "mix", "neg"))}
    ref_loss = float(jax.jit(lambda p: jt.model.apply(
        {"params": p}, {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=False,
        rngs=drngs)["loss"])(params))
    tt.model.train()
    with torch.no_grad():
        loss = float(tt.model(tt._train_device_batch(batch),
                              generator=tt.step_generator(0))["loss"])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)


def _corpus_batch(tt, data, n=40):
    from mhrec_tpu_torch.data.textset import BatchTextBatcher

    batcher = BatchTextBatcher(tt.config, data)
    return batcher.text_cache.batch(np.arange(1, n + 1))
