"""The port's HLLM serving path against the JAX package's, on the same
weights (carried across by ``convert.py``) and the same data.

The fixture is the ``generate_synthetic_dataset`` parquet pair (120 users,
300 items with title / tag / description texts). Both packages build HLLM
with tiny Llama towers (``LLMConfig.tiny`` widths: 2 layers, 64 wide, 4
heads over 2 KV heads; the port reads them from a ``config.json`` with no
weight files, the JAX package from ``random_init_towers``, which needs no
pretrain directory and so no ``transformers`` import), hierarchical prior
heads (4 categories × 2 segment heads, one medusa layer, segment
embeddings), the packed item tower, and ``precision: 32``. The JAX
parameters are drawn with numpy over the shapes of ``jax.eval_shape`` of the
model's init (an eager init compiles hundreds of operations) and carried
into the port. Chunk rows are 128 tokens (``pack_chunk``) so the CPU runs
stay small.

Tolerances: 1e-5 on float32 embeddings (order of sums); every metric of
the ``--val_only`` evaluation within 1e-6 (the metrics are rounded to 7
places).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxInteractionData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.data.textset import BatchTextBatcher as JaxBatchTextBatcher
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_eval_dataloaders
from mhrec_tpu_torch.data.textset import BatchTextBatcher
from mhrec_tpu_torch.run import main
from mhrec_tpu_torch.trainer import Trainer

torch.set_num_threads(2)

TOL = 1e-5
METRIC_TOL = 1e-6
YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]


def _write_tiny_llama_config(dirpath):
    """A ``config.json`` as ``tests/test_hllm.py:_write_tiny_llama_ckpt``
    writes it, without the weight file: the towers start at random."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump({"model_type": "llama", "vocab_size": 1024, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "rms_norm_eps": 1e-5}, fh)


def _overrides(synth_dir, tmp, **over):
    d = dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], precision="32",
        MAX_ITEM_LIST_LENGTH=6, MAX_TEXT_LENGTH=16, train_batch_size=8, eval_batch_size=32,
        tag_version="v1", loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="hierarchical", medusa_num_layers=1,
        segment_embed=True, pred_len=4, eval_pred_len=4, topk=[5, 10],
        packed_item_tower=True, packed_corpus_pass=True, pack_chunk=128,
        suppress_history=False, checkpoint_dir=str(tmp / "ckpt"),
    )
    d.update(over)
    return d


def _random_params(jt, seed=0):
    """Parameters of the JAX trainer's model at the shapes its init makes:
    normal 0.02 kernels and embeddings, 1 + 0.1·normal norm scales, 0.02·
    normal biases (none of them trivially 0 or 1), logit scale ln(1/0.07)."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "mix", "neg"))}
    shapes = jax.eval_shape(lambda: jt.model.init(rngs, jt._example_batch(minimal=True),
                                                  deterministic=False))
    assert set(shapes) == {"params"}
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        if "logit_scale" in key:
            return np.full(x.shape, np.log(1 / 0.07), np.float32)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if "norm" in key or key.endswith("['scale']"):
            return 1.0 + 0.1 * noise
        return 0.02 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.fixture(scope="module")
def hllm(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hllm")
    _write_tiny_llama_config(tmp / "tiny_llama")
    over = _overrides(synth_dir, tmp, token_cache_dir=str(tmp / "jax_tokens"),
                      random_init_towers=True, dummy_vocab_size=1024, dummy_hidden_size=64)
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
    jdata = JaxInteractionData(jcfg).build()
    _, _, jtest = jax_build_dataloader(jcfg, jdata)
    jt = JaxTrainer(jcfg, jdata)
    params = _random_params(jt)
    # what evaluate reads of the train state: the parameters
    jt.state = SimpleNamespace(params=jax.tree.map(jnp.asarray, params))
    jt.extra_vars = {}

    over = _overrides(synth_dir, tmp, token_cache_dir=str(tmp / "torch_tokens"),
                      item_pretrain_dir=str(tmp / "tiny_llama"),
                      user_pretrain_dir=str(tmp / "tiny_llama"))
    tcfg = Config(config_file_list=YAMLS, config_dict=over).finalize()
    data = InteractionData(tcfg).build()
    tt = Trainer(tcfg, data, device="cpu")
    tt.setup_model()
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    return dict(jt=jt, jdata=jdata, jtest=jtest, params=params, tt=tt, tcfg=tcfg,
                data=data, over=over, jax_over=jcfg.as_dict())


def _jax_apply(h, method, *args):
    """One jitted call of a JAX model method (compiled whole, not op by op)."""
    jt = h["jt"]
    fn = jax.jit(lambda p, *a: jt.model.apply({"params": p}, *a, method=method))
    return jax.tree.map(np.asarray, fn(jt.state.params, *(jnp.asarray(a) for a in args)))


def test_port_builds_the_same_model(hllm):
    model = hllm["tt"].model
    assert model.dtype == torch.float32 and hllm["jt"].model.dtype == jnp.float32
    assert model.item_config.packed_window == 17  # MAX_TEXT_LENGTH + one emb slot
    assert sorted(model.state_dict()) == sorted(state_dict_from_flax(hllm["params"],
                                                                     hllm["tcfg"]))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_corpus_batches_match_jax(hllm, packed):
    over = dict(hllm["over"], packed_corpus_pass=packed, token_cache_dir=False)
    ours = BatchTextBatcher(Config(config_file_list=YAMLS, config_dict=over).finalize(),
                            hllm["data"])
    ref = JaxBatchTextBatcher(_jax_config(hllm, packed_corpus_pass=packed), hllm["jdata"])
    batches = list(ours.batches())
    ref_batches = list(ref.batches())
    assert len(batches) == len(ref_batches) == 7  # 300 items, 48 a batch
    for b, r in zip(batches, ref_batches):
        assert set(b) == set(r) and b["n_real"] == r["n_real"]
        for key in r:
            np.testing.assert_array_equal(b[key], r[key], err_msg=key)


def _jax_config(h, **over):
    return JaxConfig(config_dict=dict(h["jax_over"], token_cache_dir=False, **over))


def _first_batch(h, packed):
    over = dict(h["over"], packed_corpus_pass=packed, token_cache_dir=False)
    return next(BatchTextBatcher(Config(config_file_list=YAMLS, config_dict=over).finalize(),
                                 h["data"]).batches())


def test_encode_items_matches_jax(hllm):
    b = _first_batch(hllm, packed=False)
    ref = _jax_apply(hllm, "encode_items", b["tokens"], b["lens"])
    with torch.no_grad():
        out = hllm["tt"].model.encode_items(torch.from_numpy(b["tokens"]).long(),
                                            torch.from_numpy(b["lens"]).long())
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_encode_items_packed_matches_jax(hllm):
    b = _first_batch(hllm, packed=True)
    args = [b[k] for k in ("packed_tokens", "packed_segment_ids", "packed_positions",
                           "emb_slots")]
    ref = _jax_apply(hllm, "encode_items_packed", *args)
    with torch.no_grad():
        out = hllm["tt"].model.encode_items_packed(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    # the dense padded route gives the same embeddings of the same items
    d = _first_batch(hllm, packed=False)
    with torch.no_grad():
        dense = hllm["tt"].model.encode_items(torch.from_numpy(d["tokens"]).long(),
                                              torch.from_numpy(d["lens"]).long())
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_corpus_table_matches_jax(hllm, packed):
    """The whole corpus pass: the raw item table of ``compute_item_feature``
    under ``packed_corpus_pass`` on and off."""
    over = dict(hllm["over"], packed_corpus_pass=packed, token_cache_dir=False)
    jt, tt = hllm["jt"], hllm["tt"]
    jt._corpus_batcher = JaxBatchTextBatcher(_jax_config(hllm, packed_corpus_pass=packed),
                                             hllm["jdata"])
    tt._corpus_batcher = BatchTextBatcher(
        Config(config_file_list=YAMLS, config_dict=over).finalize(), hllm["data"])
    ref = np.asarray(jt.compute_item_feature(return_host=True))
    out = tt.compute_item_feature()
    assert out.shape == ref.shape == (300, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_predict_embeddings_matches_jax(hllm):
    tt = hllm["tt"]
    table = tt.compute_item_feature()
    batch = next(iter(build_eval_dataloaders(hllm["tcfg"], hllm["data"])[1].batches()))
    ref = _jax_apply(hllm, "predict_embeddings", batch["item_seq"], batch["target_tags"],
                     table.numpy())
    with torch.no_grad():
        pe = tt.model.predict_embeddings(torch.from_numpy(batch["item_seq"]).long(),
                                         torch.from_numpy(batch["target_tags"]), table)
    assert pe["head_embs"].shape == (32, 8, 64)
    for key in ("head_embs", "user_emb"):
        np.testing.assert_allclose(pe[key].numpy(), np.asarray(ref[key]), rtol=TOL, atol=TOL)


def test_val_only_evaluation_matches_jax(hllm):
    """``python -m mhrec_tpu_torch.run ... --device cpu -- --val_only True``
    on the parquet fixture, from a checkpoint holding the JAX model's
    weights, against the JAX ``Trainer.evaluate`` of the test split."""
    over = hllm["over"]
    tt = hllm["tt"]
    tt.save_checkpoint()  # the converted weights, where --val_only loads them
    ref = hllm["jt"].evaluate(hllm["jtest"], load_best_model=False)
    args = ["--config_file", *YAMLS, "--device", "cpu", "--"]
    for key in ("data_path", "dataset", "text_path", "item_pretrain_dir", "user_pretrain_dir",
                "precision", "MAX_ITEM_LIST_LENGTH", "MAX_TEXT_LENGTH", "train_batch_size",
                "eval_batch_size", "tag_version", "loss", "eval_num_cats", "num_prior_head",
                "num_segment_head", "head_interaction", "medusa_num_layers", "segment_embed",
                "pred_len", "eval_pred_len", "packed_item_tower", "packed_corpus_pass",
                "pack_chunk", "suppress_history", "checkpoint_dir", "token_cache_dir"):
        args += [f"--{key}", json.dumps(over[key]) if key == "topk" else str(over[key])]
    args += ["--topk", "[5,10]", "--val_only", "True"]
    out = main(args)
    assert set(out) == set(ref) and {"shared", "pred_0", "pred_1", "pred_3"} <= set(out)
    for section in ref:
        assert set(out[section]) == set(ref[section]), section
        for key, v in ref[section].items():
            assert out[section][key] == pytest.approx(float(v), abs=METRIC_TOL), (section, key)


def test_hllm_serve_refuses_to_leave_the_card_unasked(hllm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config_file", *YAMLS, "--", "--val_only", "True"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(hllm["tcfg"], hllm["data"])


def _cfg(over):
    return Config(config_file_list=YAMLS, config_dict=over).finalize()


@pytest.mark.parametrize("case", ["weights", "tokenizer", "host_table", "sparse_item_adam",
                                  "training"])
def test_hllm_raises_on_what_is_not_ported(hllm, tmp_path, case):
    """What the port leaves out raises instead of running something else
    (and, for the host table, what the JAX package refuses raises too); a
    pretrain directory whose weight file does not parse raises instead of
    keeping the random initialisation."""
    from mhrec_tpu_torch.data import build_dataloader

    over = dict(hllm["over"], token_cache_dir=False)
    tower = tmp_path / "tower"
    _write_tiny_llama_config(tower)
    over.update(item_pretrain_dir=str(tower), user_pretrain_dir=str(tower))
    if case == "weights":
        (tower / "model.safetensors").write_bytes(b"")
        t = Trainer(_cfg(over), hllm["data"], device="cpu")
        with pytest.raises(ValueError, match="safetensors header"):
            t.setup_model()
    elif case == "tokenizer":
        # a SentencePiece model without tokenizer.json: the JAX package reads
        # it through sentencepiece, which the port does not depend on
        (tower / "tokenizer.model").write_bytes(b"\x00")
        with pytest.raises(NotImplementedError, match="tokenizer.model"):
            BatchTextBatcher(_cfg(over), hllm["data"])
    elif case == "host_table":
        # ported: a budget below the raw table's bytes keeps it in host
        # memory under auto; what still raises is the JAX package's refusal
        # of a host table forced on beside full-score metrics (rec.score)
        t = Trainer(_cfg(dict(over, item_table_hbm_budget_gb=1e-6)),
                    hllm["data"], device="cpu")
        assert t._use_host_item_table(True) and not t._use_host_item_table(True, True)
        t = Trainer(_cfg(dict(over, host_item_table=True)), hllm["data"], device="cpu")
        t.setup_model()
        t.collector.register.need = lambda key: key == "rec.score"
        test = build_eval_dataloaders(hllm["tcfg"], hllm["data"])[1]
        with pytest.raises(ValueError, match="host_item_table"):
            t.evaluate(test)
    elif case == "sparse_item_adam":
        with pytest.raises(ValueError, match="sparse_item_adam"):
            Trainer(_cfg(dict(over, sparse_item_adam=True)), hllm["data"],
                    device="cpu")
    else:  # training: the remat policy that saves products runs, an unknown
        # one raises, and so do image items on the packed item tower (the
        # image span rides the dense one, as in the JAX package)
        t = Trainer(_cfg(dict(over, gradient_checkpointing=True, remat_policy="dots")),
                    hllm["data"], device="cpu")
        t.setup_model()
        batch = next(build_dataloader(t.config, hllm["data"])[0].epoch_batches(0))
        assert np.isfinite(float(t.train_step(batch)["loss"]))
        with pytest.raises(ValueError, match="remat_policy"):
            Trainer(_cfg(dict(over, gradient_checkpointing=True, remat_policy="offload")),
                    hllm["data"], device="cpu")
        with pytest.raises(ValueError, match="packed_item_tower"):
            build_dataloader(_cfg(dict(over, use_image=True, packed_item_tower=True)),
                             hllm["data"])
