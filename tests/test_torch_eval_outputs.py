"""The evaluation outputs and modes of the port against the JAX package, on
the CPU, on the same weights (``convert.state_dict_from_flax``) and data.

* ``log_detailed_results`` and ``save_for_eval``: the per-batch dumps of one
  evaluation of the ``prior_config`` fixture (HSTU, 4 prior heads and the
  prior switch, item chunks of 125 over 300 items). Ids, ``user`` /
  ``item_tgt`` / ``recommend_items`` and the head sources are equal; values
  and embeddings within 1e-5. A dump of either package loads with the
  other's ``load_log_dict``; ``results.pkl`` is written beside them, and
  skipped with one warning where pandas is missing.
* the streamed GAUC / AUC and VALUE metrics (MAE, RMSE, LogLoss) against
  the JAX package's streamed path, for a single-head config and the
  multi-head prior config (``split_mode`` combine and average), and
  against the port's own full-score path (``rec.score``, the [B, H, I]
  tensor). Tolerances, the JAX test's (tests/test_eval_paths.py:46-52):
  5e-4 for gauc and auc (the chunked and the whole-corpus products may round
  a target's own score an ulp apart, which moves its rank by one half), 2e-6
  for every other metric.
* the host-memory corpus table (``host_item_table``) on a tiny HLLM (2-layer
  Llama towers 64 wide, hierarchical prior heads, the packed corpus pass):
  item chunks of 64 over 300 items (5 chunks) and ``host_eval_group_size``
  2 (two table passes), against the port's device-table evaluation and the
  JAX host-table evaluation, GAUC and the VALUE metrics included, at the
  JAX host-table test's tolerances (tests/test_eval_paths.py:228-237): 2e-3
  for gauc and auc, 1e-6 for the rest; the ``auto`` decision under a small
  ``item_table_hbm_budget_gb``, and the ValueError of a host table forced
  beside full-score metrics.
"""

import glob
import logging
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxInteractionData
from mhrec_tpu.data import build_dataloader
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu.utils.observability import load_log_dict as jax_load_log_dict
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_eval_dataloaders
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.utils.observability import load_log_dict
from tests.conftest import make_config

torch.set_num_threads(2)

DUMP_TOL = 1e-5
METRICS = ["Recall", "NDCG", "GAUC", "AUC", "MAE", "RMSE", "LogLoss"]


def _tol(key, rank=5e-4, other=2e-6):
    return rank if "auc" in key else other


def _assert_results_close(out, ref, **tol):
    """Every metric of ``ref`` in ``out``, within the tolerance of its kind."""
    assert set(ref) <= set(out)
    for section in ref:
        assert set(ref[section]) <= set(out[section]), section
        for key, v in ref[section].items():
            assert out[section][key] == pytest.approx(float(v), abs=_tol(key, **tol)), (
                section, key, out[section][key], v)


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _pair(jcfg_dict, tmp, data=None):
    """A JAX trainer (model in float32, random initial weights) and a port
    trainer on the CPU with the same weights, with their test batchers."""
    jcfg = JaxConfig(config_dict=dict(jcfg_dict, checkpoint_dir=str(tmp / "jax")))
    jdata = data or JaxInteractionData(jcfg).build()
    _, _, jtest = build_dataloader(jcfg, jdata)
    jt = JaxTrainer(jcfg, jdata)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    tcfg = Config(config_dict=dict(jcfg_dict, checkpoint_dir=str(tmp / "torch")))
    tdata = InteractionData(tcfg).build()
    _, ttest = build_eval_dataloaders(tcfg, tdata)
    tt = Trainer(tcfg, tdata, device="cpu", dtype=torch.float32)
    tt.model.load_state_dict(state_dict_from_flax(_jax_numpy(jt.state.params), tcfg),
                             strict=True)
    return jt, jtest, tt, ttest


def _force_full(trainer):
    """Evaluate through the full-score path, as tests/test_eval_paths.py
    forces it: pretend a metric needs rec.score."""
    need = trainer.collector.register.need
    trainer.collector.register.need = lambda k: k == "rec.score" or need(k)
    return need


# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dumps(prior_config, prior_data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dumps")
    over = dict(prior_config.as_dict(), eval_item_chunk_size=125, log_detailed_results=True,
                save_for_eval=True)
    jt, jtest, tt, ttest = _pair(over, tmp, prior_data)
    ref = jt.evaluate(jtest, load_best_model=False)
    out = tt.evaluate(ttest)
    return dict(jt=jt, tt=tt, ref=ref, out=out, n_batches=-(-len(ttest) // 32))


def _files(trainer, sub, pattern):
    return sorted(glob.glob(os.path.join(trainer.saved_model_dir, sub, pattern)))


def test_dumps_leave_the_metrics_as_they_were(dumps):
    _assert_results_close(dumps["out"], dumps["ref"], rank=1e-6, other=1e-6)


def test_detailed_dumps_match_jax(dumps):
    mine = _files(dumps["tt"], "detailed", "*.npz")
    ref = _files(dumps["jt"], "detailed", "*.npz")
    assert len(mine) == len(ref) == dumps["n_batches"] > 1
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in ref]
    for m, r in zip(mine, ref):
        a, b = load_log_dict(m[:-4]), jax_load_log_dict(r[:-4])
        assert set(a) == set(b) == {"values", "head_source", "values_by_head", "user",
                                    "item_tgt", "recommend_items"}
        for key in ("user", "item_tgt", "recommend_items"):
            assert a[key] == b[key], key
        assert all(len(row) == 50 for row in a["recommend_items"])
        np.testing.assert_array_equal(a["head_source"], b["head_source"])
        for key in ("values", "values_by_head"):
            np.testing.assert_allclose(a[key], b[key], rtol=DUMP_TOL, atol=DUMP_TOL, err_msg=key)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_detailed_dumps_load_with_either_loader(dumps, writer):
    path = _files(dumps["tt" if writer == "port" else "jt"], "detailed", "*.npz")[0][:-4]
    a, b = load_log_dict(path), jax_load_log_dict(path)
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key]


def test_save_for_eval_chunks_match_jax(dumps):
    mine = _files(dumps["tt"], "saved_eval", "eval_chunk_*.npz")
    ref = _files(dumps["jt"], "saved_eval", "eval_chunk_*.npz")
    assert len(mine) == len(ref) == dumps["n_batches"]
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in ref]
    for m, r in zip(mine, ref):
        with np.load(m) as a, np.load(r) as b:
            assert set(a.files) == set(b.files) == {"user_ids", "topk_values", "topk_indices",
                                                    "user_embs", "head_embs"}
            for key in ("user_ids", "topk_indices"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            for key in ("topk_values", "user_embs", "head_embs"):
                assert a[key].shape == b[key].shape
                np.testing.assert_allclose(a[key], b[key], rtol=DUMP_TOL, atol=DUMP_TOL,
                                           err_msg=key)


def test_results_table_is_written_and_skipped_without_pandas(dumps, monkeypatch, caplog):
    import pandas as pd

    tt = dumps["tt"]
    path = os.path.join(tt.saved_model_dir, "results.pkl")
    table = pd.read_pickle(path)
    ref = pd.read_pickle(os.path.join(dumps["jt"].saved_model_dir, "results.pkl"))
    assert list(table["section"]) == list(ref["section"])
    os.remove(path)
    monkeypatch.setitem(sys.modules, "pandas", None)  # as on a machine without it
    with caplog.at_level(logging.WARNING, logger="mhrec_tpu_torch.trainer.trainer"):
        tt._save_results_table()
        tt._save_results_table()
    assert not os.path.exists(path)
    assert sum("results.pkl" in r.getMessage() for r in caplog.records) == 1


# ----------------------------------------------------------------------------
def _metric_configs(synth_dir):
    single = make_config(synth_dir, metrics=METRICS).as_dict()
    multi = make_config(synth_dir, metrics=METRICS, loss="prior", eval_num_cats=4,
                        num_prior_head=4, medusa_num_layers=1, pred_len=4,
                        eval_item_chunk_size=125).as_dict()
    return {"single_head": single, "multi_head": multi,
            "multi_head_average": dict(multi, split_mode="average")}


@pytest.fixture(scope="module", params=["single_head", "multi_head", "multi_head_average"])
def streamed(request, synth_dir, tmp_path_factory):
    over = _metric_configs(synth_dir)[request.param]
    jt, jtest, tt, ttest = _pair(over, tmp_path_factory.mktemp(request.param))
    ref = jt.evaluate(jtest, load_best_model=False)
    out = tt.evaluate(ttest)
    need = _force_full(tt)
    full = tt.evaluate(ttest)
    tt.collector.register.need = need
    return dict(name=request.param, ref=ref, out=out, full=full, tt=tt)


def test_streamed_metrics_match_jax(streamed):
    out, ref = streamed["out"], streamed["ref"]
    last = out[max(out, key=lambda s: s.startswith("pred_"))]
    assert {"gauc", "auc", "mae", "rmse", "logloss"} <= set(last)
    _assert_results_close(out, ref)
    assert set(out) == set(ref)


def test_streamed_metrics_match_the_full_score_path(streamed):
    out, full = streamed["out"], streamed["full"]
    # the full-score path sums no switch accuracy (as in the JAX package)
    for section in full:
        assert set(full[section]) == {k for k in out[section]
                                     if not k.startswith("head_cat_")}, section
    _assert_results_close(out, full)
    assert streamed["tt"].collector.external_meanrank is False  # the full run's


# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hllm(synth_dir, tmp_path_factory):
    from tests.test_torch_hllm import YAMLS, _overrides, _random_params, _write_tiny_llama_config

    tmp = tmp_path_factory.mktemp("host_table")
    _write_tiny_llama_config(tmp / "tiny_llama")
    extra = dict(metrics=["Recall", "NDCG", "GAUC", "AUC", "MAE", "RMSE", "LogLoss"],
                 eval_item_chunk_size=64, host_eval_group_size=2, suppress_history=True)
    over = _overrides(synth_dir, tmp, token_cache_dir=False, random_init_towers=True,
                      dummy_vocab_size=1024, dummy_hidden_size=64, **extra)
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=dict(over, host_item_table=True))
    jcfg = jcfg.finalize()
    jdata = JaxInteractionData(jcfg).build()
    _, _, jtest = build_dataloader(jcfg, jdata)
    jt = JaxTrainer(jcfg, jdata)
    params = _random_params(jt)
    jt.state = SimpleNamespace(params=jax.tree.map(jnp.asarray, params))
    jt.extra_vars = {}
    ref = jt.evaluate(jtest, load_best_model=False)

    over = _overrides(synth_dir, tmp, token_cache_dir=False,
                      item_pretrain_dir=str(tmp / "tiny_llama"),
                      user_pretrain_dir=str(tmp / "tiny_llama"), **extra)

    def port(**mode):
        cfg = Config(config_file_list=YAMLS, config_dict=dict(over, **mode)).finalize()
        data = InteractionData(cfg).build()
        t = Trainer(cfg, data, device="cpu")
        t.setup_model()
        t.model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
        return t, build_eval_dataloaders(cfg, data)[1]

    return dict(ref=ref, port=port)


def test_host_table_matches_the_device_table_and_jax(hllm):
    t, test = hllm["port"](host_item_table=True)
    host = t.evaluate(test)
    stats = t.host_table_stats
    n_batches = -(-len(test) // 32)
    assert n_batches >= 3 and stats["groups"] == -(-n_batches // 2)
    assert stats["chunks"] == 5 * stats["groups"]
    t, test = hllm["port"](host_item_table=False)
    device = t.evaluate(test)
    assert t.host_table_stats == {}
    last = device["pred_3"]
    assert {"gauc", "auc", "mae", "rmse", "logloss", "recall@10"} <= set(last)
    for ref in (device, hllm["ref"]):
        assert set(host) == set(ref)
        _assert_results_close(host, ref, rank=2e-3, other=1e-6)


def test_auto_keeps_a_table_past_the_budget_in_host_memory(hllm):
    t, test = hllm["port"](host_item_table="auto", item_table_hbm_budget_gb=1e-6)
    assert t._use_host_item_table(True)
    auto = t.evaluate(test)
    assert t.host_table_stats["groups"] > 0
    t, test = hllm["port"](host_item_table="auto")  # 300 × 64 floats fit 4 GiB
    assert not t._use_host_item_table(True)
    _assert_results_close(auto, t.evaluate(test), rank=2e-3, other=1e-6)


def test_host_table_refuses_full_score_metrics(hllm):
    t, test = hllm["port"](host_item_table=True)
    _force_full(t)
    with pytest.raises(ValueError, match="host_item_table is incompatible"):
        t.evaluate(test)
    t, test = hllm["port"](host_item_table="auto", item_table_hbm_budget_gb=1e-6)
    assert not t._use_host_item_table(True, need_full=True)
