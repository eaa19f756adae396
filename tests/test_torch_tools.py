"""The port's offline tools, synthetic dataset writers and metric sinks
against the JAX package's:

* ``mhrec_tpu_torch/tools/clustering.py``: the same seed gives the same
  Leiden and label-propagation labels and modularity, and the same item and
  user prior-dict payloads and cluster columns, over the synthetic fixture;
* ``tools/convert_priors.py``: a reference ``*_dict.py`` module becomes the
  same JSON as JAX's tool writes, which the port's prior-dict loader reads
  back;
* ``data/synthetic.py``'s ``generate_synthetic_dataset`` and
  ``generate_synthetic_dataset_fast``: the same parquet frames and tag
  dictionary as JAX's;
* the trainer's ``_log_scalars``: a fake ``wandb`` module and a
  ``tensorboardX`` writer into ``tmp_path`` receive the same heads, keys
  and steps from the port's ``fit`` as from the JAX trainer's on the same
  batches and weights (4 steps, the scalars read every 2, an evaluation
  every 2), the values within the training parity tolerance;
  ``log_wandb: false`` sends nothing to wandb, and non-numbers go nowhere.
"""

import json
import sys
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from mhrec_tpu.data.evalset import SeqEvalBatcher as JaxEvalBatcher
from mhrec_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from mhrec_tpu.data.synthetic import generate_synthetic_dataset_fast as jax_generate_fast
from mhrec_tpu.tools import clustering as jax_clustering
from mhrec_tpu.tools import convert_priors as jax_convert_priors
from mhrec_tpu.trainer import trainer as jax_trainer_mod
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from mhrec_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    generate_synthetic_dataset_fast,
)
from mhrec_tpu_torch.data.tag_dicts import load_prior_dict
from mhrec_tpu_torch.tools import clustering, convert_priors
from mhrec_tpu_torch.trainer import trainer as port_trainer_mod
from tests import test_torch_train as TT

PORT_DATA = {}


def port_data(synth_dir):
    if "data" not in PORT_DATA:
        from mhrec_tpu_torch.config import Config

        cfg = Config(config_file_list=["overall/ID.yaml", "IDNet/hstu.yaml"], config_dict=dict(
            data_path=synth_dir["data_path"], dataset=synth_dir["name"],
            text_path=synth_dir["text_path"], tag_version="v1")).finalize()
        PORT_DATA["data"] = InteractionData(cfg).build()
    return PORT_DATA["data"]


def test_graph_algorithms_match_jax(synth_dir, jax_data):
    data = port_data(synth_dir)
    seqs = [data.seq_of(u) for u in range(1, data.user_num)]
    jseqs = [jax_data.seq_of(u) for u in range(1, jax_data.user_num)]
    assert all(np.array_equal(a, b) for a, b in zip(seqs, jseqs))
    graph = clustering.cooccurrence_graph(seqs, data.item_num, 3, 1)
    jgraph = jax_clustering.cooccurrence_graph(jseqs, jax_data.item_num, 3, 1)
    assert (graph != jgraph).nnz == 0
    users = clustering.co_interaction_graph(seqs, data.user_num - 1, data.item_num, 2)
    assert (users != jax_clustering.co_interaction_graph(
        jseqs, jax_data.user_num - 1, jax_data.item_num, 2)).nnz == 0
    for seed in (0, 3):
        for res in (0.5, 1.0):
            labels = clustering.leiden(graph, resolution=res, seed=seed)
            np.testing.assert_array_equal(
                labels, jax_clustering.leiden(jgraph, resolution=res, seed=seed))
            assert clustering.modularity(graph, labels, res) == jax_clustering.modularity(
                jgraph, labels, res)
        np.testing.assert_array_equal(clustering.label_propagation(graph, seed=seed),
                                      jax_clustering.label_propagation(jgraph, seed=seed))


@pytest.mark.parametrize("algorithm", ["leiden", "label_prop"])
def test_cluster_dicts_match_jax(synth_dir, jax_data, tmp_path, algorithm):
    data = port_data(synth_dir)
    kw = dict(seed=2, algorithm=algorithm, max_clusters=8)
    payload, items = clustering.build_item_cluster_dict(data, window=4, **kw)
    jpayload, jitems = jax_clustering.build_item_cluster_dict(jax_data, window=4, **kw)
    assert payload == jpayload and payload["v1"]["category_counts"]
    np.testing.assert_array_equal(items, jitems)
    upayload, users = clustering.build_user_cluster_dict(data, **kw)
    jupayload, jusers = jax_clustering.build_user_cluster_dict(jax_data, **kw)
    assert upayload == jupayload
    np.testing.assert_array_equal(users, jusers)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    path = clustering.write_prior_dict(payload, str(tmp_path / "port"), "Synth", "cluster_dict")
    jpath = jax_clustering.write_prior_dict(jpayload, str(tmp_path / "jax"), "Synth",
                                            "cluster_dict")
    assert open(path).read() == open(jpath).read()
    assert load_prior_dict(str(tmp_path / "port"), "Synth", "cluster_dict") == payload


def test_convert_priors_round_trips(tmp_path):
    module = tmp_path / "Synth_tag_dict.py"
    module.write_text("tag_to_general = {'v1': {'category_counts': {'a': 3, 'b': 1},\n"
                      "    'tag_to_category': {'t0': ['a'], 't1': ['b'], 7: ['a']}}}\n")
    out, jout = tmp_path / "Synth_tag_dict.json", tmp_path / "jax.json"
    assert convert_priors.main([str(module), str(out)]) == 0
    jax_convert_priors.convert(str(module), str(jout))
    assert out.read_text() == jout.read_text()
    loaded = load_prior_dict(str(tmp_path), "Synth", "tag_dict")
    assert loaded["v1"]["tag_to_category"] == {"t0": ["a"], "t1": ["b"], "7": ["a"]}
    with pytest.raises(KeyError, match="does not define tag_to_general"):
        (tmp_path / "empty.py").write_text("x = 1\n")
        convert_priors.convert(str(tmp_path / "empty.py"), str(tmp_path / "e.json"))


@pytest.mark.parametrize("fast", [False, True], ids=["loop", "fast"])
def test_synthetic_writers_match_jax(tmp_path, fast):
    kw = dict(num_users=40, num_items=120, seed=4)
    if fast:
        kw.update(mean_seq_len=20, min_seq_len=8, max_seq_len=40)
        meta = generate_synthetic_dataset_fast(str(tmp_path / "port"), **kw)
        jmeta = jax_generate_fast(str(tmp_path / "jax"), **kw)
    else:
        kw.update(with_events=True, with_user_clusters=True)
        meta = generate_synthetic_dataset(str(tmp_path / "port"), **kw)
        jmeta = jax_generate(str(tmp_path / "jax"), **kw)
    assert {k: v for k, v in meta.items() if "path" not in k} == \
        {k: v for k, v in jmeta.items() if "path" not in k}
    name = meta["name"]
    for fname in (f"{name}.parquet", f"{name}-info.parquet"):
        pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "port" / fname),
                                      pd.read_parquet(tmp_path / "jax" / fname))
    tag = f"{name}_tag_dict.json"
    assert json.loads((tmp_path / "port" / tag).read_text()) == json.loads(
        (tmp_path / "jax" / tag).read_text())


# ---------------------------------------------------------------------------
# the metric sinks
class FakeWandb:
    """``wandb`` for the loggers: each ``init`` makes a run that records
    its ``log`` calls."""

    def __init__(self):
        self.runs = []

    def init(self, **kw):
        run = SimpleNamespace(kw=kw, logged=[], finished=False)
        run.log = lambda payload, step=None: run.logged.append((dict(payload), step))
        run.finish = lambda: setattr(run, "finished", True)
        self.runs.append(run)
        return run


@pytest.fixture
def jax_data(synth_dir, tmp_path_factory):
    from mhrec_tpu.data import InteractionData as JaxData

    jcfg, _ = TT._configs(synth_dir, tmp_path_factory.mktemp("tools_data"))
    return JaxData(jcfg).build()


def _writer_class():
    from tensorboardX import SummaryWriter

    class Writer(SummaryWriter):
        """A tensorboardX writer that also records its scalars."""

        def __init__(self, logdir):
            super().__init__(logdir)
            self.calls = []

        def add_scalar(self, tag, value, step=None, *args, **kwargs):
            self.calls.append((tag, float(value), step))
            return super().add_scalar(tag, value, step, *args, **kwargs)

    return Writer


class PortBatches:
    """The JAX train batcher's stream in the port's batch layout."""

    num_hosts = 1

    def __init__(self, batcher):
        self.batcher = batcher

    def infinite_batches(self, prefetch=2):
        return (TT._port_batch(b) for b in self.batcher.infinite_batches(prefetch=0))


def test_log_scalars_match_jax(synth_dir, jax_data, tmp_path, monkeypatch):
    from mhrec_tpu.data import build_dataloader as jax_build_dataloader

    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    writers = {}
    Writer = _writer_class()
    for name, mod in (("jax", jax_trainer_mod), ("port", port_trainer_mod)):
        monkeypatch.setattr(mod, "get_tensorboard", lambda cfg, name=name: writers.setdefault(
            name, Writer(str(tmp_path / "tb" / name))))
    jt, tt, _, tcfg = TT._trainer_pair(
        synth_dir, jax_data, tmp_path, dict(attn_impl="xla", sparse_adam_impl="xla"),
        log_wandb=True, total_iters=4, eval_interval=2, update_interval=2,
        int_to_category={c: f"cat_{c}" for c in range(4)},
        optim_args={"learning_rate": 1e-4, "weight_decay": 0.01})
    jcfg = jt.config
    jt.fit(jax_build_dataloader(jcfg, jax_data)[0], JaxEvalBatcher(jcfg, jax_data, "valid"))
    tt.fit(PortBatches(jax_build_dataloader(jcfg, jax_data)[0]),
           SeqEvalBatcher(tcfg, jax_data, "valid"))
    # the same scalars; the dicts' orders differ
    got, want = sorted(writers["port"].calls), sorted(writers["jax"].calls)
    assert [(tag, step) for tag, _, step in got] == [(tag, step) for tag, _, step in want]
    heads = {tag.split("/")[0] for tag, _, _ in got}
    assert heads == {"train", "valid_pred_0", "valid_pred_1", "valid_shared"}, heads
    assert sorted({s for t, _, s in got if t.startswith("train/")}) == [2, 4]
    for (tag, v, _), (_, w, _) in zip(got, want):
        assert v == pytest.approx(w, rel=1e-3, abs=1e-4), tag
    jrun, prun = fake.runs
    assert prun.kw["group"] == jrun.kw["group"] and prun.kw["project"] == jrun.kw["project"]
    assert [(sorted(p), s) for p, s in prun.logged] == [(sorted(p), s) for p, s in jrun.logged]
    assert len(prun.logged) == 2 + 2 * 3  # 2 train fetches, 2 evaluations × 3 sections
    for (p, _), (q, _) in zip(prun.logged, jrun.logged):
        for k in q:
            assert p[k] == pytest.approx(q[k], rel=1e-3, abs=1e-4), k


def test_no_wandb_without_log_wandb(synth_dir, jax_data, tmp_path, monkeypatch):
    """``log_wandb: false`` (the default): no wandb run, and the trainer's
    scalars go to TensorBoard alone."""
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    Writer = _writer_class()
    writer = Writer(str(tmp_path / "tb"))
    monkeypatch.setattr(port_trainer_mod, "get_tensorboard", lambda cfg: writer)
    _, tcfg = TT._configs(synth_dir, tmp_path)
    t = port_trainer_mod.Trainer(tcfg, jax_data, device="cpu")
    t._log_scalars({"loss": 1.5, "note": "text"}, step=3, head="train")
    assert fake.runs == [] and t.wandblogger._run is None
    assert writer.calls == [("train/loss", 1.5, 3)]
