"""The row-sharded HSTU item table (``shard_item_embedding``) over two gloo
ranks on the CPU, without a whole copy of the table on any rank.

Two ranks (``tests/torch_parallel_worker.py table``, a free port, a time
limit) run the trainer with the table sharded and, side by side, two more
with it replicated, from the JAX ``Trainer``'s initial weights (carried
across by ``convert.py``), in float32 without dropout, the numpy negative
sampler, 4 steps, an evaluation of the valid split with a best-checkpoint
save and the test split. Item chunks of 100 rows over 300 items: the
middle chunk straddles the two ranks' blocks of 150 rows. The item table
is 16 wide and projected to the trunk's 32 (``item_proj``).

* **The memory check.** A ``TorchDispatchMode`` in each rank records every
  tensor that the build and initialisation, the steps, the evaluations and
  the save produce with 300 rows of width 16 or 32. Sharded: none, except
  rank 0's host assembly of the checkpoint's table and moments, inside the
  save and on the CPU. Replicated: the table itself, so the watch sees
  such tensors where they are.
* **The results.** The sharded run's losses, parameters, row moments,
  metrics and checkpoint file equal the replicated run's (bit for bit: the
  same arithmetic, chunk-wise normalisation being row-wise); against the
  JAX package's run over the composed batches at the JAX multi-process
  test's tolerances (loss relative 2e-4, checksum relative 1e-5, ranking
  metrics absolute 3e-5, Entropy 2e-3).
* **The draw.** Each rank's initial block is the same rows of the one
  process's initial table (the chunked draw), padding rows zero.
* **The load.** The two-rank checkpoint loads into a sharded trainer at two
  ranks (each rank's block, moments and checksum equal the run's) and at
  one process, sharded and not (the whole table equal the ranks' blocks).
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from tests.test_multiprocess import BASE_OVERRIDES, ComposedBatcher
from tests.test_torch_multiprocess import _np_tree, assert_metrics_close, checksum_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"]
WORLD = 2
PROC_TIMEOUT = 300
OVERRIDES = dict(BASE_OVERRIDES, hidden_dropout_prob=0.0, total_iters=4, eval_interval=4,
                 use_native_sampler=False, item_embedding_size=16, hstu_embedding_size=32,
                 eval_item_chunk_size=100, compute_dtype="float32",
                 optim_args={"learning_rate": 1e-4, "weight_decay": 0.0})


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(out, config, init_dir):
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "spec.json"), "w") as fh:
        json.dump({"config": config, "init_dir": init_dir}, fh)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_parallel_worker.py"),
                              "table", str(r), str(WORLD), str(port), out], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def finish(procs):
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def port_trainer(config, **over):
    from mhrec_tpu_torch.trainer import Trainer

    cfg = Config(config_file_list=FILES, config_dict=dict(config, **over)).finalize()
    t = Trainer(cfg, InteractionData(cfg).build(), device="cpu")
    t.setup_model()
    return t


@pytest.fixture(scope="module")
def runs(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_table")
    data_keys = dict(data_path=synth_dir["data_path"], dataset=synth_dir["name"],
                     text_path=synth_dir["text_path"])
    config = dict(OVERRIDES, **data_keys)
    # the JAX initial weights as a port checkpoint
    jcfg = JaxConfig(config_file_list=FILES, config_dict=dict(
        config, checkpoint_dir=str(tmp / "jax"), sparse_adam_global_dedup=True)).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    init = port_trainer(config, checkpoint_dir=str(tmp / "init"))
    init.model.load_state_dict(state_dict_from_flax(_np_tree(jt.state.params), init.config))
    init.async_checkpoint = False
    init.save_checkpoint()
    procs, outs = [], {}
    for shard in (True, False):
        name = "sharded" if shard else "replicated"
        outs[name] = str(tmp / name)
        procs += start_ranks(outs[name], dict(config, shard_item_embedding=shard,
                                              checkpoint_dir=str(tmp / f"ck_{name}")),
                             init.saved_model_dir)
    try:
        # meanwhile: the JAX run on the composed batches, and the one
        # process's initial table (the port's own draw)
        jstats = jt.fit(ComposedBatcher(jcfg, jdata), None)
        jres = jt.evaluate(SeqEvalBatcher(jcfg, jdata, phase="test"), load_best_model=False)
        jax_run = {"final_loss": float(jstats["loss"]), "result": jres,
                   "param_checksum": checksum_jax(jt.state.params)}
        one = port_trainer(config, checkpoint_dir=str(tmp / "one"))
        drawn = one.item_table().weight.detach().clone()
    finally:
        finish(procs)
    ranks = {name: [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                    for r in range(WORLD)] for name, out in outs.items()}
    return {"ranks": ranks, "jax": jax_run, "one_process_table": drawn, "config": config,
            "tmp": tmp}


def whole(ranks, key, n):
    """The table-shaped tensor ``key`` whole from the ranks' blocks."""
    return torch.cat([r[key] for r in ranks])[:n]


def test_no_rank_makes_a_whole_table(runs):
    r0, r1 = runs["ranks"]["sharded"]
    assert r1["hits"] == []
    # rank 0's host assembly of the table and its two moments for the file
    assert r0["hits"], "the checkpoint's table was not assembled on rank 0"
    assert all(phase == "save" and device == "cpu" for phase, _, _, device in r0["hits"])
    assert r0["block_rows"] == r1["block_rows"] == 150


def test_the_watch_sees_the_replicated_table(runs):
    for r in runs["ranks"]["replicated"]:
        phases = {phase for phase, _, _, _ in r["hits"]}
        assert {"init", "fit", "test"} <= phases, phases


def test_sharded_run_equals_the_replicated_run(runs):
    sh, rep = runs["ranks"]["sharded"], runs["ranks"]["replicated"]
    n = rep[0]["block"].shape[0]
    for s, r in zip(sh, rep):
        assert s["losses"] == r["losses"] and s["final_loss"] == r["final_loss"]
        assert s["checksum"] == pytest.approx(r["checksum"], rel=1e-6)
        assert s["result"] == r["result"]
    for key in ("block", "m", "v"):
        assert torch.equal(whole(sh, key, n), rep[0][key]), key
    # the chunk fetches of the evaluations: each rank sends and receives
    # its share of every chunk of every eval batch
    assert all(s["traffic"]["table_chunk"] > 0 for s in sh)
    assert all("table_chunk" not in r["traffic"] for r in rep)


def test_checkpoint_file_equals_the_replicated_runs(runs):
    sh, rep = (torch.load(runs["ranks"][name][0]["checkpoint"], weights_only=True)
               for name in ("sharded", "replicated"))
    assert sh.keys() == rep.keys()
    assert sh["params"].keys() == rep["params"].keys()
    for k, v in rep["params"].items():
        assert torch.equal(sh["params"][k], v), k
    for k in ("table_m", "table_v"):
        assert torch.equal(sh[k], rep[k]), k
    assert sh["step"] == rep["step"] and sh["best_valid_score"] == rep["best_valid_score"]


def test_sharded_run_matches_the_jax_composed_run(runs):
    r0, ref = runs["ranks"]["sharded"][0], runs["jax"]
    assert r0["final_loss"] == pytest.approx(ref["final_loss"], rel=2e-4)
    assert r0["checksum"] == pytest.approx(ref["param_checksum"], rel=1e-5)
    assert_metrics_close(r0["result"], ref["result"])


def test_chunked_draw_gives_one_process_and_each_rank_the_same_rows(runs):
    table = runs["one_process_table"]
    n = table.shape[0]
    for r, rank in enumerate(runs["ranks"]["sharded"]):
        block = rank["drawn"]
        lo, hi = r * block.shape[0], min((r + 1) * block.shape[0], n)
        assert torch.equal(block[:hi - lo], table[lo:hi])
        assert not block[hi - lo:].any()  # padding rows
    # and a one-process sharded table (one block) is the same table
    one = port_trainer(runs["config"], shard_item_embedding=True,
                       checkpoint_dir=str(runs["tmp"] / "one_sharded"))
    assert torch.equal(one.item_table().weight.detach(), table)


@pytest.mark.parametrize("where", ["two_ranks_sharded", "one_process_sharded",
                                   "one_process_replicated"])
def test_two_rank_checkpoint_loads(runs, where):
    ranks = runs["ranks"]["sharded"]
    if where == "two_ranks_sharded":
        for r in ranks:
            for key in ("block", "m", "v"):
                assert torch.equal(r["loaded"][key], r[key]), key
            assert r["loaded"]["checksum"] == pytest.approx(r["checksum"], rel=1e-6)
        return
    ckpt_dir = os.path.dirname(ranks[0]["checkpoint"])
    dst = runs["tmp"] / f"load_{where}"
    t = port_trainer(runs["config"], shard_item_embedding=where == "one_process_sharded",
                     checkpoint_dir=str(dst))
    shutil.copytree(ckpt_dir, t.saved_model_dir)
    assert t.load_checkpoint()
    n = t.dataload.item_num
    assert torch.equal(t.item_table().weight.detach()[:n], whole(ranks, "block", n))
    assert torch.equal(t.table_m[:n], whole(ranks, "m", n))
    assert t.param_checksum() == pytest.approx(ranks[0]["checksum"], rel=1e-6)
