"""Two ranks of the port's CLI training HLLM (``python -m mhrec_tpu_torch.run
--multihost --num_processes 2 --device cpu``, gloo on the CPU, a free port,
a time limit per process) against the JAX package's single-process run on
the composed batches: the JAX ``Trainer`` stepping on the two hosts'
``TextSEQTrainBatcher(host_id=h, num_hosts=2)`` batches concatenated in
host order (``tests/test_multiprocess.py:404-420, 527-535``), in this
process. Each case starts both sides from the same parameters (the JAX
ones, carried into a port checkpoint by ``convert.py`` that the CLI
resumes from), trains 3 steps, evaluates the valid split with a
best-checkpoint save and the test split from it:

* the dense item tower; the packed one in chunk rows of 64 tokens; the
  Qwen2-VL image tower of ``tests/test_vision.py:_write_tiny_qwen2vl_ckpt``
  over seeded JPEGs; the dense tower with the corpus table in host memory
  (held to the dense JAX run, whose evaluation it only changes); the dense
  tower under ``accumulate_grad`` 2;
* the checkpoint the two ranks wrote, served by one process (``--val_only``),
  gives the ranks' metrics.

Tolerances are the JAX HLLM multi-process test's: final loss relative
5e-4, ranking metrics absolute 5e-5, Entropy 2e-3; the two ranks agree to
relative 1e-6 and report equal metrics.

Beside the CLI runs, two ranks of ``tests/torch_parallel_worker.py hllm``
give the model's gathered negative pool (the packed tower) and the corpus
pass: the pool's rows equal JAX's global ``_neg_norm`` over the composed
batch, in its order, and the corpus table of two ranks (on the device and
in host memory) equals one process's. The three multi-host refusals raise
with the JAX package's messages.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.evalset import SeqEvalBatcher as JaxEvalBatcher
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.models.layers import cosine_normalize as jax_cosine_normalize
from mhrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
from mhrec_tpu_torch.parallel import DataMesh
from mhrec_tpu_torch.trainer import Trainer
from tests.test_multiprocess import ComposedBatcher
from tests.test_torch_hllm_train import _random_params
from tests.test_vision import _write_tiny_qwen2vl_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
WORLD = 2
PROC_TIMEOUT = 300
STEPS = 3
# tiny Llama towers (LLMConfig.tiny: 2 layers, 64 wide), hierarchical prior
# heads, float32, the numpy negative sampler (whose draws the two packages
# share), a constant learning rate of 1e-4
BASE = dict(
    precision="32", random_init_towers=True, dummy_vocab_size=1024, dummy_hidden_size=64,
    use_native_sampler=False, MAX_ITEM_LIST_LENGTH=6, MAX_TEXT_LENGTH=16, train_batch_size=4,
    eval_batch_size=32, num_negatives=16, tag_version="v1", loss="prior", eval_num_cats=4,
    num_prior_head=4, num_segment_head=2, head_interaction="hierarchical",
    medusa_num_layers=1, segment_embed=True, prior_switch="in", prior_switch_loss_weight=0.1,
    pred_len=4, eval_pred_len=4, topk=[5, 10], packed_item_tower=False,
    suppress_history=False, token_cache_dir=False, scheduler_args={"type": "constant"},
    optim_args={"learning_rate": 1e-4, "weight_decay": 0.01}, total_iters=STEPS,
    eval_interval=STEPS, update_interval=1, show_progress=False)
# the cases' overrides, and the JAX run each is held to
CASES = {
    "dense": ({}, "dense"),
    "packed": (dict(packed_item_tower=True, pack_chunk=64), "packed"),
    "image": (dict(random_init_towers=False, use_image=True, img_height=16, img_width=16,
                   MAX_ITEM_LIST_LENGTH=4, MAX_TEXT_LENGTH=24, num_negatives=8), "image"),
    "host_table": (dict(host_item_table=True), "dense"),
    "accumulate": (dict(accumulate_grad=2), "accumulate"),
}
JAX_RUNS = ("dense", "packed", "image", "accumulate")
TOL = {"loss": 5e-4, "metric": 5e-5, "entropy": 2e-3, "between_ranks": 1e-6}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def overrides(meta, tmp, case):
    over = dict(BASE, data_path=meta["data_path"], dataset=meta["name"],
                text_path=meta["text_path"], **CASES[case][0])
    if case == "image":
        over.update(item_pretrain_dir=str(tmp / "qwen2vl"), user_pretrain_dir=str(tmp / "qwen2vl"),
                    image_dir=str(tmp / "images"))
    return over


def write_images(root, n=16, seed=5):
    """Seeded 20 × 20 JPEGs for items i0..i{n-1} (the JAX test's)."""
    from PIL import Image

    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (20, 20, 3), np.uint8), "RGB").save(
            os.path.join(root, f"i{i}.jpg"))


def start(args, rank=None, port=None):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    head = [sys.executable, "-m", "mhrec_tpu_torch.run"]
    if rank is not None:
        head += ["--multihost", "--coordinator_address", f"127.0.0.1:{port}",
                 "--num_processes", str(WORLD), "--process_id", str(rank)]
    return subprocess.Popen(head + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def cli_args(over):
    args = ["--config_file", *YAMLS, "--", "--device", "cpu"]
    for k, v in over.items():
        args += [f"--{k}", json.dumps(v) if isinstance(v, (list, bool, dict)) else str(v)]
    return args


def finish(procs):
    """Wait for every process (each within the time limit; the rest are
    killed when one fails or hangs) and assert they exited cleanly."""
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def results(path, n):
    return [json.loads(open(f"{path}.{r}.json").read()) for r in range(n)]


class ComposedText(ComposedBatcher):
    """The JAX hosts' text batches, concatenated in host order."""

    def __init__(self, config, dataload):
        self.parts = [JaxTextBatcher(config, dataload, host_id=h, num_hosts=WORLD)
                      for h in range(WORLD)]


def jax_train_state(jt, params):
    """The JAX trainer's state and jitted step at ``params``: what
    ``setup_model`` builds (trainer.py:333-335, the optimizer under
    ``optax.MultiSteps`` for ``accumulate_grad`` > 1) without its eager
    init of the model."""
    import optax

    from mhrec_tpu.trainer.trainer import TrainState

    params = jax.tree.map(jnp.asarray, params)
    jt.tx = jt._make_tx(params)
    if jt.accumulate_grad > 1:
        jt.tx = optax.MultiSteps(jt.tx, every_k_schedule=jt.accumulate_grad)
    jt.extra_vars = {}
    jt.state = TrainState(params=params, opt_state=jt.tx.init(params),
                          step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0),
                          nan_step=jnp.asarray(-1, jnp.int32))
    jt._build_train_step()


def jax_trainer(over, tmp, name):
    """The JAX trainer of ``over`` over two devices (the global batch of 4
    divides by them), with its parameters: unit-scale random ones for the
    Llama towers (``_random_params``), the checkpoint's towers for the
    image case."""
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=dict(
        over, checkpoint_dir=str(tmp / f"jax_{name}"))).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    jt.mesh = jax_make_mesh(jax.devices()[:WORLD])
    if over.get("use_image"):
        jt.setup_model()
    else:
        jax_train_state(jt, _random_params(jt, seed=4))
    return jt, jcfg, jdata


def init_checkpoint(params, over, tmp, name):
    """``params`` (a flax tree) as a port checkpoint directory that a run
    resumes from (``load_checkpoint_name``)."""
    tcfg = Config(config_file_list=YAMLS, config_dict=dict(
        over, checkpoint_dir=str(tmp / f"init_{name}"))).finalize()
    t = Trainer(tcfg, InteractionData(tcfg).build(), device="cpu")
    t.setup_model()
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params), tcfg)
    # a user tower loaded from a checkpoint keeps its token table in JAX;
    # the port's user tower reads item embeddings only and has none
    sd.pop("user_llm.embed_tokens.weight", None)
    t.model.load_state_dict(sd)
    t.async_checkpoint = False
    t.save_checkpoint()
    return t.saved_model_dir, t


@pytest.fixture(scope="module")
def runs(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp_hllm")
    _write_tiny_qwen2vl_ckpt(str(tmp / "qwen2vl"))
    write_images(str(tmp / "images" / synth_dir["name"]))

    def prepare(name):
        over = overrides(synth_dir, tmp, name)
        jax_run = jax_trainer(over, tmp, name)
        return jax_run, init_checkpoint(jax_run[0].state.params, over, tmp, name)[0]

    # the four JAX runs in threads: XLA compiles and runs without the
    # interpreter lock, and the compiles are most of their time
    with ThreadPoolExecutor(4) as pool:
        prepared = dict(zip(JAX_RUNS, pool.map(prepare, JAX_RUNS)))
    # every case's two ranks at once
    procs, paths = [], {}
    for case, (_, ref) in CASES.items():
        init = str(tmp / f"init_copy_{case}")
        shutil.copytree(prepared[ref][1], init)
        paths[case] = str(tmp / f"mp_{case}")
        args = cli_args(dict(overrides(synth_dir, tmp, case),
                             checkpoint_dir=str(tmp / f"ck_{case}"),
                             result_json_path=paths[case], load_checkpoint_name=init))
        port = free_port()
        procs += [start(args, r, port) for r in range(WORLD)]

    def jax_run(name):
        jt, jcfg, jdata = prepared[name][0]
        stats = jt.fit(ComposedText(jcfg, jdata), None)
        result = jt.evaluate(JaxEvalBatcher(jcfg, jdata, phase="test"), load_best_model=False)
        return {"final_loss": float(stats["loss"]), "result": result}

    try:
        # meanwhile: the JAX runs on the composed batches
        with ThreadPoolExecutor(4) as pool:
            ref = dict(zip(JAX_RUNS, pool.map(jax_run, JAX_RUNS)))
    finally:
        finish(procs)
    mp = {case: results(path, WORLD) for case, path in paths.items()}
    # the dense run's checkpoint, served by one process
    serve_path = str(tmp / "serve_dense")
    served = start(cli_args(dict(overrides(synth_dir, tmp, "dense"), val_only=True,
                                 checkpoint_dir=str(tmp / "serve_ck"),
                                 result_json_path=serve_path,
                                 load_checkpoint_name=str(tmp / "init_copy_dense"))))
    finish([served])
    return {"mp": mp, "jax": ref, "served": results(serve_path, 1)[0]}


def assert_metrics_close(got, want, tol=TOL["metric"]):
    for section, metrics in want.items():
        for k, v in metrics.items():
            t = TOL["entropy"] if k.startswith("Entropy") else tol
            assert got[section][k] == pytest.approx(v, abs=t), (section, k)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_hold_one_state(runs, case):
    r0, r1 = runs["mp"][case]
    assert (r0["process_index"], r1["process_index"]) == (0, 1)
    assert r0["final_loss"] == pytest.approx(r1["final_loss"], rel=TOL["between_ranks"])
    assert r0["param_checksum"] == pytest.approx(r1["param_checksum"],
                                                 rel=TOL["between_ranks"])
    assert r0["result"] == r1["result"]
    k = CASES[case][0].get("accumulate_grad", 1)
    assert [s for s, _ in r0["losses"]] == list(range(1, STEPS * k + 1))
    # the pool gather and its gradient, the towers' gradient all-reduce,
    # ZeRO-2's broadcasts and the corpus gather all ran
    for tag in ("pool_gather", "pool_gather_grad", "grad_all_reduce", "zero_broadcast",
                "corpus_gather"):
        assert r0["collective_bytes"].get(tag, 0) > 0, tag


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_composed_run(runs, case):
    mp, ref = runs["mp"][case][0], runs["jax"][CASES[case][1]]
    assert mp["final_loss"] == pytest.approx(ref["final_loss"], rel=TOL["loss"])
    assert_metrics_close(mp["result"], ref["result"])


def test_two_rank_checkpoint_serves_at_one_rank(runs):
    served, mp = runs["served"], runs["mp"]["dense"][0]
    assert served["final_loss"] is None and served["process_index"] == 0
    assert served["param_checksum"] == pytest.approx(mp["param_checksum"], rel=1e-6)
    assert_metrics_close(served["result"], mp["result"], tol=1e-7)


# ---------------------------------------------------------------------------
# the gathered pool and the corpus pass, two ranks of the parallel worker
@pytest.fixture(scope="module")
def worker(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp_hllm_worker")
    # the packed tower (the port's departure from the JAX layout), negatives
    # per category: one gather a category
    over = dict(overrides(synth_dir, tmp, "dense"), packed_item_tower=True, pack_chunk=64,
                neg_sample_by_cat=True, checkpoint_dir=str(tmp / "ck"))
    jt, jcfg, jdata = jax_trainer(dict(over, packed_item_tower=False), tmp, "worker")
    params = jax.tree.map(np.asarray, jt.state.params)
    tcfg = Config(config_file_list=YAMLS, config_dict=over).finalize()
    sd = state_dict_from_flax(params, tcfg)
    torch.save(sd, tmp / "hllm_init.pt")
    with open(tmp / "hllm_spec.json", "w") as fh:
        json.dump({"config": over}, fh)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_parallel_worker.py"),
                               "hllm", str(r), str(WORLD), str(port), str(tmp)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    # meanwhile: JAX's global pool over the composed batch, and one
    # process's corpus table
    parts = [next(JaxTextBatcher(jcfg, jdata, host_id=h, num_hosts=WORLD).epoch_batches(0))
             for h in range(WORLD)]
    composed = {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}
    neg = jt.model.apply({"params": jt.state.params}, jnp.asarray(composed["neg_tokens"]),
                         jnp.asarray(composed["neg_token_lens"]), method="encode_items")
    neg = neg.reshape(*composed["neg_items"].shape[:2], -1, neg.shape[-1])
    # the loss gathers one pool a category (hierarchical heads, negatives
    # drawn per category)
    jax_pools = [np.asarray(jax_cosine_normalize(neg[:, c]).reshape(-1, neg.shape[-1]))
                 for c in range(over["num_prior_head"])]
    one = Trainer(tcfg, InteractionData(tcfg).build(), device="cpu")
    one.setup_model()
    one.model.load_state_dict(sd)
    table = one.compute_item_feature()
    finish(procs)
    ranks = [torch.load(tmp / f"hllm.{r}.pt") for r in range(WORLD)]
    return {"ranks": ranks, "jax_pools": jax_pools, "table": table,
            "one_batch": one._corpus_batcher.batch_size}


def test_gathered_pool_is_jaxs_global_pool(worker):
    """Each rank's gathered pool holds both ranks' negatives, rank 0's
    first: JAX's ``_neg_norm`` over the global batch, row for row."""
    r0, r1 = worker["ranks"]
    assert len(r0["pools"]) == len(worker["jax_pools"]) == 4
    for p0, p1, want in zip(r0["pools"], r1["pools"], worker["jax_pools"]):
        assert torch.equal(p0, p1)
        np.testing.assert_allclose(p0.numpy(), want, atol=2e-5, rtol=0)


def test_corpus_pass_over_two_ranks_is_one_process_table(worker):
    """Each rank encodes its half of every corpus batch (24 items, 12 a
    rank) and the gathered table equals one process's, on the device and
    in host memory; the host copy equals the device table exactly."""
    r0, r1 = worker["ranks"]
    assert r0["corpus_batch"] == worker["one_batch"] == 24
    for r in (r0, r1):
        np.testing.assert_allclose(r["table"].numpy(), worker["table"].numpy(),
                                   atol=1e-5, rtol=0)
        assert torch.equal(r["host_table"], r["table"])
        assert r["traffic"]["corpus_gather"] > 0
    assert torch.equal(r0["table"], r1["table"])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("refusal", ["dedup_items", "flat_packing"])
def test_text_batcher_refuses_what_jax_refuses(synth_dir, tmp_path, refusal):
    """The JAX package's multi-host refusals (textset.py:450-463), with its
    messages, in both packages."""
    over = dict(overrides(synth_dir, tmp_path, "dense"), checkpoint_dir=str(tmp_path))
    if refusal == "dedup_items":
        over.update(dedup_items=True)
        msg = ("dedup_items is single-process only; use the dense or packed item tower "
               "under multi-host")
    else:
        over.update(packed_item_tower=True, pack_chunk=0)
        msg = ("multi-host packed_item_tower requires chunked packing (pack_chunk > 0): the "
               "legacy flat stream has a per-host data-dependent length")
    tcfg = Config(config_file_list=YAMLS, config_dict=over).finalize()
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
    for batcher, cfg, data in ((TextSEQTrainBatcher, tcfg, InteractionData(tcfg).build()),
                               (JaxTextBatcher, jcfg, JaxData(jcfg).build())):
        with pytest.raises(ValueError) as err:
            batcher(cfg, data, host_id=0, num_hosts=WORLD)
        assert str(err.value) == msg
        batcher(cfg, data, host_id=0, num_hosts=1)  # one host takes it


def test_packed_corpus_pass_is_single_process(synth_dir, tmp_path):
    """Under W > 1 the corpus pass refuses ``packed_corpus_pass`` with the
    JAX package's message (trainer.py:974-978), before any collective."""
    over = dict(overrides(synth_dir, tmp_path, "dense"), packed_item_tower=True,
                pack_chunk=64, packed_corpus_pass=True, checkpoint_dir=str(tmp_path))
    t = Trainer(Config(config_file_list=YAMLS, config_dict=over).finalize(),
                InteractionData(Config(config_file_list=YAMLS, config_dict=over).finalize())
                .build(), device="cpu")
    t.setup_model()
    t.mesh, t.world = DataMesh(0, WORLD), WORLD
    with pytest.raises(ValueError) as err:
        t.compute_item_feature()
    assert str(err.value) == ("packed_corpus_pass is single-process only; the dense corpus "
                              "pass shards rows across hosts")
