"""Tensor parallelism (``tp_size > 1``) of the port's HLLM towers over gloo
ranks on the CPU, against the JAX package.

Ranks of ``tests/torch_parallel_worker.py tp`` (a free port, a time limit)
run each case through the trainer as ``run.train`` does: the one-process
checkpoint of the JAX parameters (carried across by ``convert.py``) loaded
by slicing, the first batch's loss and gradients (the split parameters'
assembled whole), 2 steps with an evaluation and a best-checkpoint save,
the test split from the saved checkpoint. The JAX ``Trainer`` runs the
same steps in this process meanwhile, at ``tp_size: 1`` (GSPMD's split
changes no number; a JAX ``tp_size > 1`` run on the conftest's mesh takes
minutes of compiles), on the same batches: one process's for a data world
of one, the two data ranks' composed in order otherwise. Cases:

* (i) ``tp2``: T = 2 over 2 ranks, the tiny Llama's 4 heads over 2 KV
  heads all split, dense item tower;
* (ii) ``tp2_kv1``: T = 2 with one KV head, so ``k_proj`` / ``v_proj``
  stay whole and their gradients are the model group's sum (left unsummed,
  they fail ``chip_smoke.py``'s bound on the card's gradients);
  ``tp2_q_whole``: 3 heads at T = 2, a whole ``q_proj`` whose heads the
  ranks' ``o_proj`` columns cut; ``tp2_kv_gather``: 9 heads over 3 KV
  heads at T = 2, the KV heads gathered one per local query head;
* (iii) ``dp2_tp2_packed``: data 2 × model 2 over 4 ranks, the packed item
  tower, and ``dp2_tp2_fsdp``, the same under ``fsdp: true`` (blocks cut
  from the ranks' shards over the data group);
* (iv) ``tp2_alibi``: an ALiBi tower at T = 2 on the dense path, each
  rank with its heads' slopes;
* (v) HSTU: ``hstu_tp2`` (data 1 × model 2) bit-equal to one process, and
  ``hstu_dp2_tp2_sharded`` (data 2 × model 2, the row-sharded table over
  the data group) against the JAX composed run;
* (vi) the T = 2 checkpoint of (i) served by one process gives the ranks'
  metrics, and a one-process checkpoint (every case's start) loads and
  serves at T = 2 as at one process;
* (vii) the sharding rule itself (``parallel/tensor.py::tp_params``), as
  the JAX test asserts it, and each rank's local shapes.

Tolerances are the JAX HLLM multi-process test's: loss relative 5e-4,
ranking metrics absolute 5e-5, Entropy 2e-3 (HSTU: 2e-4, checksum 1e-5,
3e-5); gradients to a relative L2 error of 2e-4 with a floor of 1e-4 of the
largest (``tests/test_torch_hllm_train.py``); the ranks of a run agree to
relative 1e-6 and report equal metrics.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.evalset import SeqEvalBatcher as JaxEvalBatcher
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from mhrec_tpu_torch.models.llm.config import LLMConfig
from mhrec_tpu_torch.parallel.tensor import tp_params
from mhrec_tpu_torch.trainer import Trainer
from tests.test_multiprocess import BASE_OVERRIDES, ComposedBatcher
from tests.test_torch_hllm_train import _rel_l2
from tests.test_torch_multiprocess import _np_tree, checksum_jax
from tests.test_torch_multiprocess_hllm import (BASE, ComposedText, free_port, init_checkpoint,
                                                jax_trainer)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
HSTU_FILES = ["IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"]
PROC_TIMEOUT = 400
STEPS = 2
TOL = {"loss": 5e-4, "metric": 5e-5, "entropy": 2e-3, "between_ranks": 1e-6, "grad": 2e-4}
HSTU_TOL = {"loss": 2e-4, "checksum": 1e-5, "metric": 3e-5, "entropy": 2e-3}
TOWER = {"model_type": "llama", "vocab_size": 1024, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
         "max_position_embeddings": 512}
# q_whole: 3 heads of 16 over one KV head, 48 wide: at T = 2 q_proj stays
# whole (3 % 2) while o_proj splits (48 % 2), so rank 1's columns [24, 48)
# begin inside head 1 (heads [1, 3), offset 8 into their context);
# kv_gather: 9 heads of 8 over 3 KV heads, 72 wide: rank 0 attends with
# heads [0, 5) and rank 1 with [4, 9), which read KV heads 0 0 0 1 1 and
# 1 1 2 2 2, no strided view of the whole projection's heads, so the KV
# heads are gathered one per query head
TOWERS = {"kv1": dict(TOWER, num_key_value_heads=1), "alibi": dict(TOWER, alibi=True),
          "q_whole": dict(TOWER, hidden_size=48, num_attention_heads=3, num_key_value_heads=1),
          "kv_gather": dict(TOWER, hidden_size=72, num_attention_heads=9,
                            num_key_value_heads=3)}
HLLM_BASE = dict(BASE, total_iters=STEPS, eval_interval=STEPS)
# case: (world, overrides, the JAX run it is held to, the worker's flags)
CASES = {
    "tp2": (2, dict(tp_size=2), "dense", dict(grads=True, serve_init=True)),
    "tp2_kv1": (2, dict(tp_size=2, tower="kv1"), "kv1", dict(grads=True)),
    "tp2_alibi": (2, dict(tp_size=2, tower="alibi"), "alibi", {}),
    "tp2_q_whole": (2, dict(tp_size=2, tower="q_whole"), "q_whole", dict(grads=True)),
    "tp2_kv_gather": (2, dict(tp_size=2, tower="kv_gather"), "kv_gather", dict(grads=True)),
    "dp2_tp2_packed": (4, dict(tp_size=2, packed_item_tower=True, pack_chunk=64), "packed", {}),
    "dp2_tp2_fsdp": (4, dict(tp_size=2, packed_item_tower=True, pack_chunk=64, fsdp=True,
                             fsdp_min_size=1024), "packed", {}),
}
# HSTU (v): size1 in float32 without dropout, the numpy sampler
HSTU_OVER = dict(BASE_OVERRIDES, hidden_dropout_prob=0.0, total_iters=STEPS,
                 eval_interval=STEPS, use_native_sampler=False, compute_dtype="float32",
                 optim_args={"learning_rate": 1e-4, "weight_decay": 0.0})
HSTU_CASES = {"hstu_tp2": (2, dict(tp_size=2)),
              "hstu_dp2_tp2_sharded": (4, dict(tp_size=2, shard_item_embedding=True))}


def hllm_over(meta, tmp, tower=None, **over):
    over = dict(HLLM_BASE, data_path=meta["data_path"], dataset=meta["name"],
                text_path=meta["text_path"], **over)
    if tower:
        path = tmp / f"tower_{tower}"
        over.update(item_pretrain_dir=str(path), user_pretrain_dir=str(path))
        if not (path / "tokenizer.json").exists():
            # a tokenizer both packages read alike (tests/test_torch_tokenizer_hllm.py):
            # without one the JAX package asks ``transformers`` for one and
            # the port hashes
            os.makedirs(path, exist_ok=True)
            (path / "config.json").write_text(json.dumps(TOWERS[tower]))
            jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
            jdata = JaxData(jcfg).build()
            chip_smoke.write_llama_tokenizer(
                str(path), chip_smoke.rendered_texts(jcfg, jdata.item_text, jdata.item_num),
                TOWER["vocab_size"])
    return over


def start_ranks(out, world, cases):
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "spec.json"), "w") as fh:
        json.dump({"cases": cases}, fh)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    return [subprocess.Popen([sys.executable, worker, "tp", str(r), str(world), str(port), out],
                             cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish(procs):
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def jax_grads(prepared):
    """The first batch's loss and gradients of ``prepared`` (``jax_trainer``'s
    trainer, config and data) at its parameters. Called from one thread at a
    time: computed on four threads at once beside the fits, one case's item
    tower gradients came out wrong (relative L2 error above 1, the case
    changing from run to run), one at a time every case's match the port."""
    jt, jcfg, jdata = prepared
    params = jax.tree.map(np.asarray, jt.state.params)
    batch = next(JaxTextBatcher(jcfg, jdata).epoch_batches(0))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "mix", "neg"))}

    def loss_fn(p):
        out = jt.model.apply({"params": p}, {k: jnp.asarray(v) for k, v in batch.items()},
                             deterministic=False, rngs=rngs)
        return out["loss"]

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    return {"loss0": float(loss), "grads": jax.tree.map(np.asarray, g)}


def jax_hllm(prepared, composed):
    """The JAX run of ``prepared`` from its parameters: the fit over one
    process's or the two hosts' composed batches, the test split."""
    jt, jcfg, jdata = prepared
    rec = {"params": jax.tree.map(np.asarray, jt.state.params)}
    stream = ComposedText(jcfg, jdata) if composed else JaxTextBatcher(jcfg, jdata)
    step, losses = jt._jit_train_step, []

    def recorded(state, batch):  # every step's loss
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
        return state, out

    jt._jit_train_step = recorded
    stats = jt.fit(stream, None)
    rec.update(final_loss=float(stats["loss"]), losses=losses,
               result=jt.evaluate(JaxEvalBatcher(jcfg, jdata, phase="test"),
                                  load_best_model=False))
    return rec


def jax_hstu(config, tmp):
    """The JAX HSTU run over the two hosts' composed batches (the row-sharded
    table's reference, tests/test_torch_multiprocess_table.py)."""
    jcfg = JaxConfig(config_file_list=HSTU_FILES, config_dict=dict(
        config, checkpoint_dir=str(tmp / "jax_hstu"), sparse_adam_global_dedup=True)).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    params = _np_tree(jt.state.params)
    stats = jt.fit(ComposedBatcher(jcfg, jdata), None)
    return {"params": params, "final_loss": float(stats["loss"]),
            "result": jt.evaluate(JaxEvalBatcher(jcfg, jdata, phase="test"),
                                  load_best_model=False),
            "param_checksum": checksum_jax(jt.state.params)}


def port_hstu(config, tmp, name, init=None):
    cfg = Config(config_file_list=HSTU_FILES, config_dict=dict(
        config, checkpoint_dir=str(tmp / name))).finalize()
    t = Trainer(cfg, InteractionData(cfg).build(), device="cpu")
    t.setup_model()
    if init is not None:
        t.model.load_state_dict(state_dict_from_flax(init, t.config))
    return t


@pytest.fixture(scope="module")
def runs(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tp")
    jax_cases = {"dense": (hllm_over(synth_dir, tmp), True, False),
                 "kv1": (hllm_over(synth_dir, tmp, "kv1"), True, False),
                 "alibi": (hllm_over(synth_dir, tmp, "alibi"), False, False),
                 "q_whole": (hllm_over(synth_dir, tmp, "q_whole"), True, False),
                 "kv_gather": (hllm_over(synth_dir, tmp, "kv_gather"), True, False),
                 "packed": (hllm_over(synth_dir, tmp, packed_item_tower=True, pack_chunk=64),
                            False, True)}
    # the JAX parameters of each tower, as one-process port checkpoints
    with ThreadPoolExecutor(4) as pool:
        prepared = dict(zip(jax_cases, pool.map(lambda n: jax_trainer(jax_cases[n][0], tmp, n),
                                                jax_cases)))
    inits = {name: init_checkpoint(prepared[name][0].state.params, jax_cases[name][0], tmp,
                                   name)[0] for name in jax_cases}
    hstu_config = dict(HSTU_OVER, data_path=synth_dir["data_path"], dataset=synth_dir["name"],
                       text_path=synth_dir["text_path"])
    # the HSTU cases start from the JAX HSTU's initial weights as well
    jcfg = JaxConfig(config_file_list=HSTU_FILES, config_dict=dict(
        hstu_config, checkpoint_dir=str(tmp / "jax_hstu_init"))).finalize()
    jh = JaxTrainer(jcfg, JaxData(jcfg).build())
    jh.model = jh.model.clone(dtype=jnp.float32)
    jh.setup_model()
    hstu_init = port_hstu(hstu_config, tmp, "hstu_init", _np_tree(jh.state.params))
    hstu_init.async_checkpoint = False
    hstu_init.save_checkpoint()
    specs = {2: [], 4: []}
    for case, (world, over, ref, flags) in CASES.items():
        over = dict(over)
        config = hllm_over(synth_dir, tmp, over.pop("tower", None), **over)
        specs[world].append(dict(name=case, files=YAMLS, config=config, init_dir=inits[ref],
                                 **flags))
    for case, (world, over) in HSTU_CASES.items():
        specs[world].append(dict(name=case, files=HSTU_FILES, config=dict(hstu_config, **over),
                                 init_dir=hstu_init.saved_model_dir))
    procs = []
    for world, cases in specs.items():
        procs += start_ranks(str(tmp / f"w{world}"), world, cases)
    try:
        # meanwhile: the JAX runs and the one-process port runs; the
        # gradients first, one case at a time
        grads = {name: jax_grads(prepared[name])
                 for name, (_, with_grads, _) in jax_cases.items() if with_grads}
        with ThreadPoolExecutor(4) as pool:
            futures = {name: pool.submit(jax_hllm, prepared[name], composed)
                       for name, (_, _, composed) in jax_cases.items()}
            futures["hstu"] = pool.submit(jax_hstu, hstu_config, tmp)
            jax_runs = {name: f.result() for name, f in futures.items()}
        for name, rec in grads.items():
            jax_runs[name].update(rec)
        one = port_hstu(hstu_config, tmp, "hstu_one")
        one.saved_model_dir = hstu_init.saved_model_dir
        assert one.load_checkpoint()
        one.saved_model_dir = str(tmp / "hstu_one_ckpt")
        from mhrec_tpu_torch.data import build_dataloader

        train, valid, test = build_dataloader(one.config, one.dataload)
        stats = one.fit(train, valid)
        one_hstu = {"losses": one.fetched_losses, "final_loss": float(stats["loss"]),
                    "checksum": one.param_checksum(),
                    "result": one.evaluate(test, load_best_model=True)}
    finally:
        finish(procs)
    ranks = {case: [torch.load(str(tmp / f"w{w}" / f"{case}.{r}.pt"), weights_only=False)
                    for r in range(w)]
             for case, (w, *_) in {**CASES, **HSTU_CASES}.items()}
    return {"ranks": ranks, "jax": jax_runs, "one_hstu": one_hstu, "tmp": tmp,
            "inits": inits, "meta": synth_dir}


def assert_metrics_close(got, want, tol=TOL["metric"], entropy=TOL["entropy"]):
    for section, metrics in want.items():
        for k, v in metrics.items():
            t = entropy if k.startswith("Entropy") else tol
            assert got[section][k] == pytest.approx(v, abs=t), (section, k)


@pytest.mark.parametrize("case", list(CASES) + list(HSTU_CASES))
def test_model_ranks_hold_one_state(runs, case):
    ranks = runs["ranks"][case]
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["final_loss"] == pytest.approx(r0["final_loss"], rel=TOL["between_ranks"])
        assert r["checksum"] == pytest.approx(r0["checksum"], rel=TOL["between_ranks"])
        assert r["result"] == r0["result"]
    assert [s for s, _ in r0["losses"]] == list(range(1, STEPS + 1))
    world = len(ranks)
    assert [r["mesh"] for r in ranks] == [(i // 2, world // 2) for i in range(world)]
    if case.startswith("hstu"):
        assert not any(t.startswith("tp_") for t in r0["traffic"])  # replicas
        return
    # the row-parallel sums, the column-parallel input gradients
    for tag in ("tp_reduce", "tp_input_grad"):
        assert r0["traffic"].get(tag, 0) > 0, tag
    assert ("tp_whole_grad" in r0["traffic"]) == (case in WHOLE_IN_SPLIT)
    if world == 4:
        # the data group's pool gather and gradient all-reduce
        for tag in ("pool_gather", "grad_all_reduce", "corpus_gather"):
            assert r0["traffic"].get(tag, 0) > 0, tag


@pytest.mark.parametrize("case", list(CASES))
def test_tp_run_matches_the_jax_run(runs, case):
    r0, ref = runs["ranks"][case][0], runs["jax"][CASES[case][2]]
    assert [l for _, l in r0["losses"]] == pytest.approx(ref["losses"], rel=TOL["loss"])
    assert r0["final_loss"] == pytest.approx(ref["final_loss"], rel=TOL["loss"])
    assert_metrics_close(r0["result"], ref["result"])


# the projections that stay whole inside a split block, by case
WHOLE_IN_SPLIT = {"tp2_kv1": (".k_proj.", ".v_proj."),
                  "tp2_q_whole": (".q_proj.", ".k_proj.", ".v_proj."),
                  "tp2_kv_gather": (".q_proj.", ".k_proj.", ".v_proj.")}


@pytest.mark.parametrize("case", ["tp2", "tp2_kv1", "tp2_q_whole", "tp2_kv_gather"])
def test_gathered_gradients_match_jax(runs, case):
    """(i), (ii): the first batch's loss and every gradient, the split
    parameters assembled from the two ranks; under one KV head the whole
    k_proj / v_proj gradients are the model group's sum; a whole q_proj
    whose heads the ranks' o_proj columns cut (``tp2_q_whole``) and KV
    heads gathered one per local query head (``tp2_kv_gather``) give
    JAX's loss and gradients too. Each case's layout is checked on the
    layer itself."""
    r0 = runs["ranks"][case][0]
    ref = runs["jax"][CASES[case][2]]
    # the loss's logit tables are bfloat16 products: XLA's fused float32
    # order can round a logit apart (the one-process port and an unjitted
    # JAX forward agree to 1.1e-7 here)
    assert r0["loss0"] == pytest.approx(ref["loss0"], rel=TOL["loss"])
    cfg = Config(config_file_list=YAMLS, config_dict=hllm_over(
        runs["meta"], runs["tmp"], CASES[case][1].get("tower"))).finalize()
    want = state_dict_from_flax(ref["grads"], cfg)
    want.pop("user_llm.embed_tokens.weight", None)
    assert set(want) == set(r0["grads"])
    floor = 1e-4 * max(float(np.linalg.norm(g.numpy())) for g in want.values())
    for name, g in want.items():
        err = _rel_l2(r0["grads"][name].numpy(), g.numpy(), floor)
        assert err <= TOL["grad"], (case, name, err)
    whole = r0["whole_in_split"]
    if case in WHOLE_IN_SPLIT:
        kinds = WHOLE_IN_SPLIT[case]
        assert len(whole) == 2 * 2 * len(kinds), whole  # 2 towers x 2 layers
        assert all(any(k in n for k in kinds) for n in whole), whole
    else:
        assert whole == []
    # the attention layout the case is for, on both ranks
    layouts = {tuple(r["attention"]) for r in runs["ranks"][case]}
    want = {"tp2": {((0, 2), False), ((2, 4), False)},
            "tp2_kv1": {((0, 2), False), ((2, 4), False)},
            "tp2_q_whole": {((0, 2), False), ((1, 3), False)},
            "tp2_kv_gather": {((0, 5), True), ((4, 9), True)}}[case]
    assert layouts == want, layouts


def test_an_unsummed_whole_gradient_fails_the_card_bound(runs):
    """(ii), planted fault: the whole k_proj / v_proj gradients of one rank
    before the model group's sum (``tensor.sum_grads`` left out) are off
    JAX's by more than chip_smoke.py's bound on (g)'s gradients
    (``grad_errors`` at TP_GRAD_TOL), which the summed ones meet."""
    r0 = runs["ranks"]["tp2_kv1"][0]
    cfg = Config(config_file_list=YAMLS, config_dict=hllm_over(
        runs["meta"], runs["tmp"], "kv1")).finalize()
    want = state_dict_from_flax(runs["jax"]["kv1"]["grads"], cfg)
    want.pop("user_llm.embed_tokens.weight", None)

    def errors(grads):
        return chip_smoke.grad_errors([
            (n, float((grads[n].double() - g.double()).square().sum()),
             float(g.double().square().sum())) for n, g in want.items()])

    summed = errors(r0["grads"])
    planted = errors(dict(r0["grads"], **r0["unsummed"]))
    assert set(r0["unsummed"]) == set(r0["whole_in_split"]) and r0["unsummed"]
    assert max(summed.values()) <= chip_smoke.TP_GRAD_TOL["float32"], summed
    # every share that is not float32 noise (the user tower's q / k
    # gradients are, at 1e-7 of the largest, under the bound's floor)
    largest = max(float(g.norm()) for g in want.values())
    real = [n for n in r0["unsummed"] if float(want[n].norm()) >= 1e-3 * largest]
    assert len(real) >= 4, real  # k and v of the item tower's two layers at least
    assert min(planted[n] for n in real) > 10 * chip_smoke.TP_GRAD_TOL["float32"], planted


def test_fsdp_grid_equals_the_zero2_grid(runs):
    """(iii): under fsdp the data 2 × model 2 run's blocks are cut from the
    shards, and it trains as the ZeRO-2 grid."""
    f, z = runs["ranks"]["dp2_tp2_fsdp"], runs["ranks"]["dp2_tp2_packed"]
    assert f[0]["traffic"].get("fsdp_gather", 0) > 0
    assert f[0]["final_loss"] == pytest.approx(z[0]["final_loss"], rel=1e-6)
    assert f[0]["checksum"] == pytest.approx(z[0]["checksum"], rel=1e-6)
    assert f[0]["result"] == z[0]["result"]
    for a, b in zip(f, z):
        assert a["persistent_bytes"]["params"] < b["persistent_bytes"]["params"]


def test_hstu_replicas_equal_one_process(runs):
    """(v): an ID model's model ranks are replicas: data 1 × model 2 is one
    process, bit for bit."""
    r0, one = runs["ranks"]["hstu_tp2"][0], runs["one_hstu"]
    assert r0["losses"] == one["losses"] and r0["final_loss"] == one["final_loss"]
    assert r0["checksum"] == one["checksum"]
    assert r0["result"] == one["result"]
    assert r0["split"] == {}


def test_sharded_hstu_grid_matches_the_jax_composed_run(runs):
    """(v): the row-sharded table over the data group of a 2 × 2 grid."""
    r0, ref = runs["ranks"]["hstu_dp2_tp2_sharded"][0], runs["jax"]["hstu"]
    assert r0["final_loss"] == pytest.approx(ref["final_loss"], rel=HSTU_TOL["loss"])
    assert r0["checksum"] == pytest.approx(ref["param_checksum"], rel=HSTU_TOL["checksum"])
    assert_metrics_close(r0["result"], ref["result"], HSTU_TOL["metric"], HSTU_TOL["entropy"])
    assert r0["traffic"].get("table_chunk", 0) > 0


def _one_process(runs, ckpt_dir, name):
    """One process's test split of the checkpoint in ``ckpt_dir`` ((i)'s
    model)."""
    cfg = Config(config_file_list=YAMLS, config_dict=dict(
        hllm_over(runs["meta"], runs["tmp"]), checkpoint_dir=str(runs["tmp"] / name))).finalize()
    t = Trainer(cfg, InteractionData(cfg).build(), device="cpu")
    t.setup_model()
    shutil.copytree(ckpt_dir, t.saved_model_dir)
    return t, t.evaluate(SeqEvalBatcher(cfg, t.dataload, phase="test"), load_best_model=True)


@pytest.mark.parametrize("direction", ["save_tp2_serve_one", "save_one_serve_tp2"])
def test_checkpoints_cross_tp_sizes(runs, direction):
    """(vi): the T = 2 checkpoint (the one-process layout, assembled on
    rank 0) served by one process gives the ranks' metrics and checksum;
    the one-process checkpoint every case starts from serves at T = 2 as
    at one process."""
    r0 = runs["ranks"]["tp2"][0]
    if direction == "save_tp2_serve_one":
        t, result = _one_process(runs, os.path.dirname(r0["checkpoint"]), "serve_tp2")
        assert t.param_checksum() == pytest.approx(r0["checksum"], rel=1e-6)
        for k, v in torch.load(r0["checkpoint"], weights_only=True)["params"].items():
            assert tuple(v.shape) == tuple(t.model.state_dict()[k].shape), k
        assert_metrics_close(result, r0["result"])
    else:
        _, result = _one_process(runs, runs["inits"]["dense"], "serve_one")
        assert_metrics_close(r0["init_result"], result)


def test_sharding_rule_is_jaxs():
    """(vii): JAX's rule (``tests/test_sharding.py:150-217``): at tp 4 the
    tiny Llama's q_proj and down_proj split, k_proj stays whole (2 KV heads
    < 4); Qwen2-1.5B keeps k/v whole at T = 4 and q whole at T = 8, where
    its o_proj and MLP still split."""
    tiny = LLMConfig.tiny()
    rule = tp_params(tiny, 4)
    assert rule["self_attn.q_proj.weight"] == 0 and rule["mlp.down_proj.weight"] == 1
    assert "self_attn.k_proj.weight" not in rule and "self_attn.v_proj.weight" not in rule
    qwen = LLMConfig(hidden_size=1536, intermediate_size=8960, num_attention_heads=12,
                     num_key_value_heads=2, attention_bias=True)
    assert set(tp_params(qwen, 4)) == {
        "self_attn.q_proj.weight", "self_attn.q_proj.bias", "self_attn.o_proj.weight",
        "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight"}
    assert set(tp_params(qwen, 8)) == {"self_attn.o_proj.weight", "mlp.gate_proj.weight",
                                       "mlp.up_proj.weight", "mlp.down_proj.weight"}
    assert tp_params(qwen, 1) == {}
    assert tp_params(dataclasses.replace(qwen, attention_bias=False), 2) == {
        n: d for n, d in tp_params(qwen, 2).items() if not n.endswith(".bias")}


@pytest.mark.parametrize("case", ["tp2", "tp2_kv1", "dp2_tp2_packed"])
def test_each_rank_holds_its_shards(runs, case):
    """(vii): each rank's local shapes are its shards of what JAX's rule
    splits, whole elsewhere; the persistent bytes count the shards; the
    moments keep the shards' shapes across a save."""
    ranks = runs["ranks"][case]
    one = {k: tuple(v.shape) for k, v in torch.load(
        ranks[0]["checkpoint"], weights_only=True)["params"].items()}
    kv_split = case != "tp2_kv1"
    for r in ranks:
        for name, shape in r["shapes"].items():
            dim = r["split"].get(name)
            want = list(one[name])
            if dim is not None:
                want[dim] //= 2
            assert shape == tuple(want), (name, shape, want)
        split = r["split"]
        for tower in ("item_llm", "user_llm"):
            for layer in (0, 1):
                pre = f"{tower}.layers.{layer}."
                assert split[pre + "self_attn.q_proj.weight"] == 0
                assert split[pre + "self_attn.o_proj.weight"] == 1
                assert split[pre + "mlp.down_proj.weight"] == 1
                assert (pre + "self_attn.k_proj.weight" in split) == kv_split
        assert not any(n.startswith(("item_llm.embed_tokens", "item_emb_tokens"))
                       for n in split)
        whole = sum(int(np.prod(s)) for s in one.values())
        held = sum(int(np.prod(s)) for s in r["shapes"].values())
        assert held < whole
        assert r["persistent_bytes"]["params"] == 4 * held
        # the save assembled whole moments on rank 0 and left every rank's
        # own moments as they were
        assert r["moment_shapes"] and all(shape == r["shapes"][n]
                                          for n, shape in r["moment_shapes"].items())
