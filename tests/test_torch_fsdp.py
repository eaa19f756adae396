"""FSDP / ZeRO-3 over two ranks of the port's CLI (``python -m
mhrec_tpu_torch.run --multihost --num_processes 2 --device cpu``, gloo, a
free port, a time limit per process), ``fsdp_min_size`` 256 so that the
tiny models shard:

* HSTU (``tests/test_torch_multiprocess.py``'s model and protocol, the
  table under ``sparse_item_adam``, a global-norm clip that fires and
  ``accumulate_grad`` 2: one optimizer step of the 2 micro-steps) with
  ``zero_stage: 3`` against the same ranks under ZeRO-2; HLLM
  (``test_torch_multiprocess_hllm``'s tiny Llama towers) with ``fsdp: true``
  and gradient checkpointing against ZeRO-2. 2 steps (HLLM: 3, as in its multi-process test), an evaluation
  with a save, the test split from it. The
  checkpoints' parameters and moments are bit-equal where the clip does
  not fire, else within JAX's rtol 2e-5 (``tests/test_sharding.py:282``);
* the FSDP runs against the JAX package's one-process run over the
  composed batches, at the limits of those two test files;
* each rank keeps a block of ceil(n / 2) elements of every sharded
  parameter, and as many of each of its moments, and no whole sharded
  parameter or gradient is alive after a step; the sharded set is JAX's
  rule at the same data-axis size (the JAX ``Trainer``'s own placement over
  two of the conftest's CPU devices, read from each leaf's sharding);
* the W = 2 FSDP checkpoint, served by one process, gives the ranks'
  metrics; ``fsdp`` at one process changes nothing.
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.evalset import SeqEvalBatcher as JaxEvalBatcher
from mhrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch import run as run_mod
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from mhrec_tpu_torch.data.trainset import SEQTrainBatcher
from mhrec_tpu_torch.trainer import Trainer
from tests import test_torch_multiprocess as mp_hstu
from tests import test_torch_multiprocess_hllm as mp_hllm
from tests import torch_parallel_worker as W
from tests.test_multiprocess import ComposedBatcher

WORLD = 2
STEPS = 2
MIN_SIZE = 256
# HSTU: one optimizer step of two micro-steps (the 2 steps), under a clip
# that fires (JAX's run takes both too)
CLIP = 1e-3
HSTU_OVER = dict(mp_hstu.OVERRIDES, total_iters=1, eval_interval=1, accumulate_grad=STEPS,
                 fsdp_min_size=MIN_SIZE, clip_grad_norm=CLIP)
HSTU_CASES = {"zero2": {}, "zero3": {"zero_stage": 3}}
# HLLM takes its multi-process test's 3 steps
HLLM_OVER = dict(mp_hllm.BASE, fsdp_min_size=MIN_SIZE)
HLLM_CASES = {"zero2": {}, "fsdp": {"fsdp": True, "gradient_checkpointing": True}}
# (FSDP run, its ZeRO-2 run, whether the clip fires)
PAIRS = [("hstu", "zero3", "zero2", True), ("hllm", "fsdp", "zero2", False)]
CLIP_RTOL = 2e-5


def hstu_args(meta, tmp, case, init):
    return mp_hstu.cli_args(meta, str(tmp / f"ck_hstu_{case}"), str(tmp / f"hstu_{case}"),
                            dict(HSTU_OVER, **HSTU_CASES[case], load_checkpoint_name=init))


def hllm_over(meta, tmp):
    return dict(HLLM_OVER, data_path=meta["data_path"], dataset=meta["name"],
                text_path=meta["text_path"])


def checkpoint(tmp, model, case):
    """The payload of the checkpoint the ranks of a case wrote (into the
    directory they resumed from)."""
    return torch.load(tmp / f"init_{model}_{case}" / "checkpoint.pt", map_location="cpu",
                      weights_only=True)


def jax_sharded(jt):
    """The flax paths of the JAX trainer's parameters that its placement
    put over ``data``, as a tree of 1.0 (sharded) / 0.0 leaves of the
    parameters' shapes."""
    def mark(x):
        spec = getattr(x.sharding, "spec", ())
        return np.full(x.shape, float(any(s is not None for s in spec)), np.float32)

    return jax.tree.map(mark, jt.state.params)


@pytest.fixture(scope="module")
def runs(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fsdp")
    meta = synth_dir
    data_keys = dict(data_path=meta["data_path"], dataset=meta["name"],
                     text_path=meta["text_path"])
    # HSTU: the JAX initial weights as a port checkpoint, as in
    # test_torch_multiprocess
    jcfg = JaxConfig(config_file_list=mp_hstu.FILES, config_dict=dict(
        HSTU_OVER, **data_keys, checkpoint_dir=str(tmp / "jax"),
        sparse_adam_global_dedup=True)).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    tcfg = Config(config_file_list=mp_hstu.FILES, config_dict=dict(
        HSTU_OVER, **data_keys, checkpoint_dir=str(tmp / "init"),
        compute_dtype="float32")).finalize()
    init = Trainer(tcfg, InteractionData(tcfg).build(), device="cpu")
    init.setup_model()
    init.model.load_state_dict(state_dict_from_flax(mp_hstu._np_tree(jt.state.params), tcfg))
    init.async_checkpoint = False
    init.save_checkpoint()
    # HLLM: the JAX towers' random parameters, likewise
    hover = hllm_over(meta, tmp)
    hjt, hjcfg, hjdata = mp_hllm.jax_trainer(hover, tmp, "fsdp")
    hinit, _ = mp_hllm.init_checkpoint(hjt.state.params, hover, tmp, "fsdp")

    procs, paths = [], {}
    for case in HSTU_CASES:
        ck = str(tmp / f"init_hstu_{case}")
        shutil.copytree(init.saved_model_dir, ck)
        port = mp_hstu.free_port()
        procs += [mp_hstu.start(hstu_args(meta, tmp, case, ck), r, port) for r in range(WORLD)]
        paths[("hstu", case)] = str(tmp / f"hstu_{case}")
    for case, extra in HLLM_CASES.items():
        ck = str(tmp / f"init_hllm_{case}")
        shutil.copytree(hinit, ck)
        paths[("hllm", case)] = str(tmp / f"hllm_{case}")
        args = mp_hllm.cli_args(dict(hover, **extra, checkpoint_dir=str(tmp / f"ck_hllm_{case}"),
                                     result_json_path=paths[("hllm", case)],
                                     load_checkpoint_name=ck))
        port = mp_hllm.free_port()
        procs += [mp_hllm.start(args, r, port) for r in range(WORLD)]
    def jax_hstu():
        stats = jt.fit(ComposedBatcher(jcfg, jdata), None)
        return {"final_loss": float(stats["loss"]),
                "result": jt.evaluate(SeqEvalBatcher(jcfg, jdata, phase="test"),
                                      load_best_model=False),
                "param_checksum": mp_hstu.checksum_jax(jt.state.params)}

    def jax_hllm():
        stats = hjt.fit(mp_hllm.ComposedText(hjcfg, hjdata), None)
        return {"final_loss": float(stats["loss"]),
                "result": hjt.evaluate(JaxEvalBatcher(hjcfg, hjdata, phase="test"),
                                       load_best_model=False)}

    def jax_placement():
        spec_cfg = JaxConfig(config_file_list=mp_hstu.FILES, config_dict=dict(
            HSTU_OVER, **data_keys, fsdp=True, checkpoint_dir=str(tmp / "jax_spec"))).finalize()
        spec_t = JaxTrainer(spec_cfg, jdata)
        spec_t.mesh = jax_make_mesh(jax.devices()[:WORLD])
        spec_t.setup_model()
        marks = state_dict_from_flax(jax_sharded(spec_t), tcfg)
        return {k for k, v in marks.items() if float(v.flatten()[0]) == 1.0}

    try:
        # meanwhile, in threads (XLA compiles without the interpreter lock):
        # the JAX runs over the composed batches, and JAX's placement under
        # fsdp over two devices
        with ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(f) for f in (jax_hstu, jax_hllm, jax_placement)]
            ref_hstu, ref_hllm, jax_set = (j.result() for j in jobs)
    finally:
        mp_hstu.finish(procs)
    mp = {key: mp_hstu.results(path, WORLD) for key, path in paths.items()}
    # the HSTU FSDP checkpoint, served by one process (``run --val_only``'s
    # path, in this process)
    scfg = Config(config_file_list=mp_hstu.FILES, config_dict=dict(
        HSTU_OVER, **data_keys, compute_dtype="float32", val_only=True,
        checkpoint_dir=str(tmp / "serve_ck"), load_checkpoint_name=str(tmp / "init_hstu_zero3"))
                  ).finalize()
    served, _, result = run_mod.serve(scfg, InteractionData(scfg).build(), "cpu")
    served = {"result": result, "param_checksum": served.param_checksum(),
              "fsdp": served.fsdp}
    return {"tmp": tmp, "mp": mp, "jax": {"hstu": ref_hstu, "hllm": ref_hllm},
            "jax_sharded": jax_set, "served": served}


@pytest.mark.parametrize("model,case,ref,clipped", PAIRS,
                         ids=[f"{m}-{c}" for m, c, _, _ in PAIRS])
def test_fsdp_trains_as_zero2(runs, model, case, ref, clipped):
    """Parameters, both moments and every step's loss of the FSDP ranks
    against the ZeRO-2 ranks on the same batches."""
    got, want = checkpoint(runs["tmp"], model, case), checkpoint(runs["tmp"], model, ref)
    assert got["step"] == want["step"] == (STEPS if model == "hstu" else mp_hllm.STEPS)
    pairs = [(f"params {k}", got["params"][k], v) for k, v in want["params"].items()]
    for i, st in want["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            pairs.append((f"moment {i} {k}", got["optimizer"]["state"][i][k], st[k]))
    assert len(pairs) > 20
    for name, a, b in pairs:
        if clipped:
            # relative to the tensor's scale: Adam's moments cancel near 0
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=CLIP_RTOL, atol=CLIP_RTOL * scale, msg=name)
        else:
            assert torch.equal(a, b), name
    losses = [[l for _, l in r["losses"]] for r in (runs["mp"][(model, case)][0],
                                                      runs["mp"][(model, ref)][0])]
    assert len(losses[0]) == got["step"]
    if clipped:
        np.testing.assert_allclose(losses[0], losses[1], rtol=CLIP_RTOL)
    else:
        assert losses[0] == losses[1]


@pytest.mark.parametrize("model,case", [("hstu", "zero3"), ("hllm", "fsdp")])
def test_fsdp_ranks_hold_blocks(runs, model, case):
    """Every rank keeps ceil(n / 2) elements of each sharded parameter and of
    each of its two moments, the rest whole; the collectives of FSDP ran,
    and no whole sharded parameter or gradient was alive after a step."""
    for r, (rank, ref) in enumerate(zip(runs["mp"][(model, case)], runs["mp"][(model, "zero2")])):
        sharded = rank["fsdp_params"]
        assert len(sharded) >= 4, sharded
        saved = sum(n - k for n, k in sharded.values()) * 4  # float32
        assert all(k == -(-n // WORLD) for n, k in sharded.values())
        got, want = rank["persistent_bytes"], ref["persistent_bytes"]
        assert got["params"] == want["params"] - saved, r
        assert got["grads"] == want["grads"] - saved, r
        blocks = sum(k for _, k in sharded.values()) * 4
        assert got["block_params"] == blocks and got["block_moments"] == 2 * blocks
        if model == "hstu":  # the row-sharded table and its moments
            assert got["table"] < 0.51 * want["table"]
        assert rank["fsdp_live_whole"] == 0
        for tag in ("fsdp_gather", "fsdp_reduce_scatter", "fsdp_save"):
            assert rank["collective_bytes"].get(tag, 0) > 0, tag
        assert ref["fsdp_params"] == {}


def test_fsdp_shards_jax_set(runs):
    """The port's sharded parameters (and the row-sharded table) are the
    ones JAX's placement puts over ``data`` at the same size of the axis."""
    rank = runs["mp"][("hstu", "zero3")][0]
    port_set = set(rank["fsdp_params"]) | {"item_embedding.weight"}
    assert runs["jax_sharded"] == port_set
    assert "table_lookup" in rank["collective_bytes"]  # the row-sharded table


@pytest.mark.parametrize("model,case", [("hstu", "zero3"), ("hllm", "fsdp")])
def test_fsdp_matches_the_jax_composed_run(runs, model, case):
    r0, r1 = runs["mp"][(model, case)]
    assert r0["final_loss"] == pytest.approx(r1["final_loss"], rel=1e-6)
    assert r0["result"] == r1["result"]
    ref = runs["jax"][model]
    if model == "hstu":
        assert r0["final_loss"] == pytest.approx(ref["final_loss"], rel=2e-4)
        assert r0["param_checksum"] == pytest.approx(ref["param_checksum"], rel=1e-5)
        mp_hstu.assert_metrics_close(r0["result"], ref["result"])
    else:
        assert r0["final_loss"] == pytest.approx(ref["final_loss"], rel=mp_hllm.TOL["loss"])
        mp_hllm.assert_metrics_close(r0["result"], ref["result"])


def test_fsdp_checkpoint_serves_at_one_rank(runs):
    served, r0 = runs["served"], runs["mp"][("hstu", "zero3")][0]
    assert served["fsdp"] is None
    assert served["param_checksum"] == pytest.approx(r0["param_checksum"], rel=1e-6)
    mp_hstu.assert_metrics_close(served["result"], r0["result"])


def test_fsdp_at_one_process_changes_nothing(synth_dir, tmp_path):
    """Without a process group (and so at W = 1) ``fsdp`` shards nothing:
    two steps equal the plain run's bit for bit."""
    keys = dict(data_path=synth_dir["data_path"], dataset=synth_dir["name"],
                text_path=synth_dir["text_path"], total_iters=2, eval_interval=100,
                compute_dtype="float32")
    states = []
    for extra in ({}, {"fsdp": True, "zero_stage": 3}):
        cfg = Config(config_file_list=mp_hstu.FILES, config_dict=dict(
            HSTU_OVER, **keys, **extra, checkpoint_dir=str(tmp_path / str(len(states)))
        )).finalize()
        data = InteractionData(cfg).build()
        t = Trainer(cfg, data, device="cpu")
        t.setup_model()
        assert t.fsdp is None
        t.fit(SEQTrainBatcher(cfg, data), None)
        states.append({k: v.clone() for k, v in t.model.state_dict().items()})
    assert states[0].keys() == states[1].keys()
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_fsdp_collectives_and_tower_over_gloo(tmp_path):
    """FSDP's collectives and a sharded two-layer tower over two gloo ranks
    on the CPU (``tests/torch_parallel_worker.py fsdp``)."""
    W.check_fsdp_worker(W.fsdp_worker_ranks(tmp_path, "cpu"))
