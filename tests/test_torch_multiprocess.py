"""Two ranks of the port through its CLI (``python -m mhrec_tpu_torch.run
--multihost --num_processes 2``, gloo on the CPU, a free port, a time
limit per process) against single-process runs on the composed batches:
the port's own and the JAX package's (JAX ``Trainer`` + the
``ComposedBatcher`` of ``tests/test_multiprocess.py``, in this process),
with ``shard_item_embedding`` off and on; then the checkpoint the two ranks
wrote, served by one process.

All runs start from the JAX ``Trainer``'s initial weights (carried across by
``convert.py`` into a port checkpoint that the CLI resumes from), compute
the trunk in float32 (``compute_dtype``; the JAX model cloned to float32),
train 6 steps without dropout at the reference protocol's learning rate
1e-4, negatives from the numpy sampler (whose draws the two packages
share; tests/test_multiprocess.py's model otherwise), evaluate the valid
split with a best-checkpoint save and the test split from it.

Tolerances: against the port's composed run, the final loss relative 1e-5
(the ranks' products round apart from the composed batch's only in the
bfloat16 logit tables of the loss) and each step's loss 2e-4, since a
false negative near ``nce_thres`` may fall on the other side of it and
move one step's loss by about 1e-4; against JAX, the JAX multi-process test's own
(loss relative 2e-4, checksum relative 1e-5, ranking metrics absolute
3e-5, Entropy 2e-3, which a near-tie at rank k moves); the two ranks agree
to relative 1e-6.
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
from mhrec_tpu_torch.trainer import Trainer
from tests.test_multiprocess import BASE_OVERRIDES, ComposedBatcher

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import ComposedBatcher as PortComposed  # noqa: E402  the same 2 hosts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"]
WORLD = 2
# the numpy negative sampler, whose draws the two packages share
OVERRIDES = dict(BASE_OVERRIDES, hidden_dropout_prob=0.0, eval_interval=6,
                 use_native_sampler=False,
                 optim_args={"learning_rate": 1e-4, "weight_decay": 0.0})
PROC_TIMEOUT = 300


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_args(meta, ckpt_dir, result_path, extra):
    args = ["--config_file", *FILES, "--", "--device", "cpu",
            "--data_path", meta["data_path"], "--dataset", meta["name"],
            "--text_path", meta["text_path"], "--checkpoint_dir", ckpt_dir,
            "--result_json_path", result_path, "--compute_dtype", "float32"]
    for k, v in dict(OVERRIDES, **extra).items():
        args += [f"--{k}", json.dumps(v) if isinstance(v, (list, bool, dict)) else str(v)]
    return args


def start(args, rank=None, port=None):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    head = [sys.executable, "-m", "mhrec_tpu_torch.run"]
    if rank is not None:
        head += ["--multihost", "--coordinator_address", f"127.0.0.1:{port}",
                 "--num_processes", str(WORLD), "--process_id", str(rank)]
    return subprocess.Popen(head + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


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


def checksum_jax(params):
    import jax

    return float(sum(np.abs(np.asarray(x, np.float32)).sum(dtype=np.float64)
                     for x in jax.tree.leaves(params)))


@pytest.fixture(scope="module")
def runs(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp")
    meta = synth_dir
    data_keys = dict(data_path=meta["data_path"], dataset=meta["name"],
                     text_path=meta["text_path"])
    # the JAX initial weights as a port checkpoint
    jcfg = JaxConfig(config_file_list=FILES, config_dict=dict(
        OVERRIDES, **data_keys, checkpoint_dir=str(tmp / "jax"),
        sparse_adam_global_dedup=True)).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    tcfg = Config(config_file_list=FILES, config_dict=dict(
        OVERRIDES, **data_keys, checkpoint_dir=str(tmp / "init"),
        compute_dtype="float32")).finalize()
    tdata = InteractionData(tcfg).build()
    init = Trainer(tcfg, tdata, device="cpu")
    init.setup_model()
    init.model.load_state_dict(state_dict_from_flax(_np_tree(jt.state.params), tcfg))
    init.async_checkpoint = False
    init.save_checkpoint()

    def init_copy(name):
        dst = tmp / name
        shutil.copytree(init.saved_model_dir, dst)
        return str(dst)

    # the two 2-rank CLI runs, side by side
    port_runs = {}
    procs = []
    for shard in (False, True):
        path = str(tmp / f"mp_shard{int(shard)}")
        port = free_port()
        args = cli_args(meta, str(tmp / f"ck_shard{int(shard)}"), path,
                        dict(shard_item_embedding=shard,
                             load_checkpoint_name=init_copy(f"init_shard{int(shard)}")))
        procs += [start(args, r, port) for r in range(WORLD)]
        port_runs[shard] = path
    try:
        # meanwhile: the JAX run on the composed batches
        jstats = jt.fit(ComposedBatcher(jcfg, jdata), None)
        jres = jt.evaluate(SeqEvalBatcher(jcfg, jdata, phase="test"), load_best_model=False)
        jax_run = {"final_loss": float(jstats["loss"]), "result": jres,
                   "param_checksum": checksum_jax(jt.state.params)}
        # and the port's
        ocfg = Config(config_file_list=FILES, config_dict=dict(
            OVERRIDES, **data_keys, checkpoint_dir=str(tmp / "oracle"), compute_dtype="float32",
            sparse_adam_global_dedup=True, load_checkpoint_name=init_copy("init_oracle"))
                      ).finalize()
        odata = InteractionData(ocfg).build()
        oracle = Trainer(ocfg, odata, device="cpu")
        oracle.setup_model()
        ostats = oracle.fit(PortComposed(ocfg, odata), None)
        ores = oracle.evaluate(SeqEvalBatcher(ocfg, odata, phase="test"))
        port_oracle = {"final_loss": float(ostats["loss"]), "result": ores,
                       "losses": oracle.fetched_losses,
                       "param_checksum": oracle.param_checksum()}
    finally:
        finish(procs)
    mp = {shard: results(path, WORLD) for shard, path in port_runs.items()}
    # the checkpoints the two ranks wrote, served by one process each
    procs = []
    for shard in (False, True):
        ck = mp[shard][0]
        serve_path = str(tmp / f"serve_shard{int(shard)}")
        args = cli_args(meta, str(tmp / f"serve_ck{int(shard)}"), serve_path, dict(
            val_only=True, load_checkpoint_name=str(tmp / f"init_shard{int(shard)}")))
        procs.append(start(args))
        ck["serve_path"] = serve_path
    finish(procs)
    served = {shard: results(mp[shard][0]["serve_path"], 1)[0] for shard in (False, True)}
    return {"mp": mp, "jax": jax_run, "port": port_oracle, "served": served}


def _np_tree(params):
    """The flax params collection as nested dicts of numpy arrays."""
    import jax

    return jax.tree.map(np.asarray, jax.device_get(params))


def assert_metrics_close(got, want):
    for section, metrics in want.items():
        for k, v in metrics.items():
            tol = 2e-3 if k.startswith("Entropy") else 3e-5
            assert got[section][k] == pytest.approx(v, abs=tol), (section, k)


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "sharded"])
def test_two_ranks_hold_one_state(runs, shard):
    r0, r1 = runs["mp"][shard]
    assert (r0["process_index"], r1["process_index"]) == (0, 1)
    assert r0["final_loss"] == pytest.approx(r1["final_loss"], rel=1e-6)
    assert r0["param_checksum"] == pytest.approx(r1["param_checksum"], rel=1e-6)
    assert r0["result"] == r1["result"]
    assert [s for s, _ in r0["losses"]] == list(range(1, 7))


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "sharded"])
def test_cli_matches_the_ports_composed_run(runs, shard):
    mp, ref = runs["mp"][shard][0], runs["port"]
    assert mp["final_loss"] == pytest.approx(ref["final_loss"], rel=1e-5)
    np.testing.assert_allclose([l for _, l in mp["losses"]],
                               [l for _, l in ref["losses"]], rtol=2e-4)
    assert mp["param_checksum"] == pytest.approx(ref["param_checksum"], rel=1e-5)
    assert_metrics_close(mp["result"], ref["result"])


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "sharded"])
def test_cli_matches_the_jax_composed_run(runs, shard):
    mp, ref = runs["mp"][shard][0], runs["jax"]
    assert mp["final_loss"] == pytest.approx(ref["final_loss"], rel=2e-4)
    assert mp["param_checksum"] == pytest.approx(ref["param_checksum"], rel=1e-5)
    assert_metrics_close(mp["result"], ref["result"])


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "sharded"])
def test_two_rank_checkpoint_serves_at_one_rank(runs, shard):
    served, mp = runs["served"][shard], runs["mp"][shard][0]
    assert served["final_loss"] is None and served["process_index"] == 0
    assert served["param_checksum"] == pytest.approx(mp["param_checksum"], rel=1e-6)
    assert_metrics_close(served["result"], mp["result"])
