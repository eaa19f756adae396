"""The five baselines trained over two ranks of the port's CLI (``python -m
mhrec_tpu_torch.run --multihost --num_processes 2``, gloo on the CPU, a
free port, a time limit per process), one case a family (SASRec also with
its shared pool): SASRec, ComiRec, REMI and DualVAE here, LLMIDRec in
``test_torch_multiprocess_llmidrec.py``.

Each family is set up as ``tests/test_torch_baselines_train.py`` sets it up
(the JAX ``Trainer``'s initial weights, DualVAE's biases drawn from a seed,
ComiRec's and REMI's interest logits spread, carried across by
``convert.py`` into a checkpoint the CLI resumes from), at a global batch
of 16 (8 rows a rank), 3 steps at learning rate 1e-3, an evaluation of the
valid split with a best-checkpoint save and the test split from it.

* **Deterministic** (no dropout, DualVAE's z = μ, the batcher's
  per-position negatives under ``sparse_item_adam``): the JAX model's
  training forward runs with ``deterministic=True`` and the ranks' step
  generator is turned off (the launcher below, as the single-process test
  turns off its trainer's). The two ranks against the JAX package's run
  over the composed batches (``tests/test_multiprocess.py``'s
  ``ComposedBatcher``): every step's loss, the parameter checksum and the
  test metrics, at ``tests/test_torch_multiprocess.py``'s tolerances
  against JAX (loss relative 2e-4, checksum relative 1e-5, ranking metrics
  absolute 3e-5, Entropy 2e-3); the ranks to each other (relative 1e-6,
  equal metrics); their checkpoint served by one process (checksum
  relative 1e-6, the metrics).
* **With the draws** (dropout, DualVAE's reparameterisation noise, the
  in-model per-position negatives of SASRec; the dense optimizer, no
  ``sparse_item_adam``): the port's random streams are not JAX's, so the
  ranks' draws (``layers.batch_rows``: each rank keeps its rows of the
  global batch's draw) are held against the port's own single-process run
  over the composed batches, at ``test_torch_multiprocess.py``'s
  tolerances against that run (final loss relative 1e-5, each step's loss
  2e-4, checksum 1e-5, metrics as above).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.evalset import SeqEvalBatcher as JaxEvalBatcher
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from mhrec_tpu_torch.trainer import Trainer
from tests.test_multiprocess import ComposedBatcher
from tests.test_torch_baselines import FAMILIES as FAMILY_SETUPS
from tests.test_torch_baselines import SPREAD, TINY_LLAMA
from tests.test_torch_baselines_train import _seeded_biases, deterministic
from tests.test_torch_multiprocess import assert_metrics_close

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import ComposedBatcher as PortComposed  # noqa: E402  the same 2 hosts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
STEPS = 3
PROC_TIMEOUT = 300
FAMILIES = ["SASRec", "SASRec-pool", "ComiRec", "REMI", "DualVAE"]
# the ranks' launcher: run.py's main, with the trainer's step generator
# turned off when the first argument says "deterministic"
LAUNCH = ("import sys\n"
          "from mhrec_tpu_torch.trainer import Trainer\n"
          "if sys.argv.pop(1) == 'deterministic':\n"
          "    Trainer.step_generator = lambda self, step, rounding=False: None\n"
          "from mhrec_tpu_torch.run import main\n"
          "main(sys.argv[1:])\n")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def family_overrides(family, synth_dir, tmp, **over):
    """(config files, overrides) of ``family`` at this file's size."""
    files, fam = FAMILY_SETUPS[family]
    base = dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], MAX_ITEM_LIST_LENGTH=12, train_batch_size=16,
        eval_batch_size=32, tag_version="v1", topk=[5, 10], total_iters=STEPS,
        eval_interval=STEPS, update_interval=1, use_native_sampler=False, seed=0,
        show_progress=False, eval_item_chunk_size=128, scheduler_args={"type": "constant"},
        optim_args={"learning_rate": 1e-3, "weight_decay": 0.01},
        model=family.split("-")[0], **fam)
    if family.startswith("LLMIDRec"):
        tower = tmp / "tiny_llama"
        tower.mkdir(exist_ok=True)
        (tower / "config.json").write_text(json.dumps(TINY_LLAMA))
        base.update(user_pretrain_dir=str(tower), compute_dtype="float32")
    base.update(over)
    return files + ["overall/ID.yaml"], base


def cli_args(files, over):
    args = ["--config_file", *files, "--", "--device", "cpu"]
    for k, v in over.items():
        args += [f"--{k}", json.dumps(v) if isinstance(v, (list, bool, dict)) else str(v)]
    return args


def start(args, mode, rank=None, port=None):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    head = [sys.executable, "-c", LAUNCH, mode]
    if rank is not None:
        head += ["--multihost", "--coordinator_address", f"127.0.0.1:{port}",
                 "--num_processes", str(WORLD), "--process_id", str(rank)]
    return subprocess.Popen(head + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(procs):
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def results(path, n):
    return [json.loads(open(f"{path}.{r}.json").read()) for r in range(n)]


def jax_init(jcfg, data, family):
    """The JAX trainer, deterministic, with the single-process test's
    initial parameters."""
    jt = JaxTrainer(jcfg, data)
    jt.model = deterministic(jt.model)
    if family.startswith("LLMIDRec"):
        jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    params = dict(jt.state.params)
    if family == "DualVAE":
        params = _seeded_biases(params)
    if "trunk" in params:
        trunk = dict(params["trunk"])
        trunk["attn_out"] = {"kernel": trunk["attn_out"]["kernel"] * SPREAD}
        params["trunk"] = trunk
    jt.state = jt.state.replace(params=params)
    return jt


def jax_composed_run(jt, jcfg, data):
    """STEPS steps of the JAX trainer on the composed global batches, then
    the test split."""
    stream = ComposedBatcher(jcfg, data).infinite_batches(prefetch=0)
    losses = []
    for _ in range(STEPS):
        batch = next(stream)
        jt.state, out = jt._jit_train_step(jt.state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(out["loss"]))
    result = jt.evaluate(JaxEvalBatcher(jcfg, data, phase="test"), load_best_model=False)
    checksum = float(sum(np.abs(np.asarray(x, np.float32)).sum(dtype=np.float64)
                         for x in jax.tree.leaves(jt.state.params)))
    return {"losses": losses, "result": result, "param_checksum": checksum}


def port_trainer(files, over, **extra):
    cfg = Config(config_file_list=files, config_dict=dict(over, **extra)).finalize()
    t = Trainer(cfg, InteractionData(cfg).build(), device="cpu", dtype=torch.float32)
    t.setup_model()
    return t


def family_runs(family, synth_dir, tmp):
    """Every run of ``family``: the two ranks deterministic and with the
    draws, the JAX and the port composed runs, the deterministic ranks'
    checkpoint served by one process."""
    files, det = family_overrides(family, synth_dir, tmp, sparse_item_adam=True,
                                  batch_position_negatives=True)
    jcfg = JaxConfig(config_file_list=files, config_dict=dict(
        det, checkpoint_dir=str(tmp / "jax"), sparse_adam_global_dedup=True)).finalize()
    jdata = JaxData(jcfg).build()
    jt = jax_init(jcfg, jdata, family)
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    # the draws: dropout and the in-model draws, the dense optimizer
    _, draws = family_overrides(family, synth_dir, tmp, sparse_item_adam=False,
                                batch_position_negatives=False)
    # the initial weights as a port checkpoint of each run's config, one
    # copy a run (each run resumes from its copy's directory and saves its
    # best checkpoint there)
    inits = {}
    for name, over in (("det", det), ("draws", draws), ("oracle", draws)):
        init = port_trainer(files, over, checkpoint_dir=str(tmp / f"init_{name}"))
        init.model.load_state_dict(state_dict_from_flax(params, init.config), strict=True)
        init.async_checkpoint = False
        init.save_checkpoint()
        inits[name] = init.saved_model_dir
    paths = {name: str(tmp / f"mp_{name}") for name in ("det", "draws")}
    procs = {}
    for name, over in (("det", det), ("draws", draws)):
        port = free_port()
        args = cli_args(files, dict(over, checkpoint_dir=str(tmp / f"ck_{name}"),
                                    result_json_path=paths[name],
                                    load_checkpoint_name=inits[name]))
        mode = "deterministic" if name == "det" else "draws"
        procs[name] = [start(args, mode, r, port) for r in range(WORLD)]
    serve_path = str(tmp / "serve")
    try:
        jax_run = jax_composed_run(jt, jcfg, jdata)
        finish(procs.pop("det"))
        # the deterministic ranks' checkpoint (in their resumed directory),
        # served by one process while the port's composed run goes on
        procs["serve"] = [start(cli_args(files, dict(
            det, val_only=True, checkpoint_dir=str(tmp / "ck_serve"),
            result_json_path=serve_path, load_checkpoint_name=inits["det"])), "deterministic")]
        oracle = port_trainer(files, draws, checkpoint_dir=str(tmp / "oracle"),
                              load_checkpoint_name=inits["oracle"])
        ostats = oracle.fit(PortComposed(oracle.config, oracle.dataload), None)
        port_run = {"final_loss": float(ostats["loss"]), "losses": oracle.fetched_losses,
                    "result": oracle.evaluate(SeqEvalBatcher(oracle.config, oracle.dataload,
                                                             phase="test")),
                    "param_checksum": oracle.param_checksum()}
    finally:
        finish([p for ps in procs.values() for p in ps])
    mp = {name: results(path, WORLD) for name, path in paths.items()}
    return {"mp": mp, "jax": jax_run, "port": port_run, "served": results(serve_path, 1)[0]}


@pytest.fixture(scope="module", params=FAMILIES)
def runs(request, synth_dir, tmp_path_factory):
    family = request.param
    return family_runs(family, synth_dir, tmp_path_factory.mktemp(f"mp_{family}"))


def test_two_ranks_hold_one_state(runs):
    for name in ("det", "draws"):
        r0, r1 = runs["mp"][name]
        assert (r0["process_index"], r1["process_index"]) == (0, 1)
        assert r0["final_loss"] == pytest.approx(r1["final_loss"], rel=1e-6)
        assert r0["param_checksum"] == pytest.approx(r1["param_checksum"], rel=1e-6)
        assert r0["result"] == r1["result"]
        assert [s for s, _ in r0["losses"]] == list(range(1, STEPS + 1))


def test_cli_matches_the_jax_composed_run(runs):
    mp, ref = runs["mp"]["det"][0], runs["jax"]
    np.testing.assert_allclose([loss for _, loss in mp["losses"]], ref["losses"], rtol=2e-4)
    assert mp["param_checksum"] == pytest.approx(ref["param_checksum"], rel=1e-5)
    assert_metrics_close(mp["result"], ref["result"])


def test_draws_match_the_ports_composed_run(runs):
    mp, ref = runs["mp"]["draws"][0], runs["port"]
    assert mp["final_loss"] == pytest.approx(ref["final_loss"], rel=1e-5)
    np.testing.assert_allclose([loss for _, loss in mp["losses"]],
                               [loss for _, loss in ref["losses"]], rtol=2e-4)
    assert mp["param_checksum"] == pytest.approx(ref["param_checksum"], rel=1e-5)
    assert_metrics_close(mp["result"], ref["result"])


def test_two_rank_checkpoint_serves_at_one_rank(runs):
    served, mp = runs["served"], runs["mp"]["det"][0]
    assert served["final_loss"] is None and served["process_index"] == 0
    assert served["param_checksum"] == pytest.approx(mp["param_checksum"], rel=1e-6)
    assert_metrics_close(served["result"], mp["result"])
