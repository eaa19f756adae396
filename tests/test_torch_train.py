"""The port's training path against the JAX package's, on the CPU.

* the training batcher: batches equal to the JAX package's (numpy sampler,
  ``use_native_sampler: false``), with the sparse unique-id block on and off;
* every learning-rate schedule against optax, and early stopping / the
  validation score against the JAX package's helpers;
* one train step, dense and sparse: the JAX ``Trainer`` with the fused STU
  kernel (#1/#4) and the row-AdamW kernel (#7) in interpret mode, the model
  held in float32, against the port's ``Trainer`` on the same weights and
  batch;
* a 60-step loss trajectory against the JAX ``Trainer`` (plain XLA paths)
  at the reference protocol's learning rate, 1e-4;
* checkpoint save → load → resume continuing the same losses, the NaN
  guard, and ``python -m mhrec_tpu_torch.run --device cpu`` training.

Tolerances, with their reasons: batches are equal. Schedules agree to
float32 rounding (rtol 1e-6: numpy's and XLA's ``cos`` may differ by an
ulp). After one Adam step from zero moments an update is about
``lr·sign(g)``, and gradients agree to bfloat16 precision (the loss's logit
tables are bfloat16 on both sides, see test_torch_losses.py), so the first
moments (``0.1·g``) are held to one bfloat16 ulp of each tensor's largest
entry, and the parameters to ``2·lr`` everywhere and ``lr/100`` on all but
a few elements. Losses of the trajectory agree to rtol 1e-3: Adam turns
the bfloat16 noise of tiny gradients into whole ``lr`` steps, so the two
trajectories drift apart in proportion to the learning rate (at 1e-3 the
drift reaches 2e-3 within 60 steps).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu.trainer.lr_schedule import build_schedule as jax_build_schedule
from mhrec_tpu.utils.misc import calculate_valid_score as jax_valid_score
from mhrec_tpu.utils.misc import early_stopping as jax_early_stopping
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_dataloader
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.trainer.lr_schedule import build_schedule
from mhrec_tpu_torch.utils.misc import calculate_valid_score, early_stopping
from tests.conftest import make_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -8
LR = 1e-3


def _configs(synth_dir, tmp, **over):
    base = dict(
        n_layers=1, n_heads=2, item_embedding_size=128, hstu_embedding_size=128,
        MAX_ITEM_LIST_LENGTH=8, pred_len=2, eval_pred_len=2, train_batch_size=8,
        num_negatives=64, loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="additive", medusa_num_layers=1,
        prior_switch="in", prior_switch_loss_weight=0.1, segment_embed=True,
        hidden_dropout_prob=0.0, use_native_sampler=False, checkpoint_dir=str(tmp),
        optim_args={"learning_rate": LR, "weight_decay": 0.01},
    )
    base.update(over)
    jcfg = make_config(synth_dir, **base)
    return jcfg, Config(config_dict=jcfg.as_dict())


@pytest.fixture(scope="module")
def jax_data(synth_dir, tmp_path_factory):
    jcfg, _ = _configs(synth_dir, tmp_path_factory.mktemp("d"))
    return JaxData(jcfg).build()


# ----------------------------------------------------------------------------
@pytest.mark.parametrize("sparse", [False, True])
def test_batcher_matches_jax(synth_dir, jax_data, tmp_path, sparse):
    jcfg, tcfg = _configs(synth_dir, tmp_path, sparse_item_adam=sparse)
    jtrain, _, _ = jax_build_dataloader(jcfg, jax_data)
    ttrain, _, _ = build_dataloader(tcfg, InteractionData(tcfg).build())
    assert ttrain.steps_per_epoch == jtrain.steps_per_epoch
    jb_all, tb_all = jtrain.epoch_batches(1), ttrain.epoch_batches(1)
    for _ in range(3):
        jb, tb = next(jb_all), next(tb_all)
        if sparse:
            ids = np.where(jb.pop("unique_mask") > 0, jb.pop("unique_ids"), -1)
            np.testing.assert_array_equal(tb.pop("unique_ids"), ids)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("args", [
    {"type": "constant"}, {"type": "constant", "warmup": 0.1}, {"type": "linear", "warmup": 0.2},
    {"type": "cosine", "warmup": 0.1}, {"type": "cosine", "warmup": 0.0, "num_cycles": 1.5},
    {"type": "cosine_with_restarts", "warmup": 0.1, "num_cycles": 3},
    {"type": "polynomial", "warmup": 0.1, "power": 2.0, "lr_end": 1e-6},
    {"type": "multistep", "milestones": [7, 20], "gamma": 0.3, "warmup": 0.1},
], ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
def test_lr_schedules_match_optax(args):
    total = 40
    mine, ref = build_schedule(args, 3e-4, total), jax_build_schedule(args, 3e-4, total)
    steps = np.arange(0, total + 3)
    want = np.asarray([float(ref(jnp.int32(s))) for s in steps], np.float32)
    got = np.asarray([mine(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert isinstance(mine(3), float)


def test_early_stopping_and_valid_score_match_jax():
    best, cur = None, 0
    jbest, jcur = None, 0
    for v in (0.1, 0.3, 0.2, 0.2, 0.25, 0.4):
        out = early_stopping(v, best, cur, 2, bigger=True)
        jout = jax_early_stopping(v, jbest, jcur, 2, bigger=True)
        assert out == jout
        best, cur, jbest, jcur = out[0], out[1], jout[0], jout[1]
    res = {"pred_1": {"ndcg@10": 0.5, "Recall@5": 0.25}, "shared": {"x": 1.0}}
    for metric in ("ndcg@10", "recall@5"):
        assert calculate_valid_score(res, metric, 2) == jax_valid_score(res, metric, 2)


# ----------------------------------------------------------------------------
def _trainer_pair(synth_dir, jax_data, tmp_path, jax_impls, **over):
    jcfg, tcfg = _configs(synth_dir, tmp_path, **dict(jax_impls, **over))
    jt = JaxTrainer(jcfg, jax_data)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    # the port takes its default paths: 'auto' (the fused STU op) and, under
    # sparse_item_adam, the row-AdamW wrapper (plain version on CPU tensors)
    for key in ("attn_impl", "sparse_adam_impl"):
        tcfg[key] = "auto"
    tt = Trainer(tcfg, jax_data, device="cpu", dtype=torch.float32)
    tt.setup_model()
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    jtrain, _, _ = jax_build_dataloader(jcfg, jax_data)
    return jt, tt, jtrain.epoch_batches(0), tcfg


def _port_batch(batch):
    b = dict(batch)
    if "unique_mask" in b:
        b["unique_ids"] = np.where(b.pop("unique_mask") > 0, b["unique_ids"], -1)
    return b


def _flax_params(jt, tcfg):
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    return {k: v.numpy() for k, v in state_dict_from_flax(params, tcfg).items()}


@pytest.mark.parametrize("sparse", [False, True])
def test_one_train_step_matches_jax_kernels(synth_dir, jax_data, tmp_path, sparse):
    jt, tt, batches, tcfg = _trainer_pair(
        synth_dir, jax_data, tmp_path, dict(attn_impl="fused", sparse_adam_impl="pallas"),
        sparse_item_adam=sparse, scheduler_args={"type": "constant"})
    before = {k: v.detach().clone().numpy() for k, v in tt.model.state_dict().items()}
    batch = next(batches)
    jt.state, jout = jt._jit_train_step(jt.state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = tt.train_step(_port_batch(batch))
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), rtol=1e-4)
    # first moments: 0.1·g on both sides
    mu = jt.state.opt_state.inner_states["normal"].inner_state[0].mu if sparse \
        else jt.state.opt_state[0].mu
    mu = _named(jax.tree.map(np.asarray, jax.device_get(mu)), tcfg)
    for name, p in tt.model.named_parameters():
        if sparse and name == "item_embedding.weight":
            ref, mine = np.asarray(jt.state.table_m), tt.table_m.numpy()
        else:
            ref, mine = mu[name], tt.optimizer.state[p]["exp_avg"].numpy()
        np.testing.assert_allclose(mine, ref, atol=BF16_ULP * np.abs(ref).max() + 1e-9,
                                   rtol=0, err_msg=name)
    after = _flax_params(jt, tcfg)
    for name, p in tt.model.state_dict().items():
        d = np.abs(p.numpy() - after[name])
        assert d.max() <= 2 * LR + 1e-6, name
        assert (d > LR / 100).mean() <= 0.01, name
        if not (sparse and name == "item_embedding.weight"):
            continue
        touched = np.abs(after[name] - before[name]).max(-1) > 0
        np.testing.assert_array_equal(np.abs(p.numpy() - before[name]).max(-1) > 0, touched)


def _named(tree, tcfg):
    return {k: v.numpy() for k, v in state_dict_from_flax(tree, tcfg).items()}


def test_loss_trajectory_matches_jax_trainer(synth_dir, jax_data, tmp_path):
    jt, tt, batches, _ = _trainer_pair(
        synth_dir, jax_data, tmp_path, dict(attn_impl="xla", sparse_adam_impl="xla"),
        sparse_item_adam=True, total_iters=60,
        optim_args={"learning_rate": 1e-4, "weight_decay": 0.01})
    jl, tl = [], []
    for _ in range(60):
        batch = next(batches)
        jt.state, jout = jt._jit_train_step(jt.state, {k: jnp.asarray(v) for k, v in batch.items()})
        jl.append(float(jout["loss"]))
        tl.append(tt.train_step(_port_batch(batch))["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert np.mean(tl[-10:]) < np.mean(tl[:10])  # it learns


# ----------------------------------------------------------------------------
def _port_trainer(synth_dir, jax_data, tmp_path, **over):
    _, tcfg = _configs(synth_dir, tmp_path, **over)
    t = Trainer(tcfg, jax_data, device="cpu", dtype=torch.float32)
    t.setup_model()
    return t, tcfg


def test_checkpoint_resume_continues_the_same_losses(synth_dir, jax_data, tmp_path):
    over = dict(sparse_item_adam=True, hidden_dropout_prob=0.3, total_iters=6)
    a, tcfg = _port_trainer(synth_dir, jax_data, tmp_path, **over)
    batches = list(build_dataloader(tcfg, jax_data)[0].epoch_batches(0))[:6]
    losses = []
    for i, b in enumerate(batches):
        losses.append(a.train_step(b)["loss"].item())
        if i == 2:
            a.best_valid_score = 0.5
            a.save_checkpoint()
    b_ = Trainer(tcfg, jax_data, device="cpu", dtype=torch.float32)
    b_.setup_model(seed=123)  # other weights, replaced by the checkpoint
    assert b_.load_checkpoint() and b_.step == 3 and b_.best_valid_score == 0.5
    resumed = [b_.train_step(b)["loss"].item() for b in batches[3:]]
    assert resumed == losses[3:]
    for (k, x), y in zip(a.model.state_dict().items(), b_.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(a.table_m, b_.table_m) and torch.equal(a.table_v, b_.table_v)


@pytest.mark.parametrize("sparse", [False, True])
def test_nan_guard_zeroes_the_step_and_fit_raises(synth_dir, jax_data, tmp_path, sparse):
    t, tcfg = _port_trainer(synth_dir, jax_data, tmp_path, sparse_item_adam=sparse,
                            total_iters=4, eval_interval=100, update_interval=100)
    train = build_dataloader(tcfg, jax_data)[0]
    batch = next(train.epoch_batches(0))
    t.train_step(batch)
    with torch.no_grad():
        t.model.logit_scale.fill_(float("nan"))
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    m_before = None if t.table_m is None else t.table_m.clone()
    out = t.train_step(batch)
    assert torch.isnan(out["loss"]) and int(t.nan_step) == 1
    for p in t.dense_params:
        assert (p.grad == 0).all()
    # the step still ran on zero gradients: Adam's moments moved the weights
    moved = False
    for k, v in t.model.state_dict().items():
        if k != "logit_scale":
            assert torch.isfinite(v).all(), k
            moved |= not torch.equal(v, before[k])
    assert moved
    if sparse:  # the row update ran on zero gradients: the moments only decayed
        assert torch.isfinite(t.table_m).all()
        assert t.table_m.abs().sum() < m_before.abs().sum()
    t2, _ = _port_trainer(synth_dir, jax_data, tmp_path, sparse_item_adam=sparse,
                          total_iters=4, eval_interval=100, update_interval=100)
    with torch.no_grad():
        t2.model.logit_scale.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="NaN loss at iter 0"):
        t2.fit(train, None)


def test_run_trains_on_the_cpu(synth_dir, tmp_path):
    """The CLI's training path: fit with an evaluation and a best-checkpoint
    save, then the test split evaluated from that checkpoint."""
    cmd = [sys.executable, "-m", "mhrec_tpu_torch.run", "--device", "cpu",
           "--config_file", "IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml", "--",
           "--data_path", synth_dir["data_path"], "--dataset", synth_dir["name"],
           "--text_path", synth_dir["text_path"], "--MAX_ITEM_LIST_LENGTH", "8",
           "--train_batch_size", "8", "--eval_batch_size", "32", "--num_negatives", "64",
           "--n_layers", "1", "--n_heads", "2", "--item_embedding_size", "128",
           "--hstu_embedding_size", "128", "--total_iters", "4", "--eval_interval", "2",
           "--eval_pred_len", "2", "--pred_len", "2", "--topk", "[5,10]", "--loss", "prior",
           "--eval_num_cats", "4", "--num_prior_head", "4", "--medusa_num_layers", "1",
           "--prior_switch", "in", "--prior_switch_loss_weight", "0.1", "--tag_version", "v1",
           "--sparse_item_adam", "True", "--checkpoint_dir", str(tmp_path),
           "--result_json_path", str(tmp_path / "res")]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = proc.stdout + proc.stderr
    assert "fit done: 4 steps" in log and "pred_1: {" in log
    ckpt = tmp_path / "HSTU-SynthRec" / "ckpt" / "checkpoint.pt"
    assert ckpt.is_file()
    import json

    res = json.loads((tmp_path / "res.0.json").read_text())
    assert np.isfinite(res["final_loss"])
