"""Gradient accumulation (``accumulate_grad`` k > 1) in the port against the
JAX package, on the CPU.

* ``dedup_touched_rows`` against the JAX one on id blocks with duplicates
  (across and within blocks), pads, and the real id 0: the same sum for each
  id, every real id once, −1 in every other slot;
* k = 2 over 4 micro-steps (2 optimizer steps) against the JAX ``Trainer``'s
  train step (``optax.MultiSteps``; under ``sparse_item_adam`` its row
  buffers and deduped row update): HSTU with ``sparse_item_adam`` on and
  off, and a 2-layer HLLM (dense AdamW on every parameter). The JAX model
  is held in float32, the port runs float32 on the CPU, the weights are
  carried across with ``convert.state_dict_from_flax``, and both take the
  JAX batcher's batches;
* the port alone: the parameters, item table and moments bit-unchanged
  between boundaries; the clipped mean; ``fit`` counting micro-steps and
  evaluating only at boundaries; a resume from a boundary checkpoint equal
  to the uninterrupted run; a checkpoint between boundaries refused.

Tolerances: losses agree to a relative error of 1e-5, and so do the
parameters after, as one vector (relative L2 error against the JAX ones).
Each parameter tensor alone is held to 1e-4: both losses round their logit
tables to bfloat16, and where the f32 sums before that rounding differ by
an ulp a logit moves by a bfloat16 ulp; Adam turns that noise into a share
of a step that is largest in the tensors that start at zero (the LayerNorm
biases reach 2.5e-5 to 3e-5 in two optimizer steps at learning rate 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu.trainer.sparse_adam import dedup_touched_rows as jax_dedup
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_dataloader
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.trainer.sparse_adam import dedup_touched_rows
from tests.conftest import make_config

torch.set_num_threads(2)

TOL = 1e-5
TENSOR_TOL = 1e-4
K = 2
HLLM_YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]


# ----------------------------------------------------------------------------
def _dedup_case(name):
    """(ids [k, U] with −1 pads, grad rows [k, U, D]) from a seeded rng."""
    rng = np.random.default_rng(len(name))
    k, U, D = 4, 24, 5
    if name == "across_blocks":  # unique within each block, shared across
        ids = np.stack([rng.permutation(40)[:U] for _ in range(k)])
        ids[:, -5:] = -1
    elif name == "within_blocks":  # repeats inside a block too
        ids = rng.integers(0, 12, size=(k, U))
        ids[rng.random((k, U)) < 0.2] = -1
    elif name == "all_pads":
        ids = np.full((k, U), -1)
    else:  # "no_pads", id 0 real
        ids = rng.integers(0, 9, size=(k, U))
        ids[0, 0] = 0
    return ids.astype(np.int64), rng.normal(size=(k, U, D)).astype(np.float32)


@pytest.mark.parametrize("name", ["across_blocks", "within_blocks", "all_pads", "no_pads"])
def test_dedup_touched_rows_matches_jax(name):
    ids, g = _dedup_case(name)
    ids_u, g_u = dedup_touched_rows(torch.from_numpy(ids), torch.from_numpy(g))
    ids_u, g_u = ids_u.numpy(), g_u.numpy()
    k, U, D = g.shape
    assert ids_u.shape == (k * U,) and g_u.shape == (k * U, D)
    # the JAX form: pads alias id 0 with mask 0
    mask = (ids >= 0).reshape(-1).astype(np.float32)
    j_ids, j_mask, j_g = (np.asarray(x) for x in jax_dedup(
        jnp.asarray(np.maximum(ids, 0).reshape(-1).astype(np.int32)), jnp.asarray(mask),
        jnp.asarray(g.reshape(-1, D))))
    want = {int(i): j_g[n] for n, i in enumerate(j_ids) if j_mask[n] > 0}
    real = ids_u >= 0
    n = int(real.sum())
    # unique real ids, ascending, at the front; -1 and zero rows after
    assert len(set(ids_u[real].tolist())) == n == len(want)
    assert real[:n].all() and not real[n:].any()
    np.testing.assert_array_equal(ids_u[:n], np.sort(ids_u[:n]))
    assert not g_u[n:].any()
    for slot in range(n):
        np.testing.assert_allclose(g_u[slot], want[int(ids_u[slot])], rtol=TOL, atol=1e-6)


def test_dedup_touched_rows_by_hand():
    ids = torch.tensor([[5, -1, 3], [5, -1, 0]])
    g = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2)
    ids_u, g_u = dedup_touched_rows(ids, g)
    assert ids_u.tolist() == [0, 3, 5, -1, -1, -1]
    assert g_u.tolist() == [[10, 11], [4, 5], [6, 8], [0, 0], [0, 0], [0, 0]]


# ----------------------------------------------------------------------------
def _hstu_configs(synth_dir, tmp, **over):
    base = dict(
        n_layers=1, n_heads=2, item_embedding_size=64, hstu_embedding_size=64,
        MAX_ITEM_LIST_LENGTH=8, pred_len=2, eval_pred_len=2, train_batch_size=8,
        num_negatives=64, loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="additive", medusa_num_layers=1,
        prior_switch="in", prior_switch_loss_weight=0.1, segment_embed=True,
        hidden_dropout_prob=0.0, use_native_sampler=False, checkpoint_dir=str(tmp),
        optim_args={"learning_rate": 1e-3, "weight_decay": 0.01}, accumulate_grad=K,
        scheduler_args={"type": "cosine", "warmup": 0.0}, total_iters=4,
        attn_impl="xla", sparse_adam_impl="xla",
    )
    base.update(over)
    jcfg = make_config(synth_dir, **base)
    return jcfg, Config(config_dict=jcfg.as_dict())


@pytest.fixture(scope="module")
def hstu_data(synth_dir, tmp_path_factory):
    jcfg, _ = _hstu_configs(synth_dir, tmp_path_factory.mktemp("d"))
    return JaxData(jcfg).build()


def _port_batch(batch):
    b = dict(batch)
    if "unique_mask" in b:
        b["unique_ids"] = np.where(b.pop("unique_mask") > 0, b["unique_ids"], -1)
    return b


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close_params(tt, jparams, tcfg):
    ref = {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree.map(np.asarray, jax.device_get(jparams)), tcfg).items()}
    mine = {k: v.detach().numpy() for k, v in tt.model.state_dict().items()}
    flat = [np.concatenate([d[k].ravel() for k in sorted(ref)]) for d in (mine, ref)]
    assert _rel_l2(*flat) <= TOL
    errs = {k: _rel_l2(mine[k], ref[k]) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TENSOR_TOL, (worst, errs[worst])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse_item_adam"])
def test_hstu_accumulation_matches_jax(synth_dir, hstu_data, tmp_path, sparse):
    jcfg, tcfg = _hstu_configs(synth_dir, tmp_path, sparse_item_adam=sparse)
    jt = JaxTrainer(jcfg, hstu_data)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    assert isinstance(jt.tx, optax.MultiSteps)
    tt = Trainer(tcfg, hstu_data, device="cpu", dtype=torch.float32)
    tt.setup_model()
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    batches = jax_build_dataloader(jcfg, hstu_data)[0].epoch_batches(0)
    jl, tl = [], []
    for _ in range(2 * K):
        batch = next(batches)
        jt.state, jout = jt._jit_train_step(jt.state, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
        jl.append(float(jout["loss"]))
        tl.append(tt.train_step(_port_batch(batch))["loss"].item())
    assert tt.step == int(jt.state.step) == 2 * K
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[0] != tl[K]  # an optimizer step ran in between
    _close_params(tt, jt.state.params, tcfg)
    if sparse:
        # the row moments are the gradients' averages, which agree to the
        # logit tables' bfloat16 noise: one bfloat16 ulp of the largest
        # entry, as test_torch_train.py holds the first moments
        for mine, ref in ((tt.table_m, jt.state.table_m), (tt.table_v, jt.state.table_v)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                       atol=2.0 ** -8 * np.abs(ref).max())


def _hllm_setup(synth_dir, tmp, **over):
    d = dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], precision="32", random_init_towers=True,
        dummy_vocab_size=1024, dummy_hidden_size=64, use_native_sampler=False,
        MAX_ITEM_LIST_LENGTH=6, MAX_TEXT_LENGTH=16, train_batch_size=4, eval_batch_size=32,
        num_negatives=16, tag_version="v1", loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="hierarchical", medusa_num_layers=1,
        segment_embed=True, prior_switch="in", prior_switch_loss_weight=0.1, pred_len=4,
        eval_pred_len=4, topk=[5, 10], packed_item_tower=True, pack_chunk=128,
        suppress_history=False, token_cache_dir=False, checkpoint_dir=str(tmp / "ckpt"),
        scheduler_args={"type": "constant"}, accumulate_grad=K,
        optim_args={"learning_rate": 1e-4, "weight_decay": 0.01},
    )
    d.update(over)
    return (JaxConfig(config_file_list=HLLM_YAMLS, config_dict=d).finalize(),
            Config(config_file_list=HLLM_YAMLS, config_dict=d).finalize())


def test_hllm_accumulation_matches_jax(synth_dir, tmp_path):
    from mhrec_tpu.trainer.trainer import TrainState
    from tests.test_torch_hllm_train import _random_params, _same_chunk_rows

    jcfg, tcfg = _hllm_setup(synth_dir, tmp_path)
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    params = _random_params(jt, seed=4)
    # what setup_model builds under accumulate_grad, without its eager init
    jparams = jax.tree.map(jnp.asarray, params)
    jt.tx = optax.MultiSteps(jt._make_tx(jparams), every_k_schedule=K)
    jt.extra_vars = {}
    jt.state = TrainState(params=jparams, opt_state=jt.tx.init(jparams),
                          step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0),
                          nan_step=jnp.asarray(-1, jnp.int32))
    jt._build_train_step()
    tt = Trainer(tcfg, jdata, device="cpu")
    tt.setup_model()
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    stream = JaxTextBatcher(jcfg, jdata).epoch_batches(0)
    batches = _same_chunk_rows([next(stream) for _ in range(2 * K)])
    jl, tl = [], []
    for batch in batches:
        jt.state, jout = jt._jit_train_step(jt.state, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
        jl.append(float(jout["loss"]))
        tl.append(tt.train_step(batch)["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[0] != tl[K]
    _close_params(tt, jt.state.params, tcfg)


# ----------------------------------------------------------------------------
def _port(synth_dir, hstu_data, tmp_path, **over):
    _, tcfg = _hstu_configs(synth_dir, tmp_path, **over)
    t = Trainer(tcfg, hstu_data, device="cpu", dtype=torch.float32)
    t.setup_model()
    return t, tcfg


def _snapshot(t):
    snap = {k: v.clone() for k, v in t.model.state_dict().items()}
    if t.table_m is not None:
        snap["table_m"], snap["table_v"] = t.table_m.clone(), t.table_v.clone()
    return snap


def _changed(t, snap):
    now = _snapshot(t)
    return {k for k in snap if not torch.equal(now[k], snap[k])}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse_item_adam"])
def test_nothing_moves_between_boundaries(synth_dir, hstu_data, tmp_path, sparse):
    """k = 3: micro-steps 1 and 2 leave every parameter, the item table and
    its moments bit-unchanged; micro-step 3 moves them, and the optimizer's
    step count is 1 (the schedule and bias corrections of optimizer step 0)."""
    t, tcfg = _port(synth_dir, hstu_data, tmp_path, accumulate_grad=3, sparse_item_adam=sparse)
    batches = build_dataloader(tcfg, hstu_data)[0].epoch_batches(0)
    snap = _snapshot(t)
    for _ in range(2):
        t.train_step(next(batches))
        assert not _changed(t, snap)
    t.train_step(next(batches))
    moved = _changed(t, snap)
    assert "item_embedding.weight" in moved
    assert moved - {"item_embedding.weight", "table_m", "table_v"}
    if sparse:
        assert {"table_m", "table_v"} <= moved
        # the union of the three blocks went through the row update once
        ids, _ = dedup_touched_rows(t.acc_ids, t.acc_g)
        real = ids[ids >= 0]
        assert real.unique().numel() == real.numel()
        rows_moved = (t.model.item_embedding.weight != snap["item_embedding.weight"]).any(-1)
        assert set(torch.nonzero(rows_moved).flatten().tolist()) <= set(real.tolist())
    steps = {int(s["step"]) for s in t.optimizer.state.values()}
    assert steps == {1}


def test_the_mean_is_clipped_once(synth_dir, hstu_data, tmp_path):
    """``clip_grad_norm`` applies to the mean of the k gradients (inside the
    chain that MultiSteps wraps), not to each micro-step's."""
    t, tcfg = _port(synth_dir, hstu_data, tmp_path, clip_grad_norm=1e-3)
    batches = list(build_dataloader(tcfg, hstu_data)[0].epoch_batches(0))[:K]
    plain, _ = _port(synth_dir, hstu_data, tmp_path, accumulate_grad=1, clip_grad_norm=None)
    # both keep the gradients the step would apply, so each batch's are
    # taken at the same weights
    plain.optimizer.step = lambda: None
    means = None
    for b in batches:
        plain.train_step(b)
        grads = [p.grad.clone() for p in plain.dense_params]
        means = grads if means is None else [m + (g - m) / 2 for m, g in zip(means, grads)]
    t.train_step(batches[0])
    t.optimizer.step = lambda: None  # keep the gradients the step would apply
    t.train_step(batches[1])
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(m) for m in means]))
    for p, m in zip(t.dense_params, means):
        torch.testing.assert_close(p.grad, m * (1e-3 / norm), rtol=1e-5, atol=1e-12)


def test_fit_counts_micro_steps_and_evaluates_at_boundaries(synth_dir, tmp_path):
    _, tcfg = _hstu_configs(synth_dir, tmp_path, sparse_item_adam=True, total_iters=3,
                            eval_interval=1, update_interval=100)
    data = InteractionData(tcfg).build()
    t = Trainer(tcfg, data, device="cpu", dtype=torch.float32)
    t.setup_model()
    train, valid, _ = build_dataloader(tcfg, data)
    at = []
    evaluate = t.evaluate

    def record(*a, **kw):
        at.append(t.step)
        return evaluate(*a, **kw)

    t.evaluate = record
    stats = t.fit(train, valid)
    assert stats["iters"] == 3 * K and t.step == 3 * K
    assert at == [K, 2 * K, 3 * K]
    assert [s for s, _ in t.fetched_losses] == [1, 3 * K]


def test_resume_from_a_boundary_checkpoint(synth_dir, hstu_data, tmp_path):
    """Two optimizer steps, a checkpoint at the boundary, two more: a
    trainer resumed from that checkpoint takes the last two the same way,
    loss for loss and bit for bit."""
    over = dict(sparse_item_adam=True, hidden_dropout_prob=0.3, total_iters=4)
    a, tcfg = _port(synth_dir, hstu_data, tmp_path, **over)
    batches = list(build_dataloader(tcfg, hstu_data)[0].epoch_batches(0))[:4 * K]
    losses = []
    for i, b in enumerate(batches):
        if i == K + 1:
            with pytest.raises(ValueError, match="accumulation boundary"):
                a.save_checkpoint()
        losses.append(a.train_step(b)["loss"].item())
        if i == 2 * K - 1:
            a.best_valid_score = 0.5
            a.save_checkpoint()
    b_ = Trainer(tcfg, hstu_data, device="cpu", dtype=torch.float32)
    b_.setup_model(seed=123)  # other weights, replaced by the checkpoint
    assert b_.load_checkpoint() and b_.step == 2 * K
    resumed = [b_.train_step(b)["loss"].item() for b in batches[2 * K:]]
    assert resumed == losses[2 * K:]
    for (k, x), y in zip(a.model.state_dict().items(), b_.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(a.table_m, b_.table_m) and torch.equal(a.table_v, b_.table_v)
    for pa, pb in zip(a.dense_params, b_.dense_params):
        sa, sb = a.optimizer.state[pa], b_.optimizer.state[pb]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and sa["step"] == sb["step"]
