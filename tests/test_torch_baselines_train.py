"""The five baselines' training and evaluation through the port's
``Trainer`` against the JAX package's ``Trainer``, on the CPU.

The families are set up as ``tests/test_baselines.py`` and
``tests/test_sparse_adam.py`` set them up (``IDNet/<family>.yaml`` over
``overall/ID.yaml``, small widths), at deterministic settings on both
sides: the JAX model's training forward runs with ``deterministic=True``
(no dropout, DualVAE's z = μ) and the port's trainer passes no generator;
SASRec and LLMIDRec take the batcher's per-position negatives
(``batch_position_negatives: true``). Both trainers start from the JAX
parameters (carried across with ``state_dict_from_flax``; DualVAE's biases
drawn from a seed and ComiRec's / REMI's interest logits spread, both as in
``test_torch_baselines.py``) and take the same batches.

Checked, for every family with and without ``sparse_item_adam``: a 3-step
loss trajectory (rtol 1e-5: Adam's first steps move each weight by about
the learning rate times the sign of its gradient, so float32 rounding of a
tiny gradient can flip a step; 1e-5 of the loss is far below a flipped
step's effect on these models after 3 steps at 1e-3) and ``evaluate()``'s
metrics after it (1e-6, the metrics' rounding); the batcher's
``pos_neg_items`` and ``unique_id_cap`` against JAX's; and a checkpoint
save and reload. ``test_torch_baselines_cli.py`` drives the CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.data import trainset as jax_trainset
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_dataloader, build_eval_dataloaders, \
    trainset
from mhrec_tpu_torch.trainer import Trainer
from tests.test_torch_baselines import SPREAD, family_configs

torch.set_num_threads(2)

FAMILIES = ["SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec"]
STEPS = 3
LOSS_RTOL = 1e-5
METRIC_TOL = 1e-6
LR = 1e-3


def deterministic(model):
    """The JAX model with its training forward forced deterministic."""

    class Deterministic(type(model)):
        def __call__(self, batch, deterministic=False):
            return super().__call__(batch, deterministic=True)

    fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)
              if f.init and f.name not in ("parent", "name")}
    return Deterministic(**fields)


def _seeded_biases(params):
    rng = np.random.default_rng(5)
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and "bias" in v:
            v = dict(v, bias=jnp.asarray(rng.normal(0.0, 0.02, v["bias"].shape), jnp.float32))
        out[k] = v
    return out


def trainer_pair(synth_dir, tmp_path_factory, family, **over):
    over = dict(dict(optim_args={"learning_rate": LR, "weight_decay": 0.01},
                     scheduler_args={"type": "constant"}, eval_item_chunk_size=128,
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")),
                     batch_position_negatives=True), **over)
    jcfg, tcfg = family_configs(synth_dir, family, tmp_path_factory, **over)
    data = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, data)
    jt.model = deterministic(jt.model)
    if hasattr(jt.model, "dtype") and family == "LLMIDRec":
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
    tt = Trainer(tcfg, data, device="cpu", dtype=torch.float32)
    tt.setup_model()
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    tt.step_generator = lambda step, rounding=False: None  # deterministic
    return jt, tt, jcfg, tcfg, data


def _port_batch(batch):
    b = dict(batch)
    if "unique_mask" in b:
        b["unique_ids"] = np.where(b.pop("unique_mask") > 0, b["unique_ids"], -1)
    return b


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("family", FAMILIES)
def test_trajectory_and_evaluation_match_jax(synth_dir, tmp_path_factory, family, sparse):
    jt, tt, jcfg, tcfg, data = trainer_pair(synth_dir, tmp_path_factory, family,
                                            sparse_item_adam=sparse)
    batches = jax_build_dataloader(jcfg, data)[0].epoch_batches(0)
    jl, tl = [], []
    for _ in range(STEPS):
        batch = next(batches)
        jt.state, jout = jt._jit_train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()})
        jl.append(float(jout["loss"]))
        tl.append(tt.train_step(_port_batch(batch))["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert all(np.isfinite(tl))
    ref = jt.evaluate(jax_build_dataloader(jcfg, data)[2], load_best_model=False)
    out = tt.evaluate(build_eval_dataloaders(tcfg, data)[1], load_best_model=False)
    assert set(out) == set(ref)
    for section in ref:
        assert set(out[section]) == set(ref[section]), section
        for key, v in ref[section].items():
            assert out[section][key] == pytest.approx(v, abs=METRIC_TOL), (section, key)
    if family in ("ComiRec", "REMI"):
        assert tt.item_table() is tt.model.trunk.item_embedding


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("family", ["SASRec", "LLMIDRec", "ComiRec"])
def test_batcher_matches_jax(synth_dir, tmp_path_factory, family, sparse):
    """Equal batches (``pos_neg_items`` among them, drawn after the tags,
    remapped under sparse mode) and the same ``unique_id_cap``."""
    over = dict(sparse_item_adam=sparse, batch_position_negatives=not sparse)
    jcfg, tcfg = family_configs(synth_dir, family, tmp_path_factory, **over)
    data = JaxData(jcfg).build()
    assert trainset._wants_position_negatives(tcfg) == jax_trainset._wants_position_negatives(
        jcfg) == (family != "ComiRec")
    assert trainset.unique_id_cap(tcfg) == jax_trainset.unique_id_cap(jcfg)
    jb_all = jax_build_dataloader(jcfg, data)[0].epoch_batches(1)
    tb_all = build_dataloader(tcfg, data)[0].epoch_batches(1)
    for _ in range(3):
        jb, tb = _port_batch(next(jb_all)), next(tb_all)
        assert set(jb) == set(tb)
        assert ("pos_neg_items" in tb) == (family != "ComiRec")
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("family", ["ComiRec", "DualVAE"])
def test_checkpoint_round_trip_continues_the_same_losses(synth_dir, tmp_path_factory, family):
    """Save after 2 sparse steps, reload into a trainer with other weights:
    the parameters, the table's moments and the next losses are equal."""
    _, tcfg = family_configs(synth_dir, family, tmp_path_factory, sparse_item_adam=True,
                             checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    data = InteractionData(tcfg).build()
    a = Trainer(tcfg, data, device="cpu")
    a.setup_model()
    batches = list(build_dataloader(tcfg, data)[0].epoch_batches(0))[:4]
    losses = []
    for i, b in enumerate(batches):
        losses.append(a.train_step(b)["loss"].item())
        if i == 1:
            a.best_valid_score = 0.25
            a.save_checkpoint()
    b_ = Trainer(tcfg, data, device="cpu")
    b_.setup_model(seed=99)
    assert b_.load_checkpoint() and b_.step == 2 and b_.best_valid_score == 0.25
    assert [b_.train_step(b)["loss"].item() for b in batches[2:]] == losses[2:]
    for (k, x), y in zip(a.model.state_dict().items(), b_.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(a.table_m, b_.table_m) and torch.equal(a.table_v, b_.table_v)
