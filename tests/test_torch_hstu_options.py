"""The port's HSTU options against the JAX package's, on the CPU.

* ``IDNet/hstu-1b.yaml``: read as PyYAML reads it, and resolved by
  ``Config`` to the JAX package's dict;
* ``scan_layers``: a scanned JAX ``HSTU`` (the unrolled model's layers
  grafted onto the stacked layout, as ``tests/test_model.py`` does) carried
  across by ``state_dict_from_flax`` gives the JAX ``encode`` and
  ``predict_embeddings``, on the same unrolled layers and checkpoint layout
  as the unrolled model; per-layer relative bias is refused as in JAX;
* the bf16 item table: ``quantize_bf16`` and one bf16 row update
  (``sparse_adamw_row_update``) bit-equal to JAX's, with and without
  noise (JAX's own ``jax.random.bits`` words passed in) and weight decay;
  a 30-step bf16-table ``fit`` tracking the f32-table ``fit``, and its
  checkpoint restoring the table bit for bit, written synchronously and by
  the writer thread;
* ``multi_horizon_nce_stacked`` against JAX's (loss, per-category loss,
  logging scalars, gradients; per-category and shared negatives), the
  port's stacked HSTU training forward against its own loop and against
  JAX's stacked forward;
* ``matmul_precision``.

Tolerances, with their reasons: the scanned model's outputs to atol 1e-5
in float32 (the two sides differ only in the order of sums, as in
test_torch_hstu.py). The bf16 quantization and row update are bit-equal:
both sides run the same float32 operations in the same order. The bf16 fit
tracks the f32 fit to 2% of the loss (the JAX package's own bound,
tests/test_sparse_adam.py). The stacked loss against JAX's: the loss and
its scalars to rtol 1e-4 and the gradients to atol 2e-5 + rtol 1e-3, as
test_torch_losses.py holds the loop loss (bf16 logit tables on both sides).
The stacked forward against the loop: rtol 2e-4 / atol 2e-5 on the outputs
and rtol 5e-3 / atol 6e-3 on the gradients (JAX's own bounds,
tests/test_losses.py: the categories' contributions to shared negative rows
sum in another order through bf16 products); against JAX's stacked
forward, the bounds of test_torch_losses.py's forward test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.config.config import _ConfigLoader
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.models.idnet.hstu import hstu_from_config as jax_hstu_from_config
from mhrec_tpu.models.losses import multi_horizon_nce_stacked as jax_stacked
from mhrec_tpu.trainer.sparse_adam import SparseAdamConfig as JaxCfg
from mhrec_tpu.trainer.sparse_adam import quantize_bf16 as jax_quantize
from mhrec_tpu.trainer.sparse_adam import sparse_adamw_row_update as jax_update
from mhrec_tpu_torch.config import Config, load_yaml
from mhrec_tpu_torch.config.config import _YAML_DIR
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import build_dataloader
from mhrec_tpu_torch.models.idnet.hstu import HSTU, hstu_from_config
from mhrec_tpu_torch.models.losses import multi_horizon_nce_stacked
from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
from mhrec_tpu_torch.run import set_matmul_precision
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.trainer.sparse_adam import (
    SparseAdamConfig,
    quantize_bf16,
    sparse_adamw_row_update,
)
from tests.conftest import make_config

torch.set_num_threads(2)

ATOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)
STACKED_OUT_TOL = dict(rtol=2e-4, atol=2e-5)
STACKED_GRAD_TOL = dict(rtol=5e-3, atol=6e-3)
BF16_ULP = 2.0 ** -8
FIT_REL = 0.02


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ----------------------------------------------------------------------------
# hstu-1b
# ----------------------------------------------------------------------------
FILES_1B = ["IDNet/hstu-1b.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"]


def test_hstu_1b_yaml_resolves_as_jax():
    with open(os.path.join(_YAML_DIR, "IDNet/hstu-1b.yaml")) as fh:
        text = fh.read()
    assert load_yaml(text) == yaml.load(text, Loader=_ConfigLoader)
    over = dict(loss="prior", eval_num_cats=8, num_prior_head=8, num_segment_head=4,
                head_interaction="additive", medusa_num_layers=1, scan_layers=True,
                enable_relative_attention_bias=False, item_table_dtype="bfloat16",
                prior_loss_impl="stacked", matmul_precision="tensorfloat32")
    ours = Config(config_file_list=FILES_1B, config_dict=dict(over)).finalize()
    ref = JaxConfig(config_file_list=FILES_1B, config_dict=dict(over)).finalize()
    assert ours.as_dict() == ref.as_dict()
    assert (ours["n_layers"], ours["n_heads"], ours["hstu_embedding_size"],
            ours["item_embedding_size"]) == (22, 32, 2048, 2048)
    assert ours["attn_dropout_prob"] == 0.2  # read by no HSTU layer, as in JAX


# ----------------------------------------------------------------------------
# scan_layers
# ----------------------------------------------------------------------------
B, L, P = 3, 12, 4


def _scan_configs(synth_dir, attn_impl, width, scan):
    jcfg = make_config(
        synth_dir, n_layers=3, n_heads=2, item_embedding_size=width // 2,
        hstu_embedding_size=width, MAX_ITEM_LIST_LENGTH=L, eval_pred_len=P, pred_len=P,
        medusa_num_layers=1, loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="additive", prior_switch="in",
        use_prior_switch_test=True, attn_impl=attn_impl, scan_layers=scan,
        enable_relative_attention_bias=False)
    return jcfg, Config(config_dict=jcfg.as_dict())


@pytest.fixture(scope="module")
def jax_data(synth_dir):
    jcfg, _ = _scan_configs(synth_dir, "xla", 64, False)
    return JaxData(jcfg).build()


@pytest.mark.parametrize("attn_impl,width", [("xla", 64), ("fused", 128)])
def test_scanned_hstu_matches_jax_f32(synth_dir, jax_data, attn_impl, width):
    """``fused`` reaches the JAX package's fused Pallas kernel (interpret
    mode) inside the scan, and the port's fused STU op (width 128: the
    kernel's smallest)."""
    rng = np.random.default_rng(0)
    items = rng.integers(1, jax_data.item_num, size=(B, L)).astype(np.int32)
    items[1, :5] = 0
    tags = (rng.random((B, P, 4)) > 0.5).astype(np.int8)
    ji, jt = jnp.asarray(items), jnp.asarray(tags)
    jcfg_u, tcfg_u = _scan_configs(synth_dir, attn_impl, width, False)
    jcfg_s, tcfg_s = _scan_configs(synth_dir, attn_impl, width, True)
    ju = jax_hstu_from_config(jcfg_u, jax_data).clone(dtype=jnp.float32)
    js = jax_hstu_from_config(jcfg_s, jax_data).clone(dtype=jnp.float32)
    pu = ju.init(jax.random.PRNGKey(0), ji, jt, method="predict_embeddings")["params"]
    # the unrolled layers grafted onto the scanned layout
    ps = {k: v for k, v in pu.items() if not k.startswith("stu_")}
    ps["stu_stack"] = {"layers": {"stu": jax.tree.map(
        lambda *xs: jnp.stack(xs, 0), *[pu[f"stu_{i}"] for i in range(3)])}}
    assert set(js.init(jax.random.PRNGKey(0), ji, jt, method="predict_embeddings")["params"]) \
        == set(ps)
    ps = jax.tree.map(np.asarray, ps)

    tm = hstu_from_config(tcfg_s, jax_data, dtype=torch.float32)
    assert len(tm.stu_layers) == 3
    sd = state_dict_from_flax(ps, tcfg_s)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    # one checkpoint layout for both settings
    sd_u = state_dict_from_flax(jax.tree.map(np.asarray, pu), tcfg_u)
    assert set(sd) == set(sd_u) and all(torch.equal(sd[k], sd_u[k]) for k in sd)

    ti, tt = torch.as_tensor(items, dtype=torch.long), torch.as_tensor(tags)
    with torch.no_grad():
        enc = tm.encode(ti)
        pe = tm.predict_embeddings(ti, tt)
    jenc = js.apply({"params": ps}, ji, method="encode")
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc, np.float32), atol=ATOL)
    jpe = js.apply({"params": ps}, ji, jt, method="predict_embeddings")
    assert set(pe) == set(jpe)
    for key in ("head_embs", "user_emb"):
        np.testing.assert_allclose(pe[key].numpy(), np.asarray(jpe[key], np.float32),
                                   atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(pe["switch_pred"].numpy(), np.asarray(jpe["switch_pred"]))


def test_scan_layers_refuses_relative_bias(synth_dir, jax_data):
    msg = "scan_layers is incompatible with per-layer relative bias"
    jcfg, tcfg = _scan_configs(synth_dir, "xla", 64, True)
    jcfg["enable_relative_attention_bias"] = tcfg["enable_relative_attention_bias"] = True
    with pytest.raises(AssertionError, match=msg):
        jax_hstu_from_config(jcfg, jax_data).init(
            jax.random.PRNGKey(0), jnp.ones((1, L), jnp.int32), method="encode")
    with pytest.raises(ValueError, match=msg):
        hstu_from_config(tcfg, jax_data)


def test_converter_refuses_a_scanned_stack_of_another_depth(synth_dir, jax_data):
    jcfg, tcfg = _scan_configs(synth_dir, "xla", 64, True)
    js = jax_hstu_from_config(jcfg, jax_data)
    ps = jax.tree.map(np.asarray, js.init(
        jax.random.PRNGKey(0), jnp.ones((1, L), jnp.int32), jnp.zeros((1, P, 4), jnp.int8),
        method="predict_embeddings")["params"])
    state_dict_from_flax(ps, tcfg)  # the configured depth converts
    tcfg["n_layers"] = 2
    with pytest.raises(ValueError, match="depth"):
        state_dict_from_flax(ps, tcfg)


# ----------------------------------------------------------------------------
# the bf16 item table
# ----------------------------------------------------------------------------
def _noise(key, shape):
    """JAX's stochastic-rounding words: ``jax.random.bits(key) & 0xFFFF``."""
    words = jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)
    return torch.from_numpy(np.asarray(words).astype(np.int64))


def test_quantize_bf16_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4000), rng.normal(size=4000) * 1e-30,
                        [0.0, -0.0, 1.0, -2.5, 3.0, 65504.0, -1e38, np.inf, -np.inf]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(_bits(quantize_bf16(torch.from_numpy(x))),
                                  _bits(jax_quantize(jnp.asarray(x))))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            _bits(quantize_bf16(torch.from_numpy(x), _noise(key, x.shape))),
            _bits(jax_quantize(jnp.asarray(x), key)))


def test_quantize_bf16_stochastic_rounding_statistics():
    """tests/test_sparse_adam.py's statistics, with the noise drawn from a
    torch generator."""
    gen = torch.Generator().manual_seed(0)
    on_grid = torch.tensor([1.0, -2.5, 0.0, 3.0])
    assert torch.equal(quantize_bf16(on_grid), on_grid)
    assert torch.equal(quantize_bf16(on_grid, generator=gen), on_grid)
    x = torch.full((20000,), 1.0 + 2.0 ** -10)  # 1/8 ulp above 1.0
    q = quantize_bf16(x, generator=gen).double().numpy()
    ulp = 2.0 ** -7
    assert set(np.unique(q)) <= {1.0, 1.0 + ulp}
    assert abs((q > 1.0).mean() - 0.125) < 0.02  # E[q] == x
    assert float(quantize_bf16(x[:1])[0]) == 1.0  # nearest rounds down


def _row_inputs(N=400, D=96, U=1024, n_real=300, seed=0):
    rng = np.random.default_rng(seed)
    table = np.array(jnp.asarray(rng.normal(size=(N, D)) * 0.05, jnp.bfloat16)
                     .astype(jnp.float32))
    m = (rng.normal(size=(N, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(N, D))) * 0.01).astype(np.float32)
    ids = np.zeros(U, np.int32)
    ids[:n_real] = rng.choice(np.arange(1, N), size=n_real, replace=False)
    mask = np.zeros(U, np.float32)
    mask[:n_real] = 1.0
    g = rng.normal(size=(U, D)).astype(np.float32)
    return table, m, v, ids, mask, g


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("wd,step", [(0.0, 0), (0.01, 0), (0.0, 9), (0.01, 9)])
def test_bf16_row_update_matches_jax_bit_for_bit(wd, step, stochastic):
    table, m, v, ids, mask, g = _row_inputs(seed=step)
    key = jax.random.PRNGKey(step + 1) if stochastic else None
    ref = jax_update(jnp.asarray(table, jnp.bfloat16), *(jnp.asarray(x) for x in
                                                          (m, v, ids, mask, g)),
                     1e-3, jnp.asarray(step), JaxCfg(weight_decay=wd), sr_key=key)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    signed = torch.from_numpy(np.where(mask > 0, ids, -1).astype(np.int64))
    rnd = _noise(key, g.shape) if stochastic else None
    sparse_adamw_row_update(tt, tm, tv, signed, torch.from_numpy(g), 1e-3, step,
                            SparseAdamConfig(weight_decay=wd), rnd=rnd)
    assert tt.dtype == torch.bfloat16 and tm.dtype == tv.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tt.float()), _bits(ref[0].astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(tm), _bits(ref[1]))
    np.testing.assert_array_equal(_bits(tv), _bits(ref[2]))
    touched = np.zeros(len(table), bool)
    touched[ids[mask > 0]] = True
    assert (tt.float().numpy()[touched] != table[touched]).any()
    np.testing.assert_array_equal(tt.float().numpy()[~touched], table[~touched])  # row 0 too


def test_bf16_row_update_draws_from_a_generator_and_row_adamw_refuses_it():
    table, m, v, ids, mask, g = _row_inputs()
    signed = torch.from_numpy(np.where(mask > 0, ids, -1).astype(np.int64))
    outs = []
    for _ in range(2):
        tt = torch.from_numpy(table).to(torch.bfloat16)
        sparse_adamw_row_update(tt, torch.from_numpy(m.copy()), torch.from_numpy(v.copy()),
                                signed, torch.from_numpy(g), 1e-3, 0, SparseAdamConfig(),
                                generator=torch.Generator().manual_seed(5))
        outs.append(tt)
    assert torch.equal(outs[0], outs[1])
    nearest = torch.from_numpy(table).to(torch.bfloat16)
    sparse_adamw_row_update(nearest, torch.from_numpy(m.copy()), torch.from_numpy(v.copy()),
                            signed, torch.from_numpy(g), 1e-3, 0, SparseAdamConfig())
    assert not torch.equal(outs[0], nearest)
    with pytest.raises(ValueError, match="float32"):
        row_adamw(nearest, torch.from_numpy(m), torch.from_numpy(v), signed,
                  torch.from_numpy(g), 1e-3, 0, SparseAdamConfig())


def _fit_config(synth_dir, tmp, dtype, **over):
    jcfg = make_config(synth_dir, sparse_item_adam=True, item_table_dtype=dtype,
                       total_iters=30, eval_interval=1000, update_interval=1,
                       checkpoint_dir=str(tmp), use_native_sampler=False, **over)
    return Config(config_dict=jcfg.as_dict())


def _fit(cfg, data):
    t = Trainer(cfg, data, device="cpu", dtype=torch.float32)
    t.setup_model(seed=3)
    return t, t.fit(build_dataloader(cfg, data)[0], None)


def test_bf16_table_trains_tracks_f32_and_checkpoints_bit_for_bit(synth_dir, tmp_path):
    cfg16 = _fit_config(synth_dir, tmp_path / "b", "bfloat16")
    data = JaxData(make_config(synth_dir)).build()
    t16, s16 = _fit(cfg16, data)
    table = t16.model.item_embedding.weight
    assert table.dtype == torch.bfloat16 and not table.requires_grad
    assert t16.table_m.dtype == t16.table_v.dtype == torch.float32
    t32, s32 = _fit(_fit_config(synth_dir, tmp_path / "f", "float32"), data)
    assert t32.model.item_embedding.weight.dtype == torch.float32
    assert np.isfinite(s16["loss"]) and np.isfinite(s32["loss"])
    assert abs(s16["loss"] - s32["loss"]) < FIT_REL * max(1.0, abs(s32["loss"]))
    # the eval path reads the table in float32
    feats = t16.model.compute_item_all()
    assert feats.dtype == torch.float32 and bool(torch.isfinite(feats).all())

    for asynchronous in (False, True):
        t16.async_checkpoint = asynchronous
        t16.save_checkpoint()
        t2 = Trainer(cfg16, data, device="cpu", dtype=torch.float32)
        t2.setup_model(seed=9)
        assert not torch.equal(t2.model.item_embedding.weight, table)
        assert t2.load_checkpoint()
        restored = t2.model.item_embedding.weight
        assert restored.dtype == torch.bfloat16
        assert torch.equal(restored.view(torch.int16), table.view(torch.int16))
        assert torch.equal(t2.table_m, t16.table_m) and torch.equal(t2.table_v, t16.table_v)


def test_bf16_table_rounding_stream_shifts_no_other_draw(synth_dir, tmp_path, monkeypatch):
    """With dropout on, the first step's loss and moments are the same with
    stochastic rounding on and off: the noise comes from a generator of its
    own (seeded apart from the step's dropout generator), and off passes
    none, so the update rounds to nearest."""
    import mhrec_tpu_torch.trainer.trainer as trainer_mod

    passed = []
    real = trainer_mod.sparse_adamw_row_update

    def spy(*args, generator=None, **kw):
        passed.append(generator)
        return real(*args, generator=generator, **kw)

    monkeypatch.setattr(trainer_mod, "sparse_adamw_row_update", spy)
    data = JaxData(make_config(synth_dir)).build()
    runs = {}
    for sr in (True, False):
        cfg = _fit_config(synth_dir, tmp_path / str(sr), "bfloat16", hidden_dropout_prob=0.3,
                          item_table_stochastic_round=sr)
        t = Trainer(cfg, data, device="cpu", dtype=torch.float32)
        t.setup_model(seed=3)
        stream = build_dataloader(cfg, data)[0].epoch_batches(0)
        # two steps: the schedule's first learning rate is 0
        runs[sr] = (t, [float(t.train_step(next(stream))["loss"].detach()) for _ in range(2)])
    on, off = runs[True][0], runs[False][0]
    assert runs[True][1] == runs[False][1]
    assert torch.equal(on.table_m, off.table_m) and torch.equal(on.table_v, off.table_v)
    assert not torch.equal(on.model.item_embedding.weight, off.model.item_embedding.weight)
    assert passed[2:] == [None, None]
    for step, gen in enumerate(passed[:2]):
        assert gen.initial_seed() == on.step_generator(step, rounding=True).initial_seed()
        assert gen.initial_seed() != on.step_generator(step).initial_seed()


@pytest.mark.parametrize("sparse", [False, True])
def test_bf16_table_needs_sparse_item_adam(synth_dir, tmp_path, sparse):
    data = JaxData(make_config(synth_dir)).build()
    cfg = _fit_config(synth_dir, tmp_path, "bfloat16")
    cfg["sparse_item_adam"] = sparse
    if sparse:
        Trainer(cfg, data, device="cpu")
    else:
        with pytest.raises(ValueError, match="sparse_item_adam"):
            Trainer(cfg, data, device="cpu")


# ----------------------------------------------------------------------------
# the stacked prior loss
# ----------------------------------------------------------------------------
def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x, dtype=np.float32), requires_grad=requires_grad)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("Lq,Pq", [(6, 3), (30, 2)])
def test_multi_horizon_nce_stacked_matches_jax(shared, Lq, Pq):
    """(30, 2) takes the long-window positive logits (L > 7P)."""
    rng = np.random.default_rng(0)
    Bq, H, D, M, C = 3, 6, 16, 40, 4
    heads = _unit(rng.normal(size=(Bq, H, Lq, D))).astype(np.float32)
    tgts = _unit(rng.normal(size=(Bq, Lq + Pq, D))).astype(np.float32)
    negs = _unit(rng.normal(size=(1 if shared else C, M, D))).astype(np.float32)
    negs[:, :3] = tgts[0, 1:4]  # false negatives
    user = rng.random((Bq, Lq + Pq)) > 0.2
    base = np.stack([user[:, :Lq] & user[:, p + 1: p + 1 + Lq] for p in range(Pq)], 1)
    extra = rng.random((C, Bq, Pq, Lq)) > 0.3
    hfc = 2 + np.arange(C)
    lam = np.asarray([0.99 ** p for p in range(Pq)], np.float32)
    lam /= lam.sum()
    lw = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    ls = np.float32(np.log(1 / 0.05))

    def jax_loss(h, t, n, s):
        total, per_pred, per_cat, logs = jax_stacked(
            h, t, n, jnp.asarray(base), jnp.asarray(extra), hfc, jnp.asarray(lam), s, 0.99,
            lw, compute_topk_log=True)
        return total, (per_pred, per_cat, logs)

    (jtotal, (jper, jcat, jlogs)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(heads), jnp.asarray(tgts), jnp.asarray(negs), jnp.asarray(ls))
    h, t, n, s = _t(heads, True), _t(tgts, True), _t(negs, True), _t(ls, True)
    total, per, cat, logs = multi_horizon_nce_stacked(
        h, t, n, torch.from_numpy(base), torch.from_numpy(extra), hfc, torch.from_numpy(lam),
        s, 0.99, lw, compute_topk_log=True)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(cat.detach().numpy(), np.asarray(jcat), rtol=LOSS_RTOL, atol=1e-6)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=LOSS_RTOL, err_msg=k)
    for name, mine, ref in zip("htns", (h.grad, t.grad, n.grad, s.grad), jgrads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), err_msg=name, **GRAD_TOL)


def _prior_configs(synth_dir, impl, by_cat, switch):
    jcfg = make_config(
        synth_dir, loss="prior", eval_num_cats=4, num_prior_head=4, num_segment_head=2,
        medusa_num_layers=1, head_interaction="additive", pred_len=4, eval_pred_len=4,
        n_layers=1, MAX_ITEM_LIST_LENGTH=8, num_negatives=96, neg_sample_by_cat=by_cat,
        weighted_prior_loss=True, prior_switch=switch,
        prior_switch_loss_weight=0.3 if switch else 0.0, prior_loss_impl=impl,
        hidden_dropout_prob=0.0, attn_impl="xla", use_native_sampler=False)
    data = JaxData(jcfg).build()  # sets the category names the port's config copies
    return jcfg, Config(config_dict=jcfg.as_dict()), data


def _forward(tm, batch):
    tb = {k: torch.as_tensor(np.asarray(v), dtype=torch.long) for k, v in batch.items()
          if k != "tag_categories"}
    tb["tag_categories"] = torch.as_tensor(batch["tag_categories"])
    for p in tm.parameters():
        p.grad = None
    out = tm(tb)
    out["loss"].backward()
    return ({k: v.item() for k, v in out.items()},
            {k: p.grad.clone() for k, p in tm.named_parameters() if p.grad is not None})


@pytest.mark.parametrize("by_cat,switch", [(True, "in"), (False, "in"), (True, None)])
def test_stacked_prior_matches_the_loop_and_jax(synth_dir, by_cat, switch):
    """The port's stacked HSTU training forward against its loop on the
    same weights and batch (tests/test_losses.py holds JAX's the same way),
    and against the JAX package's stacked forward."""
    jcfg, tcfg, data = _prior_configs(synth_dir, "stacked", by_cat, switch)
    batch = jax_build_dataloader(jcfg, data)[0].make_batch(np.random.default_rng(0),
                                                          np.arange(8))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_hstu_from_config(jcfg, data).clone(dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jbatch)["params"]
    tm = hstu_from_config(tcfg, data, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), tcfg),
                       strict=True)
    stacked, g_stacked = _forward(tm, batch)
    tm.prior_loss_impl = "loop"
    loop, g_loop = _forward(tm, batch)
    assert set(stacked) == set(loop)
    assert {f"head_nce_{c}_loss" for c in tm.int_to_category} <= set(stacked)
    for k in loop:
        np.testing.assert_allclose(stacked[k], loop[k], err_msg=k, **STACKED_OUT_TOL)
    assert set(g_stacked) == set(g_loop)
    for k in g_loop:
        np.testing.assert_allclose(g_stacked[k].numpy(), g_loop[k].numpy(), err_msg=k,
                                   **STACKED_GRAD_TOL)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch)
        return out["loss"], out

    (jloss, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert set(stacked) == set(jout)
    for k in stacked:
        np.testing.assert_allclose(stacked[k], float(jout[k]), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads), tcfg)
    for k, ref in want.items():
        ref = ref.numpy()
        mine = g_stacked[k].numpy() if k in g_stacked else np.zeros_like(ref)
        np.testing.assert_allclose(mine, ref, atol=BF16_ULP * np.abs(ref).max() + 1e-7,
                                   rtol=0, err_msg=k)


def test_stacked_dispatch_is_taken_only_where_jax_takes_it(synth_dir, monkeypatch):
    """Additive heads, banded NCE and ``prior_loss_impl: stacked`` take it;
    ``per_offset`` and the other interactions stay on the loop."""
    import mhrec_tpu_torch.models.multihead as mh

    calls = []
    real = mh.multi_horizon_nce_stacked
    monkeypatch.setattr(mh, "multi_horizon_nce_stacked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jcfg, tcfg, data = _prior_configs(synth_dir, "stacked", True, "in")
    batch = jax_build_dataloader(jcfg, data)[0].make_batch(np.random.default_rng(0),
                                                          np.arange(8))
    for over, taken in ((dict(), True), (dict(nce_impl="per_offset"), False),
                        (dict(head_interaction="multiplicative"), False),
                        (dict(prior_loss_impl="loop"), False)):
        cfg = Config(config_dict=dict(tcfg.as_dict(), **over))
        calls.clear()
        _forward(hstu_from_config(cfg, data, dtype=torch.float32), batch)
        assert bool(calls) == taken, over


# ----------------------------------------------------------------------------
# matmul_precision
# ----------------------------------------------------------------------------
def test_matmul_precision_maps_jax_names():
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        for value, want in (("highest", "highest"), ("float32", "highest"),
                            ("tensorfloat32", "high"), ("bfloat16", "medium"),
                            ("TensorFloat32", "high")):
            set_matmul_precision(value)
            assert torch.get_float32_matmul_precision() == want, value
            assert torch.backends.cudnn.allow_tf32 == (want != "highest")
        for unset in (None, ""):  # TF32 off
            set_matmul_precision("bfloat16")
            set_matmul_precision(unset)
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError, match="matmul_precision"):
            set_matmul_precision("fast")
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_scan_layers_model_is_the_unrolled_model():
    kw = dict(item_num=50, item_embedding_size=16, hstu_embedding_size=16,
              max_seq_length=8, n_layers=3, n_heads=2, dtype=torch.float32)
    a, b = HSTU(**kw), HSTU(scan_layers=True, **kw)
    assert list(a.state_dict()) == list(b.state_dict())
    for m in (a, b):
        m.init_parameters(torch.Generator().manual_seed(0))
        m.eval()
    items = torch.randint(1, 50, (2, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(a.encode(items), b.encode(items))
