"""The port's five baselines (SASRec, ComiRec, REMI, DualVAE, LLMIDRec)
against the JAX package's, on the same weights and batches.

Each family is built from its YAML (``IDNet/<family>.yaml`` over
``overall/ID.yaml``) at a small size by both packages' ``build_model``; the
JAX parameters, initialised from a seed, are carried across with
``state_dict_from_flax``, and both models see the same batch from the JAX
package's train batcher (per-position negatives drawn by the batcher, as
``batch_position_negatives`` asks). The JAX side runs as its own tests run
it on the CPU (ComiRec's STU layers take XLA's dense-mask attention; the
port's fused STU op runs its plain version on CPU tensors).

Checked: the loss dict of the training forward at deterministic settings
(no dropout, DualVAE's z = μ) and every parameter's gradient;
``predict_embeddings``, ``score_items`` and ``compute_item_all``;
``causal_interest_state``, ``routing_regularization`` and
``causal_masked_pooling``; REMI with ``lambda_rr`` and ``beta_ihn`` > 0;
DualVAE's KL annealing at several steps; and the ``sub=`` sparse sub-table
path against the dense gradients (ComiRec's table sits under ``trunk``).

Tolerances: the float32 families' outputs rtol 1e-5, atol 1e-6 (the two
sides differ only in the order of sums); LLMIDRec's tower in float32 at
1e-5, as ``test_torch_hllm.py`` holds its towers, and its bfloat16 tower's
loss at 2e-2 relative (both sides round each product's output to bfloat16,
at different places). Gradients: rtol 1e-5 plus an atol of 1e-4 of each
tensor's largest entry; a gradient sums many terms in another order, and
where a softmax over near-equal scores is differentiated (DualVAE's
pooling, 7e-5 of the largest entry seen here) the cancellation magnifies
that rounding.

ComiRec's and REMI's hard readout is an argmax over interests. At their
initial weights the K interests nearly coincide (the interest logits are
near zero), so near-ties are decided by rounding; the readout test reports
every index where the two packages pick differently and requires each to be
a tie within float32 rounding of the similarity, and at spread interest
logits (the JAX ``attn_out`` kernel times ``SPREAD``, on both sides) the
only ties left are windows of one real item, whose K interests are that
item's output whatever the logits. The gradient test runs at the spread
logits, where a rounding-decided pick cannot move a gradient to another
interest.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.models.factory import build_model as jax_build_model
from mhrec_tpu.models.idnet import comirec as jax_comirec
from mhrec_tpu.models.idnet import dualvae as jax_dualvae
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.models import factory
from mhrec_tpu_torch.models.idnet import comirec, dualvae

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL_OF_MAX = 1e-4
LLM_TOL = 1e-5
BF16_LOSS_RTOL = 2e-2
SPREAD = 30.0

COMIREC = dict(item_embedding_size=64, hstu_embedding_size=128, n_layers=2, n_heads=2,
               pred_len=2, eval_pred_len=2, num_negatives=64)
FAMILIES = {
    "SASRec": (["IDNet/sasrec.yaml"], dict(embedding_size=32, n_heads=2, num_negatives=16,
                                           batch_position_negatives=True)),
    "SASRec-pool": (["IDNet/sasrec.yaml"], dict(embedding_size=32, n_heads=2,
                                                num_negatives=None)),
    "ComiRec": (["IDNet/comirec.yaml"], COMIREC),
    "REMI": (["IDNet/remi.yaml"], COMIREC),
    "DualVAE": (["IDNet/dualvae.yaml"], dict(item_embedding_size=32, num_negatives=64)),
    "LLMIDRec": (["IDNet/llama_id.yaml"], dict(item_embed_dim=32, num_negatives=8,
                                               batch_position_negatives=True)),
    "LLMIDRec-dummy": (["IDNet/llama_id.yaml"], dict(item_embed_dim=32, num_negatives=8,
                                                     batch_position_negatives=True,
                                                     dummy_llm=True)),
}
TINY_LLAMA = {"model_type": "llama", "vocab_size": 1024, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2}


def family_configs(synth_dir, family, tmp_path_factory=None, **over):
    """(JAX config, port config) of ``family`` at test size."""
    files, fam = FAMILIES[family]
    base = dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], MAX_ITEM_LIST_LENGTH=12, train_batch_size=4,
        eval_batch_size=32, tag_version="v1", topk=[5, 10], total_iters=3,
        eval_interval=100, use_native_sampler=False, seed=0,
        # overall/ID.yaml, read after the family's file, names HSTU
        model=family.split("-")[0],
    )
    base.update(fam)
    if family == "LLMIDRec":
        tower = tmp_path_factory.mktemp("tiny_llama")
        (tower / "config.json").write_text(json.dumps(TINY_LLAMA))
        base["user_pretrain_dir"] = str(tower)
    base.update(over)
    jcfg = JaxConfig(config_file_list=files + ["overall/ID.yaml"], config_dict=base).finalize()
    return jcfg, Config(config_dict=jcfg.as_dict())


@pytest.fixture(scope="module")
def jax_data(synth_dir):
    jcfg, _ = family_configs(synth_dir, "DualVAE")
    return JaxData(jcfg).build()


def jax_batch(jcfg, data, seed_epoch=0):
    train, _, _ = jax_build_dataloader(jcfg, data)
    return next(train.epoch_batches(seed_epoch))


def to_port(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long)
            for k, v in batch.items() if k != "tag_categories"}


def _np(x):
    return np.array(x, dtype=np.float32)


def make_pair(synth_dir, jax_data, family, tmp_path_factory, dtype=torch.float32,
              spread=1.0, **over):
    """The JAX model with parameters from seed 0 (ComiRec's and REMI's
    ``attn_out`` kernel times ``spread``), the port's model with those
    parameters, and one batch."""
    jcfg, tcfg = family_configs(synth_dir, family, tmp_path_factory, **over)
    jm = jax_build_model(jcfg, jax_data)
    if dtype == torch.float32 and hasattr(jm, "dtype"):
        jm = jm.clone(dtype=jnp.float32)
    batch = jax_batch(jcfg, jax_data)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "neg": jax.random.PRNGKey(1)}, b,
        deterministic=True))(jbatch)
    params = jax.tree.map(np.asarray, variables["params"])
    if "trunk" in params:
        params["trunk"]["attn_out"]["kernel"] = params["trunk"]["attn_out"]["kernel"] * spread
    if family == "DualVAE":
        # its biases start at zero, so z = μ is exactly zero where a prefix
        # holds no real item; the gradient of JAX's norm is NaN there (0/0),
        # torch's 0 — drawn from the seed, no latent is zero
        rng = np.random.default_rng(5)
        for sub in params.values():
            if isinstance(sub, dict) and "bias" in sub:
                sub["bias"] = rng.normal(0.0, 0.02, sub["bias"].shape).astype(np.float32)
    tm = factory.build_model(tcfg, jax_data, dtype=dtype)
    tm.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    return jm, params, tm, batch, tcfg


def jax_loss_and_grads(jm, params, batch, **extra):
    jbatch = dict({k: jnp.asarray(v) for k, v in batch.items()}, **extra)

    def loss(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return ({k: float(v) for k, v in out.items()},
            jax.tree.map(np.asarray, grads))


def assert_outputs_match(out, jout, rtol=RTOL, atol=ATOL):
    assert set(out) == set(jout)
    for k, v in jout.items():
        np.testing.assert_allclose(float(out[k].detach()), v, rtol=rtol, atol=atol, err_msg=k)


# ----------------------------------------------------------------------------
F32_FAMILIES = ["SASRec", "SASRec-pool", "ComiRec", "REMI", "DualVAE", "LLMIDRec",
                "LLMIDRec-dummy"]


@pytest.mark.parametrize("family", F32_FAMILIES)
def test_loss_and_gradients_match_jax(synth_dir, jax_data, tmp_path_factory, family):
    jm, params, tm, batch, tcfg = make_pair(synth_dir, jax_data, family, tmp_path_factory,
                                            spread=SPREAD)
    jout, jgrads = jax_loss_and_grads(jm, params, batch)
    out = tm(to_port(batch))
    out["loss"].backward()
    tol = LLM_TOL if family.startswith("LLMIDRec") else ATOL
    assert_outputs_match(out, jout, atol=tol, rtol=max(RTOL, tol))
    ref = state_dict_from_flax(jgrads, tcfg)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(ref)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=RTOL,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(r).max(), err_msg=name)
    if family.startswith("SASRec"):
        assert any(k.startswith("trm_encoder.layers.1.") for k in names)
    if family == "REMI":
        assert out["rr_loss"] > 0 and tm.lambda_rr > 0 and tm.beta_ihn > 0


@pytest.mark.parametrize("family", F32_FAMILIES)
def test_predict_and_scores_match_jax(synth_dir, jax_data, tmp_path_factory, family):
    jm, params, tm, batch, _ = make_pair(synth_dir, jax_data, family, tmp_path_factory)
    variables = {"params": params}
    rng = np.random.default_rng(3)
    L = tm.position_embedding.weight.shape[0] if hasattr(tm, "position_embedding") else 12
    seq = rng.integers(1, jax_data.item_num, size=(4, min(L, 12))).astype(np.int32)
    seq[1, :5] = 0
    seq[2, :-1] = 0
    seq[3] = 0  # an all-padding row
    jpe = jm.apply(variables, jnp.asarray(seq), method="predict_embeddings")
    with torch.no_grad():
        pe = tm.predict_embeddings(torch.as_tensor(seq, dtype=torch.long))
        feats = tm.compute_item_all()
    for key in ("head_embs", "user_emb"):
        np.testing.assert_allclose(pe[key].numpy(), _np(jpe[key]), rtol=RTOL, atol=1e-5,
                                   err_msg=key)
    jfeats = jm.apply(variables, method="compute_item_all")
    np.testing.assert_allclose(feats.numpy(), _np(jfeats), rtol=RTOL, atol=1e-5)
    ref = _np(jm.apply(variables, jpe["head_embs"], jfeats, None, None, None,
                       method="score_items"))
    with torch.no_grad():
        scores = tm.score_items(torch.from_numpy(_np(jpe["head_embs"])),
                                torch.from_numpy(_np(jfeats)), None, None, None)
    assert scores.shape == ref.shape == (4, tm.medusa_num_heads, jax_data.item_num)
    np.testing.assert_allclose(scores.numpy(), ref, rtol=RTOL, atol=1e-5)


def test_llmidrec_bf16_tower_loss_matches_jax(synth_dir, jax_data, tmp_path_factory):
    jm, params, tm, batch, _ = make_pair(synth_dir, jax_data, "LLMIDRec", tmp_path_factory,
                                         dtype=torch.bfloat16)
    assert tm.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    jout, _ = jax_loss_and_grads(jm, params, batch)
    out = tm(to_port(batch))
    np.testing.assert_allclose(out["loss"].item(), jout["loss"], rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("spread", [1.0, SPREAD])
@pytest.mark.parametrize("family", ["ComiRec", "REMI"])
def test_hard_readout_picks_the_same_interests(synth_dir, jax_data, tmp_path_factory, family,
                                               spread):
    """The interests ComiRec / REMI read out for each target (the argmax
    over ``sim``), index for index: every index that differs must be a
    tie within float32 rounding. At spread logits the only ties left are
    the windows of one real item, whose K interests are that item's output
    whatever the logits."""
    jm, params, tm, batch, _ = make_pair(synth_dir, jax_data, family, tmp_path_factory,
                                         spread=spread)
    L = tm.max_seq_length
    items = np.asarray(batch["items"])
    mask = np.asarray(batch["masked_index"]).astype(bool)
    ctx = np.where(mask[:, :L], items[:, :L], 0)

    def jax_best(mdl):  # bound to the JAX model by ``apply``
        out = mdl.trunk.encode(jnp.asarray(ctx))
        interests = jax_comirec.causal_interest_state(
            mdl.trunk.interest_logits(out), out, jnp.asarray(mask[:, :L]))[0]
        tgt = mdl.trunk.embed(jnp.asarray(items[:, 1: 1 + L]))
        return jnp.argmax(jnp.einsum("blkd,bld->blk", interests, tgt), axis=-1)

    ref = np.asarray(jm.apply({"params": params}, method=jax_best))
    with torch.no_grad():
        t_ctx = torch.as_tensor(ctx, dtype=torch.long)
        out = tm.trunk.encode(t_ctx)
        interests = comirec.causal_interest_state(
            tm.trunk.interest_logits(out), out, torch.as_tensor(mask[:, :L]))[0]
        tgt = tm.trunk.embed(torch.as_tensor(items[:, 1: 1 + L], dtype=torch.long))
        sim = torch.einsum("blkd,bld->blk", interests, tgt).numpy()
    best = sim.argmax(-1)
    differ = np.argwhere(best != ref)
    gaps = [abs(sim[b, l, best[b, l]] - sim[b, l, ref[b, l]]) for b, l in differ]
    scale = np.abs(sim).max()
    assert all(g <= 1e-6 * scale for g in gaps), (
        f"{len(differ)} of {best.size} picks differ, similarity gaps {gaps} at scale {scale}")


@pytest.mark.parametrize("seed", [0, 1])
def test_interest_state_and_routing_match_jax(seed):
    rng = np.random.default_rng(seed)
    B, L, K, D = 3, 12, 4, 8
    logits = rng.normal(size=(B, L, K)).astype(np.float32)
    out = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = rng.random((B, L)) > 0.3
    mask[2] = False  # an all-padding row
    ref = jax_comirec.causal_interest_state(jnp.asarray(logits), jnp.asarray(out),
                                            jnp.asarray(mask))
    got = comirec.causal_interest_state(torch.from_numpy(logits), torch.from_numpy(out),
                                        torch.from_numpy(mask))
    for a, b, name in zip(got, ref, ("interests", "S1", "S2", "cnt")):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=RTOL, atol=ATOL, err_msg=name)
    rr = comirec.routing_regularization(*got[1:], D)
    np.testing.assert_allclose(rr.numpy(), _np(jax_comirec.routing_regularization(*ref[1:], D)),
                               rtol=RTOL, atol=ATOL)
    scores = rng.normal(size=(B, L, 5)).astype(np.float32)
    values = rng.normal(size=(B, L, 5, D)).astype(np.float32)
    pooled = dualvae.causal_masked_pooling(torch.from_numpy(scores), torch.from_numpy(values),
                                           torch.from_numpy(mask))
    np.testing.assert_allclose(
        pooled.numpy(),
        _np(jax_dualvae.causal_masked_pooling(jnp.asarray(scores), jnp.asarray(values),
                                              jnp.asarray(mask))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("step", [0, 4999, 20000])
def test_dualvae_kl_annealing_matches_jax(synth_dir, jax_data, tmp_path_factory, step):
    jm, params, tm, batch, _ = make_pair(synth_dir, jax_data, "DualVAE", tmp_path_factory,
                                         vae_beta_kl=0.5, vae_kl_anneal_steps=10000)
    jout, _ = jax_loss_and_grads(jm, params, batch, step=jnp.asarray(step, jnp.int32))
    with torch.no_grad():
        out = tm(dict(to_port(batch), step=step))
    for key in ("loss", "kl_loss", "current_beta_kl"):
        np.testing.assert_allclose(float(out[key]), jout[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert float(out["current_beta_kl"]) == pytest.approx(0.5 * min((step + 1) / 10000, 1.0))


@pytest.mark.parametrize("family", ["SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec"])
def test_sparse_sub_table_matches_dense_gradients(synth_dir, jax_data, tmp_path_factory,
                                                  family):
    """The forward on a gathered sub-table of the batch's unique ids (local
    indices, as under ``sparse_item_adam``) gives the dense loss, and its
    row gradients are the dense table gradient's rows (zero elsewhere)."""
    _, _, tm, batch, _ = make_pair(synth_dir, jax_data, family, tmp_path_factory)
    dense = to_port(batch)
    out = tm(dense)
    out["loss"].backward()
    table = dict(tm.named_parameters())[
        "trunk.item_embedding.weight" if family in ("ComiRec", "REMI")
        else "item_embedding.weight"]
    dense_grad = table.grad.clone()
    tm.zero_grad()
    keys = [k for k in ("items", "neg_items", "pos_neg_items") if k in dense]
    uniq = torch.unique(torch.cat([torch.zeros(1, dtype=torch.long)]
                                  + [dense[k].reshape(-1) for k in keys]))
    local = dict(dense, **{k: torch.searchsorted(uniq, dense[k]) for k in keys})
    sub = table.detach()[uniq].clone().requires_grad_(True)
    sparse_out = tm(local, sub=sub)
    sparse_out["loss"].backward()
    np.testing.assert_allclose(float(sparse_out["loss"]), float(out["loss"]), rtol=1e-6)
    assert table.grad is None or not table.grad.any()
    np.testing.assert_allclose(sub.grad.numpy(), dense_grad[uniq].numpy(), rtol=RTOL, atol=1e-7)
    rest = torch.ones(dense_grad.shape[0], dtype=torch.bool)
    rest[uniq] = False
    assert not dense_grad[rest].any()


def test_factory_builds_every_family(synth_dir, jax_data, tmp_path_factory):
    """``build_model`` builds the five families with the JAX package's
    compute types, and the table sits where the trainer looks for it."""
    from mhrec_tpu_torch.trainer import Trainer

    kinds = {}
    for family in ("SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec"):
        _, tcfg = family_configs(synth_dir, family, tmp_path_factory,
                                 sparse_item_adam=True)
        t = Trainer(tcfg, jax_data, device="cpu")
        kinds[family] = (type(t.model).__name__, getattr(t.model, "dtype", None),
                         t.item_table().weight.shape)
    assert kinds["SASRec"][0] == "SASRec" and kinds["DualVAE"][0] == "DualVAE"
    assert kinds["ComiRec"][:2] == ("ComiRec", None) and kinds["REMI"][0] == "ComiRec"
    assert kinds["LLMIDRec"][1] == torch.bfloat16
    assert not hasattr(factory, "_NOT_PORTED")
