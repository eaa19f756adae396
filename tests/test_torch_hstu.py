"""The port's HSTU model against the JAX package's, on the same weights.

A JAX ``HSTU`` is initialised, its flax parameters are carried across with
``state_dict_from_flax``, and both models see the same item windows (made
with numpy from a seed). ``encode``, ``predict_embeddings`` and
``score_items`` must agree — the −inf pattern of the prior masks exactly —
for the nce loss and the prior loss in all three head interactions. Widths
are D=128 with 2 heads, so the JAX side's ``attn_impl: fused`` reaches the
fused Pallas kernel (interpret mode) and the port's the fused STU op.

Tolerance: atol 1e-5 in float32, where the two sides differ only in the
order of sums. In bfloat16 both trunks round at different places (the
einsum's output, the LayerNorm's input) over every layer, so the unit-norm
head embeddings agree to 2e-2 (8e-3 seen here) and the switch decisions
are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.models.idnet.hstu import hstu_from_config as jax_hstu_from_config
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.models.idnet.hstu import hstu_from_config
from tests.conftest import make_config

torch.set_num_threads(2)

ATOL = 1e-5
BF16_ATOL = 2e-2
B, L, P = 3, 20, 4

CASES = {
    "nce-fused": dict(loss="nce", attn_impl="fused"),
    "nce-xla": dict(loss="nce", attn_impl="xla"),
    "prior-additive-fused": dict(
        loss="prior", head_interaction="additive", num_segment_head=2, attn_impl="fused"),
    "prior-multiplicative-xla": dict(
        loss="prior", head_interaction="multiplicative", num_segment_head=2,
        prior_given_at_test=True, given_prior_len=2, attn_impl="xla"),
    "prior-hierarchical-fused": dict(
        loss="prior", head_interaction="hierarchical", num_segment_head=2,
        segment_embed=True, cat_bottleneck=True, master_switch=True, attn_impl="fused"),
}


def _configs(synth_dir, case):
    over = dict(
        n_layers=2, n_heads=2, item_embedding_size=64, hstu_embedding_size=128,
        eval_pred_len=P, pred_len=P, medusa_num_layers=1,
    )
    if case["loss"] == "prior":
        over.update(eval_num_cats=4, num_prior_head=4, prior_switch="in",
                    use_prior_switch_test=True)
    over.update(case)
    jcfg = make_config(synth_dir, **over)
    return jcfg, Config(config_dict=jcfg.as_dict())


def _inputs(data, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.integers(1, data.item_num, size=(B, L)).astype(np.int32)
    items[1, :7] = 0  # left-padded window
    items[2, : L - 1] = 0  # one real item
    tags = (rng.random((B, P, 4)) > 0.5).astype(np.int8)
    return items, tags


@pytest.fixture(scope="module")
def jax_data(synth_dir):
    # one data build serves every case: the cases share data_path/tags
    jcfg, _ = _configs(synth_dir, CASES["prior-additive-fused"])
    return JaxData(jcfg).build()


def _pair(synth_dir, jax_data, case, dtype):
    jcfg, tcfg = _configs(synth_dir, case)
    jm = jax_hstu_from_config(jcfg, jax_data)
    if dtype == torch.float32:
        jm = jm.clone(dtype=jnp.float32)
    items, tags = _inputs(jax_data)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(items), jnp.asarray(tags),
                        method="predict_embeddings")
    params = jax.tree.map(np.asarray, variables["params"])
    tm = hstu_from_config(tcfg, jax_data, dtype=dtype)
    tm.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    tm.eval()
    return jm, {"params": params}, tm, items, tags


def _np(x):
    return np.array(x, dtype=np.float32)  # a writable copy torch can wrap


@pytest.mark.parametrize("name", list(CASES))
def test_hstu_matches_jax_f32(synth_dir, jax_data, name):
    case = CASES[name]
    jm, variables, tm, items, tags = _pair(synth_dir, jax_data, case, torch.float32)
    ti, tt = torch.as_tensor(items, dtype=torch.long), torch.as_tensor(tags)
    with torch.no_grad():
        enc = tm.encode(ti)
        pe = tm.predict_embeddings(ti, tt)
    np.testing.assert_allclose(
        enc.numpy(), _np(jm.apply(variables, jnp.asarray(items), method="encode")), atol=ATOL)
    jpe = jm.apply(variables, jnp.asarray(items), jnp.asarray(tags), method="predict_embeddings")
    assert set(pe) == set(jpe)
    for key in ("head_embs", "user_emb"):
        np.testing.assert_allclose(pe[key].numpy(), _np(jpe[key]), atol=ATOL, err_msg=key)
    if "switch_pred" in jpe:
        np.testing.assert_array_equal(pe["switch_pred"].numpy(), np.asarray(jpe["switch_pred"]))
        np.testing.assert_array_equal(pe["switch_correct"].numpy(),
                                      np.asarray(jpe["switch_correct"]))
        if pe["switch_pred"].shape[1] > 1:
            assert pe["switch_pred"].any() and not pe["switch_pred"].all()

    # score the whole corpus from the JAX side's embeddings, so the masks are
    # compared on identical inputs
    jfeats = jm.apply(variables, method="compute_item_all")
    with torch.no_grad():
        feats = tm.compute_item_all()
    np.testing.assert_allclose(feats.numpy(), _np(jfeats), atol=ATOL)
    item_tags = jax_data.item_tag_matrix if case["loss"] == "prior" else None
    switch = jpe.get("switch_pred")
    ref = _np(jm.apply(variables, jpe["head_embs"], jfeats,
                       None if item_tags is None else jnp.asarray(item_tags),
                       jnp.asarray(tags), switch, method="score_items"))
    with torch.no_grad():
        out = tm.score_items(
            torch.from_numpy(_np(jpe["head_embs"])), torch.from_numpy(_np(jfeats)),
            None if item_tags is None else torch.from_numpy(item_tags), tt,
            None if switch is None else torch.from_numpy(np.array(switch)),
        ).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], atol=ATOL)
    if case["loss"] == "prior":
        assert np.isneginf(ref).any() and fin.any()


@pytest.mark.parametrize("name", ["prior-additive-fused", "nce-xla"])
def test_hstu_matches_jax_bf16(synth_dir, jax_data, name):
    jm, variables, tm, items, tags = _pair(synth_dir, jax_data, CASES[name], torch.bfloat16)
    with torch.no_grad():
        pe = tm.predict_embeddings(torch.as_tensor(items, dtype=torch.long),
                                   torch.as_tensor(tags))
    jpe = jm.apply(variables, jnp.asarray(items), jnp.asarray(tags), method="predict_embeddings")
    assert pe["head_embs"].dtype == torch.float32
    for key in ("head_embs", "user_emb"):
        np.testing.assert_allclose(pe[key].numpy(), _np(jpe[key]), atol=BF16_ATOL, err_msg=key)


def test_converter_refuses_unused_and_missing_keys(synth_dir, jax_data):
    case = CASES["nce-xla"]
    _, variables, _, _, _ = _pair(synth_dir, jax_data, case, torch.float32)
    _, tcfg = _configs(synth_dir, case)
    params = dict(variables["params"])
    with pytest.raises(ValueError, match="no counterpart"):
        state_dict_from_flax({**params, "stray": {"kernel": np.zeros(2)}}, tcfg)
    params.pop("logit_scale")
    with pytest.raises(KeyError, match="logit_scale"):
        state_dict_from_flax(params, tcfg)


def test_stu_layer_dispatch(monkeypatch):
    """'auto' and 'fused' take the fused STU op when its preconditions hold;
    'pallas' takes the pointwise attention op; 'xla' and widths that are not
    multiples of 128 take the plain path."""
    from mhrec_tpu_torch.models.idnet import hstu as hstu_mod
    from mhrec_tpu_torch.ops import hstu_attention_cuda

    calls = []
    real_fused, real_v2 = hstu_mod.hstu_stu_gated_fwd, hstu_attention_cuda.hstu_attention_v2
    monkeypatch.setattr(hstu_mod, "hstu_stu_gated_fwd",
                        lambda *a, **k: calls.append("fused") or real_fused(*a, **k))
    monkeypatch.setattr(hstu_attention_cuda, "hstu_attention_v2",
                        lambda *a, **k: calls.append("pallas") or real_v2(*a, **k))
    x = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(0))
    nonpad = torch.ones(2, 5, dtype=torch.bool)
    outs = {}
    for impl, D, want in (("auto", 128, "fused"), ("fused", 128, "fused"),
                          ("pallas", 128, "pallas"), ("xla", 128, None), ("auto", 64, None)):
        layer = hstu_mod.STULayer(D, D // 2, D // 2, 2, attn_impl=impl, dtype=torch.float32)
        layer.init_parameters(torch.Generator().manual_seed(1))
        calls.clear()
        with torch.no_grad():
            outs[impl, D] = layer(x[..., :D], nonpad)
        assert calls == ([want] if want else []), (impl, D)
    for impl in ("fused", "pallas", "xla"):
        torch.testing.assert_close(outs[impl, 128], outs["auto", 128], atol=ATOL, rtol=0)
