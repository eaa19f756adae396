"""The port's training losses against the JAX package's, on the CPU.

* ``multi_horizon_nce`` (banded and per_offset): the loss, its per-offset
  terms, its logging scalars and the gradients with respect to the head
  outputs, the targets and the temperature, from the same numpy inputs;
* the HSTU training forward (``compute_multihead_losses`` and the switch
  loss): the JAX ``HSTU.__call__`` and the port's ``HSTU.forward`` on the
  same weights (carried across with ``state_dict_from_flax``) and the same
  batch, for the nce loss and the prior loss in all three head interactions,
  with the switch ``in`` and ``in_out``, the asymmetric switch loss and the
  per_offset NCE; loss, logging scalars and every parameter's gradient.

Both sides compute in float32 except the large logit tables, which both
round to bfloat16 (the JAX package's choice): a float32 input that differs
in its last bit between the two frameworks can land on the other side of a
bfloat16 rounding, so losses are held to rtol 1e-4. The gradients that flow
back through those tables are bfloat16 on both sides as well (the products'
transposes are bfloat16 products, and their sums are taken in another
order), so the model's parameter gradients agree to one bfloat16 ulp
(2^-8) of each tensor's largest entry; the loss function's own gradients,
at the small sizes of its test, to atol 2e-5 + rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.models.idnet.hstu import hstu_from_config as jax_hstu_from_config
from mhrec_tpu.models.losses import multi_horizon_nce as jax_nce
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.models.idnet.hstu import hstu_from_config
from mhrec_tpu_torch.models.layers import asymmetric_loss, weighted_bce_with_logits
from mhrec_tpu_torch.models.losses import clamp_logit_scale, multi_horizon_nce
from tests.conftest import make_config

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)
BF16_ULP = 2.0 ** -8


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x, dtype=np.float32), requires_grad=requires_grad)


@pytest.mark.parametrize("impl", ["banded", "per_offset"])
@pytest.mark.parametrize("seg_heads,P", [(1, 3), (3, 3), (2, 4)])
def test_multi_horizon_nce_matches_jax(impl, seg_heads, P):
    rng = np.random.default_rng(0)
    B, L, D, M = 4, 6, 16, 48
    heads = rng.normal(size=(B, seg_heads, L, D)).astype(np.float32)
    tgts = rng.normal(size=(B, L + P, D)).astype(np.float32)
    neg = rng.normal(size=(M, D)).astype(np.float32)
    neg /= np.linalg.norm(neg, axis=-1, keepdims=True)
    neg[:3] = tgts[0, 1:4] / np.linalg.norm(tgts[0, 1:4], axis=-1, keepdims=True)  # false negatives
    user = rng.random((B, L + P)) > 0.2
    base = np.stack([user[:, :L] & user[:, p + 1: p + 1 + L] for p in range(P)], 1)
    extra = rng.random((B, P, L)) > 0.3
    hfp = np.arange(P) * seg_heads // P
    lam = np.asarray([0.99 ** p for p in range(P)], np.float32)
    lam /= lam.sum()
    ls = np.float32(np.log(1 / 0.05))

    def jax_loss(h, t, s):
        total, per_pred, logs = jax_nce(h, t, jnp.asarray(neg), jnp.asarray(base), hfp,
                                        jnp.asarray(lam), s, 0.99, loss_weight=0.7,
                                        extra_mask=jnp.asarray(extra), compute_topk_log=True,
                                        impl=impl)
        return total, (per_pred, logs)

    (jtotal, (jper, jlogs)), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                                         has_aux=True)(
        jnp.asarray(heads), jnp.asarray(tgts), jnp.asarray(ls))
    h, t, s = _t(heads, True), _t(tgts, True), _t(ls, True)
    total, per, logs = multi_horizon_nce(h, t, _t(neg), torch.from_numpy(base), hfp,
                                         torch.from_numpy(lam), s, 0.99, loss_weight=0.7,
                                         extra_mask=torch.from_numpy(extra),
                                         compute_topk_log=True, impl=impl)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=LOSS_RTOL, atol=1e-6)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=LOSS_RTOL, err_msg=k)
    for mine, ref in zip((h.grad, t.grad, s.grad), jgrads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **GRAD_TOL)


def test_clamp_logit_scale_is_straight_through():
    for v in (-1.0, 2.0, 7.0):
        s = torch.tensor(v, requires_grad=True)
        out = clamp_logit_scale(s)
        out.backward()
        np.testing.assert_allclose(out.item(), np.exp(np.clip(v, 0, np.log(100))), rtol=1e-6)
        np.testing.assert_allclose(s.grad.item(), out.item(), rtol=1e-6)


def test_switch_losses_match_jax():
    from mhrec_tpu.models.layers import asymmetric_loss as jax_asym
    from mhrec_tpu.models.layers import weighted_bce_with_logits as jax_bce

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(5, 7)).astype(np.float32) * 3
    tgt = (rng.random((5, 7)) > 0.6).astype(np.float32)
    np.testing.assert_allclose(
        asymmetric_loss(_t(logits)[..., None], _t(tgt)[..., None], gamma_pos=4.0).item(),
        float(jax_asym(logits[..., None], tgt[..., None], gamma_pos=4.0)), rtol=1e-6)
    np.testing.assert_allclose(
        weighted_bce_with_logits(_t(logits), _t(tgt), torch.tensor(2.5)).item(),
        float(jax_bce(logits, tgt, jnp.float32(2.5))), rtol=1e-6)


# ----------------------------------------------------------------------------
# the HSTU training forward
# ----------------------------------------------------------------------------
_PRIOR = dict(loss="prior", eval_num_cats=4, num_prior_head=4, num_segment_head=2,
              prior_switch="in", prior_switch_loss_weight=0.1, neg_sample_by_cat=True)
CASES = {
    "nce": dict(loss="nce", num_segment_head=2),
    "prior-additive-in": dict(_PRIOR, head_interaction="additive"),
    "prior-additive-per_offset": dict(_PRIOR, head_interaction="additive", nce_impl="per_offset"),
    "prior-multiplicative-in_out": dict(_PRIOR, head_interaction="multiplicative",
                                        prior_switch="in_out", neg_sample_by_cat=False),
    "prior-hierarchical-asym": dict(_PRIOR, head_interaction="hierarchical", segment_embed=True,
                                    cat_bottleneck=True, master_switch=True,
                                    asym_switch_loss=True),
}


def _configs(synth_dir, case):
    over = dict(n_layers=1, n_heads=2, item_embedding_size=64, hstu_embedding_size=128,
                MAX_ITEM_LIST_LENGTH=8, pred_len=4, eval_pred_len=4, medusa_num_layers=1,
                num_negatives=96, hidden_dropout_prob=0.0, attn_impl="xla",
                use_native_sampler=False)
    over.update(case)
    jcfg = make_config(synth_dir, **over)
    return jcfg, Config(config_dict=jcfg.as_dict())


@pytest.fixture(scope="module")
def jax_data(synth_dir):
    jcfg, _ = _configs(synth_dir, CASES["prior-additive-in"])
    return JaxData(jcfg).build()


def _grads_by_name(grads, tcfg):
    return {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(np.asarray, grads),
                                                          tcfg).items()}


@pytest.mark.parametrize("name", list(CASES))
def test_training_forward_matches_jax(synth_dir, jax_data, name):
    jcfg, tcfg = _configs(synth_dir, CASES[name])
    train, _, _ = jax_build_dataloader(jcfg, jax_data)
    batch = train.make_batch(np.random.default_rng(0), np.arange(8))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_hstu_from_config(jcfg, jax_data).clone(dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jbatch)["params"]

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch)
        return out["loss"], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tm = hstu_from_config(tcfg, jax_data, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    tbatch = {k: torch.as_tensor(np.asarray(v), dtype=torch.long) for k, v in batch.items()
              if k != "tag_categories"}
    tbatch["tag_categories"] = torch.as_tensor(batch["tag_categories"])
    out = tm(tbatch)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(jloss), rtol=LOSS_RTOL)
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    want = _grads_by_name(jgrads, tcfg)
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for k, ref in want.items():
        g = got[k].grad
        mine = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(mine, ref, atol=BF16_ULP * np.abs(ref).max() + 1e-7,
                                   rtol=0, err_msg=k)
