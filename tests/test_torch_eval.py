"""The whole serving slice: the port's ``Trainer.evaluate`` against the JAX
package's on the same data and the same weights.

Both trainers evaluate the test split of the ``prior_config`` fixture (HSTU
with 4 prior heads and the prior switch, a 300-item corpus scored in item
chunks of 125, so the streamed top-k merges three chunks, the last one
padded; it keeps 50 real items, the largest k, as a head the switch turns
off takes its top-k from the last chunk's first ids). The JAX model is cloned to float32 and its initialised parameters
are carried into the port with ``state_dict_from_flax``; the port runs on
the CPU in float32. Every metric must agree within 1e-6 and the top-k item
indices handed to the collector must be equal.

A second evaluation turns the category-0 switch off for every user (its
classifier's bias set to -1e4), so head 0 scores every item −inf and its
top-k is decided by tie order alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import build_dataloader
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_eval_dataloaders
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.trainer.trainer import _tie_keys, topk_first

torch.set_num_threads(2)

TOL = 1e-6


def _record_topk(trainer):
    """Wrap the collector so each batch's top-k indices are kept."""
    seen = []
    collect = trainer.collector.eval_batch_collect

    def wrapped(**kw):
        seen.append(np.asarray(kw["topk_indices"]).copy())
        return collect(**kw)

    trainer.collector.eval_batch_collect = wrapped
    return seen


def _switch_off_cat0(params):
    params = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    params["aux_cat_head_0"]["bias"] = np.full_like(params["aux_cat_head_0"]["bias"], -1e4)
    return params


@pytest.fixture(scope="module")
def runs(prior_config, prior_data, tmp_path_factory):
    over = dict(prior_config.as_dict(), eval_item_chunk_size=125,
                checkpoint_dir=str(tmp_path_factory.mktemp("torch_eval")))
    jcfg = JaxConfig(config_dict=over)
    _, _, jtest = build_dataloader(jcfg, prior_data)
    jt = JaxTrainer(jcfg, prior_data)
    jt.model = jt.model.clone(dtype=jnp.float32)
    jt.setup_model()
    params = {k: v for k, v in jax_to_numpy(jt.state.params).items()}
    jseen = _record_topk(jt)
    jax_res = [jt.evaluate(jtest, load_best_model=False)]
    jt.state = jt.state.replace(params=_switch_off_cat0(params))
    jax_res.append(jt.evaluate(jtest, load_best_model=False))

    tcfg = Config(config_dict=over)
    data = InteractionData(tcfg).build()
    _, test = build_eval_dataloaders(tcfg, data)
    tt = Trainer(tcfg, data, device="cpu", dtype=torch.float32)
    tseen = _record_topk(tt)
    torch_res = []
    for p in (params, _switch_off_cat0(params)):
        tt.model.load_state_dict(state_dict_from_flax(p, tcfg), strict=True)
        torch_res.append(tt.evaluate(test, load_best_model=True))
    return dict(jax=jax_res, torch=torch_res, jax_topk=jseen, torch_topk=tseen,
                jax_data=prior_data, data=data, n_batches=len(jseen) // 2)


def jax_to_numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_port_data_matches_jax_data(runs):
    jd, td = runs["jax_data"], runs["data"]
    assert (jd.item_num, jd.user_num) == (td.item_num, td.user_num)
    np.testing.assert_array_equal(jd.item_tag_matrix, td.item_tag_matrix)
    np.testing.assert_array_equal(jd.seq_offsets, td.seq_offsets)
    np.testing.assert_array_equal(jd.flat_items, td.flat_items)


@pytest.mark.parametrize("run", [0, 1], ids=["switch-as-predicted", "cat0-switched-off"])
def test_evaluate_matches_jax(runs, run):
    ref, out = runs["jax"][run], runs["torch"][run]
    assert set(out) == set(ref) and "shared" in out
    for section in ref:
        assert set(out[section]) == set(ref[section]), section
        for key, v in ref[section].items():
            assert out[section][key] == pytest.approx(v, abs=TOL), (section, key)


@pytest.mark.parametrize("run", [0, 1], ids=["switch-as-predicted", "cat0-switched-off"])
def test_streamed_topk_indices_match_jax(runs, run):
    n = runs["n_batches"]
    jax_topk = runs["jax_topk"][run * n:(run + 1) * n]
    torch_topk = runs["torch_topk"][run * n:(run + 1) * n]
    assert len(torch_topk) == n > 1
    for a, b in zip(jax_topk, torch_topk):
        np.testing.assert_array_equal(b, a)
    if run == 1:
        # head 0 is all −inf for every user: tie order alone picks its
        # top-k, the same ids for all (the last chunk's first ones, as the
        # merge puts the fresh chunk first)
        np.testing.assert_array_equal(b[:, 0], np.broadcast_to(b[:1, 0], b[:, 0].shape))
        accs = [{k: v for k, v in r["shared"].items() if k.startswith("head_cat_")}
                for r in runs["torch"]]
        assert len(accs[0]) == 4 and accs[0] != accs[1]


def test_topk_first_breaks_ties_by_lower_position():
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, 2.0, -np.inf, -np.inf]])
    vals, pos = topk_first(x, 5)
    assert pos.tolist() == [[1, 2, 4, 5, 0]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0, 1.0]]
    vals, pos = topk_first(torch.full((2, 3, 9), -np.inf), 4)
    assert pos.tolist() == [[[0, 1, 2, 3]] * 3] * 2


# a chunk longer than 2^24 positions: a float32 rank n..1 would merge
# neighbouring ranks above 2^24, i.e. at the first 1024 positions
LONG_ROW = 2**24 + 1024


def _long_row(kind):
    """[1, LONG_ROW] float32: all −inf (a switched-off head), or −inf with two
    entries above the k-th value past 2^24 and the k-th value tied at
    positions 0, 1, 2, 5 and two past 2^24."""
    x = np.full(LONG_ROW, -np.inf, np.float32)
    if kind == "ties":
        x[[2**24 + 3, 2**24 + 900]] = 2.0
        x[[0, 1, 2, 5, 2**24 + 1, 2**24 + 7]] = 1.0
    return x[None]


@pytest.mark.parametrize("kind,k", [("neg_inf", 4), ("ties", 5)])
def test_tie_keys_stay_distinct_past_2_24(kind, k):
    """Over the positions tied at the k-th value the keys fall strictly with
    the position, so the lower position always ranks first."""
    x = torch.from_numpy(_long_row(kind))
    kth = torch.topk(x, k, dim=-1).values.min(dim=-1, keepdim=True).values
    key = _tie_keys(x, kth)[0]
    tied = key[(x == kth)[0]]
    assert tied.numel() == (LONG_ROW if kind == "neg_inf" else 6)
    assert bool((tied[1:] < tied[:-1]).all())
    assert bool((key[(x > kth)[0]] > tied.max()).all())


@pytest.mark.parametrize("kind,k", [("neg_inf", 4), ("neg_inf", 7), ("ties", 3),
                                    ("ties", 5), ("ties", 8)])
def test_topk_first_matches_lax_top_k_past_2_24(kind, k):
    x = _long_row(kind)
    ref_vals, ref_pos = jax.lax.top_k(jnp.asarray(x), k)
    vals, pos = topk_first(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def test_entry_points_refuse_to_leave_the_card_unasked(prior_config, monkeypatch):
    """With no CUDA device the port raises unless the CPU is asked for."""
    from mhrec_tpu_torch.run import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(config_dict=prior_config.as_dict()), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config_file", "IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml",
              "--", "--val_only", "True"])
    # the training path (no --val_only) as well
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config_file", "IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"])
