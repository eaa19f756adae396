"""The port's HLLM training path against the JAX package's, on the CPU.

Both packages build HLLM with tiny Llama towers (``random_init_towers``:
``LLMConfig.tiny``, 2 layers, 64 wide, 4 heads over 2 KV heads), hierarchical
prior heads (4 categories × 2 segment heads, one medusa layer, segment
embeddings, the prior switch at weight 0.1), the packed item tower in
chunk rows of 128 tokens, ``precision: 32``, on the parquet fixture of
``generate_synthetic_dataset`` (120 users, 300 items with texts). The JAX
parameters are carried into the port with ``convert.py``; the batches are
the JAX batcher's (numpy sampler), fed to both.

* (a) ``PackedAttention``'s dq/dk/dv on CPU tensors against ``jax.grad`` of
  ``packed_attention_dense`` (with a band and GQA, the cotangent zero on
  padding rows), to 1e-5;
* (b) ``TextSEQTrainBatcher``'s batches equal the JAX one's, dense, packed
  and ``dedup_items``;
* (c) ``HLLM.forward``'s loss and every gradient against
  ``jax.value_and_grad`` of ``HLLM.__call__``, for the packed, dense, dedup
  and ``freeze_item_llm`` branches, with gradient checkpointing on and off
  in the port (in the JAX package remat changes no value, so its reference
  is computed once per branch): loss to rtol 1e-5; each gradient tensor to
  a relative L2 error of 2e-4, a tensor's norm taken as at least 1e-4 of
  the largest one's (the loss's logit tables are bfloat16 products on both
  sides; what stays is float32 summation order, at most 1.3e-4 on the user
  tower's first query projection, whose gradients of about 1e-9 come out
  of the softmax backward's cancellation). The item tower is also
  held alone, without the loss: its vector-Jacobian product for one random
  cotangent against ``jax.vjp``, packed and dense, remat on and off, each
  parameter's gradient to a relative L2 error of 1e-4;
* (d) an 8-step loss trajectory of the JAX train step against the port's
  ``Trainer.train_step`` on the same batches, packed tower, to rtol 1e-4;
* (e) ``python -m mhrec_tpu_torch.run --device cpu`` training HLLM: fit, the
  best-checkpoint save and the test split evaluated from it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.models.llm.packed import packed_attention_dense
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import build_dataloader
from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
from mhrec_tpu_torch.models.llm.packed import PackedAttention
from mhrec_tpu_torch.trainer import Trainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
LOSS_TOL = 1e-5
LOSS_GRAD_TOL = 2e-4  # float32 summation order, see the docstring
GRAD_TOL = 1e-4
BRANCHES = {  # the item tower's batch layouts
    "packed": dict(packed_item_tower=True),
    "dense": dict(packed_item_tower=False),
    "dedup": dict(packed_item_tower=False, dedup_items=True, dedup_bucket_quantum=8),
    "freeze": dict(packed_item_tower=False, freeze_item_llm=True),
}


def _overrides(synth_dir, tmp, **over):
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
        scheduler_args={"type": "constant"},
    )
    d.update(over)
    return d


@pytest.fixture(scope="module")
def setup(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hllm_train")
    over = _overrides(synth_dir, tmp)
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
    return dict(tmp=tmp, over=over, jdata=JaxData(jcfg).build(), jcfg=jcfg)


def _configs(s, **over):
    over = dict(s["over"], **over)
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
    return jcfg, Config(config_file_list=YAMLS, config_dict=over).finalize()


# ----------------------------------------------------------------------------
def test_packed_attention_grads_match_jax():
    """(a) two chunk rows of 40 tokens, segments of 1-9 tokens, trailing
    padding, band 6, 4 query heads over 2 KV heads."""
    rng = np.random.default_rng(0)
    C, S, H, Hkv, dh, w = 2, 40, 4, 2, 8, 6
    seg = np.zeros((C, S), np.int32)
    sid = 0
    for c in range(C):
        off = 0
        while off < S - 12:
            n = int(rng.integers(1, 10))
            sid += 1
            seg[c, off:off + n] = sid
            off += n
    q = rng.normal(size=(C, S, H, dh)).astype(np.float32)
    k, v = (rng.normal(size=(C, S, Hkv, dh)).astype(np.float32) for _ in range(2))
    cot = rng.normal(size=(C, S, H, dh)).astype(np.float32) * (seg > 0)[..., None, None]

    def f(q, k, v):
        rep = lambda x: jnp.repeat(x, H // Hkv, axis=2)  # noqa: E731
        out = jax.vmap(lambda qq, kk, vv, ss: packed_attention_dense(qq, kk, vv, ss, window=w))(
            q, rep(k), rep(v), jnp.asarray(seg))
        return jnp.sum(out * cot)

    ref = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = PackedAttention.apply(*leaves, torch.from_numpy(seg), w)
    out.backward(torch.from_numpy(cot))
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert not leaf.grad.numpy()[seg == 0].any()  # padding keys: no gradient


# ----------------------------------------------------------------------------
@pytest.mark.parametrize("branch", ["packed", "dense", "dedup"])
def test_text_batcher_matches_jax(setup, branch):
    """(b) the port's text train batcher against the JAX package's."""
    jcfg, tcfg = _configs(setup, **BRANCHES[branch])
    ours = TextSEQTrainBatcher(tcfg, setup["jdata"]).epoch_batches(1)
    ref = JaxTextBatcher(jcfg, setup["jdata"]).epoch_batches(1)
    want = {"packed": "packed_tokens", "dense": "pos_tokens", "dedup": "uniq_tokens"}[branch]
    for _ in range(3):
        b, r = next(ours), next(ref)
        assert want in r and set(b) == set(r)
        for key in r:
            np.testing.assert_array_equal(b[key], r[key], err_msg=key)


# ----------------------------------------------------------------------------
def _random_params(jt, seed):
    """Parameters at the shapes the JAX model's init makes (``jax.eval_shape``,
    no compile): normal 0.02 kernels and biases, 1 + 0.1·normal norm scales,
    logit scale ln(1/0.07), and unit-normal token embeddings and emb-token
    slots. At 0.02 the slot's own embedding outweighs the text's pull
    through two 0.02-wide layers, so every item comes out nearly the same
    vector: cosines sit at the loss's 0.99 NCE threshold and a rounding flips
    which negatives count. At unit scale the items differ."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "mix", "neg"))}
    shapes = jax.eval_shape(lambda: jt.model.init(rngs, jt._example_batch(minimal=True),
                                                  deterministic=False))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        if "logit_scale" in key:
            return np.full(x.shape, np.log(1 / 0.07), np.float32)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if "norm" in key or key.endswith("['scale']"):
            return 1.0 + 0.1 * noise
        if "embed_tokens" in key or "item_emb_tokens" in key:
            return noise
        return 0.02 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_reference(setup, branch):
    """The JAX model of ``branch``, random parameters, the first batch of
    its batcher, and the loss and gradients of ``HLLM.__call__``."""
    jcfg, tcfg = _configs(setup, **BRANCHES[branch])
    jt = JaxTrainer(jcfg, setup["jdata"])
    params = _random_params(jt, seed=1)
    extra = {}
    if branch == "freeze":
        table = np.random.default_rng(2).normal(size=(setup["jdata"].item_num, 64))
        extra = {"frozen": {"all_item_embeds": jnp.asarray(table, jnp.float32)}}
    batch = next(JaxTextBatcher(jcfg, setup["jdata"]).epoch_batches(0))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "mix", "neg"))}

    def loss_fn(p):
        out = jt.model.apply({"params": p, **extra}, {k: jnp.asarray(v) for k, v in batch.items()},
                             deterministic=False, rngs=rngs)
        return out["loss"], out

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return dict(jt=jt, tcfg=tcfg, params=params, extra=extra, batch=batch, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module", params=list(BRANCHES))
def reference(request, setup):
    return request.param, _jax_reference(setup, request.param)


def _port_trainer(setup, ref):
    tt = Trainer(ref["tcfg"], setup["jdata"], device="cpu")
    tt.setup_model()
    sd = state_dict_from_flax(ref["params"], ref["tcfg"])
    if ref["extra"]:
        sd["all_item_embeds"] = torch.from_numpy(
            np.asarray(ref["extra"]["frozen"]["all_item_embeds"]))
    tt.model.load_state_dict(sd, strict=True)
    return tt


def _rel_l2(a, b, floor=1e-30):
    """‖a − b‖ / ‖b‖, with ‖b‖ taken as at least ``floor``."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_grads_match_jax(setup, reference, remat):
    """(c) one batch's loss and every gradient, per branch."""
    branch, ref = reference
    tt = _port_trainer(setup, ref)
    model = tt.model
    for tower in ("item_llm", "user_llm"):
        if hasattr(model, tower):
            getattr(model, tower).gradient_checkpointing = remat
    out = model(tt._train_device_batch(ref["batch"]), generator=tt.step_generator(0))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), ref["loss"], rtol=LOSS_TOL)
    want = state_dict_from_flax(ref["grads"], ref["tcfg"])
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    # a gradient 1e4 times smaller than the largest one is held to that
    # floor: a saturated softmax leaves the prior classifier's heads
    # gradients of float32 noise (exactly 0 here, 5e-9 of the largest in
    # the JAX package)
    floor = 1e-4 * max(float(np.linalg.norm(g.numpy())) for g in want.values())
    for name, g in want.items():
        err = _rel_l2(named[name].grad.numpy(), g.numpy(), floor)
        assert err <= LOSS_GRAD_TOL, (branch, name, err)
    if branch in ("packed", "dense"):
        _check_item_tower_vjp(tt, ref, branch)


def _check_item_tower_vjp(tt, ref, branch):
    """The item tower alone (packed: ``encode_items_packed`` over the
    batch's chunk rows; dense: ``encode_items`` over its positives) pulled
    back along one random cotangent, against ``jax.vjp``."""
    b = ref["batch"]
    if branch == "packed":
        method = "encode_items_packed"
        args = [b[k] for k in ("packed_tokens", "packed_segment_ids", "packed_positions",
                               "emb_slots")]
        targs = [torch.from_numpy(a).long() for a in args]
        targs[1] = targs[1].int()
    else:
        method, args = "encode_items", [b["pos_tokens"], b["pos_token_lens"]]
        targs = [torch.from_numpy(a).long() for a in args]
    jt = ref["jt"]

    def pullback(p, cot):
        embs, vjp = jax.vjp(lambda q: jt.model.apply({"params": q}, *map(jnp.asarray, args),
                                                     method=method), p)
        return embs, vjp(cot)[0]

    n = len(args[-1]) if branch == "packed" else len(args[1])
    cot = np.random.default_rng(3).normal(size=(n, 64)).astype(np.float32)
    embs, grads = jax.jit(pullback)(jax.tree.map(jnp.asarray, ref["params"]), cot)
    model = tt.model
    model.zero_grad(set_to_none=True)
    out = getattr(model, method)(*targs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(embs), rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(cot))
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads), ref["tcfg"])
    for name, p in model.named_parameters():
        if name.startswith("item_llm.") or name == "item_emb_tokens":
            assert _rel_l2(p.grad.numpy(), want[name].numpy()) <= GRAD_TOL, (branch, name)


# ----------------------------------------------------------------------------
def _same_chunk_rows(batches):
    """Pad every packed batch to the largest chunk-row count with rows of
    padding (segment 0), so the JAX train step compiles once; emb_slots
    index the rows before the padding and stay as they are."""
    C = max(b["packed_tokens"].shape[0] for b in batches)
    for b in batches:
        pad = ((0, C - b["packed_tokens"].shape[0]), (0, 0))
        for key in ("packed_tokens", "packed_segment_ids", "packed_positions"):
            b[key] = np.pad(b[key], pad)
    return batches


def _jax_train_state(jt, params):
    """The JAX trainer's state and jitted step at ``params`` (what
    ``setup_model`` builds, without its eager init of the model)."""
    from mhrec_tpu.trainer.trainer import TrainState

    params = jax.tree.map(jnp.asarray, params)
    jt.tx = jt._make_tx(params)
    jt.extra_vars = {}
    jt.state = TrainState(params=params, opt_state=jt.tx.init(params),
                          step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0),
                          nan_step=jnp.asarray(-1, jnp.int32))
    jt._build_train_step()


def test_loss_trajectory_matches_jax(setup):
    """(d) 8 steps at the protocol's learning rate, 1e-4 (weight decay 0.01,
    constant schedule), from the same weights on the same packed batches."""
    jcfg, tcfg = _configs(setup, optim_args={"learning_rate": 1e-4, "weight_decay": 0.01})
    jt = JaxTrainer(jcfg, setup["jdata"])
    params = _random_params(jt, seed=4)
    _jax_train_state(jt, params)
    tt = Trainer(tcfg, setup["jdata"], device="cpu")
    tt.setup_model()
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    stream = JaxTextBatcher(jcfg, setup["jdata"]).epoch_batches(0)
    batches = _same_chunk_rows([next(stream) for _ in range(8)])
    jl, tl = [], []
    for batch in batches:
        jt.state, jout = jt._jit_train_step(jt.state, {k: jnp.asarray(v) for k, v in batch.items()})
        jl.append(float(jout["loss"]))
        tl.append(tt.train_step(batch)["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# ----------------------------------------------------------------------------
def test_run_trains_hllm_on_the_cpu(synth_dir, tmp_path):
    """(e) the CLI's training path with the packed item tower and gradient
    checkpointing: fit with an evaluation and a best-checkpoint save, then
    the test split evaluated from that checkpoint."""
    over = _overrides(synth_dir, tmp_path, gradient_checkpointing=True, total_iters=4,
                      eval_interval=2, packed_corpus_pass=True)
    cmd = [sys.executable, "-m", "mhrec_tpu_torch.run", "--device", "cpu",
           "--config_file", *YAMLS, "--"]
    for key in ("data_path", "dataset", "text_path", "precision", "random_init_towers",
                "MAX_ITEM_LIST_LENGTH", "MAX_TEXT_LENGTH", "train_batch_size",
                "eval_batch_size", "num_negatives", "tag_version", "loss", "eval_num_cats",
                "num_prior_head", "num_segment_head", "head_interaction", "medusa_num_layers",
                "segment_embed", "pred_len", "eval_pred_len", "packed_item_tower",
                "packed_corpus_pass", "pack_chunk", "gradient_checkpointing", "total_iters",
                "eval_interval", "checkpoint_dir"):
        cmd += [f"--{key}", str(over[key])]
    cmd += ["--topk", "[5,10]", "--result_json_path", str(tmp_path / "res")]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = proc.stdout + proc.stderr
    assert "fit done: 4 steps" in log and "pred_3: {" in log
    assert (tmp_path / "ckpt" / "HLLM-SynthRec" / "ckpt" / "checkpoint.pt").is_file()
    import json

    res = json.loads((tmp_path / "res.0.json").read_text())
    assert np.isfinite(res["final_loss"])
