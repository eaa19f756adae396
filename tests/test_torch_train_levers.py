"""The HLLM training levers of the port against the JAX package, on the CPU.

* ``adam_mu_dtype`` / ``adam_nu_dtype`` (bfloat16 moments, one or both) and
  the modal / rec learning-rate split (``modal_lr`` …, with float32 and
  with bfloat16 moments): 3 steps of the port's ``build_optimizer`` against
  the JAX package's on the same parameters and gradients (numpy, seeded).
  Parameters to rtol 1e-6 (float32 arithmetic in both; XLA's and torch's
  ``pow`` of the bias corrections may differ by an ulp); stored bfloat16
  moments within one bfloat16 ulp, float32 ones to rtol 1e-6. Without a
  moment dtype the port runs ``torch.optim.AdamW``, which takes the bias
  correction 1 − b2^t in float64 where optax takes it in float32 (1.3e-5
  off at t = 1): there the parameters get atol 2e-5·lr beside rtol 1e-6;
* a checkpoint saved asynchronously is seen by a **second** ``Trainer``
  that loads the same directory at once, holding the state of the moment
  of the save although the first trainer changes its parameters right
  after; a synchronous save too;
* a writer that fails raises at the next wait (the next save, a load),
  and at every wait until a new save replaces it, and leaves no temporary
  file; waiters on several threads all wait for the write and all see its
  error; the end of ``fit`` waits for its save.
"""

import glob
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhrec_tpu.trainer.optim import build_optimizer as jax_build_optimizer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.data import InteractionData, build_dataloader
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.trainer import checkpoint as ckpt_io
from mhrec_tpu_torch.trainer.optim import AdamWCast, build_optimizer
from tests.conftest import make_config

torch.set_num_threads(2)

RTOL = 1e-6
STEPS = 3
# parameter names → shapes: a vision-like subtree (the modal group), the
# towers and the heads (the rec group)
SHAPES = {"visual_encoder.proj.weight": (6, 5), "visual_encoder.proj.bias": (6,),
          "item_llm.layer.weight": (4, 7), "user_llm.norm.weight": (7,),
          "head.bias": (3,)}
CASES = {
    "mu_bf16": dict(adam_mu_dtype="bfloat16"),
    "nu_bf16": dict(adam_nu_dtype="bfloat16"),
    "mu_nu_bf16": dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16"),
    "modal_split": dict(optim_args={"modal_lr": 3e-3, "modal_decay": 0.05, "rec_lr": 1e-3,
                                    "rec_decay": 0.01}),
    "modal_split_bf16": dict(optim_args={"modal_lr": 3e-3, "modal_decay": 0.05,
                                         "rec_lr": 1e-3, "rec_decay": 0.01},
                             adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16"),
}


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for name, v in values.items():
            mod = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _nest(flat):
    out = {}
    for name, v in flat.items():
        d = out
        *path, leaf = name.split(".")
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(jnp.asarray(v, jnp.float32))
    return out


def _bf16_ulp(x):
    """One bfloat16 ulp at each |x| (the smallest normal's below it)."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    over = dict(CASES[case])
    config = {"optim_args": over.pop("optim_args", {"learning_rate": 2e-3,
                                                    "weight_decay": 0.02}), **over}
    rng = np.random.default_rng(0)
    values = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]

    # the JAX package's optimizer (a constant schedule at each group's rate)
    params = jax.tree.map(jnp.asarray, _nest(values))
    tx = jax_build_optimizer(config, lambda lr: (lambda count: lr), STEPS)(params)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, _nest(g)), state, params)
        params = optax.apply_updates(params, updates)

    model = _Params(values)
    opt, schedules, frozen = build_optimizer(config, model, lambda lr: (lambda step: lr))
    assert not frozen
    assert isinstance(opt, AdamWCast) == ("adam_mu_dtype" in config or
                                          "adam_nu_dtype" in config)
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        for name, p in named.items():
            p.grad = torch.from_numpy(g[name])
        for group, sched in zip(opt.param_groups, schedules):
            group["lr"] = sched(step)
        opt.step()
    want = _flat(params)
    cast = isinstance(opt, AdamWCast)
    atol = 0.0 if cast else 2e-5 * max(g["lr"] for g in opt.param_groups)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=RTOL, atol=atol,
                                   err_msg=name)
    if "modal_split" in case:
        lrs = sorted(g["lr"] for g in opt.param_groups)
        assert lrs == [1e-3, 3e-3]
        return
    # single group: the moments sit in the chain's first state
    adam = state[0]
    for key, moment, dtype_key in (("exp_avg", adam.mu, "adam_mu_dtype"),
                                   ("exp_avg_sq", adam.nu, "adam_nu_dtype")):
        ref = _flat(moment)
        for name, p in named.items():
            got = opt.state[p][key]
            if config.get(dtype_key):
                assert got.dtype == torch.bfloat16
                diff = np.abs(got.float().numpy() - ref[name])
                assert (diff <= _bf16_ulp(ref[name])).all(), (name, key)
            else:
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), ref[name], rtol=RTOL, err_msg=name)


def test_moment_dtypes_survive_a_state_dict_round_trip():
    rng = np.random.default_rng(1)
    values = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    model = _Params(values)
    cfg = {"optim_args": {"learning_rate": 1e-3}, "adam_mu_dtype": "bfloat16"}
    opt = build_optimizer(cfg, model, lambda lr: (lambda step: lr))[0]
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    saved = opt.state_dict()
    again = build_optimizer(cfg, model, lambda lr: (lambda step: lr))[0]
    again.load_state_dict(saved)
    for p in model.parameters():
        a, b = opt.state[p], again.state[p]
        assert b["exp_avg"].dtype == torch.bfloat16 and b["exp_avg_sq"].dtype == torch.float32
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and float(b["step"]) == 1.0
    with pytest.raises(ValueError, match="moment dtype"):
        build_optimizer({"optim_args": {}, "adam_nu_dtype": "int8"}, model,
                        lambda lr: (lambda step: lr))


# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data(synth_dir, tmp_path_factory):
    return InteractionData(_config(synth_dir, tmp_path_factory.mktemp("d"))).build()


def _config(synth_dir, tmp, **over):
    base = dict(n_layers=1, n_heads=2, item_embedding_size=32, hstu_embedding_size=32,
                MAX_ITEM_LIST_LENGTH=8, pred_len=2, eval_pred_len=2, train_batch_size=8,
                num_negatives=16, hidden_dropout_prob=0.0, use_native_sampler=False,
                checkpoint_dir=str(tmp), total_iters=2, eval_interval=100)
    base.update(over)
    return Config(config_dict=make_config(synth_dir, **base).as_dict())


def _slow_writes(monkeypatch, seconds=0.3):
    """The writer thread sleeps before it writes, so a load that did not
    wait would find no checkpoint (or the previous one)."""
    write = ckpt_io.write_checkpoint

    def slow(payload, path):
        time.sleep(seconds)
        return write(payload, path)

    monkeypatch.setattr(ckpt_io, "write_checkpoint", slow)


@pytest.mark.parametrize("asynchronous", [True, False], ids=["async", "sync"])
def test_second_trainer_sees_the_checkpoint(synth_dir, data, tmp_path, monkeypatch,
                                            asynchronous):
    _slow_writes(monkeypatch)
    cfg = _config(synth_dir, tmp_path, async_checkpoint=asynchronous)
    a = Trainer(cfg, data, device="cpu")
    a.setup_model()
    for round_ in range(3):
        a.step = round_ + 1
        a.best_valid_score = 0.1 * round_
        want = {k: v.clone() for k, v in a.model.state_dict().items()}
        t0 = time.perf_counter()
        a.save_checkpoint()
        blocked = time.perf_counter() - t0
        assert a.checkpoint_stats["asynchronous"] == asynchronous
        if asynchronous:
            assert blocked < 0.3 and "bytes" not in a.checkpoint_stats
            assert a.checkpoint_stats["host_copy_bytes"] > 0
        with torch.no_grad():  # the loop goes on at once
            for p in a.model.parameters():
                p.add_(1.0)
        b = Trainer(cfg, data, device="cpu")
        b.setup_model(seed=round_ + 5)
        assert b.load_checkpoint()
        assert b.step == round_ + 1 and b.best_valid_score == pytest.approx(0.1 * round_)
        for k, v in b.model.state_dict().items():
            assert torch.equal(v, want[k]), (round_, k)
        assert a.checkpoint_stats["bytes"] == os.path.getsize(a.checkpoint_path())
        assert a.checkpoint_stats["save_s"] >= 0.3
    assert not glob.glob(os.path.join(a.saved_model_dir, "*.tmp"))


def test_failed_write_raises_at_the_next_wait(synth_dir, data, tmp_path, monkeypatch):
    cfg = _config(synth_dir, tmp_path)
    a = Trainer(cfg, data, device="cpu")
    a.setup_model()
    a.save_checkpoint()
    a.wait_for_checkpoint()
    good = os.path.getsize(a.checkpoint_path())

    def failing(payload, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing)
    a.save_checkpoint()  # returns: the writer fails behind it
    with pytest.raises(RuntimeError, match="checkpoint") as info:
        a.save_checkpoint()  # the next save waits first
    assert isinstance(info.value.__cause__, OSError)
    a.save_checkpoint()
    with pytest.raises(RuntimeError, match="checkpoint"):
        Trainer(cfg, data, device="cpu").load_checkpoint()  # a load waits too
    with pytest.raises(RuntimeError, match="checkpoint"):
        ckpt_io.wait_for_write(a.checkpoint_path())  # every waiter sees the failure
    # the last good checkpoint stands and no temporary file is left
    assert os.path.getsize(a.checkpoint_path()) == good
    assert not glob.glob(os.path.join(a.saved_model_dir, "*.tmp"))
    # a save that succeeds replaces the failed write: loads see it again
    monkeypatch.undo()
    a.step = 7
    a.save_checkpoint()
    b = Trainer(cfg, data, device="cpu")
    b.setup_model(seed=3)
    assert b.load_checkpoint() and b.step == 7
    ckpt_io.wait_for_write(a.checkpoint_path())
    assert a.checkpoint_path() not in ckpt_io._writes


@pytest.mark.parametrize("fails", [False, True], ids=["succeeds", "fails"])
def test_every_waiter_waits_for_the_write(tmp_path, monkeypatch, fails):
    """Waiters on several threads all return only once the write is done,
    and all raise its error when it failed; the entry stays in the registry
    until then."""
    write = ckpt_io.write_checkpoint

    def slow(payload, path):
        time.sleep(0.3)
        if fails:
            raise OSError("disk full")
        return write(payload, path)

    monkeypatch.setattr(ckpt_io, "write_checkpoint", slow)
    path = str(tmp_path / "checkpoint.pt")
    ckpt_io.start_write(path, {"x": torch.arange(5)})
    seen = []

    def waiter():
        try:
            ckpt_io.wait_for_write(path)
            seen.append(os.path.isfile(path))
        except RuntimeError as e:
            seen.append(type(e.__cause__))

    threads = [threading.Thread(target=waiter) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == ([OSError] * 3 if fails else [True] * 3)
    assert (path in ckpt_io._writes) == fails
    if fails:  # a new write of the path replaces the failed one
        monkeypatch.setattr(ckpt_io, "write_checkpoint", write)
        ckpt_io.start_write(path, {"x": torch.arange(5)})
        ckpt_io.wait_for_write(path)
        assert path not in ckpt_io._writes
    assert torch.equal(torch.load(path, weights_only=True)["x"], torch.arange(5))


def test_fit_waits_for_its_checkpoint(synth_dir, data, tmp_path, monkeypatch):
    _slow_writes(monkeypatch)
    cfg = _config(synth_dir, tmp_path, total_iters=2, eval_interval=2)
    a = Trainer(cfg, data, device="cpu")
    a.setup_model()
    train, valid, _ = build_dataloader(cfg, data)
    a.fit(train, valid)
    # the write finished inside fit: its stats are in, nothing is in flight
    assert a.checkpoint_stats["bytes"] == os.path.getsize(a.checkpoint_path())
    assert a.checkpoint_path() not in ckpt_io._writes
