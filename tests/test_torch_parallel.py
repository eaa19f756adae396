"""The port's data-parallel layer (``mhrec_tpu_torch/parallel``) over a real
2-rank gloo group on the CPU, against single-process references and the
JAX package.

Two processes (``tests/torch_parallel_worker.py``, a free port, a time
limit) run every case once; each test holds one case:

* the comm helpers (object broadcast and gather, barrier, SUM all-reduce,
  broadcast, list all-gather);
* the differentiable all-gather: forward the concatenation in rank order,
  backward each rank's block's gradient summed over the ranks (the
  single-process concatenation's gradient);
* the cross-rank dedup of the unique-id blocks against JAX
  ``dedup_touched_rows`` on the same ids and rows;
* the row-sharded table: lookups, the fetched table, two row updates on
  the rows each rank owns and the full-corpus scores, against the
  replicated table (relative 1e-6; they are equal); chunks of rows fetched
  inside a block and across blocks, and rank 0's host assembly, equal to
  the table's rows, with each byte of a chunk counted once;
* the one-collective metric reduce against JAX ``_normalize_all`` on the
  summed sections;
* ZeRO-2: three steps, the gathered state and a reloaded step equal to the
  replicated AdamW bit for bit;
* one HSTU train step (float32 trunk, dropout on, the table replicated and
  sharded) against the single-process step on the composed batch: the
  global loss, every dense gradient and the first row moments (0.1 × the
  deduped row gradients). The loss's logit tables are bfloat16, and a
  rank's products round apart from the composed batch's, so gradients are
  held to 1% of each tensor's largest entry: a missing rank, a doubled
  block or a per-rank mean would be off by tens of percent.
"""

import copy
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_parallel_worker as W  # noqa: E402

torch.set_num_threads(2)

WORLD = 2


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_parallel_worker.py"),
                               str(r), str(WORLD), str(port), out],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]

    def load(case):
        return [torch.load(os.path.join(out, f"{case}.{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return load


def test_comm_helpers(cases):
    for r, got in enumerate(cases("comm")):
        assert got["count"] == WORLD and got["index"] == r
        assert got["broadcast_object"] == {"from": 1}
        assert got["all_gather_objects"] == [("r", 0), ("r", 1)]
        assert got["all_reduce"].item() == 3.0 and got["broadcast"].item() == 11.0
        for q, t in enumerate(got["all_gather"]):
            assert torch.equal(t, torch.arange(3.0) + q)


def test_all_gather_rows_gradient_is_the_concatenations(cases):
    xs = [torch.randn(5, W.D, generator=W.gen(300 + r)).requires_grad_(True)
          for r in range(WORLD)]
    y = torch.cat(xs)
    sum((torch.randn(y.shape, generator=W.gen(400 + r)) * y).sum()
        for r in range(WORLD)).backward()
    for r, got in enumerate(cases("gather_rows")):
        assert torch.equal(got["y"], y.detach())
        torch.testing.assert_close(got["grad"], xs[r].grad, rtol=1e-6, atol=1e-6)


def test_cross_rank_dedup_matches_jax(cases):
    import jax.numpy as jnp

    from mhrec_tpu.trainer.sparse_adam import dedup_touched_rows as jax_dedup

    ids = np.concatenate([W.id_block(r).numpy() for r in range(WORLD)])
    grads = np.concatenate([W.row_grads(r).numpy() for r in range(WORLD)])
    mask = (ids >= 0).astype(np.float32)
    j_ids, j_mask, j_g = (np.asarray(x) for x in jax_dedup(
        jnp.asarray(np.where(ids >= 0, ids, 0), jnp.int32), jnp.asarray(mask),
        jnp.asarray(grads)))
    want = {int(i): j_g[n] for n, i in enumerate(j_ids) if j_mask[n] > 0}
    for got in cases("dedup"):
        g_ids, g_rows = got["ids"].numpy(), got["grads"].numpy()
        real = g_ids >= 0
        assert sorted(g_ids[real].tolist()) == g_ids[real].tolist() == sorted(want)
        assert (g_rows[~real] == 0).all()
        for i, row in zip(g_ids[real], g_rows[real]):
            np.testing.assert_allclose(row, want[int(i)], rtol=1e-6, atol=1e-7)


def replicated_table():
    """The shard case's table, moments and scores on one process."""
    from mhrec_tpu_torch.models.layers import cosine_normalize
    from mhrec_tpu_torch.trainer.sparse_adam import (
        dedup_touched_rows,
        sparse_adamw_row_update,
    )

    table = W.full_table()
    ids_u, g_u = dedup_touched_rows(torch.stack([W.id_block(r) for r in range(WORLD)]),
                                    torch.stack([W.row_grads(r) for r in range(WORLD)]))
    m, v = torch.zeros_like(table), torch.zeros_like(table)
    for step in range(2):
        sparse_adamw_row_update(table, m, v, ids_u, g_u * (step + 1), 1e-2, step, W.ADAM)
    heads = cosine_normalize(torch.randn(4, 3, W.D, generator=W.gen(9)))
    return table, m, v, heads @ cosine_normalize(table).t()


def test_sharded_table_matches_the_replicated_one(cases):
    table, m, v, scores = replicated_table()
    for r, got in enumerate(cases("shard")):
        assert got["block_rows"] == -(-W.N_ROWS // WORLD)  # half the rows, padded
        want = W.full_table()[W.id_block(r).clamp(min=0).view(3, 4)]
        assert torch.equal(got["lookup"], want)
        for name, ref in (("table", table), ("m", m), ("v", v), ("scores", scores)):
            torch.testing.assert_close(got[name], ref, rtol=1e-6, atol=0, msg=name)


def test_sharded_table_chunks_and_host_assembly(cases):
    got = cases("shard")
    for r, g in enumerate(got):
        for (a, b), rows in g["chunks"].items():
            assert torch.equal(rows, W.full_table()[a:b]), (a, b)
    # the host assembly of the updated table: rank 0 alone, on the CPU, in
    # chunks of 7 rows
    assert got[1]["host"] is None
    host = got[0]["host"]
    assert host.device.type == "cpu" and not host.requires_grad
    torch.testing.assert_close(host, replicated_table()[0], rtol=1e-6, atol=0)
    # each rank counts the rows it broadcast or received once: the chunk
    # fetches (5 + 10 + 18 + 1 rows, then the table and its two moments of
    # 37 rows each) and the assembly's 37
    row = W.D * 4
    for g in got:
        assert g["traffic"] == {"table_chunk": (34 + 3 * W.N_ROWS + W.N_ROWS) * row,
                                "table_save": W.N_ROWS * row}


def test_metric_reduce_matches_jax_normalize_all(cases):
    from mhrec_tpu.trainer.trainer import Trainer as JaxTrainer

    parts = [W.metric_sections(r) for r in range(WORLD)]

    def add(a, b):
        if isinstance(a, tuple):
            return tuple(x + y for x, y in zip(a[:2], b[:2])) + a[2:]
        return a + b

    sections = {sec: {k: add(parts[0][0][sec][k], parts[1][0][sec][k])
                      for k in parts[0][0][sec]} for sec in parts[0][0]}
    jns = SimpleNamespace(config={"metric_decimal_place": 7, "int_to_category": {0: "a"}},
                          num_processes=1)
    jns._reduce_sums = lambda values: JaxTrainer._reduce_sums(jns, values)
    want = JaxTrainer._normalize_all(jns, sections, 240.0, parts[0][1] + parts[1][1],
                                     parts[0][2] + parts[1][2])
    for got in cases("metrics"):
        assert got[0] == want[0]
        assert got[1].keys() == want[1].keys()
        for k in want[1]:
            assert got[1][k] == pytest.approx(want[1][k], rel=1e-12)


def test_zero_sharded_optimizer_equals_replicated_adamw(cases):
    model = W.zero_model()
    opt = W.make_adamw(W.zero_groups(model))
    for step in range(W.ZERO_STEPS):
        W.zero_grads(model, step)
        opt.step()
    state = copy.deepcopy(opt.state_dict())
    W.zero_grads(model, W.ZERO_STEPS)
    opt.step()
    got = cases("zero")
    total = sum(p.numel() for p in model.parameters())
    assert sum(g["owned"] for g in got) == total and all(g["owned"] < total for g in got)
    for g in got:
        assert g["state"]["param_groups"] == state["param_groups"]
        assert g["state"]["state"].keys() == state["state"].keys()
        for i, st in state["state"].items():
            for name, val in st.items():
                assert torch.equal(g["state"]["state"][i][name].cpu(), val.cpu()), (i, name)
        for p, q in zip(g["after_reload"], model.parameters()):
            assert torch.equal(p, q.detach())


@pytest.mark.parametrize("shard_table", [False, True])
def test_train_step_matches_the_composed_batch(cases, shard_table):
    t = W.step_trainer(sparse_adam_global_dedup=True)
    parts = [next(t.batcher(h, WORLD).epoch_batches(0)) for h in range(WORLD)]
    out = t.train_step({k: np.concatenate([b[k] for b in parts]) for k in parts[0]})
    ref_grads = {n: p.grad for n, p in t.model.named_parameters() if p.grad is not None}
    got = cases(f"step_shard{int(shard_table)}")
    for g in got:
        assert g["loss"] == pytest.approx(float(out["loss"].detach()), rel=1e-5)
        assert g["grads"].keys() == ref_grads.keys()
        for name, ref in ref_grads.items():
            scale = float(ref.abs().max()) + 1e-12
            assert float((g["grads"][name] - ref).abs().max()) <= 1e-2 * scale, name
        scale = float(t.table_m.abs().max())
        assert float((g["table_m"] - t.table_m).abs().max()) <= 1e-2 * scale
        # the same touched rows
        assert torch.equal(g["table_m"].abs().sum(-1) > 0, t.table_m.abs().sum(-1) > 0)
    # the ranks hold one state
    assert got[0]["checksum"] == got[1]["checksum"]
    assert all(torch.equal(got[0]["grads"][n], got[1]["grads"][n]) for n in ref_grads)
