"""One rank of the 2-rank checks of ``tests/test_torch_parallel.py``: joins a
gloo group on the CPU and runs every case below in order, saving what
each produced to ``{out}/{case}.{rank}.pt`` for the test to hold against
single-process references. Imports nothing of JAX.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT

``hllm RANK WORLD PORT OUT`` runs the HLLM cases of
``tests/test_torch_multiprocess_hllm.py`` instead (``run_hllm``), and
``table RANK WORLD PORT OUT`` the row-sharded table's run of
``tests/test_torch_multiprocess_table.py`` (``run_table``), and ``fsdp RANK
WORLD PORT OUT DEVICE`` FSDP's collectives and a sharded tower of
``tests/test_torch_fsdp.py`` and ``tests/test_torch_cuda.py`` on DEVICE
(``run_fsdp``).
"""

import copy
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch
import torch.utils._python_dispatch
import torch.utils._pytree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mhrec_tpu_torch.models.layers import ItemEmbed, cosine_normalize  # noqa: E402
from mhrec_tpu_torch.parallel import RowShard, comm, init_distributed, make_mesh  # noqa: E402
from mhrec_tpu_torch.trainer.optim import ZeroShardedOptimizer  # noqa: E402
from mhrec_tpu_torch.trainer.sparse_adam import (  # noqa: E402
    SparseAdamConfig,
    dedup_touched_rows,
    sparse_adamw_row_update,
)

torch.set_num_threads(1)

# shared shapes of the cases
N_ROWS, D, U = 37, 8, 12   # table rows (odd: the last block is padded), width, block slots
ADAM = SparseAdamConfig(weight_decay=0.01)
ZERO_STEPS = 3


def gen(seed):
    return torch.Generator().manual_seed(seed)


def id_block(rank):
    """Rank ``rank``'s unique-id block: distinct ids ascending, −1 pads;
    the two ranks' blocks share some ids."""
    rng = np.random.default_rng(100 + rank)
    n = 9 - rank
    ids = np.full(U, -1, np.int64)
    ids[:n] = np.sort(rng.choice(N_ROWS, n, replace=False))
    return torch.as_tensor(ids)


def row_grads(rank):
    return torch.randn(U, D, generator=gen(200 + rank))


def full_table():
    return torch.randn(N_ROWS, D, generator=gen(7))


def zero_model():
    torch.manual_seed(3)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 4),
                               torch.nn.Linear(4, 3))


def zero_groups(model):
    ps = list(model.parameters())
    return [{"params": ps[:4], "lr": 1e-2, "weight_decay": 0.01},
            {"params": ps[4:], "lr": 3e-2, "weight_decay": 0.0}]


def make_adamw(groups):
    return torch.optim.AdamW(groups, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def zero_grads(model, step):
    for i, p in enumerate(model.parameters()):
        p.grad = torch.randn(p.shape, generator=gen(1000 * step + i))


def metric_sections(rank):
    """One rank's raw metric sums (floats and (sum, count[, 'sqrt']))."""
    r = float(rank)
    sections = {"pred_1": {"recall@10": 3.0 + r, "ndcg@10": 1.25 * (r + 1),
                           "mae": (4.0 + r, 10.0 + r), "rmse": (9.0 + 2 * r, 10.0 + r, "sqrt")},
                "shared": {"Entropy@10": 50.0 + 7 * r}}
    return sections, np.asarray([5.0 + r, 2.0 * r]), 12 + rank


def run(rank, world, port, out):
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh()

    def save(case, obj):
        torch.save(obj, os.path.join(out, f"{case}.{rank}.pt"))

    # the comm helpers
    t = comm.all_reduce(torch.tensor([rank + 1.0]))
    b = comm.broadcast(torch.tensor([10.0 * rank + 1]), root=1)
    comm.sync_hosts("cases")
    save("comm", {"count": comm.process_count(), "index": comm.process_index(),
                  "broadcast_object": comm.broadcast_object({"from": rank}, root=1),
                  "all_gather_objects": comm.all_gather_objects(("r", rank)),
                  "all_reduce": t, "broadcast": b,
                  "all_gather": comm.all_gather(torch.arange(3.0) + rank)})

    # the differentiable all-gather
    x = torch.randn(5, D, generator=gen(300 + rank)).requires_grad_(True)
    y = comm.all_gather_rows(x)
    w = torch.randn(y.shape, generator=gen(400 + rank))
    (w * y).sum().backward()
    save("gather_rows", {"y": y.detach(), "grad": x.grad})

    # the cross-rank dedup of the unique-id blocks
    ids = torch.stack(comm.all_gather(id_block(rank)))
    grads = torch.stack(comm.all_gather(row_grads(rank)))
    ids_u, g_u = dedup_touched_rows(ids, grads)
    save("dedup", {"ids": ids_u, "grads": g_u})

    # the row-sharded table: lookup, fetched rows, row update, scores, the
    # host assembly
    shard = RowShard(N_ROWS, mesh)
    emb = ItemEmbed(N_ROWS, D, shard)
    with torch.no_grad():
        emb.weight.copy_(shard.block(full_table()))
    looked = emb(id_block(rank).clamp(min=0).view(3, 4))
    # chunks inside one block and straddling both
    chunks = {(a, b): emb.rows(a, b) for a, b in ((0, 5), (15, 25), (19, 37), (36, 37))}
    m = torch.zeros_like(emb.weight)
    v = torch.zeros_like(emb.weight)
    for step in range(2):
        with torch.no_grad():
            sparse_adamw_row_update(emb.weight, m, v, shard.local_ids(ids_u), g_u * (step + 1),
                                    1e-2, step, ADAM)
    heads = cosine_normalize(torch.randn(4, 3, D, generator=gen(9)))
    scores = heads @ cosine_normalize(emb.rows(0, N_ROWS)).t()
    save("shard", {"lookup": looked, "block_rows": emb.weight.shape[0],
                   "table": emb.rows(0, N_ROWS), "m": shard.fetch(m, 0, N_ROWS),
                   "v": shard.fetch(v, 0, N_ROWS), "scores": scores, "chunks": chunks,
                   "host": shard.gather_to_host(emb.weight, 7),
                   "traffic": {k: comm.traffic[k] for k in ("table_chunk", "table_save")}})

    # the one-collective metric reduce
    from mhrec_tpu_torch.trainer.trainer import Trainer

    ns = SimpleNamespace(config={"metric_decimal_place": 7, "int_to_category": {0: "a"}},
                         mesh=mesh, device=torch.device("cpu"))
    ns._reduce_sums = lambda values: Trainer._reduce_sums(ns, values)
    sections, switch, n = metric_sections(rank)
    save("metrics", Trainer._normalize_all(ns, sections, 240.0, switch, n))

    # ZeRO-2 optimizer state: steps, the gathered state, a reload
    model = zero_model()
    opt = ZeroShardedOptimizer(zero_groups(model), make_adamw, mesh)
    for step in range(ZERO_STEPS):
        zero_grads(model, step)
        opt.step()
    state = opt.state_dict()
    model2 = zero_model()
    opt2 = ZeroShardedOptimizer(zero_groups(model2), make_adamw, mesh)
    opt2.load_state_dict(copy.deepcopy(state))  # a loaded optimizer shares the 0-d steps
    with torch.no_grad():
        for p, q in zip(model2.parameters(), model.parameters()):
            p.copy_(q)
    zero_grads(model2, ZERO_STEPS)
    opt2.step()
    save("zero", {"params": [p.detach() for p in model.parameters()], "state": state,
                  "owned": sum(p.numel() for g in opt.param_groups for p in g["params"]),
                  "after_reload": [p.detach() for p in model2.parameters()]})

    # one HSTU train step on this rank's rows, the table replicated and sharded
    for shard_table in (False, True):
        t = step_trainer(shard_table)
        batch = next(t.batcher(rank, world).epoch_batches(0))
        out_ = t.train_step(batch)
        save(f"step_shard{int(shard_table)}", {
            "loss": float(out_["loss"]),
            "grads": {n: p.grad.clone() for n, p in t.model.named_parameters()
                      if p.grad is not None},
            "table_m": whole(t, t.table_m), "checksum": t.param_checksum()})
    comm.sync_hosts("done")


def whole(trainer, x):
    """A table-shaped tensor of ``trainer`` whole on this rank (fetched
    from every rank's block when the table is sharded)."""
    shard = trainer.item_table().shard
    return x if shard is None else shard.fetch(x, 0, shard.num_rows)


# the tiny HSTU of the train-step case (tests/test_multiprocess.py's shape)
STEP_OVERRIDES = dict(
    seed=0, MAX_ITEM_LIST_LENGTH=12, train_batch_size=16, eval_batch_size=16,
    num_negatives=64, n_layers=2, n_heads=2, item_embedding_size=32, hstu_embedding_size=32,
    eval_pred_len=2, pred_len=2, topk=[5, 10], loss="prior", eval_num_cats=4,
    num_prior_head=4, num_segment_head=1, medusa_num_layers=1, prior_switch="in",
    prior_switch_loss_weight=0.1, use_prior_switch_test=True, sparse_item_adam=True,
    hidden_dropout_prob=0.1, compute_dtype="float32", show_progress=False,
    use_native_sampler=False, int_to_category={c: f"cat_{c}" for c in range(4)},
    optim_args={"learning_rate": 1e-4, "weight_decay": 0.01})


def step_data():
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

    return InMemoryInteractionData(num_users=60, num_items=300, seq_len=30, num_categories=4,
                                   eval_pred_len=2, max_item_list_length=12, seed=1)


def step_trainer(shard_table=False, device="cpu", **over):
    """A Trainer on ``device`` over ``step_data()`` (``batcher(h, n)``: host
    h of n's train batcher)."""
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data.trainset import SEQTrainBatcher
    from mhrec_tpu_torch.trainer import Trainer

    cfg = Config(config_file_list=["IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"],
                 config_dict=dict(STEP_OVERRIDES, shard_item_embedding=shard_table,
                                  checkpoint_dir=os.environ.get("TMPDIR", "/tmp"), **over)
                 ).finalize()
    data = step_data()
    t = Trainer(cfg, data, device=device)
    t.setup_model()
    t.batcher = lambda h, n: SEQTrainBatcher(cfg, data, host_id=h, num_hosts=n)
    return t


def run_hllm(rank, world, port, out):
    """The HLLM cases, on the spec of ``{out}/hllm_spec.json``: ``config``
    (the overrides), ``device`` (default the CPU; a card with gloo), the
    in-memory catalog's arguments ``synthetic_data`` (else the config's
    parquet files) and the initialisation ``seed``, and the parameters of
    ``{out}/hllm_init.pt`` where it exists. Saves the negative pool of one
    forward on this rank's first train batch (every gather's output, as
    the model's mesh hands it back) and the corpus table computed on the
    device and gathered in host memory."""
    import json

    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import InteractionData
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
    from mhrec_tpu_torch.parallel.mesh import DataMesh
    from mhrec_tpu_torch.trainer import Trainer

    with open(os.path.join(out, "hllm_spec.json")) as fh:
        spec = json.load(fh)
    dev = init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=spec.get("device", "cpu"))
    cfg = Config(config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"],
                 config_dict=spec["config"]).finalize()
    data = (InMemoryInteractionData(**spec["synthetic_data"]) if "synthetic_data" in spec
            else InteractionData(cfg).build())
    t = Trainer(cfg, data, device=dev)
    t.setup_model(seed=spec.get("seed"))
    init = os.path.join(out, "hllm_init.pt")
    if os.path.exists(init):
        t.model.load_state_dict(torch.load(init))
    pools = []

    class Recorded(DataMesh):
        def all_gather_rows(self, x, tag):
            pools.append(super().all_gather_rows(x, tag).detach().clone())
            return pools[-1]

    t.model.mesh = Recorded(rank, world)
    batch = next(TextSEQTrainBatcher(cfg, data, host_id=rank, num_hosts=world)
                 .epoch_batches(0))
    with torch.no_grad():
        t.model(t._train_device_batch(batch), generator=t.step_generator(0))
    table = t.compute_item_feature()
    host = t.compute_item_feature(return_host=True)
    torch.save({"pools": [p.cpu() for p in pools], "table": table.cpu(), "host_table": host,
                "corpus_batch": t._corpus_batcher.batch_size,
                "traffic": dict(comm.traffic)}, os.path.join(out, f"hllm.{rank}.pt"))
    comm.sync_hosts("done")


class WholeTableWatch(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every tensor that an operation produces with ``rows`` rows
    of one of the ``widths`` (a whole item table, raw or projected), as
    (phase, operation, shape, device); ``phase`` names the code running."""

    def __init__(self, rows, widths):
        super().__init__()
        self.rows, self.widths = rows, set(widths)
        self.phase = "init"
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[0] == self.rows
                    and t.shape[1] in self.widths):
                self.hits.append((self.phase, str(func), tuple(t.shape), t.device.type))
        return out


def run_table(rank, world, port, out):
    """One rank of the row-sharded table's run, on the spec of
    ``{out}/spec.json`` (``config``: the overrides; ``init_dir``: a
    checkpoint directory of the initial weights): under a
    ``WholeTableWatch``, the trainer's build and initialisation, then
    (after the initial weights are loaded, outside the watch) ``fit`` with
    its evaluation and save, and the test split; then a second trainer of
    the same config loads the written checkpoint. Saves the rank's record
    to ``{out}/rank{rank}.pt``."""
    import json

    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import InteractionData, build_dataloader
    from mhrec_tpu_torch.trainer import Trainer

    with open(os.path.join(out, "spec.json")) as fh:
        spec = json.load(fh)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu")
    cfg = Config(config_file_list=["IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"],
                 config_dict=spec["config"]).finalize()
    data = InteractionData(cfg).build()
    watch = WholeTableWatch(data.item_num, (cfg["item_embedding_size"],
                                            cfg["hstu_embedding_size"]))
    with watch:
        t = Trainer(cfg, data, device="cpu")
        t.setup_model()
    drawn = t.item_table().weight.detach().clone()
    own_dir = t.saved_model_dir
    t.saved_model_dir = spec["init_dir"]
    assert t.load_checkpoint() and t.step == 0
    t.saved_model_dir = own_dir
    save_checkpoint = t.save_checkpoint

    def watched_save():
        watch.phase = "save"
        save_checkpoint()
        watch.phase = "fit"

    t.save_checkpoint = watched_save
    train, valid, test = build_dataloader(cfg, data, rank, world)
    comm.traffic.clear()
    with watch:
        watch.phase = "fit"
        stats = t.fit(train, valid)
        watch.phase = "test"
        result = t.evaluate(test, load_best_model=False)
    traffic = dict(comm.traffic)
    emb = t.item_table()
    rec = {"drawn": drawn, "hits": watch.hits, "losses": t.fetched_losses,
           "final_loss": float(stats["loss"]), "result": result,
           "checksum": t.param_checksum(), "block": emb.weight.detach().clone(),
           "m": t.table_m.clone(), "v": t.table_v.clone(), "traffic": traffic,
           "checkpoint": t.checkpoint_path(), "block_rows": emb.weight.shape[0]}
    # the written checkpoint, loaded by a trainer of the same config
    t2 = Trainer(cfg, data, device="cpu")
    t2.setup_model(seed=99)
    t2.saved_model_dir = own_dir
    assert t2.load_checkpoint()
    rec["loaded"] = {"block": t2.item_table().weight.detach().clone(), "m": t2.table_m.clone(),
                     "v": t2.table_v.clone(), "checksum": t2.param_checksum()}
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))
    comm.sync_hosts("done")


def fsdp_tower(device, remat):
    """A two-layer float32 llama tower of 64 wide (and its token table),
    drawn from a fixed seed on ``device``."""
    from mhrec_tpu_torch.models.llm.config import LLMConfig
    from mhrec_tpu_torch.models.llm.llama import LlamaBackbone

    cfg = LLMConfig(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2)
    with torch.device(device):
        m = LlamaBackbone(cfg, dtype=torch.float32, gradient_checkpointing=remat)
    m.init_parameters(torch.Generator(device=device).manual_seed(5))
    return m


def run_fsdp(rank, world, port, out, device):
    """FSDP's two collectives on ``device`` tensors, and the tower of
    ``fsdp_tower`` with its parameters of 1,024 or more elements sharded
    (with and without gradient checkpointing): this rank's rows of a batch
    forward and backward, against the replicated tower on the same rows
    with the gradients of the sharded parameters all-reduced. Saves the
    collectives' results, the outputs and the gradients beside the
    replicated tower's (a block of the sharded ones)."""
    from mhrec_tpu_torch.parallel.fsdp import shard_model

    dev = init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device=device)
    mesh = make_mesh()
    rec = {"backend": torch.distributed.get_backend(),
           "reduce_scatter": comm.reduce_scatter(
               torch.arange(6.0, device=dev) + 10 * rank, "fsdp_reduce_scatter").cpu(),
           "all_gather_flat": comm.all_gather_flat(
               torch.arange(3.0, device=dev) + 10 * rank, "fsdp_gather").cpu()}
    ids = torch.randint(0, 96, (2 * world, 8), generator=gen(11)).to(dev)[2 * rank:2 * rank + 2]
    for remat in (False, True):
        ref, m = fsdp_tower(dev, remat), fsdp_tower(dev, remat)
        fsdp = shard_model(m, mesh, 1024)
        y_ref = ref(input_ids=ids)
        y_ref.square().sum().backward()
        y = m(input_ids=ids)
        y.square().sum().backward()
        want = {}
        for name, p in ref.named_parameters():
            # a block's gradient is summed over the ranks, a replicated
            # parameter's stays the rank's (the trainer all-reduces those)
            want[name] = (fsdp.block_of(fsdp.entries[name],
                                        comm.all_reduce(p.grad.clone(), "grad_all_reduce"))
                          if name in fsdp.entries else p.grad)
        rec[f"remat{int(remat)}"] = {
            "out": y.detach().cpu(), "out_ref": y_ref.detach().cpu(),
            "sharded": sorted(fsdp.entries), "live_whole": fsdp.live_whole(),
            "grads": {n: p.grad.cpu() for n, p in m.named_parameters()},
            "want": {n: g.cpu() for n, g in want.items()}}
    rec["traffic"] = dict(comm.traffic)
    torch.save(rec, os.path.join(out, f"fsdp.{rank}.pt"))
    comm.sync_hosts("done")


def fsdp_worker_ranks(tmp_path, device):
    """Two ranks of ``tests/torch_parallel_worker.py fsdp`` on ``device``
    (gloo); returns their records."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(root, "tests",
                                                            "torch_parallel_worker.py"),
                               "fsdp", str(r), "2", str(port), str(tmp_path), device],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:] + logs[1][-3000:]
    return [torch.load(tmp_path / f"fsdp.{r}.pt") for r in range(2)]


def check_fsdp_worker(ranks):
    """The collectives' values, and the sharded tower's outputs and
    gradients bit-equal to the replicated tower's (a sharded parameter's
    all-reduced and cut to the block), with and without gradient
    checkpointing, and no whole parameter or gradient left alive."""
    for r, rec in enumerate(ranks):
        assert rec["backend"] == "gloo"
        assert torch.equal(rec["reduce_scatter"], torch.arange(3.0) * 2 + 10 + 6 * r)
        assert torch.equal(rec["all_gather_flat"], torch.tensor([0., 1, 2, 10, 11, 12]))
        for key in ("remat0", "remat1"):
            run = rec[key]
            assert torch.equal(run["out"], run["out_ref"]), key
            assert len(run["sharded"]) == 15 and run["live_whole"] == 0, key
            for name, g in run["want"].items():
                assert torch.equal(run["grads"][name], g), (key, name)
        assert rec["traffic"]["fsdp_gather"] > 0 and rec["traffic"]["fsdp_reduce_scatter"] > 0


if __name__ == "__main__":
    if sys.argv[1] == "hllm":
        rank_, world_, port_, out_ = sys.argv[2:6]
        run_hllm(int(rank_), int(world_), int(port_), out_)
    elif sys.argv[1] == "table":
        rank_, world_, port_, out_ = sys.argv[2:6]
        run_table(int(rank_), int(world_), int(port_), out_)
    elif sys.argv[1] == "fsdp":
        rank_, world_, port_, out_, device_ = sys.argv[2:7]
        run_fsdp(int(rank_), int(world_), int(port_), out_, device_)
    else:
        rank_, world_, port_, out_ = sys.argv[1:5]
        run(int(rank_), int(world_), int(port_), out_)
