"""CLI entry point (port of ``mhrec_tpu/run.py``). Usage::

    python -m mhrec_tpu_torch.run --config_file IDNet/hstu-size4.yaml \
        overall/ID.yaml IDNet/hstu.yaml -- --loss prior ...

Without ``--val_only`` it trains (``Trainer.fit`` with periodic evaluation
and best-checkpoint saves), then evaluates the test split from the best
checkpoint; ``--val_only True`` only evaluates (reference run.py:136-143).
It runs on the CUDA card unless ``--device`` names another device
(``--device cpu``).

Data parallelism over W processes (every model: HSTU, HLLM and the five
baselines): ``--multihost`` joins
a ``torch.distributed`` group, one process per rank, NCCL on the card (card
``local_rank % device_count``) and gloo with ``--device cpu``::

    python -m mhrec_tpu_torch.run --multihost --coordinator_address 127.0.0.1:29500 \
        --num_processes 2 --process_id 0 \
        --config_file overall/LLM.yaml HLLM/HLLM.yaml -- --device cpu ...

(one command per rank), or under ``torchrun --nproc_per_node W -m
mhrec_tpu_torch.run --multihost ...``, which sets the address, the world
size and the ranks. ``train_batch_size`` and ``eval_batch_size`` are
global and must divide by W; each rank builds its share of every batch
(for HLLM the texts of its rows' items, and its share of every corpus
batch). Under ``shard_item_embedding`` an HSTU's item table is split over
the ranks by rows and no rank holds it whole. HLLM refuses ``dedup_items``, a packed item tower without
``pack_chunk`` and ``packed_corpus_pass`` over several ranks, as the JAX
package does. With ``result_json_path`` every rank writes
``{result_json_path}.{rank}.json``: the metrics, each read loss, the
parameter checksum, the kernels' launches, the bytes of each
collective and of the state a rank keeps between steps.

FSDP / ZeRO-3 (``--fsdp True`` or ``--zero_stage 3``, ``--fsdp_min_size``)
shards the large parameters over the ranks of such a group
(``parallel/fsdp.py``); at one rank it changes nothing.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.data import InteractionData, build_dataloader, build_eval_dataloaders
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.ops import launch_counts
from mhrec_tpu_torch.parallel import comm, init_distributed
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.utils import init_logger, init_seed, resolve_device

logger = logging.getLogger(__name__)


def serve(config, data, device=None):
    """The ``--val_only`` path after data loading: eval batchers, a Trainer
    with parameters initialised from ``config["seed"]``, and the evaluation
    of the test split. Returns (trainer, test batcher, metric sections).
    In a process group, this rank's share of the users."""
    _, test_loader = build_eval_dataloaders(config, data, comm.process_index(),
                                            comm.process_count())
    trainer = Trainer(config, data, device=device)
    trainer.setup_model()
    result = trainer.evaluate(test_loader, load_best_model=True)
    return trainer, test_loader, result


def train(config, data, device=None):
    """The training path after data loading (JAX run.py:82-94): batchers, a
    Trainer with parameters initialised from ``config["seed"]``, ``fit``
    over the train split with evaluation on the valid split, then the test
    split evaluated from the best checkpoint. Returns (trainer, fit
    statistics, metric sections). In a process group, this rank's share
    of every batch."""
    train_loader, valid_loader, test_loader = build_dataloader(
        config, data, comm.process_index(), comm.process_count())
    trainer = Trainer(config, data, device=device)
    trainer.setup_model()
    fit_stats = trainer.fit(train_loader, valid_loader)
    result = trainer.evaluate(test_loader, load_best_model=True)
    return trainer, fit_stats, result


# ``matmul_precision`` (JAX run.py:51-58, ``jax_default_matmul_precision``)
# → torch's float32 matmul precision: full float32, TF32 or bf16 passes
MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                    "tensorfloat32": "high", "bfloat16": "medium"}


def set_matmul_precision(value) -> None:
    """Apply the config's ``matmul_precision`` to float32 products. Unset:
    full float32, TF32 off, as the reference's scores need (TF32 keeps
    about three decimal digits). An unknown value raises."""
    name = str(value).lower() if value else "highest"
    if name not in MATMUL_PRECISION:
        raise ValueError(f"matmul_precision must be one of {sorted(MATMUL_PRECISION)}, "
                         f"got {value!r}")
    # one API only: torch refuses to report a precision set through both it
    # and the older allow_tf32 flag
    torch.set_float32_matmul_precision(MATMUL_PRECISION[name])
    torch.backends.cudnn.allow_tf32 = MATMUL_PRECISION[name] != "highest"


def load_data(config):
    """The interaction data the config names: the parquet files under
    ``data_path``, or with ``synthetic_data`` (a dict of
    ``InMemoryInteractionData``'s arguments) a catalog made in memory from
    its seed, which needs no pandas (a smoke run on a machine without it)."""
    if not config.get("synthetic_data"):
        return InteractionData(config).build()
    data = InMemoryInteractionData(**config["synthetic_data"])
    if data.category_to_int:
        config["int_to_category"] = {v: k for k, v in data.category_to_int.items()}
    return data


def run_loop(config_files, extra_args, device=None, multihost: bool = False,
             coordinator_address=None, num_processes=None, process_id=None):
    """Train or serve as the config says; with ``multihost`` as one rank of
    a process group (joined here unless the caller already has one, which
    is then used as it is, its backend too). Returns the metric sections."""
    own_group = multihost and not comm.initialized()
    if own_group:
        device = init_distributed(coordinator_address, num_processes, process_id,
                                  device=device)
    try:
        return _run(config_files, extra_args, device)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _run(config_files, extra_args, device):
    config = Config(config_file_list=config_files, cli_args=extra_args).finalize()
    device = resolve_device(device)
    set_matmul_precision(config.get("matmul_precision"))
    # every rank seeds alike, as the JAX package does; the batchers' host
    # draws add the rank (trainset.py:278-280)
    init_seed(config["seed"] or 2020, config["reproducibility"])
    rank, world = comm.process_index(), comm.process_count()
    init_logger(config, process_index=rank)  # only rank 0 logs below WARNING
    logger.info("configuration:\n%s", config.format_categorized())
    for key in ("train_batch_size", "eval_batch_size"):
        if config[key] and config[key] % world:
            raise ValueError(f"{key}={config[key]} is GLOBAL and must divide by the "
                             f"world size {world}")

    logger.info("loading data...")
    data = load_data(config)
    fit_stats = None
    if config.get("val_only", False):
        trainer, _, result = serve(config, data, device)
    else:
        trainer, fit_stats, result = train(config, data, device)
    for section, metrics in result.items():
        logger.info("%s: %s", section, metrics)
    if config.get("result_json_path"):
        # the run's summary, one file a rank: the metrics, the loss of every
        # step the host read, a checksum of the parameters (equal on every
        # rank), the steady rate, the kernels' launches and the bytes of
        # each collective
        payload = {
            "process_index": rank,
            "result": {k: {m: float(v) for m, v in d.items()} for k, d in result.items()},
            "final_loss": float(fit_stats.get("loss", float("nan"))) if fit_stats else None,
            "losses": trainer.fetched_losses,
            "param_checksum": trainer.param_checksum(),
            "steady_examples_per_s": fit_stats["steady_examples_per_s"] if fit_stats else None,
            "launches": launch_counts(),
            "collective_bytes": dict(comm.traffic),
            "persistent_bytes": (fit_stats["persistent_bytes"] if fit_stats
                                 else trainer.persistent_bytes()),
            # the state kept between steps (at the end of the fit); FSDP:
            # each sharded parameter's elements and its block's, and the
            # most whole ones alive after a step
            "fsdp_params": ({n: [e.numel, e.n] for n, e in trainer.fsdp.entries.items()}
                            if trainer.fsdp is not None else {}),
            "fsdp_live_whole": fit_stats["fsdp_live_whole"] if fit_stats else None,
        }
        if trainer.device.type == "cuda":
            payload["peak_mem_gb"] = torch.cuda.max_memory_allocated(trainer.device) / 2**30
        with open(f"{config['result_json_path']}.{rank}.json", "w") as f:
            json.dump(payload, f)
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", nargs="+", required=True)
    parser.add_argument("--device", default=None,
                        help="device to run on (default: the CUDA card)")
    parser.add_argument("--multihost", action="store_true",
                        help="run as one rank of a torch.distributed process group "
                             "(data parallelism of any model)")
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of the group's store (default: torchrun's "
                             "MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="world size (default: torchrun's WORLD_SIZE)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (default: torchrun's RANK)")
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    if args.device is None and "--device" in extra[:-1]:
        # the device may also come among the config overrides after "--"
        i = extra.index("--device")
        args.device = extra[i + 1]
        del extra[i:i + 2]
    return run_loop(args.config_file, extra, device=args.device, multihost=args.multihost,
                    coordinator_address=args.coordinator_address,
                    num_processes=args.num_processes, process_id=args.process_id)


if __name__ == "__main__":
    main()
