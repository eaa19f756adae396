"""CLI entry point (port of ``mhrec_tpu/run.py``, one device). Usage::

    python -m mhrec_tpu_torch.run --config_file IDNet/hstu-size4.yaml \
        overall/ID.yaml IDNet/hstu.yaml -- --loss prior ...

Without ``--val_only`` it trains (``Trainer.fit`` with periodic evaluation
and best-checkpoint saves), then evaluates the test split from the best
checkpoint; ``--val_only True`` only evaluates (reference run.py:136-143).
It runs on the CUDA card unless ``--device`` names another device
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.data import InteractionData, build_dataloader, build_eval_dataloaders
from mhrec_tpu_torch.trainer import Trainer
from mhrec_tpu_torch.utils import init_logger, init_seed, resolve_device

logger = logging.getLogger(__name__)


def serve(config, data, device=None):
    """The ``--val_only`` path after data loading: eval batchers, a Trainer
    with parameters initialised from ``config["seed"]``, and the evaluation
    of the test split. Returns (trainer, test batcher, metric sections)."""
    _, test_loader = build_eval_dataloaders(config, data)
    trainer = Trainer(config, data, device=device)
    trainer.setup_model()
    result = trainer.evaluate(test_loader, load_best_model=True)
    return trainer, test_loader, result


def train(config, data, device=None):
    """The training path after data loading (JAX run.py:82-94): batchers, a
    Trainer with parameters initialised from ``config["seed"]``, ``fit``
    over the train split with evaluation on the valid split, then the test
    split evaluated from the best checkpoint. Returns (trainer, fit
    statistics, metric sections)."""
    train_loader, valid_loader, test_loader = build_dataloader(config, data)
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


def run_loop(config_files, extra_args, device=None):
    config = Config(config_file_list=config_files, cli_args=extra_args).finalize()
    device = resolve_device(device)
    set_matmul_precision(config.get("matmul_precision"))
    init_seed(config["seed"] or 2020, config["reproducibility"])
    init_logger(config)
    logger.info("configuration:\n%s", config.format_categorized())

    logger.info("loading data...")
    data = InteractionData(config).build()
    fit_stats = None
    if config.get("val_only", False):
        trainer, _, result = serve(config, data, device)
    else:
        trainer, fit_stats, result = train(config, data, device)
    for section, metrics in result.items():
        logger.info("%s: %s", section, metrics)
    if config.get("result_json_path"):
        payload = {
            "process_index": 0,
            "result": {k: {m: float(v) for m, v in d.items()} for k, d in result.items()},
            "final_loss": float(fit_stats.get("loss", float("nan"))) if fit_stats else None,
            "param_checksum": float(sum(p.detach().abs().float().sum()
                                        for p in trainer.model.parameters())),
        }
        with open(f"{config['result_json_path']}.0.json", "w") as f:
            json.dump(payload, f)
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", nargs="+", required=True)
    parser.add_argument("--device", default=None,
                        help="device to run on (default: the CUDA card)")
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    return run_loop(args.config_file, extra, device=args.device)


if __name__ == "__main__":
    main()
