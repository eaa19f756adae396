"""Training and evaluation engine (port of ``mhrec_tpu/trainer/trainer.py``).

* iteration-based ``fit``: ``total_iters × accumulate_grad`` micro-steps over
  an endless batch stream, NaN guard, periodic eval → ``early_stopping`` on
  the valid metric → best-checkpoint save (reference trainer.py:371-373,
  494-687);
* the train step (JAX trainer.py:549-724): under ``sparse_item_adam`` the
  loss is differentiated with respect to the gathered per-batch sub-table,
  the dense parameters take AdamW and the touched item-table rows the
  row-sparse AdamW (kernel ``row_adamw`` on the card); otherwise the whole
  model takes AdamW. The NaN guard stays on the card: a step whose loss is
  NaN has its gradients zeroed and its index recorded in ``nan_step``, and
  the host raises when it next reads the loss (every ``update_interval``
  steps and at the last step);
* gradient accumulation (``accumulate_grad`` k > 1, JAX trainer.py:619-659
  and ``optax.MultiSteps``): the dense gradients' running mean is applied
  once every k micro-steps; under ``sparse_item_adam`` the row update runs
  once per optimizer step on the deduped union of the k micro-steps' rows;
* dropout and the positive-mix draws come from a generator on the device
  seeded from (seed, step), so a resumed run draws what the first run drew;
* checkpoints (``torch.save``): parameters, optimizer state, the item
  table's row moments, step and best score. With ``async_checkpoint`` (the
  default, as in the JAX package) the state is copied to host memory on the
  calling thread and a writer thread saves it (``trainer/checkpoint.py``);
  the next save, ``load_checkpoint`` (of any trainer in the process), the
  end of ``fit`` and interpreter exit wait for it and raise its error.
  Loaded through a memory map to host memory, the optimizer's old state
  dropped first, so a 2B-parameter HLLM (24 GB with its moments) reloads
  without a second copy on the card;
* the evaluation pipeline (trainer.py:698-1152): corpus item embeddings
  (the item table of an ID model; for HLLM the item tower over every
  item's text, dense or packed, trainer.py:953-1054) → per-user-batch head
  embeddings → **streamed** full-corpus cosine scoring
  with pad-item masking and history suppression, per-head top-k merged over
  item chunks on the card → host collector → metrics → sample-count
  normalization. The item table stays on the card; each chunk's
  ``[B, H, chunk]`` score block is the largest object (beside the table
  itself, unless it is row-sharded). Beside the top-k
  merge the chunk loop advances the streamed mean-rank counters (GAUC /
  AUC) and the target scores (the VALUE metrics MAE / RMSE / LogLoss);
  the full ``[B, H, I]`` score tensor (``rec.score``) is the single-process
  oracle of both. A text model's corpus table larger than
  ``item_table_hbm_budget_gb`` stays in host memory (``host_item_table``)
  and streams through the card once per group of eval batches. The eval
  outputs ``log_detailed_results`` (per-user recommendation dumps) and
  ``save_for_eval`` (each batch's top-k and embeddings) are written under
  the checkpoint directory.

* ``item_table_dtype: bfloat16`` (under ``sparse_item_adam``): the item
  table is stored in bfloat16, its moments and the step's gathered rows in
  float32, and the row update takes the plain bf16 formulation with
  stochastic rounding (``item_table_stochastic_round``, default on) from a
  noise stream of its own.

* data parallelism (every model: HSTU, HLLM and the five baselines) in a
  ``torch.distributed`` process group of W ranks (``parallel/``),
  computing what the JAX package computes as one SPMD program over the
  composed global batch: each rank steps on its rows of the global batch
  (``train_batch_size`` is global), the negative pool is all-gathered in
  rank order (for HLLM each rank encodes its own rows' items first), every
  loss mean divides by global counts and every batch-independent term by
  W, random draws cover the global batch (``layers.batch_rows``), the dense
  gradients are SUM-all-reduced before the clip, the NaN guard reads the
  all-reduced loss, and the optimizer state is sharded ZeRO-2 style
  (``shard_optimizer_state``, default on). Under ``sparse_item_adam`` the
  ranks all-gather their unique-id blocks and row gradients and every id
  of the union is updated once (``sparse_adam_global_dedup``, on iff W >
  1). HSTU's ``shard_item_embedding`` keeps only a block of the table's
  rows on each rank (``parallel/mesh.py::RowShard``), from the build on:
  no rank's device ever holds the whole table, the evaluation scores it
  chunk by chunk, each chunk fetched from its owners
  (``ShardedItemFeatures``), and the checkpoint's table and moments are
  assembled in rank 0's host memory. Evaluation strides the users over the
  ranks and SUM-reduces every metric sum in one collective; only rank 0
  writes checkpoints, dumps and eval chunks. HLLM's corpus pass splits
  each corpus batch over the ranks (``shard_identical``) and all-gathers
  the embeddings in rank order. Inside a group every collective runs at W
  = 1 too.

* FSDP / ZeRO-3 (``fsdp: true`` or ``zero_stage: 3``, ``fsdp_min_size``;
  JAX trainer.py:284-330) over W > 1 ranks: every parameter that JAX's
  rule shards is stored as a block a rank (``parallel/fsdp.py``), gathered
  whole for its layer's forward and backward, its gradient
  reduce-scattered in the backward, its moments blocks; the global-norm
  clip sums the blocks' squares over the ranks. Under ``sparse_item_adam``
  HSTU's item table, which JAX's rule shards as a parameter, is the
  row-sharded table. An evaluation gathers every sharded parameter once
  at its start; a save assembles them and their moments in rank 0's host
  memory and writes the one-process layout.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mhrec_tpu_torch.data.textset import BatchTextBatcher
from mhrec_tpu_torch.data.trainset import _prefetch_iterator, unique_id_cap
from mhrec_tpu_torch.evaluator import Collector, Evaluator
from mhrec_tpu_torch.models.factory import build_model
from mhrec_tpu_torch.models.hllm.hllm import batch_image_extra
from mhrec_tpu_torch.models.layers import ItemEmbed, cosine_normalize
from mhrec_tpu_torch.ops import row_adam_cuda
from mhrec_tpu_torch.parallel import comm, fsdp_params, make_mesh, shard_identical
from mhrec_tpu_torch.parallel.fsdp import shard_model
from mhrec_tpu_torch.trainer import checkpoint as ckpt_io
from mhrec_tpu_torch.trainer.lr_schedule import build_schedule
from mhrec_tpu_torch.trainer.optim import (
    ZeroShardedOptimizer,
    all_reduce_grads,
    build_optimizer,
    clip_grad_norm,
)
from mhrec_tpu_torch.trainer.sparse_adam import (
    SparseAdamConfig,
    dedup_touched_rows,
    sparse_adamw_row_update,
)
from mhrec_tpu_torch.utils.misc import calculate_valid_score, early_stopping, resolve_device
from mhrec_tpu_torch.utils.observability import get_tensorboard, save_eval_chunk, save_log_dict
from mhrec_tpu_torch.utils.wandblogger import WandbLogger

logger = logging.getLogger(__name__)


def _tie_keys(x: torch.Tensor, kth: torch.Tensor) -> torch.Tensor:
    """Integer keys whose k largest are ``topk_first``'s picks: n + 1 above
    the k-th value ``kth`` [..., 1], n..1 by position where x equals it, 0
    below. Integers keep neighbouring ranks apart at any length (a float32
    rank merges them past 2^24 positions); int32 while n + 1 fits it."""
    n = x.shape[-1]
    dtype = torch.int32 if n < 2**31 - 1 else torch.int64
    key = (x == kth) * torch.arange(n, 0, -1, device=x.device, dtype=dtype)
    return key.masked_fill_(x > kth, n + 1)


def topk_first(x: torch.Tensor, k: int):
    """Top-k along the last dim, largest first, ties broken by the LOWER
    position — the order ``jax.lax.top_k`` gives. ``torch.topk`` promises no
    tie order on CUDA, and ties are common here: a head the prior switch
    turns off is all −inf. Returns (values, positions)."""
    kth = torch.topk(x, k, dim=-1).values.min(dim=-1, keepdim=True).values
    # every entry above the k-th value is in; the rest of the k slots go to
    # the lowest positions holding the k-th value
    sel = torch.topk(_tie_keys(x, kth), k, dim=-1, sorted=False).indices.sort(dim=-1).values
    vals = torch.gather(x, -1, sel)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(sel, -1, order)


class ShardedItemFeatures:
    """The scoring features of a row-sharded item table (HSTU under
    ``shard_item_embedding``), made a chunk at a time and never whole:
    ``feats[a:b]`` fetches rows [a, b) from the ranks that own them and
    projects and normalizes them (``compute_item_rows``), ``feats[ids]``
    looks up the rows of a tensor of ids; both are collectives, which every
    rank runs in the same order. ``len(feats)`` is the item count."""

    def __init__(self, model):
        self.model = model

    def __len__(self) -> int:
        return self.model.item_num

    def __getitem__(self, key):
        if isinstance(key, slice):
            a, b, _ = key.indices(len(self))
            return self.model.compute_item_rows(a, b)
        return self.model.item_features(self.model.item_embedding(key))


class Trainer:
    def __init__(self, config, dataload, device=None, dtype=None):
        """``device``: None for the card (raises if there is none), or an
        explicit device such as "cpu". ``dtype``: the trunk's compute type
        (None: the config's ``compute_dtype`` if set, else the model's
        default, bfloat16 for HSTU and ``precision`` for HLLM)."""
        self.config = config
        self.dataload = dataload
        self.device = resolve_device(device)
        if dtype is None and config.get("compute_dtype"):
            names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
            if config["compute_dtype"] not in names:
                raise ValueError(f"compute_dtype must be one of {sorted(names)}, "
                                 f"got {config['compute_dtype']!r}")
            dtype = names[config["compute_dtype"]]
        # the data-parallel group: every collective runs inside one, at one
        # rank too
        self.mesh = make_mesh() if comm.initialized() else None
        self.rank, self.world = (self.mesh.rank, self.mesh.world) if self.mesh else (0, 1)
        self.sparse_item_adam = bool(config.get("sparse_item_adam", False))
        # FSDP / ZeRO-3: JAX's keys and defaults (trainer.py:290-294); set up
        # in setup_model, once the parameters hold their initial values
        self.use_fsdp = bool(config.get("fsdp", False)) or int(config.get("zero_stage") or 2) >= 3
        self.fsdp_min_size = int(config.get("fsdp_min_size", 1 << 20) or (1 << 20))
        self.fsdp = None
        fsdp_on = self.use_fsdp and self.world > 1
        is_hstu = str(config["model"] or "HSTU") == "HSTU"
        # the row-sharded table of HSTU (JAX reads the key in hstu_from_config
        # alone, hstu.py:669)
        self.shard_table = bool(config.get("shard_item_embedding", False)) and is_hstu
        if self.shard_table and not self.sparse_item_adam:
            if not fsdp_on:
                raise NotImplementedError(
                    "shard_item_embedding needs sparse_item_adam: the sharded table is "
                    "trained by the row update on the deduped union")
            # a dense table is a parameter like any other: FSDP's rule shards it
            self.shard_table = config["shard_item_embedding"] = False
        if fsdp_on and self.sparse_item_adam and self._fsdp_shards_table(dataload):
            # JAX's rule shards the table, a parameter there (trainer.py:76,
            # 318-324); here it is the row-sharded table, which no rank holds
            # whole either
            if not is_hstu:
                raise NotImplementedError(
                    f"fsdp shards the item table of {config['model']} under sparse_item_adam "
                    "(JAX's fsdp_min_size rule), and only HSTU's table can be row-sharded: "
                    "raise fsdp_min_size above the table's size or turn sparse_item_adam off")
            self.shard_table = config["shard_item_embedding"] = True
        # parameters are made on the device: a 1B-parameter tower never
        # passes through host memory, and a sharded table is made at its
        # block's size
        with self.device:
            self.model = build_model(config, dataload, dtype=dtype, mesh=self.mesh).to(
                self.device)
        self.model.eval()
        if self.mesh is not None and hasattr(self.model, "mesh"):
            self.model.mesh = self.mesh
        self.collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.eval_pred_len = config["eval_pred_len"]
        self.metrics_pred_len_list = config["metrics_pred_len_list"]
        self.suppress_history = config.get("suppress_history", True)
        self.item_chunk_size = int(config.get("eval_item_chunk_size", 131072))
        self.results_rows: list = []
        self._corpus_batcher = None  # HLLM: the corpus text batcher, kept across evals
        self.host_table_stats: Dict[str, Any] = {}  # the last host-table evaluation's
        self._warned_no_pandas = False

        optim_args = dict(config["optim_args"] or {})
        self.learning_rate = float(optim_args.get("learning_rate", 1e-3))
        self.weight_decay = float(optim_args.get("weight_decay", 0.0))
        self.total_iters = int(config["total_iters"] or 1000)
        self.accumulate_grad = int(config["accumulate_grad"] or 1)
        self.eval_interval = int(config["eval_interval"] or self.total_iters)
        self.stopping_step = int(config["stopping_step"] or 10)
        self.valid_metric = config["valid_metric"]
        self.valid_metric_bigger = bool(config["valid_metric_bigger"])
        self.debug = bool(config.get("debug", False))
        if self.sparse_item_adam and str(config["model"]) == "HLLM":
            raise ValueError(
                "sparse_item_adam applies to ID-embedding models — the HLLM item "
                "tower is an LLM, not an embedding table")
        table_dtype = str(config.get("item_table_dtype") or "float32").lower()
        if table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"item_table_dtype must be float32|bfloat16, got {table_dtype}")
        self.item_table_dtype = torch.bfloat16 if table_dtype == "bfloat16" else torch.float32
        if self.item_table_dtype == torch.bfloat16 and not self.sparse_item_adam:
            raise ValueError(
                "item_table_dtype=bfloat16 requires sparse_item_adam (the dense AdamW "
                "would accumulate updates in bf16 and stall below ulp/2)")
        # stochastic rounding of the bf16 table's row write-back (default on)
        self.table_sr = bool(config.get("item_table_stochastic_round", True))
        # the unique-id blocks of several ranks (or of a composed batch) may
        # share rows: each id of their union is updated once, its gradients
        # summed ('auto': on iff W > 1, JAX trainer.py:166-169)
        sd = config.get("sparse_adam_global_dedup")
        self.sparse_dedup = self.world > 1 if sd in (None, "auto") else bool(sd)
        if self.world > 1 and self.sparse_item_adam and not self.sparse_dedup:
            raise ValueError("sparse_adam_global_dedup must stay on with more than one rank: "
                             "a row in two ranks' blocks would be stepped twice")
        # ZeRO-2 optimizer state over the ranks (JAX trainer.py:341-350)
        self.shard_opt = self.world > 1 and bool(config.get("shard_optimizer_state", True))
        # the row update runs the kernel (on the card) unless 'xla' asks for
        # the plain version; the JAX package's default is 'xla', chosen from
        # TPU timings that do not carry over
        self.sparse_adam_impl = str(config.get("sparse_adam_impl") or "auto")
        self.schedule = build_schedule(config["scheduler_args"], self.learning_rate,
                                       self.total_iters)
        self.update_interval = int(config.get("update_interval") or 20)
        sp = config.get("show_progress")
        self.show_progress = True if sp is None else bool(sp)
        self.loss_decimal_place = int(config.get("loss_decimal_place") or 4)
        self.seed = int(config["seed"] or 0)
        run_name = str(config["model"])
        if config.get("dataset"):
            run_name += f"-{config['dataset']}"
        if config.get("save_model_note"):
            run_name += f"-{config['save_model_note']}"
        self.saved_model_dir = os.path.abspath(
            os.path.join(config["checkpoint_dir"] or "./saved", run_name, "ckpt"))

        self.optimizer = None
        self.group_schedules: list = []
        self.dense_params: list = []
        self.table_m = self.table_v = None
        # accumulate_grad > 1 under sparse_item_adam: each micro-step's
        # unique ids [k, U] and gradient rows [k, U, D]
        self.acc_ids = self.acc_g = None
        self.step = 0  # micro-steps
        self.fetched_losses: list = []
        self.nan_step = torch.tensor(-1, dtype=torch.long, device=self.device)
        self.best_valid_score: Optional[float] = None
        self.best_valid_result = None
        # the last checkpoint save and load: bytes, the writer's seconds
        # (save_s), the seconds the caller was blocked (blocked_s), the host
        # copy's bytes (asynchronous saves), the load's seconds
        self.checkpoint_stats: Dict[str, float] = {}
        self.async_checkpoint = bool(config.get("async_checkpoint", True))
        # the scalar sinks (JAX trainer.py:205, 1240-1247), on rank 0: wandb
        # under log_wandb, a tensorboardX writer wherever tensorboardX imports
        self.wandblogger = WandbLogger(config, enabled=bool(config["log_wandb"])
                                       and self.rank == 0)
        self._tb = None

    def _fsdp_shards_table(self, dataload) -> bool:
        """Whether FSDP's rule picks the item table of an ID model (its
        rows by ``item_embedding_size``)."""
        D = self.config.get("item_embedding_size")
        if not D or str(self.config["model"]) == "HLLM":
            return False
        table = torch.empty((int(dataload.item_num), int(D)), device="meta")
        return bool(fsdp_params([("table", table)], self.world, self.fsdp_min_size))

    # ------------------------------------------------------------------
    def setup_model(self, seed: Optional[int] = None):
        """Random parameter initialisation from ``seed`` (default
        ``config["seed"]``) with an explicit generator on the model's
        device; the optimizer; under ``sparse_item_adam`` the item table's
        dense row moments. Resumes from ``load_checkpoint_name`` or, with
        ``resume: true``, from this run's checkpoint."""
        seed = int(seed if seed is not None else (self.config["seed"] or 0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        # the table is initialised in float32 and then stored in
        # item_table_dtype, as in JAX (trainer.py:353-361)
        # (a sharded table draws only its block's rows, equal to the same
        # rows of the one-process draw: ItemEmbed.trunc_normal_rows)
        self._set_table_dtype(torch.float32)
        self.model.init_parameters(gen)
        self._set_table_dtype(self.item_table_dtype)
        if str(self.config["model"]) == "HLLM":
            from mhrec_tpu_torch.models.hllm.hllm import load_pretrained_towers

            if not self.config.get("dummy_llm", False):
                load_pretrained_towers(self.model, self.config)
            if self.model.freeze_item_llm and self.config.get("all_item_embeds_path"):
                table = np.load(self.config["all_item_embeds_path"])
                self.model.all_item_embeds.copy_(torch.as_tensor(table))
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Trainable parameters: %d", n_params)
        if self.use_fsdp and self.world > 1:
            # the sparse table is the row-sharded one or stays whole
            table_key = self._table_key() if self.sparse_item_adam else None
            self.fsdp = shard_model(self.model, self.mesh, self.fsdp_min_size,
                                    exclude={table_key})
            logger.info("fsdp: %d parameters sharded over %d ranks",
                        0 if self.fsdp is None else len(self.fsdp.entries), self.world)
        self.optimizer, self.group_schedules, frozen = build_optimizer(
            self.config, self.model,
            lambda lr: build_schedule(self.config["scheduler_args"], lr, self.total_iters),
            mesh=self.mesh if self.shard_opt or self.fsdp is not None else None,
            fsdp=self.fsdp, shard_replicated=self.shard_opt)
        for p in frozen:
            p.requires_grad_(False)
        self.dense_params = (self.optimizer.params
                             if isinstance(self.optimizer, ZeroShardedOptimizer)
                             else [p for g in self.optimizer.param_groups for p in g["params"]])
        # FSDP's blocks, whose gradients the backward reduce-scatters, and
        # the replicated parameters, whose gradients are all-reduced
        self.block_params = [p for p in self.dense_params
                             if self.fsdp is not None and self.fsdp.is_block(p)]
        blocks = {id(p) for p in self.block_params}
        self.replicated_params = [p for p in self.dense_params if id(p) not in blocks]
        if self.sparse_item_adam:
            table = self.item_table().weight
            self.table_m = torch.zeros_like(table, dtype=torch.float32)
            self.table_v = torch.zeros_like(table, dtype=torch.float32)
            if self.accumulate_grad > 1:
                # a micro-step's block is every rank's (JAX trainer.py:365-379)
                k = self.accumulate_grad
                U = unique_id_cap(self.config, self.world) * self.world
                self.acc_ids = torch.full((k, U), -1, dtype=torch.long, device=self.device)
                self.acc_g = torch.zeros((k, U, table.shape[1]), dtype=torch.float32,
                                         device=self.device)
        self.step = 0
        self.nan_step.fill_(-1)
        if self.config["load_checkpoint_name"]:
            self.saved_model_dir = os.path.abspath(self.config["load_checkpoint_name"])
            if self.load_checkpoint():
                logger.info("resumed from %s at step %d", self.saved_model_dir, self.step)
        elif self.config.get("resume", False):
            if self.load_checkpoint():
                logger.info("resumed at step %d", self.step)

    def item_table(self):
        """The model's item-embedding table (an ``ItemEmbed``) wherever it
        lives, as the JAX package's ``_find_item_table_path`` finds it: at
        the top for HSTU, SASRec, DualVAE and LLMIDRec, under ``trunk`` for
        ComiRec and REMI; None for a model without one (HLLM). Two tables
        raise."""
        hits = [m for name, m in self.model.named_modules()
                if name.rsplit(".", 1)[-1] == "item_embedding" and isinstance(m, ItemEmbed)]
        if len(hits) > 1:
            raise ValueError(f"the model holds {len(hits)} item_embedding tables; "
                             "sparse_item_adam needs exactly one")
        return hits[0] if hits else None

    def _set_table_dtype(self, dtype):
        """Store an ID model's item table in ``dtype`` (a new parameter)."""
        emb = self.item_table()
        if emb is not None and emb.weight.dtype != dtype:
            emb.weight = torch.nn.Parameter(emb.weight.detach().to(dtype),
                                            requires_grad=emb.weight.requires_grad)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    # the keys of a train batch that index or count (int64 on the device):
    # item ids and masks, and the text train batcher's tokens, lengths,
    # positions and gathers
    _LONG_KEYS = ("items", "neg_items", "pos_neg_items", "masked_index", "unique_ids",
                  "pos_tokens", "pos_token_lens", "neg_tokens", "neg_token_lens",
                  "uniq_tokens", "uniq_token_lens", "uniq_inverse",
                  "packed_tokens", "packed_positions", "emb_slots")
    # the image keys of the item groups (use_image): patches float32, the
    # dynamic maps' validity bool and their positions and gathers int64
    _IMAGE_DTYPES = {"pixel_patches": torch.float32, "patch_valid": torch.bool,
                     "patch_hw": torch.long, "img_src": torch.long, "img_pos": torch.long,
                     "tok_src": torch.long}

    def _image_device_arrays(self, batch, prefix: str) -> Dict[str, torch.Tensor]:
        """The image arrays of one item group (``prefix``: pos, neg, uniq,
        or "" for a corpus batch) on the device."""
        p = f"{prefix}_" if prefix else ""
        return {f"{p}{k}": torch.as_tensor(np.asarray(batch[f"{p}{k}"]), dtype=dt).to(
                    self.device, non_blocking=True)
                for k, dt in self._IMAGE_DTYPES.items() if f"{p}{k}" in batch}

    def _train_device_batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for key in self._LONG_KEYS:
            if key in batch:
                out[key] = torch.as_tensor(np.asarray(batch[key]), dtype=torch.long).to(
                    self.device, non_blocking=True)
        for group in ("pos", "neg", "uniq"):
            out.update(self._image_device_arrays(batch, group))
        if "packed_segment_ids" in batch:
            # the packed attention kernels take contiguous int32 segment ids
            out["packed_segment_ids"] = torch.as_tensor(
                np.ascontiguousarray(batch["packed_segment_ids"], dtype=np.int32)).to(
                    self.device, non_blocking=True)
        tags = np.asarray(batch["tag_categories"])
        if tags.size:
            out["tag_categories"] = torch.as_tensor(tags).to(self.device, non_blocking=True)
        return out

    # the seed of a step's bf16-table rounding noise is the step's seed
    # XOR this 63-bit constant: far from every other step's seed
    _SR_SEED_MASK = 0x2545F4914F6CDD1D

    def step_generator(self, step: int, rounding: bool = False) -> torch.Generator:
        """The generator of a step's dropout masks and mix draws, seeded
        from (seed, step) so a resumed run repeats the stream. ``rounding``:
        the generator of the bf16 table's rounding noise instead, a stream
        of its own, so turning it on shifts no other draw (JAX's
        ``fold_in(rng, 17)``)."""
        seed = (self.seed * 1_000_003 + step) % (2 ** 63)
        if rounding:
            seed ^= self._SR_SEED_MASK
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One micro-step on one batch (numpy dict from the batcher); with
        ``accumulate_grad`` k = 1 each micro-step is an optimizer step.
        Returns the model's output dict (tensors on the device).

        k > 1 keeps the JAX semantics (``optax.MultiSteps`` and trainer.py
        619-659): ``self.step`` counts micro-steps. Between boundaries each
        dense parameter's ``grad`` holds the running mean of the micro-steps'
        gradients in optax's form, acc + (g − acc) / (n + 1); under
        ``sparse_item_adam`` each micro-step's unique ids and gradient rows go
        to slot ``step % k`` of the [k, U] / [k, U, D] buffers. The k-th
        micro-step applies the mean once (clipped, at the schedule of the
        optimizer step ``step // k``), and the item table takes one row update
        on the deduped union of the k blocks, its gradients divided by k, at
        that optimizer step's learning rate and step count. The NaN guard
        zeroes a micro-step's gradients before they are accumulated.

        In a process group the batch is this rank's rows of the global one:
        the returned scalars are the global batch's (one all-reduce), the
        dense gradients are SUM-all-reduced, and under ``sparse_item_adam``
        the ranks' id blocks and row gradients are all-gathered into the
        global block of W·U rows (what the JAX step sees)."""
        k = self.accumulate_grad
        slot = self.step % k
        dev = self._train_device_batch(batch)
        dev["step"] = self.step  # e.g. DualVAE's KL annealing (JAX trainer.py:690)
        gen = self.step_generator(self.step)
        self.model.train()
        acc = [p.grad for p in self.dense_params] if slot else None
        for p in self.dense_params:
            p.grad = None
        out, ids, g_sub = self._forward_backward(dev, gen)
        if self.mesh is not None:
            out = self._global_outputs(out)
        loss = out["loss"]
        # NaN guard on the card: zero this step's gradients and record it
        # (from the global loss, so every rank zeroes the same steps)
        bad = torch.isnan(loss.detach())
        self.nan_step = torch.where((self.nan_step < 0) & bad,
                                    torch.full_like(self.nan_step, self.step), self.nan_step)
        for p in self.dense_params:
            if p.grad is None:  # unused this step: optax still sees a zero gradient
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            all_reduce_grads(self.replicated_params)
        for p in self.dense_params:
            p.grad.masked_fill_(bad, 0.0)
        if slot:
            grads = [p.grad for p in self.dense_params]
            torch._foreach_sub_(grads, acc)
            # a tensor divisor: a Python scalar one is applied as a
            # multiplication by its reciprocal on the card
            torch._foreach_div_(grads, torch.tensor(float(slot + 1), device=self.device))
            torch._foreach_add_(acc, grads)
            for p, a in zip(self.dense_params, acc):
                p.grad = a
        if self.sparse_item_adam:
            g_sub = g_sub.masked_fill_(bad, 0.0)
            if self.world > 1:
                # the global block: every rank's ids and rows, in rank order
                ids = torch.cat(comm.all_gather(ids, "dedup_gather"))
                g_sub = torch.cat(comm.all_gather(g_sub, "dedup_gather"))
            if k > 1:
                self.acc_ids[slot].copy_(ids)
                self.acc_g[slot].copy_(g_sub)
        if slot < k - 1:
            self.step += 1
            return out
        outer = self.step // k
        clip = self.config.get("clip_grad_norm")
        if clip:
            clip_grad_norm(self.dense_params, float(clip), blocks=self.block_params)
        for group, sched in zip(self.optimizer.param_groups, self.group_schedules):
            group["lr"] = sched(outer)
        self.optimizer.step()
        if self.sparse_item_adam:
            D = g_sub.shape[-1]
            if k > 1:
                # the rows divide by k before they are summed, as in JAX (the
                # buffers are rewritten from the next micro-step on); one
                # block per micro-step and rank, each of unique ids
                k_dev = torch.tensor(float(k), device=self.device)
                ids, g_sub = dedup_touched_rows(self.acc_ids.view(k * self.world, -1),
                                                self.acc_g.div_(k_dev).view(k * self.world, -1, D))
            elif self.sparse_dedup:
                # one block per rank; on one process a composed batch's block
                # is taken whole (its ids may repeat across the hosts' parts)
                ids, g_sub = dedup_touched_rows(ids.view(self.world, -1),
                                                g_sub.view(self.world, -1, D))
            emb = self.item_table()
            table = emb.weight
            if emb.shard is not None:
                # each rank updates the rows of the union that it owns
                ids = emb.shard.local_ids(ids)
            cfg = SparseAdamConfig(weight_decay=self.weight_decay)
            with torch.no_grad():
                if table.dtype == torch.bfloat16:
                    # the plain update, because the table is bf16, as JAX
                    # sends bf16 tables to its XLA formulation
                    gen = self.step_generator(self.step, rounding=True) if self.table_sr else None
                    sparse_adamw_row_update(table, self.table_m, self.table_v, ids, g_sub,
                                            self.schedule(outer), outer, cfg, generator=gen)
                else:
                    update = (sparse_adamw_row_update if self.sparse_adam_impl == "xla"
                              else row_adam_cuda.row_adamw)
                    update(table, self.table_m, self.table_v, ids, g_sub,
                           self.schedule(outer), outer, cfg)
        self.step += 1
        return out

    def _forward_backward(self, dev, gen):
        """The micro-step's forward and backward on this rank's rows (the
        device batch ``dev``, ``gen`` its draws): leaves the dense
        parameters' gradients in ``.grad`` and returns the model's outputs
        and, under ``sparse_item_adam``, the step's unique ids and the
        gradient of their float32 rows (else None, None)."""
        if not self.sparse_item_adam:
            out = self.model(dev, generator=gen)
            out["loss"].backward()
            return out, None, None
        ids = dev.pop("unique_ids")
        if self.rank:
            self._local_block_indices(dev, ids.shape[0], self.rank)
        emb = self.item_table()
        # float32 rows whatever the table stores: the step's math is that
        # of a float32 table; a sharded table's rows come from their owners
        rows = emb(ids.clamp(min=0)) if emb.shard is not None else \
            emb.weight.detach()[ids.clamp(min=0)]
        sub0 = rows.float().requires_grad_(True)
        out = self.model(dev, sub=sub0, generator=gen)
        out["loss"].backward()
        return out, ids, sub0.grad

    # the batch keys that index the unique-id block under sparse_item_adam
    _BLOCK_KEYS = ("items", "neg_items", "pos_neg_items")

    @classmethod
    def _local_block_indices(cls, dev, cap: int, rank: int):
        """Indices into the global block (rank ``rank``'s shifted by rank ·
        ``cap``, the batcher's multi-host layout) → indices into that
        rank's own block; 0, the pad item, stays 0."""
        off = rank * cap
        for key in cls._BLOCK_KEYS:
            if key in dev:
                v = dev[key]
                dev[key] = torch.where(v > 0, v - off, v)

    def _global_outputs(self, out):
        """The step's scalars summed over the ranks in one all-reduce: each
        rank's are its share of the global batch's (loss means divide by
        global counts), so the sums are the global batch's values."""
        names = list(out)
        vals = comm.all_reduce(torch.stack([out[n].detach().float().reshape(()) for n in names]),
                               "step_scalars")
        return dict(zip(names, vals.unbind()))

    def fit(self, train_batcher, valid_batcher=None):
        """``total_iters`` optimizer steps of ``accumulate_grad`` micro-steps
        each, with periodic evaluation, early stopping and best-checkpoint
        saves. Returns run statistics (``iters``: micro-steps; the example
        rates count every micro-step's batch) and the last logged scalars."""
        if self.optimizer is None:
            self.setup_model()
        k = self.accumulate_grad
        micro_steps = self.total_iters * k
        if getattr(train_batcher, "num_hosts", self.world) != self.world:
            raise ValueError(f"the train batcher serves {train_batcher.num_hosts} hosts, the "
                             f"process group has {self.world} ranks")
        stream = train_batcher.infinite_batches(prefetch=2)
        stop_flag = False
        cur_step = 0
        t_data = t_step = t_eval = 0.0
        self.fetched_losses = []  # (step, loss) of every step the host read
        # FSDP: the most whole sharded parameters or gradients alive after a step
        self.fsdp_live_whole = 0
        t_steady = None
        it_steady = 0
        t0 = time.time()
        logs: Dict[str, float] = {}
        start_it = self.step  # nonzero after resume
        if start_it:
            logger.info("resuming fit at micro-step %d/%d", start_it, micro_steps)
        it = start_it - 1
        for it in range(start_it, micro_steps):
            td = time.time()
            batch = next(stream)
            t_data += time.time() - td
            ts = time.time()
            out = self.train_step(batch)
            if self.fsdp is not None:
                # a count of weak references: no synchronisation
                self.fsdp_live_whole = max(self.fsdp_live_whole, self.fsdp.live_whole())
            # the first step is fetched too, so the steady clock starts
            # after it; the NaN check fires on the last step as well
            if (it + 1) % self.update_interval == 0 or self.debug or it == start_it \
                    or it == micro_steps - 1:
                loss = float(out["loss"].detach())
                ns = int(self.nan_step)
                if ns >= 0:
                    raise RuntimeError(f"NaN loss at iter {ns}")
                if math.isnan(loss):
                    raise RuntimeError(f"NaN loss at iter {it}")
                logs = {k: float(v.detach()) for k, v in out.items()}
                self.fetched_losses.append((it + 1, loss))
                if (it + 1) % self.update_interval == 0 or self.debug or it == micro_steps - 1:
                    # JAX's steps: its fetches, which skip the first step
                    self._log_scalars(logs, step=it + 1, head="train")
                t_step += time.time() - ts
                if t_steady is None:
                    t_steady, it_steady = time.time(), it + 1
                if self.show_progress:
                    logger.info("iter %d/%d loss=%.*f lr=%.3e data=%.2fs step=%.2fs",
                                it + 1, micro_steps, self.loss_decimal_place, loss,
                                self.schedule(it // k), t_data, t_step)
            else:
                t_step += time.time() - ts
            # evaluation and checkpoints only at accumulation boundaries: the
            # optimizer step has just been applied, so the gradient mean and
            # the row buffers hold nothing that a checkpoint would need
            if valid_batcher is not None and (it + 1) % (self.eval_interval * k) == 0:
                te = time.time()
                result = self.evaluate(valid_batcher, load_best_model=False)
                score = calculate_valid_score(result, self.valid_metric, self.eval_pred_len)
                self.best_valid_score, cur_step, stop_flag, update_flag = early_stopping(
                    score, self.best_valid_score, cur_step, self.stopping_step,
                    bigger=self.valid_metric_bigger)
                logger.info("valid @ step %d: %s=%.6f (best %.6f)", (it + 1) // k,
                            self.valid_metric, score, self.best_valid_score)
                for section, metrics in result.items():
                    self._log_scalars(metrics, step=(it + 1) // k, head=f"valid_{section}")
                if update_flag:
                    self.best_valid_result = result
                    self.save_checkpoint()
                if t_steady is not None:
                    t_eval += time.time() - te
                if stop_flag:
                    logger.info("early stopping at step %d", (it + 1) // k)
                    break
            if self.debug and it >= 9:
                break
        tw = time.time()
        self.wait_for_checkpoint()
        if t_steady is not None:  # the save's tail counts with the evaluations
            t_eval += time.time() - tw
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        n_done = it + 1 - start_it
        batch_size = self.config["train_batch_size"]
        rate = n_done * batch_size / max(wall, 1e-9)
        steady_rate = rate
        if t_steady is not None and it + 1 > it_steady:
            steady_rate = (it + 1 - it_steady) * batch_size / max(
                time.time() - t_steady - t_eval, 1e-9)
        logger.info("fit done: %d steps, %.1fs, %.1f examples/s (%.1f steady: after the "
                    "first step, evaluations left out)", n_done, wall, rate, steady_rate)
        return {"iters": n_done, "wall_s": wall, "examples_per_s": rate,
                "steady_examples_per_s": steady_rate, "eval_s": t_eval,
                "fsdp_live_whole": self.fsdp_live_whole,
                "persistent_bytes": self.persistent_bytes(), **logs}

    def _log_scalars(self, metrics: Dict[str, Any], step: int, head: str):
        """The numbers of ``metrics`` (already on the host) to wandb and to
        TensorBoard as ``{head}/{name}`` at ``step`` (JAX trainer.py:1240-1247),
        on rank 0."""
        if self.rank:
            return
        numeric = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        self.wandblogger.log_metrics(numeric, step=step, head=head)
        if self._tb is None:
            self._tb = get_tensorboard(self.config) or False
        if self._tb:
            for k, v in numeric.items():
                self._tb.add_scalar(f"{head}/{k}", v, step)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def checkpoint_path(self) -> str:
        return os.path.join(self.saved_model_dir, "checkpoint.pt")

    def save_checkpoint(self):
        """Write the run's one checkpoint (the newest replaces the last),
        through a temporary file so a crash never leaves a torn one. Only at
        an accumulation boundary: the gradient mean and row buffers of an
        unfinished optimizer step are not saved. Asynchronous unless
        ``async_checkpoint`` is false: the state is copied to host memory
        here, so training may go on while the writer thread saves it.

        In a process group every rank calls it: the sharded table rows and
        the ZeRO optimizer state are collected first (collectives), and rank
        0 writes them in the one-process layout, which loads at any world
        size. Rank 0 assembles a sharded table and its two moments in host
        memory, a chunk of ``eval_item_chunk_size`` rows at a time; the other
        ranks send their rows and hold nothing of the whole table."""
        if self.step % self.accumulate_grad:
            raise ValueError(f"micro-step {self.step} is not at an accumulation boundary "
                             f"(accumulate_grad {self.accumulate_grad})")
        path = self.checkpoint_path()
        t0 = time.perf_counter()
        ckpt_io.wait_to_replace(path)  # one host copy at a time
        payload = {
            "params": self._whole_state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "best_valid_score": self.best_valid_score,
        }
        if self.table_m is not None:
            payload["table_m"], payload["table_v"] = (
                self._whole_table(t) for t in (self.table_m, self.table_v))
        if self.rank:
            return
        os.makedirs(self.saved_model_dir, exist_ok=True)
        stats = self.checkpoint_stats
        stats.clear()
        if self.async_checkpoint:
            # a sharded table's host assembly is a fresh copy already
            fresh = ([payload["params"][self._table_key()], payload["table_m"],
                      payload["table_v"]] if self.shard_table else [])
            if self.fsdp is not None:
                fresh += [payload["params"][name] for name in self.fsdp.entries]
            payload, stats["host_copy_bytes"] = ckpt_io.host_copy(payload, keep=fresh)
        # the synchronous save goes through the registry too, so it replaces
        # a failed write there and a load waits for it like any other
        ckpt_io.start_write(path, payload, stats)
        if self.async_checkpoint:
            stats.update(blocked_s=time.perf_counter() - t0, asynchronous=True)
            logger.info("checkpoint copied to host memory in %.1fs: %d bytes, being written",
                        stats["blocked_s"], stats["host_copy_bytes"])
            return
        ckpt_io.wait_for_write(path)
        stats.update(blocked_s=time.perf_counter() - t0, asynchronous=False)
        logger.info("checkpoint saved: %d bytes in %.1fs", stats["bytes"], stats["blocked_s"])

    def _table_key(self) -> Optional[str]:
        """The state-dict key of the item table, if the model has one."""
        emb = self.item_table()
        for name, m in self.model.named_modules():
            if emb is not None and m is emb:
                return f"{name}.weight"
        return None

    def _whole_table(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """A table-shaped tensor whole: when the table is sharded, assembled
        from every rank's rows in rank 0's host memory (None on the other
        ranks; a collective)."""
        shard = getattr(self.item_table(), "shard", None)
        return t if shard is None else shard.gather_to_host(t, self.item_chunk_size)

    def _whole_state_dict(self):
        """The model's state dict with the whole item table and the whole
        FSDP parameters (collective when they are sharded: rank 0 holds them
        in host memory, assembled a block at a time, the other ranks
        None)."""
        sd = self.model.state_dict()
        key = self._table_key()
        if key is not None:
            sd[key] = self._whole_table(sd[key])
        if self.fsdp is not None:
            for name, entry in self.fsdp.entries.items():
                sd[name] = self.fsdp.assemble(entry, sd[name])
        return sd

    def param_checksum(self) -> float:
        """The sum of |p| over every parameter, the whole item table
        included; the same on every rank (collective when the table or
        parameters are sharded: the blocks' sums are all-reduced)."""
        emb = self.item_table()
        table = emb.weight if getattr(emb, "shard", None) is not None else None
        split = [p for p in self.model.parameters()
                 if p is table or (self.fsdp is not None and self.fsdp.is_block(p))]
        ids = {id(p) for p in split}
        total = sum(p.detach().abs().float().sum() for p in self.model.parameters()
                    if id(p) not in ids)
        if split:
            total = total + comm.all_reduce(sum(p.detach().abs().float().sum() for p in split),
                                            "checksum")
        return float(total)

    def persistent_bytes(self) -> Dict[str, int]:
        """The bytes of this rank's state between two steps: the dense
        parameters, their gradients and the optimizer's moments; the item
        table under ``sparse_item_adam`` with its row moments (``table``);
        under FSDP the blocks and their moments (``block_params``,
        ``block_moments``), counted in the first three too."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts if t is not None)

        def moments(ps):
            return [v for p in ps for v in self.optimizer.state.get(p, {}).values()
                    if torch.is_tensor(v) and v.dim() > 0]

        table = self.item_table().weight if self.sparse_item_adam else None
        params = [p for p in self.model.parameters() if p is not table]
        out = {"params": nbytes(params), "grads": nbytes(p.grad for p in params),
               "moments": nbytes(moments(params)),
               "table": nbytes([table, self.table_m, self.table_v])}
        if self.fsdp is not None:
            out.update(block_params=nbytes(self.block_params),
                       block_moments=nbytes(moments(self.block_params)))
        return out

    def wait_for_checkpoint(self):
        """Wait for this run's checkpoint write in flight, if any (its error
        is raised here)."""
        ckpt_io.wait_for_write(self.checkpoint_path())

    def load_checkpoint(self) -> bool:
        """Restore the run's checkpoint, after its write in flight (by any
        trainer) has finished; False when there is none. In a process group
        every rank calls it and waits for rank 0's write; a sharded table
        and the ZeRO state take this rank's part of the whole."""
        path = self.checkpoint_path()
        ckpt_io.wait_for_write(path)
        comm.sync_hosts("checkpoint written")
        if not os.path.isfile(path):
            return False
        t0 = time.perf_counter()
        # read to host memory, mapped rather than copied: the copies below
        # move each tensor to its parameter's device, while the optimizer's
        # step counts stay where its policy keeps them (on the host unless
        # fused: on the card they would cost a synchronisation each per step)
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if self.fsdp is not None:
            for name, entry in self.fsdp.entries.items():
                payload["params"][name] = self.fsdp.block_of(entry, payload["params"][name])
        shard = getattr(self.item_table(), "shard", None)
        if shard is not None:
            key = self._table_key()
            payload["params"][key] = shard.block(payload["params"][key])
            for name in ("table_m", "table_v"):
                payload[name] = shard.block(payload[name])
        self.model.load_state_dict(payload["params"])
        # the gradients and moments in memory are dropped before the loaded
        # ones arrive, so the card never holds two sets (the next step makes
        # its gradients anew)
        for p in self.dense_params:
            p.grad = None
        self.optimizer.state.clear()
        self.optimizer.load_state_dict(payload["optimizer"])
        if self.table_m is not None:
            self.table_m.copy_(payload["table_m"])
            self.table_v.copy_(payload["table_v"])
        self.step = int(payload["step"])
        self.best_valid_score = payload["best_valid_score"]
        self.checkpoint_stats["load_s"] = time.perf_counter() - t0
        return True

    # ------------------------------------------------------------------
    @torch.no_grad()
    def compute_item_feature(self, return_host: bool = False):
        """Corpus item embeddings (reference compute_item_feature,
        trainer.py:731-824). ID models: the normalized item table (of a
        sharded table a ``ShardedItemFeatures``, read chunk by chunk). Text
        models: the item tower over the whole corpus in batches of
        ``MAX_ITEM_LIST_LENGTH · train_batch_size`` items, dense or packed
        (``packed_corpus_pass``), the last batch padded to that size → the
        RAW embedding table [item_num, D] float32 (``evaluate`` normalizes a
        copy for scoring, as the reference's predict does). ``return_host``:
        a text model's table is gathered in host memory, batch by batch, and
        never held whole on the card.

        Over W > 1 ranks (JAX trainer.py:966-1054) the batch size is rounded
        up to a multiple of W, each rank encodes rows [r·bs/W, (r+1)·bs/W) of
        every corpus batch (``shard_identical``) and the ranks all-gather
        the embeddings in rank order (counted as ``corpus_gather``), so
        every rank holds the whole table; ``packed_corpus_pass`` raises
        there, as in JAX."""
        if not getattr(self.model, "needs_item_corpus_pass", False):
            if self.shard_table:
                return ShardedItemFeatures(self.model)
            return self.model.compute_item_all()
        if self.model.freeze_item_llm:
            return self.model.all_item_embeds
        mesh = self.mesh if self.world > 1 else None
        if self._corpus_batcher is None:
            bs = None
            if mesh is not None:
                if self.config.get("packed_corpus_pass", False):
                    raise ValueError(
                        "packed_corpus_pass is single-process only; the "
                        "dense corpus pass shards rows across hosts"
                    )
                base = self.config["MAX_ITEM_LIST_LENGTH"] * self.config["train_batch_size"]
                bs = -(-base // self.world) * self.world
            # kept across evaluations: its cache holds every item's tokens
            self._corpus_batcher = BatchTextBatcher(self.config, self.dataload, batch_size=bs)

        def put(x, dtype=torch.long):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device, non_blocking=True)

        chunks = []
        # the host tokenizes and packs the next batch while the card
        # encodes this one
        for cb in _prefetch_iterator(self._corpus_batcher.batches(), 2):
            if "packed_tokens" in cb:
                emb = self.model.encode_items_packed(
                    put(cb["packed_tokens"]), put(cb["packed_segment_ids"], torch.int32),
                    put(cb["packed_positions"]), put(cb["emb_slots"]))
            else:
                # every rank built the same batch; each encodes its rows
                rows = {k: shard_identical(v, mesh) for k, v in cb.items()
                        if k not in ("item_ids", "n_real")}
                img = self._image_device_arrays(rows, "")
                emb = self.model.compute_item_chunk(
                    put(rows["tokens"]), put(rows["lens"]), img.get("pixel_patches"),
                    batch_image_extra(img, ""))
                if mesh is not None:
                    emb = torch.cat(comm.all_gather(emb, "corpus_gather"))
            emb = emb[: cb["n_real"]]
            chunks.append(emb.cpu() if return_host else emb)
        return torch.cat(chunks)

    @torch.no_grad()
    def evaluate(self, eval_batcher, load_best_model: bool = False):
        """Metrics of one split (JAX trainer.py:1058-1242). The config's
        ``log_detailed_results`` writes each batch's per-user recommendation
        dump (``detailed/batch_{n:07d}``, ids mapped through
        ``id2token``) and ``save_for_eval`` each batch's top-k and user /
        head embeddings (``saved_eval/eval_chunk_{n:05d}.npz``), under the
        checkpoint directory, n the batch's first row; with either on, the
        metric rows also go to ``results.pkl`` when pandas is installed.
        Under FSDP every sharded parameter is gathered whole for the
        evaluation and dropped after it."""
        if load_best_model and not self.load_checkpoint():
            logger.warning("no checkpoint found; evaluating current params")
        with self.fsdp.gathered() if self.fsdp is not None else contextlib.nullcontext():
            return self._evaluate(eval_batcher)

    def _evaluate(self, eval_batcher):
        self.model.eval()
        # GAUC / AUC (rec.meanrank) and the VALUE metrics (rec.tgt_score)
        # stream beside the top-k merge for any head count, as head-0
        # counts and target scores; only raw-score dumps (rec.score) take the
        # full [B, H, I] tensor (JAX trainer.py:1062-1089)
        need = self.collector.register.need
        need_full = need("rec.score")
        stream_meanrank = need("rec.meanrank") and not need_full
        stream_tgt = need("rec.tgt_score") and not need_full
        self.collector.external_meanrank = stream_meanrank
        self.collector.external_tgt_score = stream_tgt
        self.collector.set_logit_scale(self._eval_logit_scale())
        needs_corpus = getattr(self.model, "needs_item_corpus_pass", False)
        host_mode = self._use_host_item_table(needs_corpus, need_full)
        item_tags = None
        if self.dataload.item_tag_matrix is not None:
            item_tags = torch.as_tensor(self.dataload.item_tag_matrix, device=self.device)
        if self.dataload.item_orig_tag_matrix is not None:
            # Entropy is computed over the ORIGINAL tags (reference
            # trainer.py:823 passes all_original_item_tags to set_all_tags)
            self.collector.set_all_tags(np.asarray(self.dataload.item_orig_tag_matrix))
        top_k = max(self.config["topk"])
        streamed = dict(stream_meanrank=stream_meanrank, stream_tgt=stream_tgt)
        if host_mode:
            # corpus scale: the table stays in host memory and each item
            # chunk crosses to the card once per group of eval batches
            raw_host = self.compute_item_feature(return_host=True)
            results = self._host_table_topk_results(
                eval_batcher, raw_host, self.normalize_host_table(raw_host), item_tags,
                top_k, **streamed)
        else:
            item_feats = self.compute_item_feature()
            raw_item_table = None
            if needs_corpus:
                # text models: the raw table feeds the user tower, a normalized
                # copy the cosine scoring (trainer.py:1102-1108)
                raw_item_table = item_feats
                item_feats = cosine_normalize(item_feats)
            results = self._device_topk_results(eval_batcher, item_feats, item_tags, top_k,
                                                raw_item_table, need_full=need_full, **streamed)

        # only rank 0 writes dumps and eval chunks (JAX trainer.py:1150,1162)
        save_for_eval = bool(self.config.get("save_for_eval", False))
        log_detailed = bool(self.config.get("log_detailed_results", False)) and self.rank == 0
        switch_correct_sum = None
        n_eval_samples = 0
        for batch, n_real, topk_vals, topk_idx, pe in results:
            if need_full:
                # topk_vals carries the full [n_real, H, I] scores here
                self.collector.eval_batch_collect(
                    scores=topk_vals,
                    positive_i=batch["item_target"][:n_real],
                    tag_category=batch["target_tags"][:n_real],
                    outlier_users=batch["outlier_users"][:n_real],
                )
                n_eval_samples += n_real
                continue
            if save_for_eval and self.rank == 0:
                save_eval_chunk(
                    os.path.join(self.saved_model_dir, "saved_eval"), n_eval_samples,
                    user_ids=batch["user_ids"][:n_real], topk_values=topk_vals,
                    topk_indices=topk_idx, user_embs=pe["user_emb"], head_embs=pe["head_embs"])
            detailed = self.collector.eval_batch_collect(
                positive_i=batch["item_target"][:n_real],
                tag_category=batch["target_tags"][:n_real],
                outlier_users=batch["outlier_users"][:n_real],
                topk_values=topk_vals,
                topk_indices=topk_idx,
                log_detailed_results=log_detailed,
            )
            if log_detailed and detailed is not None:
                self._save_detailed(batch, n_real, detailed, n_eval_samples)
            if "switch_correct" in pe:
                sc = pe["switch_correct"].sum(axis=0)
                switch_correct_sum = sc if switch_correct_sum is None else switch_correct_sum + sc
            n_eval_samples += n_real

        raw_sections: Dict[str, Dict[str, Any]] = {}
        # non-subgroup metrics divide by the GLOBAL eval-set size, matching the
        # reference (trainer.py:1038-1041: len(sampler.dataset))
        num_total = float(len(eval_batcher))
        shared_struct = self.collector.get_data_struct(-1)
        if "rec.rec_tags" in shared_struct:
            shared = self.evaluator.evaluate(shared_struct, pred_len=-1)
            if shared:
                raw_sections["shared"] = shared
        self.collector.reset_all_tags()
        for p in self.metrics_pred_len_list:
            struct = self.collector.get_data_struct(p)
            raw_sections[f"pred_{p}"] = self.evaluator.evaluate(struct, pred_len=p)

        result_summary, switch_accs = self._normalize_all(
            raw_sections, num_total, switch_correct_sum, n_eval_samples
        )
        for section, metrics in result_summary.items():
            self.results_rows.append({"section": section, **metrics})
        if (save_for_eval or log_detailed) and self.rank == 0:
            self._save_results_table()
        if switch_accs:
            result_summary.setdefault("shared", {}).update(switch_accs)
        return result_summary

    def _save_detailed(self, batch, n_real: int, detailed, first_row: int):
        """One batch's per-user recommendation dump with head provenance
        (JAX trainer.py:1168-1196, reference trainer.py:999-1015): user,
        target and recommended item ids mapped to their tokens."""
        id2item = self.dataload.id2token["item_id"]
        id2user = self.dataload.id2token["user_id"]
        detailed["user"] = [id2user[u] for u in batch["user_ids"][:n_real].tolist()]
        detailed["item_tgt"] = [[id2item[i] for i in row]
                                for row in batch["item_target"][:n_real].tolist()]
        detailed["recommend_items"] = [[id2item[i] for i in row] for row in detailed.pop("idx")]
        detailed.pop("idx_by_head", None)
        save_log_dict(os.path.join(self.saved_model_dir, "detailed", f"batch_{first_row:07d}"),
                      detailed)

    def _save_results_table(self):
        """Every evaluation's metric rows so far as a pandas DataFrame in
        ``results.pkl`` (JAX trainer.py:1226-1235); skipped, with one
        warning, where pandas is not installed."""
        try:
            import pandas as pd
        except ImportError:
            if not self._warned_no_pandas:
                logger.warning("pandas is not installed: results.pkl is not written")
                self._warned_no_pandas = True
            return
        os.makedirs(self.saved_model_dir, exist_ok=True)
        pd.DataFrame(self.results_rows).to_pickle(
            os.path.join(self.saved_model_dir, "results.pkl"))

    def _normalize_all(self, sections, num_total: float,
                       switch_correct_sum=None, n_eval_samples: int = 0):
        """SUM-reduce every metric scalar over the ranks in ONE collective,
        then divide by the (reduced) sample counts (JAX ``_normalize_all``,
        trainer.py:1249-1298; reference trainer.py:1046-1123 all-reduces
        each scalar apart). Tuple metrics are (sum, count[, 'sqrt']), e.g.
        RMSE; the others divide by ``num_total``, the global eval-set
        size."""
        dp = self.config["metric_decimal_place"] or 5
        flat: list = []
        layout: list = []  # (section, key, tuple form: False | True | "sqrt")
        for sec, result in sections.items():
            for k in sorted(result.keys()):
                v = result[k]
                if isinstance(v, tuple):
                    layout.append((sec, k, v[2] if len(v) > 2 else True))
                    flat += [float(v[0]), float(v[1])]
                else:
                    layout.append((sec, k, False))
                    flat.append(float(v))
        n_switch = 0
        if switch_correct_sum is not None and n_eval_samples > 0:
            n_switch = len(switch_correct_sum)
            flat += [float(x) for x in switch_correct_sum] + [float(n_eval_samples)]
        reduced = self._reduce_sums(flat)
        out: Dict[str, Dict[str, float]] = {sec: {} for sec in sections}
        i = 0
        for sec, k, form in layout:
            if form is False:
                out[sec][k] = round(reduced[i] / max(1.0, num_total), dp)
                i += 1
                continue
            mean = reduced[i] / max(1.0, reduced[i + 1])
            if form == "sqrt":
                mean = float(np.sqrt(mean))
            out[sec][k] = round(mean, dp)
            i += 2
        switch_accs: Dict[str, float] = {}
        if n_switch:
            total_n = reduced[i + n_switch]
            for c in range(n_switch):
                name = self.config["int_to_category"].get(c, str(c))
                switch_accs[f"head_cat_{name}_acc"] = reduced[i + c] / max(total_n, 1.0)
        return out, switch_accs

    def _reduce_sums(self, values) -> list:
        """A list of float scalars summed over the ranks (one float64
        all-reduce on the trainer's device); unchanged outside a group."""
        if self.mesh is None or not values:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        return comm.all_reduce(t, "metric_reduce").tolist()

    # ------------------------------------------------------------------
    def _use_host_item_table(self, needs_corpus: bool, need_full: bool = False) -> bool:
        """Whether the corpus table stays in host memory (JAX
        trainer.py:1310-1334; config ``host_item_table``: auto | true |
        false, budget ``item_table_hbm_budget_gb``): never for ID models, a
        frozen table or the full-score path (which raises under ``true``);
        under auto, when the raw float32 table exceeds the budget."""
        mode = self.config.get("host_item_table", "auto")
        if mode in (False, "false", "False") or not needs_corpus:
            return False
        if self.config.get("freeze_item_llm", False):
            return False
        if need_full:
            if mode in (True, "true", "True"):
                raise ValueError(
                    "host_item_table is incompatible with full-score metrics "
                    "(rec.score needs [B, H, I] score tensors; GAUC and the VALUE "
                    "metrics stream)")
            return False
        if mode in (True, "true", "True"):
            return True
        D = getattr(getattr(self.model, "item_config", None), "hidden_size", 0)
        est_bytes = float(self.dataload.item_num) * max(D, 1) * 4
        budget = float(self.config.get("item_table_hbm_budget_gb", 4.0) or 4.0)
        return est_bytes > budget * (1 << 30)

    def normalize_host_table(self, raw_host: torch.Tensor) -> torch.Tensor:
        """The unit-norm copy of a host-memory table, as ``cosine_normalize``
        computes it, in pinned memory when there is a card (so its chunks
        cross to the card without a staging copy)."""
        norm = torch.linalg.vector_norm(raw_host, dim=-1, keepdim=True).clamp_(min=1e-12)
        out = torch.empty(raw_host.shape, dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        return torch.div(raw_host, norm, out=out)

    def _eval_device_batch(self, batch):
        """Card-side view of an eval batch: item_seq / target_tags and the
        fixed-size history-suppression buffers (col -1 = padding)."""
        hist_c = batch["history_col"]
        if not self.suppress_history:
            hist_c = np.full_like(hist_c, -1)

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device, non_blocking=True)

        return {
            "item_seq": put(batch["item_seq"], torch.long),
            "target_tags": put(batch["target_tags"], torch.int8),
            "hist_r": put(batch["history_row"], torch.long),
            "hist_c": put(hist_c, torch.long),
        }

    def _to_host(self, tensors):
        """Copies of ``tensors`` on the host, and an event that marks when
        they are complete (None off the card). On the card the copies go to
        pinned memory without blocking, so work enqueued after them keeps
        the card busy while the host waits on this batch's event alone."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors], None
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _batch_outputs(self, pe, n_real: int, topk_vals, topk_idx, mr=None):
        """What of one eval batch crosses to the host, by name: the top-k,
        the switch accuracies, under ``save_for_eval`` the user and head
        embeddings, and the streamed mean-rank state."""
        out = {"topk_vals": topk_vals[:n_real], "topk_idx": topk_idx[:n_real]}
        if "switch_correct" in pe:
            out["switch_correct"] = pe["switch_correct"][:n_real]
        if self.config.get("save_for_eval", False):
            out["user_emb"] = pe["user_emb"][:n_real]
            out["head_embs"] = pe["head_embs"][:n_real]
        if mr is not None:
            keys = ("tgt_items", "tgt_score") + (("g", "e", "fin") if mr["counts"] else ())
            out.update({f"mr_{k}": mr[k][:n_real] for k in keys})
        return out

    def _finish_batch(self, batch, n_real: int, host):
        """The consumer's tuple of one batch from its host arrays; hands the
        streamed mean-rank rows and target scores to the collector."""
        mr = {k[3:]: v for k, v in host.items() if k.startswith("mr_")}
        if mr:
            self._finalize_meanrank(mr)
        pe = {k: host[k] for k in ("switch_correct", "user_emb", "head_embs") if k in host}
        return batch, n_real, host["topk_vals"], host["topk_idx"], pe

    @torch.no_grad()
    def _device_topk_results(self, eval_batcher, item_feats, item_tags, top_k,
                             raw_item_table=None, need_full: bool = False,
                             stream_meanrank: bool = False, stream_tgt: bool = False):
        """Per-batch predict + streamed top-k with the table on the card; a
        text model's user tower reads the raw table ``raw_item_table``
        (trainer.py:1426-1427). With ``need_full`` the full masked score
        tensor [n_real, H, I] rides in the top-k values' slot. The streamed
        mean-rank state advances in the same chunk loop.
        One-deep pipelining: batch i's results are copied to the host as
        soon as its work is enqueued, then batch i+1's work is enqueued, and
        only then does the host wait for batch i's copies — so the card
        computes batch i+1 while the collector runs on batch i."""

        def materialize(p):
            batch, n_real, names, (host, done) = p
            if done is not None:
                done.synchronize()
            return self._finish_batch(batch, n_real,
                                      {k: np.asarray(h) for k, h in zip(names, host)})

        pending = None
        sharded = isinstance(item_feats, ShardedItemFeatures)
        for batch in eval_batcher.batches():
            n_real = int(batch["sample_weight"].sum())
            # a batch of padding alone is skipped, except over a sharded
            # table: the other ranks' lookups and chunk fetches of this batch
            # need this rank's, so it runs them too and yields nothing
            if n_real == 0 and not sharded:
                continue
            dev = self._eval_device_batch(batch)
            if raw_item_table is None:
                pe = self.model.predict_embeddings(dev["item_seq"], dev["target_tags"])
            else:
                pe = self.model.predict_embeddings(dev["item_seq"], dev["target_tags"],
                                                   raw_item_table)
            if need_full:
                full = self._full_scores(pe, item_feats, item_tags, dev)[:n_real]
                if n_real:
                    yield batch, n_real, full.cpu().numpy(), None, {}
                continue
            mr = None
            if stream_meanrank or stream_tgt:
                tgt = torch.as_tensor(batch["item_target"], dtype=torch.long).to(
                    self.device, non_blocking=True)
                tgt_tags = None
                if pe["head_embs"].shape[1] > 1 and item_tags is not None:
                    tgt_tags = item_tags[tgt]
                mr = self._init_meanrank_state(pe, dev, tgt, item_feats[tgt],
                                               counts=stream_meanrank, tgt_item_tags=tgt_tags)
            topk_vals, topk_idx = self._stream_score_topk(pe, item_feats, item_tags, dev, top_k,
                                                          mr=mr)
            if n_real == 0:
                continue
            out = self._batch_outputs(pe, n_real, topk_vals, topk_idx, mr)
            copies = self._to_host(list(out.values()))
            if pending is not None:
                yield materialize(pending)
            pending = (batch, n_real, list(out), copies)
        if pending is not None:
            yield materialize(pending)

    @torch.no_grad()
    def _host_table_topk_results(self, eval_batcher, raw_host, norm_host, item_tags, top_k,
                                 stream_meanrank: bool = False, stream_tgt: bool = False,
                                 overlap: bool = True):
        """Corpus-scale evaluation with the table in host memory (JAX
        trainer.py:1458-1599). Phase A runs the user tower of every eval
        batch on sequence embeddings gathered from ``raw_host`` on the host;
        phase B streams each chunk of the normalized table ``norm_host``
        (pinned) to the card once and advances every batch's running top-k
        (and mean-rank state), which stay on the card.

        Batches are taken in groups, one table pass each, so the state held
        on the card stays bounded: ``host_eval_group_size`` batches, or as
        many as fit ``host_eval_state_budget_gb`` (default 2.0). On the card
        chunk ci+1's copy is issued on a side stream before chunk ci is
        scored, and the scoring stream waits on its event only when it
        reaches that chunk (``overlap`` False: each chunk is copied on the
        scoring stream, for comparison). ``host_table_stats`` records the
        groups, chunks and bytes copied, and on the card each copy's
        events."""
        group = int(self.config.get("host_eval_group_size", 0) or 0)
        budget = float(self.config.get("host_eval_state_budget_gb", 2.0) or 2.0) * (1 << 30)
        on_card = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if on_card and overlap else None
        save_embs = bool(self.config.get("save_for_eval", False))
        I, D = norm_host.shape
        chunk = min(self.item_chunk_size, I)
        n_chunks = -(-I // chunk)
        stats = self.host_table_stats = {"groups": 0, "chunks": 0, "h2d_bytes": 0,
                                         "copy_events": []}

        def stage(ci):
            """Chunk ``ci`` of the table on the card (padded to the chunk
            size), and the event its copy completes."""
            off = ci * chunk
            src = norm_host[off:off + chunk]
            stats["chunks"] += 1
            stats["h2d_bytes"] += src.numel() * src.element_size()
            if not on_card:
                return F.pad(src, (0, 0, 0, chunk - src.shape[0])), None
            with torch.cuda.stream(copy_stream or torch.cuda.current_stream(self.device)):
                start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                feats = torch.empty((chunk, D), dtype=torch.float32, device=self.device)
                feats[:src.shape[0]].copy_(src, non_blocking=True)
                feats[src.shape[0]:].zero_()
                done.record()
            stats["copy_events"].append((start, done))
            return feats, done

        def flush(states):
            if not states:
                return
            stats["groups"] += 1
            nxt = stage(0)
            for ci in range(n_chunks):
                feats_c, ready = nxt
                if copy_stream is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                    # made on the side stream, read on this one: the
                    # allocator must not hand it back out before this
                    # stream is done with it
                    feats_c.record_stream(torch.cuda.current_stream(self.device))
                if ci + 1 < n_chunks:
                    nxt = stage(ci + 1)
                off = ci * chunk
                tags_c = None
                if item_tags is not None:
                    tags_c = F.pad(item_tags[off:off + chunk],
                                   (0, 0, 0, chunk - min(chunk, I - off)))
                for st in states:
                    st["run_vals"], st["run_idx"] = self._score_chunk(
                        st["pe"], feats_c, tags_c, st["dev"], off, I, st["run_vals"],
                        st["run_idx"], top_k, st["mr"])
            for st in states:
                out = self._batch_outputs(st["pe"], st["n_real"], st["run_vals"],
                                          st["run_idx"], st["mr"])
                host = {k: v.cpu().numpy() for k, v in out.items()}
                yield self._finish_batch(st["batch"], st["n_real"], host)

        states = []
        for batch in eval_batcher.batches():
            n_real = int(batch["sample_weight"].sum())
            if n_real == 0:
                continue
            # the sequences' rows gathered on the host, into pinned memory
            seq = torch.as_tensor(batch["item_seq"], dtype=torch.long)
            seq_embeds = torch.empty((seq.numel(), raw_host.shape[1]), dtype=raw_host.dtype,
                                     pin_memory=on_card)
            torch.index_select(raw_host, 0, seq.reshape(-1), out=seq_embeds)
            dev = self._eval_device_batch(batch)
            pe = self.model.predict_embeddings(
                dev["item_seq"], dev["target_tags"],
                seq_embeds=seq_embeds.view(*seq.shape, -1).to(self.device, non_blocking=True))
            if not save_embs:
                pe.pop("user_emb")
            mr = None
            if stream_meanrank or stream_tgt:
                tgt_np = np.asarray(batch["item_target"], dtype=np.int64)
                tgt = torch.as_tensor(tgt_np).to(self.device, non_blocking=True)
                tgt_tags = None
                if pe["head_embs"].shape[1] > 1 and item_tags is not None:
                    tgt_tags = item_tags[tgt]
                tgt_feats = norm_host[torch.as_tensor(tgt_np)].to(self.device)
                mr = self._init_meanrank_state(pe, dev, tgt, tgt_feats,
                                               counts=stream_meanrank, tgt_item_tags=tgt_tags)
            B, H, _ = pe["head_embs"].shape
            if self.config["split_mode"] == "average" and H > 1:
                H = 1  # heads fused by finite-mean inside the chunk scorer
            st = {"batch": batch, "n_real": n_real, "pe": pe, "dev": dev, "mr": mr,
                  "run_vals": torch.full((B, H, top_k), -math.inf, device=self.device),
                  "run_idx": torch.zeros((B, H, top_k), dtype=torch.long, device=self.device)}
            states.append(st)
            if not group:
                held = [pe["head_embs"], pe.get("switch_pred"), dev["target_tags"],
                        st["run_vals"], st["run_idx"]]
                per_state = sum(t.numel() * t.element_size() for t in held if t is not None)
                group = max(1, int(budget // max(per_state, 1)))
            if len(states) >= group:
                yield from flush(states)
                states = []
        yield from flush(states)

    def _item_chunks(self, item_feats, item_tags):
        """(offset, features, tags) of each item chunk of a table on the
        card, or fetched from its owners (``ShardedItemFeatures``), the tail
        padded to the chunk size."""
        I = len(item_feats)
        chunk = min(self.item_chunk_size, I)
        for off in range(0, I, chunk):
            feats_c = item_feats[off:off + chunk]
            tags_c = item_tags[off:off + chunk] if item_tags is not None else None
            if feats_c.shape[0] < chunk:
                pad = chunk - feats_c.shape[0]
                feats_c = F.pad(feats_c, (0, 0, 0, pad))
                if tags_c is not None:
                    tags_c = F.pad(tags_c, (0, 0, 0, pad))
            yield off, feats_c, tags_c

    def _stream_score_topk(self, pe, item_feats, item_tags, dev, top_k: int, mr=None):
        """Chunked full-corpus scoring with pad/history masking and per-head
        top-k merged over chunks on the card; ``mr``, a streamed mean-rank
        state (``_init_meanrank_state``), advances in the same loop."""
        B, H, _ = pe["head_embs"].shape
        if self.config["split_mode"] == "average" and H > 1:
            H = 1  # heads fused by finite-mean inside the chunk scorer
        run_vals = torch.full((B, H, top_k), -math.inf, device=self.device)
        run_idx = torch.zeros((B, H, top_k), dtype=torch.long, device=self.device)
        for off, feats_c, tags_c in self._item_chunks(item_feats, item_tags):
            run_vals, run_idx = self._score_chunk(pe, feats_c, tags_c, dev, off,
                                                  len(item_feats), run_vals, run_idx,
                                                  top_k, mr)
        return run_vals, run_idx

    def _score_chunk(self, pe, feats_c, tags_c, dev, off: int, item_num: int, run_vals,
                     run_idx, top_k: int, mr=None):
        """One item chunk: its masked scores merged into the running top-k
        (JAX ``_make_chunk_scorer``) and, with a mean-rank state that counts,
        head 0's raw scores counted against the targets' (``count_fn``)."""
        args = (pe["head_embs"], pe.get("switch_pred"), feats_c, tags_c, dev["target_tags"],
                off, item_num, dev["hist_r"], dev["hist_c"])
        scores = self._masked_chunk_scores(*args)
        run_vals, run_idx = self._merge_chunk_topk(scores, off, run_vals, run_idx, top_k)
        if mr is not None and mr["counts"]:
            if scores.shape[1] != pe["head_embs"].shape[1]:
                # the heads were fused ('average'): the counts take head 0's
                # raw scores, as the full-tensor path does
                scores = self._masked_chunk_scores(*args, fuse_average=False)
            self._count_chunk(scores[:, 0], off, item_num, mr)
        return run_vals, run_idx

    def _masked_chunk_scores(self, head_embs, switch_pred, feats_c, tags_c, tgt_tags,
                             off: int, item_num: int, hist_r, hist_c, fuse_average: bool = True):
        """score_items + pad-item masking + history suppression for one
        chunk (JAX ``_masked_chunk_scores_closure``); ``fuse_average`` False
        skips the 'average' split mode's head fusion."""
        scores = self.model.score_items(head_embs, feats_c, tags_c, tgt_tags, switch_pred)
        if fuse_average and self.config["split_mode"] == "average" and scores.shape[1] > 1:
            # finite-mean over heads (reference collector.py:227-230)
            finite = torch.isfinite(scores)
            scores = (torch.where(finite, scores, 0.0).sum(dim=1)
                      / (finite.sum(dim=1) + 1e-8))[:, None, :]
        Ck = scores.shape[-1]
        gid = off + torch.arange(Ck, device=scores.device)
        scores.masked_fill_((gid == 0) | (gid >= item_num), -math.inf)
        # history suppression: additive -inf scatter; col -1 pads the buffer
        col_local = hist_c - off
        ok = (col_local >= 0) & (col_local < Ck)
        add = torch.zeros(ok.shape, device=scores.device).masked_fill_(ok, -math.inf)
        scores.permute(0, 2, 1).index_put_(
            (hist_r, col_local.clamp(0, Ck - 1)),
            add[:, None].expand(-1, scores.shape[1]), accumulate=True,
        )
        return scores

    def _merge_chunk_topk(self, scores, off: int, run_vals, run_idx, top_k: int):
        """One chunk's per-head top-k merged into the running top-k."""
        Ck = scores.shape[-1]
        k_eff = min(top_k, Ck)
        vals, idx = topk_first(scores, k_eff)
        gidx = off + idx
        if k_eff < top_k:
            vals = F.pad(vals, (0, top_k - k_eff), value=-math.inf)
            gidx = F.pad(gidx, (0, top_k - k_eff))
        # fresh chunk first: on ties the merge keeps the chunk's entries,
        # as the JAX scorer does
        mvals, mpos = topk_first(torch.cat([vals, run_vals], dim=-1), top_k)
        return mvals, torch.gather(torch.cat([gidx, run_idx], dim=-1), -1, mpos)

    def _full_scores(self, pe, item_feats, item_tags, dev):
        """The full [B, H, I] masked score tensor (JAX ``_full_scores``,
        trainer.py:1657-1678): the oracle of the streamed paths, and what
        raw-score dumps (rec.score) read. Small corpora only. Scored chunk by
        chunk, as the streamed path scores them, so both see the same
        products; a sharded table's chunks are fetched as the streamed path
        fetches them, and only the [B, H, I] scores are whole, as in JAX."""
        I = len(item_feats)
        scores = torch.cat([
            self.model.score_items(pe["head_embs"], feats_c, tags_c, dev["target_tags"],
                                   pe.get("switch_pred"))[..., :I - off]
            for off, feats_c, tags_c in self._item_chunks(item_feats, item_tags)], dim=-1)
        scores[..., 0] = -math.inf
        # the history buffers (col -1 pads; all -1 without suppress_history)
        ok = dev["hist_c"] >= 0
        add = torch.zeros(ok.shape, device=scores.device).masked_fill_(ok, -math.inf)
        scores.permute(0, 2, 1).index_put_(
            (dev["hist_r"], dev["hist_c"].clamp(0, I - 1)),
            add[:, None].expand(-1, scores.shape[1]), accumulate=True)
        return scores

    # -- streamed mean-rank (GAUC without the [B, H, I] tensor) ------------
    # The tie-averaged descending rank of a target t is count(score > s_t) +
    # (count(score == s_t) + 1) / 2 and user_len = count(score > −inf), so
    # GAUC's inputs are sums of per-chunk counts (JAX trainer.py:1755-1925).
    # Head 0 throughout, as the full-tensor path reads it (collector
    # _collect_meanrank takes scores[:, 0]).
    def _init_meanrank_state(self, pe, dev, tgt_items, tgt_feats, counts: bool = True,
                             tgt_item_tags=None):
        """The batch's target scores and zeroed counters on the card.
        ``counts`` False (VALUE metrics only): the target scores alone. A
        multi-head model's targets are scored through ``score_items`` (with
        their item tags), so head 0 carries its prior masks."""
        if pe["head_embs"].shape[1] == 1:
            tgt_score = self._target_scores(pe["head_embs"], tgt_feats, tgt_items,
                                            dev["hist_r"], dev["hist_c"])
        else:
            tgt_score = self._target_scores_mh(pe, tgt_feats, tgt_item_tags, dev, tgt_items)
        B, P = tgt_items.shape
        zeros = torch.zeros((B, P), dtype=torch.long, device=self.device)
        return {"counts": counts, "tgt_items": tgt_items, "tgt_score": tgt_score,
                "g": zeros, "e": zeros.clone(),
                "fin": torch.zeros(B, dtype=torch.long, device=self.device)}

    @staticmethod
    def _mask_targets(s, tgt_items, hist_r, hist_c):
        """−inf for pad targets and for targets in the user's suppressed
        history, as the chunk scores mask them."""
        s = s.masked_fill(tgt_items == 0, -math.inf)
        eq = (tgt_items[hist_r] == hist_c[:, None]) & (hist_c >= 0)[:, None]  # [Hn, P]
        hit = torch.zeros(s.shape, dtype=torch.int32, device=s.device).index_add_(
            0, hist_r, eq.int())
        return s.masked_fill(hit > 0, -math.inf)

    def _target_scores(self, head_embs, tgt_feats, tgt_items, hist_r, hist_c):
        """Single head (JAX ``target_score_fn``): head_embs [B, 1, D] and
        the targets' normalized rows [B, P, D] → [B, P]."""
        s = torch.einsum("bhd,bpd->bhp", head_embs, tgt_feats)[:, 0]
        return self._mask_targets(s, tgt_items, hist_r, hist_c)

    def _target_scores_mh(self, pe, tgt_feats, tgt_item_tags, dev, tgt_items):
        """Multi-head (JAX ``target_score_mh_fn``): the batch's B·P targets
        scored as one pseudo-chunk through ``score_items``, each row's own
        targets taken from head 0."""
        B, P, D = tgt_feats.shape
        tags_c = tgt_item_tags.reshape(B * P, -1) if tgt_item_tags is not None else None
        scores = self.model.score_items(pe["head_embs"], tgt_feats.reshape(B * P, D), tags_c,
                                        dev["target_tags"], pe.get("switch_pred"))[:, 0]
        cols = (torch.arange(B, device=scores.device)[:, None] * P
                + torch.arange(P, device=scores.device)[None, :])
        s = torch.gather(scores, 1, cols)
        return self._mask_targets(s, tgt_items, dev["hist_r"], dev["hist_c"])

    @staticmethod
    def _count_chunk(scores0, off: int, item_num: int, mr):
        """Advance the counters with one chunk's head-0 scores [B, Ck] (JAX
        ``count_fn``): items above each target, items equal to it (the
        chunk's tail padding left out) and finite items."""
        valid = (off + torch.arange(scores0.shape[-1], device=scores0.device)) < item_num
        mr["fin"] += (scores0 > -math.inf).sum(-1)
        tgt_score = mr["tgt_score"]
        for p in range(tgt_score.shape[1]):
            sp = tgt_score[:, p, None]
            mr["g"][:, p] += (scores0 > sp).sum(-1)
            mr["e"][:, p] += ((scores0 == sp) & valid).sum(-1)

    def _finalize_meanrank(self, mr):
        """The host arrays of a batch's mean-rank state (real rows) →
        per-horizon [pos_rank_sum, user_len, pos_len] rows and the per-target
        sigmoid scores, handed to the collector (JAX ``_finalize_meanrank``).
        Duplicate target ids within a horizon collapse, as the reference's
        pos_matrix scatter does."""
        ids = mr["tgt_items"]
        tgt_s = mr["tgt_score"].astype(np.float64)
        P = ids.shape[1]
        first = np.ones(ids.shape, bool)
        for j in range(1, P):
            first[:, j] = ~(ids[:, :j] == ids[:, j:j + 1]).any(axis=1)
        if self.collector.external_tgt_score:
            scale = self.collector.logit_scale_value
            keep = first & np.isfinite(tgt_s)
            preds = {}
            for p in self.metrics_pred_len_list:
                m = keep[:, :p + 1]
                preds[p] = 1.0 / (1.0 + np.exp(-scale * tgt_s[:, :p + 1][m]))
            self.collector.tgt_score_collect(preds)
        if "g" not in mr:
            return
        rank = mr["g"].astype(np.float64) + (mr["e"].astype(np.float64) + 1.0) / 2.0
        fin = mr["fin"].astype(np.float64)
        rows = {}
        for p in self.metrics_pred_len_list:
            m = first[:, :p + 1]
            rows[p] = np.stack([(rank[:, :p + 1] * m).sum(1), fin,
                                m.sum(1).astype(np.float64)], axis=1)
        self.collector.meanrank_rows_collect(rows)

    def _eval_logit_scale(self) -> float:
        """The model's NCE temperature exp(clamped logit_scale)."""
        if self.config["fix_temp"]:
            return float(1.0 / 0.07)
        ls = float(self.model.logit_scale)
        return float(np.exp(min(ls, np.log(100.0))))
