"""Training and evaluation engine (port of ``mhrec_tpu/trainer/trainer.py``,
one device).

* iteration-based ``fit``: ``total_iters`` steps over an endless batch
  stream, NaN guard, periodic eval → ``early_stopping`` on the valid metric
  → best-checkpoint save (reference trainer.py:371-373, 494-687);
* the train step (JAX trainer.py:549-724): under ``sparse_item_adam`` the
  loss is differentiated with respect to the gathered per-batch sub-table,
  the dense parameters take AdamW and the touched item-table rows the
  row-sparse AdamW (kernel ``row_adamw`` on the card); otherwise the whole
  model takes AdamW. The NaN guard stays on the card: a step whose loss is
  NaN has its gradients zeroed and its index recorded in ``nan_step``, and
  the host raises when it next reads the loss (every ``update_interval``
  steps and at the last step);
* dropout and the positive-mix draws come from a generator on the device
  seeded from (seed, step), so a resumed run draws what the first run drew;
* checkpoints (``torch.save``, synchronous): parameters, optimizer state,
  the item table's row moments, step and best score; loaded through a
  memory map to host memory, the optimizer's old state dropped first, so a
  2B-parameter HLLM (24 GB with its moments) reloads without a second copy
  on the card;
* the evaluation pipeline (trainer.py:698-1152): corpus item embeddings
  (the item table of an ID model; for HLLM the item tower over every
  item's text, dense or packed, trainer.py:953-1054) → per-user-batch head
  embeddings → **streamed** full-corpus cosine scoring
  with pad-item masking and history suppression, per-head top-k merged over
  item chunks on the card → host collector → metrics → sample-count
  normalization. The item table stays on the card; each chunk's
  ``[B, H, chunk]`` score block is the largest object.

Not ported yet: ``accumulate_grad > 1`` (with ``dedup_touched_rows``),
``item_table_dtype: bfloat16``, asynchronous checkpoints and the
host-memory item table of ``host_item_table``.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mhrec_tpu_torch.data.textset import BatchTextBatcher
from mhrec_tpu_torch.data.trainset import _prefetch_iterator
from mhrec_tpu_torch.evaluator import Collector, Evaluator
from mhrec_tpu_torch.models.factory import build_model
from mhrec_tpu_torch.models.layers import cosine_normalize
from mhrec_tpu_torch.ops import row_adam_cuda
from mhrec_tpu_torch.trainer.lr_schedule import build_schedule
from mhrec_tpu_torch.trainer.optim import build_optimizer, clip_grad_norm
from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update
from mhrec_tpu_torch.utils.misc import calculate_valid_score, early_stopping, resolve_device

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


class Trainer:
    def __init__(self, config, dataload, device=None, dtype=None):
        """``device``: None for the card (raises if there is none), or an
        explicit device such as "cpu". ``dtype``: the trunk's compute type
        (None: the model's default, bfloat16 for HSTU and ``precision`` for
        HLLM)."""
        self.config = config
        self.dataload = dataload
        self.device = resolve_device(device)
        # parameters are made on the device: a 1B-parameter tower never
        # passes through host memory
        with self.device:
            self.model = build_model(config, dataload, dtype=dtype).to(self.device)
        self.model.eval()
        self.collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.eval_pred_len = config["eval_pred_len"]
        self.metrics_pred_len_list = config["metrics_pred_len_list"]
        self.suppress_history = config.get("suppress_history", True)
        self.item_chunk_size = int(config.get("eval_item_chunk_size", 131072))
        self.results_rows: list = []
        self._corpus_batcher = None  # HLLM: the corpus text batcher, kept across evals

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
        self.sparse_item_adam = bool(config.get("sparse_item_adam", False))
        if self.sparse_item_adam and str(config["model"]) == "HLLM":
            raise ValueError(
                "sparse_item_adam applies to ID-embedding models — the HLLM item "
                "tower is an LLM, not an embedding table")
        table_dtype = str(config.get("item_table_dtype") or "float32").lower()
        if table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"item_table_dtype must be float32|bfloat16, got {table_dtype}")
        if table_dtype == "bfloat16":
            raise NotImplementedError("item_table_dtype: bfloat16 is not ported yet")
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
        self.step = 0
        self.fetched_losses: list = []
        self.nan_step = torch.tensor(-1, dtype=torch.long, device=self.device)
        self.best_valid_score: Optional[float] = None
        self.best_valid_result = None
        # bytes and seconds of the last checkpoint save and load
        self.checkpoint_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def setup_model(self, seed: Optional[int] = None):
        """Random parameter initialisation from ``seed`` (default
        ``config["seed"]``) with an explicit generator on the model's
        device; the optimizer; under ``sparse_item_adam`` the item table's
        dense row moments. Resumes from ``load_checkpoint_name`` or, with
        ``resume: true``, from this run's checkpoint."""
        seed = int(seed if seed is not None else (self.config["seed"] or 0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.init_parameters(gen)
        if str(self.config["model"]) == "HLLM":
            from mhrec_tpu_torch.models.hllm.hllm import load_pretrained_towers

            if not self.config.get("dummy_llm", False):
                load_pretrained_towers(self.model, self.config)
            if self.model.freeze_item_llm and self.config.get("all_item_embeds_path"):
                table = np.load(self.config["all_item_embeds_path"])
                self.model.all_item_embeds.copy_(torch.as_tensor(table))
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Trainable parameters: %d", n_params)
        self.optimizer, self.group_schedules, frozen = build_optimizer(
            self.config, self.model,
            lambda lr: build_schedule(self.config["scheduler_args"], lr, self.total_iters))
        for p in frozen:
            p.requires_grad_(False)
        self.dense_params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self.sparse_item_adam:
            table = self.model.item_embedding.weight
            self.table_m = torch.zeros_like(table)
            self.table_v = torch.zeros_like(table)
        self.step = 0
        self.nan_step.fill_(-1)
        if self.config["load_checkpoint_name"]:
            self.saved_model_dir = os.path.abspath(self.config["load_checkpoint_name"])
            if self.load_checkpoint():
                logger.info("resumed from %s at step %d", self.saved_model_dir, self.step)
        elif self.config.get("resume", False):
            if self.load_checkpoint():
                logger.info("resumed at step %d", self.step)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    # the keys of a train batch that index or count (int64 on the device):
    # item ids and masks, and the text train batcher's tokens, lengths,
    # positions and gathers
    _LONG_KEYS = ("items", "neg_items", "masked_index", "unique_ids",
                  "pos_tokens", "pos_token_lens", "neg_tokens", "neg_token_lens",
                  "uniq_tokens", "uniq_token_lens", "uniq_inverse",
                  "packed_tokens", "packed_positions", "emb_slots")

    def _train_device_batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for key in self._LONG_KEYS:
            if key in batch:
                out[key] = torch.as_tensor(np.asarray(batch[key]), dtype=torch.long).to(
                    self.device, non_blocking=True)
        if "packed_segment_ids" in batch:
            # the packed attention kernels take contiguous int32 segment ids
            out["packed_segment_ids"] = torch.as_tensor(
                np.ascontiguousarray(batch["packed_segment_ids"], dtype=np.int32)).to(
                    self.device, non_blocking=True)
        tags = np.asarray(batch["tag_categories"])
        if tags.size:
            out["tag_categories"] = torch.as_tensor(tags).to(self.device, non_blocking=True)
        return out

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of a step's dropout masks and mix draws, seeded
        from (seed, step) so a resumed run repeats the stream."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + step) % (2 ** 63))

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on one batch (numpy dict from the batcher).
        Returns the model's output dict (tensors on the device)."""
        dev = self._train_device_batch(batch)
        gen = self.step_generator(self.step)
        self.model.train()
        for p in self.dense_params:
            p.grad = None
        if self.sparse_item_adam:
            ids = dev.pop("unique_ids")
            table = self.model.item_embedding.weight
            sub0 = table.detach()[ids.clamp(min=0)].requires_grad_(True)
            out = self.model(dev, sub=sub0, generator=gen)
        else:
            out = self.model(dev, generator=gen)
        loss = out["loss"]
        loss.backward()
        # NaN guard on the card: zero this step's gradients and record it
        bad = torch.isnan(loss.detach())
        self.nan_step = torch.where((self.nan_step < 0) & bad,
                                    torch.full_like(self.nan_step, self.step), self.nan_step)
        for p in self.dense_params:
            if p.grad is None:  # unused this step: optax still sees a zero gradient
                p.grad = torch.zeros_like(p)
            else:
                p.grad.masked_fill_(bad, 0.0)
        clip = self.config.get("clip_grad_norm")
        if clip:
            clip_grad_norm(self.dense_params, float(clip))
        for group, sched in zip(self.optimizer.param_groups, self.group_schedules):
            group["lr"] = sched(self.step)
        self.optimizer.step()
        if self.sparse_item_adam:
            g_sub = sub0.grad.masked_fill_(bad, 0.0)
            update = (sparse_adamw_row_update if self.sparse_adam_impl == "xla"
                      else row_adam_cuda.row_adamw)
            with torch.no_grad():
                update(self.model.item_embedding.weight, self.table_m, self.table_v, ids,
                       g_sub, self.schedule(self.step), self.step,
                       SparseAdamConfig(weight_decay=self.weight_decay))
        self.step += 1
        return out

    def fit(self, train_batcher, valid_batcher=None):
        """``total_iters`` steps with periodic evaluation, early stopping and
        best-checkpoint saves. Returns run statistics and the last logged
        scalars."""
        if self.optimizer is None:
            self.setup_model()
        if self.accumulate_grad > 1:
            raise NotImplementedError("accumulate_grad > 1 is not ported yet")
        if self.config.get("sparse_adam_global_dedup") not in (None, "auto", False):
            raise NotImplementedError("sparse_adam_global_dedup is not ported yet")
        stream = train_batcher.infinite_batches(prefetch=2)
        stop_flag = False
        cur_step = 0
        t_data = t_step = t_eval = 0.0
        self.fetched_losses = []  # (step, loss) of every step the host read
        t_steady = None
        it_steady = 0
        t0 = time.time()
        logs: Dict[str, float] = {}
        start_it = self.step  # nonzero after resume
        if start_it:
            logger.info("resuming fit at step %d/%d", start_it, self.total_iters)
        it = start_it - 1
        for it in range(start_it, self.total_iters):
            td = time.time()
            batch = next(stream)
            t_data += time.time() - td
            ts = time.time()
            out = self.train_step(batch)
            # the first step is fetched too, so the steady clock starts
            # after it; the NaN check fires on the last step as well
            if (it + 1) % self.update_interval == 0 or self.debug or it == start_it \
                    or it == self.total_iters - 1:
                loss = float(out["loss"].detach())
                ns = int(self.nan_step)
                if ns >= 0:
                    raise RuntimeError(f"NaN loss at iter {ns}")
                if math.isnan(loss):
                    raise RuntimeError(f"NaN loss at iter {it}")
                logs = {k: float(v.detach()) for k, v in out.items()}
                self.fetched_losses.append((it + 1, loss))
                t_step += time.time() - ts
                if t_steady is None:
                    t_steady, it_steady = time.time(), it + 1
                if self.show_progress:
                    logger.info("iter %d/%d loss=%.*f lr=%.3e data=%.2fs step=%.2fs",
                                it + 1, self.total_iters, self.loss_decimal_place, loss,
                                self.schedule(it), t_data, t_step)
            else:
                t_step += time.time() - ts
            if valid_batcher is not None and (it + 1) % self.eval_interval == 0:
                te = time.time()
                result = self.evaluate(valid_batcher, load_best_model=False)
                score = calculate_valid_score(result, self.valid_metric, self.eval_pred_len)
                self.best_valid_score, cur_step, stop_flag, update_flag = early_stopping(
                    score, self.best_valid_score, cur_step, self.stopping_step,
                    bigger=self.valid_metric_bigger)
                logger.info("valid @ step %d: %s=%.6f (best %.6f)", it + 1, self.valid_metric,
                            score, self.best_valid_score)
                if update_flag:
                    self.best_valid_result = result
                    self.save_checkpoint()
                if t_steady is not None:
                    t_eval += time.time() - te
                if stop_flag:
                    logger.info("early stopping at step %d", it + 1)
                    break
            if self.debug and it >= 9:
                break
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
                "steady_examples_per_s": steady_rate, "eval_s": t_eval, **logs}

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def checkpoint_path(self) -> str:
        return os.path.join(self.saved_model_dir, "checkpoint.pt")

    def save_checkpoint(self):
        """Write the run's one checkpoint (the newest replaces the last),
        through a temporary file so a crash never leaves a torn one."""
        os.makedirs(self.saved_model_dir, exist_ok=True)
        payload = {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "best_valid_score": self.best_valid_score,
        }
        if self.table_m is not None:
            payload["table_m"] = self.table_m
            payload["table_v"] = self.table_v
        path = self.checkpoint_path()
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self.checkpoint_stats.update(bytes=os.path.getsize(path),
                                     save_s=time.perf_counter() - t0)
        logger.info("checkpoint saved: %d bytes in %.1fs", self.checkpoint_stats["bytes"],
                    self.checkpoint_stats["save_s"])

    def load_checkpoint(self) -> bool:
        """Restore the run's checkpoint; False when there is none."""
        path = self.checkpoint_path()
        if not os.path.isfile(path):
            return False
        t0 = time.perf_counter()
        # read to host memory, mapped rather than copied: the copies below
        # move each tensor to its parameter's device, while the optimizer's
        # step counts stay where its policy keeps them (on the host unless
        # fused: on the card they would cost a synchronisation each per step)
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
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
    def compute_item_feature(self):
        """Corpus item embeddings (reference compute_item_feature,
        trainer.py:731-824). ID models: the normalized item table. Text
        models: the item tower over the whole corpus in batches of
        ``MAX_ITEM_LIST_LENGTH · train_batch_size`` items, dense or packed
        (``packed_corpus_pass``), the last batch padded to that size → the
        RAW embedding table [item_num, D] float32 (``evaluate`` normalizes a
        copy for scoring, as the reference's predict does)."""
        if not getattr(self.model, "needs_item_corpus_pass", False):
            return self.model.compute_item_all()
        if self.model.freeze_item_llm:
            return self.model.all_item_embeds
        if self._corpus_batcher is None:
            # kept across evaluations: its cache holds every item's tokens
            self._corpus_batcher = BatchTextBatcher(self.config, self.dataload)

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
                emb = self.model.compute_item_chunk(put(cb["tokens"]), put(cb["lens"]))
            chunks.append(emb[: cb["n_real"]])
        return torch.cat(chunks)

    @torch.no_grad()
    def evaluate(self, eval_batcher, load_best_model: bool = False):
        if load_best_model and not self.load_checkpoint():
            logger.warning("no checkpoint found; evaluating current params")
        self.model.eval()
        for key in ("rec.meanrank", "rec.score", "rec.tgt_score"):
            if self.collector.register.need(key):
                raise NotImplementedError(
                    f"metrics needing {key} (GAUC / VALUE / raw scores) are not ported yet")
        needs_corpus = getattr(self.model, "needs_item_corpus_pass", False)
        if self._use_host_item_table(needs_corpus):
            raise NotImplementedError(
                "host_item_table (the corpus table kept in host memory) is not ported yet")
        if self.config.get("save_for_eval") or self.config.get("log_detailed_results"):
            raise NotImplementedError("save_for_eval / log_detailed_results are not ported yet")
        self.collector.set_logit_scale(self._eval_logit_scale())
        item_feats = self.compute_item_feature()
        raw_item_table = None
        if needs_corpus:
            # text models: the raw table feeds the user tower, a normalized
            # copy the cosine scoring (trainer.py:1102-1108)
            raw_item_table = item_feats
            item_feats = cosine_normalize(item_feats)
        item_tags = None
        if self.dataload.item_tag_matrix is not None:
            item_tags = torch.as_tensor(self.dataload.item_tag_matrix, device=self.device)
        if self.dataload.item_orig_tag_matrix is not None:
            # Entropy is computed over the ORIGINAL tags (reference
            # trainer.py:823 passes all_original_item_tags to set_all_tags)
            self.collector.set_all_tags(np.asarray(self.dataload.item_orig_tag_matrix))

        top_k = max(self.config["topk"])
        switch_correct_sum = None
        n_eval_samples = 0
        for batch, n_real, topk_vals, topk_idx, pe in self._device_topk_results(
                eval_batcher, item_feats, item_tags, top_k, raw_item_table):
            self.collector.eval_batch_collect(
                positive_i=batch["item_target"][:n_real],
                tag_category=batch["target_tags"][:n_real],
                outlier_users=batch["outlier_users"][:n_real],
                topk_values=topk_vals,
                topk_indices=topk_idx,
            )
            if "switch_correct" in pe:
                sc = pe["switch_correct"][:n_real].sum(axis=0)
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
        if switch_accs:
            result_summary.setdefault("shared", {}).update(switch_accs)
        return result_summary

    def _normalize_all(self, sections, num_total: float,
                       switch_correct_sum=None, n_eval_samples: int = 0):
        """Divide every metric sum by its sample count (reference
        trainer.py:1046-1123; one process, so no cross-host reduction)."""
        dp = self.config["metric_decimal_place"] or 5
        out: Dict[str, Dict[str, float]] = {sec: {} for sec in sections}
        for sec, result in sections.items():
            for k in sorted(result.keys()):
                v = result[k]
                if isinstance(v, tuple):
                    # (sum, count[, post-reduce transform]) — e.g. RMSE
                    mean = float(v[0]) / max(1.0, float(v[1]))
                    if len(v) > 2 and v[2] == "sqrt":
                        mean = float(np.sqrt(mean))
                    out[sec][k] = round(mean, dp)
                else:
                    out[sec][k] = round(float(v) / max(1.0, num_total), dp)
        switch_accs: Dict[str, float] = {}
        if switch_correct_sum is not None and n_eval_samples > 0:
            for c, correct in enumerate(switch_correct_sum):
                name = self.config["int_to_category"].get(c, str(c))
                switch_accs[f"head_cat_{name}_acc"] = float(correct) / max(
                    float(n_eval_samples), 1.0)
        return out, switch_accs

    # ------------------------------------------------------------------
    def _use_host_item_table(self, needs_corpus: bool) -> bool:
        """Whether the corpus table would stay in host memory (JAX
        trainer.py:1310-1334; config ``host_item_table``: auto | true |
        false, budget ``item_table_hbm_budget_gb``): never for ID models or a
        frozen table; under auto, when the raw float32 table exceeds the
        budget."""
        mode = self.config.get("host_item_table", "auto")
        if mode in (False, "false", "False") or not needs_corpus:
            return False
        if self.config.get("freeze_item_llm", False):
            return False
        if mode in (True, "true", "True"):
            return True
        D = getattr(getattr(self.model, "item_config", None), "hidden_size", 0)
        est_bytes = float(self.dataload.item_num) * max(D, 1) * 4
        budget = float(self.config.get("item_table_hbm_budget_gb", 4.0) or 4.0)
        return est_bytes > budget * (1 << 30)

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

    def _device_topk_results(self, eval_batcher, item_feats, item_tags, top_k,
                             raw_item_table=None):
        """Per-batch predict + streamed top-k; a text model's user tower
        reads the raw table ``raw_item_table`` (trainer.py:1426-1427).
        One-deep pipelining: batch i's results are copied to the host as
        soon as its work is enqueued, then batch i+1's work is enqueued, and
        only then does the host wait for batch i's copies — so the card
        computes batch i+1 while the collector runs on batch i."""

        def materialize(p):
            batch, n_real, (host, done) = p
            if done is not None:
                done.synchronize()
            host = [np.asarray(h) for h in host]
            pe = {"switch_correct": host[2]} if len(host) > 2 else {}
            return batch, n_real, host[0], host[1], pe

        pending = None
        for batch in eval_batcher.batches():
            n_real = int(batch["sample_weight"].sum())
            if n_real == 0:
                continue
            dev = self._eval_device_batch(batch)
            if raw_item_table is None:
                pe = self.model.predict_embeddings(dev["item_seq"], dev["target_tags"])
            else:
                pe = self.model.predict_embeddings(dev["item_seq"], dev["target_tags"],
                                                   raw_item_table)
            topk_vals, topk_idx = self._stream_score_topk(pe, item_feats, item_tags, dev, top_k)
            # only the consumer's arrays cross to the host
            out = [topk_vals[:n_real], topk_idx[:n_real]]
            if "switch_correct" in pe:
                out.append(pe["switch_correct"][:n_real])
            copies = self._to_host(out)
            if pending is not None:
                yield materialize(pending)
            pending = (batch, n_real, copies)
        if pending is not None:
            yield materialize(pending)

    def _stream_score_topk(self, pe, item_feats, item_tags, dev, top_k: int):
        """Chunked full-corpus scoring with pad/history masking and per-head
        top-k merged over chunks on the card."""
        I = item_feats.shape[0]
        chunk = min(self.item_chunk_size, I)
        n_chunks = -(-I // chunk)
        B, H, _ = pe["head_embs"].shape
        if self.config["split_mode"] == "average" and H > 1:
            H = 1  # heads fused by finite-mean inside the chunk scorer
        run_vals = torch.full((B, H, top_k), -math.inf, device=self.device)
        run_idx = torch.zeros((B, H, top_k), dtype=torch.long, device=self.device)
        for ci in range(n_chunks):
            off = ci * chunk
            feats_c = item_feats[off:off + chunk]
            tags_c = item_tags[off:off + chunk] if item_tags is not None else None
            if feats_c.shape[0] < chunk:  # pad the tail chunk to the chunk size
                pad = chunk - feats_c.shape[0]
                feats_c = F.pad(feats_c, (0, 0, 0, pad))
                if tags_c is not None:
                    tags_c = F.pad(tags_c, (0, 0, 0, pad))
            run_vals, run_idx = self._chunk_topk(
                pe["head_embs"], pe.get("switch_pred"), feats_c, tags_c,
                dev["target_tags"], off, I, dev["hist_r"], dev["hist_c"],
                run_vals, run_idx, top_k,
            )
        return run_vals, run_idx

    def _masked_chunk_scores(self, head_embs, switch_pred, feats_c, tags_c, tgt_tags,
                             off: int, item_num: int, hist_r, hist_c):
        """score_items + pad-item masking + history suppression for one
        chunk (JAX ``_masked_chunk_scores_closure``)."""
        scores = self.model.score_items(head_embs, feats_c, tags_c, tgt_tags, switch_pred)
        if self.config["split_mode"] == "average" and scores.shape[1] > 1:
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

    def _chunk_topk(self, head_embs, switch_pred, feats_c, tags_c, tgt_tags, off, item_num,
                    hist_r, hist_c, run_vals, run_idx, top_k: int):
        """One chunk's per-head top-k merged into the running top-k (JAX
        ``_make_chunk_scorer``)."""
        scores = self._masked_chunk_scores(head_embs, switch_pred, feats_c, tags_c, tgt_tags,
                                           off, item_num, hist_r, hist_c)
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

    def _eval_logit_scale(self) -> float:
        """The model's NCE temperature exp(clamped logit_scale)."""
        if self.config["fix_temp"]:
            return float(1.0 / 0.07)
        ls = float(self.model.logit_scale)
        return float(np.exp(min(ls, np.log(100.0))))
