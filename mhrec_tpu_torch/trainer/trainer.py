"""Evaluation engine (port of the serving half of
``mhrec_tpu/trainer/trainer.py``).

The pipeline of the reference's eval (trainer.py:698-1152): corpus item
embeddings → per-user-batch head embeddings → **streamed** full-corpus
cosine scoring with pad-item masking and history suppression, per-head top-k
merged over item chunks on the card → host collector → metrics → sample-count
normalization. The item table stays on the card; each chunk's
``[B, H, chunk]`` score block is the largest object.

Training (fit, optimizers, checkpoints) comes with the training slice; until
then ``setup_model`` initialises parameters only, and
``evaluate(load_best_model=True)`` evaluates the current parameters, as the
JAX package does when no checkpoint exists.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mhrec_tpu_torch.evaluator import Collector, Evaluator
from mhrec_tpu_torch.models.factory import build_model
from mhrec_tpu_torch.utils.misc import resolve_device

logger = logging.getLogger(__name__)


def topk_first(x: torch.Tensor, k: int):
    """Top-k along the last dim, largest first, ties broken by the LOWER
    position — the order ``jax.lax.top_k`` gives. ``torch.topk`` promises no
    tie order on CUDA, and ties are common here: a head the prior switch
    turns off is all −inf. Returns (values, positions)."""
    n = x.shape[-1]
    kth = torch.topk(x, k, dim=-1).values.min(dim=-1, keepdim=True).values
    # every entry above the k-th value is in; the rest of the k slots go to
    # the lowest positions holding the k-th value (keys n..1 by position)
    rank = torch.arange(n, 0, -1, device=x.device, dtype=torch.float32)
    key = (x == kth) * rank
    key.masked_fill_(x > kth, float(n + 1))
    sel = torch.topk(key, k, dim=-1, sorted=False).indices.sort(dim=-1).values
    vals = torch.gather(x, -1, sel)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(sel, -1, order)


class Trainer:
    def __init__(self, config, dataload, device=None, dtype=torch.bfloat16):
        """``device``: None for the card (raises if there is none), or an
        explicit device such as "cpu". ``dtype``: the trunk's compute type."""
        self.config = config
        self.dataload = dataload
        self.device = resolve_device(device)
        self.model = build_model(config, dataload, dtype=dtype).to(self.device)
        self.model.eval()
        self.collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.eval_pred_len = config["eval_pred_len"]
        self.metrics_pred_len_list = config["metrics_pred_len_list"]
        self.suppress_history = config.get("suppress_history", True)
        self.item_chunk_size = int(config.get("eval_item_chunk_size", 131072))
        self.results_rows: list = []

    # ------------------------------------------------------------------
    def setup_model(self, seed: Optional[int] = None):
        """Random parameter initialisation from ``seed`` (default
        ``config["seed"]``) with an explicit generator on the model's
        device."""
        seed = int(seed if seed is not None else (self.config["seed"] or 0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.init_parameters(gen)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Trainable parameters: %d", n_params)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def compute_item_feature(self):
        """Corpus item embeddings: the normalized item table (reference
        compute_item_feature, ID-model branch)."""
        return self.model.compute_item_all()

    @torch.no_grad()
    def evaluate(self, eval_batcher, load_best_model: bool = False):
        if load_best_model:
            # checkpoints come with the training slice, so none exists yet
            logger.warning("no checkpoint found; evaluating current params")
        for key in ("rec.meanrank", "rec.score", "rec.tgt_score"):
            if self.collector.register.need(key):
                raise NotImplementedError(
                    f"metrics needing {key} (GAUC / VALUE / raw scores) are not ported yet")
        if str(self.config.get("host_item_table", "auto")) in ("True", "true"):
            raise NotImplementedError("host_item_table is not ported yet")
        if self.config.get("save_for_eval") or self.config.get("log_detailed_results"):
            raise NotImplementedError("save_for_eval / log_detailed_results are not ported yet")
        self.collector.set_logit_scale(self._eval_logit_scale())
        item_feats = self.compute_item_feature()
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
                eval_batcher, item_feats, item_tags, top_k):
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

    def _device_topk_results(self, eval_batcher, item_feats, item_tags, top_k):
        """Per-batch predict + streamed top-k. One-deep pipelining: batch
        i's results are copied to the host as soon as its work is enqueued,
        then batch i+1's work is enqueued, and only then does the host wait
        for batch i's copies — so the card computes batch i+1 while the
        collector runs on batch i."""

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
            pe = self.model.predict_embeddings(dev["item_seq"], dev["target_tags"])
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
