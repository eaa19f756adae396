#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mhrec_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile | --train-only | --stu-bwd-ab | --image-only |
                           --image-fit | --baselines-only | --distributed-only |
                           --reference-only]

Builds the port's CUDA kernels from ``mhrec_tpu_torch/csrc`` (one ``nvcc``
per source, in parallel) and holds each against its plain PyTorch version on
the card: the forward kernels of the fused STU block and of the pointwise
attention, their backward kernels, the row-sparse AdamW, and the packed
segment attention of the HLLM item tower, forward (with its log-sum-exp)
and backward (at the corpus shape: 16 chunk rows of 2048 tokens, 32 heads
over 4 KV heads of width 64, band 257, segments of 1-257 tokens and
trailing padding; also timed against ``scaled_dot_product_attention`` with
the same mask, forward and backward, which the port never calls, and alone
at the train step's 72 chunk rows). The bfloat16 routes of the fused STU
block and of the pointwise attention, and of the packed attention, forward
and backward, run their products on the tensor cores (``mma.sync``); each
kernel phase names the route it took and fails a bfloat16 HSTU kernel that
did not take the tensor cores, and the pointwise attention's forward (at
the serving shape too) and both HSTU backward kernels are also timed on
their CUDA-core route and split by the kernels a call runs
(``torch.profiler``). Then it
drives the port's two HSTU paths on the paper's headline model — HSTU
size4 (1024d, 16 layers, 16 heads, window 50) with 8-category prior heads,
4 segment heads, additive interaction and the prior switch — over 4096 users and a 200,000-item catalog, with random weights
from seed 0:

* serving (``run.serve``, what ``run.py --val_only True`` runs): the test
  split evaluated, kernel A launched 64 times; two more passes run one eval
  batch with ``attn_impl: pallas`` (through the pointwise attention kernel)
  and ``attn_impl: xla`` (the plain path, no kernel), hold each against
  the serve path's embeddings of that batch, and time that batch's
  ``predict_embeddings`` under each and under ``auto`` (kernel A);
* training (``run.train``, what ``run.py`` runs without ``--val_only``): 30
  steps of the reproduce script's prior protocol at batch 64 with 8192
  negatives, ``sparse_item_adam`` and dropout 0.2, an evaluation of the valid
  split with a best-checkpoint save (under a temporary directory), and the
  test split evaluated from that checkpoint; kernel A runs 16 times forward
  and 16 times backward per step and ``row_adamw`` once. A last pass takes
  one batch through ``attn_impl: pallas`` and ``xla`` and holds the loss and
  (on a float32 copy of the model) the gradients against ``auto``'s, each
  bfloat16 route's gradients against the float32 copy's, and one
  row update of ``sparse_adam_impl: xla`` (the plain version) against the
  kernel's.

and the HLLM serving path (``run.serve`` with ``model: HLLM``) as
``reproduce/HLLM-EBNerd-prior.sh`` sets it up: TinyLlama-1.1B item and user
towers (2048 wide, 32 heads over 4 KV heads, SwiGLU 5632, vocab 32000; the
``config.json`` of ``tools/dryrun_hllm_1b.py`` cut from 22 to HLLM_LAYERS
(6) layers, written to a temporary directory, random weights from seed 0), hierarchical prior heads
(11 categories × 2 segment heads, one medusa layer, segment embeddings),
``pred_len`` 4, ``eval_pred_len`` 8, windows of 24 items, texts of up to 256
tokens, the packed item tower and the packed corpus pass, over HLLM_USERS
(512) users and a catalog of HLLM_ITEMS (4,096) in-memory texts
(``train_batch_size`` 128, so a corpus batch holds 3,072 items and the pass
runs 2 of them, each launching
``packed_attn_fwd`` once per layer). Its evaluation is repeated and must give
the same metrics. A last pass takes the first corpus batch through the dense
padded item tower (no kernel) and holds its item embeddings to the packed
route's, in bfloat16 and on a float32 copy of the model (the copy on the
batch's first 768 items). Cuts against the script: the catalog (EB-NeRD has
more items), random tower weights instead of the TinyLlama checkpoints, the
synthetic texts' keys (title, tag, description) instead of EB-NeRD's,
``log_detailed_results`` off, no image tower, and the data-loader knobs of
the parquet reader (``tag_version``, ``min_seq_len``, ``cluster_as_tag``),
which the in-memory data does not read.

Then the HLLM training path (``run.train`` with ``model: HLLM``) on the same
towers, heads and catalog with the script's training flags: learning rate
1e-4, the weighted prior loss with negatives drawn per category, gradient
checkpointing, the packed item tower; ``train_batch_size`` 8 with 64
negatives (8 a sample for each of the 12 pools, as the script's 4096 over
its global batch of 512), so a step encodes 992 items (about 138k tokens in
about 72 chunk rows of 2048) and launches ``packed_attn_fwd`` twice per
item-tower layer (the forward and its recompute) and ``packed_attn_bwd``
once; HLLM_TRAIN_STEPS steps, an evaluation of the valid split with a best-checkpoint save
(parameters and AdamW moments, about 24 GB, under a temporary directory),
and the test split evaluated from that checkpoint. Cuts against the script:
the batch (it runs 32 a card on 16 cards), the steps (3000), and as above
the catalog, the weights and the texts' keys. A last pass takes one batch
of 2 sequences (248 items) through the packed route (the kernels forward and
backward) and the dense padded route (no kernel): on a float32 model of 2
layers at TinyLlama's widths, the loss and every gradient; on the trained
bfloat16 model, the loss.

Four phases drive the evaluation outputs and modes and gradient
accumulation: ``eval_outputs`` evaluates the serving trainer again with
``log_detailed_results`` and ``save_for_eval`` on, into a temporary
directory (the metrics must equal the plain evaluation's, one dump per eval
batch, the saved top-k equal to the streamed one); ``eval_streamed_metrics``
evaluates it with GAUC, AUC, MAE, RMSE and LogLoss (the streamed rank
counts and target scores), timed over every user, and holds the first
FULL_SCORE_USERS users to the full-score path; ``train_accum`` trains size4
as the train phase does with ``accumulate_grad`` 8 (the scripts' global
batch of 512) for 4 optimizer steps, checking that nothing moves before a
boundary, that the deduped union of the row blocks is unique and that the
kernel's row update on it equals the plain version's; ``hllm_host_table``
evaluates the HLLM serving trainer with its corpus table in host memory
against the device table, then times the host-table scoring alone over a
600,000 × 2048 table, which ``auto`` must choose by itself. Each path's
launches are counted from 0 just before it (``path_launches``).

Four phases drive HLLM towers loaded from local checkpoints, their
tokenizer and the HLLM training levers, in a work directory of their own. ``hllm_pretrained``
writes a TinyLlama-1.1B-shaped checkpoint (seed 0, bfloat16, two
``.safetensors`` shards and an index, about 2.2 GB, by ``write_safetensors``,
this script's own header writer), points both pretrain directories at it and
serves (``hllm_config``, over a catalog of PRETRAINED_ITEMS items and
PRETRAINED_USERS users, through hllm_serve_phase's checks) and trains
(``hllm_train_config``, PRETRAINED_TRAIN_STEPS steps and the test split);
every loaded tensor must equal the written one bit for bit, and a 2-layer
cut of the weights as ``.safetensors`` and as ``pytorch_model.bin`` must give
equal item embeddings. ``hllm_train_levers`` takes that trained model: a
synchronous against an asynchronous best-checkpoint save (the loop's blocked
seconds, the writer's, the host copy's bytes; a train step runs during the
write; both files equal tensor for tensor), ``remat_policy`` ``full``
against ``dots`` (steady examples/s and peak memory at LEVERS_BATCH
sequences, 44 + 22 packed launches a step under both, one batch's gradients
equal), and ``adam_mu_dtype`` / ``adam_nu_dtype: bfloat16`` against the
fused AdamW (state bytes, peak memory). ``hllm_tokenizer`` links
hllm_pretrained's shards into a directory of their own and writes a
``tokenizer.json`` of TinyLlama's layout beside them
(``write_llama_tokenizer``: BPE with byte fallback and ``fuse_unk``, the
Prepend/Replace ▁ normalizer, a BOS template, 32,000 entries; a
``tokenizer_config.json`` naming ``LlamaTokenizer``), draws item texts with
accented Latin, CJK, emoji, digit runs and runs of spaces
(``tokenizer_item_table``), and tokenizes the corpus on the host with the
port's own reader (``data/hf_tokenizer.py``): load seconds, items/s and
tokens/s cold, warm and from the disk cache, every id below 32,000, the
repeats equal, the id lists' digest equal to TOKENIZER_DIGEST (what
``transformers`` gives on the CPU); then it serves and trains 3 steps
through that tokenizer (``packed_attn_fwd`` 44 a serve run, 44 and
``packed_attn_bwd`` 22 a train step). ``hllm_towers`` writes a
bert-base-uncased-shaped BERT and a Baichuan-13B-shaped ALiBi tower (2 of
its 40 layers) and has each serve a small catalog and train 2 steps on the
dense item tower (no kernel).

Two phases drive the vision and video item towers, last, each in a work
directory of its own; no kernel of the port runs on these paths (the image
span rides the dense item tower), which their launch counts record.
``hllm_image`` is ``reproduce/HLLM-Pixel8M-prior.sh``'s model at full
width: a Qwen2-VL-2B-Instruct item tower (its ``config.json``: the text
decoder and the 32-block vision tower) and a Qwen2.5-1.5B user tower, both
decoders cut to IMAGE_LLM_LAYERS (4) of their 28 layers,
random weights from seed 0, a Qwen2-VL-layout byte-level BPE
``tokenizer.json`` (``write_qwen2_tokenizer``: the vision tokens at their
ids) and 224 × 224 images (JPEGs of mixed native sizes the script writes
for most of IMAGE_ITEMS items; the rest missing or broken, which take the
black image), over IMAGE_USERS users: it serves (the warm corpus pass's items/s and
tokens/s, users/s, the vision tower's and the item LLM's seconds on a
corpus batch, the host's decode and patchify rate cold and from the LRU,
peak memory) and trains IMAGE_TRAIN_STEPS steps at IMAGE_TRAIN_BATCH
sequences with IMAGE_ADAM_MOMENTS Adam moments (the script: 8 a card with
f32 moments, which do not fit: ``--image-fit``), then an evaluation with
a best-checkpoint save and the test split from it (steady examples/s, the
busy share under the profiler, peak memory). ``hllm_image_variants`` runs
the other vision paths at full widths and 2 + 2 layers (2 vision blocks):
video from frame directories, dynamic resolution over images of mixed
sizes, and a CLIP-L/14 LLaVA tower with the fixed ``anyres_grid`` [2, 2]
and with dynamic AnyRes, each serving 256 items and training 2 steps, the
vision weights of two of them loaded from checkpoints it writes (equal to
the written tensors), each one's bf16 item embeddings held to a float32
copy's. ``--image-only`` runs these two phases alone, without the last
line.

Then ``baselines`` (after train_accum) drives the paper's five comparison
models through ``run.train`` and ``run.serve`` over the same users and
catalog, with ``sparse_item_adam``: ComiRec and REMI (hstu-size4's trunk,
1024 wide, 16 layers of 16 heads, in float32 as in the JAX package, 4
interests; REMI with ``lambda_rr`` 100 and ``beta_ihn`` 1) and DualVAE (a
1024-wide item table, 5 aspects of 32) with 8,192 shared negatives, SASRec
(512 wide, 2 layers of 4 heads) and LLMIDRec (a 512-wide item table
projected into a TinyLlama-1.1B user tower cut to 4 of its 22 layers, 2048 wide, random
from its ``config.json``) with per-position negatives, cut to the largest
of 1,024, 512 and 256 a position whose rows fit POSITION_NEG_BUDGET. Each
trains BASELINE_STEPS steps at batch 64 (an evaluation with a save, the
test split from it), serves from that checkpoint and once more warm
(equal metrics), and a second run from the seed repeats the first loss.
The phase holds #1 and #4 in float32 (ComiRec's route) at the serve and
train batches, and #7 at SASRec's step (D = 512) bit for bit against the
plain update; #1 launches 16 times a forward and #4 16 times a step on
ComiRec and REMI, #7 once a step on every family; see ``baselines_phase``.
``--baselines-only`` builds the kernels and runs this phase alone, without
the last line.

Then ``distributed`` (after train_accum) drives data parallelism over
``torch.distributed`` on HSTU size4 in the train phase's protocol (batch 64
a rank, 8,192 negatives a category in the global pool, an evaluation with
a save, the test split from it): (a) ``python -m mhrec_tpu_torch.run
--multihost`` as rank 0 of a one-rank NCCL group against the same CLI run
without a group, 10 steps (bit-equal losses, checksum and metrics
expected); (b) two ranks over gloo with both on the one card (NCCL refuses
two ranks on one device), the item table replicated and then row-sharded,
DIST_GLOO_STEPS steps of a float32 trunk, each held to the rank-order
oracle (one process that sums the ranks' partial gradients in rank order);
(c) two gloo ranks of HLLM; (d) the five baselines over two gloo ranks at
their widths, global batch 64, each held to its rank-order oracle; (e) the
row-sharded table at 500,000 items × 1024: no tensor of the whole table
on the card in either rank, and each phase's memory against a reference
run at 131,073 items; (f) FSDP / ZeRO-3: (b)'s HSTU under ``zero_stage: 3``
(the table row-sharded through FSDP's rule) and (c)'s HLLM under ``fsdp:
true``, each held to its oracle and to its ZeRO-2 run's checkpoint (bit for
bit), its persistent bytes a rank below the ZeRO-2 run's, no whole sharded
parameter or gradient alive after a step; see ``distributed_phase``.
``--distributed-only`` builds the kernels and runs this phase alone,
without the last line.

Before the train phase, ``reference_ckpt`` writes a reference-format
``full_model_fp32.pt`` of HSTU size4 over the serve catalog from seed 1
(DeepSpeed's ``{"state_dict": ...}`` with ``_forward_module.`` prefixes),
converts it with ``python -m mhrec_tpu_torch.convert_reference``'s entry
point and serves it with ``run``'s ``--val_only True`` (#1 64 times); its
metrics must equal those of the same tensors loaded straight into the
model. ``--reference-only`` builds the kernels and runs it alone.

Then ``hstu_1b`` (after the baselines, before the HLLM ones) runs
the largest HSTU of the reference's ladder, hstu-1b (``IDNet/hstu-1b.yaml``:
22 layers, 2048 wide, 32 heads of 64) with ``scan_layers``, in the train
phase's prior protocol over the same users and catalog: it serves (#1 22
times an eval batch on its tensor-core route), serves again under
``matmul_precision: tensorfloat32``, and trains at batch 32 with a float32
table (fit, evaluation, best-checkpoint save, the test split from it; #4
22 times and #7 once a step), with a bfloat16 table (no #7 launch) and with
the stacked prior loss (timed in turns against the loop, and held to it on
one batch); see ``hstu_1b_phase``.

Prints one JSON object per line: the card's name and power limit, build
seconds, each kernel phase (error against tolerance; the kernel's and the
plain version's device times from ``torch.profiler``, each beside its wall
time ``host_ms``, and the bound), the serve, impl, eval_outputs,
eval_streamed_metrics, reference_ckpt, train, train-impl, train_accum, distributed,
baselines_<family> (five), hstu_1b_serve, hstu_1b_serve_tf32,
hstu_1b_train,
hstu_1b_train_bf16_table, hstu_1b_train_stacked, hllm_serve, hllm_impl, hllm_host_table, hllm_train,
hllm_train_impl, hllm_pretrained (with its hllm_pretrained_serve record),
hllm_train_levers, hllm_tokenizer (with its hllm_tokenizer_serve record),
hllm_towers, hllm_image (setup, serve, train) and hllm_image_variants
(with a serve record for each variant) phases, the seconds of each phase, each path's launches, a
``kernels`` summary, and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero without the last line. ``--profile`` adds phases that
run one evaluation of the test split, five train steps, one HLLM evaluation
and three HLLM train steps under ``torch.profiler`` and print device time
by kernel group and the top kernels. float32 products run in full float32:
TF32 is switched off for matmuls and cuDNN. ``--train-only`` builds the
kernels and runs the HSTU train phase alone, without the last line: a copy
of this script beside another tree's ``mhrec_tpu_torch`` (a parent commit
unpacked with ``git archive``) runs that tree's training, so two trees can
be timed in turns within one call. ``--stu-bwd-ab`` likewise builds the
kernels and times #4 (``hstu_stu_gated_bwd``) alone at the train step's
shape and at hstu-1b's width.
"""

from __future__ import annotations

import glob
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s, bf16 and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# tolerances of the kernel-vs-plain phases: float32 differs only in the order
# of sums; bfloat16 may also round the attention entries or the output one
# ulp apart (2^-8 relative), so it gets about three ulps. For the HSTU
# kernels atol is taken relative to each output's scale, atol · min(1,
# max |ref|) (kernel_phase): the pointwise attention divides by the window,
# so at L = 400 its outputs are about 0.01-0.15, and a fixed atol of 0.02 is
# as large as they are
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)

# the paths with another attention route round the bf16 trunk at other
# places over 16 layers: unit-norm embeddings (max abs) and the loss must
# still agree to this. Gradients are compared on a float32 copy of the
# model, where the routes differ only in the order of sums and in the
# bfloat16 logit tables of the loss: each gradient tensor to a relative L2
# error of F32_GRAD_TOL. bfloat16 gradients of the early layers differ by
# tens of percent between routes at 16 layers, but every bf16 route (auto,
# pallas, xla) lies about as far from the float32 copy's gradients
# (train_impl's bf16_vs_f32_auto, PERF.md §7): rounding noise grown through
# the backward, so they are reported and not held to a bound
IMPL_TOL = 5e-2
F32_GRAD_TOL = 1e-2

TRAIN_STEPS = 30

# the HLLM training phase: sequences a step and steps
HLLM_TRAIN_BATCH = 8
# the HLLM serving and training phases' users and in-memory catalog
# (4,096 and 16,384 until the distributed phase joined the script, 2,048 and
# 8,192 until its HLLM run joined it, 1,024 users until its baselines and
# sharded-table runs joined it: depth cuts; hllm_impl_phase takes a whole
# corpus batch of 3,072 items)
HLLM_USERS = 512
HLLM_ITEMS = 4096
# the towers' layers in those phases: TinyLlama-1.1B's 22 until the
# distributed phase's baselines and sharded-table runs joined the script,
# whose scratch files moved to /dev/shm, 11 until its FSDP runs and the
# reference-checkpoint phase joined it (depth cuts)
HLLM_LAYERS = 6
# 10 until the distributed phase joined the script, 4 until its baselines
# and sharded-table runs joined it (depth cuts)
HLLM_TRAIN_STEPS = 3
# chunk rows of 2048 tokens that a train step's 992 items pack into
HLLM_TRAIN_CHUNK_ROWS = 72

# the HLLM item embeddings of the dense padded and the packed item tower,
# unit-normalized, max abs difference: in bfloat16 the two routes round at
# other places over 22 layers (IMPL_TOL, as for the HSTU routes); in
# float32 they differ only in the order of sums
HLLM_F32_TOL = 1e-4

# TinyLlama-1.1B's topology (tools/dryrun_hllm_1b.py:36-47), the towers of
# reproduce/HLLM-EBNerd-prior.sh
TINYLLAMA_1B = {
    "model_type": "llama", "vocab_size": 32000, "hidden_size": 2048,
    "intermediate_size": 5632, "num_hidden_layers": 22, "num_attention_heads": 32,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "max_position_embeddings": 2048,
}

# the packed attention's corpus shape: chunk rows, tokens a row, heads, KV
# heads, head width, band (MAX_TEXT_LENGTH + the emb slot)
PACKED_SHAPE = (16, 2048, 32, 4, 64, 257)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time of one call of ``fn`` between CUDA events around ``iters``
    calls: the device's time, or the host's where launching the calls takes
    longer than running them."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the durations of the kernels,
    copies and sets that ``iters`` calls run on the card, from
    ``torch.profiler`` (the gaps between launches left out), per call. A
    trace without device events (now and then one comes back so) is taken
    again, twice at most; then it raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("device_ms: the profiler's traces held no device time")


def timings(fns, iters: int = 20, warmup: int = 3):
    """{name: (device ms, host ms)} of each named call in ``fns``: the
    host's wall times taken in turns (each name twice, the order reversed
    the second time), the device's from ``device_ms``."""
    names = list(fns)
    host = {n: [] for n in names}
    for n in names + names[::-1]:
        host[n].append(cuda_ms(fns[n], iters=iters, warmup=warmup))
    return {n: (device_ms(fns[n], iters=min(iters, 10), warmup=warmup), min(host[n]))
            for n in names}


def excess_error(outs, refs, dtype_name, scaled=False):
    """(max |out - ref|, max of |out - ref| - (atol·scale + rtol·|ref|))
    over one output or a tuple of them, scale = min(1, max |ref|) of each
    output where ``scaled``, else 1; the second is ≤ 0 when every element
    is within tolerance."""
    import torch

    if isinstance(outs, torch.Tensor):
        outs, refs = (outs,), (refs,)
    atol, rtol = TOL[dtype_name]
    err = excess = float("-inf")
    for out, ref in zip(outs, refs):
        r = ref.float().abs()
        d = (out.float() - ref.float()).abs()
        err = max(err, float(d.max()))
        scale = min(1.0, float(r.max())) if scaled and r.numel() else 1.0
        excess = max(excess, float((d - (atol * scale + rtol * r)).max()))
    return err, excess


def ref_scale(refs):
    """max |ref| of one output or of each of a tuple of them."""
    import torch

    if isinstance(refs, torch.Tensor):
        return float(refs.float().abs().max())
    return [float(r.float().abs().max()) for r in refs]


def make_nonpad(B, L, gen, device):
    """Left-padded windows as eval builds them: row 0 full, row 1 all
    padding, the rest a random number of leading pad items."""
    import torch

    lens = torch.randint(1, L + 1, (B,), generator=gen, device="cpu")
    lens[0] = L
    if B > 1:
        lens[1] = 0
    pos = torch.arange(L)
    return (pos[None, :] >= (L - lens)[:, None]).to(device)


def kernel_inputs(kind, B, L, H, d, dtype, seed):
    """Random inputs of one kernel at one shape. Kernel A's q/k/v/u are the
    strided splits of one [B, L, 4·H·d] projection, as in the STU layer; the
    backward kinds add the output gradient g."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nonpad = make_nonpad(B, L, gen, dev)
    if kind in ("stu", "stu_bwd"):
        F = H * d
        mixed = torch.randn(B, L, 4 * F, generator=gen).mul_(0.5).to(dev, dtype)
        u, v, q, k = torch.split(mixed, [F, F, F, F], dim=-1)
        gamma = (1 + 0.1 * torch.randn(F, generator=gen)).to(dev)
        beta = (0.05 * torch.randn(F, generator=gen)).to(dev)
        if kind == "stu":
            return (q, k, v, u, gamma, beta, nonpad, H)
        g = torch.randn(B, L, F, generator=gen).to(dev, dtype)
        return (q, k, v, u, gamma, beta, nonpad, g, H)
    q, k, v = (torch.randn(B, H, L, d, generator=gen).mul_(0.5).to(dev, dtype)
               for _ in range(3))
    if kind == "attn":
        return (q, k, v, nonpad)
    g = torch.randn(B, H, L, d, generator=gen).to(dev, dtype)
    return (q, k, v, g, nonpad)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound_ms(kind, args):
    """Least time the card could take: the larger of bytes moved (each
    input read once, each output written once) over HBM bandwidth and the
    operations over the peak rate of the input type. Attention flops count
    the causal (key ≤ query) pairs: 2·d per product per pair — two products
    forward (q·kᵀ, A·v); the backward recomputes the first two and adds
    g·vᵀ, Aᵀ·g, ds·k and dsᵀ·q."""
    if kind in ("stu", "stu_bwd"):
        q, k, v, u, gamma, beta, nonpad = args[:7]
        H = args[-1]
        B, L, F = v.shape
        dqk, dv = q.shape[-1] // H, F // H
        pairs = B * H * L * (L + 1) // 2
        if kind == "stu":
            nbytes = _nbytes(q, k, v, u, gamma, beta, nonpad) + B * L * F * q.element_size()
            flops = 2 * pairs * (dqk + dv) + 10 * B * L * F
        else:  # + g in; dq, dk, dv, du, dγ, dβ out
            nbytes = _nbytes(q, k, v, u, gamma, beta, nonpad, args[7], q, k, v, u, gamma, beta)
            flops = 2 * pairs * (3 * dqk + 3 * dv) + 20 * B * L * F
    else:
        q, k, v = args[:3]
        nonpad = args[-1]
        B, H, L, d = q.shape
        pairs = B * H * L * (L + 1) // 2
        if kind == "attn":
            nbytes = _nbytes(q, k, v, nonpad, v)
            flops = 2 * pairs * (d + v.shape[-1])
        else:  # + g in; dq, dk, dv out
            nbytes = _nbytes(q, k, v, args[3], nonpad, q, k, v)
            flops = 2 * pairs * (3 * d + 2 * v.shape[-1])
    return _bound(nbytes, flops, PEAK_FLOPS[str(q.dtype).replace("torch.", "")])


KERNELS = {
    "stu": dict(
        name="hstu_stu_gated_fwd", source="mhrec_tpu_torch/csrc/hstu_stu_gated_fwd.cu",
        replaces="mhrec_tpu/ops/pallas/hstu_attention_tpu.py:497",
        products="bf16: tensor cores, mma.sync m16n8k16; f32: CUDA cores",
    ),
    "attn": dict(
        name="hstu_attn_fwd", source="mhrec_tpu_torch/csrc/hstu_attn_fwd.cu",
        replaces="mhrec_tpu/ops/pallas/hstu_attention_tpu.py:269",
        products="bf16: tensor cores, mma.sync m16n8k16; f32: CUDA cores",
    ),
    "stu_bwd": dict(
        name="hstu_stu_gated_bwd", source="mhrec_tpu_torch/csrc/hstu_stu_gated_bwd.cu",
        replaces="mhrec_tpu/ops/pallas/hstu_attention_tpu.py:537",
        products="bf16: tensor cores, mma.sync m16n8k16; f32: CUDA cores",
    ),
    "attn_bwd": dict(
        name="hstu_attn_bwd", source="mhrec_tpu_torch/csrc/hstu_attn_bwd.cu",
        replaces="mhrec_tpu/ops/pallas/hstu_attention_tpu.py:307",
        products="bf16: tensor cores, mma.sync m16n8k16; f32: CUDA cores",
    ),
    "row_adamw": dict(
        name="row_adamw", source="mhrec_tpu_torch/csrc/row_adamw.cu",
        replaces="mhrec_tpu/ops/pallas/row_adam_tpu.py:231",
        products="CUDA cores",
    ),
    "packed": dict(
        name="packed_attn_fwd", source="mhrec_tpu_torch/csrc/packed_attn_fwd.cu",
        replaces="mhrec_tpu/models/llm/packed.py:45",
        products="bf16: tensor cores, mma.sync m16n8k16; f32: CUDA cores",
    ),
    "packed_bwd": dict(
        name="packed_attn_bwd", source="mhrec_tpu_torch/csrc/packed_attn_bwd.cu",
        # _splash_call's backward: _splash_attention_bwd_dq (pallas_call at
        # jax/experimental/pallas/ops/tpu/splash_attention/
        # splash_attention_kernel.py:1635) and _splash_attention_bwd_dkv (:2196)
        replaces="mhrec_tpu/models/llm/packed.py:45",
        products="bf16: tensor cores, mma.sync m16n8k16; f32: CUDA cores",
    ),
}


def kernel_fns(kind):
    from mhrec_tpu_torch.ops import hstu_attention_cuda as K

    return {
        "stu": (K.hstu_stu_gated_fwd, K.hstu_stu_gated_fwd_plain),
        "attn": (K.hstu_attn_fwd, K.hstu_attn_fwd_plain),
        "stu_bwd": (K.hstu_stu_gated_bwd, K.hstu_stu_gated_bwd_plain),
        "attn_bwd": (K.hstu_attn_bwd, K.hstu_attn_bwd_plain),
    }[kind]


def kernel_route(kind, dtype, L, H, d):
    """The route the wrapper of ``kind`` takes on these inputs, where it has
    more than one (bfloat16: tensor cores; float32: CUDA cores)."""
    from mhrec_tpu_torch.ops import hstu_attention_cuda as K

    if kind == "stu":
        return K.stu_gated_fwd_route(dtype, L, H, d, d)
    if kind == "stu_bwd":
        return K.stu_gated_bwd_route(dtype, L, H, d, d)
    if kind == "attn":
        return K.attn_fwd_route(dtype, L, d, d)
    if kind == "attn_bwd":
        return K.attn_bwd_route(dtype, L, d, d)
    return None


def kernel_phase(kind, shape_name, B, L, H, d, dtype, seed=0):
    """Compare one kernel with its plain version on the card (within TOL,
    atol scaled to each output's max |ref|), time both (plain, kernel,
    kernel, plain) and compute the bound. A pointwise
    attention kernel or STU backward kernel whose bfloat16 route runs on
    the tensor cores is also timed on its CUDA-core route
    (``cuda_core_ms``), so that the two designs are compared in one call on
    one card. Times are the device's (``device_ms``), each beside its wall
    time (``host_ms``: plain, kernel, kernel, plain). The
    comparison and timing launches are counted outside the main paths'
    runs."""
    import torch

    fn, plain = kernel_fns(kind)
    args = kernel_inputs(kind, B, L, H, d, dtype, seed)
    out = fn(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    dname = str(dtype).replace("torch.", "")
    err, excess = excess_error(out, ref, dname, scaled=True)
    outs = out if isinstance(out, tuple) else (out,)
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    rec = {"phase": "kernel", "kernel": KERNELS[kind]["name"], "shape": shape_name,
           "B": B, "L": L, "H": H, "d": d, "dtype": dname, "max_abs_err": err,
           "atol": TOL[dname][0], "rtol": TOL[dname][1], "ref_max_abs": ref_scale(ref),
           "excess": excess, "ok": finite and excess <= 0}
    route = kernel_route(kind, dtype, L, H, d)
    if route is not None:
        rec["route"] = route
    fns = {"plain": lambda: plain(*args), "kernel": lambda: fn(*args)}
    if kind in ("attn", "stu_bwd", "attn_bwd") and route == "tensor_cores":
        fns["cuda_core"] = lambda: fn(*args, route="cuda_cores")
    t = timings(fns)
    # device times; the host's wall times beside them (host_ms)
    (rec["ms"], rec["host_ms"]), (rec["plain_ms"], rec["plain_host_ms"]) = t["kernel"], t["plain"]
    if "cuda_core" in t:
        rec["cuda_core_ms"], rec["cuda_core_host_ms"] = t["cuda_core"]
    rec["bound_ms"], rec["bound_by"] = bound_ms(kind, args)
    emit(rec)
    return rec


def kernel_breakdown(kind, shape_name, B, L, H, d, dtype, iters=20, seed=0, **kw):
    """Device time of one wrapper call split by the CUDA kernels it runs
    (its own launches, and the copies and reductions around them), from
    ``torch.profiler`` over ``iters`` calls after a warm one; ms per call.
    ``kw`` goes to the wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn, _ = kernel_fns(kind)
    args = kernel_inputs(kind, B, L, H, d, dtype, seed)
    fn(*args, **kw)
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args, **kw)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = e.time_range.end - e.time_range.start
                by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + us / 1e3 / iters
        if by_name:
            break
    rec = {"phase": "kernel_breakdown", "kernel": KERNELS[kind]["name"], "shape": shape_name,
           "B": B, "L": L, "H": H, "d": d, "dtype": str(dtype).replace("torch.", ""), **kw,
           "ms_per_call": by_name, "device_ms_per_call": sum(by_name.values())}
    emit(rec)
    return rec


def row_adamw_phase(N=200_000, D=1024, U=77_824, n_real=65_000, seed=0):
    """The row-sparse AdamW kernel against its plain version at the train
    phase's table and id block: a [200000, 1024] f32 table with its moments,
    77,824 id slots (the prior protocol's unique-id block) of which the
    first 65,000 are real and the rest pad slots. The kernel must equal the
    plain update bit for bit on p, m and v. Times are per update in place."""
    import torch

    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(N, D, device=dev, generator=gen)
    m = 0.01 * torch.randn(N, D, device=dev, generator=gen)
    v = 0.01 * torch.rand(N, D, device=dev, generator=gen)
    ids = torch.full((U,), -1, dtype=torch.long, device=dev)
    ids[:n_real] = torch.randperm(N, device=dev, generator=gen)[:n_real]
    g = torch.randn(U, D, device=dev, generator=gen)
    cfg = SparseAdamConfig(weight_decay=0.01)
    ker = [t.clone() for t in (table, m, v)]
    ref = [t.clone() for t in (table, m, v)]
    row_adamw(*ker, ids, g, 1e-4, 7, cfg)
    sparse_adamw_row_update(*ref, ids, g, 1e-4, 7, cfg)
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(a, b)) for a, b in zip(ker, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(ker, ref))
    moved = bool((ker[0][ids[:n_real]] != table[ids[:n_real]]).any())
    untouched = torch.ones(N, dtype=torch.bool, device=dev)
    untouched[ids[:n_real]] = False
    kept = bool(torch.equal(ker[0][untouched], table[untouched]))
    del ref
    t = timings({"kernel": lambda: row_adamw(*ker, ids, g, 1e-4, 7, cfg),
                 "plain": lambda: sparse_adamw_row_update(*ker, ids, g, 1e-4, 7, cfg)}, iters=10)
    nbytes = 7 * 4 * n_real * D + ids.numel() * ids.element_size()
    bound, bound_by = _bound(nbytes, 16 * n_real * D, PEAK_FLOPS["float32"])
    rec = {"phase": "kernel", "kernel": "row_adamw", "N": N, "D": D, "U": U, "real_ids": n_real,
           "bit_equal": equal, "max_abs_err": err, "rows_moved": moved,
           "untouched_rows_kept": kept, "ms": t["kernel"][0], "host_ms": t["kernel"][1],
           "plain_ms": t["plain"][0], "plain_host_ms": t["plain"][1], "bound_ms": bound, "bound_by": bound_by, "ok": equal and moved and kept}
    emit(rec)
    return rec


def packed_inputs(C, S, H, Hkv, dh, window, dtype, seed=0):
    """q/k/v and segment ids packed as ``pack_items`` packs a corpus batch:
    from the start of each chunk row, segments of 1..window tokens (an
    item's text and its emb slot) until the row is at least half full, then
    trailing padding."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    seg = torch.zeros(C, S, dtype=torch.int32)
    sid = 0
    for c in range(C):
        off, fill = 0, int(torch.randint(S // 2, S + 1, (1,), generator=gen))
        while True:
            n = int(torch.randint(1, window + 1, (1,), generator=gen))
            if off + n > fill:
                break
            sid += 1
            seg[c, off:off + n] = sid
            off += n
    dev = torch.device("cuda")
    q = (0.5 * torch.randn(C, S, H, dh, generator=gen)).to(dev, dtype)
    k, v = ((0.5 * torch.randn(C, S, Hkv, dh, generator=gen)).to(dev, dtype) for _ in range(2))
    return q, k, v, seg.to(dev)


def packed_pairs(seg, window: int) -> int:
    """(query, key) pairs the packed attention computes on these segments:
    token t of a segment sees min(t, window) + 1 keys."""
    import torch

    flat = seg.flatten().cpu()
    ids, counts = torch.unique_consecutive(flat, return_counts=True)
    n = counts[ids > 0].long()
    w = int(window)
    full = torch.clamp(n, max=w + 1)  # tokens before the band fills
    return int((full * (full + 1) // 2 + (n - full) * (w + 1)).sum())


def packed_mask(seg, window: int):
    """[C, 1, S, S] bool: key j ≤ query i, same segment > 0, i − j ≤ window."""
    import torch

    S = seg.shape[1]
    idx = torch.arange(S, device=seg.device)
    band = (idx[:, None] >= idx[None, :]) & (idx[:, None] - idx[None, :] <= window)
    same = (seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, None, :]
    return (same & band)[:, None]


def packed_kernel_phase(dtype, seed=0):
    """``packed_attn_fwd`` against its plain version at the corpus shape on
    real tokens (padding rows must be zeros), its times (plain, kernel,
    kernel, plain), its bound from this run's segments, and one
    ``scaled_dot_product_attention`` call with the same boolean mask and
    ``enable_gqa`` as the library's time. ``route`` names the kernel the
    input type selects (bfloat16: tensor cores; float32: CUDA cores);
    ``band_tflops`` is the band's 4·dh flops a pair and head over the
    kernel's time; in bfloat16 ``train_rows`` times the kernel alone at the
    train step's chunk rows (``packed_fwd_train_rows``)."""
    import torch
    import torch.nn.functional as F

    from mhrec_tpu_torch.models.llm.packed import packed_attention_plain, packed_lse_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    C, S, H, Hkv, dh, w = PACKED_SHAPE
    q, k, v, seg = packed_inputs(C, S, H, Hkv, dh, w, dtype, seed)
    out, lse = packed_attn_fwd(q, k, v, seg, w, return_lse=True)
    torch.cuda.synchronize()
    ref = packed_attention_plain(q, k, v, seg, w)
    real = seg > 0
    dname = str(dtype).replace("torch.", "")
    err, excess = excess_error(out[real], ref[real], dname)
    pads_zero = not bool(out[~real].any())
    finite = bool(torch.isfinite(out).all())
    # the log-sum-exp the training path saves: float32 whatever the inputs
    lse_ref = packed_lse_plain(q, k, seg, w).transpose(1, 2)
    lse = lse.transpose(1, 2)
    lse_err, lse_excess = excess_error(lse[real], lse_ref[real], "float32")
    lse_pads = bool((lse[~real] == -math.inf).all())
    mask = packed_mask(seg, w)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    t = timings({"kernel": lambda: packed_attn_fwd(q, k, v, seg, w),
                 "plain": lambda: packed_attention_plain(q, k, v, seg, w)}, iters=10)
    try:  # a yardstick only: the port never calls it
        lib_err = float((library().transpose(1, 2)[real].float() - ref[real].float()).abs().max())
        (lib_ms, lib_host_ms), lib_note = timings({"lib": library}, iters=10)["lib"], None
    except RuntimeError as exc:
        lib_err = lib_ms = lib_host_ms = None
        lib_note = str(exc)[:300]
    pairs = packed_pairs(seg, w)
    bound, bound_by = _bound(_nbytes(q, k, v, seg, q), 4 * dh * H * pairs,
                             PEAK_FLOPS[dname])
    ms = t["kernel"][0]
    train_rows = packed_fwd_train_rows(ms / pairs, seed) if dtype == torch.bfloat16 else None
    rec = {"phase": "kernel", "kernel": "packed_attn_fwd", "shape": "corpus", "C": C, "S": S,
           "H": H, "Hkv": Hkv, "dh": dh, "window": w, "dtype": dname,
           # bfloat16 runs the tensor-core kernel, float32 the CUDA-core one
           "route": "tensor_core" if dtype == torch.bfloat16 else "cuda_core",
           "band_tflops": 4 * dh * H * pairs / ms / 1e9, "train_rows": train_rows,
           "real_tokens": int(real.sum()), "pairs": pairs, "max_abs_err": err,
           "atol": TOL[dname][0], "rtol": TOL[dname][1], "pad_rows_zero": pads_zero,
           "ms": ms, "host_ms": t["kernel"][1], "plain_ms": t["plain"][0],
           "plain_host_ms": t["plain"][1], "bound_ms": bound, "bound_by": bound_by,
           "library_ms": lib_ms, "library_host_ms": lib_host_ms,
           "library_max_abs_err": lib_err, "library_error": lib_note,
           "lse_max_abs_err": lse_err, "lse_pad_rows_neg_inf": lse_pads,
           "ok": finite and excess <= 0 and pads_zero and lse_excess <= 0 and lse_pads}
    emit(rec)
    return rec


def packed_fwd_train_rows(corpus_ms_per_pair, seed=0):
    """``packed_attn_fwd`` in bfloat16 alone at the HLLM train step's chunk
    rows (``HLLM_TRAIN_CHUNK_ROWS``, the rest of ``PACKED_SHAPE``): its time
    without and with the log-sum-exp (the train step asks for it), its band
    TFLOP/s, and its time per band pair over the corpus shape's, which says
    how much of a train-step launch's excess over the 16-row rate the kernel
    shows on its own."""
    import torch

    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    _, S, H, Hkv, dh, w = PACKED_SHAPE
    C = HLLM_TRAIN_CHUNK_ROWS
    q, k, v, seg = packed_inputs(C, S, H, Hkv, dh, w, torch.bfloat16, seed)
    ms = cuda_ms(lambda: packed_attn_fwd(q, k, v, seg, w), iters=10)
    ms_lse = cuda_ms(lambda: packed_attn_fwd(q, k, v, seg, w, return_lse=True), iters=10)
    pairs = packed_pairs(seg, w)
    return {"C": C, "ms": ms, "ms_with_lse": ms_lse, "pairs": pairs,
            "band_tflops": 4 * dh * H * pairs / ms / 1e9,
            "ms_per_pair_over_corpus": ms / pairs / corpus_ms_per_pair}


def packed_bwd_kernel_phase(dtype, seed=0):
    """``packed_attn_bwd`` against its plain version (torch's autograd of
    ``packed_attention_plain``) at the corpus shape, for a random cotangent
    that is zero on padding rows: dq, dk, dv within TOL everywhere, zeros on
    padding rows (dq) and keys (dk, dv), the same bits on a repeat. The
    reference is the plain version on the float32 values of the same inputs:
    the kernel keeps every product and sum in float32 and rounds dq, dk, dv
    once, while the plain version in bfloat16 also rounds the scores, the
    probabilities, dP and dS and the GQA sums to bfloat16 (its distance to
    the kernel is reported beside, per gradient). Times (plain, kernel,
    kernel, plain): the kernel's call, the plain version's forward and
    backward in the inputs' type; the library's is the backward alone of
    ``scaled_dot_product_attention`` with the same mask and ``enable_gqa``
    (``torch.autograd.grad`` on a kept graph). The bound: q, k, v, the
    output, its cotangent and lse read once, dq, dk, dv written once,
    against 10·dh flops per (pair, head) of this run's band (the scores and
    dP recomputed, dq, dk and dv: 2.5 times the forward's); ``band_tflops``
    is that work over the kernel's time. ``route`` names the kernels that
    the input type selects (bfloat16: tensor cores; float32: CUDA cores),
    and in bfloat16 ``train_rows`` times the kernel alone at the train
    step's chunk rows (``packed_bwd_train_rows``)."""
    import torch
    import torch.nn.functional as F

    from mhrec_tpu_torch.models.llm.packed import packed_attn_bwd_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    C, S, H, Hkv, dh, w = PACKED_SHAPE
    q, k, v, seg = packed_inputs(C, S, H, Hkv, dh, w, dtype, seed)
    real = seg > 0
    gen = torch.Generator(device=q.device).manual_seed(seed + 1)
    dout = (torch.randn(q.shape, generator=gen, device=q.device)
            * real[..., None, None]).to(dtype)
    out, lse = packed_attn_fwd(q, k, v, seg, w, return_lse=True)
    grads = packed_attn_bwd(q, k, v, out, dout, lse, seg, w)
    again = packed_attn_bwd(q, k, v, out, dout, lse, seg, w)
    torch.cuda.synchronize()
    repeat_equal = all(bool(torch.equal(a, b)) for a, b in zip(grads, again))
    del again
    dname = str(dtype).replace("torch.", "")
    ref = packed_attn_bwd_plain(*(x.float() for x in (q, k, v, dout)), seg, w)
    err, excess = excess_error(grads, ref, dname)
    per_grad = {n: excess_error(g, r, dname) for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    del ref
    if dtype != torch.float32:
        same = packed_attn_bwd_plain(q, k, v, dout, seg, w)
        for n, g, r in zip(("dq", "dk", "dv"), grads, same):
            per_grad[n] += excess_error(g, r, dname)
        del same
    zeros = not any(bool(g[~real].any()) for g in grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)

    def kernel():
        return packed_attn_bwd(q, k, v, out, dout, lse, seg, w)

    def plain():
        return packed_attn_bwd_plain(q, k, v, dout, seg, w)

    t = timings({"kernel": kernel, "plain": plain}, iters=5, warmup=1)
    lib_ms = lib_host_ms = lib_note = None
    try:  # a yardstick only: the port never calls it
        with torch.enable_grad():
            leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=packed_mask(seg, w),
                                                     enable_gqa=True)
            g = dout.transpose(1, 2)
            lib_ms, lib_host_ms = timings(
                {"lib": lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True)},
                iters=5, warmup=1)["lib"]
            del lib_out, leaves
    except RuntimeError as exc:
        lib_note = str(exc)[:300]
    pairs = packed_pairs(seg, w)
    nbytes = _nbytes(q, k, v, out, dout, lse, seg, *grads)
    bound, bound_by = _bound(nbytes, 10 * dh * H * pairs, PEAK_FLOPS[dname])
    ms = t["kernel"][0]
    train_rows = None
    if dtype == torch.bfloat16:
        del q, k, v, seg, out, dout, lse, grads
        train_rows = packed_bwd_train_rows(ms / pairs, dtype, seed)
    rec = {"phase": "kernel", "kernel": "packed_attn_bwd", "shape": "corpus", "C": C, "S": S,
           "H": H, "Hkv": Hkv, "dh": dh, "window": w, "dtype": dname,
           # bfloat16 runs the tensor-core kernels, float32 the CUDA-core ones
           "route": "tensor_core" if dtype == torch.bfloat16 else "cuda_core",
           "band_tflops": 10 * dh * H * pairs / ms / 1e9, "train_rows": train_rows,
           "real_tokens": int(real.sum()), "pairs": pairs, "max_abs_err": err,
           "atol": TOL[dname][0], "rtol": TOL[dname][1],
           # per gradient: (max abs error, excess over TOL) against the
           # float32 reference, then against the plain version in bfloat16
           "per_grad_err": per_grad, "pad_rows_and_keys_zero": zeros,
           "repeat_bit_equal": repeat_equal, "ms": ms, "host_ms": t["kernel"][1],
           "plain_ms": t["plain"][0], "plain_host_ms": t["plain"][1],
           "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
           "library_host_ms": lib_host_ms, "library_error": lib_note,
           "ok": finite and excess <= 0 and zeros and repeat_equal}
    emit(rec)
    return rec


def packed_bwd_train_rows(corpus_ms_per_pair, dtype, seed=0):
    """``packed_attn_bwd`` alone at the HLLM train step's chunk rows
    (``HLLM_TRAIN_CHUNK_ROWS``, the rest of ``PACKED_SHAPE``): its time, its
    band TFLOP/s, and its time per band pair over the corpus shape's, which
    says how much of a train-step launch's excess over the 16-row time the
    kernel shows on its own."""
    import torch

    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    _, S, H, Hkv, dh, w = PACKED_SHAPE
    C = HLLM_TRAIN_CHUNK_ROWS
    q, k, v, seg = packed_inputs(C, S, H, Hkv, dh, w, dtype, seed)
    gen = torch.Generator(device=q.device).manual_seed(seed + 1)
    dout = (torch.randn(q.shape, generator=gen, device=q.device)
            * (seg > 0)[..., None, None]).to(dtype)
    out, lse = packed_attn_fwd(q, k, v, seg, w, return_lse=True)
    ms = cuda_ms(lambda: packed_attn_bwd(q, k, v, out, dout, lse, seg, w), iters=5, warmup=1)
    pairs = packed_pairs(seg, w)
    return {"C": C, "ms": ms, "pairs": pairs, "band_tflops": 10 * dh * H * pairs / ms / 1e9,
            "ms_per_pair_over_corpus": ms / pairs / corpus_ms_per_pair}


def base_config(files=("IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"),
                **over):
    from mhrec_tpu_torch.config import Config

    return Config(config_file_list=list(files), config_dict=hstu_overrides(**over)).finalize()


def serve_config():
    return base_config(val_only=True)


def train_config(checkpoint_dir):
    """The reproduce script's prior protocol (reproduce/HSTU-Pixel8M-prior.sh)
    at the per-chip shape of BASELINE.md: batch 64, 8192 negatives drawn per
    category, the weighted prior loss, learning rate 1e-4 under the default
    cosine schedule, dropout 0.2 (hstu-size4.yaml), the row-sparse item-table
    AdamW; the switch classifier's loss at weight 0.1 so that its gradient
    runs."""
    return base_config(
        train_batch_size=64, num_negatives=8192, neg_sample_by_cat=True,
        weighted_prior_loss=True, prior_switch_loss_weight=0.1, sparse_item_adam=True,
        optim_args={"learning_rate": 1e-4, "weight_decay": 0.0},
        total_iters=TRAIN_STEPS, eval_interval=TRAIN_STEPS, update_interval=10,
        checkpoint_dir=checkpoint_dir)


def check_streamed_topk(trainer, batch, n_users=16):
    """The streamed top-k of a few users against a dense reference: full
    [n, H, I] masked scores, one stable descending sort."""
    import torch

    dev = trainer._eval_device_batch(batch)
    keep = dev["hist_r"] < n_users
    dev = {"item_seq": dev["item_seq"][:n_users], "target_tags": dev["target_tags"][:n_users],
           "hist_r": dev["hist_r"][keep], "hist_c": dev["hist_c"][keep]}
    feats = trainer.compute_item_feature()
    tags = torch.as_tensor(trainer.dataload.item_tag_matrix, device=trainer.device)
    top_k = max(trainer.config["topk"])
    pe = trainer.model.predict_embeddings(dev["item_seq"], dev["target_tags"])
    vals, idx = trainer._stream_score_topk(pe, feats, tags, dev, top_k)
    I = feats.shape[0]
    full = trainer._masked_chunk_scores(pe["head_embs"], pe.get("switch_pred"), feats, tags,
                                        dev["target_tags"], 0, I, dev["hist_r"], dev["hist_c"])
    ref_vals = torch.sort(full, dim=-1, descending=True, stable=True).values[..., :top_k]
    # the chunked and the dense products may round apart, so near-ties may
    # swap: the streamed values must match the dense top-k profile, and each
    # streamed index must carry its own dense score
    at_idx = torch.gather(full, -1, idx)
    finite = torch.isfinite(ref_vals)
    return (bool(torch.equal(finite, torch.isfinite(vals)))
            and float((vals - ref_vals)[finite].abs().max()) <= 1e-5
            and float((at_idx - vals)[finite].abs().max()) <= 1e-5)


def kernel_wrappers():
    from mhrec_tpu_torch.ops import kernel_wrappers as wrappers

    return wrappers()


def reset_launches():
    for fn in kernel_wrappers():
        fn.launches = 0


def read_launches():
    from mhrec_tpu_torch.ops import launch_counts

    return launch_counts()


def serve_phase(data):
    """The serving path: ``run.serve`` (what ``run.py --val_only True`` runs
    after loading data) with the launch counts set to 0 just before and read
    just after. ``serve_seconds`` is that call, set-up included, on a cold
    process; ``eval_seconds`` and ``users_per_s`` time a second, warm
    ``evaluate`` of the same split, which must give the same metrics."""
    import torch

    from mhrec_tpu_torch.run import serve

    config = serve_config()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, test_loader, result = serve(config, data)
    torch.cuda.synchronize()
    serve_seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    again = trainer.evaluate(test_loader)
    torch.cuda.synchronize()
    eval_seconds = time.perf_counter() - t0
    n_users = len(test_loader)
    values = [v for sec in result.values() for v in sec.values()]
    sane = (all(math.isfinite(v) for v in values)
            and all(0.0 <= result[f"pred_{p}"][m] <= 1.0 for p in config["metrics_pred_len_list"]
                    for m in result[f"pred_{p}"]))
    with torch.no_grad():
        topk_ok = check_streamed_topk(trainer, next(iter(test_loader.batches())))
    others = sum(n for k, n in launches.items() if k != "hstu_stu_gated_fwd")
    ok = (sane and topk_ok and again == result and launches["hstu_stu_gated_fwd"] == 64
          and others == 0 and "pred_7" in result and "shared" in result)
    emit({"phase": "serve", "users": n_users, "items": int(data.item_num),
          "serve_seconds": serve_seconds, "eval_seconds": eval_seconds,
          "users_per_s": n_users / eval_seconds, "peak_mem_gb": peak_gb,
          "launches": launches, "repeat_matches": again == result,
          "streamed_topk_matches_dense": topk_ok, "metrics": result, "ok": bool(ok)})
    return trainer, test_loader, launches, ok


def set_attn_impl(model, impl):
    for layer in model.stu_layers:
        layer.attn_impl = impl


def impl_phase(trainer, batch, impl):
    """One eval batch's predict_embeddings with another ``attn_impl``
    against the same batch through the serve path's fused kernel: 'pallas'
    takes the pointwise attention kernel (then LayerNorm and the gate in
    PyTorch), 'xla' the plain einsum path (a reference that runs neither
    kernel). Both are timed on that batch (``cuda_ms``, ``auto_cuda_ms``:
    auto, impl, impl, auto), after the launches are read."""
    import torch

    dev = trainer._eval_device_batch(batch)
    model = trainer.model

    def embed(which):
        set_attn_impl(model, which)
        try:
            return model.predict_embeddings(dev["item_seq"], dev["target_tags"])
        finally:
            set_attn_impl(model, "auto")

    with torch.no_grad():
        ref = embed("auto")
        reset_launches()
        pe = embed(impl)
        torch.cuda.synchronize()
        launches = read_launches()
        a1, i1, i2, a2 = (cuda_ms(lambda w=w: embed(w), iters=10)
                          for w in ("auto", impl, impl, "auto"))
    err = float((pe["head_embs"] - ref["head_embs"]).abs().max())
    cos = float((pe["head_embs"] * ref["head_embs"]).sum(-1).min())
    want_attn = len(trainer.model.stu_layers) if impl == "pallas" else 0
    ok = (err <= IMPL_TOL and launches["hstu_attn_fwd"] == want_attn
          and sum(launches.values()) == want_attn)
    emit({"phase": impl, "users": int(dev["item_seq"].shape[0]), "launches": launches,
          "head_embs_max_abs_err": err, "min_cosine": cos, "tolerance": IMPL_TOL,
          "cuda_ms": min(i1, i2), "auto_cuda_ms": min(a1, a2), "ok": bool(ok)})
    return launches, ok


def train_phase(data, checkpoint_dir):
    """The training path: ``run.train`` (what ``run.py`` runs without
    ``--val_only`` after loading data) with the launch counts set to 0 just
    before and read just after. Kernel A must run 16 times forward and 16
    times backward per step (plus 16 forward per evaluated batch) and
    ``row_adamw`` once per step; kernel B not at all."""
    import torch

    from mhrec_tpu_torch.data import build_eval_dataloaders
    from mhrec_tpu_torch.run import train

    config = train_config(checkpoint_dir)
    # valid + test batches, each evaluated once (16 forward launches each)
    eval_batches = sum(math.ceil(len(loader) / config["eval_batch_size"])
                       for loader in build_eval_dataloaders(config, data))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, stats, result = train(config, data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_layers = len(trainer.model.stu_layers)
    per_step = {"hstu_stu_gated_fwd": (launches["hstu_stu_gated_fwd"]
                                       - n_layers * eval_batches) / stats["iters"],
                "hstu_stu_gated_bwd": launches["hstu_stu_gated_bwd"] / stats["iters"],
                "row_adamw": launches["row_adamw"] / stats["iters"],
                "hstu_attn_fwd": launches["hstu_attn_fwd"] / stats["iters"],
                "hstu_attn_bwd": launches["hstu_attn_bwd"] / stats["iters"]}
    first, last = trainer.fetched_losses[0], trainer.fetched_losses[-1]
    nan_step = int(trainer.nan_step)
    ckpt = os.path.isfile(trainer.checkpoint_path())
    values = [v for sec in result.values() for v in sec.values()]
    ok = (stats["iters"] == TRAIN_STEPS and math.isfinite(first[1]) and math.isfinite(last[1])
          and nan_step < 0 and ckpt and trainer.step == TRAIN_STEPS
          and per_step == {"hstu_stu_gated_fwd": n_layers, "hstu_stu_gated_bwd": n_layers,
                           "row_adamw": 1, "hstu_attn_fwd": 0, "hstu_attn_bwd": 0}
          and all(math.isfinite(v) for v in values) and "pred_7" in result)
    emit({"phase": "train", "steps": stats["iters"], "batch": config["train_batch_size"],
          "num_negatives": config["num_negatives"], "items": int(data.item_num),
          "seconds": seconds, "fit_wall_s": stats["wall_s"], "fit_eval_s": stats["eval_s"],
          "steady_examples_per_s": stats["steady_examples_per_s"],
          "examples_per_s": stats["examples_per_s"],
          "first_loss": first, "last_loss": last, "nan_step": nan_step,
          "peak_mem_gb": peak_gb, "launches": launches, "launches_per_step": per_step,
          "checkpoint_saved_and_loaded": ckpt, "test_metrics": result.get("pred_7"),
          "ok": bool(ok)})
    return trainer, launches, ok, stats


def loss_and_grads(trainer, batch, step):
    """Loss and every gradient of one batch at the trainer's parameters,
    without an optimizer step; dropout drawn from step ``step``'s stream."""
    import torch

    model = trainer.model
    dev = trainer._train_device_batch(batch)
    ids = dev.pop("unique_ids")
    sub0 = model.item_embedding.weight.detach()[ids.clamp(min=0)].requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    out = model(dev, sub=sub0, generator=trainer.step_generator(step))
    out["loss"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    grads["item_rows"] = sub0.grad.detach()
    return float(out["loss"].detach()), grads, ids


def _grad_agreement(grads, ref):
    """(max per-tensor relative L2 error, cosine of the whole gradient, the
    tensor of the max)."""
    import torch

    rel = {n: float(torch.linalg.vector_norm(grads[n].float() - g.float())
                    / torch.linalg.vector_norm(g.float()))
           for n, g in ref.items() if bool(g.any())}
    worst = max(rel, key=rel.get)
    flat_a = torch.cat([g.flatten().double() for g in grads.values()])
    flat_b = torch.cat([g.flatten().double() for g in ref.values()])
    return rel[worst], float(torch.nn.functional.cosine_similarity(flat_a, flat_b, dim=0)), worst


def train_impl_phase(trainer, data):
    """One batch of the trained model's loss and gradients under
    ``attn_impl: pallas`` (kernel B forward and backward, 16 launches each)
    and ``xla`` (the plain path, no kernel) against ``auto`` (kernel A), in
    the model's bfloat16 and on a float32 copy; each bfloat16 route's
    gradients (``auto``, ``pallas``, ``xla``) against the float32 copy's
    ``auto`` gradients (``bf16_vs_f32_auto``: how far bfloat16 rounding
    alone takes each route); and one row update of ``sparse_adam_impl: xla`` (the plain
    version) against the kernel's, which must be bit-equal."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer import Trainer
    from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update

    batch = next(build_dataloader(trainer.config, data)[0].epoch_batches(5))
    step = trainer.step
    f32 = Trainer(trainer.config, data, dtype=torch.float32)
    f32.model.load_state_dict(trainer.model.state_dict())
    L = len(trainer.model.stu_layers)
    recs, ok_all, pallas_launches, bf16_grads = {}, True, None, {}
    for dname, tr in (("bfloat16", trainer), ("float32", f32)):
        loss_ref, g_ref, ids = loss_and_grads(tr, batch, step)
        if dname == "bfloat16":
            g_rows, ids_rows = g_ref["item_rows"], ids
            bf16_grads["auto"] = g_ref
        for impl in ("pallas", "xla"):
            set_attn_impl(tr.model, impl)
            reset_launches()
            loss, grads, _ = loss_and_grads(tr, batch, step)
            torch.cuda.synchronize()
            launches = read_launches()
            set_attn_impl(tr.model, "auto")
            loss_rel = abs(loss - loss_ref) / abs(loss_ref)
            grad_rel, cos, worst = _grad_agreement(grads, g_ref)
            want = {k: 0 for k in launches}
            if impl == "pallas":
                want.update(hstu_attn_fwd=L, hstu_attn_bwd=L)
                if dname == "bfloat16":
                    pallas_launches = launches
            if dname == "bfloat16":
                bf16_grads[impl] = grads
            ok = (loss_rel <= IMPL_TOL and launches == want
                  and (dname == "bfloat16" or grad_rel <= F32_GRAD_TOL))
            ok_all &= ok
            recs[f"{impl}_{dname}"] = {
                "loss": loss, "loss_auto": loss_ref, "loss_rel_diff": loss_rel,
                "grad_max_rel_l2": grad_rel, "grad_worst_tensor": worst, "grad_cosine": cos,
                "launches": launches, "ok": bool(ok)}
    # g_ref now holds the float32 copy's auto gradients
    vs_f32 = {}
    for impl, grads in bf16_grads.items():
        grad_rel, cos, worst = _grad_agreement(grads, g_ref)
        vs_f32[impl] = {"grad_max_rel_l2": grad_rel, "grad_worst_tensor": worst,
                        "grad_cosine": cos}
    del f32, bf16_grads
    model = trainer.model
    cfg = SparseAdamConfig(weight_decay=trainer.weight_decay)
    states = []
    for update in (row_adamw, sparse_adamw_row_update):
        tmv = [t.detach().clone() for t in (model.item_embedding.weight, trainer.table_m,
                                            trainer.table_v)]
        update(*tmv, ids_rows, g_rows, 1e-4, step, cfg)
        states.append(tmv)
    torch.cuda.synchronize()
    row_equal = all(bool(torch.equal(a, b)) for a, b in zip(*states))
    del states
    ok_all &= row_equal
    emit({"phase": "train_impl", "loss_tolerance": IMPL_TOL,
          "f32_grad_tolerance": F32_GRAD_TOL, **recs, "bf16_vs_f32_auto": vs_f32,
          "row_update_xla_equals_kernel": row_equal, "ok": bool(ok_all)})
    return pallas_launches, ok_all


def hllm_config(pretrain_dir, work_dir, **over):
    """reproduce/HLLM-EBNerd-prior.sh's flags that serving reads: TinyLlama
    towers from ``pretrain_dir`` (a ``config.json`` alone: random weights
    from ``seed``), 11 prior heads × 2 segment heads, hierarchical, segment
    embeddings, the packed item tower and the packed corpus pass;
    ``train_batch_size`` 128 sets the corpus batch to 24 · 128 = 3,072
    items. The token cache and the (absent) checkpoint live under
    ``work_dir``; ``over`` overrides any key."""
    from mhrec_tpu_torch.config import Config

    C = 11
    return Config(
        config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"],
        config_dict=dict(
            dict(dataset="synthetic", seed=0, data_path=work_dir,
                 checkpoint_dir=os.path.join(work_dir, "ckpt"),
                 item_pretrain_dir=pretrain_dir, user_pretrain_dir=pretrain_dir,
                 MAX_TEXT_LENGTH=256, gradient_checkpointing=True, MAX_ITEM_LIST_LENGTH=24,
                 loss="prior", train_batch_size=128, suppress_history=False,
                 medusa_num_layers=1, num_segment_head=2, num_prior_head=C,
                 head_interaction="hierarchical", split_mode="combine", use_image=False,
                 pred_len=4, eval_pred_len=8, medusa_lambda=0.99, eval_num_cats=C,
                 weighted_prior_loss=True, outlier_user_metrics="category", segment_embed=True,
                 eval_by_cat=False, packed_item_tower=True, packed_corpus_pass=True,
                 val_only=True,
                 int_to_category={i: f"cat_{i}" for i in range(C)}),
            **over),
    ).finalize()


def hllm_train_config(pretrain_dir, work_dir, **over):
    """The script's training flags on ``hllm_config``'s model: learning rate
    1e-4 (weight decay 0.01, cosine schedule, LLM.yaml), gradient
    checkpointing, the weighted prior loss with negatives drawn per
    category, the packed item tower; cut to ``train_batch_size``
    HLLM_TRAIN_BATCH (the script: 32 a card on 16 cards) with 64 negatives,
    which keeps its 8 negatives a sample for each of the 12 pools (4096 over
    its global batch of 512), and HLLM_TRAIN_STEPS steps (3000) with one
    evaluation at the end; every step's loss is fetched."""
    return hllm_config(pretrain_dir, work_dir, **dict(
        dict(val_only=False, train_batch_size=HLLM_TRAIN_BATCH, num_negatives=64,
             neg_sample_by_cat=True, optim_args={"learning_rate": 1e-4, "weight_decay": 0.01},
             total_iters=HLLM_TRAIN_STEPS, eval_interval=HLLM_TRAIN_STEPS, update_interval=1),
        **over))


def hllm_serve_phase(config, data, phase="hllm_serve"):
    """The HLLM serving path: ``run.serve`` with the launch counts set to 0
    just before and read just after; ``packed_attn_fwd`` must run once per
    layer per corpus batch. ``serve_seconds`` is that call, set-up included
    (random init of both towers, tokenizing the corpus); then, warm, the
    corpus pass alone (``items_per_s``, ``tokens_per_s``: real tokens and emb
    slots) and a whole repeated evaluation (``users_per_s``), which must
    give the same metrics."""
    import numpy as np
    import torch

    from mhrec_tpu_torch.run import serve

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, test_loader, result = serve(config, data)
    torch.cuda.synchronize()
    serve_seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    batcher = trainer._corpus_batcher
    n_batches = math.ceil(data.item_num / batcher.batch_size)
    layers = trainer.model.item_config.num_hidden_layers
    t0 = time.perf_counter()
    table = trainer.compute_item_feature()
    torch.cuda.synchronize()
    corpus_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = trainer.evaluate(test_loader)
    torch.cuda.synchronize()
    eval_seconds = time.perf_counter() - t0
    _, lens = batcher.text_cache.batch(np.arange(data.item_num))
    tokens = int(lens.sum()) + data.item_num * batcher.n_emb
    values = [v for sec in result.values() for v in sec.values()]
    sane = (all(math.isfinite(v) for v in values)
            and all(0.0 <= result[f"pred_{p}"][m] <= 1.0 for p in config["metrics_pred_len_list"]
                    for m in result[f"pred_{p}"]))
    others = sum(n for k, n in launches.items() if k != "packed_attn_fwd")
    ok = (sane and again == result and bool(torch.isfinite(table).all())
          and table.shape == (data.item_num, 2048)
          and launches["packed_attn_fwd"] == layers * n_batches and others == 0
          and "pred_7" in result and "shared" in result)
    n_users = len(test_loader)
    emit({"phase": phase, "users": n_users, "items": int(data.item_num),
          "corpus_batches": n_batches, "corpus_batch_items": batcher.batch_size,
          "chunk_rows": batcher._chunk_rows_hw, "corpus_tokens": tokens,
          "serve_seconds": serve_seconds, "corpus_seconds": corpus_seconds,
          "items_per_s": data.item_num / corpus_seconds, "tokens_per_s": tokens / corpus_seconds,
          "eval_seconds": eval_seconds, "users_per_s": n_users / eval_seconds,
          "users_per_s_after_corpus": n_users / max(eval_seconds - corpus_seconds, 1e-9),
          "peak_mem_gb": peak_gb, "launches": launches, "repeat_matches": again == result,
          "metrics": result, "ok": bool(ok)})
    return trainer, test_loader, launches, ok, result


def hllm_routes(model, tokens, lens, sub: int = 384):
    """Item embeddings of one batch through the packed route (the kernel)
    and the dense padded route (no kernel, in sub-batches of ``sub`` items),
    with each route's launches."""
    import torch

    from mhrec_tpu_torch.models.llm.packed import pack_items

    dev = next(model.parameters()).device
    p = pack_items(tokens, lens, n_emb=1, chunk=2048, chunk_round=1)
    with torch.no_grad():
        reset_launches()
        packed = model.encode_items_packed(
            torch.as_tensor(p["packed_tokens"], dtype=torch.long, device=dev),
            torch.as_tensor(p["packed_segment_ids"], device=dev),
            torch.as_tensor(p["packed_positions"], dtype=torch.long, device=dev),
            torch.as_tensor(p["emb_slots"], dtype=torch.long, device=dev))
        torch.cuda.synchronize()
        packed_launches = read_launches()
        reset_launches()
        dense = torch.cat([
            model.encode_items(torch.as_tensor(tokens[i:i + sub], dtype=torch.long, device=dev),
                               torch.as_tensor(lens[i:i + sub], dtype=torch.long, device=dev))
            for i in range(0, len(lens), sub)])
        torch.cuda.synchronize()
        dense_launches = read_launches()
    return packed, dense, packed_launches, dense_launches


def hllm_impl_phase(trainer, data):
    """The first corpus batch (3,072 items) through the packed and the dense
    padded item tower of the bfloat16 model, and the batch's first 768 items
    through both routes of a float32 copy; unit-normalized embeddings must
    agree to IMPL_TOL (bfloat16) and HLLM_F32_TOL (float32)."""
    import numpy as np
    import torch

    from mhrec_tpu_torch.models.layers import cosine_normalize
    from mhrec_tpu_torch.trainer import Trainer

    batcher = trainer._corpus_batcher
    tokens, lens = batcher.text_cache.batch(np.arange(batcher.batch_size))
    layers = trainer.model.item_config.num_hidden_layers
    recs, ok_all = {}, True
    f32 = Trainer(trainer.config, data, dtype=torch.float32)
    f32.model.load_state_dict(trainer.model.state_dict())
    for dname, model, n, tol in (("bfloat16", trainer.model, len(lens), IMPL_TOL),
                                 ("float32", f32.model, 768, HLLM_F32_TOL)):
        packed, dense, pl, dl = hllm_routes(model, tokens[:n], lens[:n])
        a, b = cosine_normalize(packed), cosine_normalize(dense)
        err = float((a - b).abs().max())
        cos = float((a * b).sum(-1).min())
        want = {k: 0 for k in pl}
        ok = (err <= tol and pl == dict(want, packed_attn_fwd=layers) and dl == want
              and bool(torch.isfinite(packed).all()))
        ok_all &= ok
        recs[dname] = {"items": n, "unit_emb_max_abs_err": err, "min_cosine": cos,
                       "raw_emb_max_abs_err": float((packed - dense).abs().max()),
                       "tolerance": tol, "packed_launches": pl, "dense_launches": dl,
                       "ok": bool(ok)}
    del f32
    emit({"phase": "hllm_impl", **recs, "ok": bool(ok_all)})
    return ok_all


def hllm_train_phase(config, data):
    """The HLLM training path: ``run.train`` (fit with one evaluation of the
    valid split and a best-checkpoint save, then the test split evaluated
    from that checkpoint) with the launch counts set to 0 just before and
    read just after. Per step, ``packed_attn_fwd`` must run twice per
    item-tower layer (the forward and its recompute under gradient
    checkpointing) and ``packed_attn_bwd`` once; each evaluation's corpus
    pass adds one forward launch per layer per corpus batch; no other
    kernel runs. Every step's loss must be finite. The items and tokens a
    step are counted on the fit's batches, made again from the seeded
    stream."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.run import train

    free_gb = shutil.disk_usage(os.path.dirname(config["checkpoint_dir"])).free / 2**30
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, stats, result = train(config, data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    layers = trainer.model.item_config.num_hidden_layers
    steps = stats["iters"]
    # the valid and the test evaluation each encode the whole catalog
    corpus_batches = 2 * math.ceil(data.item_num / trainer._corpus_batcher.batch_size)
    per_step = {"packed_attn_fwd": (launches["packed_attn_fwd"] - layers * corpus_batches)
                / max(steps, 1),
                "packed_attn_bwd": launches["packed_attn_bwd"] / max(steps, 1)}
    others = sum(n for k, n in launches.items() if k not in per_step)
    stream = build_dataloader(config, data)[0].epoch_batches(0)
    batches = [next(stream) for _ in range(steps)]
    items = sum(len(b["emb_slots"]) for b in batches) / steps
    tokens = sum(int((b["packed_segment_ids"] > 0).sum()) for b in batches) / steps
    rows = [int(b["packed_tokens"].shape[0]) for b in batches]
    del batches
    step_s = config["train_batch_size"] / stats["steady_examples_per_s"]
    losses = [loss for _, loss in trainer.fetched_losses]
    values = [v for sec in result.values() for v in sec.values()]
    ckpt = trainer.checkpoint_stats
    ok = (steps == HLLM_TRAIN_STEPS and len(losses) == steps
          and all(math.isfinite(x) for x in losses) and int(trainer.nan_step) < 0
          and per_step == {"packed_attn_fwd": 2 * layers, "packed_attn_bwd": layers}
          and others == 0 and os.path.isfile(trainer.checkpoint_path())
          and "load_s" in ckpt and all(math.isfinite(v) for v in values)
          and "pred_7" in result)
    emit({"phase": "hllm_train", "steps": steps, "batch": config["train_batch_size"],
          "num_negatives": config["num_negatives"], "items": int(data.item_num),
          "seconds": seconds, "fit_wall_s": stats["wall_s"], "fit_eval_s": stats["eval_s"],
          "steady_examples_per_s": stats["steady_examples_per_s"],
          "examples_per_s": stats["examples_per_s"], "steady_step_s": step_s,
          "items_per_step": items, "tokens_per_step": tokens, "chunk_rows_per_step": rows,
          "item_tower_items_per_s": items / step_s, "item_tower_tokens_per_s": tokens / step_s,
          "losses": losses, "nan_step": int(trainer.nan_step), "peak_mem_gb": peak_gb,
          "launches": launches, "launches_per_step": per_step,
          "corpus_batches": corpus_batches, "checkpoint": ckpt,
          "disk_free_gb_before": free_gb, "metrics": result, "ok": bool(ok)})
    return trainer, launches, ok


def hllm_loss_and_grads(trainer, batch, packed: bool, grads: bool = True):
    """One train batch's loss (and every gradient) through the packed item
    tower (``packed`` True: the batch holds packed keys) or the dense padded
    one, without an optimizer step, with that pass's launches."""
    import torch

    model = trainer.model
    model.packed_item_tower = packed
    model.train()
    dev = trainer._train_device_batch(batch)
    for p in model.parameters():
        p.grad = None
    reset_launches()
    with torch.set_grad_enabled(grads):
        out = model(dev, generator=trainer.step_generator(0))
        if grads:
            out["loss"].backward()
    torch.cuda.synchronize()
    launches = read_launches()
    got = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return float(out["loss"].detach()), got, launches


def hllm_train_impl_phase(trainer, data, work_dir):
    """One train batch of 2 sequences (248 items) through the packed item
    tower (the kernels forward and backward) and the dense padded one (no
    kernel): on a float32 HLLM of 2 layers at TinyLlama's widths (random
    weights from seed 0), the loss and every gradient to a relative L2
    error of F32_GRAD_TOL, and the launches of each route (packed: 2 + 2
    forward with the recompute, 2 backward; dense: none); on the trained
    bfloat16 model the loss alone, to IMPL_TOL."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.trainer import Trainer

    narrow_dir = os.path.join(work_dir, "tinyllama_2l")
    os.makedirs(narrow_dir, exist_ok=True)
    with open(os.path.join(narrow_dir, "config.json"), "w") as fh:
        json.dump(dict(TINYLLAMA_1B, num_hidden_layers=2), fh)
    pretrain_dir = trainer.config["item_pretrain_dir"]
    batches = {}
    for packed in (True, False):
        # 2 sequences of 28 items and 8 negatives a sample for each of the
        # 12 pools: 248 items
        cfg = hllm_train_config(pretrain_dir, work_dir, train_batch_size=2, num_negatives=16,
                                packed_item_tower=packed)
        batches[packed] = next(build_dataloader(cfg, data)[0].epoch_batches(5))
    same_items = all((batches[True][k] == batches[False][k]).all()
                     for k in ("items", "neg_items"))
    n_items = len(batches[True]["emb_slots"])
    recs, ok_all = {}, same_items
    loss_bf16 = {p: hllm_loss_and_grads(trainer, batches[p], p, grads=False) for p in batches}
    trainer.model.packed_item_tower = True
    rel = abs(loss_bf16[True][0] - loss_bf16[False][0]) / abs(loss_bf16[False][0])
    ok = rel <= IMPL_TOL and loss_bf16[False][2]["packed_attn_fwd"] == 0
    ok_all &= ok
    recs["bfloat16"] = {"layers": trainer.model.item_config.num_hidden_layers,
                        "loss_packed": loss_bf16[True][0], "loss_dense": loss_bf16[False][0],
                        "loss_rel_diff": rel, "tolerance": IMPL_TOL, "ok": bool(ok)}
    f32 = Trainer(hllm_train_config(narrow_dir, work_dir, train_batch_size=2, num_negatives=16),
                  data, dtype=torch.float32)
    f32.setup_model()
    (lp, gp, launch_p), (ld, gd, launch_d) = (hllm_loss_and_grads(f32, batches[p], p)
                                              for p in (True, False))
    rel = abs(lp - ld) / abs(ld)
    grad_rel, cos, _ = _grad_agreement(gp, gd)
    want = {k: 0 for k in launch_p}
    ok = (rel <= F32_GRAD_TOL and grad_rel <= F32_GRAD_TOL and set(gp) == set(gd)
          and launch_p == dict(want, packed_attn_fwd=4, packed_attn_bwd=2) and launch_d == want
          and math.isfinite(lp))
    ok_all &= ok
    recs["float32"] = {"layers": 2, "loss_packed": lp, "loss_dense": ld, "loss_rel_diff": rel,
                       "grad_max_rel_l2": grad_rel, "grad_cosine": cos, "grads": len(gp),
                       "packed_launches": launch_p, "dense_launches": launch_d,
                       "tolerance": F32_GRAD_TOL, "ok": bool(ok)}
    del f32
    emit({"phase": "hllm_train_impl", "items": n_items, "same_items": bool(same_items), **recs,
          "ok": bool(ok_all)})
    return ok_all


# -- the evaluation outputs and modes, and gradient accumulation -------------
# the metrics of the streamed GAUC / VALUE phase
STREAMED_METRICS = ["Recall", "NDCG", "GAUC", "AUC", "MAE", "RMSE", "LogLoss"]
# users held through both the streamed and the full-score path: 128, not
# the 512 users first planned, whose host collector (argpartition and
# argsort over [512, 12, 200000] scores) took 50.5 s of the phase
FULL_SCORE_USERS = 128
# the full-score path's [users, H, items] float32 tensor must stay below this
FULL_SCORE_BYTES = 16 * 2**30
# the CPU tests' tolerances (tests/test_torch_eval_outputs.py): streamed
# against full scores, and the host table against the table on the card
STREAMED_TOL = {"rank": 5e-4, "other": 2e-6}
HOST_TABLE_TOL = {"rank": 2e-3, "other": 1e-6}
# the host-table timing: a catalog past the default 4 GiB budget at width 2048
HOST_TABLE_ITEMS = 600_000
# gradient accumulation: micro-steps an optimizer step, optimizer steps
ACCUM_K = 8
ACCUM_STEPS = 4


def results_close(out, ref, tol):
    """Every metric of ``ref`` in ``out`` within ``tol["rank"]`` (gauc, auc)
    or ``tol["other"]``; returns (ok, the largest difference by kind)."""
    worst = {"rank": 0.0, "other": 0.0}
    ok = set(ref) <= set(out)
    for section, metrics in ref.items():
        for key, v in metrics.items():
            if key not in out.get(section, {}):
                ok = False
                continue
            kind = "rank" if "auc" in key else "other"
            d = abs(float(out[section][key]) - float(v))
            worst[kind] = max(worst[kind], d)
            ok &= d <= tol[kind]
    return bool(ok), worst


def record_topk(trainer):
    """Wrap the collector so each batch's top-k indices are kept; returns
    the list and a function that undoes the wrap."""
    seen = []
    collect = trainer.collector.eval_batch_collect

    def wrapped(**kw):
        if kw.get("topk_indices") is not None:
            seen.append(kw["topk_indices"].copy())
        return collect(**kw)

    trainer.collector.eval_batch_collect = wrapped
    return seen, lambda: setattr(trainer.collector, "eval_batch_collect", collect)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def eval_outputs_phase(trainer, test_loader):
    """The serve phase's trainer evaluated again with ``log_detailed_results``
    and ``save_for_eval`` on, into a temporary directory, with the launch
    counts set to 0 just before and read just after: the metrics must equal
    the plain evaluation's exactly; one detailed dump per eval batch, every
    ``recommend_items`` row holding K entries; the ``save_for_eval`` chunks'
    top-k indices equal to the plain run's streamed top-k, and user
    embeddings of the trunk's width. users/s with the dumps off and on,
    over the first EVAL_OUTPUTS_BATCHES eval batches (the dumps take about
    1/200 s a user); returns (launches, ok, users/s with the dumps off)."""
    import numpy as np
    import torch

    from mhrec_tpu_torch.utils.observability import load_log_dict

    config = trainer.config
    test_loader = FirstBatches(test_loader, EVAL_OUTPUTS_BATCHES)
    seen, undo = record_topk(trainer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = trainer.evaluate(test_loader)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    undo()
    work = tempfile.mkdtemp(prefix="chip_smoke_dumps_")
    saved_dir = trainer.saved_model_dir
    try:
        trainer.saved_model_dir = work
        config["log_detailed_results"] = config["save_for_eval"] = True
        reset_launches()
        t0 = time.perf_counter()
        dumped = trainer.evaluate(test_loader)
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t0
        launches = read_launches()
        n_batches = math.ceil(len(test_loader) / config["eval_batch_size"])
        top_k = max(config["topk"])
        details = sorted(glob.glob(os.path.join(work, "detailed", "*.npz")))
        chunks = sorted(glob.glob(os.path.join(work, "saved_eval", "eval_chunk_*.npz")))
        rows_ok = all(len(row) == top_k for p in details
                      for row in load_log_dict(p[:-4])["recommend_items"])
        chunks_ok = len(chunks) == len(seen)
        width = None
        for path, ref in zip(chunks, seen):
            with np.load(path) as z:
                width = z["user_embs"].shape[1]
                chunks_ok &= (np.array_equal(z["topk_indices"], ref)
                              and z["user_embs"].shape == (ref.shape[0],
                                                           config["hstu_embedding_size"])
                              and z["head_embs"].shape[0] == ref.shape[0])
        written = _dir_bytes(work)
    finally:
        config["log_detailed_results"] = config["save_for_eval"] = False
        trainer.saved_model_dir = saved_dir
        shutil.rmtree(work, ignore_errors=True)
    n_users = len(test_loader)
    layers = len(trainer.model.stu_layers)
    ok = (dumped == plain and len(details) == n_batches
          and len(chunks) == n_batches and rows_ok and chunks_ok
          and launches == dict({k: 0 for k in launches}, hstu_stu_gated_fwd=layers * n_batches))
    emit({"phase": "eval_outputs", "users": n_users, "eval_batches": n_batches,
          "users_per_s_dumps_off": n_users / plain_s, "users_per_s_dumps_on": n_users / dump_s,
          "seconds_dumps_off": plain_s, "seconds_dumps_on": dump_s, "bytes_written": written,
          "detailed_dumps": len(details), "save_for_eval_chunks": len(chunks),
          "recommend_items_rows_hold_k": rows_ok, "chunks_match_streamed_topk": bool(chunks_ok),
          "user_emb_width": width, "metrics_equal_plain": dumped == plain,
          "launches": launches, "ok": bool(ok)})
    return launches, ok, n_users / plain_s


# eval_outputs' eval batches (all 4 of the serve phase's until the
# distributed phase joined the script: a depth cut)
EVAL_OUTPUTS_BATCHES = 2


class FirstBatches:
    """The first ``n`` batches of an eval batcher, as an eval batcher of
    their users."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return min(len(self.loader), self.n * self.loader.batch_size)

    def batches(self):
        return itertools.islice(self.loader.batches(), self.n)


class FirstUsers:
    """The first ``n`` users of an eval batcher, as one batch (its history
    buffers cut to those rows)."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return self.n

    def batches(self):
        import numpy as np

        batch = dict(next(iter(self.loader.batches())))
        keep = batch["history_row"] < self.n
        batch["history_row"] = np.where(keep, batch["history_row"], 0)
        batch["history_col"] = np.where(keep, batch["history_col"], -1)
        for key in ("user_ids", "item_seq", "item_target", "target_tags", "outlier_users",
                    "sample_weight"):
            batch[key] = batch[key][: self.n]
        yield batch


def eval_streamed_phase(trainer, test_loader, plain_users_per_s):
    """The serve phase's trainer with the metrics Recall, NDCG, GAUC, AUC,
    MAE, RMSE and LogLoss: the streamed mean-rank and target-score path over
    every user (timed, launch counts set to 0 just before and read just
    after), and on the first FULL_SCORE_USERS users (fewer if their
    [users, H, items] float32 scores would pass FULL_SCORE_BYTES) against
    the full-score path at the CPU tests' tolerances."""
    import torch

    from mhrec_tpu_torch.evaluator import Collector, Evaluator

    config = trainer.config
    saved = config["metrics"], trainer.collector, trainer.evaluator
    config["metrics"] = STREAMED_METRICS
    try:
        trainer.collector, trainer.evaluator = Collector(config), Evaluator(config)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamed = trainer.evaluate(test_loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        heads = trainer.collector.medusa_num_heads
        n = FULL_SCORE_USERS
        while n * heads * trainer.dataload.item_num * 4 > FULL_SCORE_BYTES:
            n //= 2
        first = FirstUsers(test_loader, n)
        sub_streamed = trainer.evaluate(first)
        need = trainer.collector.register.need
        trainer.collector.register.need = lambda k: k == "rec.score" or need(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = trainer.evaluate(first)
        full_s = time.perf_counter() - t0
    finally:
        config["metrics"] = saved[0]
        trainer.collector, trainer.evaluator = saved[1], saved[2]
    close, worst = results_close(sub_streamed, full, STREAMED_TOL)
    last = streamed[f"pred_{max(config['metrics_pred_len_list'])}"]
    values = [v for sec in streamed.values() for v in sec.values()]
    layers = len(trainer.model.stu_layers)
    n_batches = math.ceil(len(test_loader) / config["eval_batch_size"])
    ok = (close and all(math.isfinite(v) for v in values)
          and {"gauc", "auc", "mae", "rmse", "logloss"} <= set(last)
          and launches == dict({k: 0 for k in launches}, hstu_stu_gated_fwd=layers * n_batches))
    emit({"phase": "eval_streamed_metrics", "users": len(test_loader), "seconds": seconds,
          "users_per_s": len(test_loader) / seconds, "plain_serve_users_per_s": plain_users_per_s,
          "full_score_users": n, "heads": heads, "full_score_seconds": full_s,
          "streamed_vs_full_max_diff": worst, "tolerance": STREAMED_TOL,
          "metrics": {k: last[k] for k in ("gauc", "auc", "mae", "rmse", "logloss")},
          "launches": launches, "ok": bool(ok)})
    return launches, ok


def hllm_host_table_phase(trainer, test_loader, device_result, data):
    """The hllm_serve phase's trainer evaluated with ``host_item_table:
    true`` (the corpus pass into host memory, then the chunks streamed to
    the card), launch counts set to 0 just before and read just after; its
    metrics must agree with the device-table evaluation of the same weights
    at the CPU test's tolerances. Then ``_host_table_topk_results`` alone
    over a HOST_TABLE_ITEMS × 2048 float32 host table — the real corpus
    embeddings and random rows from seed 0 — which ``auto`` must choose by
    itself: users/s, the copies' GB/s, the table passes and the device's
    busy share, in one run under ``torch.profiler``."""
    import copy

    import torch

    config = trainer.config
    width = trainer.model.item_config.hidden_size
    captured = {}
    compute = trainer.compute_item_feature

    def capture(*a, **kw):
        captured["table"] = compute(*a, **kw)
        return captured["table"]

    trainer.compute_item_feature = capture
    config["host_item_table"] = True
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_result = trainer.evaluate(test_loader)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = read_launches()
        eval_stats = {k: v for k, v in trainer.host_table_stats.items() if k != "copy_events"}
    finally:
        config["host_item_table"] = "auto"
        del trainer.compute_item_feature
    close, worst = results_close(host_result, device_result, HOST_TABLE_TOL)
    close_back, _ = results_close(device_result, host_result, HOST_TABLE_TOL)
    real = captured["table"]
    auto_small = trainer._use_host_item_table(True)
    big = copy.copy(data)
    big.item_num = HOST_TABLE_ITEMS
    trainer.dataload = big
    try:
        auto_big = trainer._use_host_item_table(True)
    finally:
        trainer.dataload = data
    # the catalog grown with random rows at the real rows' scale, made on
    # the card from seed 0 and copied to host memory
    t0 = time.perf_counter()
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    raw = torch.empty((HOST_TABLE_ITEMS, width), dtype=torch.float32)
    raw[: real.shape[0]] = real
    scale = float(real.std())
    for off in range(real.shape[0], HOST_TABLE_ITEMS, 65536):
        n = min(65536, HOST_TABLE_ITEMS - off)
        raw[off:off + n].copy_(scale * torch.randn((n, width), generator=gen,
                                                   device=trainer.device))
    cats = torch.randint(0, data.item_tag_matrix.shape[1], (HOST_TABLE_ITEMS,),
                         generator=gen, device=trainer.device)
    tags = torch.nn.functional.one_hot(cats, data.item_tag_matrix.shape[1]).bool()
    tags[: real.shape[0]] = torch.as_tensor(data.item_tag_matrix, device=trainer.device)
    del real, captured
    norm = trainer.normalize_host_table(raw)
    setup_s = time.perf_counter() - t0
    top_k = max(config["topk"])

    def run():
        for _ in trainer._host_table_topk_results(test_loader, raw, norm, tags, top_k):
            pass

    torch.cuda.reset_peak_memory_stats()
    seconds, _, busy_us = profiled(run)
    stats = trainer.host_table_stats
    copy_s = sum(a.elapsed_time(b) for a, b in stats["copy_events"]) / 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_users = len(test_loader)
    layers = trainer.model.item_config.num_hidden_layers
    n_corpus = math.ceil(data.item_num / trainer._corpus_batcher.batch_size)
    ok = (close and close_back and auto_big and not auto_small and eval_stats["groups"] >= 1
          and launches == dict({k: 0 for k in launches}, packed_attn_fwd=layers * n_corpus)
          and stats["groups"] >= 1 and stats["h2d_bytes"] == stats["groups"] * norm.nbytes)
    emit({"phase": "hllm_host_table", "users": n_users, "items": int(data.item_num),
          "eval_seconds": eval_s, "eval_users_per_s": n_users / eval_s,
          "eval_host_table": eval_stats, "vs_device_table_max_diff": worst,
          "tolerance": HOST_TABLE_TOL, "launches": launches,
          f"auto_picks_host_at_{data.item_num}_items": auto_small,
          f"auto_picks_host_at_{HOST_TABLE_ITEMS}_items": auto_big,
          "table_items": HOST_TABLE_ITEMS, "table_gib": norm.nbytes / 2**30,
          "setup_seconds": setup_s, "seconds": seconds, "users_per_s": n_users / seconds,
          "table_passes": stats["groups"], "chunks": stats["chunks"],
          "h2d_bytes": stats["h2d_bytes"], "h2d_copy_seconds": copy_s,
          "h2d_gb_per_s": stats["h2d_bytes"] / copy_s / 1e9 if copy_s else None,
          "h2d_gb_per_s_over_call": stats["h2d_bytes"] / seconds / 1e9,
          "device_busy_share": busy_us / 1e6 / seconds, "peak_mem_gb": peak_gb,
          "ok": bool(ok)})
    return launches, ok


def train_accum_phase(data, k1_steady):
    """HSTU size4 as the train phase sets it up, with ``accumulate_grad``
    ACCUM_K (the scripts' global batch of 512 at batch 64) for ACCUM_STEPS
    optimizer steps, launch counts set to 0 just before and read just
    after. The first ACCUM_K micro-steps are taken one by one: the item
    table, its moments and the dense parameters must stay bit-unchanged
    after the first ACCUM_K − 1 and change at the boundary, where the
    deduped union holds no duplicate real id and the kernel's row update
    equals the plain version's on the same inputs, bit for bit; ``fit``
    takes the rest. ``row_adamw`` must launch once per optimizer step and
    #4 16 times per micro-step. ``peak_mem_gb`` is that of ``fit``'s
    three optimizer steps."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.trainer import Trainer
    from mhrec_tpu_torch.trainer.sparse_adam import (
        SparseAdamConfig,
        dedup_touched_rows,
        sparse_adamw_row_update,
    )

    config = train_config(tempfile.gettempdir())
    config["accumulate_grad"] = ACCUM_K
    config["total_iters"] = config["eval_interval"] = ACCUM_STEPS
    config["update_interval"] = ACCUM_K
    trainer = Trainer(config, data)
    trainer.setup_model()
    train_loader = build_dataloader(config, data)[0]
    model = trainer.model
    table = model.item_embedding.weight

    def state():
        return [t.detach().clone() for t in [table, trainer.table_m, trainer.table_v]
                + trainer.dense_params]

    def same(a, b):
        return [bool(torch.equal(x, y)) for x, y in zip(a, b)]

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = train_loader.epoch_batches(0)
    before = state()
    unchanged, losses = True, []
    for _ in range(ACCUM_K - 1):
        losses.append(float(trainer.train_step(next(stream))["loss"].detach()))
        unchanged &= all(same(state(), before))
    pre = [t.clone() for t in before[:3]]
    losses.append(float(trainer.train_step(next(stream))["loss"].detach()))
    after = state()
    moved = same(after, before)
    changed = not moved[0] and not moved[1] and not moved[2] and not all(moved[3:])
    # the boundary's union, from the buffers as the step left them (the
    # rows already divided by k), through the plain version
    ids, g = dedup_touched_rows(trainer.acc_ids, trainer.acc_g)
    real = ids[ids >= 0]
    unique = real.unique().numel() == real.numel()
    sparse_adamw_row_update(*pre, ids, g, trainer.schedule(0), 0,
                            SparseAdamConfig(weight_decay=trainer.weight_decay))
    kernel_equals_plain = all(same(after[:3], pre))
    union = {"slots": int(ids.numel()), "real_ids": int(real.numel()),
             "ids_per_micro_step": int((trainer.acc_ids >= 0).sum()) / ACCUM_K}
    del before, after, pre, ids, g, real
    # the trainer's own peak, without the checks' copies
    torch.cuda.reset_peak_memory_stats()
    stats = trainer.fit(train_loader, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses += [loss for _, loss in trainer.fetched_losses]
    micro = ACCUM_K * ACCUM_STEPS
    layers = len(model.stu_layers)
    ok = (unchanged and changed and unique and kernel_equals_plain and trainer.step == micro
          and stats["iters"] == micro - ACCUM_K and all(math.isfinite(x) for x in losses)
          and int(trainer.nan_step) < 0
          and launches == dict({k: 0 for k in launches}, row_adamw=ACCUM_STEPS,
                               hstu_stu_gated_fwd=layers * micro,
                               hstu_stu_gated_bwd=layers * micro))
    emit({"phase": "train_accum", "accumulate_grad": ACCUM_K, "optimizer_steps": ACCUM_STEPS,
          "micro_steps": micro, "batch": config["train_batch_size"],
          "global_batch": ACCUM_K * config["train_batch_size"],
          "num_negatives": config["num_negatives"], "seconds": seconds,
          "steady_examples_per_s": stats["steady_examples_per_s"],
          "k1_steady_examples_per_s": k1_steady,
          "unchanged_before_boundary": bool(unchanged), "changed_at_boundary": bool(changed),
          "union": union, "union_unique": bool(unique),
          "row_adamw_equals_plain_on_union": bool(kernel_equals_plain),
          "losses": losses, "peak_mem_gb": peak_gb,
          "row_buffers_gb": (trainer.acc_g.nbytes + trainer.acc_ids.nbytes) / 1e9,
          "launches": launches, "ok": bool(ok)})
    del trainer
    return launches, ok


# -- distributed: data parallelism over torch.distributed ---------------------
# the HSTU phases' users and catalog (InMemoryInteractionData's arguments)
HSTU_DATA = dict(num_users=4096, num_items=200_000, seq_len=2 * 50 + 2 * 8,
                 num_categories=8, eval_pred_len=8, max_item_list_length=50, seed=0)
HSTU_FILES = ("IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/hstu.yaml")
# the distributed phase's HSTU users, (a), (b) and (f): the HSTU phases'
# 4,096 until (f) and the reference-checkpoint phase joined the script (a
# depth cut)
DIST_HSTU_DATA = dict(HSTU_DATA, num_users=2048)
# (a)'s steps: 10 until (f) joined the phase (a depth cut)
DIST_STEPS = 6
# the gloo runs' steps (about 2 s each: gloo stages through the host); 5 until
# the HLLM run joined the phase, 3 until the baselines and the sharded table
# joined it (depth cuts)
DIST_GLOO_STEPS = 2
DIST_RANK_BATCH = 64   # a rank's rows a step: the gloo runs' global batch is 128
DIST_WORLD = 2
DIST_TIMEOUT = 400     # seconds a process of the phase may take
# the gloo world-2 runs against the rank-order oracle (RankOrderTrainer: one
# process that takes each rank's partial gradients at the ranks' shapes and
# sums them in rank order), at the JAX multi-process test's tolerances
# (tests/test_multiprocess.py:170-207), whose oracle is given the workers'
# partitioning so that the reduction orders line up (:173-175)
DIST_TOL = {"loss": 2e-4, "checksum": 1e-5, "rank_metric": 3e-5, "entropy": 2e-3,
            "between_ranks": 1e-6}
# the NCCL world-1 CLI run against the ungrouped one (bit-equal is expected)
DIST_WORLD1_TOL = 1e-6
# the collectives of a train step, by their comm.traffic tags
DIST_STEP_TAGS = ("grad_all_reduce", "pool_gather", "pool_gather_grad", "dedup_gather",
                  "zero_broadcast", "loss_counts", "step_scalars")
# (c): HLLM over two gloo ranks, reproduce/HLLM-EBNerd-prior.sh's model at
# TinyLlama-1.1B width cut to DIST_HLLM_LAYERS + DIST_HLLM_LAYERS layers,
# its towers in float32; the global batch is HLLM_TRAIN_BATCH (4 rows a rank)
DIST_HLLM_LAYERS = 2
DIST_HLLM_STEPS = 2  # 3 until the baselines and the sharded table joined (a depth cut)
# 512 users and 2,048 items until (f) joined the phase (a depth cut)
DIST_HLLM_DATA = dict(num_users=256, num_items=1024, seq_len=2 * 24 + 2 * 8,
                      num_categories=11, eval_pred_len=8, max_item_list_length=24, seed=0,
                      item_texts=True)
# the collectives of an HLLM step and of its evaluations' corpus passes
DIST_HLLM_TAGS = ("grad_all_reduce", "pool_gather", "pool_gather_grad", "zero_broadcast",
                  "loss_counts", "step_scalars", "corpus_gather", "metric_reduce")


# (d): the five baselines over two gloo ranks on the one card, each at its
# widths (BASELINE_FILES, sparse_item_adam) over DIST_BASE_DATA, (c)'s 512
# users and 2,048 items in the HSTU catalog's shape; global batch
# DIST_BASE_BATCH (32 rows a rank), DIST_BASE_STEPS steps, an evaluation
# with a save, the test split from it; SASRec and LLMIDRec with
# DIST_BASE_POSITION_NEGATIVES a position (cut from the baselines phase's
# 512 / 256: both ranks and the oracle share the card); LLMIDRec's
# TinyLlama-width tower cut to DIST_BASE_LLM_LAYERS layers (its one-process
# run at 22 layers peaks at 59.53 GiB)
DIST_BASE_DATA = dict(HSTU_DATA, num_users=512, num_items=2048)
DIST_BASE_BATCH = 64
DIST_BASE_STEPS = 2
DIST_BASE_POSITION_NEGATIVES = 128
DIST_BASE_LLM_LAYERS = 2
# (f): (b)'s HSTU under ``zero_stage: 3`` (the table row-sharded through
# FSDP's rule) and (c)'s HLLM under ``fsdp: true``, at the default
# ``fsdp_min_size``, each held to its oracle and to its ZeRO-2 run's
# checkpoint: bit-equal, as no clip fires there; a clip would hold them to
# JAX's rtol (tests/test_sharding.py:282)
DIST_FSDP_RTOL = 2e-5
DIST_FSDP_TAGS = ("fsdp_gather", "fsdp_reduce_scatter", "grad_all_reduce", "zero_broadcast",
                  "pool_gather", "pool_gather_grad", "dedup_gather", "step_scalars")
# the collectives of a baseline's step
DIST_BASE_TAGS = ("grad_all_reduce", "pool_gather", "pool_gather_grad", "dedup_gather",
                  "zero_broadcast", "loss_counts", "step_scalars")
# (e): the sharded table's memory: (b)'s protocol over DIST_TABLE_USERS users
# (two eval batches a split), 1 step, with the table row-sharded over
# DIST_TABLE_ITEMS items (1024 wide: 2.05 GB, 6.1 GB with its two
# moments; 1,000,000 until (f) and the reference-checkpoint phase joined
# the script, a depth cut), after the same run over DIST_TABLE_REF_ITEMS
# items, which measures what a phase takes beside the table (activations):
# one eval chunk of 131,072 rows and a one-row tail padded to a chunk, as at
# any catalog that is not a whole number of chunks
DIST_TABLE_ITEMS = 500_000
DIST_TABLE_REF_ITEMS = 131_073
DIST_TABLE_USERS = 2048
# a phase (a step, an evaluation with its load, a save) may take beyond
# the reference run's at most this share of the difference of the two
# whole tables: a whole copy in both runs takes all of it, a block (half
# the table at two ranks) half
DIST_TABLE_COPY_SHARE = 0.75


def hstu_overrides(**over):
    """base_config's overrides of the HSTU size4 prior model, ``over`` on top."""
    C = 8
    return dict(dict(dataset="synthetic", seed=0,
                     MAX_ITEM_LIST_LENGTH=50, loss="prior", eval_num_cats=C,
                     num_prior_head=C, num_segment_head=4, head_interaction="additive",
                     medusa_num_layers=1, prior_switch="in", use_prior_switch_test=True,
                     segment_embed=True, split_mode="combine",
                     eval_pred_len=8, pred_len=8, topk=[5, 10, 50, 200],
                     eval_batch_size=1024, eval_item_chunk_size=131072,
                     int_to_category={i: f"cat_{i}" for i in range(C)}), **over)


def dist_overrides(global_batch, checkpoint_dir, **over):
    """The train phase's protocol (``train_config``) at a global batch of
    ``global_batch`` for DIST_STEPS steps: 8,192 negatives a category in the
    global pool, an evaluation with a best-checkpoint save at the last step,
    every step's loss read."""
    return hstu_overrides(**dict(dict(
        train_batch_size=global_batch, num_negatives=8192, neg_sample_by_cat=True,
        weighted_prior_loss=True, prior_switch_loss_weight=0.1, sparse_item_adam=True,
        optim_args={"learning_rate": 1e-4, "weight_decay": 0.0}, total_iters=DIST_STEPS,
        eval_interval=DIST_STEPS, update_interval=1, checkpoint_dir=checkpoint_dir), **over))


def hllm_dist_config(pretrain_dir, work_dir, **over):
    """(c)'s HLLM: ``hllm_train_config``'s model and protocol (the packed
    item tower under gradient checkpointing, 64 negatives drawn per
    category) with float32 towers, DIST_HLLM_STEPS steps and an evaluation
    with a save at the last; the corpus pass is the dense one, since the
    packed one is single-process only."""
    return hllm_train_config(pretrain_dir, work_dir, **dict(dict(
        precision="32", packed_corpus_pass=False, total_iters=DIST_HLLM_STEPS,
        eval_interval=DIST_HLLM_STEPS), **over))


def write_dist_hllm_tower(work_dir, over):
    """The directory of (c)'s towers: TinyLlama-1.1B's ``config.json`` cut
    to DIST_HLLM_LAYERS layers (``over``: other keys, a few widths on the
    CPU). Returns its path."""
    path = os.path.join(work_dir, "tinyllama_cut")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(dict(TINYLLAMA_1B, num_hidden_layers=DIST_HLLM_LAYERS, **over), fh)
    return path


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def remove_dirs(*paths):
    """Remove each directory of ``paths`` (the scratch files of a run that
    has ended: checkpoints take the scratch memory)."""
    for path in paths:
        shutil.rmtree(path, ignore_errors=True)


def start_processes(cmds, logs, env=None):
    """Start every command at once, stdout and stderr to its log file;
    returns what ``wait_processes`` takes."""
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=open(log, "w"),
                                          stderr=subprocess.STDOUT))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return procs, logs, time.monotonic() + DIST_TIMEOUT


def wait_processes(started):
    """Wait for every process of ``start_processes``, each within
    DIST_TIMEOUT of its start; on a failure or a timeout the others are
    killed. Returns the exit codes (None: killed at the limit) and the
    logs' tails."""
    procs, logs, deadline = started
    try:
        codes = [None] * len(procs)
        while any(c is None for c in codes) and time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for log in logs:
        with open(log) as fh:
            tails.append(fh.read()[-3000:])
    return codes, tails


def run_processes(cmds, logs, env=None):
    """Start every command at once (stdout and stderr to its log file) and
    wait for all (``wait_processes``). Returns the exit codes and the logs'
    tails."""
    return wait_processes(start_processes(cmds, logs, env))


def cli_args(over):
    """``run.py``'s overrides after ``--`` for the config ``over``."""
    args = []
    for k, v in over.items():
        args += [f"--{k}", json.dumps(v) if isinstance(v, (list, bool, dict)) else str(v)]
    return args


def world1_cli_runs(work_dir, device, data_kw, over):
    """(a): ``python -m mhrec_tpu_torch.run`` trains the distributed
    protocol at batch 64, once as rank 0 of a one-rank group
    (``--multihost``: NCCL on the card, every collective runs through it)
    and once without a group, side by side, over the HSTU phases' catalog
    made in memory (``synthetic_data``); the two must agree on every step's
    loss, the parameter checksum and the test metrics."""
    runs = {}
    cmds, logs = [], []
    for name, group in (("grouped", True), ("ungrouped", False)):
        cfg = dist_overrides(DIST_RANK_BATCH, os.path.join(work_dir, name),
                             synthetic_data=data_kw,
                             result_json_path=os.path.join(work_dir, f"{name}_result"), **over)
        cfg.pop("int_to_category")  # the in-memory catalog's
        head = [sys.executable, "-m", "mhrec_tpu_torch.run", "--device", device]
        if group:
            head += ["--multihost", "--num_processes", "1", "--process_id", "0",
                     "--coordinator_address", f"127.0.0.1:{free_port()}"]
        cmds.append(head + ["--config_file", *HSTU_FILES, "--"] + cli_args(cfg))
        logs.append(os.path.join(work_dir, f"{name}.log"))
        runs[name] = os.path.join(work_dir, f"{name}_result.0.json")
    codes, tails = run_processes(cmds, logs)
    remove_dirs(*(os.path.join(work_dir, name) for name in runs))  # their checkpoints
    if codes != [0, 0]:
        return {"exit_codes": codes, "log_tails": tails, "ok": False}
    res = {}
    for name, path in runs.items():
        with open(path) as fh:
            res[name] = json.load(fh)
    a, b = res["grouped"], res["ungrouped"]
    la, lb = [x for _, x in a["losses"]], [x for _, x in b["losses"]]
    metrics_a, metrics_b = ({f"{sec}/{k}": v for sec, d in r["result"].items()
                             for k, v in d.items()} for r in (a, b))

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-30)

    loss_rel = max(rel(x, y) for x, y in zip(la, lb)) if len(la) == len(lb) else math.inf
    ok = (len(la) == over.get("total_iters", DIST_STEPS) and loss_rel <= DIST_WORLD1_TOL
          and rel(a["param_checksum"], b["param_checksum"]) <= DIST_WORLD1_TOL
          and metrics_a.keys() == metrics_b.keys()
          and all(rel(metrics_a[k], metrics_b[k]) <= DIST_WORLD1_TOL or metrics_a[k] == metrics_b[k]
                  for k in metrics_a))
    return {"losses_bit_equal": la == lb, "max_loss_rel_diff": loss_rel,
            "checksum_bit_equal": a["param_checksum"] == b["param_checksum"],
            "metrics_bit_equal": a["result"] == b["result"],
            "steady_examples_per_s": {k: r["steady_examples_per_s"] for k, r in res.items()},
            "peak_mem_gb": {k: r.get("peak_mem_gb") for k, r in res.items()},
            "launches": {k: r["launches"] for k, r in res.items()},
            "collective_bytes_grouped": a["collective_bytes"],
            "final_loss": a["final_loss"], "ok": bool(ok)}


def dist_rank_config(spec, out):
    """The config of a gloo run's rank, from its ``spec``: (b)'s HSTU at
    DIST_RANK_BATCH rows a rank, or (c)'s HLLM (``spec["model"]`` "hllm")."""
    if spec.get("model") == "hllm":
        return hllm_dist_config(spec["pretrain_dir"], out, **spec["over"])
    return base_config(**dist_overrides(DIST_RANK_BATCH * DIST_WORLD, os.path.join(out, "ckpt"),
                                        shard_item_embedding=spec["shard"], **spec["over"]))


def table_watch_class():
    """``TableWatch``, made on first use so that the module imports without
    torch."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class TableWatch(TorchDispatchMode):
        """Records every tensor that an operation produces with ``rows``
        rows of one of the ``widths`` (a whole item table, raw or
        projected), as (phase, operation, shape, device); ``phase`` is set
        by the trainer (``phase_trainer_class``)."""

        def __init__(self, rows, widths):
            super().__init__()
            self.rows, self.widths = rows, set(widths)
            self.phase = "build"
            self.hits = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[0] == self.rows
                        and t.shape[1] in self.widths):
                    self.hits.append((self.phase, str(func), list(t.shape), t.device.type))
            return out

    return TableWatch


def phase_trainer_class(on_card, watch=None):
    """A ``Trainer`` whose build, initialisation, steps, evaluations, saves
    and loads (``phase_mem``: build, init, step, eval, save, load) each
    record the most memory they held on the card beyond what they started
    and ended with, in bytes, the largest over the calls of a kind (a load
    inside an evaluation counts with it), and ``peak_bytes`` the largest
    allocation of the run; each tells ``watch`` (a TableWatch) the phase it
    runs, the innermost."""
    import contextlib

    import torch

    from mhrec_tpu_torch.trainer import Trainer

    class PhaseTrainer(Trainer):
        def __init__(self, config, dataload, device=None, dtype=None):
            self.phase_mem, self.peak_bytes, self._phase_name = {}, 0, None
            with self._phase("build"):
                super().__init__(config, dataload, device, dtype)

        @contextlib.contextmanager
        def _phase(self, name):
            if self._phase_name is not None:
                # a phase inside another: the watch sees it, the memory
                # counts with the outer one
                outer = watch.phase if watch is not None else None
                if watch is not None:
                    watch.phase = name
                try:
                    yield
                finally:
                    if watch is not None:
                        watch.phase = outer
                return
            self._phase_name = name
            if watch is not None:
                watch.phase = name
            if on_card:
                torch.cuda.synchronize()
                begin = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            try:
                yield
            finally:
                self._phase_name = None
                if watch is not None:
                    watch.phase = "between"
            if on_card:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                self.peak_bytes = max(self.peak_bytes, peak)
                extra = peak - max(begin, torch.cuda.memory_allocated())
                self.phase_mem[name] = max(self.phase_mem.get(name, 0), extra)

        def setup_model(self, seed=None):
            with self._phase("init"):
                return super().setup_model(seed)

        def train_step(self, batch):
            with self._phase("step"):
                return super().train_step(batch)

        def evaluate(self, eval_batcher, load_best_model=False):
            with self._phase("eval"):
                return super().evaluate(eval_batcher, load_best_model)

        def save_checkpoint(self):
            with self._phase("save"):
                return super().save_checkpoint()

        def load_checkpoint(self):
            with self._phase("load"):
                return super().load_checkpoint()

    return PhaseTrainer


def rank_train(rank, dev, config, data, phases=False, watch_table=False, test_split=True):
    """``run.train`` of ``config`` on this rank's rows (without
    ``test_split``: its fit alone), the launch counts and the collectives'
    bytes counted from 0 just before; with ``phases`` through
    ``phase_trainer_class`` (the memory of each phase), with
    ``watch_table`` under a TableWatch of the item table's rows and widths.
    Returns the rank's record."""
    import contextlib

    import torch

    from mhrec_tpu_torch import run as run_mod
    from mhrec_tpu_torch.parallel import comm

    on_card = dev.type == "cuda"
    watch = None
    if watch_table:
        watch = table_watch_class()(int(data.item_num), {config["item_embedding_size"],
                                                          config["hstu_embedding_size"]})
    reset_launches()
    comm.traffic.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
    plain = run_mod.Trainer
    if phases:
        run_mod.Trainer = phase_trainer_class(on_card, watch)
    t0 = time.perf_counter()
    try:
        with watch if watch is not None else contextlib.nullcontext():
            if test_split:
                trainer, stats, result = run_mod.train(config, data, dev)
            else:
                train_b, valid_b, _ = run_mod.build_dataloader(config, data, rank, DIST_WORLD)
                trainer = run_mod.Trainer(config, data, device=dev)
                trainer.setup_model()
                stats = trainer.fit(train_b, valid_b)
                result = trainer.best_valid_result
    finally:
        run_mod.Trainer = plain
    if on_card:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    rec = {"rank": rank, "seconds": seconds, "iters": stats["iters"],
           "losses": trainer.fetched_losses, "final_loss": float(stats["loss"]),
           "param_checksum": trainer.param_checksum(), "result": result,
           "steady_examples_per_s": stats["steady_examples_per_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None,
           "launches": read_launches(), "collective_bytes": dict(comm.traffic),
           "optimizer_sharded": type(trainer.optimizer).__name__,
           "dense_params": sum(p.numel() for p in trainer.dense_params),
           "persistent_bytes": stats["persistent_bytes"],
           "fsdp_live_whole": stats["fsdp_live_whole"],
           "fsdp_params": ({n: [e.numel, e.n] for n, e in trainer.fsdp.entries.items()}
                           if trainer.fsdp is not None else {}),
           "checkpoint": trainer.checkpoint_path(),
           "evaluations": stats["iters"] // trainer.eval_interval + int(test_split)}
    if phases:
        rec["phase_mem"], rec["peak_bytes"] = trainer.phase_mem, trainer.peak_bytes
    if watch is not None:
        rec["table_hits"] = watch.hits
    emb = trainer.item_table()
    if emb is not None:
        rec["table_rows"] = int(emb.weight.shape[0])
        rec["table_bytes"] = sum(t.numel() * t.element_size()
                                 for t in (emb.weight, trainer.table_m, trainer.table_v))
        rec["whole_table_bytes"] = int(data.item_num) * emb.weight.shape[1] * 4
    if getattr(trainer, "_corpus_batcher", None) is not None:
        rec["corpus_batch"] = trainer._corpus_batcher.batch_size
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    return rec


def dist_rank(rank, port, out):
    """One rank of a gloo run of (b), (c), (d) or (e): joins a gloo group of
    DIST_WORLD ranks on the device of ``{out}/spec.json`` (card 0: both
    ranks share the one card) and runs ``run.train`` on its rows of the
    global batch: (b)'s or (c)'s config, each of (d)'s families in turn
    (``spec["model"]`` "baselines"), or (e)'s HSTU at each of its catalogs
    in turn ("table"); then writes what it saw to ``{out}/rank{rank}.json``."""
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.parallel import comm, init_distributed
    from mhrec_tpu_torch.utils import init_logger

    with open(os.path.join(out, "spec.json")) as fh:
        spec = json.load(fh)
    dev = init_distributed(f"127.0.0.1:{port}", DIST_WORLD, rank, backend="gloo",
                           device=spec["device"])
    model = spec.get("model")
    if model == "baselines":
        data = InMemoryInteractionData(**spec["data"])
        rec = {"rank": rank, "families": {}}
        for family in spec["families"]:
            config = baseline_dist_config(family, os.path.join(out, family), spec["user_dir"],
                                          **spec["over"])
            init_logger(config, process_index=rank)
            rec["families"][family] = rank_train(rank, dev, config, data)
    elif model == "table":
        rec = {"rank": rank, "runs": {}}
        for items in spec["items"]:
            data = InMemoryInteractionData(**dict(spec["data"], num_items=items))
            n = spec["steps"][str(items)]
            config = base_config(**dist_overrides(
                DIST_RANK_BATCH * DIST_WORLD, os.path.join(out, f"ckpt_{items}"),
                shard_item_embedding=True, **dict(spec["over"], total_iters=n, eval_interval=n)))
            init_logger(config, process_index=rank)
            rec["runs"][str(items)] = rank_train(rank, dev, config, data, phases=True,
                                                 watch_table=True, test_split=False)
            # the run's checkpoint (6.1 GB at 500,000 items), written by
            # rank 0 once both ranks have ended the run
            comm.sync_hosts("table run done")
            if rank == 0:
                remove_dirs(config["checkpoint_dir"])
    else:
        config = dist_rank_config(spec, out)
        init_logger(config, process_index=rank)
        hstu = model is None
        rec = rank_train(rank, dev, config, InMemoryInteractionData(**spec["data"]),
                         phases=hstu, watch_table=hstu and spec["shard"])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


class ComposedBatcher:
    """The single-process oracle's batches: each step the DIST_WORLD hosts'
    batch halves concatenated in host order, the global batch the ranks
    build together (tests/test_multiprocess.py:121-143). ``part``: the
    hosts' batcher class (default ``SEQTrainBatcher``)."""

    num_hosts = 1

    def __init__(self, config, data, part=None):
        from mhrec_tpu_torch.data.trainset import SEQTrainBatcher

        self.parts = [(part or SEQTrainBatcher)(config, data, host_id=h, num_hosts=DIST_WORLD)
                      for h in range(DIST_WORLD)]

    def compose(self, parts):
        import numpy as np

        return {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}

    def infinite_batches(self, prefetch: int = 2):
        from mhrec_tpu_torch.data.trainset import _prefetch_iterator

        def gen():
            streams = [p.infinite_batches(prefetch=0) for p in self.parts]
            while True:
                yield self.compose([next(s) for s in streams])

        return _prefetch_iterator(gen(), prefetch)


class RankBatches(ComposedBatcher):
    """``ComposedBatcher``'s hosts' batches, each step the list of the
    DIST_WORLD parts in host order (what ``RankOrderTrainer`` steps on)."""

    def compose(self, parts):
        return parts


class _HalfMesh:
    """Rank ``rank``'s stand-in for its DataMesh inside ``group``."""

    def __init__(self, group, rank):
        self.group, self.rank, self.world = group, rank, group.world

    def all_gather_rows(self, x, tag):
        return self.group.gather_rows(x, self.rank)

    def all_reduce(self, t, tag):
        return self.group.all_reduce(t, tag, self.rank)


class RankOrderGroup:
    """The model-level collectives of ``world`` ranks (the negative pool's
    gather, the loss counts' sum in the forward, the pool gradient's sum in
    the loss's backward), played in one process for the oracle; ``mesh(h)``
    stands in for rank h's ``DataMesh``. Each collective runs twice per
    half: a recording run (``record``: each half's tensors, keyed by tag
    and call number, the tensor handed back unchanged; a gather hands back
    its rows repeated), then a summing run (each all-reduce the halves'
    tensors summed in rank order, each gather the halves' rows in rank
    order). A step thus runs each half's forward twice (a probe, then the
    step) and its backward twice (``torch.autograd.grad`` down to its pools,
    then ``backward``). The recording runs compute what the summing runs
    compute, on the same inputs, so the values they record are the other
    halves' values in the summing run; ``probe_exact`` says whether the
    gathered rows were, bit for bit."""

    def __init__(self, world):
        self.world = world
        self.rows = [[] for _ in range(world)]
        self.pools = [[] for _ in range(world)]
        self.recorded = [{} for _ in range(world)]
        self.calls = [{} for _ in range(world)]
        self.record = True
        self.probe_exact = True

    def start(self, record: bool):
        self.record = record
        self.calls = [{} for _ in range(self.world)]

    def _key(self, rank, tag):
        i = self.calls[rank].get(tag, 0)
        self.calls[rank][tag] = i + 1
        return tag, i

    def gather_rows(self, x, rank):
        import torch

        _, i = self._key(rank, "rows")
        if self.record:
            self.rows[rank].append(x.detach().clone())
            return torch.cat([x] * self.world)
        self.probe_exact &= bool(torch.equal(x.detach(), self.rows[rank][i]))
        # the other ranks' rows enter as constants, so this rank's backward
        # takes its own block of the pool's gradient, which the loss's pool
        # products have summed over the ranks (DataMesh.all_gather_rows)
        out = torch.cat([x if r == rank else self.rows[r][i] for r in range(self.world)])
        self.pools[rank].append(out)
        return out

    def all_reduce(self, t, tag, rank):
        key = self._key(rank, tag)
        if self.record:
            self.recorded[rank][key] = t.detach().clone()
            return t
        total = None
        for r in range(self.world):
            x = t.detach() if r == rank else self.recorded[r][key]
            total = x.clone() if total is None else total + x
        return t.copy_(total)

    def mesh(self, rank):
        return _HalfMesh(self, rank)


def rank_order_trainer_class():
    """``RankOrderTrainer``, made on first use so that the module imports
    without torch."""
    from mhrec_tpu_torch.trainer import Trainer

    class RankOrderTrainer(Trainer):
        """The distributed phase's oracle: one process that steps on the
        DIST_WORLD hosts' batch parts (``RankBatches``) as the ranks do,
        computing each rank's partial gradients and summing them in rank
        order. Half h runs on its own replica of the parameters (the
        trainer's model for h = 0, a copy made equal to it each step for
        the others) with its own unique-id rows under ``sparse_item_adam``,
        at the ranks' shapes, with ``RankOrderGroup`` in place of the
        process group; the dense gradients are the halves' summed in rank
        order, the id blocks and row gradients the halves' concatenated,
        the step scalars the halves' summed. The rest of the step (NaN
        guard, clip, AdamW, the row update on the deduped union) is
        ``Trainer.train_step``'s at one process."""

        def setup_model(self, seed=None):
            import copy

            super().setup_model(seed)
            self.replicas = [copy.deepcopy(self.model) for _ in range(DIST_WORLD - 1)]
            self.probe_exact = True

        def save_checkpoint(self):
            """None: the oracle's parameters stay in memory, and its test
            split evaluates what its last step left (its one evaluation, at
            the last step, is where the ranks save theirs); the checkpoint
            held is the ranks', which ``served`` loads."""

        def _train_device_batch(self, parts):
            return {"parts": [Trainer._train_device_batch(self, p) for p in parts]}

        def _forward_backward(self, dev, gen):
            import torch

            models = [self.model, *self.replicas]
            state = self.model.state_dict()
            for m in self.replicas:
                m.load_state_dict(state)
                m.train()
                for p in m.parameters():
                    p.grad = None
            halves = []
            for h, d in enumerate(dev["parts"]):
                d["step"] = dev["step"]
                ids = sub = None
                if self.sparse_item_adam:
                    ids = d.pop("unique_ids")
                    self._local_block_indices(d, ids.shape[0], h)
                    sub = self.item_table().weight.detach()[ids.clamp(min=0)].float()
                halves.append((d, ids, sub))
            group = RankOrderGroup(len(models))

            def forward(h, sub):
                d = halves[h][0]
                models[h].mesh = group.mesh(h)
                kw = {} if sub is None else {"sub": sub}
                return models[h](d, generator=self.step_generator(self.step), **kw)

            # the probe: each half's gathered rows and loss counts
            group.start(record=True)
            for h in range(len(models)):
                forward(h, halves[h][2])
            group.start(record=False)
            subs = [None if s is None else s.clone().requires_grad_(True) for _, _, s in halves]
            outs = [forward(h, subs[h]) for h in range(len(models))]
            # each half's pool gradients, from its loss's products, then the
            # backward that takes them summed over the halves
            group.start(record=True)
            for h, o in enumerate(outs):
                if group.pools[h]:
                    torch.autograd.grad(o["loss"], group.pools[h], retain_graph=True,
                                        allow_unused=True)
            group.start(record=False)
            for o in outs:
                o["loss"].backward()
            for m in models:
                m.mesh = None
            self.probe_exact &= group.probe_exact
            # the all-reduce of the dense gradients: rank 0's, then the others'
            for ps in zip(*(m.parameters() for m in models)):
                gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
                if any(p.grad is not None for p in ps):
                    total = gs[0].clone()
                    for g in gs[1:]:
                        total += g
                    ps[0].grad = total
            out = {k: sum(o[k].detach().float().reshape(()) for o in outs) for k in outs[0]}
            if not self.sparse_item_adam:
                return out, None, None
            return (out, torch.cat([ids for _, ids, _ in halves]),
                    torch.cat([s.grad for s in subs]))

    return RankOrderTrainer


def one_process_trainer(config, data, device, trainer_cls=None):
    """A single-process trainer of ``config`` (default class ``Trainer``)
    that evaluates in batches of a rank's eval rows, so that every user's
    embedding comes from a product of the ranks' shapes (the metrics do not
    depend on the batch; the products' rounding may). Returns (trainer,
    valid batcher, test batcher)."""
    from mhrec_tpu_torch.data import build_eval_dataloaders
    from mhrec_tpu_torch.trainer import Trainer

    config["eval_batch_size"] //= DIST_WORLD
    trainer = (trainer_cls or Trainer)(config, data, device=device)
    trainer.setup_model()
    return (trainer, *build_eval_dataloaders(config, data))


def rank_order_oracle(config, data, device, part=None):
    """The rank-order oracle's run of ``config`` over the hosts' batch
    parts (``part``: their batcher class): fit with the valid evaluation,
    then the test split of the parameters the fit left (the ranks' run
    evaluates them from its checkpoint, saved at the same last step; the
    oracle writes none). Returns its record and the trainer."""
    trainer, valid, test = one_process_trainer(config, data, device,
                                               rank_order_trainer_class())
    stats = trainer.fit(RankBatches(trainer.config, data, part), valid)
    result = trainer.evaluate(test)
    rec = {"final_loss": float(stats["loss"]), "losses": trainer.fetched_losses,
           "param_checksum": trainer.param_checksum(), "result": result,
           "steady_examples_per_s": stats["steady_examples_per_s"],
           "pool_probe_exact": trainer.probe_exact}
    return rec, trainer


def trainer_state(trainer, host=True):
    """Every parameter of a single-process trainer (the item table's row
    moments included), in ``params_apart``'s order; copied to host memory
    unless ``host`` is false."""
    ts = list(trainer.model.state_dict().values())
    if trainer.table_m is not None:
        ts += [trainer.table_m, trainer.table_v]
    return [t.detach().cpu() if host else t for t in ts]


def params_apart(a, b):
    """The largest |difference| over every parameter (the item tables, the
    row moments included) of two single-process trainers (or their
    ``trainer_state``), and how many elements differ at all."""
    import torch

    worst, n_diff = 0.0, 0
    pairs = list(zip(*(t if isinstance(t, list) else trainer_state(t, host=False)
                       for t in (a, b))))
    for x, y in pairs:
        d = (x.float() - y.to(x.device).float()).abs()
        worst = max(worst, float(d.max()))
        n_diff += int(torch.count_nonzero(d))
    return worst, n_diff


def metrics_close(got, want):
    """Ranking metrics and Entropy within DIST_TOL's: (all within, the
    largest difference of each kind, the first 20 metrics off, as
    (section/metric, got, want))."""
    worst = {"rank_metric": 0.0, "entropy": 0.0}
    off = []
    for section, metrics in want.items():
        for k, v in metrics.items():
            kind = "entropy" if k.startswith("Entropy") else "rank_metric"
            d = abs(got.get(section, {}).get(k, math.inf) - v)
            worst[kind] = max(worst[kind], d)
            if d > DIST_TOL[kind]:
                off.append((f"{section}/{k}", got.get(section, {}).get(k), v))
    return not off, worst, off[:20]


def gloo_ranks_start(out, spec):
    """Start DIST_WORLD ranks of ``chip_smoke.py --distributed-rank`` in
    processes of their own, over gloo, with ``spec`` written to
    ``{out}/spec.json``; ``gloo_ranks_finish`` waits for them."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "spec.json"), "w") as fh:
        json.dump(spec, fh)
    port = free_port()
    cmds = [[sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--distributed-rank",
             str(r), str(port), out] for r in range(DIST_WORLD)]
    return out, start_processes(cmds, [os.path.join(out, f"rank{r}.log")
                                       for r in range(DIST_WORLD)])


def gloo_ranks_finish(started):
    """The ranks' records of ``gloo_ranks_start``, or a failure record."""
    out, procs = started
    codes, tails = wait_processes(procs)
    if codes != [0] * DIST_WORLD:
        return {"exit_codes": codes, "log_tails": tails, "ok": False}
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    return ranks


def gloo_ranks(out, spec):
    """DIST_WORLD ranks of ``chip_smoke.py --distributed-rank`` over gloo,
    waited for. Returns the ranks' records, or a failure record."""
    return gloo_ranks_finish(gloo_ranks_start(out, spec))


def held_to_oracle(ranks, oracle, oracle_trainer, served, served_result, tags):
    """(the record, the checks) of a gloo run's ranks against the oracle
    (loss, checksum, metrics at DIST_TOL), against each other (loss and
    checksum, metrics equal), and their checkpoint evaluated by one process
    (``served``, its test metrics ``served_result``) against their metrics;
    the bytes a step of each collective of ``tags``."""
    r0, r1 = ranks
    between = max(abs(r0[k] - r1[k]) / abs(r1[k]) for k in ("final_loss", "param_checksum"))
    loss_rel = abs(r0["final_loss"] - oracle["final_loss"]) / abs(oracle["final_loss"])
    ck_rel = abs(r0["param_checksum"] - oracle["param_checksum"]) / oracle["param_checksum"]
    m_ok, worst, off = metrics_close(r0["result"], oracle["result"])
    s_ok, s_worst, s_off = metrics_close(r0["result"], served_result)
    p_worst, p_diff = params_apart(served, oracle_trainer)
    steps = r0["iters"]
    checks = {
        "metrics": m_ok, "checkpoint_served_by_one_process": s_ok,
        "loss": loss_rel <= DIST_TOL["loss"], "checksum": ck_rel <= DIST_TOL["checksum"],
        "between_ranks": between <= DIST_TOL["between_ranks"],
        "ranks_metrics_equal": r0["result"] == r1["result"],
        "zero_optimizer": all(r["optimizer_sharded"] == "ZeroShardedOptimizer" for r in ranks)}
    rec = {
        "label": "gloo, 2 ranks on one card", "final_loss_rel_diff": loss_rel,
        "checksum_rel_diff": ck_rel, "between_ranks_rel_diff": between,
        "max_metric_diff": worst, "metrics_beyond_tolerance": off,
        "served_max_metric_diff": s_worst, "served_metrics_beyond_tolerance": s_off,
        "params_max_abs_diff_vs_oracle": p_worst, "param_elements_differing": p_diff,
        "oracle_pool_probe_exact": oracle["pool_probe_exact"],
        "steady_examples_per_s": [r["steady_examples_per_s"] for r in ranks],
        "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "collective_bytes_per_step": {t: r0["collective_bytes"].get(t, 0) / steps
                                      for t in tags},
        "collective_bytes_run": r0["collective_bytes"],
        "seconds": [r["seconds"] for r in ranks]}
    return rec, checks


def checkpoints_apart(a, b):
    """(bit-equal, the largest difference of a tensor over its largest
    |value|) of every parameter, row moment and optimizer moment of two
    checkpoint files."""
    import torch

    pa, pb = (torch.load(p, map_location="cpu", weights_only=True, mmap=True) for p in (a, b))
    pairs = [(pa["params"][k], v) for k, v in pb["params"].items()]
    pairs += [(pa[k], pb[k]) for k in ("table_m", "table_v") if k in pb]
    for i, st in pb["optimizer"]["state"].items():
        pairs += [(pa["optimizer"]["state"][i][k], st[k]) for k in ("exp_avg", "exp_avg_sq")]
    equal, worst = len(pa["params"]) == len(pb["params"]), 0.0
    for x, y in pairs:
        if x.shape != y.shape:
            return False, math.inf
        if not torch.equal(x, y):
            equal = False
            worst = max(worst, float((x.float() - y.float()).abs().max())
                        / max(float(y.float().abs().max()), 1e-30))
    return equal, worst


def fsdp_held(ranks, zero2, fsdp_ok_names):
    """(f)'s record and checks of a gloo FSDP run's ``ranks`` beside the
    same model's ZeRO-2 ranks ``zero2``: the checkpoints bit-equal (or
    within DIST_FSDP_RTOL of the largest value), every rank's persistent
    bytes below the ZeRO-2 rank's, the sharded parameters' blocks half of
    them, no whole sharded parameter or gradient alive after a step, and
    FSDP's collectives run."""
    equal, worst = checkpoints_apart(ranks[0]["checkpoint"], zero2[0]["checkpoint"])
    per_rank = []
    for r, z in zip(ranks, zero2):
        got, want = r["persistent_bytes"], z["persistent_bytes"]
        per_rank.append({
            "rank": r["rank"], "persistent_gb": {k: v / 1e9 for k, v in got.items()},
            "zero2_persistent_gb": {k: v / 1e9 for k, v in want.items()},
            "total_gb": sum(got[k] for k in ("params", "grads", "moments", "table")) / 1e9,
            "zero2_total_gb": sum(want[k] for k in ("params", "grads", "moments", "table")) / 1e9,
            "live_whole_after_steps": r["fsdp_live_whole"],
            "sharded_params": len(r["fsdp_params"]),
            "sharded_elements": sum(n for n, _ in r["fsdp_params"].values()),
            "peak_mem_gb": r["peak_mem_gb"], "zero2_peak_mem_gb": z["peak_mem_gb"]})
    steps = ranks[0]["iters"]
    checks = {
        "params_and_moments_as_zero2": equal or worst <= DIST_FSDP_RTOL,
        "persistent_below_zero2": all(p["total_gb"] < p["zero2_total_gb"] for p in per_rank),
        "blocks_halve": all(k == -(-n // DIST_WORLD) for r in ranks
                            for n, k in r["fsdp_params"].values()) and bool(ranks[0]["fsdp_params"]),
        "sharded_set": fsdp_ok_names(ranks[0]["fsdp_params"]),
        "no_whole_between_steps": all(r["fsdp_live_whole"] == 0 for r in ranks),
        "fsdp_collectives": all(r["collective_bytes"].get(t, 0) > 0 for r in ranks
                                for t in ("fsdp_gather", "fsdp_reduce_scatter", "fsdp_save"))}
    rec = {"bit_equal_to_zero2": equal, "max_scaled_diff_vs_zero2": worst, "ranks": per_rank,
           "fsdp_collective_bytes_per_step": {
               t: ranks[0]["collective_bytes"].get(t, 0) / steps
               for t in ("fsdp_gather", "fsdp_reduce_scatter")}}
    return rec, checks


def distributed_hllm(work_dir, device, over, tower_over, data_kw=DIST_HLLM_DATA):
    """(c): HLLM over two gloo ranks on the one card (``hllm_dist_config``,
    towers from ``write_dist_hllm_tower``), over ``data_kw``, held to
    the rank-order oracle, to each other and to their checkpoint served by
    one process; the launches of #8a–c a rank must be what the layers and
    steps give (the forward and its recompute, the backward; the corpus
    pass is the dense one and launches none). Returns (its record, the
    ranks' launches)."""
    import torch

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
    from mhrec_tpu_torch.parallel import fsdp_params

    pretrain_dir = write_dist_hllm_tower(work_dir, tower_over)
    out = os.path.join(work_dir, "hllm")
    started = gloo_ranks_start(out, {
        "model": "hllm", "device": "cuda:0" if device == "cuda" else device,
        "pretrain_dir": pretrain_dir, "data": data_kw, "over": over})
    data = InMemoryInteractionData(**data_kw)
    try:
        # the oracle meanwhile, in this process
        oracle, oracle_trainer = rank_order_oracle(
            hllm_dist_config(pretrain_dir, os.path.join(work_dir, "hllm_oracle"), **over),
            data, device, TextSEQTrainBatcher)
    finally:
        ranks = gloo_ranks_finish(started)
    if isinstance(ranks, dict):
        return ranks, None, None
    # the ranks' checkpoint, evaluated by one process
    served, _, test = one_process_trainer(hllm_dist_config(pretrain_dir, out, **over),
                                          data, device)
    served_result = served.evaluate(test, load_best_model=True)
    rec, checks = held_to_oracle(ranks, oracle, oracle_trainer, served, served_result,
                                 DIST_HLLM_TAGS)
    del served
    if device == "cuda":
        torch.cuda.empty_cache()
    # (f): the same under fsdp, against the oracle and against these ranks
    t_f = time.perf_counter()
    f_out = os.path.join(work_dir, "hllm_fsdp")
    f_over = dict(over, fsdp=True)
    f_ranks = gloo_ranks(f_out, {"model": "hllm", "device": "cuda:0" if device == "cuda"
                                 else device, "pretrain_dir": pretrain_dir, "data": data_kw,
                                 "over": f_over})
    if isinstance(f_ranks, dict):
        f_rec = dict(f_ranks)
    else:
        served, _, test = one_process_trainer(hllm_dist_config(pretrain_dir, f_out, **f_over),
                                              data, device)
        f_rec, f_checks = held_to_oracle(f_ranks, oracle, oracle_trainer, served,
                                         served.evaluate(test, load_best_model=True),
                                         DIST_HLLM_TAGS + DIST_FSDP_TAGS)
        del served
        want_set = set(fsdp_params(oracle_trainer.model.named_parameters(), DIST_WORLD,
                                   over.get("fsdp_min_size", 1 << 20)))
        held, more = fsdp_held(f_ranks, ranks, lambda names: set(names) == want_set)
        f_rec.update(held)
        f_checks.update(more)
        f_checks["launches"] = all(r["launches"][k] == n for r in f_ranks for k, n in {
            "packed_attn_fwd": 2 * DIST_HLLM_LAYERS * f_ranks[0]["iters"],
            "packed_attn_bwd": DIST_HLLM_LAYERS * f_ranks[0]["iters"]}.items())
        f_rec.update(model="(c) under fsdp: true", checks=f_checks, ok=all(f_checks.values()),
                     launches=[r["launches"] for r in f_ranks])
    f_rec["seconds_phase"] = time.perf_counter() - t_f
    del oracle_trainer
    remove_dirs(out, f_out, pretrain_dir)
    if device == "cuda":
        torch.cuda.empty_cache()
    layers = DIST_HLLM_LAYERS
    steps = ranks[0]["iters"]
    want = {"packed_attn_fwd": 2 * layers * steps, "packed_attn_bwd": layers * steps}
    checks["launches"] = all(r["launches"][k] == n for r in ranks for k, n in want.items())
    checks["steps"] = steps == over.get("total_iters", DIST_HLLM_STEPS)
    rec.update(model="HLLM, TinyLlama-1.1B width, %d + %d layers, float32" % (layers, layers),
               steps=steps, global_batch=HLLM_TRAIN_BATCH, launches_expected=want,
               dense_params=ranks[0]["dense_params"], corpus_batch=ranks[0].get("corpus_batch"),
               persistent_gb=[{k: v / 1e9 for k, v in r["persistent_bytes"].items()}
                              for r in ranks],
               checks=checks, ok=all(checks.values()))
    return rec, ranks[0]["launches"], f_rec


def baseline_dist_config(family, checkpoint_dir, user_dir, **over):
    """(d)'s config of ``family``: ``baseline_config`` at the global batch
    DIST_BASE_BATCH for DIST_BASE_STEPS steps with an evaluation and a save
    at the last, every step's loss read, DIST_BASE_POSITION_NEGATIVES a
    position for SASRec and LLMIDRec."""
    d = dict(train_batch_size=DIST_BASE_BATCH, total_iters=DIST_BASE_STEPS,
             eval_interval=DIST_BASE_STEPS, update_interval=1)
    if family in ("SASRec", "LLMIDRec"):
        d["num_negatives"] = DIST_BASE_POSITION_NEGATIVES
    d.update(over)
    return baseline_config(family, checkpoint_dir, user_dir, **d)


def distributed_baselines(work_dir, device, data_kw, over, tower_over, families=None):
    """(d): the baselines over two gloo ranks on the one card, the families
    one after another in one pair of rank processes (``dist_rank``'s
    "baselines"), while this process runs each family's rank-order oracle;
    then each family's ranks are held to its oracle, to each other and to
    their checkpoint served by one process (``held_to_oracle``), and their
    launches to what the family's layers and steps give: #7 once a step,
    ComiRec's and REMI's float32 trunk #4 once a layer a step and #1 once a
    layer a forward, no other kernel. ``over`` cuts the configs and
    ``tower_over`` LLMIDRec's tower (the CPU tests); ``families``: default
    every family of BASELINE_FILES. Returns (the record of each family, the
    launches of each family's rank 0)."""
    import torch

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

    families = tuple(families or BASELINE_FILES)
    user_dir = os.path.join(work_dir, "base_user_llm")
    os.makedirs(user_dir, exist_ok=True)
    with open(os.path.join(user_dir, "config.json"), "w") as fh:
        json.dump(dict(TINYLLAMA_1B, num_hidden_layers=DIST_BASE_LLM_LAYERS, **tower_over), fh)
    out = os.path.join(work_dir, "baselines")
    started = gloo_ranks_start(out, {
        "model": "baselines", "device": "cuda:0" if device == "cuda" else device,
        "data": data_kw, "families": list(families), "user_dir": user_dir, "over": over})
    data = InMemoryInteractionData(**data_kw)
    oracles = {}
    try:
        for family in families:
            oracle, trainer = rank_order_oracle(baseline_dist_config(
                family, os.path.join(work_dir, f"base_oracle_{family}"), user_dir,
                **dict(over, sparse_adam_global_dedup=True)), data, device)
            oracles[family] = (oracle, trainer_state(trainer))
            del trainer
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        ranks = gloo_ranks_finish(started)
    if isinstance(ranks, dict):
        return {"all": ranks}, {}
    recs, launches = {}, {}
    for family in families:
        fam = [r["families"][family] for r in ranks]
        config = baseline_dist_config(family, os.path.join(out, family), user_dir, **over)
        served, _, test = one_process_trainer(config, data, device)
        served_result = served.evaluate(test, load_best_model=True)
        oracle, oracle_state = oracles.pop(family)
        rec, checks = held_to_oracle(fam, oracle, oracle_state, served, served_result,
                                     DIST_BASE_TAGS)
        del served, oracle_state
        if device == "cuda":
            torch.cuda.empty_cache()
        steps = fam[0]["iters"]
        layers = int(config["n_layers"]) if family in ("ComiRec", "REMI") else 0
        want = {"row_adamw": steps, "hstu_stu_gated_bwd": layers * steps}
        checks["launches"] = all(
            all(r["launches"][k] == want.get(k, 0) for k in r["launches"]
                if k != "hstu_stu_gated_fwd")
            and (r["launches"]["hstu_stu_gated_fwd"] > layers * steps if layers
                 else r["launches"]["hstu_stu_gated_fwd"] == 0) for r in fam)
        checks["steps"] = steps == config["total_iters"]
        rec.update(family=family, files=list(BASELINE_FILES[family]), steps=steps,
                   global_batch=config["train_batch_size"],
                   num_negatives=config["num_negatives"], stu_layers=layers,
                   launches_expected=dict(want, hstu_stu_gated_fwd=f"> {layers * steps}"
                                          if layers else 0),
                   dense_params=fam[0]["dense_params"], checks=checks,
                   ok=all(checks.values()))
        recs[family] = rec
        launches[family] = fam[0]["launches"]
    remove_dirs(out, user_dir)
    return recs, launches


def table_memory(run, ref, rank):
    """(e)'s checks of one rank's run against its reference run (the same
    protocol at a small catalog): every tensor of the table's rows and
    width that the run made was the host assembly of the checkpoint on rank
    0 (``save``) or a checkpoint read into host memory (``load``), never on
    the card; and no phase took DIST_TABLE_COPY_SHARE of the two whole
    tables' difference beyond the reference run's same phase (its
    activations). Returns (the record, ok)."""
    gb = 1e9
    T, T_ref = run["whole_table_bytes"], ref["whole_table_bytes"]
    limit = DIST_TABLE_COPY_SHARE * (T - T_ref)
    hits = run["table_hits"]
    hits_ok = all(dev == "cpu" and (phase == "load" or (phase == "save" and rank == 0))
                  for phase, _, _, dev in hits)
    rec = {"whole_table_gb": T / gb,
           "block_and_moments_gb": run["table_bytes"] / gb, "table_hits": len(hits),
           "table_hits_by_phase_device": sorted({(p, d) for p, _, _, d in hits}),
           "table_hits_ok": hits_ok}
    ok = hits_ok
    if run.get("phase_mem"):
        beyond = {p: run["phase_mem"][p] - ref["phase_mem"].get(p, 0) for p in run["phase_mem"]}
        mem_ok = all(v < limit for v in beyond.values())
        rec.update(peak_gb=run["peak_bytes"] / gb,
                   phase_gb={p: v / gb for p, v in run["phase_mem"].items()},
                   ref_phase_gb={p: v / gb for p, v in ref["phase_mem"].items()},
                   beyond_ref_gb={p: v / gb for p, v in beyond.items()},
                   limit_gb=limit / gb, no_whole_table_in_peak=mem_ok)
        ok &= mem_ok
    return rec, ok


def distributed_table(work_dir, device, data_kw, over, items, ref_steps):
    """(e): HSTU size4 in (b)'s protocol, 1 step, the table row-sharded,
    over two gloo ranks on the one card, at each catalog of ``items`` (the
    reference first, then the measured one; ``fit`` with its evaluation and
    save, no test split) in one pair of rank processes
    (``dist_rank``'s "table"), through ``phase_trainer_class`` under a
    TableWatch: each rank's peak and each phase's memory beside the whole
    table's bytes, and ``table_memory``'s checks; the bytes of the
    evaluations' chunk fetches; #7 once a step a rank. The reference run
    takes ``ref_steps`` steps, (b)'s, so that it also measures (b)'s phases
    (a later step frees the gradients of the one before). Returns (its
    record, the measured run's rank-0 launches, the reference run's rank
    records)."""
    out = os.path.join(work_dir, "table")
    steps = {str(items[0]): ref_steps, str(items[1]): 1}
    ranks = gloo_ranks(out, {"model": "table", "device": "cuda:0" if device == "cuda" else device,
                             "data": data_kw, "items": list(items), "steps": steps,
                             "over": over})
    if isinstance(ranks, dict):
        return ranks, None, None
    ref_key, run_key = (str(n) for n in items)
    checks, per_rank = {"memory": True, "launches": True}, []
    for r in ranks:
        run, ref = r["runs"][run_key], r["runs"][ref_key]
        mem, ok = table_memory(run, ref, r["rank"])
        # the valid and the test split's evaluations
        mem.update(rank=r["rank"], seconds=run["seconds"], ref_seconds=ref["seconds"],
                   table_chunk_bytes_per_eval=(run["collective_bytes"].get("table_chunk", 0)
                                               / run["evaluations"]),
                   table_save_bytes=run["collective_bytes"].get("table_save", 0),
                   launches=run["launches"])
        per_rank.append(mem)
        checks["memory"] &= ok
        checks["launches"] &= run["launches"]["row_adamw"] == run["iters"]
    rec = {"label": "gloo, 2 ranks on one card, the table row-sharded",
           "items": int(run_key), "reference_items": int(ref_key), "ranks": per_rank,
           "steps": ranks[0]["runs"][run_key]["iters"], "checks": checks,
           "ok": all(checks.values())}
    return rec, ranks[0]["runs"][run_key]["launches"], [r["runs"][ref_key] for r in ranks]


def distributed_fsdp_hstu(disk_dir, device, data_kw, gloo_over, data, oracle, oracle_trainer,
                          zero2):
    """(f)'s HSTU: (b)'s gloo run under ``zero_stage: 3`` at the default
    ``fsdp_min_size`` (FSDP's rule picks the table too, which is then the
    row-sharded one), held to (b)'s oracle (``held_to_oracle``), to (b)'s
    sharded ZeRO-2 ranks ``zero2`` (``fsdp_held``), its launches to (b)'s.
    Returns (its record, rank 0's launches)."""
    from mhrec_tpu_torch.parallel import fsdp_params

    out = os.path.join(disk_dir, "fsdp_hstu")
    over = dict(gloo_over, zero_stage=3)
    ranks = gloo_ranks(out, {"device": "cuda:0" if device == "cuda" else device,
                             "shard": False, "data": data_kw, "over": over})
    if isinstance(ranks, dict) or not isinstance(zero2, list):
        return (ranks if isinstance(ranks, dict) else {"ok": False, "zero2": zero2}), None
    served, _, test = one_process_trainer(
        base_config(**dist_overrides(DIST_RANK_BATCH * DIST_WORLD, os.path.join(out, "ckpt"),
                                     **over)), data, device)
    rec, checks = held_to_oracle(ranks, oracle, oracle_trainer, served,
                                 served.evaluate(test, load_best_model=True),
                                 DIST_STEP_TAGS + DIST_FSDP_TAGS)
    del served
    table_key = "item_embedding.weight"
    want = set(fsdp_params(oracle_trainer.model.named_parameters(), DIST_WORLD,
                           over.get("fsdp_min_size", 1 << 20)))
    held, more = fsdp_held(ranks, zero2, lambda names: table_key in want
                           and set(names) == want - {table_key})
    rec.update(held)
    checks.update(more)
    checks["table_row_sharded"] = all(
        r["table_rows"] == z["table_rows"] for r, z in zip(ranks, zero2))
    steps, layers = ranks[0]["iters"], int(base_config(**over)["n_layers"])
    want_launches = {"hstu_stu_gated_bwd": layers * steps, "row_adamw": steps}
    checks["launches"] = (
        all(r["launches"][k] == n for r in ranks for k, n in want_launches.items())
        and all(r["launches"]["hstu_stu_gated_fwd"] > layers * steps for r in ranks))
    rec.update(model="(b) under zero_stage: 3", launches=[r["launches"] for r in ranks],
               checks=checks, ok=all(checks.values()))
    return rec, ranks[0]["launches"]


def progress(part, t0, ok):
    """A line that says which part of the distributed phase has ended, at
    how many seconds into it, and whether every check so far held."""
    emit({"phase": "distributed_progress", "part": part,
          "seconds": time.perf_counter() - t0, "ok": bool(ok)})


def distributed_phase(work_dir, smi, device="cuda", data_kw=DIST_HSTU_DATA, hllm_over=None,
                      hllm_tower=None, hllm_data=DIST_HLLM_DATA, base_over=None,
                      base_tower=None, base_data=DIST_BASE_DATA, table_data=None,
                      table_items=(DIST_TABLE_REF_ITEMS, DIST_TABLE_ITEMS), disk_dir=None,
                      **over):
    """The data-parallel path on the card: (a) ``world1_cli_runs`` (HSTU
    size4, the train phase's prior protocol); (b) two ranks of that HSTU
    over gloo on the one card (``dist_rank`` in processes of their own;
    NCCL refuses two ranks on one device), the item table replicated and
    then row-sharded, each held to the rank-order oracle
    (``rank_order_oracle``) at DIST_TOL, the two ranks to each other, the
    sharded run's per-rank table bytes to half the replicated run's and its
    memory to ``table_memory``'s checks against (e)'s reference run; (c)
    ``distributed_hllm``; (d) ``distributed_baselines``; (e)
    ``distributed_table``; and the record: examples/s, peak memory per
    rank, the launches of the kernels, the bytes a step of each collective
    and the seconds, beside the card's name and power limit. The gloo rates
    are correctness runs (both ranks on one card, gloo staging through host
    memory), not scaling numbers. ``device`` "cpu" and config overrides
    ``over`` (HSTU), ``hllm_over`` (HLLM), ``hllm_tower`` (the towers'
    ``config.json``), ``base_over`` / ``base_tower`` (the baselines and
    LLMIDRec's tower), the catalogs ``data_kw`` / ``hllm_data`` /
    ``base_data`` / ``table_data`` and (e)'s ``table_items`` rehearse it at a
    few widths without the card. (b)-(d) keep their files under ``disk_dir``
    (default ``work_dir``), (a) and (e) under ``work_dir``. Returns
    (launches of each run, ok)."""
    import torch

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

    t0 = time.perf_counter()
    disk_dir = disk_dir or work_dir
    rec = {"phase": "distributed", "card": smi, "steps": over.get("total_iters", DIST_STEPS),
           "gloo_steps": over.get("total_iters", DIST_GLOO_STEPS),
           "rank_batch": DIST_RANK_BATCH}
    rec["world1_nccl_cli"] = world1_cli_runs(work_dir, device, data_kw, over)
    ok = rec["world1_nccl_cli"]["ok"]
    progress("a", t0, ok)
    launches = {}
    if "launches" in rec["world1_nccl_cli"]:
        launches["distributed_world1_nccl"] = rec["world1_nccl_cli"]["launches"]["grouped"]
    # (b) computes the trunk in float32, so that the oracle comparison sees
    # the data-parallel arithmetic and not bf16 rounding grown over 16
    # layers (#1 and #4 take their float32 routes), for DIST_GLOO_STEPS
    gloo_over = dict(dict(total_iters=DIST_GLOO_STEPS, eval_interval=DIST_GLOO_STEPS),
                     **over, compute_dtype="float32")
    # the replicated run, with the oracle in this process meanwhile, then
    # the sharded one (side by side, four ranks' evaluations overfill the
    # card)
    runs = {}
    data = InMemoryInteractionData(**data_kw)
    for shard, name in ((False, "replicated"), (True, "sharded")):
        started = gloo_ranks_start(os.path.join(disk_dir, name), {
            "device": "cuda:0" if device == "cuda" else device, "shard": shard,
            "data": data_kw, "over": gloo_over})
        try:
            if not shard:
                t_oracle = time.perf_counter()
                oracle, oracle_trainer = rank_order_oracle(
                    base_config(**dist_overrides(DIST_RANK_BATCH * DIST_WORLD,
                                                 os.path.join(disk_dir, "oracle"), **gloo_over,
                                                 sparse_adam_global_dedup=True)), data, device)
                oracle_seconds = time.perf_counter() - t_oracle
        finally:
            runs[name] = gloo_ranks_finish(started)
        if isinstance(runs[name], list):
            launches[f"distributed_gloo_{name}"] = runs[name][0]["launches"]
    rec["oracle"] = {k: oracle[k] for k in ("final_loss", "param_checksum",
                                            "steady_examples_per_s", "pool_probe_exact")}
    rec["oracle"]["seconds"] = oracle_seconds
    for name, ranks in runs.items():
        if isinstance(ranks, dict):
            rec[f"gloo_{name}"] = ranks
            ok = False
            continue
        # the checkpoint the ranks wrote, evaluated by one process: the
        # distributed evaluation's half of the oracle comparison, on the
        # same parameters; and those parameters against the oracle's
        served, _, test = one_process_trainer(
            base_config(**dist_overrides(DIST_RANK_BATCH * DIST_WORLD,
                                         os.path.join(disk_dir, name, "ckpt"), **gloo_over)),
            data, device)
        run_rec, checks = held_to_oracle(ranks, oracle, oracle_trainer, served,
                                         served.evaluate(test, load_best_model=True),
                                         DIST_STEP_TAGS)
        del served
        steps = ranks[0]["iters"]
        layers = int(base_config(**over)["n_layers"])
        want = {"hstu_stu_gated_bwd": layers * steps, "row_adamw": steps}
        checks["launches"] = (
            all(r["launches"][k] == n for r in ranks for k, n in want.items())
            and all(r["launches"]["hstu_stu_gated_fwd"] > layers * steps for r in ranks))
        run_rec.update(table_rows=[r["table_rows"] for r in ranks],
                       table_bytes=[r["table_bytes"] for r in ranks],
                       phase_mem_gb=[{p: v / 1e9 for p, v in r.get("phase_mem", {}).items()}
                                     for r in ranks],
                       table_chunk_bytes_per_eval=[
                           r["collective_bytes"].get("table_chunk", 0) / r["evaluations"]
                           for r in ranks],
                       checks=checks, ok=all(checks.values()))
        rec[f"gloo_{name}"] = run_rec
        ok &= run_rec["ok"]
    # (f): (b)'s HSTU under zero_stage 3, the table row-sharded through
    # FSDP's rule, against (b)'s oracle and (b)'s sharded ZeRO-2 ranks
    t_f = time.perf_counter()
    rec["gloo_fsdp_hstu"], f_launches = distributed_fsdp_hstu(
        disk_dir, device, data_kw, gloo_over, data, oracle, oracle_trainer, runs.get("sharded"))
    rec["gloo_fsdp_hstu"]["seconds_phase"] = time.perf_counter() - t_f
    if f_launches is not None:
        launches["distributed_gloo_fsdp_hstu"] = f_launches
    ok &= rec["gloo_fsdp_hstu"].get("ok", False)
    del oracle_trainer
    remove_dirs(*(os.path.join(disk_dir, name, "ckpt") for name in runs),
                os.path.join(disk_dir, "fsdp_hstu"))
    if device == "cuda":
        # the oracle's replicas and cached blocks leave the card to (c)'s ranks
        torch.cuda.empty_cache()
    if all(isinstance(runs.get(n), list) for n in ("replicated", "sharded")):
        halved = all(2 * s["table_bytes"] == r["table_bytes"]
                     for s, r in zip(runs["sharded"], runs["replicated"]))
        rec["sharded_table_bytes_halved"] = halved
        ok &= halved
    progress("b", t0, ok)
    t_hllm = time.perf_counter()
    rec["gloo_hllm"], hllm_launches, rec["gloo_fsdp_hllm"] = distributed_hllm(
        disk_dir, device, hllm_over or {}, hllm_tower or {}, hllm_data)
    rec["gloo_hllm"]["seconds_phase"] = time.perf_counter() - t_hllm
    f_hllm = rec["gloo_fsdp_hllm"] or {}
    if hllm_launches is not None:
        launches["distributed_gloo_hllm"] = hllm_launches
    if "launches" in f_hllm:
        launches["distributed_gloo_fsdp_hllm"] = f_hllm["launches"][0]
    ok &= rec["gloo_hllm"]["ok"] and f_hllm.get("ok", False)
    progress("c", t0, ok)
    # (d): the baselines
    t_base = time.perf_counter()
    base_over = dict(base_over or {})
    base_recs, base_launches = distributed_baselines(disk_dir, device, base_data, base_over,
                                                     base_tower or {})
    rec["gloo_baselines"] = base_recs
    rec["gloo_baselines_seconds"] = time.perf_counter() - t_base
    for family, fam_launches in base_launches.items():
        launches[f"distributed_gloo_{family}"] = fam_launches
    ok &= bool(base_launches) and all(r.get("ok", False) for r in base_recs.values())
    progress("d", t0, ok)
    # (e): the sharded table's memory, and (b)'s sharded run against the
    # same reference run
    t_table = time.perf_counter()
    table_data = table_data or dict(HSTU_DATA, num_users=DIST_TABLE_USERS)
    rec["gloo_table"], table_launches, table_ref = distributed_table(
        work_dir, device, table_data, dict(over, compute_dtype="float32"), table_items,
        ref_steps=gloo_over["total_iters"])
    rec["gloo_table"]["seconds_phase"] = time.perf_counter() - t_table
    if table_launches is not None:
        launches["distributed_gloo_table"] = table_launches
    ok &= rec["gloo_table"]["ok"]
    if table_ref is not None and isinstance(runs.get("sharded"), list):
        memory = [table_memory(r, ref, r["rank"]) for r, ref in zip(runs["sharded"], table_ref)]
        rec["gloo_sharded"]["table_memory"] = [m for m, _ in memory]
        rec["gloo_sharded"]["checks"]["table_memory"] = all(mem_ok for _, mem_ok in memory)
        rec["gloo_sharded"]["ok"] = all(rec["gloo_sharded"]["checks"].values())
        ok &= rec["gloo_sharded"]["ok"]
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = bool(ok)
    emit(rec)
    return launches, ok


# -- a reference checkpoint: conversion, then serving -------------------------
def reference_hstu_state_dict(params):
    """The names under which the reference saves an HSTU's parameters
    (``params``: the port's, by name; hstu.py:380-543), the inverse of
    ``convert_reference.convert_hstu``: the STU blocks under
    ``_hstu._attention_layers`` (their norms have no parameters there and
    are left out), the ResBlocks of a head an ``nn.Sequential``."""
    import re

    rules = ((r"^stu_layers\.(\d+)\.uvqk$", r"_hstu._attention_layers.\1._uvqk"),
             (r"^stu_layers\.(\d+)\.o_proj\.", r"_hstu._attention_layers.\1._o."),
             (r"^rel_bias\.(\d+)\.(ts_w|pos_w)$", r"_hstu._attention_layers.\1._rel_attn_bias._\2"),
             (r"^item_proj\.", "item_id_proj_tower."),
             (r"^(medusa_head\.\d+)\.res\.", r"\1."),
             (r"^(medusa_cat_head\.\d+)\.0\.res\.", r"\1."),
             (r"^(medusa_seg_head\.\d+\.\d+)\.res\.", r"\1."),
             (r"^(medusa_seg_head\.\d+)\.res\.", r"\1.0."))
    out = {}
    for k, v in params.items():
        if re.match(r"^stu_layers\.\d+\.(input_norm|attn_norm)\.", k):
            continue
        for pattern, repl in rules:
            k = re.sub(pattern, repl, k)
        out[k] = v
    return out


# the reference checkpoint's users: (a serve run's 4,096 on its catalog)
REFERENCE_USERS = 4096


def reference_ckpt_phase(data_kw, work_dir, device="cuda", **over):
    """A reference-format checkpoint of HSTU size4 (``serve_config``'s
    model) over ``data_kw``'s catalog: the port's parameters from seed 1
    with the STU norms at the reference's identity, saved under the
    reference's names (``reference_hstu_state_dict``) as DeepSpeed's fp32
    merge writes ``full_model_fp32.pt`` (``{"state_dict": ...}``, every
    name prefixed ``_forward_module.``); converted by the port's CLI
    (``convert_reference.main``) and served by ``run.main(... --val_only
    True)`` on ``device``, launches counted from 0 just before. Its metrics
    must equal, bit for bit, those of the same tensors put straight into a
    model (``load_state_dict``) and evaluated. Returns (launches, ok)."""
    import torch

    from mhrec_tpu_torch import convert_reference, run as run_mod
    from mhrec_tpu_torch.data import build_eval_dataloaders
    from mhrec_tpu_torch.trainer import Trainer

    cli_over = dict(dict(seed=1, synthetic_data=data_kw, checkpoint_dir=work_dir), **over)
    config = base_config(**dict(cli_over, val_only=True))
    data = run_mod.load_data(config)  # the CLI's: the catalog's category names
    # the tensors put straight into a model, evaluated
    trainer = Trainer(config, data, device=device)
    trainer.setup_model()
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            if ".input_norm." in name or ".attn_norm." in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
    params = {k: v.detach().cpu() for k, v in trainer.model.named_parameters()}
    _, test = build_eval_dataloaders(config, data)
    direct = trainer.evaluate(test)
    del trainer
    path = os.path.join(work_dir, "full_model_fp32.pt")
    ref = {f"_forward_module.{k}": v for k, v in reference_hstu_state_dict(params).items()}
    torch.save({"state_dict": ref, "epoch": 0}, path)
    ckpt_bytes = os.path.getsize(path)
    del ref
    argv = ["--config_file", *HSTU_FILES, "--", "--device", device]
    for k, v in hstu_overrides(**cli_over).items():
        if k != "int_to_category":  # the CLI takes the catalog's (run.load_data)
            argv += [f"--{k}", json.dumps(v) if isinstance(v, (dict, list, bool)) else str(v)]
    t0 = time.perf_counter()
    conv = convert_reference.main(["--ckpt", path] + argv)
    convert_s = time.perf_counter() - t0
    reset_launches()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = run_mod.main(argv + ["--val_only", "True"])
    if device == "cuda":
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    want_launches = {"hstu_stu_gated_fwd": 16 * -(-REFERENCE_USERS // config["eval_batch_size"])}
    checks = {"served_equals_direct": served == direct, "no_missing": not conv["missing"],
              "no_unused": not conv["unused"], "used_every_tensor": conv["used"] == len(params)
              - sum(1 for k in params if ".input_norm." in k or ".attn_norm." in k),
              "launches": all(launches[k] == n for k, n in want_launches.items())
              and all(n == 0 for k, n in launches.items() if k not in want_launches)}
    rec = {"phase": "reference_ckpt", "items": int(data.item_num), "users": len(test),
           "checkpoint_gb": ckpt_bytes / 1e9, "tensors": conv["used"],
           "convert_seconds": convert_s, "read_s": conv["read_s"],
           "map_and_load_s": conv["convert_s"],
           "read_gb_per_s": conv["bytes"] / 1e9 / max(conv["read_s"], 1e-9),
           "convert_gb_per_s": ckpt_bytes / 1e9 / max(convert_s, 1e-9),
           "serve_seconds": serve_s, "launches": launches, "launches_expected": want_launches,
           "missing": conv["missing"][:10], "unused": conv["unused"][:10], "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    return launches, rec["ok"]


# -- hstu-1b: the largest HSTU of the reference's ladder ----------------------
HSTU_1B_FILES = ("IDNet/hstu-1b.yaml", "overall/ID.yaml", "IDNet/hstu.yaml")
# batch 32, as the JAX package's 1b ladder row trains it (BASELINE.md:48).
# Steps of each training variant: if the script runs long, these are cut
# first, never the width or the depth
HSTU_1B_BATCH = 32
# 20 until the distributed phase joined the script, 10 until its baselines
# and sharded-table runs joined it, 6 until its FSDP runs joined it
HSTU_1B_STEPS = 3
# steps of each turn of the loop / stacked timing (loop, stacked, stacked,
# loop); 5 until the distributed phase joined the script, 3 until its FSDP
# runs joined it
HSTU_1B_TURN_STEPS = 2
# the stacked prior loss against the loop on one batch, on a float32 copy
# of the model: the loss to this relative difference and each gradient
# tensor to STACKED_GRAD_TOL (relative L2). The two paths differ only in the
# order of the categories' f32 sums, which on the H100 read 9.5e-8 and
# 6.5e-8 (PERF.md §6); one of the 8 categories' slices taken wrong (a mask,
# a weight, a false-negative table) changes that category's loss term
# outright
STACKED_LOSS_TOL = 1e-5
STACKED_GRAD_TOL = 1e-4


def hstu_1b_config(checkpoint_dir, **over):
    """hstu-1b (IDNet/hstu-1b.yaml: 22 layers, 2048 wide, 32 heads of 64,
    dropout 0.2) with ``scan_layers`` in the train phase's prior protocol
    (train_config: 8 categories, 4 segment heads, additive heads, one medusa
    layer, the switch, the weighted prior loss, 8192 negatives a category,
    ``pred_len`` 8, window 50, ``sparse_item_adam``) at batch HSTU_1B_BATCH
    for HSTU_1B_STEPS steps; per-layer relative bias off, which
    ``scan_layers`` refuses. ``over``: further settings."""
    cfg = base_config(
        files=HSTU_1B_FILES, scan_layers=True, enable_relative_attention_bias=False,
        train_batch_size=HSTU_1B_BATCH, num_negatives=8192, neg_sample_by_cat=True,
        weighted_prior_loss=True, prior_switch_loss_weight=0.1, sparse_item_adam=True,
        optim_args={"learning_rate": 1e-4, "weight_decay": 0.0},
        total_iters=HSTU_1B_STEPS, eval_interval=HSTU_1B_STEPS, update_interval=5,
        checkpoint_dir=checkpoint_dir)
    for key, value in over.items():
        cfg[key] = value
    return cfg


def hstu_train_flops(config) -> int:
    """Model FLOPs of one HSTU train step: three times the forward's
    products (forward and backward) for the trunk's projections (uvqk,
    o_proj) and causal attention, the medusa heads and the loss's
    differentiable products (negative logits, banded partition sums,
    positive logits; the shared NCE over the segment heads and one per prior
    category), once the false-negative tables, which take no gradient.
    Elementwise work is left out."""
    B, L, P = config["train_batch_size"], config["MAX_ITEM_LIST_LENGTH"], config["pred_len"]
    D, layers, H = config["hstu_embedding_size"], config["n_layers"], config["n_heads"]
    S, C = config["num_segment_head"], config["num_prior_head"]
    M = B * math.ceil(config["num_negatives"] / B)  # negatives a pool
    J = L + P - 1
    tokens = B * L
    trunk = layers * (2 * tokens * 5 * D * D + 2 * (B * H * L * (L + 1) // 2) * 2 * (D // H))
    heads = (S + C) * config["medusa_num_layers"] * 2 * tokens * D * D
    nce_heads = S + C  # the shared NCE's distinct heads, then one per category
    grad_products = nce_heads * (2 * B * L * M * D + 2 * B * L * M * J + 2 * B * L * J * D)
    fixed_products = (1 + C) * 2 * B * J * M * D
    return 3 * (trunk + heads + grad_products) + fixed_products


def _metric_values(result):
    return [v for sec in result.values() for v in sec.values()]


def _overall(result):
    """The metric sections without their per-category entries."""
    return {sec: {m: v for m, v in vals.items() if "-" not in m} for sec, vals in result.items()}


def _timed_steps(trainer, stream, steps):
    """Examples/s of ``steps`` train steps, the card synchronised at both ends."""
    _sync(trainer)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(next(stream))
    _sync(trainer)
    return steps * trainer.config["train_batch_size"] / (time.perf_counter() - t0)


def _sync(trainer):
    import torch

    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


def _reset_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    import torch

    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None


def row_update_equals_plain(trainer, batch, at_step):
    """One train step of ``trainer`` (f32 table, ``sparse_item_adam``) with
    its row update held against the plain version at the shape and on the
    data the path gives it: (table, m, v) are copied just before
    ``row_adamw`` runs, ``sparse_adamw_row_update`` runs on the copies with
    the same ids, rows, learning rate and step, and the two must be equal
    bit for bit, and the rows must move. The step is taken as step
    ``at_step`` of the schedule (one with a learning rate above 0; the
    trainer's count is put back after). On the card both are then timed in
    place on the copies (plain, kernel, kernel, plain) beside the bound.
    Returns the record."""
    import torch

    from mhrec_tpu_torch.ops import row_adam_cuda
    from mhrec_tpu_torch.trainer.sparse_adam import sparse_adamw_row_update

    kernel, rec = row_adam_cuda.row_adamw, {}

    def checked(p, m, v, ids, g, lr, step, cfg):
        pre = [t.detach().clone() for t in (p, m, v)]
        real = ids[ids >= 0]
        rows_before = p.detach()[real].clone()
        kernel(p, m, v, ids, g, lr, step, cfg)
        after = [t.detach().clone() for t in (p, m, v)]
        sparse_adamw_row_update(*pre, ids, g, lr, step, cfg)
        rec.update(N=p.shape[0], D=p.shape[1], U=int(ids.numel()), real_ids=int(real.numel()),
                   bit_equal=all(bool(torch.equal(a, b)) for a, b in zip(after, pre)),
                   max_abs_err=max(float((a - b).abs().max()) for a, b in zip(after, pre)),
                   rows_moved=bool((after[0][real] != rows_before).any()))
        if p.is_cuda:
            args = (ids, g, lr, step, cfg)
            t = timings({"kernel": lambda: kernel(*pre, *args),
                         "plain": lambda: sparse_adamw_row_update(*pre, *args)}, iters=10)
            nbytes = 7 * 4 * rec["real_ids"] * rec["D"] + ids.numel() * ids.element_size()
            bound, bound_by = _bound(nbytes, 16 * rec["real_ids"] * rec["D"],
                                     PEAK_FLOPS["float32"])
            rec.update(ms=t["kernel"][0], host_ms=t["kernel"][1], plain_ms=t["plain"][0],
                       plain_host_ms=t["plain"][1], bound_ms=bound, bound_by=bound_by)
        del pre, after

    # the wrapper counts its launches on the module's row_adamw, which is
    # ``checked`` meanwhile: this step's launches land there, uncounted
    checked.launches = 0
    row_adam_cuda.row_adamw = checked
    step, trainer.step = trainer.step, at_step
    try:
        trainer.train_step(batch)
    finally:
        row_adam_cuda.row_adamw, trainer.step = kernel, step
    rec["lr"] = trainer.schedule(at_step)
    rec["ok"] = bool(rec.get("bit_equal") and rec.get("rows_moved"))
    return rec


def hstu_1b_phase(data, work_dir, device=None, **over):
    """hstu-1b at full width (hstu_1b_config; ``over`` cuts it for the CPU
    tests), each path with the launch counts set to 0 just before it and
    read just after:

    * ``hstu_1b_serve``: ``run.serve`` over the HSTU phases' users and
      catalog at eval batch 1024; #1 22 times an eval batch on its
      tensor-core route and no other kernel; users/s of a warm repeat,
      which must give the same metrics; peak memory. Then
      ``hstu_1b_serve_tf32``: the same trainer's evaluation under
      ``matmul_precision: tensorfloat32`` (users/s, the largest metric
      difference from full float32; informational, only finite metrics
      are required), the precision restored after;
    * ``hstu_1b_train``: ``run.train`` with an f32 table, HSTU_1B_STEPS
      steps, an evaluation with a best-checkpoint save, the test split from
      it; #4 22 times a step, #7 once a step, #1 22 times a step and an
      eval batch; steady examples/s, the device's busy share over three
      more steps under the profiler, peak memory, model FLOP/s against
      989 TFLOP/s dense bf16; then one more step whose #7 launch is held
      bit for bit against the plain update (row_update_equals_plain);
    * ``hstu_1b_train_bf16_table``: the same steps with ``item_table_dtype:
      bfloat16`` (``fit`` without evaluations): no #7 launch, a bf16 table
      with f32 moments; the loss gap to the f32 run after the same steps,
      steady examples/s, the table's bytes;
    * ``hstu_1b_train_stacked``: the same steps with ``prior_loss_impl:
      stacked``, then the loop and the stacked loss timed in turns on that
      trainer (loop, stacked, stacked, loop; HSTU_1B_TURN_STEPS steps each),
      and one batch's loss and gradients of both on a float32 copy of the
      model (STACKED_LOSS_TOL, STACKED_GRAD_TOL) and, reported only, in bf16.

    Returns (each path's launches, the names of the checks that failed)."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader, build_eval_dataloaders
    from mhrec_tpu_torch.ops import hstu_attention_cuda as K
    from mhrec_tpu_torch.run import serve, set_matmul_precision, train
    from mhrec_tpu_torch.trainer import Trainer

    failed, paths = [], {}

    # serving
    config = hstu_1b_config(work_dir, val_only=True, **over)
    layers, H = config["n_layers"], config["n_heads"]
    d = config["hstu_embedding_size"] // H
    route = K.stu_gated_fwd_route(torch.bfloat16, config["MAX_ITEM_LIST_LENGTH"], H, d, d)
    reset_launches()
    t0 = time.perf_counter()
    trainer, test_loader, result = serve(config, data, device)
    _sync(trainer)
    serve_seconds = time.perf_counter() - t0
    paths["hstu_1b_serve"] = launches = read_launches()
    dev = trainer.device
    _reset_peak(dev)
    t0 = time.perf_counter()
    again = trainer.evaluate(test_loader)
    _sync(trainer)
    eval_seconds = time.perf_counter() - t0
    peak = _peak_gb(dev)
    n_users = len(test_loader)
    batches = math.ceil(n_users / config["eval_batch_size"])
    values = _metric_values(result)
    ok = (route == "tensor_cores" and again == result
          and launches == dict({k: 0 for k in launches}, hstu_stu_gated_fwd=layers * batches)
          and all(math.isfinite(v) for v in values) and "pred_7" in result)
    emit({"phase": "hstu_1b_serve", "layers": layers, "width": config["hstu_embedding_size"],
          "heads": H, "users": n_users, "items": int(data.item_num), "eval_batches": batches,
          "serve_seconds": serve_seconds, "eval_seconds": eval_seconds,
          "users_per_s": n_users / eval_seconds, "peak_mem_gb": peak,
          "stu_fwd_route": route, "launches": launches,
          "launches_per_eval_batch": launches["hstu_stu_gated_fwd"] / batches,
          "repeat_matches": again == result, "metrics": _overall(result), "ok": bool(ok)})
    if not ok:
        failed.append("hstu_1b_serve")
    set_matmul_precision("tensorfloat32")
    try:
        trainer.evaluate(test_loader)  # the TF32 products' first call
        t0 = time.perf_counter()
        tf32 = trainer.evaluate(test_loader)
        _sync(trainer)
        tf32_seconds = time.perf_counter() - t0
    finally:
        set_matmul_precision(None)
    diffs = {f"{sec}/{m}": abs(tf32[sec][m] - result[sec][m]) for sec in result
             for m in result[sec]}
    worst = max(diffs, key=diffs.get)
    ok = all(math.isfinite(v) for v in _metric_values(tf32))
    emit({"phase": "hstu_1b_serve_tf32", "matmul_precision": "tensorfloat32",
          "users_per_s": n_users / tf32_seconds, "highest_users_per_s": n_users / eval_seconds,
          "max_metric_abs_diff": diffs[worst], "max_diff_metric": worst,
          "metrics": _overall(tf32), "ok": bool(ok)})
    if not ok:
        failed.append("hstu_1b_serve_tf32")
    del trainer, test_loader
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # training, f32 table
    config = hstu_1b_config(work_dir, **over)
    steps, B = config["total_iters"], config["train_batch_size"]
    eval_batches = sum(math.ceil(len(loader) / config["eval_batch_size"])
                       for loader in build_eval_dataloaders(config, data))
    reset_launches()
    _reset_peak(dev)
    t0 = time.perf_counter()
    trainer, stats, result = train(config, data, device)
    _sync(trainer)
    seconds = time.perf_counter() - t0
    paths["hstu_1b_train"] = launches = read_launches()
    peak = _peak_gb(dev)
    f32_losses = [loss for _, loss in trainer.fetched_losses]
    flops = hstu_train_flops(config)
    steady = stats["steady_examples_per_s"]
    busy = None
    if dev.type == "cuda":
        stream = build_dataloader(config, data)[0].epoch_batches(3)
        batches3 = [next(stream) for _ in range(3)]
        wall, _, busy_us = profiled(lambda: [trainer.train_step(b) for b in batches3])
        busy = busy_us / 1e6 / wall
    # #7 against its plain version on one more step's ids and rows
    row_check = row_update_equals_plain(
        trainer, next(build_dataloader(config, data)[0].epoch_batches(4)), steps // 2)
    want = dict({k: 0 for k in launches}, hstu_stu_gated_fwd=layers * (steps + eval_batches),
                hstu_stu_gated_bwd=layers * steps, row_adamw=steps)
    ok = (stats["iters"] == steps and launches == want and int(trainer.nan_step) < 0
          and all(math.isfinite(x) for x in f32_losses) and "load_s" in trainer.checkpoint_stats
          and os.path.isfile(trainer.checkpoint_path()) and row_check["ok"]
          and all(math.isfinite(v) for v in _metric_values(result)) and "pred_7" in result)
    f32_table_bytes = trainer.model.item_embedding.weight.nbytes
    emit({"phase": "hstu_1b_train", "steps": stats["iters"], "batch": B,
          "num_negatives": config["num_negatives"], "items": int(data.item_num),
          "parameters": sum(p.numel() for p in trainer.model.parameters()),
          "seconds": seconds, "fit_wall_s": stats["wall_s"], "fit_eval_s": stats["eval_s"],
          "steady_examples_per_s": steady, "examples_per_s": stats["examples_per_s"],
          "device_busy_share": busy, "peak_mem_gb": peak,
          "model_flops_per_step": flops, "model_tflop_per_s": flops * steady / B / 1e12,
          "share_of_bf16_peak": flops * steady / B / PEAK_FLOPS["bfloat16"],
          "losses": trainer.fetched_losses, "table_bytes": f32_table_bytes,
          "launches": launches, "launches_per_step": {
              "hstu_stu_gated_bwd": launches["hstu_stu_gated_bwd"] / steps,
              "row_adamw": launches["row_adamw"] / steps},
          "checkpoint": trainer.checkpoint_stats, "test_metrics": _overall(result)["pred_7"],
          "row_adamw_vs_plain": row_check, "ok": bool(ok)})
    if not ok:
        failed.append("hstu_1b_train")
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # training, bf16 table
    config = hstu_1b_config(work_dir, item_table_dtype="bfloat16", **over)
    trainer = Trainer(config, data, device=device)
    trainer.setup_model()
    train_loader = build_dataloader(config, data)[0]
    reset_launches()
    _reset_peak(dev)
    stats = trainer.fit(train_loader, None)
    _sync(trainer)
    paths["hstu_1b_train_bf16_table"] = launches = read_launches()
    table = trainer.model.item_embedding.weight
    losses = [loss for _, loss in trainer.fetched_losses]
    want = dict({k: 0 for k in launches}, hstu_stu_gated_fwd=layers * steps,
                hstu_stu_gated_bwd=layers * steps)
    ok = (stats["iters"] == steps and launches == want and table.dtype == torch.bfloat16
          and trainer.table_m.dtype == trainer.table_v.dtype == torch.float32
          and int(trainer.nan_step) < 0 and all(math.isfinite(x) for x in losses))
    emit({"phase": "hstu_1b_train_bf16_table", "steps": stats["iters"], "batch": B,
          "stochastic_round": trainer.table_sr,
          "steady_examples_per_s": stats["steady_examples_per_s"],
          "f32_steady_examples_per_s": steady, "losses": trainer.fetched_losses,
          "last_loss_gap_to_f32": losses[-1] - f32_losses[-1],
          "last_loss_rel_gap_to_f32": (losses[-1] - f32_losses[-1]) / abs(f32_losses[-1]),
          "table_dtype": str(table.dtype), "table_bytes": table.nbytes,
          "f32_table_bytes": f32_table_bytes, "moments_bytes": 2 * trainer.table_m.nbytes,
          "peak_mem_gb": _peak_gb(dev), "launches": launches, "ok": bool(ok)})
    if not ok:
        failed.append("hstu_1b_train_bf16_table")
    del trainer, table
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # training, stacked prior loss
    config = hstu_1b_config(work_dir, prior_loss_impl="stacked", **over)
    trainer = Trainer(config, data, device=device)
    trainer.setup_model()
    train_loader = build_dataloader(config, data)[0]
    reset_launches()
    _reset_peak(dev)
    stats = trainer.fit(train_loader, None)
    _sync(trainer)
    paths["hstu_1b_train_stacked"] = launches = read_launches()
    losses = [loss for _, loss in trainer.fetched_losses]
    want = dict({k: 0 for k in launches}, hstu_stu_gated_fwd=layers * steps,
                hstu_stu_gated_bwd=layers * steps, row_adamw=steps)
    ok = (stats["iters"] == steps and launches == want and int(trainer.nan_step) < 0
          and all(math.isfinite(x) for x in losses))
    peak = _peak_gb(dev)
    stream = itertools.chain.from_iterable(
        train_loader.epoch_batches(epoch) for epoch in itertools.count(11))
    turns = {"loop": [], "stacked": []}
    for impl in ("loop", "stacked", "stacked", "loop"):
        trainer.model.prior_loss_impl = impl
        turns[impl].append(_timed_steps(trainer, stream, HSTU_1B_TURN_STEPS))
    trainer.model.prior_loss_impl = "stacked"
    batch = next(stream)
    agree = {}
    f32 = Trainer(config, data, device=device, dtype=torch.float32)
    f32.model.load_state_dict(trainer.model.state_dict())
    for name, tr in (("float32", f32), ("bfloat16", trainer)):
        out = {}
        for impl in ("stacked", "loop"):
            tr.model.prior_loss_impl = impl
            out[impl] = loss_and_grads(tr, batch, trainer.step)
        (l_s, g_s, _), (l_l, g_l, _) = out["stacked"], out["loop"]
        grad_rel, cos, worst = _grad_agreement(g_s, g_l)
        agree[name] = {"loss_stacked": l_s, "loss_loop": l_l,
                       "loss_rel_diff": abs(l_s - l_l) / abs(l_l), "grad_max_rel_l2": grad_rel,
                       "grad_worst_tensor": worst, "grad_cosine": cos}
        del out, g_s, g_l
    del f32
    ok = (ok and agree["float32"]["loss_rel_diff"] <= STACKED_LOSS_TOL
          and agree["float32"]["grad_max_rel_l2"] <= STACKED_GRAD_TOL)
    emit({"phase": "hstu_1b_train_stacked", "steps": stats["iters"], "batch": B,
          "steady_examples_per_s": stats["steady_examples_per_s"],
          "f32_loop_steady_examples_per_s": steady, "losses": trainer.fetched_losses,
          "last_loss_rel_gap_to_loop": (losses[-1] - f32_losses[-1]) / abs(f32_losses[-1]),
          "turn_steps": HSTU_1B_TURN_STEPS, "turns_examples_per_s": turns,
          "loop_examples_per_s": max(turns["loop"]),
          "stacked_examples_per_s": max(turns["stacked"]),
          "one_batch": agree, "loss_tolerance": STACKED_LOSS_TOL,
          "grad_tolerance": STACKED_GRAD_TOL, "peak_mem_gb": peak, "launches": launches,
          "ok": bool(ok)})
    if not ok:
        failed.append("hstu_1b_train_stacked")
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return paths, failed


# ---------------------------------------------------------------------------
# the five baselines of the paper's comparison (README, SURVEY.md rows 94-98)

# each family's config files, the last one naming the model: ComiRec, REMI
# and DualVAE take hstu-size4's widths (1024 wide; the trunk 16 layers of 16
# heads), SASRec and LLMIDRec their own YAML's (512 wide)
BASELINE_FILES = {
    "ComiRec": ("IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/comirec.yaml"),
    "REMI": ("IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/remi.yaml"),
    "DualVAE": ("IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/dualvae.yaml"),
    "SASRec": ("overall/ID.yaml", "IDNet/sasrec.yaml"),
    "LLMIDRec": ("overall/ID.yaml", "IDNet/llama_id.yaml"),
}
BASELINE_BATCH = 64
# 10 until the distributed phase joined the script, 4 until its baselines
# run joined it (depth cuts: (d) trains every family too)
BASELINE_STEPS = 2
# the shared negative pool a step (reproduce/HSTU-Pixel8M-base.sh, per chip)
BASELINE_POOL = 8192
# SASRec and LLMIDRec draw num_negatives for EVERY position: at the
# protocol's 8192 a batch of 64 × 50 positions gathers 26.2M rows (53.7 GB
# at 512 wide in float32). The phase takes the largest of these counts
# whose per-position rows (gathered, projected to the tower's width,
# normalized, and the gradients of both) and sub-table (with its gradient)
# stay under POSITION_NEG_BUDGET
POSITION_NEG_CHOICES = (1024, 512, 256)
# LLMIDRec's TinyLlama-width user tower, cut from its 22 layers to keep the
# script's time (a depth cut: its checkpoint was 12.87 GB, its run 59.53 GiB)
BASELINE_LLM_LAYERS = 4
POSITION_NEG_BUDGET = 40 * 2**30


def baseline_widths(config, tower_width):
    """(item table width, the width the model computes at)."""
    family = config["model"]
    if family in ("ComiRec", "REMI"):
        return config["item_embedding_size"], config["hstu_embedding_size"]
    if family == "DualVAE":
        return config["item_embedding_size"], config["item_embedding_size"]
    if family == "SASRec":
        return config["embedding_size"], config["embedding_size"]
    return config["item_embed_dim"], tower_width


def position_negatives_bytes(config, K, tower_width):
    """Bytes that K per-position negatives cost a SASRec or LLMIDRec step
    (see POSITION_NEG_BUDGET): 4-byte rows at the item width twice, at the
    model's width four times, and the sub-table of ``unique_id_cap`` rows
    twice."""
    from mhrec_tpu_torch.data.trainset import unique_id_cap

    width, proj = baseline_widths(config, tower_width)
    cfg = dict(config.as_dict(), num_negatives=K)
    rows = config["train_batch_size"] * config["MAX_ITEM_LIST_LENGTH"] * K
    return 4 * rows * (2 * width + 4 * proj) + 2 * 4 * unique_id_cap(cfg) * width


def pick_position_negatives(config, tower_width):
    """(K, its bytes): the largest of POSITION_NEG_CHOICES under the budget,
    else the smallest."""
    for K in POSITION_NEG_CHOICES:
        nbytes = position_negatives_bytes(config, K, tower_width)
        if nbytes <= POSITION_NEG_BUDGET:
            return K, nbytes
    return K, nbytes


def baseline_config(family, checkpoint_dir, user_dir=None, **over):
    """``family`` from its config files at batch BASELINE_BATCH for
    BASELINE_STEPS steps, window 50, BASELINE_POOL shared negatives,
    ``sparse_item_adam``, one evaluation with a best-checkpoint save at the
    end; LLMIDRec's user tower from ``user_dir``'s config.json (random
    weights: ``user_llm_init`` is false, and the JAX model loads none).
    ``over``: further settings."""
    from mhrec_tpu_torch.config import Config

    d = dict(dataset="synthetic", seed=0, MAX_ITEM_LIST_LENGTH=50,
             train_batch_size=BASELINE_BATCH, num_negatives=BASELINE_POOL,
             sparse_item_adam=True, total_iters=BASELINE_STEPS, eval_interval=BASELINE_STEPS,
             update_interval=5, checkpoint_dir=checkpoint_dir)
    if family == "LLMIDRec":
        d["user_pretrain_dir"] = user_dir
    d.update(over)
    return Config(config_file_list=list(BASELINE_FILES[family]), config_dict=d).finalize()


def baselines_phase(data, work_dir, device=None, families=tuple(BASELINE_FILES),
                    position_negatives=None, user_llm=None, **over):
    """The five baselines through the entry points a user calls, at full
    width over ``data`` (the HSTU phases' users and catalog), each path with
    the launch counts set to 0 just before it and read just after:

    * kernel holds (on the card): #1 ``hstu_stu_gated_fwd`` and #4
      ``hstu_stu_gated_bwd`` in float32, the route ComiRec's and REMI's
      trunk takes (CUDA cores), at their serve (1024) and train (64)
      batches, window 50, 16 heads of 64, against the plain versions;
    * ``baselines_<family>``: ``run.train`` (BASELINE_STEPS steps, an
      evaluation of the valid split with a best-checkpoint save, the test
      split from it); #7 once a step, and for ComiRec / REMI #1 16 times a
      step and an eval batch and #4 16 times a step; no other kernel;
      steady examples/s, peak memory, every fetched loss finite. SASRec's
      trainer then takes one more step whose #7 launch is held bit for bit
      against the plain update at D = 512 (``row_update_equals_plain``);
    * ``baselines_<family>_serve``: ``run.serve`` (``--val_only True``) from
      that checkpoint: its metrics equal the training run's test metrics,
      a warm repeat equals them too (users/s), and the streamed top-k of a
      few users equals a dense sort (``check_streamed_topk``); #1 16 times
      an eval batch for ComiRec / REMI, no kernel for the others;
    * a second run from the same seed: a fresh trainer's first step gives
      the first run's first loss, bit for bit.

    SASRec and LLMIDRec take ``position_negatives`` per position (None:
    ``pick_position_negatives``). ``user_llm``: LLMIDRec's tower config
    (default TinyLlama-1.1B's at BASELINE_LLM_LAYERS layers);
    ``over`` cuts the configurations (the CPU tests). Returns (each path's
    launches, the names of the checks that failed, the kernel records)."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader, build_eval_dataloaders
    from mhrec_tpu_torch.run import serve, train
    from mhrec_tpu_torch.trainer import Trainer
    from mhrec_tpu_torch.utils.misc import resolve_device

    dev = resolve_device(device)
    paths, failed, kernel_recs = {}, [], {}
    if dev.type == "cuda":
        with torch.no_grad():
            for kind, shape_name, B in (("stu", "comirec_serve", 1024),
                                        ("stu", "comirec_train", BASELINE_BATCH),
                                        ("stu_bwd", "comirec_train", BASELINE_BATCH),
                                        ("stu_bwd", "comirec_serve", 1024)):
                rec = kernel_recs[f"{kind}/{shape_name}"] = kernel_phase(
                    kind, shape_name, B, 50, 16, 64, torch.float32)
                if not (rec["ok"] and rec["route"] == "cuda_cores"):
                    failed.append(f"baselines/{kind}/{shape_name}")
        torch.cuda.empty_cache()
    user_llm = user_llm or dict(TINYLLAMA_1B, num_hidden_layers=BASELINE_LLM_LAYERS)
    user_dir = os.path.join(work_dir, "user_llm")
    os.makedirs(user_dir, exist_ok=True)
    with open(os.path.join(user_dir, "config.json"), "w") as fh:
        json.dump(user_llm, fh)

    for family in families:
        ckpt_dir = os.path.join(work_dir, family)
        config = baseline_config(family, ckpt_dir, user_dir, **over)
        cuts = {}
        tower = user_llm["hidden_size"]
        if family in ("SASRec", "LLMIDRec"):
            K, nbytes = ((position_negatives,
                          position_negatives_bytes(config, position_negatives, tower))
                         if position_negatives else pick_position_negatives(config, tower))
            config["num_negatives"] = K
            cuts = {"position_negatives": K, "protocol_negatives": BASELINE_POOL,
                    "position_negatives_bytes": nbytes}
        layers = config["n_layers"] if family in ("ComiRec", "REMI") else 0
        loaders = build_eval_dataloaders(config, data)
        valid_b, test_b = (math.ceil(len(loader) / config["eval_batch_size"])
                           for loader in loaders)

        # training: fit, an evaluation with a best-checkpoint save, the test
        # split from that checkpoint
        reset_launches()
        _reset_peak(dev)
        t0 = time.perf_counter()
        trainer, stats, trained = train(config, data, device)
        _sync(trainer)
        train_seconds = time.perf_counter() - t0
        paths[f"baselines_{family}"] = launches = read_launches()
        train_peak = _peak_gb(dev)
        steps = stats["iters"]
        losses = [loss for _, loss in trainer.fetched_losses]
        want = dict({k: 0 for k in launches}, row_adamw=steps,
                    hstu_stu_gated_fwd=layers * (steps + valid_b + test_b),
                    hstu_stu_gated_bwd=layers * steps)
        train_ok = (steps == config["total_iters"] and launches == want
                    and int(trainer.nan_step) < 0 and all(math.isfinite(x) for x in losses)
                    and os.path.isfile(trainer.checkpoint_path())
                    and "load_s" in trainer.checkpoint_stats
                    and all(math.isfinite(v) for v in _metric_values(trained)))
        rec = {"phase": f"baselines_{family}", "files": list(BASELINE_FILES[family]),
               "widths": baseline_widths(config, tower), "stu_layers": layers,
               "steps": steps, "batch": config["train_batch_size"],
               "num_negatives": config["num_negatives"], "items": int(data.item_num),
               "users": len(loaders[1]),
               "parameters": sum(p.numel() for p in trainer.model.parameters()),
               "train_seconds": train_seconds,
               "steady_examples_per_s": stats["steady_examples_per_s"],
               "fit_eval_s": stats["eval_s"], "train_peak_mem_gb": train_peak,
               "losses": trainer.fetched_losses, "train_launches": launches,
               "train_launches_per_step": {k: launches[k] / steps for k in
                                           ("hstu_stu_gated_fwd", "hstu_stu_gated_bwd",
                                            "row_adamw")},
               "checkpoint": trainer.checkpoint_stats, "cuts": cuts}
        if family == "SASRec":
            # #7 against its plain version on one more step's block (D = 512)
            row = rec["row_adamw_vs_plain"] = row_update_equals_plain(
                trainer, next(build_dataloader(config, data)[0].epoch_batches(4)), steps // 2)
            kernel_recs["row_adamw/sasrec"] = row
            train_ok = train_ok and row["ok"]
        first_loss = trainer.fetched_losses[0]
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # serving: run.serve (--val_only True) from the checkpoint, then warm
        serve_cfg = baseline_config(family, ckpt_dir, user_dir,
                                    **dict(over, val_only=True,
                                           num_negatives=config["num_negatives"]))
        reset_launches()
        _reset_peak(dev)
        t0 = time.perf_counter()
        trainer, test_loader, served = serve(serve_cfg, data, device)
        _sync(trainer)
        serve_seconds = time.perf_counter() - t0
        paths[f"baselines_{family}_serve"] = serve_launches = read_launches()
        t0 = time.perf_counter()
        again = trainer.evaluate(test_loader)
        _sync(trainer)
        eval_seconds = time.perf_counter() - t0
        serve_peak = _peak_gb(dev)
        with torch.no_grad():
            topk_ok = check_streamed_topk(trainer, next(iter(test_loader.batches())))
        heads = trainer.model.medusa_num_heads
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        serve_ok = (served == trained and again == served and topk_ok
                    and serve_launches == dict({k: 0 for k in serve_launches},
                                               hstu_stu_gated_fwd=layers * test_b))

        # a second run from the same seed: the same first loss
        rep = Trainer(config, data, device=device)
        rep.setup_model()
        rep_loss = float(rep.train_step(
            next(build_dataloader(config, data)[0].epoch_batches(0)))["loss"].detach())
        del rep
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        seed_ok = rep_loss == first_loss[1]

        rec.update({"serve_seconds": serve_seconds, "eval_seconds": eval_seconds,
                    "users_per_s": len(test_loader) / eval_seconds, "heads": heads,
                    "serve_peak_mem_gb": serve_peak, "serve_launches": serve_launches,
                    "serve_launches_per_eval_batch": serve_launches["hstu_stu_gated_fwd"] / test_b,
                    "serve_equals_train_test": served == trained, "repeat_matches": again == served,
                    "streamed_topk_matches_dense": topk_ok, "first_loss": first_loss,
                    "same_seed_first_loss": rep_loss, "same_seed_matches": seed_ok,
                    "test_metrics": _overall(served), "train_ok": bool(train_ok),
                    "serve_ok": bool(serve_ok), "ok": bool(train_ok and serve_ok and seed_ok)})
        emit(rec)
        if not rec["ok"]:
            failed.append(f"baselines_{family}")
    return paths, failed, kernel_recs


# the profile phases' groups of device kernels, by name (first match wins)
PROFILE_GROUPS = (
    ("packed_attn_bwd", "packed_attn_bwd"),
    ("packed_attn_fwd", "packed_attn"),
    ("hstu_stu_gated_fwd", "stu_gated_fwd"),
    ("hstu_stu_gated_bwd", "stu_gated_bwd|attn_bwd"),
    ("hstu_attn_fwd", "attn_fwd_kernel"),
    ("row_adamw", "row_adamw"),
    ("adamw", "[Aa]dam|multi_tensor"),
    ("matmul", "gemm|nvjet|xmma|cutlass"),
    ("topk_and_sort", "topk|sort|radix"),
    ("copy_to_host", "Memcpy DtoH"),
)


# -- HLLM towers from local checkpoints, and the HLLM training levers ----------
# bert-base-uncased's config.json (12 layers, 768 wide, 12 heads, 3072,
# vocab 30522, 512 positions)
BERT_BASE = {
    "model_type": "bert", "vocab_size": 30522, "hidden_size": 768, "intermediate_size": 3072,
    "num_hidden_layers": 12, "num_attention_heads": 12, "max_position_embeddings": 512,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}
# Baichuan-13B's config.json (5120 wide, 40 heads, 13696, vocab 64000, the
# fused W_pack projection, ALiBi) cut to 2 of its 40 layers; "alibi" names
# what the 40-layer count would have told LLMConfig
BAICHUAN_13B_2L = {
    "model_type": "baichuan", "vocab_size": 64000, "hidden_size": 5120,
    "intermediate_size": 13696, "num_hidden_layers": 2, "num_attention_heads": 40,
    "rms_norm_eps": 1e-6, "alibi": True,
}
# the pretrained-tower phases' catalog and users (hllm_serve's are
# HLLM_ITEMS and HLLM_USERS), to keep time
PRETRAINED_ITEMS = 4096
PRETRAINED_USERS = 512  # 1024 until the FSDP runs joined the script
PRETRAINED_TRAIN_STEPS = 2  # 3 until (d) and (e) joined the distributed phase
# the towers phase: catalog, users, and the ALiBi tower's corpus batch
# (MAX_ITEM_LIST_LENGTH 24 × train_batch_size 8 = 192 items: its
# [192, 40, 257, 257] float32 scores take 2.0 GB)
TOWERS_ITEMS = 1024
TOWERS_USERS = 256
ALIBI_CORPUS_TRAIN_BATCH = 8
# the levers phase: sequences a step (dots keeps every product's output:
# about 1.25 GB a layer at 2 sequences, 248 items) and timed steps
LEVERS_BATCH = 2
LEVERS_STEPS = 2  # 3 until the distributed phase joined the script

# where the written checkpoints are drawn
DEVICE = "cuda"

_ST_DTYPE_NAMES = {"float32": "F32", "bfloat16": "BF16", "float16": "F16", "int64": "I64"}


def write_safetensors(path, tensors):
    """A ``.safetensors`` file written by hand: the 8-byte little-endian
    header length, the JSON header (dtype, shape, byte range of each
    tensor), padded to 8 bytes, then each tensor's raw bytes."""
    import torch

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPE_NAMES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    body = json.dumps(header, separators=(",", ":")).encode()
    body += b" " * (-len(body) % 8)
    with open(path, "wb") as fh:
        fh.write(len(body).to_bytes(8, "little"))
        fh.write(body)
        for t in tensors.values():
            fh.write(memoryview(t.detach().reshape(-1).contiguous().cpu()
                                .view(torch.uint8).numpy()))


def hf_state_dict(cfg, seed, device, dtype, lm_head=True):
    """An HF-named state dict of ``cfg``'s topology (Llama family, with
    Baichuan's W_pack when ``cfg`` is baichuan and q/k/v biases when it is
    qwen2 / qwen2_vl, or BERT) drawn on
    ``device`` from ``seed``: normal 0.02 matrices and embeddings, norm
    scales 1 + 0.1·normal, normal 0.02 biases, in ``dtype``; with the keys
    the towers do not read (``lm_head``, the BERT pooler)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    D, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    h = cfg["num_attention_heads"]
    hk = cfg.get("num_key_value_heads", h)
    dh = D // h
    sd = {}

    def put(name, *shape, scale=0.02, one=False):
        t = torch.randn(shape, generator=gen, device=device) * (0.1 if one else scale)
        sd[name] = (t + 1.0 if one else t).to(dtype)

    if cfg["model_type"] == "bert":
        put("bert.embeddings.word_embeddings.weight", V, D)
        put("bert.embeddings.position_embeddings.weight", cfg["max_position_embeddings"], D)
        put("bert.embeddings.token_type_embeddings.weight", cfg["type_vocab_size"], D)
        put("bert.embeddings.LayerNorm.weight", D, one=True)
        put("bert.embeddings.LayerNorm.bias", D)
        for i in range(cfg["num_hidden_layers"]):
            p = f"bert.encoder.layer.{i}"
            for n in ("attention.self.query", "attention.self.key", "attention.self.value",
                      "attention.output.dense"):
                put(f"{p}.{n}.weight", D, D)
                put(f"{p}.{n}.bias", D)
            put(f"{p}.intermediate.dense.weight", I, D)
            put(f"{p}.intermediate.dense.bias", I)
            put(f"{p}.output.dense.weight", D, I)
            put(f"{p}.output.dense.bias", D)
            for n in ("attention.output.LayerNorm", "output.LayerNorm"):
                put(f"{p}.{n}.weight", D, one=True)
                put(f"{p}.{n}.bias", D)
        put("bert.pooler.dense.weight", D, D)
        put("bert.pooler.dense.bias", D)
        return sd
    put("model.embed_tokens.weight", V, D)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        if cfg["model_type"] == "baichuan":
            put(f"{p}.self_attn.W_pack.weight", 3 * D, D)
        else:
            put(f"{p}.self_attn.q_proj.weight", h * dh, D)
            put(f"{p}.self_attn.k_proj.weight", hk * dh, D)
            put(f"{p}.self_attn.v_proj.weight", hk * dh, D)
            if cfg["model_type"] in ("qwen2", "qwen2_vl"):  # q/k/v biases
                put(f"{p}.self_attn.q_proj.bias", h * dh)
                put(f"{p}.self_attn.k_proj.bias", hk * dh)
                put(f"{p}.self_attn.v_proj.bias", hk * dh)
        put(f"{p}.self_attn.o_proj.weight", D, h * dh)
        put(f"{p}.mlp.gate_proj.weight", I, D)
        put(f"{p}.mlp.up_proj.weight", I, D)
        put(f"{p}.mlp.down_proj.weight", D, I)
        put(f"{p}.input_layernorm.weight", D, one=True)
        put(f"{p}.post_attention_layernorm.weight", D, one=True)
    put("model.norm.weight", D, one=True)
    if lm_head:
        put("lm_head.weight", V, D)
    return sd


def write_hf_checkpoint(dirpath, cfg, sd, fmt="safetensors", shards=1):
    """``config.json`` and ``sd`` as ``fmt`` ("safetensors", by
    ``write_safetensors``, or "bin", by ``torch.save``), in ``shards``
    files with an index when more than one. Returns the seconds taken."""
    import torch

    t0 = time.perf_counter()
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    names = list(sd)
    parts = [names[i::shards] for i in range(shards)]
    if fmt == "safetensors":
        file_of = (lambda n: "model.safetensors") if shards == 1 else (
            lambda n: f"model-{n + 1:05d}-of-{shards:05d}.safetensors")
        index = "model.safetensors.index.json"
    else:
        file_of = (lambda n: "pytorch_model.bin") if shards == 1 else (
            lambda n: f"pytorch_model-{n + 1:05d}-of-{shards:05d}.bin")
        index = "pytorch_model.bin.index.json"
    weight_map = {}
    for n, part in enumerate(parts):
        tensors = {k: sd[k] for k in part}
        path = os.path.join(dirpath, file_of(n))
        if fmt == "safetensors":
            write_safetensors(path, tensors)
        else:
            torch.save({k: v.cpu() for k, v in tensors.items()}, path)
        weight_map.update({k: file_of(n) for k in part})
    if shards > 1:
        with open(os.path.join(dirpath, index), "w") as fh:
            json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    return time.perf_counter() - t0


def link_layer_cut(src_dir, dst_dir, cfg, layers):
    """A checkpoint directory of the first ``layers`` layers of the one in
    ``src_dir``: its own ``config.json`` beside links to the source's weight
    files, so nothing is written twice (the loader maps only the layers the
    config names)."""
    os.makedirs(dst_dir)
    with open(os.path.join(dst_dir, "config.json"), "w") as fh:
        json.dump(dict(cfg, num_hidden_layers=layers), fh)
    for name in os.listdir(src_dir):
        if name != "config.json":
            os.symlink(os.path.join(src_dir, name), os.path.join(dst_dir, name))
    return dst_dir


def loaded_equal_written(model, sd, tower_dir):
    """Every parameter of both towers equal to its written tensor bit for
    bit (bf16 → f32 is exact); returns (all equal, tensors compared)."""
    import torch

    from mhrec_tpu_torch.models.llm import loader
    from mhrec_tpu_torch.models.llm.config import LLMConfig

    cfg = LLMConfig.from_pretrained_dir(tower_dir)
    to_tower = (loader.bert_state_dict_from_hf if cfg.model_type == "bert"
                else loader.llama_state_dict_from_hf)
    equal, n = True, 0
    for tower in ("item_llm", "user_llm"):
        module = getattr(model, tower)
        want = to_tower(sd, cfg, token_embeddings=hasattr(module, "embed_tokens")
                        or hasattr(module, "word_embeddings"))
        for name, p in module.named_parameters():
            equal &= bool(torch.equal(p.detach(), want[name].to(p.device, p.dtype)))
            n += 1
    return equal, n


def tower_load_record(model):
    return {t: dict(s, gb_per_s=s["bytes"] / 1e9 / s["seconds"])
            for t, s in model.tower_load_stats.items()}


def hllm_pretrained_phase(work_dir):
    """HLLM with both towers from a TinyLlama-1.1B-shaped checkpoint the
    script writes (seed 0, bfloat16, two ``.safetensors`` shards and an
    index, about 2.2 GB): serving (``run.serve``: the towers' load seconds
    and GB/s, every loaded tensor equal to the written one, the corpus pass
    and users/s, through hllm_serve_phase's checks) and training
    (``run.train``: PRETRAINED_TRAIN_STEPS steps, then the test split; no
    evaluation inside the fit, so no checkpoint is written), with
    ``packed_attn_fwd`` 44 and ``packed_attn_bwd`` 22 launches a step. Then
    a 2-layer cut of the same weights as ``.safetensors`` and as
    ``pytorch_model.bin`` must give equal item embeddings (the packed item
    tower over the first corpus batch). Returns (the training trainer, its
    config, the data, launches, ok)."""
    import numpy as np
    import torch

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.run import train
    from mhrec_tpu_torch.trainer import Trainer

    tower_dir = os.path.join(work_dir, "tinyllama_safetensors")
    sd = hf_state_dict(TINYLLAMA_1B, seed=0, device=DEVICE, dtype=torch.bfloat16)
    ckpt_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    write_s = write_hf_checkpoint(tower_dir, TINYLLAMA_1B, sd, shards=2)
    data = InMemoryInteractionData(
        num_users=PRETRAINED_USERS, num_items=PRETRAINED_ITEMS, seq_len=2 * 24 + 2 * 8,
        num_categories=11, eval_pred_len=8, max_item_list_length=24, seed=0, item_texts=True)
    serve_cfg = hllm_config(tower_dir, work_dir)
    trainer, _, serve_launches, ok_serve, _ = hllm_serve_phase(serve_cfg, data,
                                                               phase="hllm_pretrained_serve")
    equal, n_tensors = loaded_equal_written(trainer.model, sd, tower_dir)
    serve_load = tower_load_record(trainer.model)
    del trainer
    torch.cuda.empty_cache()

    cfg = hllm_train_config(tower_dir, work_dir, total_iters=PRETRAINED_TRAIN_STEPS,
                            eval_interval=100 * PRETRAINED_TRAIN_STEPS)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, stats, result = train(cfg, data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    layers = trainer.model.item_config.num_hidden_layers
    corpus_batches = math.ceil(data.item_num / trainer._corpus_batcher.batch_size)
    per_step = {"packed_attn_fwd": (train_launches["packed_attn_fwd"] - layers * corpus_batches)
                / stats["iters"],
                "packed_attn_bwd": train_launches["packed_attn_bwd"] / stats["iters"]}
    losses = [loss for _, loss in trainer.fetched_losses]
    train_load = tower_load_record(trainer.model)
    ok_train = (stats["iters"] == PRETRAINED_TRAIN_STEPS and len(losses) == stats["iters"]
                and all(math.isfinite(x) for x in losses)
                and per_step == {"packed_attn_fwd": 2 * layers, "packed_attn_bwd": layers}
                and "pred_7" in result and set(train_load) == {"item_llm", "user_llm"})

    # a 2-layer cut as .safetensors (the written shards, linked) and as
    # pytorch_model.bin
    cut = {k: v for k, v in sd.items() if k != "lm_head.weight" and (
        not k.startswith("model.layers.") or int(k.split(".")[2]) < 2)}
    del sd
    cut_dirs = {"safetensors": link_layer_cut(tower_dir, os.path.join(work_dir, "tinyllama_2l"),
                                              TINYLLAMA_1B, 2)}
    cut_dirs["bin"] = os.path.join(work_dir, "tinyllama_2l_bin")
    write_hf_checkpoint(cut_dirs["bin"], dict(TINYLLAMA_1B, num_hidden_layers=2), cut, fmt="bin")
    embs = {}
    for fmt, cut_dir in cut_dirs.items():
        t = Trainer(hllm_config(cut_dir, work_dir), data)
        t.setup_model()
        tokens, lens = trainer._corpus_batcher.text_cache.batch(
            np.arange(1, min(769, data.item_num)))
        embs[fmt] = hllm_routes(t.model, tokens, lens)[0]
        del t
    same_bin = bool(torch.equal(embs["safetensors"], embs["bin"]))
    del cut, embs
    torch.cuda.empty_cache()
    ok = bool(ok_serve and ok_train and equal and same_bin)
    emit({"phase": "hllm_pretrained", "checkpoint_bytes": ckpt_bytes, "shards": 2,
          "write_s": write_s, "serve_load": serve_load, "train_load": train_load,
          "loaded_tensors_equal_written": bool(equal), "tensors_compared": n_tensors,
          "train_steps": stats["iters"], "train_seconds": seconds,
          "steady_examples_per_s": stats["steady_examples_per_s"],
          "steady_step_s": cfg["train_batch_size"] / stats["steady_examples_per_s"],
          "losses": losses, "peak_mem_gb": peak_gb, "serve_launches": serve_launches,
          "train_launches": train_launches, "launches_per_step": per_step,
          "bin_2layer_item_embeddings_equal": same_bin, "metrics": result, "ok": ok})
    return trainer, cfg, data, {"serve": serve_launches, "train": train_launches}, ok


# -- a tower's HF tokenizer (tokenizer.json) -----------------------------------
# the hllm_tokenizer phase's texts are cut to hllm_config's MAX_TEXT_LENGTH;
# TOKENIZER_DIGEST is the sha256 (ids_digest) of the PRETRAINED_ITEMS items'
# id lists that transformers gives under the tokenizer write_llama_tokenizer
# writes (tests/test_torch_tokenizer.py computes it with transformers)
TOKENIZER_MAX_LENGTH = 256
TOKENIZER_DIGEST = "1bc8278eecc4c727048f583595339cb0cbe651ac14f1531cf02c4ec3873275e4"
# the base characters of that tokenizer: everything else (CJK, emoji, most
# accented letters) takes the byte fallback
TOKENIZER_ALPHABET = ("▁" + "".join(chr(c) for c in range(33, 127)) + "éèàüöñ")
_SYLLABLES = ("ka", "lo", "mi", "re", "su", "ta", "ne", "vo", "pi", "gu", "sha", "dri",
              "on", "el", "ar", "ix", "um", "qu", "zy", "bel")
_ACCENTED = ("café", "naïve", "Ångström", "résumé", "crème", "brûlée", "façade", "Zürich",
             "São", "Paulo", "Øresund", "jalapeño", "Málaga", "Kraków", "Dvořák")
_CJK_WORDS = ("日本語", "東京", "中文", "新闻", "한국어", "뉴스", "ひらがな", "カタカナ")
_EMOJI = ("😀", "👍🏽", "🇯🇵", "❤️", "🎉", "🚀", "👩‍👩‍👧", "☕")


def tokenizer_item_table(num_items, seed=0):
    """Item texts drawn from ``seed`` (title, tag, description) that mix
    pseudo-words of ASCII syllables (Zipf-distributed) with accented Latin,
    CJK, emoji, digit runs and runs of spaces; item 0 has none, as in the
    catalogs."""
    import numpy as np

    from mhrec_tpu_torch.data.synthetic import ItemTextTable

    rng = np.random.default_rng((seed, 7))
    words = ["".join(_SYLLABLES[int(j)] for j in rng.integers(0, len(_SYLLABLES), size=k))
             for k in rng.integers(1, 5, size=6000)]
    zipf = np.cumsum(1.0 / np.arange(1, len(words) + 1))
    zipf /= zipf[-1]

    def word():
        r = rng.random()
        if r < 0.06:
            return _ACCENTED[int(rng.integers(len(_ACCENTED)))]
        if r < 0.09:
            return _CJK_WORDS[int(rng.integers(len(_CJK_WORDS)))]
        if r < 0.11:
            return _EMOJI[int(rng.integers(len(_EMOJI)))]
        if r < 0.16:
            return str(int(rng.integers(0, 10 ** int(rng.integers(1, 7)))))
        w = words[int(np.searchsorted(zipf, rng.random()))]
        return w.capitalize() if rng.random() < 0.15 else w

    def phrase(n):
        out = []
        for _ in range(n):
            out.append(word())
            out.append(" " * int(rng.choice([1, 1, 1, 1, 1, 1, 2, 3])))
        return "".join(out).rstrip(" ")

    ids = np.arange(1, num_items)
    columns = {"title": [phrase(int(rng.integers(2, 7))) for _ in ids],
               "tag": [f"tag_{int(rng.integers(0, 50))}" for _ in ids],
               "description": [phrase(int(rng.integers(10, 160))) for _ in ids]}
    return ItemTextTable(ids, columns)


def rendered_texts(config, table, num_items):
    """Each item's text as the corpus pass renders it (``ItemTextCache``)."""
    from types import SimpleNamespace

    from mhrec_tpu_torch.data.textset import ItemTextCache

    cache = ItemTextCache(SimpleNamespace(item_text=table), None, config["text_keys"],
                          config["item_prompt"], TOKENIZER_MAX_LENGTH)
    return [cache.render(i) for i in range(num_items)]


def write_llama_tokenizer(dirpath, texts, vocab_size, seed=0):
    """A TinyLlama-shaped ``tokenizer.json`` and ``tokenizer_config.json``
    in plain Python: BPE with byte fallback and ``fuse_unk``; <unk> <s> </s>,
    the 256 ``<0xNN>`` tokens, TOKENIZER_ALPHABET, then merges that build the
    most frequent words of ``texts`` left to right (a word: a ▁-run and what
    follows it, after the normalizer), then words of syllables drawn from
    ``seed``, until the vocabulary holds exactly ``vocab_size`` entries; the
    Prepend/Replace ▁ normalizer, no pre-tokenizer, a BOS template; the
    config names LlamaTokenizer with ``add_bos_token: true`` and
    ``legacy: false``. Returns the seconds taken."""
    import collections
    import random
    import re as _re

    t0 = time.perf_counter()
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(
        specials + [f"<0x{b:02X}>" for b in range(256)] + list(TOKENIZER_ALPHABET))}
    merges = []
    alphabet = set(TOKENIZER_ALPHABET)
    counts = collections.Counter(
        w for t in texts for w in _re.split("(?<=[^▁])(?=▁)", "▁" + t.replace(" ", "▁")))

    def build(word):
        cur = word[0]
        for ch in word[1:]:
            if len(vocab) >= vocab_size:
                return
            new = cur + ch
            if new not in vocab:
                merges.append([cur, ch])
                vocab[new] = len(vocab)
            cur = new

    for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= vocab_size:
            break
        if set(w) <= alphabet:
            build(w)
    rnd = random.Random(seed)
    while len(vocab) < vocab_size:
        build("▁" + "".join(rnd.choice(_SYLLABLES) for _ in range(rnd.randint(2, 6))))
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate(specials)]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "<s>", "type_id": 1}},
                                    {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                                      "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    with open(os.path.join(dirpath, "tokenizer.json"), "w", encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False)
    with open(os.path.join(dirpath, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "LlamaTokenizer", "add_bos_token": True,
                   "add_eos_token": False, "legacy": False, "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>", "pad_token": None,
                   "model_max_length": 2048}, fh)
    return time.perf_counter() - t0


def ids_digest(id_lists):
    """sha256 over id lists: each list's length and ids as little-endian
    int32."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for ids in id_lists:
        a = np.asarray(ids, dtype="<i4")
        h.update(len(a).to_bytes(4, "little"))
        h.update(a.tobytes())
    return h.hexdigest()


def _corpus_pass(tokenizer, config, data, cache_dir=None):
    """The corpus's id lists through ``ItemTextCache`` (a fresh one, whose
    per-item cache is cold), and the seconds taken; from the disk cache under
    ``cache_dir`` when it holds one for this tokenizer and these texts."""
    import numpy as np

    from mhrec_tpu_torch.data.textset import ItemTextCache

    cache = ItemTextCache(data, tokenizer, config["text_keys"], config["item_prompt"],
                          config["MAX_TEXT_LENGTH"])
    t0 = time.perf_counter()
    if cache_dir is not None:
        hit = cache.load_disk_cache(cache_dir, "synthetic", data.item_num)
    tokens, lens = cache.batch(np.arange(data.item_num))
    seconds = time.perf_counter() - t0
    ids = [tokens[i, :n].tolist() for i, n in enumerate(lens)]
    return ids, seconds, (hit if cache_dir is not None else None), cache


def hllm_tokenizer_phase(work_dir, tower_dir):
    """HLLM with both towers from hllm_pretrained's TinyLlama-1.1B checkpoint
    (its shards linked, not written again) and a tokenizer.json of
    TinyLlama's layout (``write_llama_tokenizer``, vocabulary 32,000) beside
    them, over PRETRAINED_ITEMS items whose texts ``tokenizer_item_table``
    draws: the tokenizer's load seconds; the corpus tokenized on the host
    with a cold cache (a fresh tokenizer), again (the BPE word cache warm)
    and from the disk cache (items/s, tokens/s, tokens an item); every id
    below 32,000; both repeats equal to the first; the id lists' digest equal
    to TOKENIZER_DIGEST (what transformers gives on the CPU); then serving
    (``run.serve``, the packed corpus pass: ``packed_attn_fwd`` once per layer
    per corpus batch) and training (``run.train``, PRETRAINED_TRAIN_STEPS
    steps: 44 ``packed_attn_fwd`` and 22 ``packed_attn_bwd`` launches a step)
    through that tokenizer. Returns (launches, ok)."""
    import numpy as np
    import torch

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher, build_tokenizer
    from mhrec_tpu_torch.run import train

    vocab = TINYLLAMA_1B["vocab_size"]
    tok_dir = link_layer_cut(tower_dir, os.path.join(work_dir, "tinyllama_tokenizer"),
                             TINYLLAMA_1B, TINYLLAMA_1B["num_hidden_layers"])
    data = InMemoryInteractionData(
        num_users=PRETRAINED_USERS, num_items=PRETRAINED_ITEMS, seq_len=2 * 24 + 2 * 8,
        num_categories=11, eval_pred_len=8, max_item_list_length=24, seed=0)
    t0 = time.perf_counter()
    data.item_text = tokenizer_item_table(PRETRAINED_ITEMS, seed=0)
    texts_s = time.perf_counter() - t0
    serve_cfg = hllm_config(tok_dir, work_dir)
    texts = rendered_texts(serve_cfg, data.item_text, PRETRAINED_ITEMS)
    write_s = write_llama_tokenizer(tok_dir, texts, vocab, seed=0)

    t0 = time.perf_counter()
    tokenizer = build_tokenizer(tok_dir, vocab)
    load_s = time.perf_counter() - t0
    cold, cold_s, _, cache = _corpus_pass(tokenizer, serve_cfg, data)
    same_render = [cache.render(i) for i in range(PRETRAINED_ITEMS)] == texts
    warm, warm_s, _, _ = _corpus_pass(tokenizer, serve_cfg, data)
    cache_dir = os.path.join(work_dir, "token_cache_probe")
    cache.build_disk_cache(cache_dir, "synthetic", data.item_num)
    disk, disk_s, hit, _ = _corpus_pass(build_tokenizer(tok_dir, vocab), serve_cfg, data,
                                        cache_dir)
    n_tokens = sum(len(ids) for ids in cold)
    digest = ids_digest(cold)
    ids_ok = all(0 <= i < vocab for ids in cold for i in ids)
    tok_ok = (getattr(tokenizer, "kind", None) == "hf:LlamaTokenizerFast" and same_render
              and ids_ok and warm == cold and disk == cold and hit
              and digest == TOKENIZER_DIGEST)

    trainer, _, serve_launches, ok_serve, _ = hllm_serve_phase(
        serve_cfg, data, phase="hllm_tokenizer_serve")
    text_cache = trainer._corpus_batcher.text_cache
    served = text_cache.tokenizer.kind == "hf:LlamaTokenizerFast" and np.array_equal(
        text_cache.batch(np.arange(PRETRAINED_ITEMS))[1], np.asarray([len(x) for x in cold]))
    layers = trainer.model.item_config.num_hidden_layers
    n_batches = math.ceil(data.item_num / trainer._corpus_batcher.batch_size)
    del trainer
    torch.cuda.empty_cache()

    cfg = hllm_train_config(tok_dir, work_dir, total_iters=PRETRAINED_TRAIN_STEPS,
                            eval_interval=100 * PRETRAINED_TRAIN_STEPS)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, stats, result = train(cfg, data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # the test split's corpus pass runs in the training config's batches
    test_batches = math.ceil(data.item_num / trainer._corpus_batcher.batch_size)
    per_step = {"packed_attn_fwd": (train_launches["packed_attn_fwd"] - layers * test_batches)
                / stats["iters"],
                "packed_attn_bwd": train_launches["packed_attn_bwd"] / stats["iters"]}
    losses = [loss for _, loss in trainer.fetched_losses]
    # the train batcher run.train builds, and the evaluation's corpus batcher
    trained = {TextSEQTrainBatcher(cfg, data).text_cache.tokenizer.kind,
               trainer._corpus_batcher.text_cache.tokenizer.kind} == {"hf:LlamaTokenizerFast"}
    ok_train = (stats["iters"] == PRETRAINED_TRAIN_STEPS and len(losses) == stats["iters"]
                and all(math.isfinite(x) for x in losses) and trained
                and per_step == {"packed_attn_fwd": 2 * layers, "packed_attn_bwd": layers}
                and "pred_7" in result)
    del trainer
    torch.cuda.empty_cache()
    ok = bool(tok_ok and ok_serve and served and ok_train
              and serve_launches["packed_attn_fwd"] == layers * n_batches == 44)
    emit({"phase": "hllm_tokenizer", "vocab": len(tokenizer.model.vocab),
          "texts_s": texts_s, "tokenizer_write_s": write_s, "tokenizer_load_s": load_s,
          "items": PRETRAINED_ITEMS, "tokens": n_tokens,
          "tokens_per_item": n_tokens / PRETRAINED_ITEMS,
          "chars_per_item": sum(map(len, texts)) / PRETRAINED_ITEMS,
          "cold_items_per_s": PRETRAINED_ITEMS / cold_s, "cold_tokens_per_s": n_tokens / cold_s,
          "warm_items_per_s": PRETRAINED_ITEMS / warm_s, "warm_tokens_per_s": n_tokens / warm_s,
          "disk_cache_items_per_s": PRETRAINED_ITEMS / disk_s,
          "disk_cache_tokens_per_s": n_tokens / disk_s,
          "ids_below_vocab": ids_ok, "repeat_equal": warm == cold, "disk_cache_hit": bool(hit),
          "disk_cache_equal": disk == cold, "digest": digest, "digest_expected": TOKENIZER_DIGEST,
          "serve_used_tokenizer": bool(served), "serve_launches": serve_launches,
          "train_steps": stats["iters"], "train_seconds": seconds,
          "steady_examples_per_s": stats["steady_examples_per_s"], "losses": losses,
          "peak_mem_gb": peak_gb, "train_launches": train_launches,
          "launches_per_step": per_step, "metrics": result, "ok": ok})
    return {"serve": serve_launches, "train": train_launches}, ok


def _step_stats(trainer, stream, steps):
    """``steps`` train steps after one untimed: steady examples/s, peak
    memory, the losses, the launches a step."""
    import torch

    trainer.train_step(next(stream))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(next(stream))["loss"].detach()) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    return {"steady_examples_per_s": steps * LEVERS_BATCH / seconds, "step_s": seconds / steps,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
            "launches_per_step": {k: v / steps for k, v in launches.items() if v}}


def _one_batch_grads(trainer, batch, to_host):
    import torch

    model = trainer.model
    model.train()
    for p in model.parameters():
        p.grad = None
    out = model(trainer._train_device_batch(batch), generator=trainer.step_generator(0))
    out["loss"].backward()
    grads = {n: (p.grad.detach().to("cpu") if to_host else p.grad.detach())
             for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    return float(out["loss"].detach()), grads


def _state_bytes(opt):
    return sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values()
               if hasattr(v, "numel") and v.is_cuda)


def _checkpoints_equal(a, b):
    """Two checkpoint files hold equal tensors and values."""
    import torch

    pa = torch.load(a, map_location="cpu", weights_only=True, mmap=True)
    pb = torch.load(b, map_location="cpu", weights_only=True, mmap=True)

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
        if isinstance(x, dict):
            return (isinstance(y, dict) and set(x) == set(y)
                    and all(same(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return x == y
    return same(pa, pb)


def _host_copy_rate(trainer):
    """The 22-layer model's checkpoint state (parameters and AdamW moments,
    25.7 GB) copied to host memory by ``host_copy``, the copy an
    asynchronous save makes (pageable). Nothing is written."""
    import torch

    from mhrec_tpu_torch.trainer import checkpoint as ckpt_io

    state = {"params": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copy, nbytes = ckpt_io.host_copy(state)
    seconds = time.perf_counter() - t0
    del copy
    return {"bytes": nbytes, "seconds": seconds, "gb_per_s": nbytes / 1e9 / seconds}


def hllm_train_levers_phase(trainer, cfg, data, work_dir):
    """The HLLM training levers on the pretrained-tower phase's trained
    model (hllm_train_config's: 22 layers):

    * one best-checkpoint save synchronous, then one asynchronous of the
      same state, during whose write the loop takes a train step: the
      seconds the loop was blocked, the writer's seconds, the host copy's
      bytes, and both files equal tensor for tensor. On a 1-layer
      hllm_train_config model from a 1-layer cut of the weights (about 3.5
      GB a file, mostly the heads and the token table): the machine's disk
      takes 45 GiB of writes a run, and hllm_train's asynchronous 25.7 GB
      save of the 22-layer model is already one of them. The 22-layer
      model's state is copied to host memory as ``host_copy`` does it
      (pageable), without a write;
    * LEVERS_STEPS steps at LEVERS_BATCH sequences under ``remat_policy``
      ``full`` and ``dots``: steady examples/s, peak memory, launches a step
      (44 ``packed_attn_fwd``, 22 ``packed_attn_bwd`` under both); one
      batch's gradients under ``dots`` against ``full``'s (relative L2 of
      each tensor within F32_GRAD_TOL);
    * ``adam_mu_dtype`` / ``adam_nu_dtype: bfloat16`` against the default
      fused AdamW: the optimizer state's bytes and peak memory over the same
      steps; losses finite."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.trainer import Trainer
    from mhrec_tpu_torch.trainer.lr_schedule import build_schedule
    from mhrec_tpu_torch.trainer.optim import build_optimizer

    rec, ok = {}, True
    stream = build_dataloader(hllm_train_config(
        cfg["item_pretrain_dir"], work_dir, train_batch_size=LEVERS_BATCH, num_negatives=16),
        data)[0].infinite_batches(prefetch=2)
    # saves, on a 1-layer cut of the same weights (the machine's disk takes
    # 45 GiB of writes a run, and hllm_train's 25.7 GB checkpoint is one
    # of them): synchronous, then asynchronous of the same state with a
    # train step during the write
    one_layer = link_layer_cut(cfg["item_pretrain_dir"], os.path.join(work_dir, "tinyllama_1l"),
                               TINYLLAMA_1B, 1)
    small = Trainer(hllm_train_config(one_layer, work_dir,
                                      checkpoint_dir=os.path.join(work_dir, "levers")), data)
    small.setup_model()
    small.train_step(next(stream))  # the optimizer's moments exist
    path = small.checkpoint_path()
    sync_path = path + ".sync"
    small.async_checkpoint = False
    small.save_checkpoint()
    rec["sync_save"] = dict(small.checkpoint_stats)
    os.replace(path, sync_path)
    small.async_checkpoint = True
    t0 = time.perf_counter()
    small.save_checkpoint()
    blocked = time.perf_counter() - t0
    loss = float(small.train_step(next(stream))["loss"].detach())  # the loop goes on
    step_done = time.perf_counter() - t0
    small.wait_for_checkpoint()
    rec["async_save"] = dict(small.checkpoint_stats, step_done_after_s=step_done,
                             step_loss=loss, blocked_measured_s=blocked)
    t0 = time.perf_counter()
    equal = _checkpoints_equal(sync_path, path)
    rec["checkpoints_equal"] = equal
    rec["compare_s"] = time.perf_counter() - t0
    rec["save_layers"] = small.model.item_config.num_hidden_layers
    os.remove(sync_path)
    os.remove(path)
    del small
    torch.cuda.empty_cache()
    ok &= bool(equal and math.isfinite(loss))
    rec["host_copy_22_layers"] = _host_copy_rate(trainer)

    # remat_policy full against dots
    towers = [trainer.model.item_llm, trainer.model.user_llm]
    batch = next(stream)
    for pol in ("full", "dots"):
        for t in towers:
            t.remat_policy = pol
        rec[pol] = _step_stats(trainer, stream, LEVERS_STEPS)
        want = {"packed_attn_fwd": 44.0, "packed_attn_bwd": 22.0}
        ok &= (rec[pol]["launches_per_step"] == want
               and all(math.isfinite(x) for x in rec[pol]["losses"]))
    for t in towers:
        t.remat_policy = "full"
    loss_full, g_full = _one_batch_grads(trainer, batch, to_host=True)
    for t in towers:
        t.remat_policy = "dots"
    loss_dots, g_dots = _one_batch_grads(trainer, batch, to_host=False)
    for t in towers:
        t.remat_policy = "full"
    rel = max(float(torch.linalg.vector_norm(g_dots[n].float() - g.to(g_dots[n].device))
                    / max(float(torch.linalg.vector_norm(g.float())), 1e-30))
              for n, g in g_full.items())
    del g_full, g_dots
    rec["dots_vs_full"] = {"loss_full": loss_full, "loss_dots": loss_dots,
                           "grad_max_rel_l2": rel, "tolerance": F32_GRAD_TOL}
    ok &= rel <= F32_GRAD_TOL and math.isfinite(loss_dots)

    # adam moment dtypes: the default fused AdamW's state, then bfloat16's
    rec["adam_f32_state_bytes"] = _state_bytes(trainer.optimizer)
    trainer.optimizer.state.clear()
    torch.cuda.empty_cache()
    bf16_cfg = hllm_train_config(cfg["item_pretrain_dir"], work_dir,
                                 adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16")
    trainer.optimizer, trainer.group_schedules, _ = build_optimizer(
        bf16_cfg, trainer.model,
        lambda lr: build_schedule(bf16_cfg["scheduler_args"], lr, trainer.total_iters))
    rec["adam_bf16"] = _step_stats(trainer, stream, LEVERS_STEPS)
    rec["adam_bf16_state_bytes"] = _state_bytes(trainer.optimizer)
    ok &= (all(math.isfinite(x) for x in rec["adam_bf16"]["losses"])
           and rec["adam_bf16_state_bytes"] * 2 <= rec["adam_f32_state_bytes"] + 2**20)
    emit({"phase": "hllm_train_levers", "batch": LEVERS_BATCH, "steps": LEVERS_STEPS, **rec,
          "ok": bool(ok)})
    return rec["full"]["launches_per_step"], bool(ok)


def hllm_towers_phase(work_dir):
    """Two towers from checkpoints the script writes, each serving a small
    catalog (``run.serve``, the dense item tower and corpus pass: no kernel)
    and training 2 steps (``run.train``, finite losses): a
    bert-base-uncased-shaped BERT (full depth, float32 ``.safetensors``)
    and a Baichuan-13B-shaped ALiBi tower (2 of its 40 layers, bfloat16
    ``W_pack`` ``.safetensors``; its corpus batch cut to
    ALIBI_CORPUS_TRAIN_BATCH × 24 items so the [items, 40, T, T] float32
    scores fit). Every loaded tensor must equal the written one."""
    import torch

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.run import serve, train

    data = InMemoryInteractionData(
        num_users=TOWERS_USERS, num_items=TOWERS_ITEMS, seq_len=2 * 24 + 2 * 8,
        num_categories=11, eval_pred_len=8, max_item_list_length=24, seed=0, item_texts=True)
    recs, ok_all, launches_all = {}, True, {}
    for name, hf_cfg, dtype, corpus_batch in (
            ("bert_base", BERT_BASE, torch.float32, 32),
            ("baichuan_13b_2l", BAICHUAN_13B_2L, torch.bfloat16, ALIBI_CORPUS_TRAIN_BATCH)):
        tower_dir = os.path.join(work_dir, name)
        # no lm_head: the towers never read it, and the disk counts writes
        sd = hf_state_dict(hf_cfg, seed=1, device=DEVICE, dtype=dtype, lm_head=False)
        write_s = write_hf_checkpoint(tower_dir, hf_cfg, sd)
        dense = dict(packed_item_tower=False, packed_corpus_pass=False)
        reset_launches()
        t0 = time.perf_counter()
        trainer, _, result = serve(hllm_config(tower_dir, work_dir, train_batch_size=corpus_batch,
                                               **dense), data)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = read_launches()
        equal, n = loaded_equal_written(trainer.model, sd, tower_dir)
        load = tower_load_record(trainer.model)
        del trainer, sd
        torch.cuda.empty_cache()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, stats, tresult = train(hllm_train_config(
            tower_dir, work_dir, train_batch_size=2, num_negatives=16, total_iters=2,
            eval_interval=200, **dense), data)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = read_launches()
        losses = [loss for _, loss in trainer.fetched_losses]
        peak = torch.cuda.max_memory_allocated() / 2**30
        del trainer
        torch.cuda.empty_cache()
        ok = (equal and stats["iters"] == 2 and len(losses) == 2
              and all(math.isfinite(x) for x in losses) and "pred_7" in result
              and "pred_7" in tresult and not any(serve_launches.values())
              and not any(train_launches.values()))
        ok_all &= ok
        launches_all[name] = {"serve": serve_launches, "train": train_launches}
        recs[name] = {"write_s": write_s, "load": load, "loaded_tensors_equal_written": equal,
                      "tensors_compared": n, "serve_s": serve_s,
                      "users_per_s": TOWERS_USERS / serve_s, "train_s": train_s,
                      "losses": losses, "train_peak_mem_gb": peak, "ok": bool(ok)}
    emit({"phase": "hllm_towers", "items": TOWERS_ITEMS, "users": TOWERS_USERS, **recs,
          "ok": bool(ok_all)})
    return launches_all, ok_all


# -- the vision and video item towers (Qwen2-VL, CLIP / LLaVA) -------------------
# Qwen2-VL-2B-Instruct's config.json: its text decoder (1536 wide, 28 layers,
# 12 heads over 2 KV heads, SwiGLU 8960, vocab 151,936, q/k/v biases,
# rope_theta 1e6, M-RoPE sections 16/24/24) and its vision tower (1280 wide,
# 32 blocks, 16 heads, MLP ratio 4, patch 14, temporal patch 2, merge 2,
# quick-GELU): the item tower of reproduce/HLLM-Pixel8M-*.sh
QWEN2_VL_2B = {
    "model_type": "qwen2_vl", "vocab_size": 151936, "hidden_size": 1536,
    "intermediate_size": 8960, "num_hidden_layers": 28, "num_attention_heads": 12,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "max_position_embeddings": 32768, "tie_word_embeddings": True,
    "use_sliding_window": False, "sliding_window": 32768,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vision_start_token_id": 151652, "vision_end_token_id": 151653,
    "image_token_id": 151655, "video_token_id": 151656,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16,
                      "in_chans": 3, "hidden_size": 1536, "patch_size": 14,
                      "spatial_merge_size": 2, "temporal_patch_size": 2,
                      "hidden_act": "quick_gelu"},
}
# Qwen2.5-1.5B's config.json: the user tower of those scripts
QWEN25_1_5B = {
    "model_type": "qwen2", "vocab_size": 151936, "hidden_size": 1536,
    "intermediate_size": 8960, "num_hidden_layers": 28, "num_attention_heads": 12,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": True,
    "use_sliding_window": False, "sliding_window": 131072,
}
# a llava_next config.json: openai/clip-vit-large-patch14's vision tower
# (1024 wide, 24 layers, 16 heads, MLP 4096, patch 14, 224 px, quick-GELU)
# under a text decoder of Qwen2.5-1.5B's widths
CLIP_L14_LLAVA = {
    "model_type": "llava_next",
    "text_config": {k: v for k, v in QWEN25_1_5B.items()},
    "vision_config": {"model_type": "clip_vision_model", "hidden_size": 1024,
                      "num_hidden_layers": 24, "num_attention_heads": 16,
                      "intermediate_size": 4096, "patch_size": 14, "image_size": 224,
                      "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5},
}
# Qwen2-VL's added tokens (tokenizer.json of Qwen2-VL-2B-Instruct)
QWEN2_VL_ADDED = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
                  "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
                  "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
                  "<|image_pad|>", "<|video_pad|>")
QWEN2_VL_FIRST_ADDED = 151643
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
               r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# the byte-level BPE the image phases write: entries (bytes, then merges)
IMAGE_TOKENIZER_VOCAB = 8192
# hllm_image: users and catalog; the share of items with no image (the
# black fallback) and with a file that does not decode (the same); the
# images' native sizes (h, w), resized to 224 × 224 on the host. 4,096 and
# 4,096 until the distributed phase joined the script (a depth cut)
# the item and user decoders' layers in hllm_image: 28 each (Qwen2-VL-2B's
# and Qwen2.5-1.5B's) until the distributed phase's baselines and
# sharded-table runs joined the script, 14 and then 7 as its FSDP runs and
# the reference-checkpoint phase joined it (depth cuts; the vision tower
# keeps its 32 blocks)
IMAGE_LLM_LAYERS = 4
# 512 and 512 until the distributed phase's FSDP runs joined the script
IMAGE_USERS = 256
IMAGE_ITEMS = 256
IMAGE_MISSING_EVERY = 16
# 257 until IMAGE_ITEMS fell to 256 (so that a broken file is still met)
IMAGE_BROKEN_EVERY = 127
IMAGE_NATIVE_SIZES = ((256, 256), (240, 320), (320, 240), (224, 224))
# the host's decode rate is taken over this many items (cold, then the LRU)
IMAGE_HOST_RATE_ITEMS = 512
# the towers' seconds are taken on this many items of a corpus batch
IMAGE_TOWER_ITEMS = 256
# the serving corpus batch: MAX_ITEM_LIST_LENGTH 10 × this (640 items)
IMAGE_SERVE_BATCH = 64
# the training cut: sequences a card and the Adam moments' type. The script
# runs 8 a card (128 over 16 cards); see PERF.md §4 for why 4 and bf16
IMAGE_TRAIN_BATCH = 4
IMAGE_ADAM_MOMENTS = "bfloat16"
# 2 steps (5 until the baselines phase joined the script, 3 until the
# distributed phase's HLLM run joined it, to keep it well inside its time
# limit): the steady rate is taken over the last one
IMAGE_TRAIN_STEPS = 2
# the busy share: train steps under the profiler
IMAGE_PROFILED_STEPS = 1
# hllm_image_variants: the towers' depth, users, catalog, steps; the share
# of items with frames / images
VARIANT_VIT_BLOCKS = 2
VARIANT_LLM_LAYERS = 2
# 128 users until the distributed phase joined the script, 64 until its
# FSDP runs joined it; the items stay above the largest top-k (200)
VARIANT_USERS = 32
VARIANT_ITEMS = 256
VARIANT_STEPS = 1  # 2 until the distributed phase joined the script
# the variants' bf16 item embeddings against a float32 copy's (unit
# vectors, max abs difference) on the first corpus batch
VARIANT_F32_TOL = 5e-2
# the variants' images: native sizes of mixed aspect (h, w)
VARIANT_SIZES = ((224, 224), (448, 224), (160, 320), (112, 112), (300, 500))


def _bytes_to_unicode():
    """GPT-2's byte → printable character map (byte-level BPE)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def write_qwen2_tokenizer(dirpath, texts, vocab_size=IMAGE_TOKENIZER_VOCAB, seed=0):
    """A Qwen2-VL-layout ``tokenizer.json`` and ``tokenizer_config.json`` in
    plain Python: byte-level BPE (NFC, the Qwen2 split regex, GPT-2's byte
    map; the 256 byte characters, then merges that build the most frequent
    words of ``texts`` left to right, then words of syllables drawn from
    ``seed``, until ``vocab_size`` entries), and Qwen2-VL's added tokens at
    their ids (<|endoftext|> 151643 … <|vision_start|> 151652,
    <|vision_end|> 151653, <|image_pad|> 151655, <|video_pad|> 151656);
    the config names Qwen2Tokenizer. Returns the seconds taken."""
    import collections
    import random
    import re as _re

    t0 = time.perf_counter()
    bmap = _bytes_to_unicode()
    vocab = {bmap[b]: i for i, b in enumerate(range(256))}
    merges = []
    counts = collections.Counter(
        "".join(bmap[b] for b in w.encode("utf-8"))
        for t in texts for w in _re.findall(r" ?[A-Za-z]+| ?[0-9]| ?[^\sA-Za-z0-9]+|\s+", t))

    def build(word):
        cur = word[0]
        for ch in word[1:]:
            if len(vocab) >= vocab_size:
                return
            new = cur + ch
            if new not in vocab:
                merges.append([cur, ch])
                vocab[new] = len(vocab)
            cur = new

    for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= vocab_size:
            break
        build(w)
    rnd = random.Random(seed)
    while len(vocab) < vocab_size:
        build(bmap[32] + "".join(rnd.choice(_SYLLABLES) for _ in range(rnd.randint(2, 6))))
    added = [{"id": QWEN2_VL_FIRST_ADDED + i, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(QWEN2_VL_ADDED)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT}, "behavior": "Isolated",
             "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    with open(os.path.join(dirpath, "tokenizer.json"), "w", encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False)
    with open(os.path.join(dirpath, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "Qwen2Tokenizer", "add_prefix_space": False,
                   "added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items()
                                                           if k != "id"} for a in added},
                   "bos_token": None, "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
                   "unk_token": None, "errors": "replace", "split_special_tokens": False,
                   "clean_up_tokenization_spaces": False, "model_max_length": 32768}, fh)
    return time.perf_counter() - t0


def _synthetic_image(rng, h, w):
    """A JPEG-like picture: a smooth random field with mild noise."""
    import numpy as np
    from PIL import Image

    low = rng.integers(0, 256, size=(h // 16 + 2, w // 16 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(low).resize((w, h), Image.Resampling.BILINEAR), np.int16)
    img = img + rng.integers(-12, 13, size=img.shape, dtype=np.int16)
    return Image.fromarray(img.clip(0, 255).astype(np.uint8))


def write_item_images(root, id2token, n_items, seed=0, sizes=IMAGE_NATIVE_SIZES,
                      missing_every=IMAGE_MISSING_EVERY, broken_every=IMAGE_BROKEN_EVERY):
    """``{root}/{token}.jpg`` (reference dataload.py:213-218) for items
    1..n_items-1, drawn from ``seed`` at the native sizes ``sizes`` (cycled),
    on 8 threads: none for every ``missing_every``-th item and a file that
    does not decode for every ``broken_every``-th (both take the black
    image). Returns (seconds, images written)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)

    def one(x):
        if x % missing_every == 0:
            return 0
        path = os.path.join(root, f"{id2token[x]}.jpg")
        if x % broken_every == 0:
            with open(path, "wb") as fh:
                fh.write(b"\xff\xd8 not a picture")
            return 0
        h, w = sizes[x % len(sizes)]
        _synthetic_image(np.random.default_rng((seed, x)), h, w).save(path, quality=90)
        return 1

    with ThreadPoolExecutor(8) as pool:
        written = sum(pool.map(one, range(1, n_items)))
    return time.perf_counter() - t0, written


def write_item_frames(root, id2token, n_items, frames=4, seed=0, size=(240, 320), every=2):
    """Directories ``{root}/{token}/f{t}.jpg`` of ``frames`` frames for every
    ``every``-th item (the rest take black frames): a picture drifting
    frame to frame. Returns the seconds taken."""
    import numpy as np

    from PIL import Image

    t0 = time.perf_counter()
    for x in range(1, n_items, every):
        d = os.path.join(root, str(id2token[x]))
        os.makedirs(d, exist_ok=True)
        base = np.asarray(_synthetic_image(np.random.default_rng((seed, x)), *size))
        for t in range(frames):
            Image.fromarray(np.roll(base, 8 * t, axis=1)).save(os.path.join(d, f"f{t}.jpg"),
                                                                quality=90)
    return time.perf_counter() - t0


def vision_hf_state_dict(cfg, seed, device, dtype):
    """HF-named weights of ``cfg``'s vision tower, drawn as ``hf_state_dict``
    draws (normal 0.02, norm scales 1 + 0.1·normal): ``visual.*`` for
    Qwen2-VL (the Conv3d patch embedding [E, C, tps, ps, ps]),
    ``vision_tower.vision_model.*`` and ``multi_modal_projector.*`` for a
    LLaVA / CLIP tower (no weights for the unused last layer)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    v, sd = cfg["vision_config"], {}

    def put(name, *shape, one=False):
        t = torch.randn(shape, generator=gen, device=device) * (0.1 if one else 0.02)
        sd[name] = (t + 1.0 if one else t).to(dtype)

    def block(p, D, F, names):
        for ln in names[:2]:
            put(f"{p}.{ln}.weight", D, one=True)
            put(f"{p}.{ln}.bias", D)
        for name, o, i in names[2]:
            put(f"{p}.{name}.weight", o, i)
            put(f"{p}.{name}.bias", o)

    text = cfg.get("text_config", cfg)["hidden_size"]
    if cfg["model_type"].startswith("llava"):
        D, F, ps = v["hidden_size"], v["intermediate_size"], v["patch_size"]
        V = "vision_tower.vision_model"
        put(f"{V}.embeddings.class_embedding", D)
        put(f"{V}.embeddings.patch_embedding.weight", D, 3, ps, ps)
        put(f"{V}.embeddings.position_embedding.weight", (v["image_size"] // ps) ** 2 + 1, D)
        put(f"{V}.pre_layrnorm.weight", D, one=True)
        put(f"{V}.pre_layrnorm.bias", D)
        for i in range(v["num_hidden_layers"] - 1):
            block(f"{V}.encoder.layers.{i}", D, F, ("layer_norm1", "layer_norm2", [
                (f"self_attn.{n}", D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")] + [
                ("mlp.fc1", F, D), ("mlp.fc2", D, F)]))
        put("multi_modal_projector.linear_1.weight", text, D)
        put("multi_modal_projector.linear_1.bias", text)
        put("multi_modal_projector.linear_2.weight", text, text)
        put("multi_modal_projector.linear_2.bias", text)
        return sd
    D, ps, tps, m = v["embed_dim"], v["patch_size"], v["temporal_patch_size"], \
        v["spatial_merge_size"]
    F = D * v["mlp_ratio"]
    put("visual.patch_embed.proj.weight", D, 3, tps, ps, ps)
    for i in range(v["depth"]):
        block(f"visual.blocks.{i}", D, F, ("norm1", "norm2", [
            ("attn.qkv", 3 * D, D), ("attn.proj", D, D), ("mlp.fc1", F, D), ("mlp.fc2", D, F)]))
    put("visual.merger.ln_q.weight", D, one=True)
    put("visual.merger.ln_q.bias", D)
    put("visual.merger.mlp.0.weight", m * m * D, m * m * D)
    put("visual.merger.mlp.0.bias", m * m * D)
    put("visual.merger.mlp.2.weight", text, m * m * D)
    put("visual.merger.mlp.2.bias", text)
    return sd


def image_config(item_dir, user_dir, work_dir, **over):
    """reproduce/HLLM-Pixel8M-prior.sh's flags: the item tower from
    ``item_dir`` (a Qwen2-VL ``config.json``; random weights from ``seed``
    where it holds none) and the user tower from ``user_dir``, ``use_image``
    over ``{work_dir}/images/synthetic/{token}.jpg`` at 224 × 224,
    MAX_TEXT_LENGTH 256, windows of 10, 8 prior heads × 2 segment heads,
    hierarchical, one medusa layer, segment embeddings, negatives drawn per
    category (10 a pool), the weighted prior loss, learning rate 1e-4,
    gradient checkpointing, the dense item tower; ``train_batch_size``
    IMAGE_SERVE_BATCH sets the corpus batch (640 items). Cut against the
    script: ``log_detailed_results`` off, and the parquet reader's knobs
    (``tag_version``, ``min_seq_len``), which the in-memory data does not
    read. ``over`` overrides any key."""
    from mhrec_tpu_torch.config import Config

    C = 8
    return Config(
        config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"],
        config_dict=dict(
            dict(dataset="synthetic", seed=0, data_path=work_dir,
                 checkpoint_dir=os.path.join(work_dir, "ckpt"),
                 item_pretrain_dir=item_dir, user_pretrain_dir=user_dir,
                 image_dir=os.path.join(work_dir, "images"), use_image=True,
                 use_image_online=False, img_height=224, img_width=224,
                 MAX_TEXT_LENGTH=256, gradient_checkpointing=True, MAX_ITEM_LIST_LENGTH=10,
                 loss="prior", train_batch_size=IMAGE_SERVE_BATCH, medusa_num_layers=1,
                 num_segment_head=2, num_prior_head=C, head_interaction="hierarchical",
                 split_mode="combine", pred_len=4, eval_pred_len=8, medusa_lambda=0.99,
                 eval_num_cats=C, neg_sample_by_cat=True, neg_sample_mix_ratio=0,
                 pos_sample_mix_ratio=0, weighted_prior_loss=True,
                 outlier_user_metrics="category", segment_embed=True, save_for_eval=False,
                 eval_by_cat=False, packed_item_tower=False, packed_corpus_pass=False,
                 suppress_history=False, val_only=True, update_interval=1,
                 optim_args={"learning_rate": 1e-4, "weight_decay": 0.01},
                 image_cache_items=IMAGE_ITEMS,
                 int_to_category={i: f"cat_{i}" for i in range(C)}),
            **over),
    ).finalize()


def image_train_config(item_dir, user_dir, work_dir, **over):
    """``image_config``'s model with the training cut: IMAGE_TRAIN_BATCH
    sequences a step (each 14 positives and 9 pools of 10 negatives: 416
    items at 4), ``adam_mu_dtype`` / ``adam_nu_dtype`` IMAGE_ADAM_MOMENTS,
    IMAGE_TRAIN_STEPS steps and one evaluation at the end."""
    return image_config(item_dir, user_dir, work_dir, **dict(
        dict(val_only=False, train_batch_size=IMAGE_TRAIN_BATCH,
             adam_mu_dtype=IMAGE_ADAM_MOMENTS, adam_nu_dtype=IMAGE_ADAM_MOMENTS,
             total_iters=IMAGE_TRAIN_STEPS, eval_interval=IMAGE_TRAIN_STEPS),
        **over))


def _host_image_rates(config, data, n=IMAGE_HOST_RATE_ITEMS):
    """The host's decode and patchify rate over ``n`` items of the catalog
    with a fresh store: cold (every item decoded, resized, normalized and
    patchified on ImagePreprocessor's threads) and from its LRU of
    patches."""
    import numpy as np

    from mhrec_tpu_torch.data.vision import ItemImageStore

    store = ItemImageStore(config, data)
    ids = np.arange(1, min(n + 1, data.item_num))
    out = {}
    for kind in ("cold", "lru"):
        t0 = time.perf_counter()
        for s in range(0, len(ids), 256):
            store.batch(ids[s:s + 256])
        out[f"{kind}_items_per_s"] = len(ids) / (time.perf_counter() - t0)
    out["lru_items"] = len(store._patch_cache)
    out["lru_gb"] = sum(v.nbytes for v in store._patch_cache.values()) / 1e9
    return out


def _tower_times(trainer, n=IMAGE_TOWER_ITEMS):
    """Seconds of the vision tower (with the splice's positions:
    ``_image_kwargs``) and of the item LLM on the first ``n`` items of the
    first corpus batch, warm, each once after one untimed call, the card
    synchronised at both ends."""
    import torch

    from mhrec_tpu_torch.models.hllm.hllm import batch_image_extra

    model, cb = trainer.model, next(trainer._corpus_batcher.batches())
    dev = trainer.device
    cb = {k: v[:n] for k, v in cb.items() if hasattr(v, "shape") and v.ndim}
    tokens = torch.as_tensor(cb["tokens"], dtype=torch.long, device=dev)
    lens = torch.as_tensor(cb["lens"], dtype=torch.long, device=dev)
    img = trainer._image_device_arrays(cb, "")
    px, image_extra = img["pixel_patches"], batch_image_extra(img, "")
    col = torch.arange(tokens.shape[1], device=dev)[None]
    mask = (col < lens[:, None] + 1).int()

    def timed(fn):
        fn()
        _sync(trainer)
        t0 = time.perf_counter()
        out = fn()
        _sync(trainer)
        return time.perf_counter() - t0, out

    with torch.no_grad():
        vis_s, extra = timed(lambda: model._image_kwargs(tokens, px, image_extra))
        llm_s, hidden = timed(lambda: model.item_llm(
            input_ids=tokens, attention_mask=mask, emb_tokens=model.item_emb_tokens,
            emb_pos=lens, **extra))
    n = len(lens)
    return {"items": n, "vision_ms": 1e3 * vis_s, "item_llm_ms": 1e3 * llm_s,
            "vision_items_per_s": n / vis_s, "item_llm_items_per_s": n / llm_s,
            "image_tokens": int(extra["image_embeds"].shape[1]),
            "finite": bool(torch.isfinite(hidden).all())}


def image_serve_phase(config, data, phase, device=None):
    """The serving path of an image item tower: ``run.serve`` with the
    launch counts set to 0 just before and read just after (no kernel of
    #1–#8c runs: the image span rides the dense item tower); then a warm
    repeated evaluation (users/s; the same metrics), its corpus pass timed
    apart, the card synchronised at its end (items/s; tokens/s over the
    text, image and emb slots), the vision tower's and the item LLM's
    seconds on part of a corpus batch (``_tower_times``) and the host's
    decode rate (``_host_image_rates``). Returns (trainer, test loader,
    launches, ok)."""
    import numpy as np
    import torch

    from mhrec_tpu_torch.run import serve

    reset_launches()
    dev = torch.device(device or DEVICE)
    _reset_peak(dev)
    t0 = time.perf_counter()
    trainer, test_loader, result = serve(config, data, device)
    _sync(trainer)
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    corpus_pass, tables = trainer.compute_item_feature, []

    def timed_corpus_pass(*args, **kw):
        t0 = time.perf_counter()
        tables.append(corpus_pass(*args, **kw))
        _sync(trainer)
        tables.append(time.perf_counter() - t0)
        return tables[0]

    trainer.compute_item_feature = timed_corpus_pass
    t0 = time.perf_counter()
    again = trainer.evaluate(test_loader)
    _sync(trainer)
    eval_s = time.perf_counter() - t0
    del trainer.compute_item_feature
    table, corpus_s = tables
    peak = _peak_gb(dev)
    towers = _tower_times(trainer)
    host = _host_image_rates(config, data)
    batcher = trainer._corpus_batcher
    _, lens = batcher.text_cache.batch(np.arange(data.item_num))
    tokens = int(lens.sum()) + data.item_num * batcher.n_emb
    n_users = len(test_loader)
    ok = (all(math.isfinite(v) for v in _metric_values(result)) and again == result
          and "pred_7" in result and not any(launches.values())
          and tuple(table.shape) == (data.item_num, trainer.model.item_config.hidden_size)
          and bool(torch.isfinite(table).all()) and towers["finite"])
    emit({"phase": phase, "users": n_users, "items": int(data.item_num),
          "corpus_batch_items": batcher.batch_size, "corpus_tokens": tokens,
          "serve_seconds": serve_s, "corpus_seconds": corpus_s,
          "items_per_s": data.item_num / corpus_s, "tokens_per_s": tokens / corpus_s,
          "eval_seconds": eval_s, "users_per_s": n_users / eval_s,
          "towers": towers, "host_images": host, "peak_mem_gb": peak, "launches": launches,
          "repeat_matches": again == result, "metrics": result, "ok": bool(ok)})
    return trainer, test_loader, launches, ok


def image_train_phase(config, data, phase, device=None, profiled_steps=0):
    """The training path of an image item tower: ``run.train`` (fit, one
    evaluation of the valid split with a best-checkpoint save, the test
    split from the reloaded checkpoint) with the launch counts set to 0 just
    before and read just after: no kernel of #1–#8c runs; every loss finite.
    Steady examples/s and items/s, peak memory; on the card, the device's
    busy share over ``profiled_steps`` more steps under the profiler.
    Returns (trainer, launches, ok)."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.run import train

    dev = torch.device(device or DEVICE)
    reset_launches()
    _reset_peak(dev)
    t0 = time.perf_counter()
    trainer, stats, result = train(config, data, device)
    _sync(trainer)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = _peak_gb(dev)
    steps = stats["iters"]
    stream = build_dataloader(config, data)[0].epoch_batches(5)
    batch = next(stream)
    items = batch["pos_tokens"].shape[0] + batch["neg_tokens"].shape[0]
    busy = None
    if dev.type == "cuda" and profiled_steps:
        batches = [batch] + [next(stream) for _ in range(profiled_steps - 1)]
        wall, _, busy_us = profiled(lambda: [trainer.train_step(b) for b in batches])
        busy = busy_us / 1e6 / wall
    losses = [loss for _, loss in trainer.fetched_losses]
    ckpt = trainer.checkpoint_stats
    step_s = config["train_batch_size"] / stats["steady_examples_per_s"]
    ok = (steps == config["total_iters"] and len(losses) == steps
          and all(math.isfinite(x) for x in losses) and int(trainer.nan_step) < 0
          and not any(launches.values()) and os.path.isfile(trainer.checkpoint_path())
          and "load_s" in ckpt and all(math.isfinite(v) for v in _metric_values(result))
          and "pred_7" in result)
    emit({"phase": phase, "steps": steps, "batch": config["train_batch_size"],
          "adam_moments": str(config.get("adam_mu_dtype") or "float32"),
          "items_per_step": int(items), "seconds": seconds, "fit_wall_s": stats["wall_s"],
          "fit_eval_s": stats["eval_s"], "steady_examples_per_s": stats["steady_examples_per_s"],
          "steady_step_s": step_s, "item_tower_items_per_s": items / step_s,
          "device_busy_share": busy, "losses": losses, "nan_step": int(trainer.nan_step),
          "peak_mem_gb": peak, "launches": launches, "checkpoint": ckpt, "metrics": result,
          "ok": bool(ok)})
    return trainer, launches, ok


def _image_catalog(n_users, n_items, max_item_list_length=10, num_categories=8):
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

    return InMemoryInteractionData(
        num_users=n_users, num_items=n_items, seq_len=2 * max_item_list_length + 2 * 8,
        num_categories=num_categories, eval_pred_len=8,
        max_item_list_length=max_item_list_length, seed=0, item_texts=True)


def _write_tower_dirs(work_dir, item_cfg, user_cfg, data, config_for_texts):
    """The item and user tower directories: each ``config.json`` (no
    weights: random from the seed) and, beside the item tower's, the
    Qwen2-VL-layout tokenizer over the catalog's rendered texts."""
    dirs = {}
    for name, cfg in (("item", item_cfg), ("user", user_cfg)):
        d = dirs[name] = os.path.join(work_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump(cfg, fh)
    tok_s = write_qwen2_tokenizer(
        dirs["item"], rendered_texts(config_for_texts, data.item_text, data.item_num))
    return dirs["item"], dirs["user"], tok_s


def hllm_image_phase(work_dir, device=None, item_cfg=None, user_cfg=None,
                     n_users=IMAGE_USERS, n_items=IMAGE_ITEMS, profiled_steps=None, **over):
    """reproduce/HLLM-Pixel8M-prior.sh at full width: a Qwen2-VL-2B item
    tower (its vision tower and its text decoder) and a Qwen2.5-1.5B user
    tower from ``config.json`` files (random weights from seed 0; by
    default both decoders cut to IMAGE_LLM_LAYERS layers), the
    Qwen2-VL-layout tokenizer, 224 × 224 JPEGs for most of the catalog.
    Serves (``hllm_image_serve``) and trains (``hllm_image_train``).
    ``item_cfg``, ``user_cfg``, the catalog and ``over`` cut it for the CPU
    tests. Returns (each path's launches, the names of the checks that
    failed)."""
    import torch

    item_cfg = item_cfg or dict(QWEN2_VL_2B, num_hidden_layers=IMAGE_LLM_LAYERS)
    user_cfg = user_cfg or dict(QWEN25_1_5B, num_hidden_layers=IMAGE_LLM_LAYERS)
    data = _image_catalog(n_users, n_items)
    base = image_config(None, None, work_dir, **over)
    item_dir, user_dir, tok_s = _write_tower_dirs(work_dir, item_cfg, user_cfg, data, base)
    img_s, n_img = write_item_images(os.path.join(work_dir, "images", "synthetic"),
                                     data.id2token["item_id"], data.item_num)
    emit({"phase": "hllm_image_setup", "tokenizer_write_s": tok_s, "images_write_s": img_s,
          "images": n_img, "items": int(data.item_num)})
    failed, launches = [], {}
    trainer, _, launches["hllm_image_serve"], ok = image_serve_phase(
        image_config(item_dir, user_dir, work_dir, **over), data, "hllm_image_serve", device)
    if not ok:
        failed.append("hllm_image_serve")
    tokenizer = trainer._corpus_batcher.text_cache.tokenizer
    if getattr(tokenizer, "kind", None) != "hf:Qwen2TokenizerFast":
        failed.append("hllm_image_tokenizer")
    del trainer
    if torch.device(device or DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    cfg = image_train_config(item_dir, user_dir, work_dir, **over)
    trainer, launches["hllm_image_train"], ok = image_train_phase(
        cfg, data, "hllm_image_train", device,
        IMAGE_PROFILED_STEPS if profiled_steps is None else profiled_steps)
    if not ok:
        failed.append("hllm_image_train")
    del trainer
    return launches, failed


def image_fit_phase(work_dir):
    """How hllm_image's training fits on the card: two train steps of its
    model (image_train_config) at the script's 8 sequences a card with
    float32 and with bfloat16 Adam moments, and at 4 with bfloat16 ones;
    each setting's peak memory, or "out of memory". A sizing probe
    (``--image-fit``), not a path of the smoke run."""
    import gc

    import torch

    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.trainer import Trainer

    data = _image_catalog(IMAGE_USERS, IMAGE_ITEMS)
    base = image_config(None, None, work_dir)
    item_dir, user_dir, _ = _write_tower_dirs(work_dir, QWEN2_VL_2B, QWEN25_1_5B, data, base)
    write_item_images(os.path.join(work_dir, "images", "synthetic"), data.id2token["item_id"],
                      data.item_num)
    out = {}
    for batch, moments in ((8, "float32"), (8, "bfloat16"), (4, "bfloat16")):
        cfg = image_train_config(item_dir, user_dir, work_dir, train_batch_size=batch,
                                 adam_mu_dtype=moments, adam_nu_dtype=moments)
        stream = build_dataloader(cfg, data)[0].epoch_batches(0)
        batches = [next(stream) for _ in range(2)]
        trainer = None
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer = Trainer(cfg, data)
            trainer.setup_model()
            t0 = time.perf_counter()
            for b in batches:
                loss = float(trainer.train_step(b)["loss"])
            torch.cuda.synchronize()
            out[f"batch{batch}_{moments}"] = {
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                "two_steps_s": time.perf_counter() - t0, "loss": loss}
        except torch.cuda.OutOfMemoryError:
            out[f"batch{batch}_{moments}"] = "out of memory"
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "hllm_image_fit", "limit_gb": torch.cuda.get_device_properties(0).total_memory
          / 2**30, **out})
    return out


def image_phases(seconds):
    """hllm_image and hllm_image_variants, each in a work directory of its
    own. Returns (each path's launches, the names of the checks that
    failed)."""
    import torch

    launches, failed = {}, []
    for name, fn in (("hllm_image", hllm_image_phase),
                     ("hllm_image_variants", hllm_image_variants_phase)):
        t0 = time.perf_counter()
        work_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            paths, bad = fn(work_dir)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        launches.update(paths)
        failed.extend(bad)
        seconds[name] = time.perf_counter() - t0
    return launches, failed


def _f32_agreement(trainer):
    """The first corpus batch's item embeddings, the bfloat16 model's
    against a float32 copy's (unit vectors, max abs difference)."""
    import torch

    from mhrec_tpu_torch.models.hllm.hllm import batch_image_extra
    from mhrec_tpu_torch.models.layers import cosine_normalize
    from mhrec_tpu_torch.trainer import Trainer

    f32 = Trainer(trainer.config, trainer.dataload, device=trainer.device, dtype=torch.float32)
    f32.model.load_state_dict(trainer.model.state_dict())
    cb = next(trainer._corpus_batcher.batches())
    put = trainer._image_device_arrays
    tok = torch.as_tensor(cb["tokens"], dtype=torch.long, device=trainer.device)
    lens = torch.as_tensor(cb["lens"], dtype=torch.long, device=trainer.device)
    img = put(cb, "")
    with torch.no_grad():
        a, b = (cosine_normalize(m.compute_item_chunk(tok, lens, img["pixel_patches"],
                                                      batch_image_extra(img, "")))
                for m in (trainer.model, f32.model))
    del f32
    return float((a - b).abs().max())


def hllm_image_variants_phase(work_dir, device=None, vit_blocks=VARIANT_VIT_BLOCKS,
                              llm_layers=VARIANT_LLM_LAYERS, n_users=VARIANT_USERS,
                              n_items=VARIANT_ITEMS, steps=VARIANT_STEPS, widths=None,
                              img=224, **over):
    """The other vision paths at the full widths and a small depth
    (``vit_blocks`` vision blocks, ``llm_layers`` + ``llm_layers`` text
    layers), each serving ``n_items`` items and training ``steps`` steps
    with the Qwen2-VL-layout tokenizer; no kernel of #1–#8c runs in any:

    * ``video``: ``use_video``, 4 frames from frame-image directories
      (grid_t 2, 512 patches, 128 video tokens), black frames for half the
      items, the towers' weights from a ``.safetensors`` checkpoint the
      phase writes (``visual.*`` and ``model.*``): every loaded tensor
      equal to the written one;
    * ``dynamic``: ``dynamic_image_res`` over images of mixed native sizes
      (smart-resize grids up to 248 tokens, per-item spans and M-RoPE
      positions);
    * ``llava_anyres``: a CLIP-L/14 LLaVA tower with the fixed
      ``anyres_grid`` [2, 2] (5 crops, 1,312 image tokens), its weights
      (``vision_tower.*``, ``multi_modal_projector.*``,
      ``language_model.model.*``) from a checkpoint the phase writes;
    * ``llava_dynamic``: that tower with dynamic AnyRes (the default
      pinpoints over 224: up to 5 crops, 256–1,312 tokens).

    Each also holds its bf16 item embeddings on the first corpus batch to a
    float32 copy's (VARIANT_F32_TOL). ``widths`` (Qwen2-VL item, user and
    LLaVA item config dicts) and ``img`` (the Qwen2-VL image side) replace
    the full widths for the CPU tests, and ``over`` overrides any key of
    every variant. Returns (each path's launches, the names of the checks
    that failed)."""
    import torch

    from mhrec_tpu_torch.run import train

    dev = torch.device(device or DEVICE)
    qwen_item, qwen_user, llava_item = widths or (QWEN2_VL_2B, QWEN25_1_5B, CLIP_L14_LLAVA)
    qwen_item = dict(qwen_item, num_hidden_layers=llm_layers,
                     vision_config=dict(qwen_item["vision_config"], depth=vit_blocks))
    user = dict(qwen_user, num_hidden_layers=llm_layers)
    llava = dict(llava_item, text_config=dict(llava_item["text_config"],
                                              num_hidden_layers=llm_layers),
                 vision_config=dict(llava_item["vision_config"],
                                    num_hidden_layers=vit_blocks + 1))
    # batch 2 with 2 negatives a pool: 46 items a step, 20 a corpus batch
    small = dict(train_batch_size=2, eval_batch_size=64, num_negatives=4,
                 image_cache_items=n_items, img_height=img, img_width=img)
    S = llava["vision_config"]["image_size"]
    g = S // llava["vision_config"]["patch_size"]
    # LLaVA's image tokens: a base crop and a 2 × 2 grid with a newline a
    # row (the fixed grid, and the dynamic pinpoints' largest), then text
    llava_text = g * g + 2 * g * (2 * g + 1) + 64
    variants = {
        "video": (qwen_item, dict(use_image=False, use_video=True, video_nframes=4)),
        "dynamic": (qwen_item, dict(dynamic_image_res=True)),
        "llava_anyres": (llava, dict(anyres_grid=[2, 2], img_height=S, img_width=S,
                                     MAX_TEXT_LENGTH=llava_text)),
        "llava_dynamic": (llava, dict(dynamic_image_res=True, img_height=S, img_width=S,
                                      MAX_TEXT_LENGTH=llava_text)),
    }
    failed, launches, recs = [], {}, {}
    for name, (item_cfg, extra) in variants.items():
        t0 = time.perf_counter()
        opts = {**small, **extra, **over}
        data, root = _image_catalog(n_users, n_items), os.path.join(work_dir, name)
        item_dir, user_dir, _ = _write_tower_dirs(root, item_cfg, user, data,
                                                  image_config(None, None, root, **opts))
        ids = data.id2token["item_id"]
        if name == "video":
            write_item_frames(os.path.join(root, "videos", "synthetic"), ids, n_items)
            opts["video_dir"] = os.path.join(root, "videos")
        else:
            write_item_images(os.path.join(root, "images", "synthetic"), ids, n_items,
                              sizes=VARIANT_SIZES)
        loaded = None
        if name in ("video", "llava_anyres"):
            # the towers' weights from a checkpoint: text decoder and vision tower
            sd = hf_state_dict(item_cfg.get("text_config", item_cfg), seed=2, device=dev.type,
                               dtype=torch.bfloat16, lm_head=False)
            if name == "llava_anyres":
                sd = {k.replace("model.", "language_model.model.", 1): v for k, v in sd.items()}
            vis = vision_hf_state_dict(item_cfg, seed=3, device=dev.type, dtype=torch.bfloat16)
            write_hf_checkpoint(item_dir, item_cfg, {**sd, **vis})
            loaded = vis
        cfg = image_config(item_dir, user_dir, root, **opts)
        trainer, _, serve_launches, ok_serve = image_serve_phase(
            cfg, data, f"hllm_image_{name}_serve", device)
        rec = {"serve_ok": bool(ok_serve)}
        if loaded is not None:
            from mhrec_tpu_torch.models.llm.vision import load_any_vision_params
            want = load_any_vision_params(loaded, trainer.model.visual.config)
            rec["loaded_visual_equal_written"] = all(
                torch.equal(p.detach(), want[n].to(p.device, p.dtype))
                for n, p in trainer.model.visual.named_parameters())
            rec["visual_load"] = trainer.model.tower_load_stats.get("visual")
        rec["bf16_vs_f32_unit_emb_err"] = _f32_agreement(trainer)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        reset_launches()
        tcfg = image_config(item_dir, user_dir, root, **dict(
            opts, val_only=False, total_iters=steps, eval_interval=100 * steps))
        trainer, stats, result = train(tcfg, data, device)
        train_launches = read_launches()
        losses = [loss for _, loss in trainer.fetched_losses]
        rec.update(train_steps=stats["iters"], losses=losses,
                   steady_examples_per_s=stats["steady_examples_per_s"],
                   seconds=time.perf_counter() - t0)
        ok = (ok_serve and rec.get("loaded_visual_equal_written", True)
              and rec["bf16_vs_f32_unit_emb_err"] <= VARIANT_F32_TOL
              and stats["iters"] == steps and len(losses) == steps
              and all(math.isfinite(x) for x in losses) and "pred_7" in result
              and not any(train_launches.values()))
        rec["ok"] = bool(ok)
        recs[name] = rec
        launches[f"hllm_image_{name}_serve"] = serve_launches
        launches[f"hllm_image_{name}_train"] = train_launches
        if not ok:
            failed.append(f"hllm_image_variants/{name}")
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "hllm_image_variants", "vit_blocks": vit_blocks, "llm_layers": llm_layers,
          "users": n_users, "items": n_items, **recs, "ok": not failed})
    return launches, failed


def profiled(fn):
    """``fn()`` under ``torch.profiler``: (wall seconds, the device's
    (start, end, name) spans in µs, sorted, and its busy µs: the union of
    the spans)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return wall, spans, busy_us


def profile_phase(name, fn, top: int = 40):
    """``fn()`` under ``torch.profiler``: device time by group and of the
    ``top`` kernels, and the device's busy share of the wall time (the union
    of kernel intervals over the host time of ``fn``)."""
    import re

    wall, spans, busy_us = profiled(fn)
    by_name = {}
    for start, stop, kname in spans:
        n, us = by_name.get(kname, (0, 0.0))
        by_name[kname] = (n + 1, us + stop - start)
    rows = sorted(({"name": k[:120], "count": n, "device_ms": us / 1e3}
                   for k, (n, us) in by_name.items()), key=lambda r: -r["device_ms"])
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for r in rows:
        g = next((g for g, pat in PROFILE_GROUPS if re.search(pat, r["name"])), "other")
        groups[g] += r["device_ms"]
    emit({"phase": f"profile_{name}", "wall_s": wall, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / wall, "groups_ms": groups,
          "device_events": sum(r["count"] for r in rows), "top": rows[:top]})


def profile_train_steps(trainer, data, n=5, name="train"):
    """``n`` train steps under the profiler, after one warm step."""
    import torch

    from mhrec_tpu_torch.data import build_dataloader

    stream = build_dataloader(trainer.config, data)[0].epoch_batches(7)
    batches = [next(stream) for _ in range(n + 1)]
    trainer.train_step(batches[0])  # warm
    torch.cuda.synchronize()

    def run():
        for b in batches[1:]:
            trainer.train_step(b)

    profile_phase(name, run)


def pretrained_phases(seconds):
    """The phases of the HLLM towers from local checkpoints, their tokenizer
    and the training levers, in a work directory of their own (the levers phase
    writes two 25.7 GB checkpoints). Returns (each path's launches, the
    names of the phases that failed)."""
    import torch

    failed, launches = [], {}
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_pretrained_")
    try:
        t0 = time.perf_counter()
        trainer, cfg, data, launches_pre, ok = hllm_pretrained_phase(work_dir)
        launches["hllm_pretrained_serve"] = launches_pre["serve"]
        launches["hllm_pretrained_train"] = launches_pre["train"]
        if not ok:
            failed.append("hllm_pretrained")
        seconds["hllm_pretrained"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches["hllm_train_levers_per_step"], ok = hllm_train_levers_phase(
            trainer, cfg, data, work_dir)
        if not ok:
            failed.append("hllm_train_levers")
        del trainer, data
        torch.cuda.empty_cache()
        seconds["hllm_train_levers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok_launches, ok = hllm_tokenizer_phase(
            work_dir, os.path.join(work_dir, "tinyllama_safetensors"))
        launches["hllm_tokenizer_serve"] = tok_launches["serve"]
        launches["hllm_tokenizer_train"] = tok_launches["train"]
        if not ok:
            failed.append("hllm_tokenizer")
        seconds["hllm_tokenizer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        towers_launches, ok = hllm_towers_phase(work_dir)
        launches.update({f"hllm_towers_{k}": v for k, v in towers_launches.items()})
        if not ok:
            failed.append("hllm_towers")
        seconds["hllm_towers"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    return launches, failed


# the machine's own scratch root (its disk), kept by use_memory_scratch for
# disk_tmpdir
DISK_TMP = None


def disk_tmpdir(prefix):
    """A scratch directory on the machine's disk, for the phases whose
    checkpoints fit its cap together (the HSTU train phase, the baselines
    phase and (b)-(d) of the distributed phase, about 35 GB): checkpoints
    read back through a memory map load from the disk's page cache several
    times faster than from /dev/shm."""
    return tempfile.mkdtemp(prefix=prefix, dir=DISK_TMP)


def use_memory_scratch():
    """Put every scratch file of the run (checkpoints, tower weights,
    images, tokenizers; each phase's ``tempfile.mkdtemp``) in a directory of
    its own under /dev/shm where the machine has that tmpfs: the card's
    machines cap what a run writes to their disk (45 GiB, deletions not
    refunded), and the phases write over 100 GB of checkpoints in turn;
    ``disk_tmpdir`` keeps the disk for a few. Each phase removes its files
    when it ends, and the directory goes at exit."""
    import atexit

    global DISK_TMP
    DISK_TMP = tempfile.gettempdir()
    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        tempfile.tempdir = tempfile.mkdtemp(prefix="chip_smoke_", dir="/dev/shm")
        os.environ["TMPDIR"] = tempfile.tempdir  # the processes it starts too
        atexit.register(shutil.rmtree, tempfile.tempdir, True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not os.path.isdir(os.path.join(ROOT, "mhrec_tpu_torch", "csrc")):
        print("chip_smoke.py: the mhrec_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    sys.path.insert(0, ROOT)
    if "--distributed-rank" in args:
        # one rank of the distributed phase's gloo runs (distributed_phase),
        # on the device its spec names
        i = args.index("--distributed-rank")
        return dist_rank(int(args[i + 1]), int(args[i + 2]), args[i + 3])
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    use_memory_scratch()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"nvidia_smi": smi})
    # the image paths run no kernel of this port: these modes skip the build
    if "--image-fit" in args:
        work_dir = tempfile.mkdtemp(prefix="chip_smoke_image_fit_")
        try:
            image_fit_phase(work_dir)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        return 0
    if "--image-only" in args:
        seconds = {}
        launches, failed = image_phases(seconds)
        emit({"phase_seconds": seconds, "path_launches": launches})
        return 1 if failed else 0

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    per_source = cuda_build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": per_source})

    hstu_data = HSTU_DATA  # the HSTU phases' users and catalog
    if "--distributed-only" in args:
        # the distributed phase alone
        work_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
        disk_dir = disk_tmpdir("chip_smoke_dist_")
        try:
            launches, ok = distributed_phase(work_dir, smi, disk_dir=disk_dir)
        finally:
            remove_dirs(work_dir, disk_dir)
        emit({"path_launches": launches})
        return 0 if ok else 1
    if "--stu-bwd-ab" in args:
        # #4 alone at the train step's shape and at hstu-1b's width, split by
        # the kernels a call runs: a copy of this script beside another
        # tree's mhrec_tpu_torch times that tree's kernel
        ok = True
        with torch.no_grad():
            for shape_name, H in (("size4", 16), ("1b", 32)):
                ok &= kernel_phase("stu_bwd", shape_name, 64, 50, H, 64, torch.bfloat16)["ok"]
                kernel_breakdown("stu_bwd", shape_name, 64, 50, H, 64, torch.bfloat16)
        return 0 if ok else 1
    if "--reference-only" in args:
        # the reference-checkpoint phase alone
        work_dir = tempfile.mkdtemp(prefix="chip_smoke_reference_")
        try:
            launches, ok = reference_ckpt_phase(hstu_data, work_dir)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        emit({"path_launches": {"reference_ckpt": launches}})
        return 0 if ok else 1
    if "--baselines-only" in args:
        # the baselines phase alone (its kernel holds included)
        work_dir = disk_tmpdir("chip_smoke_baselines_")
        try:
            launches, bad, _ = baselines_phase(InMemoryInteractionData(**hstu_data), work_dir)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        emit({"path_launches": launches})
        return 1 if bad else 0
    if "--train-only" in args:
        data = InMemoryInteractionData(**hstu_data)
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            ok = train_phase(data, ckpt_dir)[2]
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        return 0 if ok else 1

    failed = []
    kernel_recs = {}
    seconds = {}  # wall seconds of each phase
    t0 = time.perf_counter()
    shapes = {"size4": (64, 50, 16, 64), "merrec": (32, 400, 8, 64)}
    with torch.no_grad():
        for kind in ("stu", "attn", "stu_bwd", "attn_bwd"):
            for shape_name, (B, L, H, d) in shapes.items():
                for dtype in (torch.float32, torch.bfloat16):
                    rec = kernel_phase(kind, shape_name, B, L, H, d, dtype)
                    # every bfloat16 route here runs on the tensor cores
                    if not rec["ok"] or (dtype == torch.bfloat16
                                         and rec["route"] != "tensor_cores"):
                        failed.append(f"{kind}/{shape_name}/{dtype}")
                    if shape_name == "size4" and dtype == torch.bfloat16:
                        # the train step's shape (batch 64, window 50, bf16)
                        kernel_recs[kind] = rec
            if kind in ("stu", "attn"):
                # the serving shape: one eval batch of 1024 users
                rec = kernel_phase(kind, "serve", 1024, 50, 16, 64, torch.bfloat16)
                kernel_recs[kind] = rec
                if not (rec["ok"] and rec["route"] == "tensor_cores"):
                    failed.append(f"{kind}/serve")
            if kind == "stu":
                # hstu-1b's serving shape and its train batch (F = 2048)
                for shape_name, B in (("1b_serve", 1024), ("1b_train", HSTU_1B_BATCH)):
                    rec = kernel_phase(kind, shape_name, B, 50, 32, 64, torch.bfloat16)
                    if not (rec["ok"] and rec["route"] == "tensor_cores"):
                        failed.append(f"{kind}/{shape_name}")
            if kind == "attn":
                # the serving shape, split by the kernels a call runs, on
                # both routes
                for route in ("tensor_cores", "cuda_cores"):
                    kernel_breakdown(kind, "serve", 1024, 50, 16, 64, torch.bfloat16, route=route)
            if kind == "stu_bwd":
                # hstu-1b's width (F = 2048), where one block holds an SM,
                # at the size4 train batch and at hstu-1b's
                for shape_name, B in (("1b", 64), ("1b_train", HSTU_1B_BATCH)):
                    rec = kernel_phase(kind, shape_name, B, 50, 32, 64, torch.bfloat16)
                    if not (rec["ok"] and rec["route"] == "tensor_cores"):
                        failed.append(f"{kind}/{shape_name}")
            if kind in ("stu_bwd", "attn_bwd"):
                # the train step's shape, split by the kernels a call runs,
                # on both routes
                for route in ("tensor_cores", "cuda_cores"):
                    kernel_breakdown(kind, "size4", 64, 50, 16, 64, torch.bfloat16, route=route)
        kernel_recs["row_adamw"] = row_adamw_phase()
        if not kernel_recs["row_adamw"]["ok"]:
            failed.append("row_adamw")
        for dtype in (torch.float32, torch.bfloat16):
            # the corpus pass and the item tower's training run in bfloat16
            rec = kernel_recs["packed"] = packed_kernel_phase(dtype)
            if not rec["ok"]:
                failed.append(f"packed/{dtype}")
            rec = kernel_recs["packed_bwd"] = packed_bwd_kernel_phase(dtype)
            if not rec["ok"]:
                failed.append(f"packed_bwd/{dtype}")
    torch.cuda.empty_cache()
    seconds["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data = InMemoryInteractionData(**hstu_data)
    trainer, test_loader, serve_launches, ok = serve_phase(data)
    batch0 = next(iter(test_loader.batches()))
    if not ok:
        failed.append("serve")
    pallas_launches, ok = impl_phase(trainer, batch0, "pallas")
    if not ok:
        failed.append("pallas")
    if not impl_phase(trainer, batch0, "xla")[1]:
        failed.append("xla")
    if "--profile" in args:
        profile_phase("serve", lambda: trainer.evaluate(test_loader))
    seconds["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    outputs_launches, ok, plain_users_per_s = eval_outputs_phase(trainer, test_loader)
    if not ok:
        failed.append("eval_outputs")
    seconds["eval_outputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed_launches, ok = eval_streamed_phase(trainer, test_loader, plain_users_per_s)
    if not ok:
        failed.append("eval_streamed_metrics")
    del trainer
    torch.cuda.empty_cache()
    seconds["eval_streamed_metrics"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_reference_")
    try:
        reference_launches, ok = reference_ckpt_phase(hstu_data, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    if not ok:
        failed.append("reference_ckpt")
    torch.cuda.empty_cache()
    seconds["reference_ckpt"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ckpt_dir = disk_tmpdir("chip_smoke_ckpt_")
    try:
        trainer, train_launches, ok, train_stats = train_phase(data, ckpt_dir)
        if not ok:
            failed.append("train")
        impl_train_launches, ok = train_impl_phase(trainer, data)
        if not ok:
            failed.append("train_impl")
        if "--profile" in args:
            profile_train_steps(trainer, data)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del trainer
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    accum_launches, ok = train_accum_phase(data, train_stats["steady_examples_per_s"])
    if not ok:
        failed.append("train_accum")
    torch.cuda.empty_cache()
    seconds["train_accum"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    disk_dir = disk_tmpdir("chip_smoke_dist_")
    try:
        dist_launches, ok = distributed_phase(work_dir, smi, disk_dir=disk_dir)
    finally:
        remove_dirs(work_dir, disk_dir)
    if not ok:
        failed.append("distributed")
    torch.cuda.empty_cache()
    seconds["distributed"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    work_dir = disk_tmpdir("chip_smoke_baselines_")
    try:
        baseline_launches, baseline_failed, _ = baselines_phase(data, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    failed.extend(baseline_failed)
    torch.cuda.empty_cache()
    seconds["baselines"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_1b_")
    try:
        hstu_1b_launches, hstu_1b_failed = hstu_1b_phase(data, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    failed.extend(hstu_1b_failed)
    del data
    torch.cuda.empty_cache()
    seconds["hstu_1b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_hllm_")
    try:
        pretrain_dir = os.path.join(work_dir, "tinyllama")
        os.makedirs(pretrain_dir)
        with open(os.path.join(pretrain_dir, "config.json"), "w") as fh:
            json.dump(dict(TINYLLAMA_1B, num_hidden_layers=HLLM_LAYERS), fh)
        # HLLM_USERS and HLLM_ITEMS: cut twice as phases joined the script
        data = InMemoryInteractionData(
            num_users=HLLM_USERS, num_items=HLLM_ITEMS, seq_len=2 * 24 + 2 * 8, num_categories=11,
            eval_pred_len=8, max_item_list_length=24, seed=0, item_texts=True,
        )
        trainer, test_loader, hllm_launches, ok, hllm_result = hllm_serve_phase(
            hllm_config(pretrain_dir, work_dir), data)
        if not ok:
            failed.append("hllm_serve")
        if "--profile" in args:
            profile_phase("hllm_serve", lambda: trainer.evaluate(test_loader))
        if not hllm_impl_phase(trainer, data):
            failed.append("hllm_impl")
        seconds["hllm_serve"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        host_launches, ok = hllm_host_table_phase(trainer, test_loader, hllm_result, data)
        if not ok:
            failed.append("hllm_host_table")
        del trainer, test_loader
        torch.cuda.empty_cache()
        seconds["hllm_host_table"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        trainer, hllm_train_launches, ok = hllm_train_phase(
            hllm_train_config(pretrain_dir, work_dir), data)
        if not ok:
            failed.append("hllm_train")
        if not hllm_train_impl_phase(trainer, data, work_dir):
            failed.append("hllm_train_impl")
        if "--profile" in args:
            profile_train_steps(trainer, data, n=3, name="hllm_train")
        del trainer
        seconds["hllm_train"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    pretrained_launches, pretrained_failed = pretrained_phases(seconds)
    failed.extend(pretrained_failed)
    image_launches, image_failed = image_phases(seconds)
    failed.extend(image_failed)
    emit({"phase_seconds": seconds})
    # each path's launches, counted from 0 just before it
    emit({"path_launches": {
        "serve": serve_launches, "eval_outputs": outputs_launches,
        "eval_streamed_metrics": streamed_launches, "reference_ckpt": reference_launches,
        "train": train_launches,
        "train_accum": accum_launches, **dist_launches, **baseline_launches,
        **hstu_1b_launches,
        "hllm_serve": hllm_launches,
        "hllm_host_table": host_launches, "hllm_train": hllm_train_launches,
        **pretrained_launches, **image_launches}})

    launches = {"stu": serve_launches["hstu_stu_gated_fwd"],
                "attn": pallas_launches["hstu_attn_fwd"],
                "stu_bwd": train_launches["hstu_stu_gated_bwd"],
                "attn_bwd": impl_train_launches["hstu_attn_bwd"],
                "row_adamw": train_launches["row_adamw"],
                "packed": hllm_launches["packed_attn_fwd"],
                "packed_bwd": hllm_train_launches["packed_attn_bwd"]}
    # the data-parallel runs' launches a rank ((b)-(e): the baselines' #1, #4
    # and #7, the sharded table's #7), beside the main path's count
    dist_paths = {path: counts for path, counts in dist_launches.items()
                  if path.startswith("distributed_gloo_")}
    emit({"kernels": [
        dict(KERNELS[kind], route="cuda", launches=launches[kind],
             distributed_launches_per_rank={
                 path[len("distributed_gloo_"):]: counts[KERNELS[kind]["name"]]
                 for path, counts in dist_paths.items() if counts[KERNELS[kind]["name"]]},
             max_abs_err=kernel_recs[kind]["max_abs_err"], ms=kernel_recs[kind]["ms"],
             host_ms=kernel_recs[kind]["host_ms"],
             plain_ms=kernel_recs[kind]["plain_ms"], bound_ms=kernel_recs[kind]["bound_ms"],
             bound_by=kernel_recs[kind]["bound_by"],
             library_ms=kernel_recs[kind].get("library_ms"))
        for kind in KERNELS
    ]})
    if failed:
        print("chip_smoke.py: failed phases: " + ", ".join(failed), file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
