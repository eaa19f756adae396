#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mhrec_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``mhrec_tpu_torch/csrc`` (one ``nvcc``
per source, in parallel), holds each kernel against its plain PyTorch version
on the card, then drives the serving path (``run.py --val_only True``) of the
paper's headline model — HSTU size4 (1024d, 16 layers, 16 heads, window 50)
with 8-category prior heads, 4 segment heads, additive interaction and the
prior switch — over 4096 users and a 200,000-item catalog, with random
weights from seed 0. Two more passes run one eval batch with
``attn_impl: pallas`` (through the pointwise attention kernel) and with
``attn_impl: xla`` (the plain path, no kernel) and hold each against the
serve path's embeddings of that batch.

Prints one JSON object per line: the card's name and power limit, build
seconds, each kernel phase (error against tolerance; kernel, plain and
bound times), the serve phase, the pallas and xla phases, a ``kernels``
summary, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without the last line. ``--profile`` adds a phase that evaluates
the test split once more under ``torch.profiler`` and prints device time by
kernel group and the top kernels. float32 products run in full float32: TF32
is switched off for matmuls and cuDNN.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s, bf16 and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# tolerances of the kernel-vs-plain phases: float32 differs only in the order
# of sums; bfloat16 may also round the attention entries or the output one
# ulp apart (2^-8 relative), so it gets about three ulps
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def excess_error(out, ref, dtype_name):
    """(max |out - ref|, max of |out - ref| - (atol + rtol·|ref|)); the
    second is ≤ 0 when every element is within tolerance."""
    atol, rtol = TOL[dtype_name]
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d - (atol + rtol * ref.float().abs())).max())


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
    strided splits of one [B, L, 4·H·d] projection, as in the STU layer."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nonpad = make_nonpad(B, L, gen, dev)
    if kind == "stu":
        F = H * d
        mixed = torch.randn(B, L, 4 * F, generator=gen).mul_(0.5).to(dev, dtype)
        u, v, q, k = torch.split(mixed, [F, F, F, F], dim=-1)
        gamma = (1 + 0.1 * torch.randn(F, generator=gen)).to(dev)
        beta = (0.05 * torch.randn(F, generator=gen)).to(dev)
        return (q, k, v, u, gamma, beta, nonpad, H)
    q, k, v = (torch.randn(B, H, L, d, generator=gen).mul_(0.5).to(dev, dtype)
               for _ in range(3))
    return (q, k, v, nonpad)


def bound_ms(kind, args):
    """Least time the card could take: the larger of bytes moved (each
    input read once, the output written once) over HBM bandwidth and the
    operations over the peak rate of the input type. Attention flops count
    the causal (key ≤ query) pairs."""
    if kind == "stu":
        q, k, v, u, gamma, beta, nonpad, H = args
        B, L, F = v.shape
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, u, gamma, beta, nonpad))
        nbytes += B * L * F * q.element_size()
        pairs = B * H * L * (L + 1) // 2
        flops = 2 * pairs * (q.shape[-1] // H + F // H) + 10 * B * L * F
    else:
        q, k, v, nonpad = args
        B, H, L, d = q.shape
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, nonpad))
        nbytes += v.numel() * v.element_size()
        pairs = B * H * L * (L + 1) // 2
        flops = 2 * pairs * (d + v.shape[-1])
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


KERNELS = {
    "stu": dict(
        name="hstu_stu_gated_fwd", source="mhrec_tpu_torch/csrc/hstu_stu_gated_fwd.cu",
        replaces="mhrec_tpu/ops/pallas/hstu_attention_tpu.py:497",
    ),
    "attn": dict(
        name="hstu_attn_fwd", source="mhrec_tpu_torch/csrc/hstu_attn_fwd.cu",
        replaces="mhrec_tpu/ops/pallas/hstu_attention_tpu.py:269",
    ),
}


def kernel_fns(kind):
    from mhrec_tpu_torch.ops import hstu_attention_cuda as K

    if kind == "stu":
        return K.hstu_stu_gated_fwd, K.hstu_stu_gated_fwd_plain
    return K.hstu_attn_fwd, K.hstu_attn_fwd_plain


def kernel_phase(kind, shape_name, B, L, H, d, dtype, seed=0):
    """Compare one kernel with its plain version on the card, time both
    (plain, kernel, kernel, plain) and compute the bound. The comparison
    and timing launches are counted outside the main path's runs."""
    import torch

    fn, plain = kernel_fns(kind)
    args = kernel_inputs(kind, B, L, H, d, dtype, seed)
    out = fn(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    dname = str(dtype).replace("torch.", "")
    err, excess = excess_error(out, ref, dname)
    finite = bool(torch.isfinite(out).all())
    rec = {"phase": "kernel", "kernel": KERNELS[kind]["name"], "shape": shape_name,
           "B": B, "L": L, "H": H, "d": d, "dtype": dname, "max_abs_err": err,
           "atol": TOL[dname][0], "rtol": TOL[dname][1],
           "ok": finite and excess <= 0}
    p1, k1, k2, p2 = (cuda_ms(lambda f=f: f(*args)) for f in (plain, fn, fn, plain))
    rec["ms"], rec["plain_ms"] = min(k1, k2), min(p1, p2)
    rec["bound_ms"], rec["bound_by"] = bound_ms(kind, args)
    emit(rec)
    return rec


def serve_config():
    from mhrec_tpu_torch.config import Config

    C = 8
    return Config(
        config_file_list=["IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"],
        config_dict=dict(
            dataset="synthetic", seed=0, val_only=True,
            MAX_ITEM_LIST_LENGTH=50, loss="prior", eval_num_cats=C,
            num_prior_head=C, num_segment_head=4, head_interaction="additive",
            medusa_num_layers=1, prior_switch="in", use_prior_switch_test=True,
            segment_embed=True, split_mode="combine",
            eval_pred_len=8, pred_len=8, topk=[5, 10, 50, 200],
            eval_batch_size=1024, eval_item_chunk_size=131072,
            int_to_category={i: f"cat_{i}" for i in range(C)},
        ),
    ).finalize()


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


def serve_phase(data):
    """The main path: ``run.serve`` (what ``run.py --val_only True`` runs
    after loading data) with the launch counts set to 0 just before and read
    just after. ``serve_seconds`` is that call, set-up included, on a cold
    process; ``eval_seconds`` and ``users_per_s`` time a second, warm
    ``evaluate`` of the same split, which must give the same metrics."""
    import torch

    from mhrec_tpu_torch.ops import hstu_attention_cuda as K
    from mhrec_tpu_torch.run import serve

    config = serve_config()
    K.hstu_stu_gated_fwd.launches = 0
    K.hstu_attn_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, test_loader, result = serve(config, data)
    torch.cuda.synchronize()
    serve_seconds = time.perf_counter() - t0
    launches = {"hstu_stu_gated_fwd": K.hstu_stu_gated_fwd.launches,
                "hstu_attn_fwd": K.hstu_attn_fwd.launches}
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
    topk_ok = check_streamed_topk(trainer, next(iter(test_loader.batches())))
    ok = (sane and topk_ok and again == result and launches["hstu_stu_gated_fwd"] == 64
          and launches["hstu_attn_fwd"] == 0 and "pred_7" in result and "shared" in result)
    emit({"phase": "serve", "users": n_users, "items": int(data.item_num),
          "serve_seconds": serve_seconds, "eval_seconds": eval_seconds,
          "users_per_s": n_users / eval_seconds, "peak_mem_gb": peak_gb,
          "launches": launches, "repeat_matches": again == result,
          "streamed_topk_matches_dense": topk_ok, "metrics": result, "ok": bool(ok)})
    return trainer, test_loader, launches, ok


def impl_phase(trainer, batch, impl):
    """One eval batch's predict_embeddings with another ``attn_impl``
    against the same batch through the serve path's fused kernel: 'pallas'
    takes the pointwise attention kernel, 'xla' the plain einsum path (a
    reference that runs neither kernel)."""
    import torch

    from mhrec_tpu_torch.ops import hstu_attention_cuda as K

    dev = trainer._eval_device_batch(batch)
    ref = trainer.model.predict_embeddings(dev["item_seq"], dev["target_tags"])
    for layer in trainer.model.stu_layers:
        layer.attn_impl = impl
    K.hstu_stu_gated_fwd.launches = 0
    K.hstu_attn_fwd.launches = 0
    pe = trainer.model.predict_embeddings(dev["item_seq"], dev["target_tags"])
    torch.cuda.synchronize()
    launches = {"hstu_stu_gated_fwd": K.hstu_stu_gated_fwd.launches,
                "hstu_attn_fwd": K.hstu_attn_fwd.launches}
    for layer in trainer.model.stu_layers:
        layer.attn_impl = "auto"
    err = float((pe["head_embs"] - ref["head_embs"]).abs().max())
    cos = float((pe["head_embs"] * ref["head_embs"]).sum(-1).min())
    # the paths round the bf16 trunk at different places over 16 layers;
    # the unit-norm head embeddings must still agree closely
    tol = 5e-2
    want_attn = len(trainer.model.stu_layers) if impl == "pallas" else 0
    ok = (err <= tol and launches["hstu_attn_fwd"] == want_attn
          and launches["hstu_stu_gated_fwd"] == 0)
    emit({"phase": impl, "users": int(dev["item_seq"].shape[0]), "launches": launches,
          "head_embs_max_abs_err": err, "min_cosine": cos, "tolerance": tol, "ok": bool(ok)})
    return launches, ok


# the profile phase's groups of device kernels, by name (first match wins)
PROFILE_GROUPS = (
    ("hstu_stu_gated_fwd", "stu_gated_fwd"),
    ("hstu_attn_fwd", "attn_fwd_kernel"),
    ("matmul", "gemm|nvjet|xmma|cutlass"),
    ("topk_and_sort", "topk|sort|radix"),
    ("copy_to_host", "Memcpy DtoH"),
)


def profile_phase(trainer, loader, top: int = 40):
    """One more evaluation of the test split under ``torch.profiler``:
    device time by group and of the ``top`` kernels, and the device's busy
    share of the wall time (the union of kernel intervals over the host
    time of the evaluation)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.evaluate(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name, busy_us, end = {}, 0.0, float("-inf")
    for start, stop, name in spans:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + stop - start)
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    rows = sorted(({"name": k[:120], "count": n, "device_ms": us / 1e3}
                   for k, (n, us) in by_name.items()), key=lambda r: -r["device_ms"])
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for r in rows:
        g = next((g for g, pat in PROFILE_GROUPS if re.search(pat, r["name"])), "other")
        groups[g] += r["device_ms"]
    emit({"phase": "profile", "wall_s": wall, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / wall, "groups_ms": groups,
          "top": rows[:top]})


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not os.path.isdir(os.path.join(ROOT, "mhrec_tpu_torch", "csrc")):
        print("chip_smoke.py: the mhrec_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"nvidia_smi": smi})

    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    per_source = cuda_build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": per_source})

    failed = []
    kernel_recs = {}
    shapes = {"size4": (64, 50, 16, 64), "merrec": (32, 400, 8, 64)}
    for kind in ("stu", "attn"):
        for shape_name, (B, L, H, d) in shapes.items():
            for dtype in (torch.float32, torch.bfloat16):
                rec = kernel_phase(kind, shape_name, B, L, H, d, dtype)
                if not rec["ok"]:
                    failed.append(f"{kind}/{shape_name}/{dtype}")
        # the serving shape: one eval batch of 1024 users
        rec = kernel_phase(kind, "serve", 1024, 50, 16, 64, torch.bfloat16)
        kernel_recs[kind] = rec
        if not rec["ok"]:
            failed.append(f"{kind}/serve")

    data = InMemoryInteractionData(
        num_users=4096, num_items=200_000, seq_len=2 * 50 + 2 * 8, num_categories=8,
        eval_pred_len=8, max_item_list_length=50, seed=0,
    )
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
        profile_phase(trainer, test_loader)

    launches = {"stu": serve_launches["hstu_stu_gated_fwd"],
                "attn": pallas_launches["hstu_attn_fwd"]}
    emit({"kernels": [
        dict(KERNELS[kind], route="cuda", launches=launches[kind],
             max_abs_err=kernel_recs[kind]["max_abs_err"], ms=kernel_recs[kind]["ms"],
             plain_ms=kernel_recs[kind]["plain_ms"], bound_ms=kernel_recs[kind]["bound_ms"],
             bound_by=kernel_recs[kind]["bound_by"], library_ms=None)
        for kind in ("stu", "attn")
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
