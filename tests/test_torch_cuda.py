"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc``; elsewhere they skip. This file
imports neither JAX nor the JAX package, so on the machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 differs from the plain version only in the order of
sums (1e-4); bfloat16 may round an attention entry or an output one ulp
apart (2^-8 relative), so it gets about three ulps (2e-2).
"""

import os

import pytest
import torch

from mhrec_tpu_torch.ops import hstu_attention_cuda as K

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SHAPES = {"size4": (4, 50, 16, 64), "merrec": (2, 400, 8, 64), "odd": (3, 17, 2, 32)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _nonpad(B, L, gen, device):
    lens = torch.randint(0, L + 1, (B,), generator=gen)
    lens[0] = L
    return (torch.arange(L)[None] >= (L - lens)[:, None]).to(device)


def _close(out, ref, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _close_to_scale(out, ref, dtype):
    """``_close`` with atol taken relative to the reference's scale,
    TOL · min(1, max |ref|): the pointwise attention's outputs shrink as
    1/sqrt(L) (about 0.1 at L = 400), where a fixed atol of 2e-2 would be as
    large as they are."""
    tol = TOL[dtype]
    scale = min(1.0, float(ref.float().abs().max()))
    torch.testing.assert_close(out.float(), ref.float(), atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stu_gated_kernel_matches_plain(card, shape, dtype):
    B, L, H, d = SHAPES[shape]
    gen = torch.Generator().manual_seed(0)
    F = H * d
    mixed = (0.5 * torch.randn(B, L, 4 * F, generator=gen)).to(card, dtype)
    u, v, q, k = torch.split(mixed, [F] * 4, dim=-1)
    gamma = (1 + 0.1 * torch.randn(F, generator=gen)).to(card)
    beta = (0.05 * torch.randn(F, generator=gen)).to(card)
    nonpad = _nonpad(B, L, gen, card)
    before = K.hstu_stu_gated_fwd.launches
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    torch.cuda.synchronize()
    assert K.hstu_stu_gated_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, L, F)
    _close(out, K.hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, H), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_attn_kernel_matches_plain(card, shape, dtype):
    B, L, H, d = SHAPES[shape]
    gen = torch.Generator().manual_seed(1)
    q, k, v = ((0.5 * torch.randn(B, L, H, d, generator=gen)).to(card, dtype) for _ in range(3))
    nonpad = _nonpad(B, L, gen, card)
    before = K.hstu_attn_fwd.launches
    # [B, L, H, d] viewed head-major: the kernel reads the strides, no copy
    out = K.hstu_attention_v2(q, k, v, nonpad)
    torch.cuda.synchronize()
    assert K.hstu_attn_fwd.launches == before + 1
    ref = K.hstu_attn_fwd_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), nonpad)
    _close(out, ref.transpose(1, 2), dtype)
    flat = K.hstu_attention_bhld(*(x.transpose(1, 2).reshape(B * H, L, d) for x in (q, k, v)),
                                 nonpad.repeat_interleave(H, dim=0))
    _close(flat.reshape(B, H, L, d).transpose(1, 2), out, dtype)


def test_kernel_refuses_cpu_and_gpu_mix(card):
    x = torch.zeros(1, 2, 4, 8, device=card)
    with pytest.raises(ValueError, match="nonpad"):
        K.hstu_attn_fwd(x, x, x, torch.ones(1, 4, dtype=torch.bool))


def _gated_inputs(B, L, H, d, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    F = H * d
    mixed = (0.5 * torch.randn(B, L, 4 * F, generator=gen)).to(device, dtype)
    u, v, q, k = torch.split(mixed, [F] * 4, dim=-1)
    gamma = (1 + 0.1 * torch.randn(F, generator=gen)).to(device)
    beta = (0.05 * torch.randn(F, generator=gen)).to(device)
    g = torch.randn(B, L, F, generator=gen).to(device, dtype)
    return q, k, v, u, gamma, beta, _nonpad(B, L, gen, device), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stu_gated_bwd_kernel_matches_plain(card, shape, dtype):
    B, L, H, d = SHAPES[shape]
    q, k, v, u, gamma, beta, nonpad, g = _gated_inputs(B, L, H, d, dtype, card)
    before = K.hstu_stu_gated_bwd.launches
    out = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H)
    torch.cuda.synchronize()
    assert K.hstu_stu_gated_bwd.launches == before + 1
    ref = K.hstu_stu_gated_bwd_plain(q, k, v, u, gamma, beta, nonpad, g, H)
    for name, o, r in zip(("dq", "dk", "dv", "du", "dgamma", "dbeta"), out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        _close(o, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_attn_bwd_kernel_matches_plain(card, shape, dtype):
    B, L, H, d = SHAPES[shape]
    gen = torch.Generator().manual_seed(2)
    q, k, v, g = ((0.5 * torch.randn(B, L, H, d, generator=gen)).to(card, dtype)
                  for _ in range(4))
    nonpad = _nonpad(B, L, gen, card)
    before = K.hstu_attn_bwd.launches
    # [B, L, H, d] viewed head-major: the kernel reads the strides, no copy
    args = [x.transpose(1, 2) for x in (q, k, v, g)] + [nonpad]
    out = K.hstu_attn_bwd(*args)
    torch.cuda.synchronize()
    assert K.hstu_attn_bwd.launches == before + 1
    for o, r in zip(out, K.hstu_attn_bwd_plain(*args)):
        _close(o, r, dtype)


def test_autograd_goes_through_the_backward_kernels(card):
    B, L, H, d = SHAPES["odd"]
    q, k, v, u, gamma, beta, nonpad, g = _gated_inputs(B, L, H, d, torch.float32, card)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, u, gamma, beta)]
    before = (K.hstu_stu_gated_bwd.launches, K.hstu_attn_bwd.launches)
    K.hstu_stu_gated_fwd(*leaves, nonpad, H).backward(g)
    want = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)
    heads = [x.detach().reshape(B, L, H, d).clone().requires_grad_(True) for x in (q, k, v)]
    out = K.hstu_attention_v2(*heads, nonpad)
    out.backward(g.reshape(B, L, H, d))
    torch.cuda.synchronize()
    assert (K.hstu_stu_gated_bwd.launches, K.hstu_attn_bwd.launches) == \
        (before[0] + 2, before[1] + 1)
    flat = [x.detach().transpose(1, 2).reshape(B * H, L, d).requires_grad_(True) for x in heads]
    K.hstu_attention_bhld(*flat, nonpad.repeat_interleave(H, dim=0)).backward(
        g.reshape(B, L, H, d).transpose(1, 2).reshape(B * H, L, d))
    for x, f in zip(heads, flat):
        _close(f.grad.reshape(B, H, L, d).transpose(1, 2), x.grad, torch.float32)


@pytest.mark.parametrize("D", [96, 1024])
@pytest.mark.parametrize("wd,step", [(0.0, 0), (0.01, 7)])
def test_row_adamw_equals_plain_bit_for_bit(card, D, wd, step):
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update

    gen = torch.Generator().manual_seed(3)
    N, U, n_real = 5000, 1536, 1200
    table = torch.randn(N, D, generator=gen)
    m = 0.01 * torch.randn(N, D, generator=gen)
    v = 0.01 * torch.randn(N, D, generator=gen).abs()
    ids = torch.full((U,), -1, dtype=torch.long)
    ids[:n_real] = torch.randperm(N, generator=gen)[:n_real]
    g = torch.randn(U, D, generator=gen)
    cfg = SparseAdamConfig(weight_decay=wd)
    ref = [t.to(card) for t in (table, m, v)]
    out = [t.to(card) for t in (table, m, v)]
    before = row_adamw.launches
    row_adamw(*out, ids.to(card), g.to(card), 1e-3, step, cfg)
    sparse_adamw_row_update(*ref, ids.to(card), g.to(card), 1e-3, step, cfg)
    torch.cuda.synchronize()
    assert row_adamw.launches == before + 1
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    untouched = torch.ones(N, dtype=torch.bool)
    untouched[ids[:n_real]] = False
    assert torch.equal(out[0].cpu()[untouched], table[untouched])


def test_backward_kernels_refuse_cpu_and_gpu_mix(card):
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig

    x = torch.zeros(1, 2, 4, 8, device=card)
    with pytest.raises(ValueError, match="must be on"):
        K.hstu_attn_bwd(x, x, x, x.cpu(), torch.ones(1, 4, dtype=torch.bool, device=card))
    t = torch.zeros(4, 8, device=card)
    with pytest.raises(ValueError, match="ids"):
        row_adamw(t, t.clone(), t.clone(), torch.zeros(2, dtype=torch.long), torch.zeros(2, 8),
                  1e-3, 0, SparseAdamConfig())


def _packed_inputs(C, S, H, Hkv, dh, window, dtype, device, seed=4):
    """Random q/k/v and segment ids packed as ``pack_items`` packs: runs of
    1..window+1 tokens from the start of each row, then trailing padding."""
    gen = torch.Generator().manual_seed(seed)
    seg = torch.zeros(C, S, dtype=torch.int32)
    sid = 0
    for c in range(C):
        off, fill = 0, int(torch.randint(S // 2, S + 1, (1,), generator=gen))
        while True:
            n = int(torch.randint(1, window + 2, (1,), generator=gen))
            if off + n > fill:
                break
            sid += 1
            seg[c, off:off + n] = sid
            off += n
    q = (0.5 * torch.randn(C, S, H, dh, generator=gen)).to(device, dtype)
    k, v = ((0.5 * torch.randn(C, S, Hkv, dh, generator=gen)).to(device, dtype)
            for _ in range(2))
    return q, k, v, seg.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", ["corpus", "tiny"])
def test_packed_attn_kernel_matches_plain(card, shape, dtype):
    from mhrec_tpu_torch.models.llm.packed import packed_attention_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    C, S, H, Hkv, dh, w = {"corpus": (2, 2048, 32, 4, 64, 257),
                           "tiny": (3, 200, 4, 2, 16, 20)}[shape]
    q, k, v, seg = _packed_inputs(C, S, H, Hkv, dh, w, dtype, card)
    before = packed_attn_fwd.launches
    out = packed_attn_fwd(q, k, v, seg, w)
    torch.cuda.synchronize()
    assert packed_attn_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and bool(torch.isfinite(out).all())
    ref = packed_attention_plain(q, k, v, seg, w)
    real = seg > 0
    _close(out[real], ref[real], dtype)
    assert not bool(out[~real].any())
    # no band: the rows' runs alone bound the keys
    _close(packed_attn_fwd(q, k, v, seg)[real], packed_attention_plain(q, k, v, seg)[real], dtype)


def test_packed_attn_kernel_refuses_split_heads(card):
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    q, k, v, seg = _packed_inputs(1, 64, 4, 2, 16, 8, torch.float32, card)
    with pytest.raises(ValueError, match="contiguous heads"):
        packed_attn_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg, 8)
    with pytest.raises(ValueError, match="segment_ids"):
        packed_attn_fwd(q, k, v, seg.long(), 8)


def test_llama_item_tower_runs_the_packed_kernel(card):
    """A tiny packed item tower on the card launches the kernel once per
    layer and agrees with the same tower on the CPU (the plain version)."""
    import copy
    import dataclasses

    import numpy as np

    from mhrec_tpu_torch.models.llm.config import LLMConfig
    from mhrec_tpu_torch.models.llm.llama import LlamaBackbone
    from mhrec_tpu_torch.models.llm.packed import pack_items
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    cfg = dataclasses.replace(LLMConfig.tiny(), packed_window=33)
    cpu = LlamaBackbone(cfg, dtype=torch.float32)
    cpu.init_parameters(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(card)
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 33, size=40).astype(np.int32)
    tokens = np.zeros((40, 33), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, 1024, size=n)
    p = pack_items(tokens, lens, chunk=256, chunk_round=1)
    args = dict(input_ids=torch.from_numpy(p["packed_tokens"]).long(),
                position_ids=torch.from_numpy(p["packed_positions"]).long(),
                segment_ids=torch.from_numpy(p["packed_segment_ids"]))
    before = packed_attn_fwd.launches
    with torch.no_grad():
        out = gpu(**{k: v.to(card) for k, v in args.items()})
        torch.cuda.synchronize()
        ref = cpu(**args)
    assert packed_attn_fwd.launches == before + cfg.num_hidden_layers
    real = args["segment_ids"] > 0
    _close(out.cpu()[real], ref[real], torch.float32)


def _packed_bwd_inputs(C, S, H, Hkv, dh, w, dtype, card):
    q, k, v, seg = _packed_inputs(C, S, H, Hkv, dh, w, dtype, card)
    gen = torch.Generator().manual_seed(5)
    real = seg > 0
    dout = (torch.randn(q.shape, generator=gen).to(card) * real[..., None, None]).to(dtype)
    return q, k, v, seg, dout, real


@pytest.mark.parametrize("window", [True, False], ids=["band", "no_band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", ["corpus", "tiny"])
def test_packed_attn_bwd_kernel_matches_plain(card, shape, dtype, window):
    """dq, dk, dv against torch's autograd of the plain version on the float32
    values of the same inputs (the kernel keeps its sums in float32 and
    rounds once), zeros on padding rows and keys, and the same bits on a
    repeat."""
    from mhrec_tpu_torch.models.llm.packed import packed_attn_bwd_plain, packed_lse_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    C, S, H, Hkv, dh, w = {"corpus": (2, 2048, 32, 4, 64, 257),
                           "tiny": (3, 200, 4, 2, 16, 20)}[shape]
    q, k, v, seg, dout, real = _packed_bwd_inputs(C, S, H, Hkv, dh, w, dtype, card)
    w = w if window else None
    out, lse = packed_attn_fwd(q, k, v, seg, w, return_lse=True)
    torch.testing.assert_close(lse.transpose(1, 2)[real],
                               packed_lse_plain(q, k, seg, w).transpose(1, 2)[real],
                               atol=1e-5, rtol=1e-5)
    assert bool((lse.transpose(1, 2)[~real] == -float("inf")).all())
    before = packed_attn_bwd.launches
    grads = packed_attn_bwd(q, k, v, out, dout, lse, seg, w)
    again = packed_attn_bwd(q, k, v, out, dout, lse, seg, w)
    torch.cuda.synchronize()
    assert packed_attn_bwd.launches == before + 2
    ref = packed_attn_bwd_plain(*(x.float() for x in (q, k, v, dout)), seg, w)
    for name, g, r, x, a in zip(("dq", "dk", "dv"), grads, ref, (q, k, v), again):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert bool(torch.isfinite(g).all()) and torch.equal(g, a), name
        assert not bool(g[~real].any()), name
        _close(g, r, dtype)


# a tensor-parallel rank's heads (models/llm/llama.py LlamaAttention): (whole
# query heads, KV heads, head width, T, the rank); "kv_view": Qwen2-1.5B at
# T = 4, rank 2's 3 heads read a strided view of the second KV head;
# "kv_gather": 6 heads over 3 KV heads at T = 2, rank 0's heads read KV
# heads 0, 0, 1, gathered
TP_LAYOUTS = {"kv_view": (12, 2, 128, 4, 2), "kv_gather": (6, 3, 64, 2, 0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("layout", list(TP_LAYOUTS))
def test_packed_attn_kernels_on_tensor_parallel_heads(card, layout, dtype):
    """#8a and #8b/c on a rank's local query heads over the KV heads it
    passes them (a view of the whole projection's heads, or those heads
    gathered one per query head), against the plain versions on the same
    inputs."""
    from mhrec_tpu_torch.models.llm.packed import packed_attention_plain, packed_attn_bwd_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    H, Hkv, dh, T, m = TP_LAYOUTS[layout]
    w = 20
    q, k, v, seg, dout, real = _packed_bwd_inputs(3, 300, H, Hkv, dh, w, dtype, card)
    h0, h1 = m * H // T, (m + 1) * H // T
    need = [h // (H // Hkv) for h in range(h0, h1)]
    q, dout = q[:, :, h0:h1].contiguous(), dout[:, :, h0:h1].contiguous()
    if layout == "kv_view":
        k, v = k[:, :, need[0]:need[-1] + 1], v[:, :, need[0]:need[-1] + 1]
        assert not k.is_contiguous() and k.stride(1) == Hkv * dh
    else:
        idx = torch.tensor(need, device=card)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    before = (packed_attn_fwd.launches, packed_attn_bwd.launches)
    out, lse = packed_attn_fwd(q, k, v, seg, w, return_lse=True)
    grads = packed_attn_bwd(q, k, v, out, dout, lse, seg, w)
    torch.cuda.synchronize()
    assert (packed_attn_fwd.launches, packed_attn_bwd.launches) == (before[0] + 1, before[1] + 1)
    _close(out[real], packed_attention_plain(q, k, v, seg, w)[real], dtype)
    ref = packed_attn_bwd_plain(*(x.float() for x in (q, k, v, dout)), seg, w)
    for name, g, r, x in zip(("dq", "dk", "dv"), grads, ref, (q, k, v)):
        assert g.shape == x.shape and not bool(g[~real].any()), name
        _close(g, r, dtype)


def _edge_segments(C, S, window, seed):
    """Segment ids whose runs straddle the kernels' 64-row tile edges: from
    the start of each row, runs of 1, 63, 1, 1, 65, 2, 200 (longer than the
    band), 1 and 30 tokens, then random runs of 1..2·window tokens, then
    trailing padding; the last chunk row is all padding."""
    gen = torch.Generator().manual_seed(seed)
    seg = torch.zeros(C, S, dtype=torch.int32)
    sid = 0
    for c in range(C - 1):
        lens = [1, 63, 1, 1, 65, 2, 200, 1, 30]
        off, fill = 0, S - int(torch.randint(1, 40, (1,), generator=gen))
        while True:
            n = lens.pop(0) if lens else int(torch.randint(1, 2 * window + 1, (1,), generator=gen))
            if off + n > fill:
                break
            sid += 1
            seg[c, off:off + n] = sid
            off += n
    return seg

def _packed_layout(layout, C, S, H, Hkv, dh, dtype, card, gen):
    """q, k, v [C, S, ·, dh] as ``contiguous`` tensors, as ``fused`` strided
    views of one projection (token stride (H + 2·Hkv)·dh), or ``misaligned``:
    rows 8 bytes past a 16-byte boundary, which the wrappers copy."""
    if layout == "fused":
        proj = (0.5 * torch.randn(C, S, (H + 2 * Hkv) * dh, generator=gen)).to(card, dtype)
        q, k, v = (x.unflatten(-1, (-1, dh))
                   for x in proj.split([H * dh, Hkv * dh, Hkv * dh], dim=-1))
        assert q.stride(1) == (H + 2 * Hkv) * dh and not q.is_contiguous()
    elif layout == "misaligned":
        sizes = [C * S * H * dh, C * S * Hkv * dh, C * S * Hkv * dh]
        flat = (0.5 * torch.randn(sum(sizes) + 4, generator=gen)).to(card, dtype)[4:]
        q, k, v = (x.view(C, S, -1, dh) for x in flat.split(sizes))
        assert q.data_ptr() % 16 == 8
    else:
        q = (0.5 * torch.randn(C, S, H, dh, generator=gen)).to(card, dtype)
        k, v = ((0.5 * torch.randn(C, S, Hkv, dh, generator=gen)).to(card, dtype)
                for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("window", [70, None], ids=["band", "no_band"])
@pytest.mark.parametrize("layout", ["contiguous", "fused", "misaligned"])
@pytest.mark.parametrize("heads", [(4, 4), (16, 2)], ids=["mha", "gqa8"])
@pytest.mark.parametrize("dh", [32, 128])
def test_packed_attn_bwd_tensor_core_route(card, dh, heads, layout, window):
    """The bfloat16 route (tensor-core kernels) at the head widths and GQA
    ratios the main path does not take, on segments that straddle tile
    edges (1-token runs, a run longer than the band, a chunk row all
    padding, a ragged S): dq, dk, dv against torch's autograd of the plain
    version on the float32 values of the same inputs, zeros on padding rows
    and keys, the same bits on a repeat. ``fused``: q, k, v are strided
    views of one projection, token stride (H + 2·Hkv)·dh; ``misaligned``:
    their rows miss the 16-byte boundary the kernels' copies need."""
    from mhrec_tpu_torch.models.llm.packed import packed_attn_bwd_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    C, S, (H, Hkv), dtype = 3, 450, heads, torch.bfloat16
    seg = _edge_segments(C, S, 70, seed=dh + H).to(card)
    real = seg > 0
    gen = torch.Generator().manual_seed(6)
    q, k, v = _packed_layout(layout, C, S, H, Hkv, dh, dtype, card, gen)
    dout = (torch.randn(C, S, H, dh, generator=gen).to(card) * real[..., None, None]).to(dtype)
    out, lse = packed_attn_fwd(q, k, v, seg, window, return_lse=True)
    before = packed_attn_bwd.launches
    grads = packed_attn_bwd(q, k, v, out, dout, lse, seg, window)
    again = packed_attn_bwd(q, k, v, out, dout, lse, seg, window)
    torch.cuda.synchronize()
    assert packed_attn_bwd.launches == before + 2
    ref = packed_attn_bwd_plain(*(x.float() for x in (q, k, v, dout)), seg, window)
    for name, g, r, x, a in zip(("dq", "dk", "dv"), grads, ref, (q, k, v), again):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert bool(torch.isfinite(g).all()) and torch.equal(g, a), name
        assert not bool(g[~real].any()), name
        _close(g, r, dtype)




@pytest.mark.parametrize("window", [70, None], ids=["band", "no_band"])
@pytest.mark.parametrize("layout", ["contiguous", "fused", "misaligned"])
@pytest.mark.parametrize("heads", [(4, 4), (16, 2)], ids=["mha", "gqa8"])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_packed_attn_fwd_tensor_core_route(card, dh, heads, layout, window):
    """The bfloat16 forward (tensor-core kernel) at every head width the
    wrapper takes, on segments that straddle tile edges (1-token runs, a run
    longer than the band, a chunk row all padding, a ragged S): out and lse
    against the plain version on the float32 values of the same inputs,
    zeros and −inf on padding rows, the same bits on a repeat."""
    from mhrec_tpu_torch.models.llm.packed import packed_attention_plain, packed_lse_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    C, S, (H, Hkv), dtype = 3, 450, heads, torch.bfloat16
    seg = _edge_segments(C, S, 70, seed=dh + H).to(card)
    real = seg > 0
    q, k, v = _packed_layout(layout, C, S, H, Hkv, dh, dtype, card,
                             torch.Generator().manual_seed(7))
    before = packed_attn_fwd.launches
    out, lse = packed_attn_fwd(q, k, v, seg, window, return_lse=True)
    again, lse2 = packed_attn_fwd(q, k, v, seg, window, return_lse=True)
    torch.cuda.synchronize()
    assert packed_attn_fwd.launches == before + 2
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    qf, kf, vf = (x.float() for x in (q, k, v))
    _close(out[real], packed_attention_plain(qf, kf, vf, seg, window)[real], dtype)
    assert not bool(out[~real].any())
    lse = lse.transpose(1, 2)
    lse_ref = packed_lse_plain(qf, kf, seg, window).transpose(1, 2)
    torch.testing.assert_close(lse[real], lse_ref[real], atol=1e-5, rtol=1e-5)
    assert bool((lse[~real] == -float("inf")).all())


def test_packed_attn_fwd_tensor_core_window_zero(card):
    """Window 0 keeps the diagonal alone: each real row's output is its own
    value row (through the bf16 probability 1), as the plain version."""
    from mhrec_tpu_torch.models.llm.packed import packed_attention_plain
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_fwd

    seg = _edge_segments(2, 300, 70, seed=3).to(card)
    q, k, v = _packed_layout("contiguous", 2, 300, 8, 2, 64, torch.bfloat16, card,
                             torch.Generator().manual_seed(8))
    out = packed_attn_fwd(q, k, v, seg, 0)
    real = seg > 0
    ref = packed_attention_plain(q, k, v, seg, 0)
    assert torch.equal(out[real], ref[real])
    assert torch.equal(out[real], v.repeat_interleave(4, dim=2)[real])
    assert not bool(out[~real].any())


GATED_TC_SHAPES = {"size4": (4, 50, 16, 64), "merrec": (2, 400, 8, 64),
                   "f2048": (2, 50, 32, 64), "size1": (3, 50, 4, 32), "d128": (2, 70, 8, 128)}


@pytest.mark.parametrize("layout", ["uvqk", "misaligned"])
@pytest.mark.parametrize("shape", list(GATED_TC_SHAPES))
def test_stu_gated_fwd_tensor_core_route(card, shape, layout):
    """The bfloat16 fused STU forward (tensor-core kernel) at the size4,
    merrec, hstu-1b (F = 2048) and size1 widths and at head width 128: q,
    k, v, u as the strided splits of the uvqk projection (no copy) or
    misaligned by 8 bytes (the wrapper copies), batch row 1 all padding;
    against the plain version within TOL, the same bits on a repeat."""
    B, L, H, d = GATED_TC_SHAPES[shape]
    dtype = torch.bfloat16
    assert K.stu_gated_fwd_route(dtype, L, H, d, d) == "tensor_cores"
    q, k, v, u, gamma, beta, nonpad, _ = _gated_inputs(B, L, H, d, dtype, card, seed=d + H)
    nonpad[1] = False
    if layout == "misaligned":
        F = H * d
        flat = torch.empty(4 * B * L * F + 4, dtype=dtype, device=card)[4:]
        q, k, v, u = (x.copy_(y) for x, y in zip(
            (t.view(B, L, F) for t in flat.split(B * L * F)), (q, k, v, u)))
        assert q.data_ptr() % 16 == 8
    before = K.hstu_stu_gated_fwd.launches
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    again = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    torch.cuda.synchronize()
    assert K.hstu_stu_gated_fwd.launches == before + 2
    assert out.dtype == dtype and out.shape == (B, L, H * d) and torch.equal(out, again)
    _close(out, K.hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, H), dtype)


def test_stu_gated_fwd_tensor_core_unequal_widths(card):
    """q/k heads of 32 and v/u heads of 64 (the splits of one projection, as
    an STU layer with attention_dim 32 and linear_dim 64 makes them) on the
    tensor-core route: its tiles are laid out for 64 with q/k zero past 32."""
    B, L, H, dqk, dv = 3, 70, 8, 32, 64
    assert K.stu_gated_fwd_route(torch.bfloat16, L, H, dqk, dv) == "tensor_cores"
    gen = torch.Generator().manual_seed(9)
    F, Fq = H * dv, H * dqk
    mixed = (0.5 * torch.randn(B, L, 2 * F + 2 * Fq, generator=gen)).to(card, torch.bfloat16)
    u, v, q, k = torch.split(mixed, [F, F, Fq, Fq], dim=-1)
    gamma = (1 + 0.1 * torch.randn(F, generator=gen)).to(card)
    beta = (0.05 * torch.randn(F, generator=gen)).to(card)
    nonpad = _nonpad(B, L, gen, card)
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    assert out.shape == (B, L, F)
    _close(out, K.hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, H), torch.bfloat16)


def test_stu_gated_fwd_cuda_core_widths(card):
    """bfloat16 at a head width the 16-byte copies cannot take runs the
    CUDA-core kernel, and agrees with the plain version as well."""
    B, L, H, d = 3, 40, 4, 12
    assert K.stu_gated_fwd_route(torch.bfloat16, L, H, d, d) == "cuda_cores"
    q, k, v, u, gamma, beta, nonpad, _ = _gated_inputs(B, L, H, d, torch.bfloat16, card)
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    _close(out, K.hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, H), torch.bfloat16)


@pytest.mark.parametrize("kind,k", [("neg_inf", 4), ("ties", 3), ("ties", 5)])
def test_topk_first_breaks_ties_by_lower_position_past_2_24(card, kind, k):
    """On the card, where ``torch.topk`` breaks ties in no set order, a row
    of 2^24 + 1024 positions: the k largest, ties to the lower position (a
    stable descending sort, the order of ``jax.lax.top_k``)."""
    import numpy as np

    from mhrec_tpu_torch.trainer.trainer import topk_first

    n = 2**24 + 1024
    x = np.full(n, -np.inf, np.float32)
    if kind == "ties":
        x[[2**24 + 3, 2**24 + 900]] = 2.0
        x[[0, 1, 2, 5, 2**24 + 1, 2**24 + 7]] = 1.0
    ref = np.argsort(-x, kind="stable")[:k]
    vals, pos = topk_first(torch.from_numpy(x[None]).to(card), k)
    assert pos.cpu().numpy()[0].tolist() == ref.tolist()
    assert vals.cpu().numpy()[0].tolist() == x[ref].tolist()


def test_packed_attention_autograd_under_checkpoint(card):
    """``PackedAttention`` under non-reentrant checkpointing: the forward
    kernel runs twice (the forward and its recompute), the backward kernel
    once, and the gradients are those of one direct backward call."""
    from torch.utils.checkpoint import checkpoint

    from mhrec_tpu_torch.models.llm.packed import packed_attention
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    q, k, v, seg, dout, _ = _packed_bwd_inputs(3, 200, 4, 2, 16, 20, torch.float32, card)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    before = (packed_attn_fwd.launches, packed_attn_bwd.launches)
    out = checkpoint(packed_attention, *leaves, seg, 20, use_reentrant=False)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (packed_attn_fwd.launches, packed_attn_bwd.launches) == (before[0] + 2, before[1] + 1)
    o, lse = packed_attn_fwd(q, k, v, seg, 20, return_lse=True)
    for leaf, want in zip(leaves, packed_attn_bwd(q, k, v, o, dout, lse, seg, 20)):
        torch.testing.assert_close(leaf.grad, want, atol=0, rtol=0)


def test_llama_item_tower_trains_through_the_packed_kernels(card):
    """A tiny packed item tower with gradient checkpointing on the card:
    per layer two forward launches and one backward, and the gradients of
    every parameter agree with the same tower on the CPU (the plain
    version under torch's autograd)."""
    import copy
    import dataclasses

    import numpy as np

    from mhrec_tpu_torch.models.llm.config import LLMConfig
    from mhrec_tpu_torch.models.llm.llama import LlamaBackbone
    from mhrec_tpu_torch.models.llm.packed import pack_items
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    cfg = dataclasses.replace(LLMConfig.tiny(), packed_window=33)
    cpu = LlamaBackbone(cfg, dtype=torch.float32, gradient_checkpointing=True)
    cpu.init_parameters(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(card)
    rng = np.random.default_rng(1)
    lens = rng.integers(1, 33, size=40).astype(np.int32)
    tokens = np.zeros((40, 33), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, 1024, size=n)
    p = pack_items(tokens, lens, chunk=256, chunk_round=1)
    args = dict(input_ids=torch.from_numpy(p["packed_tokens"]).long(),
                position_ids=torch.from_numpy(p["packed_positions"]).long(),
                segment_ids=torch.from_numpy(p["packed_segment_ids"]))
    real = args["segment_ids"] > 0
    cot = torch.randn(*real.shape, cfg.hidden_size, generator=torch.Generator().manual_seed(2))
    cot = cot * real[..., None]
    before = (packed_attn_fwd.launches, packed_attn_bwd.launches)
    gpu(**{k: v.to(card) for k, v in args.items()}).backward(cot.to(card))
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert (packed_attn_fwd.launches, packed_attn_bwd.launches) == (before[0] + 2 * L,
                                                                    before[1] + L)
    cpu(**args).backward(cot)
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        err = float((a.grad.cpu() - b.grad).norm() / b.grad.norm().clamp_min(1e-30))
        assert err <= 1e-4, (name, err)


def test_packed_attn_bwd_refuses_what_it_cannot_take(card):
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    q, k, v, seg, dout, _ = _packed_bwd_inputs(1, 64, 4, 2, 16, 8, torch.float32, card)
    out, lse = packed_attn_fwd(q, k, v, seg, 8, return_lse=True)
    with pytest.raises(ValueError, match="dout must be"):
        packed_attn_bwd(q, k, v, out, dout.cpu(), lse, seg, 8)
    with pytest.raises(ValueError, match="lse must be"):
        packed_attn_bwd(q, k, v, out, dout, lse.cpu(), seg, 8)
    with pytest.raises(ValueError, match="segment_ids"):
        packed_attn_bwd(q, k, v, out, dout, lse, seg.long(), 8)
    with pytest.raises(ValueError, match="contiguous heads"):
        packed_attn_bwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, out, dout, lse,
                        seg, 8)


# window lengths around the one-block window (64) and its two-pass
# continuation, the widths of size1 / size4 / merrec / hstu-1b and 128
BWD_TC_SHAPES = {"L1": (3, 1, 4, 64), "L16": (3, 16, 4, 64), "size4": (4, 50, 16, 64),
                 "L64": (3, 64, 4, 64), "L65": (3, 65, 4, 64), "merrec": (2, 400, 8, 64),
                 "d32": (3, 50, 4, 32), "d128": (2, 70, 8, 128), "f2048": (2, 50, 32, 64)}


def _misaligned(tensors, dtype, card):
    """Copies of ``tensors`` (same shapes, contiguous) in one buffer that
    starts 8 bytes past a 16-byte boundary, so every copy does too."""
    n = sum(t.numel() for t in tensors)
    flat = torch.empty(n + 4, dtype=dtype, device=card)[4:]
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).copy_(t))
        at += t.numel()
    assert out[0].data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize("layout", ["uvqk", "misaligned"])
@pytest.mark.parametrize("shape", list(BWD_TC_SHAPES))
def test_stu_gated_bwd_tensor_core_route(card, shape, layout):
    """The bfloat16 fused STU backward (tensor-core recompute and attention
    backward): q, k, v, u as the strided splits of the uvqk projection (no
    copy) or misaligned by 8 bytes (the wrapper copies), batch row 1 all
    padding (zero dq, dk, dv there); against the plain version within TOL,
    the same bits on a repeat."""
    B, L, H, d = BWD_TC_SHAPES[shape]
    dtype = torch.bfloat16
    assert K.stu_gated_bwd_route(dtype, L, H, d, d) == "tensor_cores"
    q, k, v, u, gamma, beta, nonpad, g = _gated_inputs(B, L, H, d, dtype, card, seed=d + H + L)
    nonpad[1] = False
    if layout == "misaligned":
        q, k, v, u, g = _misaligned((q, k, v, u, g), dtype, card)
    before = K.hstu_stu_gated_bwd.launches
    out = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H)
    again = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H)
    torch.cuda.synchronize()
    assert K.hstu_stu_gated_bwd.launches == before + 2
    ref = K.hstu_stu_gated_bwd_plain(q, k, v, u, gamma, beta, nonpad, g, H)
    for name, o, a, r in zip(("dq", "dk", "dv", "du", "dgamma", "dbeta"), out, again, ref):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.equal(o, a), name
        _close(o, r, dtype)
    for o in out[:3]:
        assert not bool(o[1].any())


def test_stu_gated_bwd_tensor_core_unequal_widths(card):
    """q/k heads of 32 and v/u heads of 64 on the tensor-core backward, over
    a window past 64 rows."""
    B, L, H, dqk, dv = 3, 70, 8, 32, 64
    assert K.stu_gated_bwd_route(torch.bfloat16, L, H, dqk, dv) == "tensor_cores"
    gen = torch.Generator().manual_seed(9)
    F, Fq = H * dv, H * dqk
    mixed = (0.5 * torch.randn(B, L, 2 * F + 2 * Fq, generator=gen)).to(card, torch.bfloat16)
    u, v, q, k = torch.split(mixed, [F, F, Fq, Fq], dim=-1)
    gamma = (1 + 0.1 * torch.randn(F, generator=gen)).to(card)
    beta = (0.05 * torch.randn(F, generator=gen)).to(card)
    g = torch.randn(B, L, F, generator=gen).to(card, torch.bfloat16)
    nonpad = _nonpad(B, L, gen, card)
    out = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H)
    ref = K.hstu_stu_gated_bwd_plain(q, k, v, u, gamma, beta, nonpad, g, H)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        _close(o, r, torch.bfloat16)


def _attn_bwd_inputs(B, L, H, dqk, dv, card, seed):
    """q, k [B, L, H, dqk], v, g [B, L, H, dv] viewed head-major (strided,
    no copy), and nonpad with batch row 1 all padding."""
    gen = torch.Generator().manual_seed(seed)
    q, k = ((0.5 * torch.randn(B, L, H, dqk, generator=gen)).to(card, torch.bfloat16)
            for _ in range(2))
    v, g = ((0.5 * torch.randn(B, L, H, dv, generator=gen)).to(card, torch.bfloat16)
            for _ in range(2))
    nonpad = _nonpad(B, L, gen, card)
    nonpad[1] = False
    return [x.transpose(1, 2) for x in (q, k, v, g)], nonpad


@pytest.mark.parametrize("layout", ["blhd", "misaligned"])
@pytest.mark.parametrize("shape", list(BWD_TC_SHAPES))
def test_attn_bwd_tensor_core_route(card, shape, layout):
    """The bfloat16 pointwise attention backward on the tensor cores: inputs
    as head-major views of [B, L, H, d] (strided, no copy) or contiguous and
    misaligned by 8 bytes (the wrapper copies); zero gradients on the
    all-padding batch row; against the plain version within TOL, the same
    bits on a repeat."""
    B, L, H, d = BWD_TC_SHAPES[shape]
    assert K.attn_bwd_route(torch.bfloat16, L, d, d) == "tensor_cores"
    args, nonpad = _attn_bwd_inputs(B, L, H, d, d, card, seed=d + L)
    if layout == "misaligned":
        args = _misaligned([x.contiguous() for x in args], torch.bfloat16, card)
    before = K.hstu_attn_bwd.launches
    out = K.hstu_attn_bwd(*args, nonpad)
    again = K.hstu_attn_bwd(*args, nonpad)
    torch.cuda.synchronize()
    assert K.hstu_attn_bwd.launches == before + 2
    for name, o, a, r in zip(("dq", "dk", "dv"), out, again, K.hstu_attn_bwd_plain(*args, nonpad)):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape, name
        assert torch.equal(o, a), name
        assert not bool(o[1].any()), name
        _close(o, r, torch.bfloat16)


@pytest.mark.parametrize("L", [50, 130])
def test_attn_bwd_tensor_core_unequal_widths(card, L):
    """q/k heads of 32 and v heads of 64, in one block (L = 50) and in two
    passes (L = 130)."""
    args, nonpad = _attn_bwd_inputs(3, L, 4, 32, 64, card, seed=L)
    assert K.attn_bwd_route(torch.bfloat16, L, 32, 64) == "tensor_cores"
    for o, r in zip(K.hstu_attn_bwd(*args, nonpad), K.hstu_attn_bwd_plain(*args, nonpad)):
        assert o.shape == r.shape
        _close(o, r, torch.bfloat16)


@pytest.mark.parametrize("L", [50, 100])
def test_attn_bwd_tensor_core_route_bhld(card, L):
    """[B·H, L, d] through ``hstu_attention_bhld`` and autograd: one launch
    of the tensor-core backward, gradients as the plain version's."""
    B, H, d = 2, 4, 64
    (q, k, v, g), nonpad = _attn_bwd_inputs(B, L, H, d, d, card, seed=7)
    flat = [x.reshape(B * H, L, d).detach().requires_grad_(True) for x in (q, k, v)]
    rows = nonpad.repeat_interleave(H, dim=0)
    before = K.hstu_attn_bwd.launches
    K.hstu_attention_bhld(*flat, rows).backward(g.reshape(B * H, L, d))
    torch.cuda.synchronize()
    assert K.hstu_attn_bwd.launches == before + 1
    ref = K.hstu_attn_bwd_plain(*(x.detach()[:, None] for x in flat), g.reshape(B * H, 1, L, d),
                                rows)
    for x, r in zip(flat, ref):
        _close(x.grad, r[:, 0], torch.bfloat16)


def test_backward_kernels_cuda_core_route_on_request(card):
    """``route="cuda_cores"`` runs the CUDA-core kernels on bfloat16 (as
    ``chip_smoke.py`` times them beside the tensor cores), and they agree
    with the plain versions too; float32 refuses the tensor cores."""
    B, L, H, d = 3, 50, 4, 64
    q, k, v, u, gamma, beta, nonpad, g = _gated_inputs(B, L, H, d, torch.bfloat16, card)
    args = (q, k, v, u, gamma, beta, nonpad, g, H)
    for o, r in zip(K.hstu_stu_gated_bwd(*args, route="cuda_cores"),
                    K.hstu_stu_gated_bwd_plain(*args)):
        _close(o, r, torch.bfloat16)
    heads, nonpad = _attn_bwd_inputs(B, L, H, d, d, card, seed=3)
    for o, r in zip(K.hstu_attn_bwd(*heads, nonpad, route="cuda_cores"),
                    K.hstu_attn_bwd_plain(*heads, nonpad)):
        _close(o, r, torch.bfloat16)
    with pytest.raises(ValueError, match="tensor-core route"):
        K.hstu_attn_bwd(*(x.float() for x in heads), nonpad, route="tensor_cores")


@pytest.mark.parametrize("layout", ["blhd", "misaligned"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 130, 400])
def test_attn_fwd_tensor_core_route(card, L, d, layout):
    """The bfloat16 pointwise attention forward on the tensor cores, in one
    block a head (L <= 64) and over 64-row query tiles (L > 64), at every
    padded width: inputs as head-major views of [B, L, H, d] (strided, no
    copy) or contiguous and misaligned by 8 bytes (the wrapper copies);
    zeros on the all-padding batch row; against the plain version within
    TOL (atol relative to the reference's scale), the same bits on a
    repeat."""
    assert K.attn_fwd_route(torch.bfloat16, L, d, d) == "tensor_cores"
    (q, k, v, _), nonpad = _attn_bwd_inputs(3, L, 4, d, d, card, seed=d + L)
    args = [q, k, v]
    if layout == "misaligned":
        args = _misaligned([x.contiguous() for x in args], torch.bfloat16, card)
    before = K.hstu_attn_fwd.launches
    with torch.no_grad():
        out = K.hstu_attn_fwd(*args, nonpad)
        again = K.hstu_attn_fwd(*args, nonpad)
    torch.cuda.synchronize()
    assert K.hstu_attn_fwd.launches == before + 2
    ref = K.hstu_attn_fwd_plain(*args, nonpad)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (3, 4, L, d)
    assert torch.equal(out, again)
    assert not bool(out[1].any())
    _close_to_scale(out, ref, torch.bfloat16)


@pytest.mark.parametrize("L", [50, 130])
def test_attn_fwd_tensor_core_unequal_widths(card, L):
    """q/k heads of 32 and v heads of 64, in one block (L = 50) and over
    query tiles (L = 130)."""
    (q, k, v, _), nonpad = _attn_bwd_inputs(3, L, 4, 32, 64, card, seed=L + 1)
    assert K.attn_fwd_route(torch.bfloat16, L, 32, 64) == "tensor_cores"
    with torch.no_grad():
        out = K.hstu_attn_fwd(q, k, v, nonpad)
    ref = K.hstu_attn_fwd_plain(q, k, v, nonpad)
    assert out.shape == ref.shape == (3, 4, L, 64)
    _close_to_scale(out, ref, torch.bfloat16)


@pytest.mark.parametrize("wrapper", ["v2", "bhld"])
@pytest.mark.parametrize("L", [50, 100])
def test_attn_fwd_tensor_core_route_through_the_layout_wrappers(card, wrapper, L):
    """``hstu_attention_v2`` ([B, L, H, d]) and ``hstu_attention_bhld``
    ([B·H, L, d]) forward and autograd backward in bfloat16: one launch of
    the forward and one of the backward, each the same bits as its
    tensor-core route called directly, and within TOL of the plain
    versions (atol relative to the reference's scale)."""
    B, H, d = 2, 4, 64
    (q, k, v, g), nonpad = _attn_bwd_inputs(B, L, H, d, d, card, seed=5)
    if wrapper == "v2":
        leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
        rows, g_in = nonpad, g.transpose(1, 2)
        fn, heads = K.hstu_attention_v2, (lambda t: t.transpose(1, 2))
    else:
        leaves = [x.reshape(B * H, L, d).detach().requires_grad_(True) for x in (q, k, v)]
        rows, g_in = nonpad.repeat_interleave(H, dim=0), g.reshape(B * H, L, d)
        fn, heads = K.hstu_attention_bhld, (lambda t: t[:, None])
    before = (K.hstu_attn_fwd.launches, K.hstu_attn_bwd.launches)
    out = fn(*leaves, rows)
    out.backward(g_in)
    torch.cuda.synchronize()
    assert (K.hstu_attn_fwd.launches, K.hstu_attn_bwd.launches) == (before[0] + 1, before[1] + 1)
    x = [heads(t.detach()) for t in leaves]
    with torch.no_grad():
        direct = K.hstu_attn_fwd(*x, rows, route="tensor_cores")
        grads = K.hstu_attn_bwd(*x, heads(g_in), rows, route="tensor_cores")
    assert torch.equal(heads(out.detach()), direct)
    _close_to_scale(heads(out.detach()), K.hstu_attn_fwd_plain(*x, rows), torch.bfloat16)
    for leaf, gd, r in zip(leaves, grads, K.hstu_attn_bwd_plain(*x, heads(g_in), rows)):
        assert torch.equal(heads(leaf.grad), gd)
        _close_to_scale(heads(leaf.grad), r, torch.bfloat16)


def test_attn_fwd_cuda_core_route_on_request(card):
    """``route="cuda_cores"`` runs the CUDA-core kernel on bfloat16 (as
    ``chip_smoke.py`` times it beside the tensor cores), and it agrees with
    the plain version too; float32 refuses the tensor cores."""
    for L in (50, 130):
        (q, k, v, _), nonpad = _attn_bwd_inputs(3, L, 4, 64, 64, card, seed=L + 2)
        before = K.hstu_attn_fwd.launches
        with torch.no_grad():
            out = K.hstu_attn_fwd(q, k, v, nonpad, route="cuda_cores")
        assert K.hstu_attn_fwd.launches == before + 1
        _close_to_scale(out, K.hstu_attn_fwd_plain(q, k, v, nonpad), torch.bfloat16)
        with pytest.raises(ValueError, match="tensor-core route"):
            K.hstu_attn_fwd(q.float(), k.float(), v.float(), nonpad, route="tensor_cores")


@pytest.mark.parametrize("k", [2, 8])
def test_accumulated_row_update_equals_plain_bit_for_bit(card, k):
    """``accumulate_grad`` k: k blocks of unique ids (shared across blocks,
    −1 pads) merged by ``dedup_touched_rows`` on the card — the same ids and
    sums, bit for bit, as on the CPU, every real id once — then one row
    update through ``row_adamw`` against the plain version on that union."""
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer.sparse_adam import (
        SparseAdamConfig,
        dedup_touched_rows,
        sparse_adamw_row_update,
    )

    gen = torch.Generator().manual_seed(k)
    N, U, D, n_real = 4000, 1024, 256, 900
    ids = torch.full((k, U), -1, dtype=torch.long)
    for j in range(k):
        ids[j, :n_real] = torch.randperm(N // 2, generator=gen)[:n_real]
    g = torch.randn(k, U, D, generator=gen) / k
    ids_u, g_u = dedup_touched_rows(ids.to(card), g.to(card))
    ref_ids, ref_g = dedup_touched_rows(ids, g)
    assert torch.equal(ids_u.cpu(), ref_ids) and torch.equal(g_u.cpu(), ref_g)
    real = ref_ids[ref_ids >= 0]
    assert real.unique().numel() == real.numel() == ids[ids >= 0].unique().numel()
    table = torch.randn(N, D, generator=gen)
    m = 0.01 * torch.randn(N, D, generator=gen)
    v = 0.01 * torch.randn(N, D, generator=gen).abs()
    cfg = SparseAdamConfig(weight_decay=0.01)
    out = [t.to(card) for t in (table, m, v)]
    ref = [t.to(card) for t in (table, m, v)]
    before = row_adamw.launches
    row_adamw(*out, ids_u, g_u, 1e-3, 3, cfg)
    sparse_adamw_row_update(*ref, ids_u, g_u, 1e-3, 3, cfg)
    torch.cuda.synchronize()
    assert row_adamw.launches == before + 1
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    untouched = torch.ones(N, dtype=torch.bool)
    untouched[real] = False
    assert torch.equal(out[0].cpu()[untouched], table[untouched])


def test_host_table_side_stream_copies_match_synchronous(card, tmp_path):
    """The host-memory corpus table: chunks copied on a side stream (the
    scoring stream waiting on each copy's event) give the same top-k,
    bit for bit, as chunks copied on the scoring stream, and as the table
    held on the card; 6 item chunks, one table pass per eval batch."""
    import json

    import numpy as np

    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import build_eval_dataloaders
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.trainer import Trainer

    with open(tmp_path / "config.json", "w") as fh:
        json.dump({"model_type": "llama", "vocab_size": 1024, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2}, fh)
    C = 4
    cfg = Config(config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"], config_dict=dict(
        dataset="synthetic", seed=0, data_path=str(tmp_path),
        checkpoint_dir=str(tmp_path / "ckpt"), item_pretrain_dir=str(tmp_path),
        user_pretrain_dir=str(tmp_path), MAX_TEXT_LENGTH=24, MAX_ITEM_LIST_LENGTH=6,
        loss="prior", train_batch_size=8, eval_batch_size=32, num_prior_head=C,
        num_segment_head=2, head_interaction="hierarchical", medusa_num_layers=1,
        eval_num_cats=C, pred_len=4, eval_pred_len=4, topk=[5, 10], segment_embed=True,
        eval_item_chunk_size=512, host_eval_group_size=1, val_only=True,
        int_to_category={i: f"cat_{i}" for i in range(C)})).finalize()
    data = InMemoryInteractionData(num_users=100, num_items=3000, seq_len=2 * 6 + 8,
                                   num_categories=C, eval_pred_len=4, max_item_list_length=6)
    trainer = Trainer(cfg, data)
    trainer.setup_model()
    test = build_eval_dataloaders(cfg, data)[1]
    raw = torch.randn(3000, 64, generator=torch.Generator().manual_seed(0))
    norm = trainer.normalize_host_table(raw)
    assert norm.is_pinned()
    tags = torch.as_tensor(data.item_tag_matrix, device=card)
    runs = [list(trainer._host_table_topk_results(test, raw, norm, tags, 10, overlap=o))
            for o in (True, False)]
    assert trainer.host_table_stats["groups"] == 4 and trainer.host_table_stats["chunks"] == 24
    runs.append(list(trainer._device_topk_results(test, norm.to(card), tags, 10,
                                                  raw_item_table=raw.to(card))))
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(a[2], b[2])
    for a, b in zip(runs[0], runs[2]):
        np.testing.assert_array_equal(a[3], b[3])


# -- HLLM towers from local checkpoints and the HLLM training levers ---------
def _tiny_tower_config(**over):
    import dataclasses

    from mhrec_tpu_torch.models.llm.config import LLMConfig

    return dataclasses.replace(LLMConfig.tiny(vocab_size=512, hidden_size=128),
                               num_attention_heads=2, num_key_value_heads=1, **over)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_tower_loads_onto_the_card_bit_for_bit(card, tmp_path, fmt):
    """A bfloat16 checkpoint written by chip_smoke.py's writer, loaded into
    a tower on the card: every parameter equals the written tensor."""
    import json

    import chip_smoke
    from mhrec_tpu_torch.models.hllm.hllm import load_tower_weights
    from mhrec_tpu_torch.models.llm.config import LLMConfig
    from mhrec_tpu_torch.models.llm.llama import LlamaBackbone

    hf = dict(chip_smoke.TINYLLAMA_1B, vocab_size=512, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    sd = chip_smoke.hf_state_dict(hf, seed=3, device=card, dtype=torch.bfloat16)
    chip_smoke.write_hf_checkpoint(str(tmp_path), hf, sd, fmt=fmt, shards=2)
    with open(tmp_path / "config.json") as fh:
        assert json.load(fh)["hidden_size"] == 128
    tower = LlamaBackbone(LLMConfig.from_pretrained_dir(str(tmp_path))).to(card)
    stats = load_tower_weights(tower, str(tmp_path))
    assert stats["bytes"] > 0
    equal, n = True, 0
    for name, p in tower.named_parameters():
        hf_name = "model." + name
        equal &= torch.equal(p, sd[hf_name].float())
        n += 1
    assert equal and n == 2 + 9 * 2


@pytest.mark.parametrize("alibi", [False, True], ids=["rope", "alibi"])
def test_tower_on_the_card_matches_the_cpu(card, alibi):
    """The dense tower (RoPE or ALiBi) in float32 on the card against the
    same weights on the CPU."""
    from mhrec_tpu_torch.models.llm.llama import LlamaBackbone

    cfg = _tiny_tower_config(alibi=alibi)
    cpu = LlamaBackbone(cfg, dtype=torch.float32)
    cpu.init_parameters(torch.Generator().manual_seed(1))
    gpu = LlamaBackbone(cfg, dtype=torch.float32).to(card)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(1, 512, (4, 33), generator=torch.Generator().manual_seed(2))
    mask = (torch.arange(33)[None] < torch.tensor([[33], [20], [5], [1]])).int()
    with torch.no_grad():
        ref = cpu(input_ids=ids, attention_mask=mask)
        out = gpu(input_ids=ids.to(card), attention_mask=mask.to(card)).cpu()
    keep = mask.bool()
    torch.testing.assert_close(out[keep], ref[keep], atol=1e-4, rtol=1e-4)


def test_bert_tower_on_the_card_matches_the_cpu(card):
    from mhrec_tpu_torch.models.llm.bert import BertBackbone
    from mhrec_tpu_torch.models.llm.config import LLMConfig

    cfg = LLMConfig(model_type="bert", vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                    max_position_embeddings=64, rms_norm_eps=1e-12)
    cpu = BertBackbone(cfg, dtype=torch.float32)
    cpu.init_parameters(torch.Generator().manual_seed(1))
    gpu = BertBackbone(cfg, dtype=torch.float32).to(card)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(1, 512, (3, 40), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = cpu(input_ids=ids)
        out = gpu(input_ids=ids.to(card)).cpu()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_remat_dots_on_the_packed_kernels(card, dtype):
    """``remat_policy: dots`` through the packed kernels: the gradients of
    ``full`` (bit for bit: the kept products are the ones the recompute
    would make), and the forward kernel launched twice a layer under both
    (its recompute is not kept)."""
    from mhrec_tpu_torch.models.llm.llama import LlamaBackbone
    from mhrec_tpu_torch.models.llm.packed import pack_items
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd

    cfg = _tiny_tower_config(packed_window=33)
    model = LlamaBackbone(cfg, dtype=dtype, gradient_checkpointing=True).to(card)
    model.init_parameters(torch.Generator(device=card).manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    lens = torch.randint(1, 32, (40,), generator=gen).numpy()
    tokens = torch.randint(1, 512, (40, 33), generator=gen).numpy()
    p = pack_items(tokens, lens, n_emb=1, chunk=256, chunk_round=1)
    ids = torch.as_tensor(p["packed_tokens"], dtype=torch.long, device=card)
    seg = torch.as_tensor(p["packed_segment_ids"], device=card)
    pos = torch.as_tensor(p["packed_positions"], dtype=torch.long, device=card)
    grads, launches = {}, {}
    for pol in ("full", "dots"):
        model.remat_policy = pol
        model.zero_grad(set_to_none=True)
        packed_attn_fwd.launches = packed_attn_bwd.launches = 0
        out = model(input_ids=ids, position_ids=pos, segment_ids=seg)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        launches[pol] = (packed_attn_fwd.launches, packed_attn_bwd.launches)
        grads[pol] = {n: q.grad.clone() for n, q in model.named_parameters()}
    assert launches["full"] == launches["dots"] == (4, 2)
    for n, g in grads["full"].items():
        assert torch.equal(grads["dots"][n], g), n


def test_adamw_cast_on_the_card_matches_the_cpu(card, monkeypatch):
    """bfloat16 moments: the optimizer on the card against the CPU, 3 steps
    of the same float32 arithmetic. The card's and the host's elementwise
    kernels may round the update a few float32 ulps apart (2.5 ulps of a
    1e-3 update on 1 of 21,000 elements on an H100 80GB HBM3 at 700 W), so
    the parameters get
    atol 1e-9 (1e-6 of the learning rate) beside rtol 1e-6, and the stored
    moments one bfloat16 ulp."""
    from mhrec_tpu_torch.trainer import optim

    monkeypatch.setattr(optim, "BUCKET_NUMEL", 1000)  # several buckets per step
    gen = torch.Generator().manual_seed(6)
    values = [torch.randn(300, 70, generator=gen), torch.randn(513, generator=gen)]
    grads = [[torch.randn(v.shape, generator=gen) * 1e-3 for v in values] for _ in range(3)]
    out = {}
    for dev in ("cpu", card):
        params = [torch.nn.Parameter(v.clone().to(dev)) for v in values]
        opt = optim.AdamWCast(params, lr=1e-3, weight_decay=0.01, mu_dtype=torch.bfloat16,
                              nu_dtype=torch.bfloat16)
        for g in grads:
            for p, x in zip(params, g):
                p.grad = x.to(dev)
            opt.step()
        out[str(dev)] = ([p.detach().cpu() for p in params],
                         [opt.state[p]["exp_avg"].cpu() for p in params])
    (pc, mc), (pg, mg) = out["cpu"], out[str(card)]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, atol=1e-9, rtol=1e-6)
    for a, b in zip(mc, mg):
        ulp = 2.0 ** (torch.floor(torch.log2(a.float().abs().clamp(min=2.0 ** -126))) - 7)
        assert b.dtype == torch.bfloat16 and bool(((b.float() - a.float()).abs() <= ulp).all())


def test_async_checkpoint_of_card_tensors(card, tmp_path):
    """A payload on the card copied to host memory, written by the writer
    thread while the card tensors change, read back equal to the copy."""
    from mhrec_tpu_torch.trainer import checkpoint as ckpt_io

    state = {"w": torch.randn(1000, 512, device=card), "step": 3,
             "opt": {"m": torch.randn(77, device=card).bfloat16()}}
    want = {"w": state["w"].cpu(), "m": state["opt"]["m"].cpu()}
    payload, nbytes = ckpt_io.host_copy(state)
    assert nbytes == 1000 * 512 * 4 + 77 * 2 and payload["w"].device.type == "cpu"
    path = str(tmp_path / "checkpoint.pt")
    stats = {}
    ckpt_io.start_write(path, payload, stats)
    state["w"].add_(1.0)
    ckpt_io.wait_for_write(path)
    back = torch.load(path, weights_only=True)
    assert torch.equal(back["w"], want["w"]) and torch.equal(back["opt"]["m"], want["m"])
    assert stats["bytes"] == os.path.getsize(path) and back["step"] == 3


def test_stu_gated_fwd_at_the_1b_serving_width(card):
    """#1 at hstu-1b's serving shape (F = 2048, 32 heads of 64, window 50;
    256 of an eval batch's 1024 rows), on its tensor-core route, against
    the plain version within TOL."""
    B, L, H, d = 256, 50, 32, 64
    dtype = torch.bfloat16
    assert K.stu_gated_fwd_route(dtype, L, H, d, d) == "tensor_cores"
    q, k, v, u, gamma, beta, nonpad, _ = _gated_inputs(B, L, H, d, dtype, card, seed=12)
    before = K.hstu_stu_gated_fwd.launches
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    torch.cuda.synchronize()
    assert K.hstu_stu_gated_fwd.launches == before + 1
    _close(out, K.hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, H), dtype)


def _bf16_row_inputs(device, N=3000, D=256, U=2048, n_real=1500, seed=0):
    gen = torch.Generator().manual_seed(seed)
    table = (0.05 * torch.randn(N, D, generator=gen)).to(torch.bfloat16)
    m = 0.01 * torch.randn(N, D, generator=gen)
    v = 0.01 * torch.rand(N, D, generator=gen)
    ids = torch.full((U,), -1, dtype=torch.long)
    ids[:n_real] = torch.randperm(N - 1, generator=gen)[:n_real] + 1
    g = torch.randn(U, D, generator=gen)
    rnd = torch.randint(0, 1 << 16, (U, D), generator=gen)
    return [t.to(device) for t in (table, m, v, ids, g, rnd)]


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("wd,step", [(0.0, 0), (0.01, 7)])
def test_bf16_row_update_on_the_card_equals_the_cpu(card, wd, step, stochastic):
    """The bf16 table's row update (the plain formulation; no kernel: #7
    refuses a bf16 table) on the card against the same update on the CPU,
    bit for bit, with the same noise words; row 0 and untouched rows kept."""
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update

    cfg = SparseAdamConfig(weight_decay=wd)
    states = {}
    for dev in ("cpu", card):
        table, m, v, ids, g, rnd = _bf16_row_inputs(dev)
        before = table.clone()
        sparse_adamw_row_update(table, m, v, ids, g, 1e-3, step, cfg,
                                rnd=rnd if stochastic else None)
        states[str(dev)] = [t.cpu() for t in (table, m, v, before, ids)]
    (tc, mc, vc, before, ids), (tg, mg, vg, _, _) = states["cpu"], states[str(card)]
    assert tg.dtype == torch.bfloat16 and mg.dtype == vg.dtype == torch.float32
    assert torch.equal(tg.view(torch.int16), tc.view(torch.int16))
    assert torch.equal(mg, mc) and torch.equal(vg, vc)
    touched = torch.zeros(len(tg), dtype=torch.bool)
    touched[ids[ids >= 0]] = True
    assert torch.equal(tg[~touched], before[~touched]) and not torch.equal(tg[touched],
                                                                           before[touched])
    table, m, v, ids, g, _ = _bf16_row_inputs(card)
    with pytest.raises(ValueError, match="float32"):
        row_adamw(table, m, v, ids, g, 1e-3, step, cfg)


def _small_prior_setup(**over):
    """A 1-layer, 128-wide HSTU in chip_smoke.py's prior protocol (8
    categories, additive heads, the switch, negatives by category) on the
    in-memory data, and one train batch."""
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

    L = 8
    cfg = Config(
        config_file_list=["IDNet/hstu-size1.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"],
        config_dict=dict(
            dataset="synthetic", seed=0, MAX_ITEM_LIST_LENGTH=L, loss="prior",
            eval_num_cats=8, num_prior_head=8, num_segment_head=4,
            head_interaction="additive", medusa_num_layers=1, prior_switch="in",
            prior_switch_loss_weight=0.1, neg_sample_by_cat=True, weighted_prior_loss=True,
            pred_len=8, eval_pred_len=8, n_layers=1, n_heads=2, item_embedding_size=128,
            hstu_embedding_size=128, train_batch_size=16, num_negatives=512,
            sparse_item_adam=True, enable_relative_attention_bias=False,
            scan_layers=True, hidden_dropout_prob=0.0, total_iters=2, **over),
    ).finalize()
    data = InMemoryInteractionData(num_users=256, num_items=5000, seq_len=2 * L + 16,
                                   num_categories=8, eval_pred_len=8, max_item_list_length=L)
    batch = next(build_dataloader(cfg, data)[0].epoch_batches(0))
    return cfg, data, batch


def test_stacked_prior_loss_on_the_card_matches_the_loop(card):
    """The stacked prior loss against the loop on the card, a float32
    model, one batch: the outputs to rtol 2e-4 / atol 2e-5 and the
    gradients to rtol 5e-3 / atol 6e-3 (the JAX package's own bounds for
    the two paths, tests/test_losses.py)."""
    from mhrec_tpu_torch.trainer import Trainer

    cfg, data, batch = _small_prior_setup(prior_loss_impl="stacked")
    t = Trainer(cfg, data, device=card, dtype=torch.float32)
    t.setup_model()
    dev = t._train_device_batch(batch)
    ids = dev.pop("unique_ids")
    runs = {}
    for impl in ("stacked", "loop"):
        t.model.prior_loss_impl = impl
        sub = t.model.item_embedding.weight.detach()[ids.clamp(min=0)].requires_grad_(True)
        for p in t.model.parameters():
            p.grad = None
        out = t.model(dict(dev), sub=sub)
        out["loss"].backward()
        grads = {n: p.grad.clone() for n, p in t.model.named_parameters() if p.grad is not None}
        grads["item_rows"] = sub.grad
        runs[impl] = ({k: float(v.detach()) for k, v in out.items()}, grads)
    (o_s, g_s), (o_l, g_l) = runs["stacked"], runs["loop"]
    assert set(o_s) == set(o_l) and "head_nce_0_loss" in o_s
    for k in o_l:
        torch.testing.assert_close(o_s[k], o_l[k], rtol=2e-4, atol=2e-5, msg=k)
    assert set(g_s) == set(g_l)
    for k in g_l:
        torch.testing.assert_close(g_s[k], g_l[k], rtol=5e-3, atol=6e-3, msg=k)


def test_bf16_table_trains_on_the_card_without_row_adamw(card):
    """Two train steps with ``item_table_dtype: bfloat16``: the table stays
    bf16 with f32 moments, rows move, #7 is never launched, #4 is."""
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer import Trainer

    cfg, data, batch = _small_prior_setup(item_table_dtype="bfloat16")
    t = Trainer(cfg, data, device=card)
    t.setup_model()
    table = t.model.item_embedding.weight
    before = table.detach().clone()
    adam0, bwd0 = row_adamw.launches, K.hstu_stu_gated_bwd.launches
    for _ in range(2):
        loss = t.train_step(batch)["loss"]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert row_adamw.launches == adam0 and K.hstu_stu_gated_bwd.launches == bwd0 + 2
    assert table.dtype == torch.bfloat16 and t.table_m.dtype == torch.float32
    assert not torch.equal(table, before)


# -- the vision item towers ----------------------------------------------------
def _vision_inputs(case, cfg, gen):
    """Patches (and the dynamic maps) of 6 items on a 4 × 4 grid."""
    gt = 2 if case == "video" else 1
    x = torch.randn(6, gt * 16, cfg.patch_dim, generator=gen)
    if case != "dynamic":
        return (x,)
    valid = torch.ones(6, 16, dtype=torch.bool)
    valid[1, 8:] = False
    valid[4, 4:] = False
    hw = torch.stack(torch.meshgrid(torch.arange(4), torch.arange(4), indexing="ij"), -1)
    hw = hw.reshape(16, 2)[None].expand(6, 16, 2) * valid[..., None]
    return x, valid, hw.contiguous()


@pytest.mark.parametrize("case", ["static", "video", "dynamic"])
def test_vision_tower_on_the_card(card, case):
    """The Qwen2-VL tower (128 wide, 2 blocks, 4 heads, patch 14) on the
    card: in float32 against the CPU's float32 run (1e-4 of the largest
    output), and in bfloat16 against the card's float32 run (5e-2 of the
    largest output: bf16 products and residual stream over 2 blocks)."""
    from mhrec_tpu_torch.models.llm.vision import VisionConfig, VisionTower

    cfg = VisionConfig(embed_dim=128, depth=2, num_heads=4, mlp_ratio=4, patch_size=14,
                       hidden_size=256)
    gt = 2 if case == "video" else 1
    cpu = VisionTower(cfg, 4, 4, dtype=torch.float32, grid_t=gt)
    cpu.init_parameters(torch.Generator().manual_seed(0))
    args = _vision_inputs(case, cfg, torch.Generator().manual_seed(1))
    outs = {}
    with torch.no_grad():
        ref = cpu(*args)
        for dtype in (torch.float32, torch.bfloat16):
            tower = VisionTower(cfg, 4, 4, dtype=dtype, grid_t=gt).to(card)
            tower.load_state_dict(cpu.state_dict())
            outs[dtype] = tower(*(a.to(card) for a in args)).float().cpu()
    scale = float(ref.abs().max())
    assert float((outs[torch.float32] - ref).abs().max()) <= 1e-4 * scale
    assert float((outs[torch.bfloat16] - outs[torch.float32]).abs().max()) <= 5e-2 * scale


def test_image_hllm_step_on_the_card(card, tmp_path):
    """A tiny ``use_image`` HLLM (a Qwen2-VL config.json 64 wide, its vision
    tower 32 wide; 16 × 16 JPEGs for most items) in float32: one batch's
    loss on the card equals the CPU's with the same weights (1e-4), one
    train step on the card moves the vision tower's weights, and no kernel
    of the port is launched."""
    import json

    import chip_smoke
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.trainer import Trainer

    hf = dict(chip_smoke.QWEN2_VL_2B, vocab_size=512, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]},
              vision_config=dict(chip_smoke.QWEN2_VL_2B["vision_config"], depth=2,
                                 embed_dim=32, num_heads=4, mlp_ratio=2, patch_size=4,
                                 hidden_size=64))
    with open(tmp_path / "config.json", "w") as fh:
        json.dump(hf, fh)
    data = InMemoryInteractionData(num_users=40, num_items=300, seq_len=2 * 6 + 8,
                                   num_categories=4, eval_pred_len=4, max_item_list_length=6,
                                   item_texts=True, max_filler_words=12)
    chip_smoke.write_item_images(str(tmp_path / "images" / "synthetic"),
                                 data.id2token["item_id"], 300, sizes=((16, 16), (24, 32)))
    C = 4
    cfg = Config(config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"], config_dict=dict(
        dataset="synthetic", seed=0, data_path=str(tmp_path), precision="32",
        checkpoint_dir=str(tmp_path / "ckpt"), item_pretrain_dir=str(tmp_path),
        user_pretrain_dir=str(tmp_path), image_dir=str(tmp_path / "images"), use_image=True,
        img_height=16, img_width=16, MAX_TEXT_LENGTH=24, MAX_ITEM_LIST_LENGTH=6,
        loss="prior", train_batch_size=2, num_negatives=8, num_prior_head=C,
        num_segment_head=2, head_interaction="hierarchical", medusa_num_layers=1,
        eval_num_cats=C, pred_len=4, eval_pred_len=4, packed_item_tower=False,
        token_cache_dir=False, scheduler_args={"type": "constant"},
        int_to_category={i: f"cat_{i}" for i in range(C)})).finalize()
    batch = next(build_dataloader(cfg, data)[0].epoch_batches(0))
    losses = []
    for dev in ("cpu", card):
        t = Trainer(cfg, data, device=dev)
        t.setup_model()
        if dev == "cpu":
            state = t.model.state_dict()
        else:
            t.model.load_state_dict(state)
        with torch.no_grad():
            out = t.model(t._train_device_batch(batch), generator=t.step_generator(0))
        losses.append(float(out["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-4 * max(1.0, abs(losses[0]))
    before = t.model.visual.blocks[0].qkv.weight.detach().clone()
    launches = {fn.__name__: fn.launches for fn in chip_smoke.kernel_wrappers()}
    loss = t.train_step(batch)["loss"]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert not torch.equal(t.model.visual.blocks[0].qkv.weight, before)
    assert {fn.__name__: fn.launches for fn in chip_smoke.kernel_wrappers()} == launches


# -- the baselines (ComiRec / REMI's float32 trunk, #7 at SASRec's width) ------
@pytest.mark.parametrize("B", [64, 1024])
def test_stu_gated_f32_at_comirec_shapes(card, B):
    """#1 and #4 in float32 (their CUDA-core route), at ComiRec's train (64)
    and serve (1024) batches: window 50, 16 heads of 64."""
    L, H, d = 50, 16, 64
    args = _gated_inputs(B, L, H, d, torch.float32, card, seed=B)
    q, k, v, u, gamma, beta, nonpad, g = args
    assert K.stu_gated_fwd_route(torch.float32, L, H, d, d) == "cuda_cores"
    assert K.stu_gated_bwd_route(torch.float32, L, H, d, d) == "cuda_cores"
    f0, b0 = K.hstu_stu_gated_fwd.launches, K.hstu_stu_gated_bwd.launches
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H)
    grads = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H)
    torch.cuda.synchronize()
    assert (K.hstu_stu_gated_fwd.launches, K.hstu_stu_gated_bwd.launches) == (f0 + 1, b0 + 1)
    _close(out, K.hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, H), torch.float32)
    ref = K.hstu_stu_gated_bwd_plain(q, k, v, u, gamma, beta, nonpad, g, H)
    for o, r in zip(grads, ref):
        _close(o, r, torch.float32)


def test_row_adamw_at_sasrec_width_equals_plain(card):
    """#7 on a [200000, 512] table (SASRec's and LLMIDRec's width), unique
    ids with −1 pads, bit for bit against the plain update."""
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update

    gen = torch.Generator().manual_seed(512)
    N, D, U, n_real = 200_000, 512, 8192, 6000
    ids = torch.full((U,), -1, dtype=torch.long)
    ids[:n_real] = torch.randperm(N, generator=gen)[:n_real]
    g = torch.randn(U, D, generator=gen)
    state = [torch.randn(N, D, generator=gen), 0.01 * torch.randn(N, D, generator=gen),
             0.01 * torch.randn(N, D, generator=gen).abs()]
    out = [t.to(card) for t in state]
    ref = [t.to(card) for t in state]
    cfg = SparseAdamConfig(weight_decay=0.01)
    before = row_adamw.launches
    row_adamw(*out, ids.to(card), g.to(card), 1e-3, 5, cfg)
    sparse_adamw_row_update(*ref, ids.to(card), g.to(card), 1e-3, 5, cfg)
    torch.cuda.synchronize()
    assert row_adamw.launches == before + 1
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


BASELINE_FILES = {"SASRec": ["IDNet/sasrec.yaml"], "ComiRec": ["IDNet/comirec.yaml"],
                  "REMI": ["IDNet/remi.yaml"], "DualVAE": ["IDNet/dualvae.yaml"],
                  "LLMIDRec": ["IDNet/llama_id.yaml"]}


@pytest.mark.parametrize("family", list(BASELINE_FILES))
def test_baseline_step_on_the_card_matches_the_cpu(card, family):
    """One sparse train step of each baseline (2 layers, 128 wide; LLMIDRec
    the dummy tower) on the card and on the CPU from the same weights, no
    dropout: equal losses within 1e-4, and the card launches #7 once and,
    for ComiRec / REMI, #1 and #4 once a layer."""
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import build_dataloader
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
    from mhrec_tpu_torch.trainer import Trainer

    L = 8
    cfg = Config(config_file_list=["overall/ID.yaml"] + BASELINE_FILES[family], config_dict=dict(
        dataset="synthetic", seed=0, MAX_ITEM_LIST_LENGTH=L, n_layers=2, n_heads=2,
        item_embedding_size=128, hstu_embedding_size=128, embedding_size=128,
        item_embed_dim=64, train_batch_size=16, num_negatives=64, sparse_item_adam=True,
        total_iters=2)).finalize()
    data = InMemoryInteractionData(num_users=256, num_items=5000, seq_len=2 * L + 16,
                                   num_categories=8, eval_pred_len=8, max_item_list_length=L)
    batch = next(build_dataloader(cfg, data)[0].epoch_batches(0))
    trainers = {}
    for dev in ("cpu", card):
        t = trainers[str(dev)] = Trainer(cfg, data, device=dev)
        t.setup_model(seed=3)
        t.step_generator = lambda step, rounding=False: None  # no dropout, z = μ
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    losses = {"cpu": trainers["cpu"].train_step(batch)["loss"].item()}
    launches = (K.hstu_stu_gated_fwd.launches, K.hstu_stu_gated_bwd.launches,
                row_adamw.launches)
    losses["cuda"] = trainers["cuda"].train_step(batch)["loss"].item()
    torch.cuda.synchronize()
    after = (K.hstu_stu_gated_fwd.launches, K.hstu_stu_gated_bwd.launches,
             row_adamw.launches)
    layers = 2 if family in ("ComiRec", "REMI") else 0
    assert tuple(a - b for a, b in zip(after, launches)) == (layers, layers, 1)
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-4)


# -- data parallelism: a one-rank NCCL group on the card -----------------------
def _nccl_group(card):
    """Rank 0 of a one-rank NCCL group on the card (a free port)."""
    import socket

    from mhrec_tpu_torch.parallel import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return init_distributed(f"127.0.0.1:{port}", 1, 0, device=card)


def test_nccl_world1_collectives_on_the_card(card):
    """The comm helpers through NCCL on card tensors: at one rank each
    returns its input, the differentiable all-gather its gradient."""
    import torch.distributed as dist

    from mhrec_tpu_torch.parallel import comm

    _nccl_group(card)
    try:
        assert dist.get_backend() == "nccl" and comm.process_count() == 1
        x = torch.arange(6.0, device=card).reshape(3, 2)
        assert torch.equal(comm.all_reduce(x.clone()), x)
        assert torch.equal(comm.broadcast(x.clone(), 0), x)
        assert torch.equal(comm.all_gather(x)[0], x)
        leaf = x.clone().requires_grad_(True)
        (comm.all_gather_rows(leaf) * 3).sum().backward()
        assert torch.equal(leaf.grad, torch.full_like(x, 3.0))
        assert comm.broadcast_object({"a": 1}) == {"a": 1}
        assert comm.all_gather_objects(5) == [5]
        comm.sync_hosts("test")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shard_table", [False, True])
def test_nccl_world1_group_equals_the_ungrouped_run(card, shard_table):
    """Three train steps and an evaluation of a small HSTU (bf16 trunk,
    dropout, sparse_item_adam) as rank 0 of a one-rank NCCL group, every
    collective run through NCCL, against the same run without a group: the
    losses, every parameter, the row moments and the metrics bit for bit
    (at one rank the sharded table holds every row)."""
    import sys

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_worker as W

    def run():
        t = W.step_trainer(shard_table, device=card, compute_dtype="bfloat16")
        batches = t.batcher(0, 1).epoch_batches(0)
        losses = [float(t.train_step(next(batches))["loss"]) for _ in range(3)]
        from mhrec_tpu_torch.data.evalset import SeqEvalBatcher

        result = t.evaluate(SeqEvalBatcher(t.config, t.dataload, phase="test"))
        state = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
        return t, losses, state, result

    ref, ref_losses, ref_state, ref_result = run()
    _nccl_group(card)
    try:
        t, losses, state, result = run()
        assert t.mesh is not None and t.world == 1
    finally:
        dist.destroy_process_group()
    assert losses == ref_losses
    for k, v in ref_state.items():
        assert torch.equal(state[k], v), k
    assert torch.equal(t.table_m, ref.table_m) and torch.equal(t.table_v, ref.table_v)
    assert result == ref_result


# -- data parallelism of HLLM: two gloo ranks on the one card ------------------
HLLM_DP_CONFIG = dict(
    dataset="synthetic", seed=0, precision="32", random_init_towers=True,
    dummy_vocab_size=1024, dummy_hidden_size=64, MAX_ITEM_LIST_LENGTH=6, MAX_TEXT_LENGTH=16,
    train_batch_size=8, eval_batch_size=16, num_negatives=32, loss="prior", eval_num_cats=4,
    num_prior_head=4, num_segment_head=2, head_interaction="hierarchical",
    medusa_num_layers=1, segment_embed=True, neg_sample_by_cat=True, pred_len=4,
    eval_pred_len=4, topk=[5, 10], suppress_history=False, token_cache_dir=False,
    int_to_category={c: f"cat_{c}" for c in range(4)})
HLLM_DP_DATA = dict(num_users=64, num_items=200, seq_len=2 * 6 + 8, num_categories=4,
                    eval_pred_len=4, max_item_list_length=6, seed=0, item_texts=True)


def test_hllm_corpus_gather_and_pool_order_on_the_card(card, tmp_path):
    """Two gloo ranks on the one card (``tests/torch_parallel_worker.py
    hllm``; NCCL refuses two ranks on one device), a tiny float32 HLLM with
    the packed item tower (#8a on the card) and negatives per category: the
    corpus table the ranks gather from their halves of every corpus batch
    equals one process's table on the card (on the card and gathered in
    host memory), and each rank's gathered negative pool is the two ranks'
    negatives in rank order, equal to one process's pool over the composed
    batch (the dense tower: the same embeddings up to float32 sums)."""
    import json
    import socket
    import subprocess
    import sys

    import numpy as np

    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
    from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
    from mhrec_tpu_torch.trainer import Trainer

    over = dict(HLLM_DP_CONFIG, data_path=str(tmp_path), checkpoint_dir=str(tmp_path / "ck"))
    with open(tmp_path / "hllm_spec.json", "w") as fh:
        json.dump({"config": dict(over, packed_item_tower=True, pack_chunk=256),
                   "synthetic_data": HLLM_DP_DATA, "device": str(card), "seed": 3}, fh)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, os.path.join(root, "tests",
                                                            "torch_parallel_worker.py"),
                               "hllm", str(r), "2", str(port), str(tmp_path)], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:] + logs[1][-3000:]
    ranks = [torch.load(tmp_path / f"hllm.{r}.pt") for r in range(2)]

    cfg = Config(config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"],
                 config_dict=over).finalize()
    data = InMemoryInteractionData(**HLLM_DP_DATA)
    one = Trainer(cfg, data, device=card)
    one.setup_model(seed=3)
    table = one.compute_item_feature().cpu()
    parts = [next(TextSEQTrainBatcher(cfg, data, host_id=h, num_hosts=2).epoch_batches(0))
             for h in range(2)]
    composed = {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}
    pools = []

    class Recorder:
        rank, world = 0, 1

        def all_gather_rows(self, x, tag):
            pools.append(x.detach().cpu())
            return x

        def all_reduce(self, t, tag):
            return t

    one.model.mesh = Recorder()
    with torch.no_grad():
        one.model(one._train_device_batch(composed), generator=one.step_generator(0))
    for r in ranks:
        assert r["corpus_batch"] % 2 == 0 and r["traffic"]["corpus_gather"] > 0
        torch.testing.assert_close(r["table"], table, atol=1e-5, rtol=0)
        assert torch.equal(r["host_table"], r["table"])
        assert len(r["pools"]) == len(pools) == 4
        for got, want in zip(r["pools"], pools):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# -- FSDP: two gloo ranks on the one card -----------------------------------
def test_fsdp_collectives_and_tower_on_the_card(card, tmp_path):
    """FSDP's reduce-scatter and flat all-gather on CUDA tensors over gloo
    (torch's single-tensor forms), and a two-layer tower with its large
    parameters sharded, with and without gradient checkpointing: outputs
    and gradients bit-equal to the replicated tower's on the same rows
    (``tests/torch_parallel_worker.py fsdp`` on ``cuda:0``; NCCL refuses two
    ranks on one device)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_worker as W

    W.check_fsdp_worker(W.fsdp_worker_ranks(tmp_path, "cuda:0"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_row_parallel_partial_product_on_the_card(card, dtype):
    """A tensor-parallel rank's row-parallel partial product in a 16-bit
    compute type (``llama._tp_linear``): one GEMM that writes float32 (no
    rounding to the compute type, which the model group's sum does once),
    equal to the widened operands' float32 product to the order of sums;
    its backward is one process's product's (``F.linear`` in the compute
    type) on a gradient the compute type holds, to a rounding of that type
    (TOL of bfloat16)."""
    from mhrec_tpu_torch.models.llm.llama import _tp_linear

    gen = torch.Generator(device=card).manual_seed(0)
    layer = torch.nn.Linear(704, 512, bias=False).to(card)
    x = torch.randn(3, 40, 704, device=card, generator=gen).requires_grad_(True)
    out = _tp_linear(layer, x, dtype)
    assert out.dtype == torch.float32
    ref = torch.nn.functional.linear(x.detach().to(dtype).float(), layer.weight.to(dtype).float())
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    g = torch.randn(out.shape, device=card, generator=gen).to(dtype)
    out.backward(g.float())
    x2 = x.detach().clone().requires_grad_(True)
    w2 = layer.weight.detach().clone().requires_grad_(True)
    torch.nn.functional.linear(x2.to(dtype), w2.to(dtype)).backward(g)
    for got, want in ((x.grad, x2.grad), (layer.weight.grad, w2.grad)):
        tol = TOL[torch.bfloat16]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))
