"""The float32 backward of the packed segment attention (#8b / #8c,
``csrc/packed_attn_bwd_f32.cu``) as far as the CPU can check it: what the
wrapper hands the C functions of each route (meta tensors, the kernels
replaced by a recorder), and the kernels' walk (``chip_smoke.py``'s
``packed_warp_tiles``, the rule the kernels' warps skip sub-tiles by): every
attended pair lies in a sub-tile the walk computes. The kernels themselves
run in ``tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mhrec_tpu_torch.ops import packed_attention_cuda as P


def _recorder(monkeypatch):
    calls = []

    def fn(name, argtypes, source=None):
        def call(*args):
            calls.append((name, source, len(argtypes), args))
            return 0
        return call

    monkeypatch.setattr(P, "_fn", fn)
    monkeypatch.setattr(P, "_stream", lambda t: 0)
    monkeypatch.setattr(P.packed_attn_bwd, "launches", 0)
    return calls


def _meta_inputs(C, S, H, Hkv, dh, dtype, layout):
    m = torch.device("meta")
    q = torch.empty(C, S, H, dh, device=m, dtype=dtype)
    if layout == "kv_view":  # a rank's strided view of two of four KV heads
        kv = torch.empty(C, S, 4, dh, device=m, dtype=dtype)
        k, v = kv[:, :, 1:1 + Hkv], kv.clone()[:, :, 1:1 + Hkv]
    else:
        k, v = (torch.empty(C, S, Hkv, dh, device=m, dtype=dtype) for _ in range(2))
    if layout == "misaligned":  # rows 8 bytes past a 16-byte boundary
        q = torch.empty(C * S * H * dh + 2, device=m, dtype=dtype)[2:].view(C, S, H, dh)
        assert q.data_ptr() % 16 == 8
    out, dout = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty(C, H, S, device=m)
    seg = torch.empty(C, S, device=m, dtype=torch.int32)
    return q, k, v, out, dout, lse, seg


@pytest.mark.parametrize("dtype,dh,layout,window", [
    (torch.float32, 64, "contiguous", 257),   # the corpus shape's head width and band
    (torch.float32, 128, "kv_view", 13),      # a TP rank's view, a band off the tile grid
    (torch.float32, 16, "contiguous", None),  # no band: S - 1
    (torch.float32, 32, "misaligned", 70),    # copied to 16-byte rows first
    (torch.bfloat16, 64, "contiguous", 257),
], ids=["f32-dh64", "f32-dh128-view", "f32-dh16-noband", "f32-misaligned", "bf16"])
def test_bwd_wrapper_reaches_the_route_kernel(monkeypatch, dtype, dh, layout, window):
    """float32 reaches ``packed_attn_bwd_f32`` (its own library), bfloat16
    ``packed_attn_bwd``, each with the 11 pointers, C, S, H, Hkv, dh, q's,
    k's and v's chunk-row and token strides, the band, the scale and the
    stream (no dtype code); one launch is counted a call."""
    calls = _recorder(monkeypatch)
    C, S, H, Hkv = 2, 300, 4, 2
    q, k, v, out, dout, lse, seg = _meta_inputs(C, S, H, Hkv, dh, dtype, layout)
    grads = P.packed_attn_bwd(q, k, v, out, dout, lse, seg, window)
    assert [tuple(g.shape) for g in grads] == [(C, S, H, dh), (C, S, Hkv, dh), (C, S, Hkv, dh)]
    assert all(g.dtype == dtype for g in grads)
    (name, source, n_args, args), = calls
    assert (name, source) == (("packed_attn_bwd_f32", None) if dtype == torch.float32
                              else ("packed_attn_bwd", None))
    assert n_args == len(args) == 25
    assert args[11:16] == (C, S, H, Hkv, dh)
    qs = (S * H * dh, H * dh)  # a misaligned q is copied to a contiguous one
    assert args[16:22] == (*qs, *k.stride()[:2], *v.stride()[:2])
    if layout == "kv_view":  # passed as it is: the kernels take any row stride
        assert k.stride()[:2] == (S * 4 * dh, 4 * dh)
    assert args[22] == (S - 1 if window is None else window)
    assert args[23] == pytest.approx(dh ** -0.5) and args[24] == 0
    assert P.packed_attn_bwd.launches == 1


def _segments(rng, C, S, window, pad_runs):
    """Segment ids as pack_items packs them (runs of 1..2·window tokens from
    the start of each row, then trailing padding), with runs of padding in
    between where ``pad_runs``; one row all padding."""
    seg = np.zeros((C, S), np.int32)
    sid = 0
    for c in range(C - 1):
        off, fill = 0, int(rng.integers(S // 2, S + 1))
        while True:
            if pad_runs and rng.random() < 0.2:
                off += int(rng.integers(1, 20))
            n = int(rng.integers(1, 2 * window + 1))
            if off + n > fill:
                break
            sid += 1
            seg[c, off:off + n] = sid
            off += n
    return torch.from_numpy(seg)


@pytest.mark.parametrize("window,pad_runs,seed", [
    (257, False, 0),  # the corpus band: every segment fits in it
    (13, False, 1),   # a band off the 16-row grid, most segments past it
    (70, True, 2),    # padding runs between segments
    (1, True, 3),
    (300, True, 4),
], ids=["band257", "band13", "band70-pads", "band1-pads", "band300-pads"])
def test_f32_walk_covers_every_attended_pair(window, pad_runs, seed):
    """Each (query, key) pair the forward attends lies in a 16 × 16 sub-tile
    the float32 kernels' walk computes, in the dq pass (the query's warp, a
    stage holding the key) and in the dk/dv pass (the key's warp, a stage
    holding the query); no sub-tile is computed twice; the walk computes at
    least the band's pairs and fewer than the 64 × 64 tiles."""
    C, S = 4, 300
    seg = _segments(np.random.default_rng(seed), C, S, window, pad_runs)
    tiles = list(chip_smoke.packed_warp_tiles(seg, window))
    assert len(set(tiles)) == len(tiles)
    done = set(tiles)
    mask = chip_smoke.packed_mask(seg, window)[:, 0]
    for c, i, j in mask.nonzero().tolist():
        assert any(("dq", c, i - i % 16, s0) in done for s0 in range(j - 15, j + 1)), (c, i, j)
        assert any(("dkv", c, j - j % 16, s0) in done for s0 in range(i - 15, i + 1)), (c, i, j)
    pairs = chip_smoke.packed_pairs(seg, window)
    assert pairs == int(mask.sum())
    warp = chip_smoke.packed_tile_pairs(seg, window, "warp")
    block = chip_smoke.packed_tile_pairs(seg, window, "block")
    for p in ("dq", "dkv"):
        assert pairs <= warp[p] < block[p]
