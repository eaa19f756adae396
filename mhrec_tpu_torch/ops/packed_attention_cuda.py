"""Packed (varlen) segment attention of the HLLM item tower as a hand-written
CUDA kernel (``csrc/packed_attn_fwd.cu``).

Counterpart of the splash-attention call ``_splash_call``
(``mhrec_tpu/models/llm/packed.py:45``) behind ``packed_attention_splash``.
On CPU tensors ``packed_attn_fwd`` runs the plain version
(``models/llm/packed.py::packed_attention_plain``); on CUDA tensors it
launches the kernel or raises. ``packed_attn_fwd.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mhrec_tpu_torch.models.llm.packed import packed_attention_plain
from mhrec_tpu_torch.ops import cuda_build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def packed_attn_fwd(q, k, v, segment_ids, window: Optional[int] = None):
    """q [C, S, H, dh], k/v [C, S, Hkv, dh] (float32 or bfloat16, each token
    row's heads contiguous), segment_ids [C, S] int32, 0 = padding → out
    [C, S, H, dh] contiguous in q's dtype: query i attends to key j ≤ i of
    its own segment with i − j ≤ ``window`` (None = no band), softmax over
    them with float32 statistics and scale 1/√dh; KV head h // (H / Hkv)
    serves query head h. Each segment id must occupy one contiguous run of
    its row (``pack_items`` packs so); the kernel bounds its key band by
    that. Rows of segment 0 are zeros."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, segment_ids, window)
    name = "packed_attn_fwd"
    dev, dtype = q.device, q.dtype
    _check(dtype in _DTYPES, f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, f"{name}: q, k, v must be 4-d")
    C, S, H, dh = q.shape
    Hkv = k.shape[2]
    _check(k.shape == (C, S, Hkv, dh) and v.shape == k.shape,
           f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    _check(Hkv >= 1 and H % Hkv == 0, f"{name}: {H} query heads over {Hkv} KV heads")
    _check(dh in _HEAD_DIMS, f"{name}: head width {dh} not one of {_HEAD_DIMS}")
    _check(1 <= C <= 65535 and 1 <= H <= 65535, f"{name}: grid ({C}, {H}) out of range")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check(t.device == dev and t.dtype == dtype, f"{name}: {what} must be {dtype} on {dev}")
        _check(t.stride(3) == 1 and t.stride(2) == dh,
               f"{name}: {what} must have contiguous heads (strides {t.stride()})")
    _check(segment_ids.device == dev and segment_ids.dtype == torch.int32
           and segment_ids.shape == (C, S) and segment_ids.is_contiguous(),
           f"{name}: segment_ids must be a contiguous int32 [{C}, {S}] tensor on {dev}")
    w = S - 1 if window is None else int(window)
    _check(w >= 0, f"{name}: window {w} must be >= 0")
    lib = cuda_build.load(name)
    fn = lib.packed_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_LL] * 6 + [_I, _F, _I, _P]
        fn.restype = ctypes.c_int
    out = torch.empty((C, S, H, dh), dtype=dtype, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
             C, S, H, Hkv, dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), min(w, S), dh ** -0.5, _DTYPES[dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    packed_attn_fwd.launches += 1
    return out


packed_attn_fwd.launches = 0
