"""Packed (varlen) segment attention of the HLLM item tower as hand-written
CUDA kernels: the forward (``csrc/packed_attn_fwd.cu``) and the backward
(``csrc/packed_attn_bwd.cu``: a dq pass and a dk/dv pass). Each routes by
the input type: bfloat16 runs on the tensor cores, float32 on the CUDA
cores in full float32.

Counterparts of the splash-attention call ``_splash_call``
(``mhrec_tpu/models/llm/packed.py:45``) behind ``packed_attention_splash``
and of the two kernels of its ``custom_vjp``. On CPU tensors each wrapper
runs its plain version (``models/llm/packed.py``: the forward, its
log-sum-exp, and the autograd of the forward); on CUDA tensors it launches
its kernel or raises. ``packed_attn_fwd.launches`` and
``packed_attn_bwd.launches`` count the kernels' launches (one backward call
launches both of its passes and counts once).

Under tensor parallelism (``tp_size > 1``, ``models/llm/llama.py``) each
rank calls the kernels on its own H/T query heads and the KV heads those
read: its own KV heads where their count divides by T, else a strided view
of the whole projection's KV heads (the kernels take any token and row
strides, so the view is not copied) or, where the local query heads do
not map onto that view as h // (H / Hkv), the KV heads gathered one per
query head. The JAX splash call has no partitioning rule
(``mhrec_tpu/models/llm/packed.py:45-75`` has no ``shard_map``): GSPMD
runs it on the heads its operands hold. Splitting the kernels by heads is
a departure in mechanics, not in the numbers: each head's attention is
computed alone in both.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mhrec_tpu_torch.models.llm.packed import (
    packed_attention_plain,
    packed_attn_bwd_plain,
    packed_lse_plain,
)
from mhrec_tpu_torch.ops import cuda_build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_inputs(name, q, k, v, segment_ids, window):
    """The checks both kernels share → (C, S, H, Hkv, dh, band)."""
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
    return C, S, H, Hkv, dh, min(w, S)


def _fn(name: str, argtypes):
    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def packed_attn_fwd(q, k, v, segment_ids, window: Optional[int] = None,
                    return_lse: bool = False):
    """q [C, S, H, dh], k/v [C, S, Hkv, dh] (float32 or bfloat16, each token
    row's heads contiguous), segment_ids [C, S] int32, 0 = padding → out
    [C, S, H, dh] contiguous in q's dtype: query i attends to key j ≤ i of
    its own segment with i − j ≤ ``window`` (None = no band), softmax over
    them with float32 statistics and scale 1/√dh; KV head h // (H / Hkv)
    serves query head h. Each segment id must occupy one contiguous run of
    its row (``pack_items`` packs so); the kernel bounds its key band by
    that. Rows of segment 0 are zeros. ``return_lse`` also returns each
    row's float32 log-sum-exp of its scaled scores, [C, H, S] (−inf on rows
    of segment 0), which the backward reads."""
    if q.device.type == "cpu":
        out = packed_attention_plain(q, k, v, segment_ids, window)
        return (out, packed_lse_plain(q, k, segment_ids, window)) if return_lse else out
    name = "packed_attn_fwd"
    C, S, H, Hkv, dh, w = _check_inputs(name, q, k, v, segment_ids, window)
    if q.dtype == torch.bfloat16:
        q, k, v = (cuda_build.aligned16(t) for t in (q, k, v))
    fn = _fn(name, [_P] * 6 + [_I] * 5 + [_LL] * 6 + [_I, _F, _I, _P])
    out = torch.empty((C, S, H, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((C, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             C, S, H, Hkv, dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), w, dh ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    packed_attn_fwd.launches += 1
    return (out, lse) if return_lse else out


packed_attn_fwd.launches = 0


def packed_attn_bwd(q, k, v, out, dout, lse, segment_ids, window: Optional[int] = None):
    """Gradients (dq, dk, dv) of ``packed_attn_fwd``'s output ``out`` for the
    cotangent ``dout`` [C, S, H, dh], from the forward's inputs and its
    ``lse`` [C, H, S]; in the inputs' dtype, dk/dv summed over the query
    heads of each KV head. dq is 0 on rows of segment 0, dk and dv on keys
    that no real query attends."""
    if q.device.type == "cpu":
        return packed_attn_bwd_plain(q, k, v, dout, segment_ids, window)
    name = "packed_attn_bwd"
    C, S, H, Hkv, dh, w = _check_inputs(name, q, k, v, segment_ids, window)
    dev, dtype = q.device, q.dtype
    for t, what, shape in ((out, "out", q.shape), (dout, "dout", q.shape)):
        _check(t.device == dev and t.dtype == dtype and t.shape == shape,
               f"{name}: {what} must be {dtype} {tuple(shape)} on {dev}")
    _check(lse.device == dev and lse.dtype == torch.float32 and lse.shape == (C, H, S)
           and lse.is_contiguous(),
           f"{name}: lse must be a contiguous float32 [{C}, {H}, {S}] tensor on {dev}")
    out, dout = out.contiguous(), dout.contiguous()
    if dtype == torch.bfloat16:
        q, k, v, out, dout = (cuda_build.aligned16(t) for t in (q, k, v, out, dout))
    fn = _fn(name, [_P] * 11 + [_I] * 5 + [_LL] * 6 + [_I, _F, _I, _P])
    dq = torch.empty((C, S, H, dh), dtype=dtype, device=dev)
    dk = torch.empty((C, S, Hkv, dh), dtype=dtype, device=dev)
    dv = torch.empty((C, S, Hkv, dh), dtype=dtype, device=dev)
    delta = torch.empty((C, H, S), dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), segment_ids.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(),
             C, S, H, Hkv, dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), w, dh ** -0.5, _DTYPES[dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    packed_attn_bwd.launches += 1
    return dq, dk, dv


packed_attn_bwd.launches = 0
