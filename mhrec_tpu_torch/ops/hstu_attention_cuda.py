"""Hand-written CUDA forward kernels for HSTU attention, with their plain
PyTorch versions.

Counterpart of ``mhrec_tpu/ops/pallas/hstu_attention_tpu.py`` (forward
halves; the backward kernels come with the training slice):

* ``hstu_stu_gated_fwd`` — the fused STU block ``u ⊙ LN(attention)``
  (``csrc/hstu_stu_gated_fwd.cu``), replacing ``_fwd_gated_kernel`` /
  ``hstu_attention_gated_pallas``;
* ``hstu_attn_fwd`` — the pointwise attention over ``[B, H, L, d]``
  (``csrc/hstu_attn_fwd.cu``), replacing ``_fwd_kernel_v2`` /
  ``hstu_attention_pallas_v2``; ``hstu_attention_v2`` and
  ``hstu_attention_bhld`` are its layout wrappers for ``[B, L, H, d]`` and
  ``[B·H, L, d]`` (the latter replacing ``_fwd_kernel`` /
  ``hstu_attention_pallas``).

Both kernels are bound by device-memory bytes on the H100; each ``.cu``
file's header says how its design treats that. A wrapper given CPU tensors
runs the plain version of its kernel; given CUDA tensors it launches the
kernel or raises — there is no fallback. Each wrapper counts its launches in
``<wrapper>.launches``.

Every wrapper takes the key padding as ``nonpad`` [B, L] (True = real item):
the attention mask is ``causal & nonpad[key]`` and the divisor is the
window length L, pad items included (``mhrec_tpu/ops/hstu_attention.py:34``).
"""

from __future__ import annotations

import ctypes

import torch

from mhrec_tpu_torch.ops import cuda_build

# shared-memory layout of csrc/hstu_attn_common.cuh
_TQ, _TK, _MAX_D = 16, 64, 128
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _head_smem_bytes(dqk: int, dv: int) -> int:
    return 4 * (_TQ * (dqk + 1) + _TK * (dqk + 1) + _TK * dv + _TQ * (_TK + 1))


def _lib(name: str, argtypes) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_cuda_inputs(name: str, tensors, nonpad):
    dev = tensors[0].device
    dtype = tensors[0].dtype
    _check(dtype in _DTYPES, f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    for t in tensors:
        _check(t.device == dev, f"{name}: all inputs must be on {dev}, got {t.device}")
        _check(t.dtype == dtype, f"{name}: all inputs must be {dtype}, got {t.dtype}")
        _check(t.stride(-1) == 1, f"{name}: last dimension must be contiguous")
    _check(nonpad.device == dev and nonpad.dtype == torch.bool and nonpad.is_contiguous(),
           f"{name}: nonpad must be a contiguous bool tensor on {dev}")


def _launch_error(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _masked_silu_scores(q, k, nonpad, n: int):
    """``mask ⊙ silu(q kᵀ) / n`` in f32 over [..., L, d] q/k and [B, L]
    nonpad (broadcast over the middle dims), cast to the value type later by
    the caller."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * torch.sigmoid(s) * (1.0 / n)
    L = q.shape[-2]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    keep = causal & nonpad.view(nonpad.shape[0], *([1] * (q.dim() - 3)), 1, L)
    return torch.where(keep, s, torch.zeros((), device=s.device))


# ----------------------------------------------------------------------------
# Kernel A: fused STU block
# ----------------------------------------------------------------------------
def hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, num_heads: int,
                             eps: float = 1e-6):
    """Plain version of ``hstu_stu_gated_fwd`` (the math of the JAX kernel
    ``_fwd_gated_kernel``, hstu_attention_tpu.py:378-409)."""
    B, L, Fq = q.shape
    F = v.shape[-1]
    H = num_heads
    qh = q.reshape(B, L, H, Fq // H).transpose(1, 2)
    kh = k.reshape(B, L, H, Fq // H).transpose(1, 2)
    vh = v.reshape(B, L, H, F // H).transpose(1, 2)
    s = _masked_silu_scores(qh, kh, nonpad, L).to(v.dtype)
    attn = torch.matmul(s.float(), vh.float()).transpose(1, 2).reshape(B, L, F)
    mu = attn.mean(-1, keepdim=True)
    var = (attn - mu).square().mean(-1, keepdim=True)
    xhat = (attn - mu) * torch.rsqrt(var + eps)
    y = xhat * gamma.float() + beta.float()
    return (u.float() * y).to(q.dtype)


def hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, num_heads: int,
                       eps: float = 1e-6):
    """``u ⊙ LayerNorm(concat_h(mask ⊙ silu(q_h k_hᵀ)/L · v_h))``.

    q, k [B, L, H·dqk]; v, u [B, L, H·dv] — row-strided views (e.g. the
    splits of the uvqk projection) are taken without copies; gamma, beta
    [H·dv] float32; nonpad [B, L] bool. Returns [B, L, H·dv] in q's dtype.
    """
    if q.device.type == "cpu":
        return hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, num_heads, eps)
    name = "hstu_stu_gated_fwd"
    _check_cuda_inputs(name, (q, k, v, u), nonpad)
    B, L, Fq = q.shape
    F = v.shape[-1]
    H = num_heads
    _check(k.shape == q.shape and u.shape == v.shape and v.shape[:2] == (B, L),
           f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
           f"u{tuple(u.shape)} disagree")
    _check(Fq % H == 0 and F % H == 0, f"{name}: widths {Fq}, {F} not divisible by {H} heads")
    dqk, dv = Fq // H, F // H
    _check(dqk <= _MAX_D and dv <= _MAX_D, f"{name}: head widths above {_MAX_D}")
    _check(4 * _TQ * F + _head_smem_bytes(dqk, dv) <= _SMEM_LIMIT,
           f"{name}: F={F} needs more shared memory than a block has")
    _check(1 <= B <= 65535, f"{name}: batch {B} outside the grid's range")
    for t, what in ((gamma, "gamma"), (beta, "beta")):
        _check(t.device == q.device and t.dtype == torch.float32 and t.is_contiguous()
               and t.shape == (F,), f"{name}: {what} must be contiguous float32 [{F}]")
    _check(nonpad.shape == (B, L), f"{name}: nonpad must be [{B}, {L}]")
    fn = _lib(name, [_P] * 8 + [_I] * 5 + [_LL] * 8 + [_F, _F, _I, _P])
    out = torch.empty((B, L, F), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), nonpad.data_ptr(), out.data_ptr(), B, L, H, dqk, dv,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), u.stride(0), u.stride(1),
             1.0 / L, eps, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error(name, err)
    hstu_stu_gated_fwd.launches += 1
    return out


hstu_stu_gated_fwd.launches = 0


# ----------------------------------------------------------------------------
# Kernel B: pointwise attention over [B, H, L, d]
# ----------------------------------------------------------------------------
def hstu_attn_fwd_plain(q, k, v, nonpad):
    """Plain version of ``hstu_attn_fwd`` (the math of the JAX kernel
    ``_fwd_kernel_v2``, hstu_attention_tpu.py:201-220)."""
    s = _masked_silu_scores(q, k, nonpad, q.shape[-2]).to(v.dtype)
    return torch.matmul(s.float(), v.float()).to(q.dtype)


def hstu_attn_fwd(q, k, v, nonpad):
    """q, k [B, H, L, dqk], v [B, H, L, dv] (any strides with a contiguous
    last dim), nonpad [B, L] bool → [B, H, L, dv] in q's dtype."""
    if q.device.type == "cpu":
        return hstu_attn_fwd_plain(q, k, v, nonpad)
    name = "hstu_attn_fwd"
    _check_cuda_inputs(name, (q, k, v), nonpad)
    B, H, L, dqk = q.shape
    dv = v.shape[-1]
    _check(k.shape == q.shape and v.shape[:3] == (B, H, L),
           f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    _check(dqk <= _MAX_D and dv <= _MAX_D, f"{name}: head widths above {_MAX_D}")
    _check(1 <= B <= 65535 and 1 <= H <= 65535, f"{name}: grid ({B}, {H}) out of range")
    _check(nonpad.shape == (B, L), f"{name}: nonpad must be [{B}, {L}]")
    fn = _lib(name, [_P] * 5 + [_I] * 5 + [_LL] * 9 + [_F, _I, _P])
    out = torch.empty((B, H, L, dv), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), nonpad.data_ptr(), out.data_ptr(),
             B, H, L, dqk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             1.0 / L, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error(name, err)
    hstu_attn_fwd.launches += 1
    return out


hstu_attn_fwd.launches = 0


def hstu_attention_v2(q, k, v, nonpad):
    """[B, L, H, d] in and out through ``hstu_attn_fwd`` (counterpart of
    ``hstu_attention_pallas_v2``); the head-major views cost no copy."""
    out = hstu_attn_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), nonpad)
    return out.transpose(1, 2)


def hstu_attention_bhld(q, k, v, nonpad):
    """[B·H, L, d] in and out, nonpad [B·H, L] per row (counterpart of
    ``_hstu_attention_bhld`` behind ``hstu_attention_pallas``)."""
    return hstu_attn_fwd(q[:, None], k[:, None], v[:, None], nonpad)[:, 0]
