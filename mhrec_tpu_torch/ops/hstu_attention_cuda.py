"""Hand-written CUDA kernels for HSTU attention, forward and backward, with
their plain PyTorch versions.

Counterpart of ``mhrec_tpu/ops/pallas/hstu_attention_tpu.py``:

* ``hstu_stu_gated_fwd`` — the fused STU block ``u ⊙ LN(attention)``
  (``csrc/hstu_stu_gated_fwd.cu``), replacing ``_fwd_gated_kernel`` /
  ``hstu_attention_gated_pallas``, on the tensor cores in bfloat16
  (``stu_gated_fwd_route``); differentiable, its backward is
  ``hstu_stu_gated_bwd`` (``csrc/hstu_stu_gated_bwd.cu``), replacing
  ``_bwd_gated_kernel``, on the tensor cores in bfloat16
  (``stu_gated_bwd_route``). In float32 both run on the CUDA cores in one
  of two forms (``stu_gated_f32_form``): one thread-block cluster a batch
  row over windows of at most 64 rows (``csrc/hstu_stu_f32.cu``), else one
  block a 16-row query tile (the two files above);
* ``hstu_attn_fwd`` — the pointwise attention over ``[B, H, L, d]``
  (``csrc/hstu_attn_fwd.cu``), replacing ``_fwd_kernel_v2`` /
  ``hstu_attention_pallas_v2``, on the tensor cores in bfloat16
  (``attn_fwd_route``); differentiable, its backward is
  ``hstu_attn_bwd`` (``csrc/hstu_attn_bwd.cu``), replacing
  ``_bwd_kernel_v2``, on the tensor cores in bfloat16
  (``attn_bwd_route``). ``hstu_attention_v2`` and ``hstu_attention_bhld`` are
  its layout wrappers for ``[B, L, H, d]`` and ``[B·H, L, d]`` (the latter
  replacing ``_fwd_kernel`` / ``_bwd_kernel`` behind
  ``hstu_attention_pallas``), differentiable through it.

The kernels are bound by device-memory bytes on the H100 at the size4
shape; each ``.cu`` file's header says how its design treats that. A
wrapper given CPU tensors runs the plain version of its kernel; given CUDA
tensors it launches the kernel or raises — there is no fallback. Each kernel
wrapper counts its launches in ``<wrapper>.launches``.

Every wrapper takes the key padding as ``nonpad`` [B, L] (True = real item):
the attention mask is ``causal & nonpad[key]`` and the divisor is the
window length L, pad items included (``mhrec_tpu/ops/hstu_attention.py:34``).
"""

from __future__ import annotations

import ctypes

import torch

from mhrec_tpu_torch.ops import cuda_build

# shared-memory layout of csrc/hstu_attn_common.cuh, the warps and key-tile
# rows of the fused STU block's tensor-core kernels (csrc/hstu_stu_tc.cuh),
# and the bytes of per-row statistics that the backward's kernel holds on top
_TQ, _TK, _MAX_D = 16, 64, 128
_TC_WARPS, _TC_TK = 4, 32
_TC_BWD_STATS = 4 * 4 * _TQ
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the float32 cluster kernels (csrc/hstu_stu_f32.cu, hstu_stu_cluster.cuh):
# the longest window, the portable cluster size, the heads a forward block
# works on at once (a pair of product groups each), a score tile's floats,
# the exchanged partial sums' and row statistics' floats
_CL_MAX_L, _CL_MAX_CLUSTER, _CL_PAIRS = 64, 8, 2
_CL_P_FLOATS, _CL_STAT_FLOATS = 64 * 68, 8 * 64
F32_FORMS = ("cluster", "query_tiles")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)


def _head_smem_bytes(dqk: int, dv: int) -> int:
    return 4 * (_TQ * (dqk + 1) + _TK * (dqk + 1) + _TK * dv + _TQ * (_TK + 1))


def _tc_smem_bytes(dqk: int, dv: int, L: int, H: int) -> int:
    """Shared memory of the fused STU block's tensor-core kernels with one
    stage a warp (``tc_smem_bytes`` of csrc/hstu_stu_tc.cuh)."""
    dp = next(d for d in (16, 32, 64, 128) if d >= max(dqk, dv))
    return (4 * _TQ * (H * dv + 8) + 2 * _TC_WARPS * (_TQ + 2 * _TC_TK) * (dp + 8)
            + -(-L // 16) * 16)


def stu_gated_fwd_route(dtype, L: int, H: int, dqk: int, dv: int) -> str:
    """Which kernel ``hstu_stu_gated_fwd`` launches on the card: bfloat16
    with head widths that are multiples of 8 runs on the tensor cores where
    its shared memory fits (every size the models build: widths 32 and 64
    up to F = 2048); float32, bfloat16 at other widths, and rows too wide for
    its shared memory on the CUDA cores."""
    tc = (dtype == torch.bfloat16 and dqk % 8 == 0 and dv % 8 == 0
          and _tc_smem_bytes(dqk, dv, L, H) <= _SMEM_LIMIT)
    return "tensor_cores" if tc else "cuda_cores"


def stu_f32_cluster(H: int):
    """(blocks a cluster, heads a block) of the float32 cluster kernels at
    H heads: ceil(H / 8) heads a block, as few blocks as cover H (at most
    8, the portable cluster size; the last block may hold fewer heads)."""
    hb = -(-H // _CL_MAX_CLUSTER)
    return -(-H // hb), hb


def _stu_cluster_smem_bytes(L: int, H: int, dqk: int, dv: int, backward: bool) -> int:
    """Dynamic shared memory of a float32 cluster block
    (``stu32::fwd_smem_bytes`` / ``bwd_smem_bytes``): the statistics, q, k,
    v tiles of ``round8(L)`` rows at a pitch that is a multiple of 4 floats
    with an odd quarter — every head's of the block forward (plus a score
    tile for each head worked on at once where a q tile cannot hold the
    scores and then the output), one head's and the block's [L, hb·dv] rows
    and two score tiles backward."""
    hb = stu_f32_cluster(H)[1]
    L8 = -(-L // 8) * 8
    dp = -(-max(dqk, dv) // 4) * 4
    ld = dp + (4 if dp % 8 == 0 else 8)
    if backward:
        floats = _CL_STAT_FLOATS + 2 * _CL_P_FLOATS + 3 * L8 * ld + L8 * (hb * dv + 4)
    else:
        own = ld < L8 or dv > 64
        floats = (_CL_STAT_FLOATS + own * min(hb, _CL_PAIRS) * _CL_P_FLOATS
                  + hb * 3 * L8 * ld)
    return 4 * floats


def stu_gated_f32_form(L: int, H: int, dqk: int, dv: int, backward: bool = False) -> str:
    """Which float32 kernel the fused STU block takes on the card (both on
    the CUDA cores in full float32): "cluster" — one thread-block cluster a
    batch row (``stu_f32_cluster``), a block's heads' windows in shared
    memory, the LayerNorm's row sums exchanged through distributed shared
    memory — for windows of at most 64 rows (every model config: window 50)
    and head widths that are multiples of 4 up to 128, where its shared
    memory fits; else "query_tiles", one block a 16-row query tile walking
    every head."""
    ok = (1 <= L <= _CL_MAX_L and 4 <= min(dqk, dv) and max(dqk, dv) <= _MAX_D
          and dqk % 4 == 0 and dv % 4 == 0
          and _stu_cluster_smem_bytes(L, H, dqk, dv, backward) <= _SMEM_LIMIT)
    return "cluster" if ok else "query_tiles"


def _pick_f32_form(name: str, form, q, v, H: int, backward: bool) -> str:
    """The float32 form a call takes: ``form`` as asked (None: the shape's
    own, ``stu_gated_f32_form``); the cluster form only where the shape
    allows it."""
    auto = stu_gated_f32_form(q.shape[1], H, q.shape[-1] // H, v.shape[-1] // H, backward)
    form = auto if form is None else form
    _check(form in F32_FORMS, f"{name}: unknown float32 form {form!r}")
    _check(form == "query_tiles" or auto == "cluster",
           f"{name}: this shape cannot take the float32 cluster form")
    return form


def _tc_widths(dqk: int, dv: int) -> bool:
    """Head widths the bfloat16 tensor-core kernels take: multiples of 8
    (their 16-byte copies) up to 128."""
    return dqk % 8 == 0 and dv % 8 == 0 and max(dqk, dv) <= _MAX_D


def stu_gated_bwd_route(dtype, L: int, H: int, dqk: int, dv: int) -> str:
    """Which kernels ``hstu_stu_gated_bwd`` launches on the card: bfloat16
    with head widths that are multiples of 8 up to 128 runs on the tensor
    cores where the recompute's shared memory (the forward's, plus the rows'
    statistics) fits — every size the models build, F = 2048 included;
    float32, bfloat16 at other widths, and rows too wide on the CUDA cores
    (the tensor cores would take float32 as TF32)."""
    tc = (dtype == torch.bfloat16 and _tc_widths(dqk, dv)
          and _tc_smem_bytes(dqk, dv, L, H) + _TC_BWD_STATS <= _SMEM_LIMIT)
    return "tensor_cores" if tc else "cuda_cores"


def attn_fwd_route(dtype, L: int, dqk: int, dv: int) -> str:
    """Which kernel ``hstu_attn_fwd`` launches on the card: bfloat16 with
    head widths that are multiples of 8 up to 128 on the tensor cores;
    float32 and bfloat16 at other widths on the CUDA cores. The window
    length L picks the kernel within the tensor-core route (up to 64 rows
    one block a head, beyond that one block a 64-row query tile), not the
    route."""
    tc = dtype == torch.bfloat16 and _tc_widths(dqk, dv)
    return "tensor_cores" if tc else "cuda_cores"


def attn_bwd_route(dtype, L: int, dqk: int, dv: int) -> str:
    """Which kernels ``hstu_attn_bwd`` launches on the card: the forward's
    rule (``attn_fwd_route``). Within the tensor-core route L picks the
    kernels: up to 64 rows one block a head, beyond that a dq and a dk/dv
    pass over 64-row tiles."""
    return attn_fwd_route(dtype, L, dqk, dv)


def _pick_route(name: str, route, auto: str) -> str:
    """``route`` as asked (None: ``auto``, the route the inputs select);
    the tensor cores only where the inputs allow them."""
    route = auto if route is None else route
    _check(route in ("tensor_cores", "cuda_cores"), f"{name}: unknown route {route!r}")
    _check(route == "cuda_cores" or auto == "tensor_cores",
           f"{name}: these inputs cannot take the tensor-core route")
    return route


def _lib(name: str, argtypes, source: str = None) -> ctypes.CDLL:
    """Function ``name`` of the library built from ``csrc/<source>.cu``
    (None: ``name``'s own)."""
    lib = cuda_build.load(source or name)
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


def _check_gated_inputs(name, q, k, v, u, gamma, beta, nonpad, num_heads):
    """Shapes and widths the fused STU kernels take; returns (B, L, H, dqk, dv)."""
    B, L, Fq = q.shape
    F = v.shape[-1]
    H = num_heads
    _check(k.shape == q.shape and u.shape == v.shape and v.shape[:2] == (B, L),
           f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
           f"u{tuple(u.shape)} disagree")
    _check(Fq % H == 0 and F % H == 0, f"{name}: widths {Fq}, {F} not divisible by {H} heads")
    dqk, dv = Fq // H, F // H
    _check(dqk <= _MAX_D and dv <= _MAX_D, f"{name}: head widths above {_MAX_D}")
    _check(4 * _TQ * (F + 2) + _head_smem_bytes(dqk, dv) <= _SMEM_LIMIT,
           f"{name}: F={F} needs more shared memory than a block has")
    _check(1 <= B <= 65535, f"{name}: batch {B} outside the grid's range")
    for t, what in ((gamma, "gamma"), (beta, "beta")):
        _check(t.device == q.device and t.dtype == torch.float32 and t.is_contiguous()
               and t.shape == (F,), f"{name}: {what} must be contiguous float32 [{F}]")
    _check(nonpad.shape == (B, L), f"{name}: nonpad must be [{B}, {L}]")
    return B, L, H, dqk, dv


def _launch_error(name: str, err: int):
    if err == -1:
        raise RuntimeError(f"{name}: no thread-block cluster of this shape fits on the card "
                           "(cudaOccupancyMaxActiveClusters found none)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _keep_mask(nonpad, q):
    """causal & nonpad[key] for [..., L, d] heads and [B, L] nonpad,
    broadcast over the middle dims."""
    L = q.shape[-2]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    return causal & nonpad.view(nonpad.shape[0], *([1] * (q.dim() - 3)), 1, L)


def _masked_silu_scores(q, k, nonpad, n: int):
    """``mask ⊙ silu(q kᵀ) / n`` in f32 over [..., L, d] q/k and [B, L]
    nonpad, cast to the value type later by the caller."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * torch.sigmoid(s) * (1.0 / n)
    return torch.where(_keep_mask(nonpad, q), s, torch.zeros((), device=s.device))


def _attn_bwd_math(q, k, v, g, nonpad, n: int):
    """dq, dk, dv of ``(mask ⊙ silu(q kᵀ)/n) v`` over [..., L, d] heads, in
    the JAX kernels' order (``_bwd_kernel_v2``, hstu_attention_tpu.py:223-253):
    A rounded to v's type and ds to q's before the gradient products, which
    are summed in f32."""
    x = torch.matmul(q.float(), k.float().transpose(-1, -2))
    sig = torch.sigmoid(x)
    keep = _keep_mask(nonpad, q)
    zero = torch.zeros((), device=x.device)
    a = torch.where(keep, x * sig * (1.0 / n), zero).to(v.dtype)
    dv = torch.matmul(a.float().transpose(-1, -2), g.float()).to(v.dtype)
    da = torch.matmul(g.float(), v.float().transpose(-1, -2))
    dsilu = sig * (1.0 + x * (1.0 - sig))
    ds = torch.where(keep, da * dsilu * (1.0 / n), zero).to(q.dtype)
    dq = torch.matmul(ds.float(), k.float()).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()).to(k.dtype)
    return dq, dk, dv


# ----------------------------------------------------------------------------
# Kernel A: fused STU block, forward and backward
# ----------------------------------------------------------------------------
def _split_heads(t, H: int):
    B, L, F = t.shape
    return t.reshape(B, L, H, F // H).transpose(1, 2)


def _stu_attention_rows(q, k, v, nonpad, H: int):
    """The fused block's concatenated attention rows [B, L, H·dv] in f32."""
    B, L, F = v.shape
    s = _masked_silu_scores(_split_heads(q, H), _split_heads(k, H), nonpad, L).to(v.dtype)
    return torch.matmul(s.float(), _split_heads(v, H).float()).transpose(1, 2).reshape(B, L, F)


def hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, num_heads: int,
                             eps: float = 1e-6):
    """Plain version of the fused STU forward kernel (the math of the JAX
    kernel ``_fwd_gated_kernel``, hstu_attention_tpu.py:378-409)."""
    attn = _stu_attention_rows(q, k, v, nonpad, num_heads)
    mu = attn.mean(-1, keepdim=True)
    var = (attn - mu).square().mean(-1, keepdim=True)
    xhat = (attn - mu) * torch.rsqrt(var + eps)
    y = xhat * gamma.float() + beta.float()
    return (u.float() * y).to(q.dtype)


def _stu_gated_fwd_launch(q, k, v, u, gamma, beta, nonpad, num_heads: int, eps: float,
                         form=None):
    name, H = "hstu_stu_gated_fwd", num_heads
    cluster = (q.dtype == torch.float32  # a form the shape cannot take fails on every device
               and _pick_f32_form(name, form, q, v, H, False) == "cluster")
    if q.device.type == "cpu":
        return hstu_stu_gated_fwd_plain(q, k, v, u, gamma, beta, nonpad, num_heads, eps)
    _check_cuda_inputs(name, (q, k, v, u), nonpad)
    B, L, H, dqk, dv = _check_gated_inputs(name, q, k, v, u, gamma, beta, nonpad, num_heads)
    code = _DTYPES[q.dtype]
    if stu_gated_fwd_route(q.dtype, L, H, dqk, dv) == "tensor_cores":
        code = 2
    if cluster or code == 2:  # their 16-byte copies
        q, k, v, u, gamma, beta = (cuda_build.aligned16(t) for t in (q, k, v, u, gamma, beta))
    out = torch.empty((B, L, H * dv), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), nonpad.data_ptr(), out.data_ptr(), B, L, H, dqk, dv,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), u.stride(0), u.stride(1), 1.0 / L, eps)
    if cluster:
        fn = _lib("hstu_stu_f32_fwd", [_P] * 8 + [_I] * 5 + [_LL] * 8 + [_F, _F, _P],
                  "hstu_stu_f32")
        err = fn(*args, _stream(q))
    else:
        fn = _lib(name, [_P] * 8 + [_I] * 5 + [_LL] * 8 + [_F, _F, _I, _P])
        err = fn(*args, code, _stream(q))
    _launch_error(name, err)
    hstu_stu_gated_fwd.launches += 1
    return out


def hstu_stu_gated_bwd_plain(q, k, v, u, gamma, beta, nonpad, g, num_heads: int,
                             eps: float = 1e-6):
    """Plain version of ``hstu_stu_gated_bwd`` (the math of the JAX kernel
    ``_bwd_gated_kernel``, hstu_attention_tpu.py:412-485, with the dγ/dβ
    partials summed as ``_bwd_gated`` does)."""
    H = num_heads
    B, L, F = v.shape
    attn = _stu_attention_rows(q, k, v, nonpad, H)
    mu = attn.mean(-1, keepdim=True)
    var = (attn - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (attn - mu) * inv
    gf, gam, bet = g.float(), gamma.float(), beta.float()
    dy = u.float() * gf
    du = ((xhat * gam + bet) * gf).to(u.dtype)
    dgamma = (dy * xhat).sum((0, 1)).to(gamma.dtype)
    dbeta = dy.sum((0, 1)).to(beta.dtype)
    dxhat = dy * gam
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dattn = ((dxhat - m1 - xhat * m2) * inv).to(v.dtype)
    dq, dk, dv = _attn_bwd_math(_split_heads(q, H), _split_heads(k, H), _split_heads(v, H),
                                _split_heads(dattn, H), nonpad, L)

    def flat(t):
        return t.transpose(1, 2).reshape(B, L, -1)

    return flat(dq), flat(dk), flat(dv), du, dgamma, dbeta


def hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, num_heads: int,
                       eps: float = 1e-6, route=None, form=None):
    """Gradients (dq, dk, dv, du, dγ, dβ) of ``hstu_stu_gated_fwd`` given its
    output gradient g [B, L, H·dv]. dq, dk, dv, du come back contiguous in
    the inputs' dtype, dγ and dβ in float32. One call is one launch of the
    backward kernel (one cluster kernel, or two steps on one stream,
    ``csrc/hstu_stu_gated_bwd.cu``). ``route``: None takes
    ``stu_gated_bwd_route``; "cuda_cores" runs the CUDA-core kernels on
    bfloat16 too (to time the two designs side by side). ``form`` (float32):
    None takes ``stu_gated_f32_form``; "query_tiles" runs the query-tile
    kernels where the cluster form would (to time the two side by side)."""
    name = "hstu_stu_gated_bwd"
    H = num_heads
    route = _pick_route(name, route, stu_gated_bwd_route(q.dtype, q.shape[1], H,
                                                         q.shape[-1] // H, v.shape[-1] // H))
    cluster = (q.dtype == torch.float32  # a form the shape cannot take fails on every device
               and _pick_f32_form(name, form, q, v, H, True) == "cluster")
    if q.device.type == "cpu":
        return hstu_stu_gated_bwd_plain(q, k, v, u, gamma, beta, nonpad, g, num_heads, eps)
    g = g.contiguous()
    _check_cuda_inputs(name, (q, k, v, u, g), nonpad)
    B, L, H, dqk, dv = _check_gated_inputs(name, q, k, v, u, gamma, beta, nonpad, num_heads)
    _check(g.shape == v.shape, f"{name}: g{tuple(g.shape)} must be shaped as v{tuple(v.shape)}")
    code = 2 if route == "tensor_cores" else _DTYPES[q.dtype]
    if cluster or code == 2:  # their 16-byte copies
        q, k, v, u, gamma, beta, g = (cuda_build.aligned16(t)
                                      for t in (q, k, v, u, gamma, beta, g))
    F, Fq = H * dv, H * dqk
    dq, dk = (torch.empty((B, L, Fq), dtype=q.dtype, device=q.device) for _ in range(2))
    dvv, du = (torch.empty((B, L, F), dtype=q.dtype, device=q.device) for _ in range(2))
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                      v.stride(0), v.stride(1), u.stride(0), u.stride(1))
    ptrs = [t.data_ptr() for t in (q, k, v, u, gamma, beta, nonpad, g, dq, dk, dvv, du)]
    if cluster:  # no dattn round trip; dγ, dβ partials a batch row
        parts = torch.empty((2, B, F), dtype=torch.float32, device=q.device)
        fn = _lib("hstu_stu_f32_bwd", [_P] * 14 + [_I] * 5 + [_LLP] + [_F, _F, _P],
                  "hstu_stu_f32")
        err = fn(*ptrs, parts[0].data_ptr(), parts[1].data_ptr(), B, L, H, dqk, dv, strides,
                 1.0 / L, eps, _stream(q))
    else:
        dattn = torch.empty((B, L, F), dtype=q.dtype, device=q.device)
        parts = torch.empty((2, B * -(-L // _TQ), F), dtype=torch.float32, device=q.device)
        fn = _lib(name, [_P] * 15 + [_I] * 5 + [_LLP] + [_F, _F, _I, _P])
        err = fn(*ptrs, dattn.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), B, L, H,
                 dqk, dv, strides, 1.0 / L, eps, code, _stream(q))
    _launch_error(name, err)
    hstu_stu_gated_bwd.launches += 1
    dgamma, dbeta = parts.sum(1)
    return dq, dk, dvv, du, dgamma, dbeta


hstu_stu_gated_bwd.launches = 0


class _StuGated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, u, gamma, beta, nonpad, num_heads, eps, form):
        ctx.save_for_backward(q, k, v, u, gamma, beta, nonpad)
        ctx.num_heads, ctx.eps, ctx.form = num_heads, eps, form
        return _stu_gated_fwd_launch(q, k, v, u, gamma, beta, nonpad, num_heads, eps, form)

    @staticmethod
    def backward(ctx, g):
        q, k, v, u, gamma, beta, nonpad = ctx.saved_tensors
        form = None if ctx.form is None or q.dtype != torch.float32 else ctx.form
        grads = hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, ctx.num_heads, ctx.eps,
                                   form=form)
        return (*grads, None, None, None, None)


def hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, num_heads: int,
                       eps: float = 1e-6, form=None):
    """``u ⊙ LayerNorm(concat_h(mask ⊙ silu(q_h k_hᵀ)/L · v_h))``.

    q, k [B, L, H·dqk]; v, u [B, L, H·dv] — row-strided views (e.g. the
    splits of the uvqk projection) are taken without copies; gamma, beta
    [H·dv] float32; nonpad [B, L] bool. Returns [B, L, H·dv] in q's dtype.
    Differentiable in q, k, v, u, gamma and beta through
    ``hstu_stu_gated_bwd``; ``.launches`` counts the forward kernel.
    ``form`` (float32 on the card): None takes ``stu_gated_f32_form``;
    "query_tiles" runs the query-tile kernels, forward and backward, where
    the cluster form would (to time the two side by side).
    """
    return _StuGated.apply(q, k, v, u, gamma, beta, nonpad, num_heads, eps, form)


hstu_stu_gated_fwd.launches = 0


# ----------------------------------------------------------------------------
# Kernel B: pointwise attention over [B, H, L, d], forward and backward
# ----------------------------------------------------------------------------
def hstu_attn_fwd_plain(q, k, v, nonpad):
    """Plain version of the pointwise attention forward kernel (the math of
    the JAX kernel ``_fwd_kernel_v2``, hstu_attention_tpu.py:201-220)."""
    s = _masked_silu_scores(q, k, nonpad, q.shape[-2]).to(v.dtype)
    return torch.matmul(s.float(), v.float()).to(q.dtype)


def _check_attn_inputs(name, tensors, nonpad):
    q, k, v = tensors[:3]
    _check_cuda_inputs(name, tensors, nonpad)
    B, H, L, dqk = q.shape
    dv = v.shape[-1]
    _check(k.shape == q.shape and v.shape[:3] == (B, H, L),
           f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    _check(dqk <= _MAX_D and dv <= _MAX_D, f"{name}: head widths above {_MAX_D}")
    _check(1 <= B <= 65535 and 1 <= H <= 65535, f"{name}: grid ({B}, {H}) out of range")
    _check(nonpad.shape == (B, L), f"{name}: nonpad must be [{B}, {L}]")
    return B, H, L, dqk, dv


def _attn_fwd_launch(q, k, v, nonpad, route=None):
    name = "hstu_attn_fwd"
    route = _pick_route(name, route, attn_fwd_route(q.dtype, *q.shape[-2:], v.shape[-1]))
    if q.device.type == "cpu":
        return hstu_attn_fwd_plain(q, k, v, nonpad)
    B, H, L, dqk, dv = _check_attn_inputs(name, (q, k, v), nonpad)
    code = _DTYPES[q.dtype]
    if route == "tensor_cores":
        q, k, v = (cuda_build.aligned16(t) for t in (q, k, v))
        code = 2
    fn = _lib(name, [_P] * 5 + [_I] * 5 + [_LL] * 9 + [_F, _I, _P])
    out = torch.empty((B, H, L, dv), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), nonpad.data_ptr(), out.data_ptr(),
             B, H, L, dqk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             1.0 / L, code, _stream(q))
    _launch_error(name, err)
    hstu_attn_fwd.launches += 1
    return out


def hstu_attn_bwd_plain(q, k, v, g, nonpad):
    """Plain version of ``hstu_attn_bwd`` (the math of the JAX kernel
    ``_bwd_kernel_v2``, hstu_attention_tpu.py:223-253)."""
    return _attn_bwd_math(q, k, v, g, nonpad, q.shape[-2])


def hstu_attn_bwd(q, k, v, g, nonpad, route=None):
    """Gradients (dq, dk, dv) of ``hstu_attn_fwd`` given its output gradient
    g [B, H, L, dv]; inputs at any strides with a contiguous last dim,
    gradients contiguous [B, H, L, d] in the inputs' dtype. ``route``: None
    takes ``attn_bwd_route``; "cuda_cores" runs the CUDA-core kernels on
    bfloat16 too (to time the two designs side by side)."""
    name = "hstu_attn_bwd"
    route = _pick_route(name, route, attn_bwd_route(q.dtype, *q.shape[-2:], v.shape[-1]))
    if q.device.type == "cpu":
        return hstu_attn_bwd_plain(q, k, v, g, nonpad)
    B, H, L, dqk, dv = _check_attn_inputs(name, (q, k, v, g), nonpad)
    _check(g.shape == v.shape, f"{name}: g{tuple(g.shape)} must be shaped as v{tuple(v.shape)}")
    code = _DTYPES[q.dtype]
    if route == "tensor_cores":
        q, k, v, g = (cuda_build.aligned16(t) for t in (q, k, v, g))
        code = 2
    fn = _lib(name, [_P] * 8 + [_I] * 5 + [_LLP] + [_F, _I, _P])
    dq, dk = (torch.empty((B, H, L, dqk), dtype=q.dtype, device=q.device) for _ in range(2))
    dvv = torch.empty((B, H, L, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, g, dq, dk, dvv)
                                         for s in t.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), nonpad.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), B, H, L, dqk, dv, strides,
             1.0 / L, code, _stream(q))
    _launch_error(name, err)
    hstu_attn_bwd.launches += 1
    return dq, dk, dvv


hstu_attn_bwd.launches = 0


class _Attn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, nonpad, route):
        ctx.save_for_backward(q, k, v, nonpad)
        return _attn_fwd_launch(q, k, v, nonpad, route)

    @staticmethod
    def backward(ctx, g):
        q, k, v, nonpad = ctx.saved_tensors
        return (*hstu_attn_bwd(q, k, v, g, nonpad), None, None)


def hstu_attn_fwd(q, k, v, nonpad, route=None):
    """q, k [B, H, L, dqk], v [B, H, L, dv] (any strides with a contiguous
    last dim), nonpad [B, L] bool → [B, H, L, dv] in q's dtype.
    Differentiable in q, k, v through ``hstu_attn_bwd``; ``.launches``
    counts the forward kernel. ``route``: None takes ``attn_fwd_route``;
    "cuda_cores" runs the CUDA-core kernel on bfloat16 too (to time the two
    designs side by side)."""
    return _Attn.apply(q, k, v, nonpad, route)


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
