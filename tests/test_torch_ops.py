"""The port's HSTU attention ops (``mhrec_tpu_torch/ops``) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On CPU tensors every kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (the arithmetic the CUDA kernels repeat) to the
Pallas kernels #1-#3 (``_fwd_gated``, ``_fwd_v2``, ``_fwd``). Both sides
compute in float32 and differ only in the order of sums: rtol/atol 2e-5.
The CUDA kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.ops.hstu_attention import hstu_attention_xla
from mhrec_tpu.ops.pallas.hstu_attention_tpu import (
    hstu_attention_gated_pallas,
    hstu_attention_pallas,
    hstu_attention_pallas_v2,
)
from mhrec_tpu_torch.ops import cuda_build
from mhrec_tpu_torch.ops import hstu_attention_cuda as K
from mhrec_tpu_torch.ops.hstu_attention import attention_mask, hstu_attention

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _nonpad(B, L, rng):
    """Left-padded rows as eval builds them: row 0 full, row 1 a third pad,
    row 2 (if any) all padding, the rest random."""
    keep = np.ones((B, L), bool)
    if B > 1:
        keep[1, : L // 3] = False
    if B > 2:
        keep[2] = False
    for b in range(3, B):
        keep[b, : rng.integers(0, L)] = False
    return keep


def _jax_mask(nonpad):
    L = nonpad.shape[1]
    return jnp.asarray(nonpad[:, None, None, :] & np.tril(np.ones((L, L), bool))[None, None])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "B,L",
    [
        (2, 20),  # JAX's short-L row-packed mode, seg=32
        (3, 50),  # seg=64, odd B (the size4 window), with an all-pad row
        (2, 70),  # JAX's unpacked mode (L > 64)
    ],
)
def test_stu_gated_plain_matches_pallas(B, L):
    D, h = 128, 2
    rng = np.random.default_rng(0)
    q, k, v, u = (rng.normal(size=(B, L, D)).astype(np.float32) * 0.5 for _ in range(4))
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    beta = (0.05 * rng.normal(size=(D,))).astype(np.float32)
    nonpad = _nonpad(B, L, rng)

    ref = hstu_attention_gated_pallas(
        *map(jnp.asarray, (q, k, v, u, gamma, beta)), _jax_mask(nonpad), h, interpret=True
    )
    args = (_t(q), _t(k), _t(v), _t(u), _t(gamma), _t(beta), _t(nonpad), h)
    out = K.hstu_stu_gated_fwd(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(out, K.hstu_stu_gated_fwd_plain(*args))
    if B > 2:
        # a row with no key at all attends to nothing: LN(0) = β, out = u·β
        np.testing.assert_allclose(out[2].numpy(), u[2] * beta, **TOL)


def test_stu_gated_plain_takes_strided_uvqk_splits():
    """The STU layer hands the kernel row-strided splits of one projection;
    the result must not depend on the layout."""
    B, L, D, h = 2, 12, 128, 2
    rng = np.random.default_rng(1)
    mixed = _t(rng.normal(size=(B, L, 4 * D)).astype(np.float32))
    u, v, q, k = torch.split(mixed, [D] * 4, dim=-1)
    gamma, beta = torch.ones(D), torch.zeros(D)
    nonpad = _t(_nonpad(B, L, rng))
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, h)
    dense = K.hstu_stu_gated_fwd(*(x.contiguous() for x in (q, k, v, u)), gamma, beta, nonpad, h)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("B,L,H,d", [(2, 10, 4, 8), (3, 70, 2, 16)])
def test_attention_v2_plain_matches_pallas_v2(B, L, H, d):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(B, L, H, d)).astype(np.float32) for _ in range(3))
    nonpad = _nonpad(B, L, rng)
    ref = hstu_attention_pallas_v2(*map(jnp.asarray, (q, k, v)), _jax_mask(nonpad), interpret=True)
    out = K.hstu_attention_v2(_t(q), _t(k), _t(v), _t(nonpad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the dispatcher's 'pallas' choice is this wrapper
    via = hstu_attention(_t(q), _t(k), _t(v), _t(nonpad), impl="pallas")
    assert torch.equal(via, out)


def test_attention_bhld_plain_matches_pallas_v1():
    """Kernel #3 (``hstu_attention_pallas``, [B·H, L, d] programs) through
    the layout wrapper over the pointwise kernel."""
    B, L, H, d = 2, 70, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, L, H, d)).astype(np.float32) for _ in range(3))
    nonpad = rng.random((B, L)) > 0.25
    nonpad[:, -1] = True
    ref = hstu_attention_pallas(*map(jnp.asarray, (q, k, v)), _jax_mask(nonpad), interpret=True)

    def bhld(x):
        return _t(x.transpose(0, 2, 1, 3).reshape(B * H, L, -1))

    np_bh = _t(np.repeat(nonpad, H, axis=0))
    out = K.hstu_attention_bhld(bhld(q), bhld(k), bhld(v), np_bh)
    out = out.reshape(B, H, L, d).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_attention_matches_xla(with_bias):
    B, L, H, d = 2, 9, 2, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(B, L, H, d)).astype(np.float32) for _ in range(3))
    nonpad = _nonpad(B, L, rng)
    bias = rng.normal(size=(1, L, L)).astype(np.float32) if with_bias else None
    ref = hstu_attention_xla(
        *map(jnp.asarray, (q, k, v)), _jax_mask(nonpad),
        None if bias is None else jnp.asarray(bias),
    )
    out = hstu_attention(_t(q), _t(k), _t(v), _t(nonpad), impl="xla",
                         bias=None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(attention_mask(_t(nonpad)).numpy(), np.asarray(_jax_mask(nonpad)))


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(2)
    B, L, H, d = 2, 6, 2, 64
    q, k, v = (_t(rng.normal(size=(B, H, L, d)).astype(np.float32)) for _ in range(3))
    nonpad = _t(_nonpad(B, L, rng))
    before = (K.hstu_attn_fwd.launches, K.hstu_stu_gated_fwd.launches)
    assert torch.equal(K.hstu_attn_fwd(q, k, v, nonpad), K.hstu_attn_fwd_plain(q, k, v, nonpad))
    flat = [x.transpose(1, 2).reshape(B, L, H * d) for x in (q, k, v, v)]
    g, b = torch.ones(H * d), torch.zeros(H * d)
    assert torch.equal(K.hstu_stu_gated_fwd(*flat, g, b, nonpad, H),
                       K.hstu_stu_gated_fwd_plain(*flat, g, b, nonpad, H))
    assert (K.hstu_attn_fwd.launches, K.hstu_stu_gated_fwd.launches) == before


def _meta_stu_inputs(B=2, L=8, F=128, dtype=torch.float32):
    m = torch.device("meta")
    q, k, v, u = (torch.empty(B, L, F, device=m, dtype=dtype) for _ in range(4))
    gamma = torch.empty(F, device=m)
    beta = torch.empty(F, device=m)
    nonpad = torch.empty(B, L, device=m, dtype=torch.bool)
    return [q, k, v, u, gamma, beta, nonpad, 2]


@pytest.mark.parametrize(
    "break_it, what",
    [
        (lambda a: a.__setitem__(0, a[0].half()), "dtype"),
        (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), "must be"),
        (lambda a: a.__setitem__(2, a[2][..., ::2]), "contiguous"),
        (lambda a: a.__setitem__(3, a[3][:, :4]), "disagree"),
        (lambda a: a.__setitem__(4, a[4].double()), "gamma"),
        (lambda a: a.__setitem__(6, a[6].int()), "nonpad"),
        (lambda a: a.__setitem__(7, 3), "divisible"),
    ],
)
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(break_it, what):
    args = _meta_stu_inputs()
    break_it(args)
    with pytest.raises(ValueError, match=what):
        K.hstu_stu_gated_fwd(*args)


def test_kernel_wrapper_refuses_rows_beyond_shared_memory():
    args = _meta_stu_inputs(F=4096)
    args[7] = 32
    with pytest.raises(ValueError, match="shared memory"):
        K.hstu_stu_gated_fwd(*args)


def test_cuda_paths_raise_without_a_card(monkeypatch, tmp_path):
    """Off the card a non-CPU tensor reaches the kernel's build, which
    raises: there is no quiet fallback to the plain version."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "NVCC_CANDIDATES", (str(tmp_path / "nvcc"),))
    before = K.hstu_stu_gated_fwd.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.hstu_stu_gated_fwd(*_meta_stu_inputs())
    m = torch.device("meta")
    x = torch.empty(2, 2, 8, 64, device=m)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.hstu_attn_fwd(x, x, x, torch.empty(2, 8, device=m, dtype=torch.bool))
    assert K.hstu_stu_gated_fwd.launches == before


def test_library_name_tracks_sources_and_flags(monkeypatch):
    a = cuda_build.library_path("hstu_attn_fwd")
    assert a.name.startswith("libhstu_attn_fwd-") and a.parent == cuda_build.BUILD_DIR
    assert a != cuda_build.library_path("hstu_stu_gated_fwd")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("hstu_attn_fwd") != a


# ----------------------------------------------------------------------------
# backward kernels #4-#6: the plain backward versions (what the CUDA kernels
# compute) against jax.vjp of the Pallas kernels in interpret mode. Gradients
# of the attention inputs to 2e-5; dγ and dβ, sums over every row, to 1e-4.
# ----------------------------------------------------------------------------
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
AFFINE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,L,H,d,route", [
    (torch.bfloat16, 50, 16, 64, "tensor_cores"),    # size4, serving and training
    (torch.bfloat16, 400, 8, 64, "tensor_cores"),    # merrec
    (torch.bfloat16, 50, 32, 64, "tensor_cores"),    # hstu-1b, F = 2048
    (torch.bfloat16, 50, 4, 32, "tensor_cores"),     # size1
    (torch.bfloat16, 50, 16, 128, "tensor_cores"),
    (torch.bfloat16, 50, 4, 12, "cuda_cores"),       # a width the 16-byte copies cannot take
    (torch.bfloat16, 50, 18, 128, "cuda_cores"),     # F = 2304 at width 128: rows too wide
    (torch.float32, 50, 16, 64, "cuda_cores"),
    (torch.float32, 1, 16, 64, "cuda_cores"),        # cluster form
    (torch.float32, 400, 8, 64, "cuda_cores"),       # query-tile form
    (torch.float32, 50, 32, 64, "cuda_cores"),       # F = 2048, cluster form
], ids=["size4", "merrec", "1b", "size1", "d128", "d12", "d128-F2304", "f32", "f32-L1",
        "f32-merrec", "f32-F2048"])
def test_stu_gated_fwd_route(dtype, L, H, d, route):
    """bfloat16 takes the tensor-core kernel at every width the models build;
    the rest the CUDA-core kernel, which admits them (its shared memory)."""
    assert K.stu_gated_fwd_route(dtype, L, H, d, d) == route
    assert 4 * K._TQ * (H * d + 2) + K._head_smem_bytes(d, d) <= K._SMEM_LIMIT


@pytest.mark.parametrize("dtype,L,H,dqk,dv,route", [
    (torch.bfloat16, 50, 16, 64, 64, "tensor_cores"),    # size4, the train step (F = 1024)
    (torch.bfloat16, 400, 8, 64, 64, "tensor_cores"),    # merrec
    (torch.bfloat16, 50, 32, 64, 64, "tensor_cores"),    # hstu-1b, F = 2048
    (torch.bfloat16, 50, 4, 32, 32, "tensor_cores"),     # size1
    (torch.bfloat16, 70, 8, 128, 128, "tensor_cores"),   # d = 128, F = 1024
    (torch.bfloat16, 70, 8, 32, 64, "tensor_cores"),     # dqk != dv
    (torch.bfloat16, 50, 4, 12, 12, "cuda_cores"),       # a width the 16-byte copies cannot take
    (torch.bfloat16, 50, 4, 16, 12, "cuda_cores"),       # dv not a multiple of 8
    (torch.bfloat16, 50, 18, 128, 128, "cuda_cores"),    # F = 2304 at width 128: rows too wide
    (torch.float32, 50, 16, 64, 64, "cuda_cores"),
    (torch.float32, 50, 32, 64, 64, "cuda_cores"),       # F = 2048
    (torch.float32, 65, 16, 64, 64, "cuda_cores"),       # query-tile form
    (torch.float32, 50, 8, 32, 64, "cuda_cores"),        # dqk != dv, cluster form
], ids=["size4", "merrec", "1b", "size1", "d128", "dqk32-dv64", "d12", "dv12", "d128-F2304",
        "f32", "f32-F2048", "f32-L65", "f32-dqk32-dv64"])
def test_stu_gated_bwd_route(dtype, L, H, dqk, dv, route):
    """bfloat16 takes the tensor-core backward at every width the models
    build; the rest the CUDA-core kernels, which admit them (their shared
    memory)."""
    assert K.stu_gated_bwd_route(dtype, L, H, dqk, dv) == route
    assert 4 * K._TQ * (H * dv + 2) + K._head_smem_bytes(dqk, dv) <= K._SMEM_LIMIT


# The float32 forms of #1 / #4 at the models' shapes (L, H, dqk, dv): the
# form, the cluster (blocks, heads a block), each direction's shared memory,
# reckoned by hand from csrc/hstu_stu_cluster.cuh — 512 floats of
# statistics, score tiles of 64 × 68, q/k/v tiles of round8(L) rows at
# pitch 68 (width 64), 36 (width 32) or 20 (width 16) — and the blocks an
# SM's shared memory holds (228 KB, 1 KB reserved a block).
F32_FORMS = {
    # ComiRec / REMI's trunk (hstu-size4): two blocks an SM both ways
    "size4": ((50, 16, 64, 64), "cluster", "cluster", (8, 2),
              4 * (512 + 2 * 3 * 56 * 68), 4 * (512 + 2 * 4352 + 3 * 56 * 68 + 56 * 132),
              (2, 2)),
    # q tiles of pitch 36 cannot hold 56 score columns: a score tile of their own
    "size1": ((50, 4, 32, 32), "cluster", "cluster", (4, 1),
              4 * (512 + 4352 + 3 * 56 * 36), 4 * (512 + 2 * 4352 + 3 * 56 * 36 + 56 * 36),
              (5, 3)),
    "size2": ((50, 8, 32, 32), "cluster", "cluster", (8, 1),
              4 * (512 + 4352 + 3 * 56 * 36), 4 * (512 + 2 * 4352 + 3 * 56 * 36 + 56 * 36),
              (5, 3)),
    # 512 / 12 = 42: not a multiple of 4, the 16-byte copies cannot take it
    "size3": ((50, 12, 42, 42), "query_tiles", "query_tiles", (6, 2), None, None, None),
    "1b": ((50, 32, 64, 64), "cluster", "cluster", (8, 4),
           4 * (512 + 4 * 3 * 56 * 68), 4 * (512 + 2 * 4352 + 3 * 56 * 68 + 56 * 260),
           (1, 1)),
    "L1": ((1, 16, 64, 64), "cluster", "cluster", (8, 2),
           4 * (512 + 2 * 3 * 8 * 68), 4 * (512 + 2 * 4352 + 3 * 8 * 68 + 8 * 132),
           (14, 4)),
    "L65": ((65, 16, 64, 64), "query_tiles", "query_tiles", (8, 2), None, None, None),
    "L400": ((400, 8, 64, 64), "query_tiles", "query_tiles", (8, 1), None, None, None),
    # heads of 16: q tiles too narrow for the scores, a score tile for each of
    # the two heads a block works on at once
    "H32-d16": ((64, 32, 16, 16), "cluster", "cluster", (8, 4),
                4 * (512 + 2 * 4352 + 4 * 3 * 64 * 20),
                4 * (512 + 2 * 4352 + 3 * 64 * 20 + 64 * 68), (2, 3)),
    # heads of 128 at a full window: the forward's two score tiles do not fit
    "L64-d128": ((64, 16, 128, 128), "query_tiles", "cluster", (8, 2),
                 None, 4 * (512 + 2 * 4352 + 3 * 64 * 132 + 64 * 260), None),
}


@pytest.mark.parametrize("name", list(F32_FORMS))
def test_stu_gated_f32_form(name):
    (L, H, dqk, dv), fwd, bwd, cluster, fwd_bytes, bwd_bytes, per_sm = F32_FORMS[name]
    assert K.stu_gated_f32_form(L, H, dqk, dv) == fwd
    assert K.stu_gated_f32_form(L, H, dqk, dv, backward=True) == bwd
    assert K.stu_f32_cluster(H) == cluster
    C, hb = cluster
    assert C <= 8 and (C - 1) * hb < H <= C * hb  # every head in one block, none empty
    if bwd_bytes is not None:
        assert K._stu_cluster_smem_bytes(L, H, dqk, dv, True) == bwd_bytes <= K._SMEM_LIMIT
    if fwd_bytes is None:
        return
    got = (K._stu_cluster_smem_bytes(L, H, dqk, dv, False), bwd_bytes)
    assert got[0] == fwd_bytes <= K._SMEM_LIMIT
    assert tuple(233472 // (b + 1024) for b in got) == per_sm


@pytest.mark.parametrize("form,L,match", [
    ("cluster", 65, "cluster form"),      # past 64 rows
    ("tiles", 50, "unknown float32 form"),
    ("query_tiles", 50, None),
    ("cluster", 50, None),
])
def test_cpu_call_checks_the_f32_form_as_the_card_does(form, L, match):
    """A float32 form the shape cannot take raises on CPU tensors too (forward
    and backward); one it can take runs the plain version."""
    rng = np.random.default_rng(3)
    B, H, d = 2, 2, 16
    q, k, v, u, g = (_t(rng.normal(size=(B, L, H * d)).astype(np.float32)) for _ in range(5))
    gam, bet = torch.ones(H * d), torch.zeros(H * d)
    nonpad = _t(_nonpad(B, L, rng))
    fwd = lambda: K.hstu_stu_gated_fwd(q, k, v, u, gam, bet, nonpad, H, form=form)  # noqa: E731
    bwd = lambda: K.hstu_stu_gated_bwd(q, k, v, u, gam, bet, nonpad, g, H, form=form)  # noqa: E731
    if match is not None:
        for call in (fwd, bwd):
            with pytest.raises(ValueError, match=match):
                call()
        return
    assert torch.equal(fwd(), K.hstu_stu_gated_fwd_plain(q, k, v, u, gam, bet, nonpad, H))
    for a, b in zip(bwd(), K.hstu_stu_gated_bwd_plain(q, k, v, u, gam, bet, nonpad, g, H)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,form,cluster", [(50, None, True), (50, "query_tiles", False),
                                            (65, None, False)])
def test_f32_wrappers_pass_the_form_to_the_kernels(monkeypatch, L, form, cluster):
    """What the float32 wrappers hand the C functions (meta tensors, the
    kernels replaced by a recorder): the cluster form's entry points of
    csrc/hstu_stu_f32.cu, the backward's with one dγ / dβ row a batch row
    and no dattn scratch, else the query-tile kernels' with dtype code 0;
    one launch counted a call."""
    calls = []

    def lib(name, argtypes, source=None):
        def fn(*args):
            calls.append((name, source, len(argtypes), args))
            return 0
        return fn

    monkeypatch.setattr(K, "_lib", lib)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(K.hstu_stu_gated_fwd, "launches", 0)
    monkeypatch.setattr(K.hstu_stu_gated_bwd, "launches", 0)
    B, H, d = 3, 16, 64
    m = torch.device("meta")
    q, k, v, u, g = (torch.empty(B, L, H * d, device=m) for _ in range(5))
    gamma, beta = torch.empty(H * d, device=m), torch.empty(H * d, device=m)
    nonpad = torch.empty(B, L, device=m, dtype=torch.bool)
    out = K.hstu_stu_gated_fwd(q, k, v, u, gamma, beta, nonpad, H, form=form)
    grads = K.hstu_stu_gated_bwd(q, k, v, u, gamma, beta, nonpad, g, H, form=form)
    assert out.shape == (B, L, H * d) and [t.shape for t in grads[4:]] == [(H * d,)] * 2
    (fname, fsrc, fn_args, fargs), (bname, bsrc, bn_args, bargs) = calls
    assert fn_args == len(fargs) and bn_args == len(bargs)
    if cluster:
        assert (fname, fsrc, bname, bsrc) == ("hstu_stu_f32_fwd", "hstu_stu_f32",
                                              "hstu_stu_f32_bwd", "hstu_stu_f32")
    else:
        assert (fname, fsrc, bname, bsrc) == ("hstu_stu_gated_fwd", None,
                                              "hstu_stu_gated_bwd", None)
        assert fargs[-2] == bargs[-2] == 0  # the float32 dtype code
    assert (K.hstu_stu_gated_fwd.launches, K.hstu_stu_gated_bwd.launches) == (1, 1)


@pytest.mark.parametrize("dtype,L,dqk,dv,route", [
    (torch.bfloat16, 50, 64, 64, "tensor_cores"),     # size4: one block a head
    (torch.bfloat16, 1, 32, 32, "tensor_cores"),
    (torch.bfloat16, 64, 128, 128, "tensor_cores"),   # the longest window one block holds
    (torch.bfloat16, 65, 128, 128, "tensor_cores"),   # two passes from here on
    (torch.bfloat16, 400, 64, 64, "tensor_cores"),    # merrec
    (torch.bfloat16, 50, 32, 64, "tensor_cores"),     # dqk != dv
    (torch.bfloat16, 50, 12, 12, "cuda_cores"),       # not a multiple of 8
    (torch.bfloat16, 50, 64, 136, "cuda_cores"),      # wider than 128
    (torch.float32, 50, 64, 64, "cuda_cores"),
    (torch.float32, 400, 128, 128, "cuda_cores"),
], ids=["size4", "L1", "L64-d128", "L65-d128", "merrec", "dqk32-dv64", "d12", "dv136",
        "f32", "f32-merrec"])
def test_attn_bwd_route(dtype, L, dqk, dv, route):
    assert K.attn_bwd_route(dtype, L, dqk, dv) == route


def test_backward_wrappers_refuse_a_route_the_inputs_cannot_take():
    """The tensor cores only where the route check admits the inputs (never
    float32); an unknown route name raises too. Asking for the CUDA cores is
    always allowed."""
    args = _meta_stu_inputs()
    g = torch.empty(2, 8, 128, device="meta")
    with pytest.raises(ValueError, match="tensor-core route"):
        K.hstu_stu_gated_bwd(*args[:7], g, 2, route="tensor_cores")
    x = torch.empty(2, 2, 8, 64, device="meta")
    nonpad = torch.empty(2, 8, device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="tensor-core route"):
        K.hstu_attn_bwd(x, x, x, x, nonpad, route="tensor_cores")
    with pytest.raises(ValueError, match="unknown route"):
        K.hstu_attn_bwd(x.to(torch.bfloat16), *[x.to(torch.bfloat16)] * 3, nonpad, route="tc")


@pytest.mark.parametrize("dtype,L,dqk,dv,route", [
    (torch.bfloat16, 50, 64, 64, "tensor_cores"),     # size4 and serving: one block a head
    (torch.bfloat16, 1, 32, 32, "tensor_cores"),
    (torch.bfloat16, 64, 128, 128, "tensor_cores"),   # the longest window one block holds
    (torch.bfloat16, 65, 128, 128, "tensor_cores"),   # 64-row query tiles from here on
    (torch.bfloat16, 400, 64, 64, "tensor_cores"),    # merrec
    (torch.bfloat16, 50, 32, 64, "tensor_cores"),     # dqk != dv
    (torch.bfloat16, 50, 12, 12, "cuda_cores"),       # not a multiple of 8
    (torch.bfloat16, 50, 64, 136, "cuda_cores"),      # wider than 128
    (torch.float32, 50, 64, 64, "cuda_cores"),
    (torch.float32, 400, 128, 128, "cuda_cores"),
], ids=["size4", "L1", "L64-d128", "L65-d128", "merrec", "dqk32-dv64", "d12", "dv136",
        "f32", "f32-merrec"])
def test_attn_fwd_route(dtype, L, dqk, dv, route):
    assert K.attn_fwd_route(dtype, L, dqk, dv) == route


def test_attn_fwd_refuses_a_route_the_inputs_cannot_take():
    """The tensor cores only where ``attn_fwd_route`` admits the inputs
    (never float32); an unknown route name raises; the CUDA cores are
    always allowed."""
    x = torch.empty(2, 2, 8, 64, device="meta")
    nonpad = torch.empty(2, 8, device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="tensor-core route"):
        K.hstu_attn_fwd(x, x, x, nonpad, route="tensor_cores")
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="unknown route"):
        K.hstu_attn_fwd(xb, xb, xb, nonpad, route="tc")
    for dtype, dqk in ((torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 12)):
        auto = K.attn_fwd_route(dtype, 8, dqk, dqk)
        assert K._pick_route("hstu_attn_fwd", "cuda_cores", auto) == "cuda_cores"
        assert K._pick_route("hstu_attn_fwd", None, auto) == auto


@pytest.mark.parametrize("route", [None, "tensor_cores", "cuda_cores"])
def test_attn_fwd_cpu_call_with_a_route_runs_the_plain_version(route):
    """On CPU tensors a route the inputs admit is checked and then runs the
    plain version, bit for bit, with no launch counted."""
    B, L, H, d = 3, 20, 2, 16
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=(B, H, L, d)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    nonpad = _t(_nonpad(B, L, rng))
    before = K.hstu_attn_fwd.launches
    out = K.hstu_attn_fwd(q, k, v, nonpad, route=route)
    assert K.hstu_attn_fwd.launches == before
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, K.hstu_attn_fwd_plain(q, k, v, nonpad))


@pytest.mark.parametrize("wrapper", ["hstu_attn_fwd", "hstu_attn_bwd", "hstu_stu_gated_bwd"])
@pytest.mark.parametrize("route,dtype,match", [
    ("tc", torch.bfloat16, "unknown route"),
    ("tensor_cores", torch.float32, "tensor-core route"),
], ids=["unknown", "f32-tensor-cores"])
def test_cpu_call_checks_the_route_as_the_card_does(wrapper, route, dtype, match):
    """A route the inputs cannot take raises on CPU tensors too, before the
    plain version runs, so that a bad route name fails on every device."""
    B, L, H, d = 2, 8, 2, 16
    x = torch.zeros(B, H, L, d, dtype=dtype)
    nonpad = torch.ones(B, L, dtype=torch.bool)
    calls = {
        "hstu_attn_fwd": lambda: K.hstu_attn_fwd(x, x, x, nonpad, route=route),
        "hstu_attn_bwd": lambda: K.hstu_attn_bwd(x, x, x, x, nonpad, route=route),
        "hstu_stu_gated_bwd": lambda: K.hstu_stu_gated_bwd(
            *[x.reshape(B, L, H * d)] * 4, torch.ones(H * d), torch.zeros(H * d), nonpad,
            x.reshape(B, L, H * d), H, route=route),
    }
    with pytest.raises(ValueError, match=match):
        calls[wrapper]()


@pytest.mark.parametrize("mutant,caught", [
    ("drop-key-63", True),
    ("drop-tile-edge-keys", True),
    ("drop-keys-64-79", True),
    ("divide-by-448", True),
    ("one-ulp-up", False),
])
def test_smoke_tolerance_tells_a_dropped_key_from_rounding(mutant, caught):
    """``chip_smoke.py`` holds the bfloat16 pointwise attention to its plain
    version with atol relative to the output's scale. At merrec's window
    (L = 400, outputs about 0.1) that check rejects an output that leaves
    out keys at the edges of the kernel's 64-key tiles, or one 16-key
    block, or divides by the window padded to whole tiles (448, which a
    fixed atol of 2e-2 lets pass), and admits an output one bf16 ulp off
    everywhere (the rounding a sound kernel shows)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    B, L, H, d = 2, 400, 8, 64
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, L, d, generator=gen).mul_(0.5).to(torch.bfloat16)
               for _ in range(3))
    nonpad = torch.ones(B, L, dtype=torch.bool)
    nonpad[1, :150] = False
    ref = K.hstu_attn_fwd_plain(q, k, v, nonpad)
    if mutant == "one-ulp-up":
        out = torch.nextafter(ref, torch.full_like(ref, float("inf")))
    elif mutant == "divide-by-448":
        a = K._masked_silu_scores(q, k, nonpad, 448)
        out = torch.matmul(a.to(v.dtype).float(), v.float()).to(q.dtype)
    else:
        dropped = {"drop-key-63": [63], "drop-tile-edge-keys": list(range(63, L, 64)),
                   "drop-keys-64-79": list(range(64, 80))}[mutant]
        a = K._masked_silu_scores(q, k, nonpad, L).clone()
        a[..., dropped] = 0
        out = torch.matmul(a.to(v.dtype).float(), v.float()).to(q.dtype)
    _, excess = chip_smoke.excess_error(out, ref, "bfloat16", scaled=True)
    assert (excess > 0) == caught


@pytest.mark.parametrize("B,L", [(3, 50), (2, 70)])
def test_attention_v2_bf16_plain_matches_pallas_v2(B, L):
    """In bfloat16 the plain version (which the tensor-core route repeats)
    rounds where ``_fwd_kernel_v2`` does: A once to bf16 before A·v, the
    output once. The two differ only in the order of f32 sums, which can
    move an A entry or an output by one bf16 ulp (2^-8 relative)."""
    H, d = 2, 16
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(B, L, H, d)).astype(np.float32) for _ in range(3))
    nonpad = _nonpad(B, L, rng)
    ref = hstu_attention_pallas_v2(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                   _jax_mask(nonpad), interpret=True)
    out = K.hstu_attention_v2(*(_t(x).to(torch.bfloat16) for x in (q, k, v)), _t(nonpad))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_aligned16_copies_only_rows_that_miss_16_bytes():
    from mhrec_tpu_torch.ops.cuda_build import aligned16

    mixed = torch.zeros(2, 5, 4 * 64, dtype=torch.bfloat16)
    q = mixed[..., 128:192]  # a split of the uvqk projection: aligned rows
    assert aligned16(q) is q
    heads = mixed.unflatten(-1, (-1, 16))[:, :, 8:12]  # [C, S, H, dh] views of a projection
    assert aligned16(heads) is heads
    flat = torch.zeros(2 * 5 * 64 + 4, dtype=torch.bfloat16)[4:].view(2, 5, 64)
    moved = aligned16(flat)  # 8 bytes past a 16-byte boundary: copied
    assert moved.data_ptr() % 16 == 0 and moved.is_contiguous() and torch.equal(moved, flat)
    gamma = torch.ones(68)[4:]
    assert aligned16(gamma) is gamma


@pytest.mark.parametrize("B,L", [(2, 20), (3, 50), (2, 70)])
def test_stu_gated_bwd_plain_matches_pallas(B, L):
    import jax

    D, h = 128, 2
    rng = np.random.default_rng(7)
    q, k, v, u = (rng.normal(size=(B, L, D)).astype(np.float32) * 0.5 for _ in range(4))
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    beta = (0.05 * rng.normal(size=(D,))).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    nonpad = _nonpad(B, L, rng)
    mask = _jax_mask(nonpad)
    _, vjp = jax.vjp(lambda *a: hstu_attention_gated_pallas(*a, mask, h, interpret=True),
                     *map(jnp.asarray, (q, k, v, u, gamma, beta)))
    ref = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v, u, gamma, beta)]
    before = K.hstu_stu_gated_bwd.launches
    K.hstu_stu_gated_fwd(*leaves, _t(nonpad), h).backward(_t(g))
    assert K.hstu_stu_gated_bwd.launches == before  # CPU tensors: the plain version
    for i, (name, leaf) in enumerate(zip(("dq", "dk", "dv", "du", "dgamma", "dbeta"), leaves)):
        tol = AFFINE_TOL if i >= 4 else GRAD_TOL
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref[i]), err_msg=name, **tol)
    if B > 2:
        # the all-pad row: no key reaches it, so only u and β see its gradient
        for leaf in leaves[:3]:
            assert not leaf.grad[2].any()


@pytest.mark.parametrize("B,L", [(2, 20), (3, 50), (2, 70)])
def test_attention_v2_bwd_plain_matches_pallas_v2(B, L):
    import jax

    H, d = 2, 16
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.normal(size=(B, L, H, d)).astype(np.float32) for _ in range(4))
    nonpad = _nonpad(B, L, rng)
    mask = _jax_mask(nonpad)
    _, vjp = jax.vjp(lambda *a: hstu_attention_pallas_v2(*a, mask, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    hstu_attention(*leaves, _t(nonpad), impl="pallas").backward(_t(g))
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)
    if B > 2:
        assert not any(leaf.grad[2].any() for leaf in leaves)  # fully padded row


def test_attention_bhld_bwd_plain_matches_pallas_v1():
    """Kernel #6 (``_bwd`` behind ``hstu_attention_pallas``) through the
    layout wrapper's autograd over the pointwise backward."""
    import jax

    B, L, H, d = 2, 50, 2, 16
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.normal(size=(B, L, H, d)).astype(np.float32) for _ in range(4))
    nonpad = rng.random((B, L)) > 0.25
    nonpad[:, -1] = True
    _, vjp = jax.vjp(lambda *a: hstu_attention_pallas(*a, _jax_mask(nonpad), interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))

    def bhld(x):
        return _t(x.transpose(0, 2, 1, 3).reshape(B * H, L, -1))

    leaves = [bhld(x).requires_grad_(True) for x in (q, k, v)]
    out = K.hstu_attention_bhld(*leaves, _t(np.repeat(nonpad, H, axis=0)))
    out.backward(bhld(g))
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        mine = leaf.grad.reshape(B, H, L, d).transpose(1, 2).numpy()
        np.testing.assert_allclose(mine, np.asarray(r), err_msg=name, **GRAD_TOL)


def test_backward_wrappers_on_cpu_run_the_plain_versions():
    rng = np.random.default_rng(4)
    B, L, H, d = 2, 9, 2, 64
    q, k, v, g = (_t(rng.normal(size=(B, H, L, d)).astype(np.float32)) for _ in range(4))
    nonpad = _t(_nonpad(B, L, rng))
    before = (K.hstu_attn_bwd.launches, K.hstu_stu_gated_bwd.launches)
    for a, b in zip(K.hstu_attn_bwd(q, k, v, g, nonpad), K.hstu_attn_bwd_plain(q, k, v, g, nonpad)):
        assert torch.equal(a, b)
    flat = [x.transpose(1, 2).reshape(B, L, H * d) for x in (q, k, v, v, g)]
    gam, bet = torch.ones(H * d), torch.zeros(H * d)
    args = (*flat[:4], gam, bet, nonpad, flat[4], H)
    for a, b in zip(K.hstu_stu_gated_bwd(*args), K.hstu_stu_gated_bwd_plain(*args)):
        assert torch.equal(a, b)
    assert (K.hstu_attn_bwd.launches, K.hstu_stu_gated_bwd.launches) == before


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    args = _meta_stu_inputs()
    g = torch.empty(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="shaped as v"):
        K.hstu_stu_gated_bwd(*args[:7], g, 2)
    x = torch.empty(2, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="shaped as v"):
        K.hstu_attn_bwd(x, x, x, x[..., :32], torch.empty(2, 8, device="meta", dtype=torch.bool))
