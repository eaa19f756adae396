"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc``; elsewhere they skip. This file
imports neither JAX nor the JAX package, so on the machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 differs from the plain version only in the order of
sums (1e-4); bfloat16 may round an attention entry or an output one ulp
apart (2^-8 relative), so it gets about three ulps (2e-2).
"""

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
