"""The port's Llama item/user towers and packed attention against the JAX
package's, on the same numpy-seeded inputs and (for the backbone) the same
weights carried across by ``convert.py``.

Widths are ``LLMConfig.tiny``'s: 2 layers, 64 wide, 4 heads over 2 KV
heads. Tolerances: float32 differs only in the order of sums (1e-5; RMSNorm
and RoPE tables 1e-6); bfloat16 rounds at other places in the two
frameworks (2e-2). Packed attention is compared on real tokens only: the
dense oracle averages over everything on padding rows, the port writes
zeros there, and no caller reads them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.models.llm import llama as jllama
from mhrec_tpu.models.llm import packed as jpacked
from mhrec_tpu.models.llm.config import LLMConfig as JaxLLMConfig
from mhrec_tpu_torch.convert import llama_state_dict_from_flax
from mhrec_tpu_torch.models.llm import llama as tllama
from mhrec_tpu_torch.models.llm import packed as tpacked
from mhrec_tpu_torch.models.llm.config import LLMConfig

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _items(rng, N, T, vocab=1024):
    """N padded token rows [N, T + 1] of 1..T real tokens (room for the emb
    slot) and their lengths."""
    lens = rng.integers(1, T + 1, size=N).astype(np.int32)
    lens[0] = T
    tokens = np.zeros((N, T + 1), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, vocab, size=n)
    return tokens, lens


@pytest.mark.parametrize("chunk", [0, 96], ids=["flat", "chunked"])
def test_pack_items_matches_jax(chunk):
    rng = np.random.default_rng(0)
    tokens, lens = _items(rng, 40, 30)
    # the port packs for one card (chunk_round 1), the JAX tests for 8
    # virtual devices: both round chunk rows to a quantum of 8
    ours = tpacked.pack_items(tokens, lens, bucket=128, n_emb=1, chunk=chunk, chunk_round=1)
    ref = jpacked.pack_items(tokens, lens, bucket=128, n_emb=1, chunk=chunk, chunk_round=8)
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert tpacked.round_chunk_rows(13, 1) == jpacked.round_chunk_rows(13, 8) == 16


@pytest.mark.parametrize("window", [None, 6], ids=["no-band", "band-6"])
def test_packed_attention_plain_matches_dense_oracle(window):
    rng = np.random.default_rng(1)
    tokens, lens = _items(rng, 24, 12)
    seg = tpacked.pack_items(tokens, lens, chunk=48, chunk_round=1)["packed_segment_ids"]
    C, S = seg.shape
    H, Hkv, dh = 4, 2, 16
    q = rng.normal(size=(C, S, H, dh)).astype(np.float32)
    k, v = (rng.normal(size=(C, S, Hkv, dh)).astype(np.float32) for _ in range(2))
    out = tpacked.packed_attention(*(torch.from_numpy(x) for x in (q, k, v, seg)),
                                   window=window).numpy()
    real = seg > 0
    assert not out[~real].any()
    for c in range(C):
        if not real[c].any():
            continue
        ref = np.asarray(jpacked.packed_attention_dense(
            jnp.asarray(q[c]), jnp.repeat(jnp.asarray(k[c]), H // Hkv, axis=1),
            jnp.repeat(jnp.asarray(v[c]), H // Hkv, axis=1), jnp.asarray(seg[c]),
            window=window))
        np.testing.assert_allclose(out[c][real[c]], ref[real[c]], rtol=1e-5, atol=1e-5)


def test_rms_norm_matches_jax():
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32)
    w = np.random.default_rng(3).normal(size=64).astype(np.float32)
    ref = jllama.RMSNorm(1e-5).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    norm = tllama.RMSNorm(64, 1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        out = norm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


ROPE = {
    "default": {},
    "linear": dict(rope_scaling_type="linear", rope_scaling_factor=4.0),
    "dynamic": dict(rope_scaling_type="dynamic", rope_scaling_factor=2.0),
    "yarn": dict(rope_scaling_type="yarn", rope_scaling_factor=4.0, rope_orig_max_pos=64),
}


@pytest.mark.parametrize("variant", list(ROPE))
def test_rope_matches_jax(variant):
    cfg = dataclasses.replace(LLMConfig.tiny(), **ROPE[variant])
    jcfg = dataclasses.replace(JaxLLMConfig.tiny(), **ROPE[variant])
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 700, size=(2, 9)).astype(np.int32)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    jcos, jsin = jllama.rotary_embedding(jnp.asarray(pos), 16, jcfg, seq_len=900)
    cos, sin = tllama.rotary_embedding(torch.from_numpy(pos), 16, cfg, seq_len=900)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6, atol=1e-6)
    out = tllama.apply_rope(torch.from_numpy(x), cos, sin).numpy()
    ref = np.asarray(jllama.apply_rope(jnp.asarray(x), jcos, jsin))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tower():
    """A tiny flax backbone's parameters (normal init, emb slot included)
    and the port's backbone with the same weights, in float32."""
    jcfg = dataclasses.replace(JaxLLMConfig.tiny(), packed_window=13)
    jmodel = jllama.LlamaBackbone(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                input_ids=jnp.ones((1, 4), jnp.int32)))
    rng = np.random.default_rng(5)
    # normal 0.02 kernels and embeddings; RMSNorm weights 1 + 0.1·normal,
    # so a swapped one shows
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if "norm" in jax.tree_util.keystr(p)
        else (0.02 * rng.normal(size=x.shape)).astype(np.float32), shapes["params"])
    emb_token = rng.normal(size=(1, 1, 64)).astype(np.float32) * 0.02
    return jcfg, params, emb_token


def _torch_backbone(jcfg, params, dtype):
    cfg = LLMConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaBackbone(cfg, dtype=dtype)
    model.load_state_dict(llama_state_dict_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("mode", ["dense", "packed", "flat"])
def test_llama_backbone_matches_flax(tower, mode, dname):
    jdtype, tdtype, tol = DTYPES[dname]
    jcfg, params, emb_token = tower
    jmodel = jllama.LlamaBackbone(jcfg, dtype=jdtype)
    model = _torch_backbone(jcfg, params, tdtype)
    rng = np.random.default_rng(6)
    tokens, lens = _items(rng, 10, 12)
    emb = jnp.asarray(emb_token)
    if mode == "dense":
        mask = (np.arange(13)[None] < lens[:, None] + 1).astype(np.int32)
        jargs = dict(input_ids=jnp.asarray(tokens), attention_mask=jnp.asarray(mask),
                     emb_tokens=emb, emb_pos=jnp.asarray(lens))
        targs = dict(input_ids=torch.from_numpy(tokens).long(),
                     attention_mask=torch.from_numpy(mask),
                     emb_tokens=torch.from_numpy(emb_token), emb_pos=torch.from_numpy(lens).long())
        keep = mask.astype(bool)
    else:
        chunk = 0 if mode == "flat" else 40
        p = tpacked.pack_items(tokens, lens, bucket=64, chunk=chunk, chunk_round=1)
        tok, seg, pos = p["packed_tokens"], p["packed_segment_ids"], p["packed_positions"]
        if mode == "flat":
            tok, pos = tok[None], pos[None]
        jargs = dict(input_ids=jnp.asarray(tok), position_ids=jnp.asarray(pos),
                     segment_ids=jnp.asarray(seg), emb_tokens=emb,
                     emb_pos=jnp.asarray(p["emb_slots"]))
        targs = dict(input_ids=torch.from_numpy(tok).long(), position_ids=torch.from_numpy(pos),
                     segment_ids=torch.from_numpy(seg), emb_tokens=torch.from_numpy(emb_token),
                     emb_pos=torch.from_numpy(p["emb_slots"]).long())
        keep = (seg > 0).reshape(tok.shape)
    ref = np.asarray(jax.jit(lambda p, kw: jmodel.apply({"params": p}, **kw))(params, jargs)
                     .astype(jnp.float32))
    with torch.no_grad():
        out = model(**targs).float().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[keep], ref[keep], rtol=tol, atol=tol)
