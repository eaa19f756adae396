"""Decoder backbone for the Llama family (llama / TinyLlama / mistral / qwen2
/ baichuan topology), port of ``mhrec_tpu/models/llm/llama.py``: RMSNorm
→ GQA attention with RoPE (or ALiBi for the Baichuan-13B variant) → SwiGLU
MLP, pre-norm residuals, final RMSNorm.

Parameters are float32; the layers compute in ``dtype`` (bfloat16 by
default), as flax's ``Dense(dtype=...)`` does. Item texts run either as a
dense padded ``[N, T]`` batch whose mask removes pad keys, or packed
(``segment_ids`` given): items concatenated into chunk rows, attention
causal within each segment through ``packed_attention`` — the hand-written
CUDA kernel on the card. The learnable item-embedding token is scattered
into each item's trailing slot (reference ``modeling_llama.py:1220-1228``).
ALiBi towers add a per-head distance penalty ``[H, T, T]`` to the dense
scores instead of rotating q and k; the packed route has no score-bias
input, so it raises for them, as in the JAX package.

Products stay ``F.linear`` / ``torch.matmul`` (the JAX package leaves them
to XLA), and the dense padded attention of the user tower is plain PyTorch
for the same reason. Gradient checkpointing recomputes each layer in the
backward: ``remat_policy: full`` keeps only the layer's input (``nn.remat``
with no policy in the JAX package); ``dots`` also keeps every matrix
product's output and recomputes the elementwise work and the packed
attention kernel (``dots_saveable``, whose recompute takes in the splash
custom call too).

The image item tower splices the vision tower's tokens into the token
embeddings before the emb-token scatter: over a static span
(``image_span``: every item's image pads at the same columns) or through a
per-position gather map (``image_src``: dynamic per-image token counts).
Qwen2-VL towers (``mrope_section``) take 3-D positions [3, B, T] (t, h, w)
through the multimodal RoPE.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from mhrec_tpu_torch.models.llm.config import LLMConfig
from mhrec_tpu_torch.models.llm.packed import packed_attention
from mhrec_tpu_torch.parallel import tensor


class RMSNorm(nn.Module):
    """Statistics and scale in float32, result cast back to the input type."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (Press et al. 2022), the closest-power-of-two
    interpolation of transformers' ``build_alibi_tensor``, copied from the
    JAX package."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = base ** np.arange(1, closest + 1, dtype=np.float32)
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, n_heads - closest)
        extra = extra_base ** np.arange(1, 1 + 2 * n_extra, 2, dtype=np.float32)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


# the matrix products whose outputs ``remat_policy: dots`` keeps
# (jax.checkpoint_policies.dots_saveable keeps every dot_general's)
_DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm")
    if hasattr(torch.ops.aten, name))


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_saveable)


_PACKED_ALIBI = ("packed varlen attention has no score-bias input (the packed kernel takes "
                 "segment ids only): ALiBi towers must run the dense padded path "
                 "(packed_item_tower / packed_corpus_pass false)")


def rope_parameters(c, head_dim: int, seq_len: int | None = None):
    """(inv_freq [head_dim//2] float32 numpy, attention_scaling) for the
    configured RoPE scaling variant — semantics of the reference's vendored
    HF ``modeling_rope_utils.py`` (``_compute_{linear,dynamic_ntk,yarn}_
    parameters``), copied from the JAX package."""
    base = c.rope_theta
    d = head_dim
    exp = np.arange(0, d, 2, dtype=np.float32) / d
    t = c.rope_scaling_type
    if t is None:
        return 1.0 / (base ** exp), 1.0
    f = c.rope_scaling_factor
    if t == "linear":
        return 1.0 / (base ** exp) / f, 1.0
    if t == "dynamic":
        # NTK: HF uses max_position_embeddings as the window and clamps
        # seq_len from below, so at/below the window the frequencies are
        # unscaled; the backbone passes its T
        orig = c.max_position_embeddings
        L = max(seq_len or orig, orig)
        base2 = base * ((f * L / orig) - (f - 1)) ** (d / (d - 2))
        return 1.0 / (base2 ** exp), 1.0
    orig = c.rope_orig_max_pos or c.max_position_embeddings
    if t == "yarn":
        pos_freqs = base ** exp
        inv_extrapolation = 1.0 / pos_freqs
        inv_interpolation = 1.0 / (f * pos_freqs)

        def corr_dim(n_rot):
            return (d * math.log(orig / (n_rot * 2 * math.pi))) / (2 * math.log(base))

        low = max(math.floor(corr_dim(c.rope_beta_fast)), 0)
        high = min(math.ceil(corr_dim(c.rope_beta_slow)), d - 1)
        if low == high:
            high += 0.001  # HF's divide-by-zero guard
        ramp = (np.arange(d // 2, dtype=np.float32) - low) / (high - low)
        extrapolation_factor = 1.0 - np.clip(ramp, 0.0, 1.0)
        inv = (inv_interpolation * (1.0 - extrapolation_factor)
               + inv_extrapolation * extrapolation_factor)
        att = c.rope_attention_factor
        if att is None:
            att = 0.1 * math.log(f) + 1.0 if f > 1.0 else 1.0
        return inv.astype(np.float32), float(att)
    raise ValueError(f"unsupported rope_scaling type: {t!r}")


def rotary_embedding(positions: torch.Tensor, head_dim: int, config,
                     seq_len: int | None = None):
    """cos/sin tables in float32: positions [B, T] → [B, T, head_dim//2]
    each. ``config`` is an LLMConfig (scaling-aware) or a plain theta."""
    if isinstance(config, (int, float)):
        inv_freq = 1.0 / (config ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
        scale = 1.0
    else:
        inv_freq, scale = rope_parameters(config, head_dim, seq_len)
    inv = torch.from_numpy(np.asarray(inv_freq, dtype=np.float32)).to(positions.device)
    freqs = positions[..., None].float() * inv
    return torch.cos(freqs) * scale, torch.sin(freqs) * scale


def mrope_rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float, section):
    """Multimodal RoPE (qwen2_vl): positions [3, B, T] with (t, h, w)
    components; ``section`` lists how many of the head_dim//2 rotary
    frequencies each component drives, in order (reference
    modeling_qwen2_vl.py apply_multimodal_rotary_pos_emb) → cos/sin
    [B, T, head_dim//2] float32."""
    if sum(section) != head_dim // 2:
        raise ValueError(f"mrope_section {section} does not cover head_dim {head_dim} // 2")
    inv = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))).to(
            positions.device)
    freqs = positions[..., None].float() * inv
    cos, sin = torch.cos(freqs), torch.sin(freqs)  # [3, B, T, dh/2]
    bounds = np.cumsum([0, *section])
    return (torch.cat([cos[i, ..., a:b] for i, (a, b) in enumerate(zip(bounds, bounds[1:]))], -1),
            torch.cat([sin[i, ..., a:b] for i, (a, b) in enumerate(zip(bounds, bounds[1:]))], -1))


def splice_image(inputs_embeds, image_embeds, image_span=None, image_src=None):
    """The vision tower's tokens into the token embeddings (reference
    modeling_qwen2_vl.py:1858 masked_scatter): ``image_src`` [B, T] the
    index of the image token at each position or -1 (one gather, no
    data-dependent shapes), else the static ``image_span`` (start, n)."""
    img = image_embeds.to(inputs_embeds.dtype)
    if image_src is not None:
        idx = torch.clamp(image_src.long(), min=0)[..., None].expand(-1, -1, img.shape[-1])
        take = torch.gather(img, 1, idx)
        return torch.where((image_src >= 0)[..., None], take, inputs_embeds)
    s, n = image_span
    return torch.cat([inputs_embeds[:, :s], img, inputs_embeds[:, s + n:]], dim=1)


def apply_rope(x, cos, sin):
    """x: [B, T, H, D]; rotate-half convention (HF Llama), computed in
    float32 and cast back to x's type."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _linear(layer: nn.Linear, x, dtype):
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _plan(config: LLMConfig, tp, prefix: str):
    """The layer's split projections under ``prefix`` (``tensor.tp_params``,
    by their name in the block → dimension); none without tensor
    parallelism."""
    if tp is None or tp.size <= 1 or not config.tp_shard:
        return {}
    return {name[len(prefix):]: dim for name, dim in tensor.tp_params(config, tp.size).items()
            if name.startswith(prefix)}


class _PartialProduct(torch.autograd.Function):
    """``x @ wᵀ`` of bfloat16 (float16) operands written in float32 by one
    GEMM (``torch.mm``'s ``out_dtype``): the tensor cores' products summed
    in float32 and left unrounded. The backward runs in the operands' type,
    as one process's product does: the gradient that arrives is the float32
    image of a compute-type value (the caller rounds the model group's sum
    once), so it converts back exactly."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


def _tp_linear(layer: nn.Linear, x, dtype):
    """A row-parallel partial product in float32: the compute type's
    operands, products summed in float32 (the model group adds the ranks'
    partials before the one rounding). On the card a bfloat16 (float16)
    product is one tensor-core GEMM that writes float32; elsewhere, and in
    float32, the operands are widened first (the same numbers)."""
    x, w = x.to(dtype), layer.weight.to(dtype)
    if x.is_cuda and dtype in (torch.bfloat16, torch.float16):
        return _PartialProduct.apply(x, w)
    return F.linear(x.float(), w.float())


class LlamaAttention(nn.Module):
    """GQA attention. Under tensor parallelism (``tp``, a
    ``parallel/tensor.py::TPGroup``, and ``config.tp_shard``) the block
    holds what ``tensor.tp_params`` gives this model rank: its heads of
    q/k/v where their counts divide by T, its rows of ``o_proj``'s input
    where the width does (``tp_split``). A whole q (k, v) projection gives
    every head; the rank attends with the query heads that its ``o_proj``
    rows read (``heads``) over the KV heads those read: its own KV heads
    when k/v are split, else a view of the whole projection's heads where
    the local query heads map onto them as h // (H / Hkv), else those heads
    gathered one per query head. The whole projections' gradients are then
    shares (``tp_whole``), summed over the model group by the trainer."""

    def __init__(self, config: LLMConfig, dtype=torch.bfloat16, tp=None):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        D, h, hk = c.hidden_size, c.num_attention_heads, c.num_key_value_heads
        dh = D // h
        plan = _plan(c, tp, "self_attn.")
        self.tp = tp if plan else None
        self.tp_split = plan
        T, m = (tp.size, tp.rank) if plan else (1, 0)
        nq = h // T if "q_proj.weight" in plan else h
        nk = hk // T if "k_proj.weight" in plan else hk
        self.q_proj = nn.Linear(D, nq * dh, bias=c.attention_bias)
        self.k_proj = nn.Linear(D, nk * dh, bias=c.attention_bias)
        self.v_proj = nn.Linear(D, nk * dh, bias=c.attention_bias)
        self.row_split = "o_proj.weight" in plan
        self.o_proj = nn.Linear(D // T if self.row_split else D, D, bias=False)
        # this rank's columns [r0, r1) of the attention output (o_proj's
        # input), the query heads [h0, h1) they come from and their KV heads
        self.cols = (m * D // T, (m + 1) * D // T) if self.row_split else (0, D)
        h0, h1 = self.cols[0] // dh, -(-self.cols[1] // dh)
        self.heads = (h0, h1)
        self.tp_whole = [f"{n}.{w}" for n in ("q_proj", "k_proj", "v_proj")
                         for w in ("weight", "bias")
                         if self.row_split and f"{n}.weight" not in plan
                         and (w == "weight" or c.attention_bias)]
        g = h // hk
        need = [(h0 + j) // g for j in range(h1 - h0)]
        self.kv_index = None  # KV heads by index (a gather), else the slice kv_slice
        if "k_proj.weight" in plan:
            self.kv_slice = (0, nk)
        else:
            kv0, kv1 = need[0], need[-1] + 1
            rep = (h1 - h0) // (kv1 - kv0)
            self.kv_slice = (kv0, kv1)
            if (h1 - h0) % (kv1 - kv0) or any(need[j] - kv0 != j // rep
                                               for j in range(h1 - h0)):
                self.kv_index = need

    def _local_heads(self, q, k, v):
        """The query heads this rank attends with and their KV heads."""
        if self.tp is None:
            return q, k, v
        h0, h1 = self.heads
        if q.shape[2] != h1 - h0:  # a whole q projection
            q = q[:, :, h0:h1]
        if self.kv_index is not None:
            idx = torch.tensor(self.kv_index, device=k.device)
            return q, k.index_select(2, idx), v.index_select(2, idx)
        kv0, kv1 = self.kv_slice
        if k.shape[2] != kv1 - kv0:  # a view of the whole projection's heads
            k, v = k[:, :, kv0:kv1], v[:, :, kv0:kv1]
        return q, k, v

    def forward(self, x, mask_bias, cos, sin, segment_ids=None, alibi_bias=None):
        c = self.config
        B, T, D = x.shape
        dh = D // c.num_attention_heads
        if self.row_split:
            x = tensor.copy_to_model(x, self.tp)
        q = _linear(self.q_proj, x, self.dtype).view(B, T, -1, dh)
        k = _linear(self.k_proj, x, self.dtype).view(B, T, -1, dh)
        v = _linear(self.v_proj, x, self.dtype).view(B, T, -1, dh)
        if cos is not None:  # RoPE; None: ALiBi (a distance bias on the scores)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        q, k, v = self._local_heads(q, k, v)
        h, hk = q.shape[2], k.shape[2]
        if segment_ids is not None:
            if alibi_bias is not None:
                raise NotImplementedError(_PACKED_ALIBI)
            # packed varlen batch: causal-within-segment attention (reference
            # flash_attn_varlen path). A sliding window tighter than the
            # packed band wins: the band allows i - j <= w, so mistral's
            # "attend to the last `sw` tokens" is w = sw - 1 (llama.py:219-221)
            w = c.packed_window or None
            if c.sliding_window and (w is None or c.sliding_window - 1 < w):
                w = c.sliding_window - 1
            if segment_ids.dim() == 2:  # chunked packing [C, chunk]
                ctx = packed_attention(q, k, v, segment_ids, window=w)
            else:  # one flat stream [S]
                ctx = packed_attention(q, k, v, segment_ids[None], window=w)
            ctx = ctx.reshape(B, T, h * dh)
        else:
            if hk != h:
                k = k.repeat_interleave(h // hk, dim=2)
                v = v.repeat_interleave(h // hk, dim=2)
            # scores rounded to the compute type, then divided in float32
            # (the JAX package divides by an np.float64, which promotes)
            scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(dh)
            scores = scores + mask_bias
            if alibi_bias is not None:  # [H, T, T], broadcast over the batch
                scores = scores + alibi_bias[self.heads[0]:self.heads[1]]
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, h * dh)
        if not self.row_split:
            return _linear(self.o_proj, ctx, self.dtype)
        a = self.cols[0] - self.heads[0] * dh
        ctx = ctx[..., a:a + self.cols[1] - self.cols[0]]
        return tensor.reduce_from_model(_tp_linear(self.o_proj, ctx, self.dtype),
                                        self.tp).to(self.dtype)


class LlamaMLP(nn.Module):
    """SwiGLU. Under tensor parallelism (where the intermediate width
    divides by T) this rank's columns of ``gate`` / ``up`` and rows of
    ``down``'s input, the partial products summed over the model group."""

    def __init__(self, config: LLMConfig, dtype=torch.bfloat16, tp=None):
        super().__init__()
        self.dtype = dtype
        D, I = config.hidden_size, config.intermediate_size
        plan = _plan(config, tp, "mlp.")
        self.tp = tp if plan else None
        self.tp_split = plan
        n = I // tp.size if plan else I
        self.gate_proj = nn.Linear(D, n, bias=False)
        self.up_proj = nn.Linear(D, n, bias=False)
        self.down_proj = nn.Linear(n, D, bias=False)

    def forward(self, x):
        if self.tp is not None:
            x = tensor.copy_to_model(x, self.tp)
        gate = _linear(self.gate_proj, x, self.dtype)
        up = _linear(self.up_proj, x, self.dtype)
        if self.tp is None:
            return _linear(self.down_proj, F.silu(gate) * up, self.dtype)
        return tensor.reduce_from_model(_tp_linear(self.down_proj, F.silu(gate) * up, self.dtype),
                                        self.tp).to(self.dtype)


class LlamaLayer(nn.Module):
    def __init__(self, config: LLMConfig, dtype=torch.bfloat16, tp=None):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.self_attn = LlamaAttention(config, dtype, tp)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.mlp = LlamaMLP(config, dtype, tp)

    def forward(self, x, mask_bias, cos, sin, segment_ids=None, alibi_bias=None):
        x = x + self.self_attn(self.input_layernorm(x), mask_bias, cos, sin, segment_ids,
                               alibi_bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaBackbone(nn.Module):
    """Decoder stack returning the last hidden states [B, T, D]."""

    def __init__(self, config: LLMConfig, dtype=torch.bfloat16,
                 gradient_checkpointing: bool = False, token_embeddings: bool = True,
                 remat_policy: str = "full", tp=None):
        """``token_embeddings=False`` leaves out the token table of a tower
        that only ever takes ``inputs_embeds`` (the user tower), as flax
        creates it only when token ids arrive. ``gradient_checkpointing``
        keeps only each layer's input for the backward, which runs the layer
        again; ``remat_policy`` "dots" also keeps the layer's matrix-product
        outputs. ``tp`` (a ``parallel/tensor.py::TPGroup``) with
        ``config.tp_shard``: the layers' projections split over the model
        group as JAX's rule says (the token table and the norms stay
        whole)."""
        super().__init__()
        self.config = config
        self.dtype = dtype
        if remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be full|dots, got {remat_policy!r}")
        self.gradient_checkpointing = gradient_checkpointing
        self.remat_policy = remat_policy
        if token_embeddings:
            self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(config, dtype, tp)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """flax's initialisers: normal(0.02) kernels and embeddings, zero
        biases, unit RMSNorm weights. A tensor-parallel shard is this
        rank's part of the whole parameter's draw, so the ranks together
        hold what one process draws."""
        split = tensor.split_params(self)
        for name, m in self.named_modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                key = f"{name}.weight"
                if key in split:
                    dim, tp = split[key]
                    shape = list(m.weight.shape)
                    shape[dim] *= tp.size
                    whole = torch.empty(shape, device=m.weight.device).normal_(
                        0.0, 0.02, generator=gen)
                    m.weight.copy_(tensor.local_shard(whole, dim, tp))
                else:
                    m.weight.normal_(0.0, 0.02, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = keep
        position_ids: Optional[torch.Tensor] = None,
        causal: bool = True,
        emb_tokens: Optional[torch.Tensor] = None,  # [1, n, D] learnable slots
        emb_pos: Optional[torch.Tensor] = None,     # [B] or flat [N] first slot
        segment_ids: Optional[torch.Tensor] = None,  # [S] or [C, chunk]: packed
        image_embeds: Optional[torch.Tensor] = None,  # [B, n_img, D]
        image_span: Optional[tuple] = None,            # static (start, n_img)
        image_src: Optional[torch.Tensor] = None,      # [B, T] dynamic gather map
    ) -> torch.Tensor:
        c = self.config
        if c.alibi and segment_ids is not None:
            raise NotImplementedError(_PACKED_ALIBI)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        if image_embeds is not None:
            inputs_embeds = splice_image(inputs_embeds, image_embeds, image_span, image_src)
        if emb_tokens is not None and emb_pos is not None:
            # the learnable item-embedding token(s) into each item's trailing
            # slot(s): slot emb_pos + i takes token i (llama.py:345-373); in
            # packed modes emb_pos are flat indices into the [B·T] stream
            B, T, D = inputs_embeds.shape
            flat = inputs_embeds.reshape(B * T, D).clone()
            base = emb_pos if segment_ids is not None else (
                torch.arange(B, device=emb_pos.device) * T + emb_pos)
            for i in range(emb_tokens.shape[1]):
                flat[base + i] = emb_tokens[0, i].to(flat.dtype)
            inputs_embeds = flat.reshape(B, T, D)
        x = inputs_embeds.to(self.dtype)
        B, T, _ = x.shape
        mask_bias = None
        if segment_ids is None:  # dense padded batch: additive mask
            if attention_mask is None:
                attention_mask = torch.ones((B, T), dtype=torch.int32, device=x.device)
            mask = attention_mask.bool()[:, None, None, :]
            if causal:
                idx = torch.arange(T, device=x.device)
                tri = idx[:, None] >= idx[None, :]
                if c.sliding_window:
                    # mistral: token i attends to j ∈ (i - sliding_window, i]
                    tri = tri & (idx[:, None] - idx[None, :] < c.sliding_window)
                mask = mask & tri
            mask_bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
        if position_ids is None:
            position_ids = torch.arange(T, device=x.device)[None].expand(B, T)
        alibi_bias = None
        if c.alibi:
            # no RoPE: a per-head penalty m·(j − i) on the scores (−m·|i − j|
            # without the causal mask). Every dense call site right-pads with
            # arange positions, so one [H, T, T] table serves every row
            cos = sin = None
            pos = position_ids[0] if position_ids.dim() >= 2 else position_ids
            rel = (pos[None, :] - pos[:, None]).float()
            if not causal:
                rel = -rel.abs()
            # every head's; each attention block takes its own heads' rows
            slopes = torch.from_numpy(alibi_slopes(c.num_attention_heads)).to(x.device)
            alibi_bias = slopes[:, None, None] * rel[None]
        elif position_ids.dim() == 3 and c.mrope_section:
            cos, sin = mrope_rotary_embedding(position_ids, c.hidden_size // c.num_attention_heads,
                                              c.rope_theta, c.mrope_section)
        else:
            if position_ids.dim() == 3:
                position_ids = position_ids[0]
            cos, sin = rotary_embedding(position_ids, c.hidden_size // c.num_attention_heads,
                                        c, seq_len=T)
        for layer in self.layers:
            if remat:
                # non-reentrant: the backward reruns the layer's forward (the
                # packed attention kernel included) with grad on, taking the
                # kept products from the cache under "dots"; the layers draw
                # no random numbers, so no RNG state is kept
                x = checkpoint(layer, x, mask_bias, cos, sin, segment_ids, alibi_bias,
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=(_dots_context if self.remat_policy == "dots"
                                           else noop_context_fn))
            else:
                x = layer(x, mask_bias, cos, sin, segment_ids, alibi_bias)
        return self.norm(x)
