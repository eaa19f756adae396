"""Shared model building blocks (port of ``mhrec_tpu/models/layers.py``).

Initialisers take an explicit ``torch.Generator``; the JAX package's
initialisers have torch counterparts here so a randomly initialised port
model draws from the same distributions (not the same numbers).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax truncated_normal(stddev, lower=-2, upper=2) rescales so the truncated
# distribution has the requested std: std / 0.87962566103423978
_TRUNC_STD_CORRECTION = 0.87962566103423978


@torch.no_grad()
def trunc_normal_init(t: torch.Tensor, gen: torch.Generator, std: float = 0.02):
    """Counterpart of the JAX package's ``trunc_normal_init`` (reference
    truncated_normal(std=0.02) on everything outside the HSTU trunk)."""
    s = std / _TRUNC_STD_CORRECTION
    return nn.init.trunc_normal_(t, mean=0.0, std=s, a=-2 * s, b=2 * s, generator=gen)


@torch.no_grad()
def xavier_uniform_init(t: torch.Tensor, gen: torch.Generator):
    """flax ``xavier_uniform`` on a [in, out] kernel; torch stores Linear
    weights as [out, in], and the bound is symmetric in fan in/out."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    return t.uniform_(-bound, bound, generator=gen)


def cosine_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, eps) — NaN-safe on all-zero rows (see the JAX
    package's docstring for the reference forms this unifies)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm(dtype=...)``: statistics in float32 with the
    fast variance E[x²] − E[x]² (clipped at 0), affine in float32, result
    cast to ``dtype`` (the input's dtype when None)."""

    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__(dim, eps=eps)
        self.out_dtype = dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.out_dtype or x.dtype)


class ItemEmbed(nn.Module):
    """Item-embedding table whose lookups can be redirected to a per-batch
    sub-table of gathered unique rows (the JAX package's ``ItemEmbed`` 'sub'
    collection). Under ``sparse_item_adam`` the trainer passes ``sub``
    [U, D] and the ids are LOCAL indices into it; the full table is then
    not read, and the trainer row-updates only the touched rows
    (``trainer/sparse_adam.py``).

    ``shard`` (a ``parallel/mesh.py::RowShard``) splits the rows over the
    ranks (``shard_item_embedding``): ``weight`` is then this rank's block
    from the start, a lookup without ``sub`` is a collective that fetches
    each row from its owner (no gradient flows through it: the sharded table
    is trained by the row update), and ``rows`` fetches a chunk of rows from
    their owners. No method makes the whole table of a sharded one."""

    # the initial draw's chunk of rows, each from a generator of its own
    INIT_CHUNK_ROWS = 256

    def __init__(self, num_embeddings: int, features: int, shard=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.shard = shard
        rows = num_embeddings if shard is None else shard.rows
        self.weight = nn.Parameter(torch.empty(rows, features))

    def forward(self, ids, sub=None):
        if sub is not None:
            return F.embedding(ids, sub)
        if self.shard is not None:
            with torch.no_grad():
                return self.shard.lookup(self.weight, ids)
        return F.embedding(ids, self.weight)

    def rows(self, a: int, b: int) -> torch.Tensor:
        """Rows [a, b) of the whole table (fetched from their owners when
        sharded: a collective)."""
        if self.shard is None:
            return self.weight[a:b]
        return self.shard.fetch(self.weight, a, b)

    @torch.no_grad()
    def trunc_normal_rows(self, gen: torch.Generator, std: float = 0.02):
        """``trunc_normal_init`` of the table, drawn in chunks of
        ``INIT_CHUNK_ROWS`` rows, chunk c from a generator seeded with (a seed
        drawn from ``gen``) + c. Only the chunks that overlap this rank's
        block are drawn, and its rows equal the same rows of the one-process
        table (no random stream can skip ahead by rows, so one stream over
        the whole table would make every rank draw all of it); a sharded
        block's padding rows are zero. ``gen`` advances by one draw."""
        w = self.weight
        base = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
        start = 0 if self.shard is None else self.shard.start
        stop = min(start + w.shape[0], self.num_embeddings)
        w.zero_()
        C = self.INIT_CHUNK_ROWS
        for c in range(start // C, -(-stop // C)):
            lo, hi = c * C, min((c + 1) * C, self.num_embeddings)
            chunk = torch.empty((hi - lo, w.shape[1]), dtype=w.dtype, device=w.device)
            trunc_normal_init(chunk, torch.Generator(device=w.device).manual_seed(base + c), std)
            a, b = max(lo, start), min(hi, stop)
            w[a - start:b - start].copy_(chunk[a - lo:b - lo])


class ResBlock(nn.Module):
    """Linear + SiLU residual block (reference llm_heads.py:5-40)."""

    def __init__(self, hidden_size: int, use_norm: bool = False):
        super().__init__()
        self.norm = LayerNorm(hidden_size, eps=1e-5) if use_norm else None
        self.linear = nn.Linear(hidden_size, hidden_size)

    def init_parameters(self, gen: torch.Generator):
        trunc_normal_init(self.linear.weight, gen)
        trunc_normal_init(self.linear.bias, gen)

    def forward(self, x):
        if self.norm is not None:
            x = self.norm(x)
        return x + F.silu(self.linear(x))


def batch_rows(shape, shard, draw) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose dim 0 is this rank's rows of a
    global batch: with ``shard`` (a DataMesh of ``world`` data ranks; the
    model ranks of a data row draw alike) the draw
    covers the global batch of ``world · shape[0]`` rows and this rank's
    rows are kept, so the ranks together draw what one process draws over
    the composed batch (the JAX package's one random stream over the global
    array)."""
    if shard is None:
        return draw(shape)
    B = shape[0]
    return draw((shard.world * B,) + tuple(shape[1:]))[shard.rank * B:(shard.rank + 1) * B]


def dropout(x: torch.Tensor, rate: float, generator=None, shard=None) -> torch.Tensor:
    """flax ``nn.Dropout``: with a generator and ``rate`` > 0, keep each
    element with probability 1 − rate and scale the kept by 1 / (1 − rate),
    the mask drawn from ``generator`` (over the global batch with
    ``shard``, see ``batch_rows``); without one (evaluation) the
    identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = batch_rows(x.shape, shard, lambda shape: torch.empty(shape, device=x.device)
                      .bernoulli_(keep, generator=generator))
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


# the feed-forward activations of the JAX package's TransformerLayer; "gelu"
# is the exact erf form (HF / RecBole ``torch.nn.functional.gelu``)
TRANSFORMER_ACTS = {"gelu": F.gelu, "relu": F.relu, "silu": F.silu, "swish": F.silu,
                    "tanh": torch.tanh}


class TransformerLayer(nn.Module):
    """Post-LN transformer block (the JAX package's ``TransformerLayer``,
    reference layers.py:421-637 RecBole style): softmax attention over a
    fused q/k/v projection, attention dropout, output projection, hidden
    dropout, residual, LayerNorm; then the feed-forward with ``hidden_act``,
    hidden dropout, residual, LayerNorm. ``attn_bias`` is additive (0 or
    -1e9). Dropout runs only when the caller passes a generator (training);
    the BERT tower keeps rate 0. As flax's ``Dense`` with float32
    parameters, every product runs in float32 whatever the input type; the
    attention is the plain product-softmax-product (the JAX package computes
    it outside any Pallas kernel)."""

    def __init__(self, n_heads: int, hidden_size: int, inner_size: int,
                 layer_norm_eps: float = 1e-12, hidden_dropout_prob: float = 0.0,
                 attn_dropout_prob: float = 0.0, hidden_act: str = "gelu"):
        super().__init__()
        D = hidden_size
        self.n_heads = n_heads
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attn_dropout_prob = attn_dropout_prob
        self.act = TRANSFORMER_ACTS[hidden_act]
        self.qkv = nn.Linear(D, 3 * D)  # rows ordered (q|k|v, head, dh)
        self.attn_out = nn.Linear(D, D)
        self.attn_ln = LayerNorm(D, eps=layer_norm_eps, dtype=torch.float32)
        self.ff_in = nn.Linear(D, inner_size)
        self.ff_out = nn.Linear(inner_size, D)
        self.ff_ln = LayerNorm(D, eps=layer_norm_eps, dtype=torch.float32)

    def forward(self, x, attn_bias, generator=None, shard=None):
        """``shard`` (a DataMesh): the dropout masks cover the global batch
        (``batch_rows``)."""
        B, L, D = x.shape
        h = self.n_heads
        dh = D // h
        # the divisor in the input's type, as ``jnp.sqrt(dh).astype(x.dtype)``
        scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)
        qkv = self.qkv(x.float()).view(B, L, 3, h, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("blhd,bmhd->bhlm", q, k) / scale + attn_bias
        probs = dropout(torch.softmax(scores, dim=-1), self.attn_dropout_prob, generator, shard)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(B, L, D)
        ctx = dropout(self.attn_out(ctx), self.hidden_dropout_prob, generator, shard)
        x = self.attn_ln(x + ctx)
        ff = dropout(self.ff_out(self.act(self.ff_in(x))), self.hidden_dropout_prob, generator,
                     shard)
        return self.ff_ln(x + ff)


class TransformerEncoder(nn.Module):
    """A stack of ``TransformerLayer``s (the JAX package's
    ``TransformerEncoder``)."""

    def __init__(self, n_layers: int, n_heads: int, hidden_size: int, inner_size: int,
                 layer_norm_eps: float = 1e-12, hidden_dropout_prob: float = 0.0,
                 attn_dropout_prob: float = 0.0, hidden_act: str = "gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(n_heads, hidden_size, inner_size, layer_norm_eps,
                             hidden_dropout_prob, attn_dropout_prob, hidden_act)
            for _ in range(n_layers))

    def forward(self, x, attn_bias, generator=None, shard=None):
        for layer in self.layers:
            x = layer(x, attn_bias, generator, shard)
        return x


def additive_causal_mask(items: torch.Tensor, bidirectional: bool = False) -> torch.Tensor:
    """0 / -1e9 additive attention mask [B, 1, L, L] (or [B, 1, 1, L]
    bidirectional) from non-pad item ids (reference sasrec.py
    get_attention_mask)."""
    L = items.shape[1]
    mask = (items != 0)[:, None, None, :]
    if not bidirectional:
        mask = mask & torch.ones((L, L), dtype=torch.bool, device=items.device).tril()
    return torch.where(mask, 0.0, -1e9)


def asymmetric_loss(logits, targets, gamma_pos: float = 0.0, gamma_neg: float = 4.0,
                    clip: float = 0.05, eps: float = 1e-8):
    """Asymmetric focal BCE (reference layers.py:16-84), mean-reduced.
    ``logits``/``targets``: [..., num_tasks]; the loss is summed over the
    last axis, then averaged."""
    xs_pos = torch.sigmoid(logits)
    xs_neg = 1.0 - xs_pos
    if clip and clip > 0:
        xs_neg = torch.clamp(xs_neg + clip, max=1.0)
    loss = (targets * torch.log(torch.clamp(xs_pos, min=eps))
            + (1.0 - targets) * torch.log(torch.clamp(xs_neg, min=eps)))
    if gamma_neg > 0 or gamma_pos > 0:
        pt = xs_pos * targets + xs_neg * (1.0 - targets)
        gamma = gamma_pos * targets + gamma_neg * (1.0 - targets)
        loss = loss * torch.pow(1.0 - pt, gamma)
    return torch.mean(-loss.sum(dim=-1))


def weighted_bce_with_logits(logits, targets, pos_weight):
    """``binary_cross_entropy_with_logits(pos_weight=...)`` written as the
    JAX package writes it, mean-reduced over every element (reference
    hstu.py:794-796)."""
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))
    return torch.mean(loss)
