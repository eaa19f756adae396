"""Row-sparse (lazy) AdamW for the item-embedding table (port of
``mhrec_tpu/trainer/sparse_adam.py``).

The gradient of an embedding lookup touches only the rows gathered in the
batch. The trainer differentiates with respect to the per-batch gathered
sub-table (``[U, D]`` unique rows, read by ``ItemEmbed`` through its ``sub``
argument) and applies AdamW to only those rows, with the moments stored
dense and touched row-wise. Untouched rows receive no update — LazyAdam
semantics: idle rows' moments do not decay, and decoupled weight decay
applies only on touch.

Unlike the JAX package, the update happens in place, and the unique-id block
marks its pad slots with id −1 (the JAX package aliases them to row 0 with a
mask of 0). ``sparse_adamw_row_update`` here is the plain version, the
``index_add_`` counterpart of the JAX package's XLA scatters; the CUDA
kernel ``row_adamw`` (``ops/row_adam_cuda.py``) performs the same
operations in the same order.

``dedup_touched_rows`` merges the unique-id blocks of several micro-steps
(``accumulate_grad > 1``) into one block of unique ids, each id's gradient
rows summed: the row update and its kernel take each real id once.

A bfloat16 table (``item_table_dtype: bfloat16``) takes the JAX package's
XLA formulation, as JAX sends it there too (row_adam_tpu.py:272-279): the
Adam math in float32 on the upcast rows, the new row value put on the
bfloat16 grid by ``quantize_bf16`` (stochastically when noise is given),
and the exact difference scattered into the table. Its moments stay
float32.

Not ported yet: the cross-process dedup of ``sparse_adam_global_dedup``
(multi-GPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class SparseAdamConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def quantize_bf16(x: torch.Tensor, rnd: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Round float32 ``x`` onto the bfloat16 grid, returned as float32 (JAX
    ``quantize_bf16``, sparse_adam.py:55-70). Without noise:
    round-to-nearest-even. With 16-bit noise words ``rnd`` (integers in
    [0, 2^16), the shape of ``x``: JAX's ``jax.random.bits(key) & 0xFFFF``)
    or a ``generator`` that draws them: stochastic rounding, the uint32
    ``(bits + rnd) & 0xFFFF0000``, which wraps at 2^32, done in int64 masked
    to 32 bits. ``E[quantize(x)] == x``, so updates below half an ulp still
    advance in expectation; values on the grid pass unchanged."""
    if rnd is None and generator is None:
        return x.to(torch.bfloat16).float()
    if rnd is None:
        rnd = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device,
                            dtype=torch.int64)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + rnd.to(torch.int64)) & 0xFFFF0000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def adam_scalars(lr, step_count: int, cfg: SparseAdamConfig):
    """The update's scalars as float32 values, computed as the JAX kernel's
    wrapper computes them (row_adam_tpu.py:292-301): bias corrections
    ``c = 1 − b^t`` with ``t = step_count + 1``, and ``1 − b`` in float32."""
    f = np.float32
    t = f(step_count + 1)
    b1, b2 = f(cfg.b1), f(cfg.b2)
    return dict(neg_lr=float(-f(lr)), c1=float(f(1) - b1 ** t), c2=float(f(1) - b2 ** t),
                eps=float(f(cfg.eps)), wd=float(f(cfg.weight_decay)), b1=float(b1),
                b2=float(b2), omb1=float(f(1) - b1), omb2=float(f(1) - b2))


def sparse_adamw_row_update(table, m, v, ids, grad_rows, lr, step_count: int,
                            cfg: SparseAdamConfig, rnd: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
    """Advance the rows ``ids`` (int64 [U], −1 = pad slot, real ids unique)
    of ``table``, ``m`` and ``v`` (float32 [N, D]; a bfloat16 table goes to
    ``_bf16_row_update`` with the noise ``rnd`` or ``generator``, else they
    are unused) one AdamW step in place,
    given their gradient rows ``grad_rows`` [U, D] (optax.adamw's formula:
    ``−lr · (mhat / (sqrt(vhat) + eps) + wd · p)``, bias corrections from
    the global step count). Pad slots alias row 0 with a zero update, so the
    function needs no host synchronisation. Each operation is its own
    elementwise kernel, in the order of the CUDA kernel, so the two agree
    bit for bit on the card."""
    if table.dtype == torch.bfloat16:
        return _bf16_row_update(table, m, v, ids, grad_rows, lr, step_count, cfg, rnd,
                                generator)
    s = adam_scalars(lr, step_count, cfg)
    keep = (ids >= 0)[:, None]
    rows = ids.clamp(min=0)
    zero = torch.zeros((), dtype=torch.float32, device=table.device)
    g = torch.where(keep, grad_rows.float(), zero)
    p_old, m_old, v_old = table[rows], m[rows], v[rows]
    # divisors as tensors on the device: a Python scalar divisor would be
    # applied as a multiplication by its reciprocal
    c1 = torch.tensor(s["c1"], dtype=torch.float32, device=table.device)
    c2 = torch.tensor(s["c2"], dtype=torch.float32, device=table.device)
    m_new = m_old * s["b1"] + g * s["omb1"]
    v_new = v_old * s["b2"] + (g * g) * s["omb2"]
    mhat = m_new / c1
    vhat = v_new / c2
    direction = mhat / (torch.sqrt(vhat) + s["eps"]) + p_old * s["wd"]
    table.index_add_(0, rows, torch.where(keep, direction * s["neg_lr"], zero))
    m.index_add_(0, rows, torch.where(keep, m_new - m_old, zero))
    v.index_add_(0, rows, torch.where(keep, v_new - v_old, zero))


def _bf16_row_update(table, m, v, ids, grad_rows, lr, step_count, cfg, rnd, generator):
    """The bfloat16-table branch of JAX's ``sparse_adamw_row_update``
    (sparse_adam.py:100-117), operation for operation and with its float32
    constants (``1 − b`` rounded from float64, ``b^t`` in float32), so one
    update is bit-equal to it: the Adam step on the upcast rows, the new
    value quantized (``quantize_bf16``, noise from ``rnd`` or
    ``generator``), and the exact float32 difference scattered as bfloat16,
    as JAX's ``.at[ids].add`` does. Pad slots add zero to row 0."""
    f = np.float32
    dev = table.device
    keep = (ids >= 0)[:, None]
    rows = ids.clamp(min=0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    t = f(step_count + 1)
    # divisors as tensors: a Python scalar divisor is applied on the card as
    # a multiplication by its reciprocal
    c1 = torch.tensor(f(1) - np.power(f(cfg.b1), t), device=dev)
    c2 = torch.tensor(f(1) - np.power(f(cfg.b2), t), device=dev)
    g = torch.where(keep, grad_rows.float(), zero)
    m_old, v_old = m[rows], v[rows]
    p_old = table[rows].float()
    m_new = m_old * float(f(cfg.b1)) + g * float(f(1.0 - cfg.b1))
    v_new = v_old * float(f(cfg.b2)) + (g * g) * float(f(1.0 - cfg.b2))
    direction = (m_new / c1) / (torch.sqrt(v_new / c2) + float(f(cfg.eps))) \
        + p_old * float(f(cfg.weight_decay))
    delta = torch.where(keep, direction * float(-f(lr)), zero)
    delta = torch.where(keep, quantize_bf16(p_old + delta, rnd, generator) - p_old, zero)
    table.index_add_(0, rows, delta.to(torch.bfloat16))
    m.index_add_(0, rows, torch.where(keep, m_new - m_old, zero))
    v.index_add_(0, rows, torch.where(keep, v_new - v_old, zero))


def dedup_touched_rows(ids, grad_rows):
    """Merge duplicate row ids into one slot each, gradients summed (JAX
    ``dedup_touched_rows``, sparse_adam.py:120).

    ids: int64 [k, U] — k blocks of row ids, −1 for pad slots; grad_rows:
    [k, U, D]. Returns (ids_u [k·U], g_u [k·U, D] float32): every real id once, ascending, at the front, with the
    sum of its gradient rows; −1 and zero rows after. The JAX version pads
    with id 0 and mask 0 instead; the row update here takes −1 as its pad
    slot and needs the real ids unique, which this output is.

    The blocks are summed one after another, in block order, by
    ``index_add_``: when real ids are unique within each block (one train
    step's unique-id block each), no two rows of one ``index_add_`` land on
    one slot, so the sums are the same on every run on the card too."""
    k, U = ids.shape
    flat = ids.reshape(-1)
    pad = flat < 0
    # pads sort last, so the real ids' groups come first
    key = flat.masked_fill(pad, torch.iinfo(torch.int64).max)
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_sorted = torch.cumsum(first, 0) - 1
    seg = torch.empty_like(seg_sorted).scatter_(0, order, seg_sorted)
    ids_u = torch.full_like(flat, -1).scatter_(0, seg, flat.masked_fill(pad, -1))
    g_u = torch.zeros((k * U, grad_rows.shape[-1]), dtype=torch.float32,
                      device=grad_rows.device)
    seg = seg.view(k, U)
    for j in range(k):
        g_u.index_add_(0, seg[j], grad_rows[j].float())
    # the pad slots' group (and the slots no group took) reads zero rows
    g_u.masked_fill_((ids_u < 0)[:, None], 0.0)
    return ids_u, g_u
