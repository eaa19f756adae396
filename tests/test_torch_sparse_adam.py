"""The port's row-sparse AdamW (``trainer/sparse_adam.py``, the plain version
of the CUDA kernel ``row_adamw``) against the JAX package's XLA formulation
(``sparse_adamw_row_update``) and its Pallas kernel #7
(``sparse_adamw_row_update_pallas``, interpret mode), from the same numpy
inputs, with pad slots in the id block.

Tolerance: the port performs the Pallas kernel's float32 operations in its
order, so it agrees with the kernel and with the XLA formulation to about
one ulp (rtol/atol 1e-6, the JAX package's own kernel-vs-XLA tolerance);
rows that no real id touches stay bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.ops.pallas.row_adam_tpu import sparse_adamw_row_update_pallas
from mhrec_tpu.trainer.sparse_adam import SparseAdamConfig as JaxCfg
from mhrec_tpu.trainer.sparse_adam import sparse_adamw_row_update as jax_update
from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw
from mhrec_tpu_torch.trainer.sparse_adam import SparseAdamConfig, sparse_adamw_row_update

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(N=400, D=256, U=1024, n_real=300, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    m = (rng.normal(size=(N, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(N, D))) * 0.01).astype(np.float32)
    ids = np.zeros(U, np.int32)
    ids[:n_real] = rng.choice(np.arange(N), size=n_real, replace=False)
    mask = np.zeros(U, np.float32)
    mask[:n_real] = 1.0
    g = rng.normal(size=(U, D)).astype(np.float32)
    return table, m, v, ids, mask, g


def _port(table, m, v, ids, mask, g, lr, step, wd, fn=sparse_adamw_row_update):
    tm = [torch.from_numpy(x.copy()) for x in (table, m, v)]
    signed = torch.from_numpy(np.where(mask > 0, ids, -1).astype(np.int64))
    fn(*tm, signed, torch.from_numpy(g), lr, step, SparseAdamConfig(weight_decay=wd))
    return [x.numpy() for x in tm]


@pytest.mark.parametrize("wd,step", [(0.0, 0), (0.01, 0), (0.0, 7), (0.01, 7)])
def test_row_update_matches_jax_xla_and_pallas(wd, step):
    table, m, v, ids, mask, g = _inputs()
    args = [jnp.asarray(x) for x in (table, m, v, ids, mask, g)]
    xla = jax_update(*args, 1e-3, jnp.asarray(step), JaxCfg(weight_decay=wd))
    pallas = sparse_adamw_row_update_pallas(*args, 1e-3, jnp.asarray(step),
                                            JaxCfg(weight_decay=wd), interpret=True)
    out = _port(table, m, v, ids, mask, g, 1e-3, step, wd)
    touched = np.zeros(len(table), bool)
    touched[ids[mask > 0]] = True
    for name, o, x, p, before in zip("pmv", out, xla, pallas, (table, m, v)):
        np.testing.assert_allclose(o, np.asarray(p), err_msg=name, **TOL)
        np.testing.assert_allclose(o, np.asarray(x), err_msg=name, **TOL)
        np.testing.assert_array_equal(o[~touched], before[~touched])
        assert not np.array_equal(o[touched], before[touched])


def test_pad_slots_leave_row_zero_alone_and_any_width_works():
    """Pad slots alias row 0 with a zero update; D need not be a multiple of
    128 (the TPU kernel's limit); the wrapper runs the plain version on CPU
    tensors and counts no launch."""
    table, m, v, ids, mask, g = _inputs(D=96, n_real=40)
    assert 0 not in ids[mask > 0]
    before = row_adamw.launches
    out = _port(table, m, v, ids, mask, g, 1e-2, 3, 0.01, fn=row_adamw)
    assert row_adamw.launches == before
    ref = jax_update(*(jnp.asarray(x) for x in (table, m, v, ids, mask, g)), 1e-2,
                     jnp.asarray(3), JaxCfg(weight_decay=0.01))
    for o, r, b in zip(out, ref, (table, m, v)):
        np.testing.assert_array_equal(o[0], b[0])
        np.testing.assert_allclose(o, np.asarray(r), **TOL)


def test_two_steps_are_deterministic():
    table, m, v, ids, mask, g = _inputs(seed=5)
    runs = []
    for _ in range(2):
        state = [table, m, v]
        for step in range(2):
            state = _port(*state, ids, mask, g * (step + 1), 1e-3, step, 0.01)
        runs.append(state)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
