"""Row-sparse AdamW of the item-table rows a train step touched, as a
hand-written CUDA kernel (``csrc/row_adamw.cu``).

Counterpart of ``sparse_adamw_row_update_pallas``
(``mhrec_tpu/ops/pallas/row_adam_tpu.py``, kernel ``_row_adam_call``). On
CPU tensors ``row_adamw`` runs the plain version
(``trainer/sparse_adam.py::sparse_adamw_row_update``); on CUDA tensors it
launches the kernel or raises. The two perform the same float32 operations
in the same order and agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import torch

from mhrec_tpu_torch.ops import cuda_build
from mhrec_tpu_torch.trainer.sparse_adam import (
    SparseAdamConfig,
    adam_scalars,
    sparse_adamw_row_update,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def row_adamw(table, m, v, ids, grad_rows, lr, step_count: int, cfg: SparseAdamConfig):
    """In place: advance rows ``ids`` of ``table``, ``m``, ``v`` one AdamW
    step (see ``sparse_adamw_row_update``). table, m, v: contiguous float32
    [N, D]; ids: contiguous int64 [U], −1 for pad slots; grad_rows: float32
    [U, D]. Real ids must be unique and below N — the batcher's contract,
    which the kernel does not check: two slots of one row would race.
    ``row_adamw.launches`` counts the kernel's launches."""
    name = "row_adamw"
    # a bf16 table takes sparse_adamw_row_update's own formulation, never
    # this kernel (nor its plain version on the CPU)
    if table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be float32, got {table.dtype}")
    if table.device.type == "cpu":
        return sparse_adamw_row_update(table, m, v, ids, grad_rows, lr, step_count, cfg)
    dev = table.device
    N, D = table.shape
    for t, what in ((table, "table"), (m, "m"), (v, "v")):
        if t.device != dev or t.dtype != torch.float32 or t.shape != (N, D) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 [{N}, {D}] on {dev}")
    if ids.device != dev or ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous int64 vector on {dev}")
    U = ids.shape[0]
    grad_rows = grad_rows.float().contiguous()
    if grad_rows.device != dev or grad_rows.shape != (U, D):
        raise ValueError(f"{name}: grad_rows must be [{U}, {D}] on {dev}")
    lib = cuda_build.load(name)
    fn = lib.row_adamw
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 2 + [_F] * 9 + [_P]
        fn.restype = ctypes.c_int
    s = adam_scalars(lr, step_count, cfg)
    err = fn(table.data_ptr(), m.data_ptr(), v.data_ptr(), ids.data_ptr(), grad_rows.data_ptr(),
             U, D, s["neg_lr"], s["c1"], s["c2"], s["eps"], s["wd"], s["b1"], s["b2"],
             s["omb1"], s["omb2"], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    row_adamw.launches += 1


row_adamw.launches = 0
