"""Dataloader factory (reference ``REC/data/utils.py:13-77``).

Only the evaluation batchers are ported so far; the training batchers come
with the training slice.
"""

from __future__ import annotations

from mhrec_tpu_torch.data.evalset import SeqEvalBatcher


def build_eval_dataloaders(config, dataload):
    """Returns the (valid, test) evaluation batchers of one process."""
    return (SeqEvalBatcher(config, dataload, phase="valid"),
            SeqEvalBatcher(config, dataload, phase="test"))
