"""Dataloader factory (reference ``REC/data/utils.py:13-77``; port of
``mhrec_tpu/data/loaders.py``, one process). Every model evaluates through
``SeqEvalBatcher``; HLLM trains on ``TextSEQTrainBatcher``'s batches, the
ID models on ``SEQTrainBatcher``'s."""

from __future__ import annotations

from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
from mhrec_tpu_torch.data.trainset import SEQTrainBatcher


def build_eval_dataloaders(config, dataload):
    """Returns the (valid, test) evaluation batchers of one process."""
    return (SeqEvalBatcher(config, dataload, phase="valid"),
            SeqEvalBatcher(config, dataload, phase="test"))


def build_dataloader(config, dataload):
    """Returns the (train, valid, test) batchers of one process."""
    is_text = str(config["model"] or "HSTU") == "HLLM"
    train = (TextSEQTrainBatcher if is_text else SEQTrainBatcher)(config, dataload)
    return (train, *build_eval_dataloaders(config, dataload))
