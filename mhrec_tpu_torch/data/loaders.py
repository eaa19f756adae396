"""Dataloader factory (reference ``REC/data/utils.py:13-77``; port of
``mhrec_tpu/data/loaders.py``). Every model evaluates through
``SeqEvalBatcher``; HLLM trains on ``TextSEQTrainBatcher``'s batches, the
ID models on ``SEQTrainBatcher``'s. ``host_id`` / ``num_hosts``: this
rank's share of every global batch (users and train samples strided over
the ranks, and for HLLM the texts of those samples' items)."""

from __future__ import annotations

from mhrec_tpu_torch.data.evalset import SeqEvalBatcher
from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
from mhrec_tpu_torch.data.trainset import SEQTrainBatcher


def build_eval_dataloaders(config, dataload, host_id: int = 0, num_hosts: int = 1):
    """Returns the (valid, test) evaluation batchers of rank ``host_id``."""
    return (SeqEvalBatcher(config, dataload, phase="valid", host_id=host_id,
                           num_hosts=num_hosts),
            SeqEvalBatcher(config, dataload, phase="test", host_id=host_id,
                           num_hosts=num_hosts))


def build_dataloader(config, dataload, host_id: int = 0, num_hosts: int = 1):
    """Returns the (train, valid, test) batchers of rank ``host_id``."""
    is_text = str(config["model"] or "HSTU") == "HLLM"
    train = (TextSEQTrainBatcher if is_text else SEQTrainBatcher)(
        config, dataload, host_id=host_id, num_hosts=num_hosts)
    return (train, *build_eval_dataloaders(config, dataload, host_id, num_hosts))
