"""Model registry: config['model'] name → constructor (port of
``mhrec_tpu/models/factory.py``). HSTU and HLLM are ported so far."""

from __future__ import annotations

import torch

_NOT_PORTED = ("SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec")


def build_model(config, dataload, dtype=None):
    """``dtype``: the trunk's compute type; None takes the model's default
    (bfloat16 for HSTU, ``precision`` for HLLM)."""
    name = str(config["model"] or "HSTU")
    if name == "HSTU":
        from mhrec_tpu_torch.models.idnet.hstu import hstu_from_config

        return hstu_from_config(config, dataload, dtype=dtype or torch.bfloat16)
    if name == "HLLM":
        from mhrec_tpu_torch.models.hllm.hllm import hllm_from_config

        return hllm_from_config(config, dataload, dtype=dtype)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    raise ValueError(f"Unknown model {name!r}")
