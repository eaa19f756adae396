"""Model registry: config['model'] name → constructor (port of
``mhrec_tpu/models/factory.py``). Only HSTU is ported so far."""

from __future__ import annotations

import torch

_NOT_PORTED = ("SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec", "HLLM")


def build_model(config, dataload, dtype=torch.bfloat16):
    name = str(config["model"] or "HSTU")
    if name == "HSTU":
        from mhrec_tpu_torch.models.idnet.hstu import hstu_from_config

        return hstu_from_config(config, dataload, dtype=dtype)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    raise ValueError(f"Unknown model {name!r}")
