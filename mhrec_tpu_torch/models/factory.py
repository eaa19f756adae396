"""Model registry: config['model'] name → constructor (port of
``mhrec_tpu/models/factory.py``)."""

from __future__ import annotations

import torch


def build_model(config, dataload, dtype=None, mesh=None):
    """``dtype``: the trunk's compute type; None takes the model's default,
    the JAX package's: bfloat16 for HSTU and LLMIDRec's user tower,
    ``precision`` for HLLM, float32 for the ComiRec / REMI trunk. SASRec and
    DualVAE compute in float32 whatever it says, as in JAX. ``mesh``: the
    data-parallel group, which an HSTU under ``shard_item_embedding`` splits
    its table over from the start, and over whose model group an HLLM
    splits its Llama towers under ``tp_size > 1``."""
    name = str(config["model"] or "HSTU")
    if name == "HSTU":
        from mhrec_tpu_torch.models.idnet.hstu import hstu_from_config

        return hstu_from_config(config, dataload, dtype=dtype or torch.bfloat16, mesh=mesh)
    if name == "SASRec":
        from mhrec_tpu_torch.models.idnet.sasrec import sasrec_from_config

        return sasrec_from_config(config, dataload)
    if name == "ComiRec":
        from mhrec_tpu_torch.models.idnet.comirec import comirec_from_config

        return comirec_from_config(config, dataload, dtype=dtype or torch.float32)
    if name == "REMI":
        from mhrec_tpu_torch.models.idnet.remi import remi_from_config

        return remi_from_config(config, dataload, dtype=dtype or torch.float32)
    if name == "DualVAE":
        from mhrec_tpu_torch.models.idnet.dualvae import dualvae_from_config

        return dualvae_from_config(config, dataload)
    if name == "LLMIDRec":
        from mhrec_tpu_torch.models.idnet.llmidrec import llmidrec_from_config

        return llmidrec_from_config(config, dataload, dtype=dtype or torch.bfloat16)
    if name == "HLLM":
        from mhrec_tpu_torch.models.hllm.hllm import hllm_from_config

        return hllm_from_config(config, dataload, dtype=dtype, mesh=mesh)
    raise ValueError(f"Unknown model {name!r}")
