"""REMI — ComiRec-SA with Interest-aware Hard Negative mining (IHN) and
Routing Regularization (RR) (port of ``mhrec_tpu/models/idnet/remi.py``).

Reference ``code/REC/model/IDNet/remi.py``: the same multi-interest trunk as
ComiRec (remi.py:40-100), plus the RR loss over the routing weights'
variances (remi.py:156-199) and the IHN importance-sampled NCE
(remi.py:201-278). Both live in ``comirec.py``; REMI is the ComiRec module
with ``lambda_rr`` / ``beta_ihn`` active.
"""

from __future__ import annotations

import torch

from mhrec_tpu_torch.models.idnet.comirec import ComiRec

REMI = ComiRec  # the same module; REMI lives in the loss hyperparameters


def remi_from_config(config, dataload, dtype=torch.float32) -> ComiRec:
    dim = config["hstu_embedding_size"]
    hidden = config.get("interest_hidden", 0) or int(
        dim * config.get("interest_hidden_ratio", 0.5))
    return ComiRec(
        item_num=dataload.item_num,
        item_embedding_size=config["item_embedding_size"],
        hstu_embedding_size=dim,
        max_seq_length=config["MAX_ITEM_LIST_LENGTH"],
        pred_len=config["pred_len"],
        n_layers=config["n_layers"],
        n_heads=config["n_heads"],
        hidden_act=config["hidden_act"] or "silu",
        hidden_dropout_prob=config["hidden_dropout_prob"] or 0.1,
        num_interest=config.get("interest_num", config.get("num_interest", 4)),
        interest_hidden=hidden,
        attention_net_bias=config.get("attention_net_bias", True),
        skip_hstu=config.get("skip_hstu", False),
        use_input_dropout=config.get("input_dropout", False),
        medusa_lambda=config["medusa_lambda"],
        nce_thres=config["nce_thres"] or 0.99,
        fix_temp=bool(config["fix_temp"]),
        lambda_rr=float(config.get("lambda_rr", 0.0) or 0.0),
        beta_ihn=float(config.get("beta_ihn", 0.0) or 0.0),
        dtype=dtype,
    )
