"""Weight bridge: the JAX package's flax ``HSTU`` parameter tree → this
package's ``HSTU`` ``state_dict``.

Flax ``Dense`` kernels are [in, out] and become ``nn.Linear`` weights
[out, in]; the fused ``uvqk`` projection keeps its [D, 4 splits] layout
(split order u, v, q, k, silu before the split — hstu.py:62-69). The key walk
follows ``tools/convert_reference_ckpt.py:208-248``. A flax parameter the
walk does not use, or one it needs and does not find, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def state_dict_from_flax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """``params``: nested dict of numpy arrays (the flax ``params``
    collection of ``mhrec_tpu.models.idnet.hstu.HSTU``); ``config``: the
    Config the model was built from."""
    flat = _flatten(params)
    used = set()
    sd: Dict[str, torch.Tensor] = {}

    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"flax parameter {path!r} is missing")
        used.add(path)
        return flat[path]

    def put(key: str, path: str, transpose: bool = False):
        arr = take(path)
        sd[key] = torch.from_numpy(np.array(arr.T if transpose else arr))  # owned copy

    def put_dense(prefix: str, path: str):
        put(f"{prefix}.weight", f"{path}/kernel", transpose=True)
        put(f"{prefix}.bias", f"{path}/bias")

    def put_norm(prefix: str, path: str):
        put(f"{prefix}.weight", f"{path}/scale")
        put(f"{prefix}.bias", f"{path}/bias")

    def put_resblocks(prefix: str, path: str):
        r = 0
        while f"{path}/res_{r}/Dense_0/kernel" in flat:
            put_dense(f"{prefix}.res.{r}.linear", f"{path}/res_{r}/Dense_0")
            if f"{path}/res_{r}/LayerNorm_0/scale" in flat:
                put_norm(f"{prefix}.res.{r}.norm", f"{path}/res_{r}/LayerNorm_0")
            r += 1

    put("item_embedding.weight", "item_embedding/embedding")
    if "item_proj/kernel" in flat:
        put("item_proj.weight", "item_proj/kernel", transpose=True)
    put("position_embedding.weight", "position_embedding/embedding")
    for i in range(int(config["n_layers"])):
        p, t = f"stu_{i}", f"stu_layers.{i}"
        put_norm(f"{t}.input_norm", f"{p}/input_norm")
        put(f"{t}.uvqk", f"{p}/uvqk")
        put_norm(f"{t}.attn_norm", f"{p}/attn_norm")
        put_dense(f"{t}.o_proj", f"{p}/o_proj")
        if config["enable_relative_attention_bias"]:
            put(f"rel_bias.{i}.ts_w", f"rel_bias_{i}/ts_w")
            put(f"rel_bias.{i}.pos_w", f"rel_bias_{i}/pos_w")
    if not config["fix_temp"]:
        put("logit_scale", "logit_scale")

    S = int(config["num_segment_head"] or 1)
    C = int(config["num_prior_head"] or 1)
    hi = config["head_interaction"]
    if hi == "hierarchical" and (config["medusa_num_layers"] or 0) > 0:
        for c in range(C):
            b = 0
            if config.get("cat_bottleneck", False):
                put_norm(f"medusa_cat_head.{c}.0.norm", f"cat_bneck_{c}/LayerNorm_0")
                put_dense(f"medusa_cat_head.{c}.0.down", f"cat_bneck_{c}/Dense_0")
                put_dense(f"medusa_cat_head.{c}.0.up", f"cat_bneck_{c}/Dense_1")
                b = 1
            put_resblocks(f"medusa_cat_head.{c}.{b}", f"cat_head_{c}")
            if config.get("share_seg_weights", False):
                put_resblocks(f"medusa_seg_head.{c}", f"seg_head_shared_{c}")
            else:
                for s in range(S):
                    put_resblocks(f"medusa_seg_head.{c}.{s}", f"seg_head_{c}_{s}")
        if config.get("segment_embed", False):
            put("segment_emb.weight", "segment_emb/embedding")
    else:
        n_heads = S + C if hi == "additive" else S * C
        for h in range(n_heads):
            put_resblocks(f"medusa_head.{h}", f"medusa_head_{h}")
    if config["loss"] == "prior" and config["prior_switch"] is not None:
        for c in range(1 if config.get("master_switch", False) else C):
            put_dense(f"aux_cat_head.{c}", f"aux_cat_head_{c}")

    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"flax parameters with no counterpart in the port: {unused}")
    return sd
