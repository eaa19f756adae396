"""Weight bridge: the JAX package's flax ``HSTU``, ``HLLM`` or baseline
(SASRec, ComiRec, REMI, DualVAE, LLMIDRec) parameter tree → this package's
``state_dict`` of the same model.

Flax ``Dense`` kernels are [in, out] and become ``nn.Linear`` weights
[out, in]; the fused ``uvqk`` projection keeps its [D, 4 splits] layout
(split order u, v, q, k, silu before the split — hstu.py:62-69). The Llama
towers' ``DenseGeneral`` attention kernels [D, heads, dh] become [heads·dh,
D] weights, and a BERT tower's fused ``qkv`` kernel [D, 3, heads, dh] one
[3·heads·dh, D] weight. A scanned HSTU stack (``scan_layers``: each leaf
of ``stu_stack/layers/stu`` stacked on a leading [n_layers] axis) maps
onto the same unrolled ``stu_layers`` as the unrolled tree. An HLLM's
``visual`` tower (Qwen2-VL: ``patch_embed``, ``blocks_{i}``, ``ln_q``,
``merger_fc1/2``; CLIP / LLaVA: also ``position_embedding``,
``class_embedding``, ``pre_layernorm``, ``proj_fc1/2``, ``image_newline``)
maps onto the port's ``visual`` with ``blocks_{i}`` as ``blocks.{i}``.
SASRec's encoder takes the BERT layer map (``trm_encoder/layer_{i}``),
ComiRec's and REMI's ``trunk/stu_{i}`` the HSTU layer map, LLMIDRec's
``user_llm`` the Llama tower map, DualVAE's ``inf_fc{i}`` / ``inf_ln{i}``
become ``inf_fc.{i}`` / ``inf_ln.{i}``. The key walk follows ``tools/convert_reference_ckpt.py:208-248``. A flax parameter the
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


class _Walk:
    """Flax paths → state_dict keys, with the paths used kept track of."""

    def __init__(self, params: Mapping):
        self.flat = _flatten(params)
        self.used = set()
        self.sd: Dict[str, torch.Tensor] = {}

    def has(self, path: str) -> bool:
        return path in self.flat

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"flax parameter {path!r} is missing")
        self.used.add(path)
        return self.flat[path]

    def put(self, key: str, path: str, transpose: bool = False, layer=None):
        """``layer``: the slice of a leaf stacked on a leading [n_layers]
        axis (a scanned stack's) that ``key`` takes."""
        arr = self.take(path)
        if layer is not None:
            arr = arr[layer]
        self.sd[key] = torch.from_numpy(np.array(arr.T if transpose else arr))  # owned copy

    def put_dense(self, prefix: str, path: str, layer=None):
        self.put(f"{prefix}.weight", f"{path}/kernel", transpose=True, layer=layer)
        self.put(f"{prefix}.bias", f"{path}/bias", layer=layer)

    def put_norm(self, prefix: str, path: str, layer=None):
        self.put(f"{prefix}.weight", f"{path}/scale", layer=layer)
        self.put(f"{prefix}.bias", f"{path}/bias", layer=layer)

    def put_resblocks(self, prefix: str, path: str):
        r = 0
        while self.has(f"{path}/res_{r}/Dense_0/kernel"):
            self.put_dense(f"{prefix}.res.{r}.linear", f"{path}/res_{r}/Dense_0")
            if self.has(f"{path}/res_{r}/LayerNorm_0/scale"):
                self.put_norm(f"{prefix}.res.{r}.norm", f"{path}/res_{r}/LayerNorm_0")
            r += 1

    def put_flat_dense(self, prefix: str, path: str):
        """A ``DenseGeneral`` over several output axes: kernel [D, ...] →
        weight [prod(...), D], bias [...] → [prod(...)]."""
        kernel = self.take(f"{path}/kernel")
        self.sd[f"{prefix}.weight"] = torch.from_numpy(
            np.array(kernel.reshape(kernel.shape[0], -1).T))
        if self.has(f"{path}/bias"):
            self.sd[f"{prefix}.bias"] = torch.from_numpy(
                np.array(self.take(f"{path}/bias").reshape(-1)))

    def put_bert(self, tower: str):
        """A BERT backbone under ``tower``."""
        if self.has(f"{tower}/word_embeddings/embedding"):
            self.put(f"{tower}.word_embeddings.weight", f"{tower}/word_embeddings/embedding")
        self.put(f"{tower}.position_embeddings.weight",
                 f"{tower}/position_embeddings/embedding")
        self.put_norm(f"{tower}.embeddings_ln", f"{tower}/embeddings_ln")
        self.put_encoder(f"{tower}.encoder", f"{tower}/encoder")

    def put_encoder(self, prefix: str, path: str):
        """A ``TransformerEncoder``: ``layer_{i}`` with its fused ``qkv``
        kernel [D, 3, heads, dh] → ``layers.{i}`` with a [3·D, D] weight."""
        i = 0
        while self.has(f"{path}/layer_{i}/qkv/kernel"):
            p, t = f"{path}/layer_{i}", f"{prefix}.layers.{i}"
            self.put_flat_dense(f"{t}.qkv", f"{p}/qkv")
            for dense in ("attn_out", "ff_in", "ff_out"):
                self.put_dense(f"{t}.{dense}", f"{p}/{dense}")
            for norm in ("attn_ln", "ff_ln"):
                self.put_norm(f"{t}.{norm}", f"{p}/{norm}")
            i += 1

    def put_stu(self, t: str, p: str, layer=None):
        """One STU layer (``input_norm``, ``uvqk``, ``attn_norm``, ``o_proj``)."""
        self.put_norm(f"{t}.input_norm", f"{p}/input_norm", layer=layer)
        self.put(f"{t}.uvqk", f"{p}/uvqk", layer=layer)
        self.put_norm(f"{t}.attn_norm", f"{p}/attn_norm", layer=layer)
        self.put_dense(f"{t}.o_proj", f"{p}/o_proj", layer=layer)

    def put_tower(self, tower: str):
        """A Llama or BERT backbone (or the dummy backend) under ``tower``:
        Llama's ``DenseGeneral`` attention kernels [D, heads, dh] become
        [heads·dh, D]."""
        if self.has(f"{tower}/position_embeddings/embedding"):
            return self.put_bert(tower)
        if self.has(f"{tower}/embed_layer/kernel"):  # DummyLLM
            if self.has(f"{tower}/input_layer/embedding"):
                self.put(f"{tower}.input_layer.weight", f"{tower}/input_layer/embedding")
            self.put_dense(f"{tower}.embed_layer", f"{tower}/embed_layer")
            return
        # a tower fed only inputs_embeds has no token table
        if self.has(f"{tower}/embed_tokens/embedding"):
            self.put(f"{tower}.embed_tokens.weight", f"{tower}/embed_tokens/embedding")
        self.put(f"{tower}.norm.weight", f"{tower}/norm/weight")
        i = 0
        while self.has(f"{tower}/layers_{i}/input_layernorm/weight"):
            p, t = f"{tower}/layers_{i}", f"{tower}.layers.{i}"
            for norm in ("input_layernorm", "post_attention_layernorm"):
                self.put(f"{t}.{norm}.weight", f"{p}/{norm}/weight")
            for proj in ("q_proj", "k_proj", "v_proj"):
                self.put_flat_dense(f"{t}.self_attn.{proj}", f"{p}/self_attn/{proj}")
            self.put(f"{t}.self_attn.o_proj.weight", f"{p}/self_attn/o_proj/kernel",
                     transpose=True)
            for proj in ("gate_proj", "up_proj", "down_proj"):
                self.put(f"{t}.mlp.{proj}.weight", f"{p}/mlp/{proj}/kernel", transpose=True)
            i += 1

    def put_visual(self, tower: str):
        """A Qwen2-VL ``VisionTower`` or a ``ClipVisionTower`` under
        ``tower``."""
        if self.has(f"{tower}/patch_embed/bias"):
            self.put_dense(f"{tower}.patch_embed", f"{tower}/patch_embed")
        else:
            self.put(f"{tower}.patch_embed.weight", f"{tower}/patch_embed/kernel", transpose=True)
        clip = self.has(f"{tower}/proj_fc1/kernel")
        norms = ("layer_norm1", "layer_norm2") if clip else ("norm1", "norm2")
        denses = (("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2") if clip
                  else ("qkv", "proj", "fc1", "fc2"))
        i = 0
        while self.has(f"{tower}/blocks_{i}/{norms[0]}/scale"):
            p, t = f"{tower}/blocks_{i}", f"{tower}.blocks.{i}"
            for norm in norms:
                self.put_norm(f"{t}.{norm}", f"{p}/{norm}")
            for dense in denses:
                self.put_dense(f"{t}.{dense}", f"{p}/{dense}")
            i += 1
        if clip:
            for name in ("position_embedding", "class_embedding", "image_newline"):
                if self.has(f"{tower}/{name}"):
                    self.put(f"{tower}.{name}", f"{tower}/{name}")
            if self.has(f"{tower}/pre_layernorm/scale"):
                self.put_norm(f"{tower}.pre_layernorm", f"{tower}/pre_layernorm")
            for dense in ("proj_fc1", "proj_fc2"):
                self.put_dense(f"{tower}.{dense}", f"{tower}/{dense}")
        else:
            self.put_norm(f"{tower}.ln_q", f"{tower}/ln_q")
            for dense in ("merger_fc1", "merger_fc2"):
                self.put_dense(f"{tower}.{dense}", f"{tower}/{dense}")

    def finish(self) -> Dict[str, torch.Tensor]:
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise ValueError(f"flax parameters with no counterpart in the port: {unused}")
        return self.sd


def llama_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax params of one ``LlamaBackbone`` (or ``DummyLLM``) → the
    ``state_dict`` of this package's counterpart."""
    walk = _Walk({"tower": params})
    walk.put_tower("tower")
    return {k[len("tower."):]: v for k, v in walk.finish().items()}


def bert_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax params of one ``BertBackbone`` → the ``state_dict`` of this
    package's counterpart."""
    walk = _Walk({"tower": params})
    walk.put_bert("tower")
    return {k[len("tower."):]: v for k, v in walk.finish().items()}


def vision_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax params of one ``VisionTower`` or ``ClipVisionTower`` → the
    ``state_dict`` of this package's counterpart."""
    walk = _Walk({"tower": params})
    walk.put_visual("tower")
    return {k[len("tower."):]: v for k, v in walk.finish().items()}


def _put_baseline(walk: _Walk, name: str):
    """The five baselines' trees (the JAX package's ``models/idnet``)."""
    put, put_dense, put_norm = walk.put, walk.put_dense, walk.put_norm
    if name in ("ComiRec", "REMI"):
        put("trunk.item_embedding.weight", "trunk/item_embedding/embedding")
        if walk.has("trunk/item_id_proj_tower/kernel"):
            put("trunk.item_id_proj_tower.weight", "trunk/item_id_proj_tower/kernel",
                transpose=True)
        put("trunk.position_embedding.weight", "trunk/position_embedding/embedding")
        i = 0
        while walk.has(f"trunk/stu_{i}/uvqk"):
            walk.put_stu(f"trunk.stu_layers.{i}", f"trunk/stu_{i}")
            i += 1
        put("trunk.attn_hidden.weight", "trunk/attn_hidden/kernel", transpose=True)
        if walk.has("trunk/attn_hidden/bias"):
            put("trunk.attn_hidden.bias", "trunk/attn_hidden/bias")
        put("trunk.attn_out.weight", "trunk/attn_out/kernel", transpose=True)
        return
    put("item_embedding.weight", "item_embedding/embedding")
    if name == "SASRec":
        put("position_embedding.weight", "position_embedding/embedding")
        put_norm("input_norm", "input_norm")
        walk.put_encoder("trm_encoder", "trm_encoder")
    elif name == "DualVAE":
        put("position_embedding.weight", "position_embedding/embedding")
        put_norm("input_layernorm", "input_layernorm")
        put_dense("item_proj", "item_proj")
        put("item_topics", "item_topics")
        put_dense("pool_hidden", "pool_hidden")
        put("pool_out.weight", "pool_out/kernel", transpose=True)
        i = 0
        while walk.has(f"inf_fc{i}/kernel"):
            put_dense(f"inf_fc.{i}", f"inf_fc{i}")
            put_norm(f"inf_ln.{i}", f"inf_ln{i}")
            i += 1
        put_dense("user_mu", "user_mu")
        put_dense("user_std", "user_std")
    else:  # LLMIDRec
        if walk.has("item_id_proj_tower/kernel"):
            put("item_id_proj_tower.weight", "item_id_proj_tower/kernel", transpose=True)
        walk.put_tower("user_llm")


BASELINES = ("SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec")


def state_dict_from_flax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """``params``: nested dict of numpy arrays (the flax ``params``
    collection of ``mhrec_tpu.models.idnet.hstu.HSTU``, of one of the five
    baselines of ``mhrec_tpu.models.idnet`` or of
    ``mhrec_tpu.models.hllm.hllm.HLLM``); ``config``: the Config the model
    was built from."""
    walk = _Walk(params)
    flat, put, put_dense, put_norm = walk.flat, walk.put, walk.put_dense, walk.put_norm
    put_resblocks = walk.put_resblocks

    name = str(config["model"] or "HSTU")
    if name in BASELINES:
        _put_baseline(walk, name)
        if not config["fix_temp"]:
            put("logit_scale", "logit_scale")
        return walk.finish()
    if name == "HLLM":
        if "item_llm" in params:
            walk.put_tower("item_llm")
        if "visual" in params:
            walk.put_visual("visual")
        walk.put_tower("user_llm")
        if "item_emb_tokens" in flat:
            put("item_emb_tokens", "item_emb_tokens")
    else:
        put("item_embedding.weight", "item_embedding/embedding")
        if "item_proj/kernel" in flat:
            put("item_proj.weight", "item_proj/kernel", transpose=True)
        put("position_embedding.weight", "position_embedding/embedding")
        # a scanned stack (ScannedSTUStack) stacks each leaf on a leading
        # [n_layers] axis; its slice i goes to the unrolled layer i
        n_layers = int(config["n_layers"])
        scanned = "stu_stack" in params
        if scanned:
            depths = {v.shape[0] for k, v in flat.items() if k.startswith("stu_stack/")}
            if depths != {n_layers}:
                raise ValueError(f"scanned stack of depth {sorted(depths)}, config n_layers "
                                 f"{n_layers}")
        for i in range(n_layers):
            p, layer = ("stu_stack/layers/stu", i) if scanned else (f"stu_{i}", None)
            walk.put_stu(f"stu_layers.{i}", p, layer=layer)
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

    return walk.finish()
