"""Reference checkpoints → this package's state dict (the counterpart of the
root ``tools/convert_reference_ckpt.py``, which writes the JAX package's
params).

The reference saves its models in two forms (reference trainer.py:344-357,
851-876): an HF-style directory (``pytorch_model.bin``, or the shards that
``pytorch_model.bin.index.json`` lists) and one consolidated file
(``full_model_fp32.pt``, DeepSpeed's fp32 merge), either possibly wrapped in
``{"state_dict" | "module" | "model_state_dict": ...}`` and its names
prefixed ``_forward_module.`` or ``module.``. ``load_reference_state_dict``
reads both into float32 tensors.

The converters map the reference's names onto the port's, as the root
tool maps them onto JAX's: HSTU, HLLM, and ComiRec / REMI (one surface).
Both frameworks keep ``nn.Linear``'s [out, in] layout, so nothing is
transposed. A position table of another row count is cut or zero-padded
(``fit_rows``), the reference's STU norms, which have no parameters, become
unit scales and zero biases, and the HLLM towers go through the HF maps of
``models/llm/loader.py``. A parameter the checkpoint lacks keeps its
initial value and is reported missing; a reference tensor with no target
is reported unused.

CLI (the run's config files and overrides, as for ``run``)::

    python -m mhrec_tpu_torch.convert_reference --ckpt full_model_fp32.pt \\
        --config_file IDNet/hstu-size4.yaml overall/ID.yaml IDNet/hstu.yaml -- \\
        --data_path ... --dataset ... --checkpoint_dir ./saved

writes the port's checkpoint of the run, which ``python -m
mhrec_tpu_torch.run <the same arguments> --val_only True`` then serves. It
builds the model on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_WRAPPER_PREFIXES = ("_forward_module.", "module.")
_CONTAINER_KEYS = ("state_dict", "module", "model_state_dict")


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (a file or an HF-style directory) as a flat
    {name: float32 tensor} dict, its containers unwrapped and its wrapper
    prefixes taken off (root tool ``load_reference_state_dict``)."""

    def flat(sd):
        out = {}
        for k, v in sd.items():
            if not isinstance(v, torch.Tensor):
                continue
            for pref in _WRAPPER_PREFIXES:
                while k.startswith(pref):
                    k = k[len(pref):]
            out[k] = v.detach().float().cpu()
        return out

    def unwrap(obj):
        if isinstance(obj, dict):
            for ck in _CONTAINER_KEYS:
                if ck in obj and isinstance(obj[ck], dict):
                    return unwrap(obj[ck])
        return obj

    if os.path.isdir(path):
        index = os.path.join(path, "pytorch_model.bin.index.json")
        if os.path.isfile(index):
            with open(index) as fh:
                shards = sorted(set(json.load(fh)["weight_map"].values()))
            sd: Dict[str, torch.Tensor] = {}
            for shard in shards:
                sd.update(flat(unwrap(torch.load(os.path.join(path, shard), map_location="cpu",
                                                 weights_only=True))))
            return sd
        for cand in ("pytorch_model.bin", "full_model_fp32.pt"):
            fp = os.path.join(path, cand)
            if os.path.isfile(fp):
                return load_reference_state_dict(fp)
        raise FileNotFoundError(
            f"no pytorch_model.bin(.index.json) or full_model_fp32.pt in {path}")
    # the consolidated file may pickle more than tensors, as the root tool allows
    return flat(unwrap(torch.load(path, map_location="cpu", weights_only=False)))


def fit_rows(src: torch.Tensor, like: torch.Tensor, name: str) -> torch.Tensor:
    """``src`` with ``like``'s row count: the reference's position table has
    L + 1 rows however the run was configured (root tool ``_fit_rows``)."""
    if src.shape == like.shape:
        return src
    if src.shape[1:] == like.shape[1:]:
        n = like.shape[0]
        if src.shape[0] >= n:
            logger.info("%s: truncating rows %d -> %d", name, src.shape[0], n)
            return src[:n]
        logger.info("%s: zero-padding rows %d -> %d", name, src.shape[0], n)
        out = torch.zeros(like.shape, dtype=src.dtype)
        out[:src.shape[0]] = src
        return out
    raise ValueError(f"{name}: shape {tuple(src.shape)} incompatible with {tuple(like.shape)}")


class _Mapper:
    """Reference names → the port's state dict ``target`` (shapes and
    dtypes), keeping track of the reference names used and missing."""

    def __init__(self, sd: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor]):
        self.sd, self.target = sd, target
        self.out: Dict[str, torch.Tensor] = {}
        self.used: set = set()
        self.missing: List[str] = []

    def has(self, key: str) -> bool:
        return key in self.target

    def take(self, key: str) -> Optional[torch.Tensor]:
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def put(self, key: str, value: Optional[torch.Tensor], like_rows: bool = False):
        if value is None:
            return
        like = self.target[key]
        if like_rows:
            value = fit_rows(value, like, key)
        if value.shape != like.shape:
            raise ValueError(f"{key}: reference shape {tuple(value.shape)} != ours "
                             f"{tuple(like.shape)} — config mismatch with the original run?")
        self.out[key] = value.to(like.dtype)

    def move(self, key: str, ref: str, like_rows: bool = False):
        self.put(key, self.take(ref), like_rows)

    def identity_norm(self, prefix: str):
        """A reference STU norm (``F.layer_norm`` without parameters)."""
        for part, fill in (("weight", 1.0), ("bias", 0.0)):
            key = f"{prefix}.{part}"
            if self.has(key):
                self.out[key] = torch.full_like(self.target[key], fill)

    def stu(self, ours: str, ref: str):
        self.move(f"{ours}.uvqk", f"{ref}._uvqk")
        self.move(f"{ours}.o_proj.weight", f"{ref}._o.weight")
        self.move(f"{ours}.o_proj.bias", f"{ref}._o.bias")
        for norm in ("input_norm", "attn_norm"):
            self.identity_norm(f"{ours}.{norm}")

    def results(self):
        return self.out, sorted(self.used), self.missing, sorted(set(self.sd) - self.used)


def _convert_medusa_heads(m: _Mapper, config):
    """The multi-head surface that HSTU and HLLM share (medusa, cat and seg
    heads, ``segment_emb``, the switch classifiers): the reference's
    ``nn.Sequential`` of ResBlocks is the port's ``MedusaHead.res``."""
    if config.get("cat_bottleneck"):
        raise NotImplementedError(
            "cat_bottleneck head conversion is not wired (no reference "
            "reproduce protocol uses it)")

    def resblocks(ours, ref):
        j = 0
        while m.has(f"{ours}.res.{j}.linear.weight"):
            m.move(f"{ours}.res.{j}.linear.weight", f"{ref}.{j}.linear.weight")
            m.move(f"{ours}.res.{j}.linear.bias", f"{ref}.{j}.linear.bias")
            if m.has(f"{ours}.res.{j}.norm.weight"):
                m.move(f"{ours}.res.{j}.norm.weight", f"{ref}.{j}.norm.weight")
                m.move(f"{ours}.res.{j}.norm.bias", f"{ref}.{j}.norm.bias")
            j += 1

    C = int(config.get("num_prior_head") or 1)
    S = int(config.get("num_segment_head") or 1)
    if config.get("head_interaction") == "hierarchical":
        for c in range(C):
            resblocks(f"medusa_cat_head.{c}.0", f"medusa_cat_head.{c}")
            if config.get("share_seg_weights"):
                resblocks(f"medusa_seg_head.{c}", f"medusa_seg_head.{c}.0")
            else:
                for s in range(S):
                    resblocks(f"medusa_seg_head.{c}.{s}", f"medusa_seg_head.{c}.{s}")
    else:
        h = 0
        while any(k.startswith(f"medusa_head.{h}.") for k in m.target):
            resblocks(f"medusa_head.{h}", f"medusa_head.{h}")
            h += 1
    if m.has("segment_emb.weight"):
        m.move("segment_emb.weight", "segment_emb.weight")
    c = 0
    while m.has(f"aux_cat_head.{c}.weight"):
        m.move(f"aux_cat_head.{c}.weight", f"aux_cat_head.{c}.weight")
        m.move(f"aux_cat_head.{c}.bias", f"aux_cat_head.{c}.bias")
        c += 1


def convert_hstu(sd, target, config):
    """A reference HSTU (hstu.py:380-543: the item and position tables,
    ``_hstu._attention_layers.{i}`` STU blocks, their ``_rel_attn_bias``,
    the heads, ``segment_emb``, ``logit_scale``) onto the port's names.
    Returns (state, used, missing, unused)."""
    m = _Mapper(sd, target)
    m.move("item_embedding.weight", "item_embedding.weight")
    m.move("position_embedding.weight", "position_embedding.weight", like_rows=True)
    if m.has("item_proj.weight"):
        m.move("item_proj.weight", "item_id_proj_tower.weight")
    if m.has("logit_scale"):
        m.move("logit_scale", "logit_scale")
    for i in range(int(config["n_layers"])):
        ref = f"_hstu._attention_layers.{i}"
        m.stu(f"stu_layers.{i}", ref)
        if m.has(f"rel_bias.{i}.ts_w"):
            m.move(f"rel_bias.{i}.ts_w", f"{ref}._rel_attn_bias._ts_w")
            m.move(f"rel_bias.{i}.pos_w", f"{ref}._rel_attn_bias._pos_w", like_rows=True)
    _convert_medusa_heads(m, config)
    return m.results()


def convert_hllm(sd, target, config):
    """A reference HLLM (hllm.py:69-252: ``item_llm.*`` and ``user_llm.*``
    HF tower weights, ``item_emb_tokens``, ``logit_scale``, the heads) onto
    the port's names; the towers through the HF maps the pretrain-directory
    loader uses (every tensor under a tower's prefix counts as used, as in
    the root tool)."""
    from mhrec_tpu_torch.models.llm import loader
    from mhrec_tpu_torch.models.llm.config import LLMConfig

    m = _Mapper(sd, target)

    def tower(name, pretrain_dir):
        tower_sd = {k[len(name) + 1:]: v for k, v in sd.items() if k.startswith(f"{name}.")}
        if not tower_sd:
            m.missing.append(f"{name}.*")
            return
        cfg = LLMConfig.from_pretrained_dir(pretrain_dir)
        to_tower = (loader.bert_state_dict_from_hf if cfg.model_type == "bert"
                    else loader.llama_state_dict_from_hf)
        has_table = any(m.has(f"{name}.{t}.weight") for t in ("embed_tokens", "word_embeddings"))
        for k, v in to_tower(tower_sd, cfg, token_embeddings=has_table).items():
            m.put(f"{name}.{k}", v.float())
        m.used.update(f"{name}.{k}" for k in tower_sd)

    if any(k.startswith("item_llm.") for k in target):
        tower("item_llm", config["item_pretrain_dir"])
    if any(k.startswith("user_llm.") for k in target):
        tower("user_llm", config["user_pretrain_dir"] or config["item_pretrain_dir"])
    if m.has("item_emb_tokens"):
        m.move("item_emb_tokens", "item_emb_tokens")
    if m.has("logit_scale"):
        m.move("logit_scale", "logit_scale")
    _convert_medusa_heads(m, config)
    return m.results()


def convert_comirec(sd, target, config):
    """A reference ComiRec or REMI (comirec.py:52-107, remi.py:53-106, one
    surface: the flat tables, the ``_hstu._attention_layers.{i}`` trunk, the
    ``attention_net`` extractor, ``item_id_proj_tower``, ``logit_scale``)
    onto the port's ``trunk``-nested names."""
    m = _Mapper(sd, target)
    m.move("trunk.item_embedding.weight", "item_embedding.weight")
    m.move("trunk.position_embedding.weight", "position_embedding.weight", like_rows=True)
    if m.has("trunk.item_id_proj_tower.weight"):
        m.move("trunk.item_id_proj_tower.weight", "item_id_proj_tower.weight")
    if m.has("logit_scale"):
        m.move("logit_scale", "logit_scale")
    i = 0
    while m.has(f"trunk.stu_layers.{i}.uvqk"):
        m.stu(f"trunk.stu_layers.{i}", f"_hstu._attention_layers.{i}")
        i += 1
    # nn.Sequential(Linear, Tanh, Dropout, Linear): indices 0 and 3
    m.move("trunk.attn_hidden.weight", "attention_net.0.weight")
    if m.has("trunk.attn_hidden.bias"):
        m.move("trunk.attn_hidden.bias", "attention_net.0.bias")
    m.move("trunk.attn_out.weight", "attention_net.3.weight")
    return m.results()


CONVERTERS = {
    "HSTU": convert_hstu,
    "HLLM": convert_hllm,
    "ComiRec": convert_comirec,
    "REMI": convert_comirec,
}


def check_convertible(config) -> str:
    """The model's name, or the root tool's refusal."""
    model_name = str(config["model"])
    if model_name not in CONVERTERS:
        raise NotImplementedError(
            f"converter handles {sorted(CONVERTERS)} checkpoints "
            f"(model={model_name}); SASRec/DualVAE/LLMIDRec reference "
            f"checkpoints have no reproduce protocol — file an issue with "
            f"the run config if you need one")
    if model_name == "HLLM" and config.get("use_image"):
        raise NotImplementedError(
            "vision-tower (use_image) HLLM checkpoint conversion is not "
            "wired — the Qwen2-VL visual weights live inside the reference "
            "item_llm; convert the text-only surface or load the towers "
            "directly from their HF dirs")
    return model_name


def convert(sd: Dict[str, torch.Tensor], model: torch.nn.Module, config
            ) -> Tuple[Dict[str, torch.Tensor], list, list, list]:
    """``model``'s state dict with the reference tensors of ``sd`` in place
    of its parameters' (the rest at their current values, buffers too), and
    the used, missing and unused reference names."""
    target = {k: v.detach() for k, v in model.named_parameters()}
    mapped, used, missing, unused = CONVERTERS[check_convertible(config)](sd, target, config)
    return dict(model.state_dict(), **mapped), used, missing, unused


def main(argv=None) -> dict:
    """The CLI: convert ``--ckpt`` and write the run's checkpoint. Returns
    its path, the tensors mapped and the seconds and bytes of the read and
    the conversion."""
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.run import load_data
    from mhrec_tpu_torch.trainer import Trainer
    from mhrec_tpu_torch.utils import resolve_device

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="reference checkpoint: full_model_fp32.pt / pytorch_model.bin / "
                         "HF-style shard directory")
    ap.add_argument("--config_file", nargs="+", required=True)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args, extra = ap.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    if args.device is None and "--device" in extra[:-1]:
        i = extra.index("--device")
        args.device = extra[i + 1]
        del extra[i:i + 2]
    config = Config(config_file_list=args.config_file, cli_args=extra).finalize()
    check_convertible(config)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    sd = load_reference_state_dict(args.ckpt)
    read_s = time.perf_counter() - t0
    logger.info("loaded %d tensors from %s", len(sd), args.ckpt)
    trainer = Trainer(config, load_data(config), device=device)
    trainer.setup_model()
    t1 = time.perf_counter()
    state, used, missing, unused = convert(sd, trainer.model, config)
    trainer.model.load_state_dict(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t1
    logger.info("mapped %d reference tensors", len(used))
    if missing:
        logger.warning("reference checkpoint MISSING %d expected tensors (left at init): %s",
                       len(missing), missing[:20])
    if unused:
        logger.warning("%d reference tensors UNUSED (no target here): %s", len(unused),
                       unused[:20])
    trainer.async_checkpoint = False
    trainer.save_checkpoint()
    logger.info("wrote converted checkpoint to %s", trainer.saved_model_dir)
    print(trainer.saved_model_dir)
    return {"checkpoint_dir": trainer.saved_model_dir, "used": len(used),
            "missing": missing, "unused": unused, "read_s": read_s, "convert_s": convert_s,
            "bytes": sum(t.numel() * t.element_size() for t in sd.values())}


if __name__ == "__main__":
    main()
