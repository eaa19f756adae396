"""Local HF checkpoint → tower state dicts (port of
``mhrec_tpu/models/llm/loader.py``; nothing is downloaded).

``load_state_dict(path)`` reads a checkpoint directory's weights:

* ``*.safetensors``, parsed here and not through the ``safetensors``
  package: an 8-byte little-endian header length, a JSON header naming each
  tensor's dtype, shape and byte range, then the raw bytes, which
  ``torch.frombuffer`` views in place (the file is memory-mapped
  copy-on-write). A sharded set is read through
  ``model.safetensors.index.json``;
* ``pytorch_model*.bin`` (or the shards that ``pytorch_model.bin.index.json``
  lists) through ``torch.load(..., weights_only=True, mmap=True)``.

Tensors keep the checkpoint's dtype; the tower maps cast them to the
parameters' dtype once, when they are copied in (bf16 → f32 is exact).
A file that does not parse raises, and so does a shard that an index lists
and the directory lacks. A directory with neither an index nor a weight
file raises ``NoWeightFiles``, the one case where the caller keeps the
random initialisation.

``llama_state_dict_from_hf`` maps a Llama-family state dict onto
``LlamaBackbone`` names (HF's ``nn.Linear`` layout is the port's, so nothing
is transposed): the bare, ``model.``, ``language_model.model.`` and
``language_model.`` nestings, Baichuan's fused ``W_pack`` [3D, D] split into
q/k/v thirds, q/k/v biases when the config sets ``attention_bias``.
``bert_state_dict_from_hf`` maps a ``BertModel`` onto ``BertBackbone``:
separate q/k/v stacked into the fused ``qkv`` projection, the token-type-0
row folded into the position table (item text always has type 0).
Keys the towers do not use (``lm_head``, the pooler, rotary buffers) are
left out; a key they need and do not find raises ``KeyError``.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import sys
from typing import Dict

import torch

from mhrec_tpu_torch.models.llm.config import LLMConfig

# safetensors dtype names → torch dtypes
_ST_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16,
    "F32": torch.float32, "F64": torch.float64,
}
# a header larger than this is not a safetensors header
_MAX_HEADER = 100 * 2**20


class NoWeightFiles(FileNotFoundError):
    """The directory holds no weight files and no index of any."""


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, viewed in a copy-on-write
    memory map of it. Raises ``ValueError`` on a malformed file."""
    if sys.byteorder != "little":
        raise ValueError("safetensors data is little-endian; this host is not")
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        n = int.from_bytes(head, "little")
        if n > min(size - 8, _MAX_HEADER):
            raise ValueError(f"{path}: header length {n} exceeds the file ({size} bytes)")
        try:
            header = json.loads(fh.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the header is not JSON ({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the header is not a JSON object")
        data_len = size - 8 - n
        buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _ST_DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(x) for x in info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: malformed entry for {name!r}: {info!r}") from None
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= data_len or end - begin != numel * itemsize or min(
                shape, default=0) < 0:
            raise ValueError(f"{path}: {name!r} spans bytes [{begin}, {end}) of {data_len}, "
                             f"which does not hold {info['dtype']} {shape}")
        offset = 8 + n + begin
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif offset % itemsize:  # unaligned: copy the bytes out
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=offset)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel,
                                         offset=offset).reshape(shape)
    return out


def _shards(path: str, index_name: str, pattern: str):
    """The files of a weight set: those the index lists (each must be
    there), else the glob."""
    index = os.path.join(path, index_name)
    if os.path.isfile(index):
        with open(index) as fh:
            weight_map = json.load(fh)["weight_map"]
        files = [os.path.join(path, s) for s in sorted(set(weight_map.values()))]
        missing = [f for f in files if not os.path.isfile(f)]
        if missing:
            raise FileNotFoundError(f"{index} lists shards that are missing: {missing}")
        return files, weight_map
    return sorted(glob.glob(os.path.join(path, pattern))), None


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The HF state dict of a local checkpoint directory (safetensors first,
    then ``pytorch_model*.bin``), on the host, in the checkpoint's dtypes."""
    files, weight_map = _shards(path, "model.safetensors.index.json", "*.safetensors")
    reader = read_safetensors
    if not files:
        files, weight_map = _shards(path, "pytorch_model.bin.index.json", "pytorch_model*.bin")

        def reader(f):
            return torch.load(f, map_location="cpu", weights_only=True, mmap=True)
    if not files:
        raise NoWeightFiles(f"No safetensors/bin weights under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(reader(f))
    if weight_map is not None:
        missing = sorted(set(weight_map) - set(tensors))
        if missing:
            raise ValueError(f"{path}: the index lists tensors its shards lack: {missing[:5]}")
    return tensors


def _getter(sd: Dict[str, torch.Tensor], prefixes):
    def key(name):
        for p in prefixes:
            if p + name in sd:
                return p + name
        raise KeyError(name)

    def has(name):
        return any(p + name in sd for p in prefixes)

    return (lambda name: sd[key(name)]), has


def llama_state_dict_from_hf(sd: Dict[str, torch.Tensor], config: LLMConfig,
                             token_embeddings: bool = True) -> Dict[str, torch.Tensor]:
    """HF Llama-family names → ``LlamaBackbone`` state-dict names.
    ``token_embeddings=False`` leaves out the token table (the user tower
    has none)."""
    t, has = _getter(sd, ("", "model.", "language_model.model.", "language_model."))
    out = {"norm.weight": t("norm.weight")}
    if token_embeddings:
        out["embed_tokens.weight"] = t("embed_tokens.weight")
    for i in range(config.num_hidden_layers):
        pre = f"layers.{i}"
        if has(f"{pre}.self_attn.W_pack.weight"):
            # Baichuan fuses q/k/v into one [3D, D] matrix: thirds by rows
            qkv = t(f"{pre}.self_attn.W_pack.weight").chunk(3, dim=0)
        else:
            qkv = [t(f"{pre}.self_attn.{p}_proj.weight") for p in "qkv"]
        for p, w in zip("qkv", qkv):
            out[f"{pre}.self_attn.{p}_proj.weight"] = w
            if config.attention_bias:
                out[f"{pre}.self_attn.{p}_proj.bias"] = t(f"{pre}.self_attn.{p}_proj.bias")
        out[f"{pre}.self_attn.o_proj.weight"] = t(f"{pre}.self_attn.o_proj.weight")
        for p in ("gate_proj", "up_proj", "down_proj"):
            out[f"{pre}.mlp.{p}.weight"] = t(f"{pre}.mlp.{p}.weight")
        for p in ("input_layernorm", "post_attention_layernorm"):
            out[f"{pre}.{p}.weight"] = t(f"{pre}.{p}.weight")
    return out


def bert_state_dict_from_hf(sd: Dict[str, torch.Tensor], config: LLMConfig,
                            token_embeddings: bool = True) -> Dict[str, torch.Tensor]:
    """HF ``BertModel`` names → ``BertBackbone`` state-dict names."""
    t, has = _getter(sd, ("", "bert.", "model."))
    pos = t("embeddings.position_embeddings.weight")
    if has("embeddings.token_type_embeddings.weight"):
        # the type-0 row added once, in float32 as the JAX loader adds it
        pos = pos.float() + t("embeddings.token_type_embeddings.weight")[0].float()[None]
    out = {"position_embeddings.weight": pos,
           "embeddings_ln.weight": t("embeddings.LayerNorm.weight"),
           "embeddings_ln.bias": t("embeddings.LayerNorm.bias")}
    if token_embeddings:
        out["word_embeddings.weight"] = t("embeddings.word_embeddings.weight")
    for i in range(config.num_hidden_layers):
        p, q = f"encoder.layer.{i}", f"encoder.layers.{i}"
        att = f"{p}.attention.self"
        for part in ("weight", "bias"):
            out[f"{q}.qkv.{part}"] = torch.cat(
                [t(f"{att}.{n}.{part}") for n in ("query", "key", "value")])
            out[f"{q}.attn_out.{part}"] = t(f"{p}.attention.output.dense.{part}")
            out[f"{q}.attn_ln.{part}"] = t(f"{p}.attention.output.LayerNorm.{part}")
            out[f"{q}.ff_in.{part}"] = t(f"{p}.intermediate.dense.{part}")
            out[f"{q}.ff_out.{part}"] = t(f"{p}.output.dense.{part}")
            out[f"{q}.ff_ln.{part}"] = t(f"{p}.output.LayerNorm.{part}")
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy a mapped state dict into ``module``'s parameters, cast to each
    parameter's dtype on its device. Every parameter must be covered and
    every shape must match."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"checkpoint does not cover the tower: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for name, p in params.items():
        src = state[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)} against the "
                             f"tower's {tuple(p.shape)}")
        # to the parameter's device in the checkpoint's type first, then the
        # cast there: copy_ across devices would cast on the host and move
        # the wider type
        p.copy_(src.to(p.device))
    if any(p.is_cuda for p in params.values()):
        torch.cuda.synchronize()  # the casts on the card are done when this returns
