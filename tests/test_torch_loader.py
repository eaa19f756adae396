"""The port's HF checkpoint loader (``mhrec_tpu_torch/models/llm/loader.py``)
against the JAX package's, on checkpoints the tests write from a seed.

* the port's own ``.safetensors`` parser against the ``safetensors``
  package's reader, every dtype the towers meet (skipped without the
  package);
* Llama, Qwen2 (q/k/v biases), Baichuan (``W_pack``) and BERT state dicts,
  as ``.safetensors`` and as ``pytorch_model.bin``, whole and sharded with
  an index, mapped onto the port's tower names and compared **bit for bit**
  with ``convert.*_state_dict_from_flax`` of the JAX loader's
  ``load_llama_params`` / ``load_bert_params`` (the JAX loader reads
  ``.safetensors`` through numpy, which has no bfloat16, so those files are
  float32; bfloat16 goes through ``.bin``), then loaded into the port's
  tower, which they must cover exactly;
* a directory with only ``config.json`` keeps the random initialisation;
* a corrupt file, or a shard that the index lists and the directory lacks,
  raises, also through ``load_pretrained_towers``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mhrec_tpu.models.llm.config import LLMConfig as JaxLLMConfig
from mhrec_tpu.models.llm.loader import load_bert_params, load_llama_params
from mhrec_tpu_torch.convert import bert_state_dict_from_flax, llama_state_dict_from_flax
from mhrec_tpu_torch.models.hllm.hllm import load_pretrained_towers, load_tower_weights
from mhrec_tpu_torch.models.llm import loader
from mhrec_tpu_torch.models.llm.bert import BertBackbone
from mhrec_tpu_torch.models.llm.config import LLMConfig
from mhrec_tpu_torch.models.llm.llama import LlamaBackbone

torch.set_num_threads(2)

# the towers' config.json files, at tiny widths
CONFIGS = {
    "llama": {"model_type": "llama", "vocab_size": 96, "hidden_size": 32,
              "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "rms_norm_eps": 1e-5},
    "qwen2": {"model_type": "qwen2", "vocab_size": 96, "hidden_size": 32,
              "intermediate_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "rms_norm_eps": 1e-6, "use_sliding_window": False},
    # Baichuan-13B's topology (W_pack, ALiBi) cut to tiny widths
    "baichuan": {"model_type": "baichuan", "vocab_size": 96, "hidden_size": 32,
                 "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                 "rms_norm_eps": 1e-6, "alibi": True},
    "bert": {"model_type": "bert", "vocab_size": 96, "hidden_size": 32,
             "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
             "max_position_embeddings": 40, "type_vocab_size": 2, "layer_norm_eps": 1e-12},
}


def hf_state_dict(kind, seed=0):
    """An HF-named state dict of ``kind`` with float32 values from ``seed``,
    plus keys the towers do not read (``lm_head``, the BERT pooler)."""
    c = CONFIGS[kind]
    D, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    h = c["num_attention_heads"]
    hk = c.get("num_key_value_heads", h)
    dh = D // h
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.05)

    if kind == "bert":
        put("bert.embeddings.word_embeddings.weight", V, D)
        put("bert.embeddings.position_embeddings.weight", c["max_position_embeddings"], D)
        put("bert.embeddings.token_type_embeddings.weight", c["type_vocab_size"], D)
        put("bert.embeddings.LayerNorm.weight", D)
        put("bert.embeddings.LayerNorm.bias", D)
        for i in range(c["num_hidden_layers"]):
            p = f"bert.encoder.layer.{i}"
            for n in ("attention.self.query", "attention.self.key", "attention.self.value",
                      "attention.output.dense"):
                put(f"{p}.{n}.weight", D, D)
                put(f"{p}.{n}.bias", D)
            put(f"{p}.intermediate.dense.weight", I, D)
            put(f"{p}.intermediate.dense.bias", I)
            put(f"{p}.output.dense.weight", D, I)
            put(f"{p}.output.dense.bias", D)
            for n in ("attention.output.LayerNorm", "output.LayerNorm"):
                put(f"{p}.{n}.weight", D)
                put(f"{p}.{n}.bias", D)
        put("bert.pooler.dense.weight", D, D)
        return sd
    put("model.embed_tokens.weight", V, D)
    put("model.norm.weight", D)
    put("lm_head.weight", V, D)
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        if kind == "baichuan":
            put(f"{p}.self_attn.W_pack.weight", 3 * D, D)
        else:
            put(f"{p}.self_attn.q_proj.weight", h * dh, D)
            put(f"{p}.self_attn.k_proj.weight", hk * dh, D)
            put(f"{p}.self_attn.v_proj.weight", hk * dh, D)
        if kind == "qwen2":
            put(f"{p}.self_attn.q_proj.bias", h * dh)
            put(f"{p}.self_attn.k_proj.bias", hk * dh)
            put(f"{p}.self_attn.v_proj.bias", hk * dh)
        put(f"{p}.self_attn.o_proj.weight", D, h * dh)
        put(f"{p}.mlp.gate_proj.weight", I, D)
        put(f"{p}.mlp.up_proj.weight", I, D)
        put(f"{p}.mlp.down_proj.weight", D, I)
        put(f"{p}.input_layernorm.weight", D)
        put(f"{p}.post_attention_layernorm.weight", D)
    return sd


def write_checkpoint(dirpath, kind, sd, fmt, sharded):
    """``config.json`` and the weights as ``fmt`` ("safetensors" | "bin"),
    in two shards with an index when ``sharded``."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump(CONFIGS[kind], fh)
    if fmt == "safetensors":
        from safetensors.torch import save_file

        def save(part, name):
            save_file({k: v.contiguous() for k, v in part.items()}, os.path.join(dirpath, name))
        names = ("model.safetensors", "model-{:05d}-of-00002.safetensors",
                 "model.safetensors.index.json")
    else:
        def save(part, name):
            torch.save(part, os.path.join(dirpath, name))
        names = ("pytorch_model.bin", "pytorch_model-{:05d}-of-00002.bin",
                 "pytorch_model.bin.index.json")
    if not sharded:
        save(sd, names[0])
        return
    keys = sorted(sd)
    halves = (keys[: len(keys) // 2], keys[len(keys) // 2:])
    weight_map = {}
    for n, part in enumerate(halves, start=1):
        save({k: sd[k] for k in part}, names[1].format(n))
        weight_map.update({k: names[1].format(n) for k in part})
    with open(os.path.join(dirpath, names[2]), "w") as fh:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map}, fh)


def _tower(kind, path, dtype=torch.float32):
    cfg = LLMConfig.from_pretrained_dir(path)
    if kind == "bert":
        return cfg, BertBackbone(cfg, dtype=dtype)
    return cfg, LlamaBackbone(cfg, dtype=dtype)


# ----------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64,
                                   torch.int32, torch.uint8, torch.bool])
def test_parser_matches_the_safetensors_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(3)
    values = {
        "matrix": torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32)),
        "vector": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
        "odd": torch.from_numpy(rng.normal(size=(1, 3, 1)).astype(np.float32)),
    }
    if dtype.is_floating_point:
        sd = {k: v.to(dtype) for k, v in values.items()}
    else:
        sd = {k: (v * 40).to(dtype) for k, v in values.items()}
    path = str(tmp_path / "t.safetensors")
    st.save_file(sd, path, metadata={"format": "pt"})
    ours = loader.read_safetensors(path)
    theirs = st.load_file(path)
    assert set(ours) == set(theirs) == set(sd)
    for k in sd:
        assert ours[k].dtype == theirs[k].dtype == dtype
        assert ours[k].shape == theirs[k].shape
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "sharded"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_mapped_state_dict_is_the_jax_loaders_bit_for_bit(tmp_path, kind, fmt, sharded):
    if fmt == "safetensors":
        pytest.importorskip("safetensors")  # the JAX loader reads through it
    path = str(tmp_path / kind)
    write_checkpoint(path, kind, hf_state_dict(kind), fmt, sharded)
    jcfg = JaxLLMConfig.from_pretrained_dir(path)
    if kind == "bert":
        want = bert_state_dict_from_flax(load_bert_params(path, jcfg))
        got = loader.bert_state_dict_from_hf(loader.load_state_dict(path),
                                             LLMConfig.from_pretrained_dir(path))
    else:
        want = llama_state_dict_from_flax(load_llama_params(path, jcfg))
        got = loader.llama_state_dict_from_hf(loader.load_state_dict(path),
                                              LLMConfig.from_pretrained_dir(path))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].float(), want[k]), k
    cfg, tower = _tower(kind, path)
    assert cfg.alibi == (kind == "baichuan") and cfg.attention_bias == (kind == "qwen2")
    loader.load_into(tower, got)
    for name, p in tower.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


def test_bfloat16_weights_load_exactly(tmp_path):
    """bfloat16 weights (the TinyLlama checkpoints' type) as ``.bin`` against
    the JAX loader, and as ``.safetensors`` against the ``.bin`` load: bf16
    → f32 is exact, so every value is the checkpoint's."""
    sd = {k: v.to(torch.bfloat16) for k, v in hf_state_dict("llama", seed=4).items()}
    write_checkpoint(str(tmp_path / "bin"), "llama", sd, "bin", sharded=False)
    jcfg = JaxLLMConfig.from_pretrained_dir(str(tmp_path / "bin"))
    want = llama_state_dict_from_flax(load_llama_params(str(tmp_path / "bin"), jcfg))
    cfg, tower = _tower("llama", str(tmp_path / "bin"))
    assert load_tower_weights(tower, str(tmp_path / "bin"))
    for name, p in tower.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), want[name]), name
    if pytest.importorskip("safetensors"):
        write_checkpoint(str(tmp_path / "st"), "llama", sd, "safetensors", sharded=True)
        _, tower2 = _tower("llama", str(tmp_path / "st"))
        assert load_tower_weights(tower2, str(tmp_path / "st"))
        for (name, p), q in zip(tower.named_parameters(), tower2.parameters()):
            assert torch.equal(p, q), name


def test_user_tower_without_token_table_and_bert_fold(tmp_path):
    """The user tower has no token table: the map leaves it out. BERT's
    type-0 row is folded into the position table."""
    path = str(tmp_path / "llama")
    sd = hf_state_dict("llama")
    write_checkpoint(path, "llama", sd, "bin", sharded=False)
    cfg = LLMConfig.from_pretrained_dir(path)
    user = LlamaBackbone(cfg, dtype=torch.float32, token_embeddings=False)
    assert load_tower_weights(user, path)
    assert torch.equal(user.layers[1].mlp.up_proj.weight, sd["model.layers.1.mlp.up_proj.weight"])
    bsd = hf_state_dict("bert")
    got = loader.bert_state_dict_from_hf(bsd, LLMConfig.from_pretrained_dir(
        _dir_with_config(tmp_path / "bert", "bert")))
    want = (bsd["bert.embeddings.position_embeddings.weight"]
            + bsd["bert.embeddings.token_type_embeddings.weight"][0][None])
    assert torch.equal(got["position_embeddings.weight"], want)


def _dir_with_config(path, kind):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(CONFIGS[kind], fh)
    return str(path)


class _Towers(torch.nn.Module):
    """What ``load_pretrained_towers`` reads of an HLLM: its two towers."""

    def __init__(self, cfg):
        super().__init__()
        self.item_llm = LlamaBackbone(cfg, dtype=torch.float32)
        self.user_llm = LlamaBackbone(cfg, dtype=torch.float32, token_embeddings=False)
        gen = torch.Generator().manual_seed(0)
        self.item_llm.init_parameters(gen)
        self.user_llm.init_parameters(gen)


def test_config_only_directory_keeps_random_init(tmp_path):
    path = _dir_with_config(tmp_path / "cfg_only", "llama")
    model = _Towers(LLMConfig.from_pretrained_dir(path))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained_towers(model, {"item_pretrain_dir": path, "user_pretrain_dir": path})
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(loader.NoWeightFiles):
        loader.load_state_dict(path)
    # a checkpoint beside it loads; item_llm_init: false keeps that tower
    write_checkpoint(path, "llama", hf_state_dict("llama"), "bin", sharded=False)
    load_pretrained_towers(model, {"item_pretrain_dir": path, "user_pretrain_dir": path,
                                   "item_llm_init": False})
    assert torch.equal(model.item_llm.norm.weight, before["item_llm.norm.weight"])
    assert not torch.equal(model.user_llm.norm.weight, before["user_llm.norm.weight"])


def _corrupt(raw: bytes, how: str) -> bytes:
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    if how == "length":
        return (len(raw) + 1).to_bytes(8, "little") + raw[8:]
    if how == "json":
        return raw[:8] + b"{" * n + raw[8 + n:]
    if how == "truncated":
        return raw[:-8]
    key = next(k for k in header if k != "__metadata__")
    if how == "offsets":
        header[key]["data_offsets"][1] += 4
    elif how == "dtype":
        header[key]["dtype"] = "Q7"
    elif how == "shape":
        header[key]["shape"] = [3, 3, 3, 3]
    body = json.dumps(header).encode()
    body += b" " * (-len(body) % 8)
    return len(body).to_bytes(8, "little") + body + raw[8 + n:]


@pytest.mark.parametrize("how", ["length", "json", "truncated", "offsets", "dtype", "shape"])
def test_corrupt_safetensors_raises(tmp_path, how):
    st = pytest.importorskip("safetensors.torch")
    path = _dir_with_config(tmp_path / "bad", "llama")
    f = os.path.join(path, "model.safetensors")
    st.save_file({k: v.contiguous() for k, v in hf_state_dict("llama").items()}, f)
    with open(f, "rb") as fh:
        raw = fh.read()
    with open(f, "wb") as fh:
        fh.write(_corrupt(raw, how))
    with pytest.raises(ValueError):
        loader.read_safetensors(f)
    model = _Towers(LLMConfig.from_pretrained_dir(path))
    with pytest.raises(ValueError):  # never a random init
        load_pretrained_towers(model, {"item_pretrain_dir": path, "user_pretrain_dir": path})


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_missing_shard_raises(tmp_path, fmt):
    """An index that lists a shard the directory lacks (an interrupted copy)
    raises, never a random init."""
    if fmt == "safetensors":
        pytest.importorskip("safetensors")
    path = str(tmp_path / "partial")
    write_checkpoint(path, "llama", hf_state_dict("llama"), fmt, sharded=True)
    shard = {"safetensors": "model-00002-of-00002.safetensors",
             "bin": "pytorch_model-00002-of-00002.bin"}[fmt]
    os.remove(os.path.join(path, shard))
    with pytest.raises(FileNotFoundError, match=shard) as err:
        loader.load_state_dict(path)
    assert not isinstance(err.value, loader.NoWeightFiles)
    model = _Towers(LLMConfig.from_pretrained_dir(path))
    with pytest.raises(FileNotFoundError, match=shard):
        load_pretrained_towers(model, {"item_pretrain_dir": path, "user_pretrain_dir": path})


def test_checkpoint_that_does_not_cover_the_tower_raises(tmp_path):
    path = _dir_with_config(tmp_path / "short", "llama")
    sd = hf_state_dict("llama")
    del sd["model.layers.1.mlp.up_proj.weight"]
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    _, tower = _tower("llama", path)
    with pytest.raises(KeyError):
        load_tower_weights(tower, path)
    wide = dataclasses.replace(LLMConfig.from_pretrained_dir(path), intermediate_size=80)
    state = loader.llama_state_dict_from_hf(hf_state_dict("llama"), wide)
    with pytest.raises(ValueError):
        loader.load_into(LlamaBackbone(wide, dtype=torch.float32), state)
