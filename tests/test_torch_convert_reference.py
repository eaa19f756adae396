"""The port's reference-checkpoint converter (``mhrec_tpu_torch/convert_reference.py``)
against the root ``tools/convert_reference_ckpt.py`` followed by the
port's ``convert.py``.

A reference-named state dict is drawn from a seed for tiny HSTU (additive
and hierarchical heads, the switch, a position table of another row count
to cut or pad), ComiRec, REMI and HLLM (tiny Llama towers with medusa and
switch heads). The root tool maps it onto the JAX trainer's params, which
``convert.py`` carries into the port's names; the port maps it straight
into its own. Both must give the same tensors, bit for bit, and the same
used / missing / unused report. The root tool's HLLM towers are held to
the JAX HF loader's map (``llama_params_from_state_dict``) through
``convert.py``, and its heads run through its own ``_Mapper`` and
``_convert_medusa_heads``: the root tool's ``convert_hllm`` cannot convert
an HLLM with Llama towers. Its ``_graft_tree`` never descends into a
nested subtree (the recursive call sits after a ``raise``), and it raises
on the user tower's token table, which the JAX HF map always makes and the
JAX user tower (fed ``inputs_embeds`` only) lacks.

The loader reads every container and prefix form and the sharded ``.bin``
index as the root tool's does; the two refusals carry the root tool's
messages; and ``chip_smoke.py``'s reference-checkpoint phase converts a
written ``full_model_fp32.pt`` through the CLI's entry point and serves it
with ``run --val_only True --device cpu`` at the metrics of the same
tensors loaded straight into a model.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.models.llm.config import LLMConfig as JaxLLMConfig
from mhrec_tpu.models.llm.loader import llama_params_from_state_dict
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch import convert_reference as CR
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import llama_state_dict_from_flax, state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData
from mhrec_tpu_torch.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
import convert_reference_ckpt as root_tool  # noqa: E402

ID_FILES = ["overall/ID.yaml", "IDNet/hstu.yaml"]
LLM_FILES = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
BASE = dict(MAX_ITEM_LIST_LENGTH=8, train_batch_size=8, eval_batch_size=16, num_negatives=16,
            tag_version="v1", n_layers=2, n_heads=2, item_embedding_size=32,
            hstu_embedding_size=32, eval_pred_len=2, pred_len=2, topk=[5, 10], loss="prior",
            eval_num_cats=4, num_prior_head=4, num_segment_head=2, medusa_num_layers=1,
            prior_switch="in", prior_switch_loss_weight=0.1, sparse_item_adam=False)
HSTU_CASES = {"additive": dict(head_interaction="additive"),
              "hierarchical": dict(head_interaction="hierarchical", segment_embed=True,
                                   medusa_use_norm=True),
              "shared_seg": dict(head_interaction="hierarchical", share_seg_weights=True)}


def configs(meta, files, tmp, **over):
    keys = dict(BASE, data_path=meta["data_path"], dataset=meta["name"],
                text_path=meta["text_path"], checkpoint_dir=str(tmp), **over)
    return (JaxConfig(config_file_list=files, config_dict=keys).finalize(),
            Config(config_file_list=files, config_dict=keys).finalize())


def port_params(cfg, seed=7):
    t = Trainer(cfg, InteractionData(cfg).build(), device="cpu")
    t.setup_model(seed=seed)
    return t.model, {k: v.detach().clone() for k, v in t.model.named_parameters()}


_JAX_PARAMS = {}


def jax_params(cfg):
    """The JAX trainer's initial params of ``cfg`` (one trainer a model and
    head layout: the params the root tool maps onto are replaced, never
    changed in place)."""
    key = json.dumps({k: cfg[k] for k in ("model", "head_interaction", "share_seg_weights",
                                          "segment_embed", "medusa_use_norm", "dummy_llm")},
                     default=str, sort_keys=True)
    if key not in _JAX_PARAMS:
        t = JaxTrainer(cfg, JaxData(cfg).build())
        t.setup_model()
        _JAX_PARAMS[key] = t.state.params
    return _JAX_PARAMS[key]


def through_root(root_convert, sd, jcfg, tcfg, params):
    """The root tool's map onto the JAX params, then ``convert.py``."""
    new, used, missing, unused = root_convert({k: v.numpy() for k, v in sd.items()}, params,
                                              jcfg)
    return state_dict_from_flax(new, tcfg), (used, missing, unused)


def comirec_reference(params):
    """The reference names of a ComiRec / REMI (comirec.py:52-107)."""
    rules = ((r"^trunk\.stu_layers\.(\d+)\.uvqk$", r"_hstu._attention_layers.\1._uvqk"),
             (r"^trunk\.stu_layers\.(\d+)\.o_proj\.", r"_hstu._attention_layers.\1._o."),
             (r"^trunk\.attn_hidden\.", "attention_net.0."),
             (r"^trunk\.attn_out\.", "attention_net.3."), (r"^trunk\.", ""))
    out = {}
    for k, v in params.items():
        if re.search(r"\.(input_norm|attn_norm)\.", k):
            continue
        for pattern, repl in rules:
            k = re.sub(pattern, repl, k)
        out[k] = v
    return out


@pytest.mark.parametrize("rows", [2, -1], ids=["cut_rows", "pad_rows"])
@pytest.mark.parametrize("case", list(HSTU_CASES))
def test_hstu_converter_equals_root_tool(synth_dir, tmp_path, case, rows):
    jcfg, tcfg = configs(synth_dir, ["IDNet/hstu-size1.yaml"] + ID_FILES, tmp_path,
                         **HSTU_CASES[case])
    model, params = port_params(tcfg)
    sd = chip_smoke.reference_hstu_state_dict(params)
    pos = sd["position_embedding.weight"]
    sd["position_embedding.weight"] = (torch.cat([pos, torch.randn(rows, pos.shape[1])])
                                       if rows > 0 else pos[:rows])
    want, report = through_root(root_tool.convert_hstu, sd, jcfg, tcfg, jax_params(jcfg))
    got, used, missing, unused = CR.convert(sd, model, tcfg)
    assert (used, missing, unused) == report
    assert not missing and not unused
    for k in params:
        assert torch.equal(got[k], want[k]), k
    if rows < 0:  # the padded row is zero
        assert not got["position_embedding.weight"][-1].any()


@pytest.mark.parametrize("family", ["ComiRec", "REMI"])
def test_comirec_remi_converter_equals_root_tool(synth_dir, tmp_path, family):
    files = ID_FILES + [f"IDNet/{family.lower()}.yaml"]
    jcfg, tcfg = configs(synth_dir, files, tmp_path)
    model, params = port_params(tcfg)
    sd = comirec_reference(params)
    sd["unrelated.weight"] = torch.ones(3)
    want, report = through_root(root_tool.convert_comirec, sd, jcfg, tcfg, jax_params(jcfg))
    mapped, used, missing, unused = CR.CONVERTERS[family](
        sd, {k: v for k, v in params.items()}, tcfg)
    assert (used, missing, unused) == report and unused == ["unrelated.weight"]
    assert len(mapped) == len(params)
    for k, v in mapped.items():
        assert torch.equal(v, want[k]), k


def test_missing_tensors_are_reported_and_left_at_init(synth_dir, tmp_path):
    jcfg, tcfg = configs(synth_dir, ["IDNet/hstu-size1.yaml"] + ID_FILES, tmp_path,
                         head_interaction="additive")
    model, params = port_params(tcfg)
    sd = chip_smoke.reference_hstu_state_dict(params)
    gone = ["_hstu._attention_layers.1._uvqk", "aux_cat_head.0.bias"]
    for k in gone:
        del sd[k]
    _, report = through_root(root_tool.convert_hstu, sd, jcfg, tcfg, jax_params(jcfg))
    got, used, missing, unused = CR.convert(sd, model, tcfg)
    assert (used, missing, unused) == report and sorted(missing) == sorted(gone)
    assert torch.equal(got["stu_layers.1.uvqk"], params["stu_layers.1.uvqk"])


def _tiny_llama(dirpath):
    cfg = dict(model_type="llama", vocab_size=96, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-6, max_position_embeddings=64)
    os.makedirs(dirpath)
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    return cfg


def root_hllm_surface(sd, params, jcfg):
    """The root tool's ``convert_hllm`` without its towers (which it cannot
    convert: ``_graft_tree`` raises on the user tower's token table that the
    JAX HF map always makes, and grafts nothing else): its ``_Mapper`` and
    ``_convert_medusa_heads`` over ``item_emb_tokens``, ``logit_scale`` and
    the heads, every tower tensor counted as used, as it counts them."""
    m = root_tool._Mapper({k: v.numpy() for k, v in sd.items()}, params)
    m.put(("item_emb_tokens",), m.take("item_emb_tokens"))
    m.put(("logit_scale",), m.take("logit_scale"))
    root_tool._convert_medusa_heads(m, jcfg)
    m.used.update(k for k in sd if k.startswith(("item_llm.", "user_llm.")))
    return m.results()


def test_hllm_converter_equals_root_tool(synth_dir, tmp_path):
    llama = _tiny_llama(str(tmp_path / "llama"))
    jcfg, tcfg = configs(synth_dir, LLM_FILES, tmp_path / "ck", item_pretrain_dir=str(
        tmp_path / "llama"), user_pretrain_dir=str(tmp_path / "llama"), dummy_llm=False,
        MAX_TEXT_LENGTH=16, head_interaction="multiplicative", num_segment_head=1)
    model, params = port_params(tcfg)
    # the reference's towers: HF names under item_llm. / user_llm., drawn
    # apart from the port's initial values
    sd = {}
    for i, tower in enumerate(("item_llm", "user_llm")):
        for k, v in chip_smoke.hf_state_dict(llama, 20 + i, "cpu", torch.float32).items():
            sd[f"{tower}.{k}"] = v
    for k, v in chip_smoke.reference_hstu_state_dict(
            {k: v for k, v in params.items() if not k.startswith(("item_llm.", "user_llm."))}
    ).items():
        sd[k] = torch.randn(v.shape, generator=torch.Generator().manual_seed(len(sd)))
    new, *report = root_hllm_surface(sd, jax_params(jcfg), jcfg)
    got, used, missing, unused = CR.convert(sd, model, tcfg)
    assert (used, missing, unused) == tuple(report) and not missing and not unused
    # the heads, item_emb_tokens and logit_scale: the root tool's, carried by
    # convert.py
    want = state_dict_from_flax(new, tcfg)
    heads = [k for k in params if not k.startswith(("item_llm.", "user_llm."))]
    assert any(k.startswith("medusa_head.") for k in heads) and "aux_cat_head.0.weight" in heads
    for k in heads:
        assert torch.equal(got[k], want[k]), k
    # the towers: the JAX HF loader's map, carried by convert.py
    jllama = JaxLLMConfig.from_pretrained_dir(str(tmp_path / "llama"))
    for tower in ("item_llm", "user_llm"):
        tower_sd = {k[len(tower) + 1:]: v.numpy() for k, v in sd.items()
                    if k.startswith(f"{tower}.")}
        ref = llama_state_dict_from_flax(llama_params_from_state_dict(tower_sd, jllama))
        names = [k for k in params if k.startswith(f"{tower}.")]
        assert len(names) == len(ref) - (tower == "user_llm")  # no user token table
        for k in names:
            assert torch.equal(got[k], ref[k[len(tower) + 1:]]), k


def _write_forms(sd, tmp_path):
    """``sd`` in every on-disk form the reference writes; returns the paths."""
    paths = {}
    for name, wrap in (("state_dict", lambda d: {"state_dict": {f"_forward_module.{k}": v
                                                                 for k, v in d.items()}}),
                       ("module", lambda d: {"module": {f"module.{k}": v for k, v in d.items()},
                                             "epoch": 3}),
                       ("model_state_dict", lambda d: {"model_state_dict": d}),
                       ("nested", lambda d: {"state_dict": {"module": {
                           f"_forward_module.module.{k}": v for k, v in d.items()}}}),
                       ("bare", lambda d: d)):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save(wrap(sd), paths[name])
    one = tmp_path / "hf_dir"
    one.mkdir()
    torch.save(sd, one / "pytorch_model.bin")
    paths["hf_dir"] = str(one)
    shards = tmp_path / "sharded"
    shards.mkdir()
    keys = sorted(sd)
    weight_map = {}
    for i, part in enumerate((keys[::2], keys[1::2])):
        fname = f"pytorch_model-0000{i + 1}-of-00002.bin"
        torch.save({k: sd[k] for k in part}, shards / fname)
        weight_map.update({k: fname for k in part})
    with open(shards / "pytorch_model.bin.index.json", "w") as fh:
        json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    paths["sharded"] = str(shards)
    fp32 = tmp_path / "fp32_dir"
    fp32.mkdir()
    torch.save({"state_dict": sd}, fp32 / "full_model_fp32.pt")
    paths["fp32_dir"] = str(fp32)
    return paths


def test_loader_reads_every_form_as_the_root_tool(tmp_path):
    gen = torch.Generator().manual_seed(0)
    sd = {"item_embedding.weight": torch.randn(5, 4, generator=gen),
          "_hstu._attention_layers.0._uvqk": torch.randn(4, 8, generator=gen).bfloat16(),
          "logit_scale": torch.tensor(2.5), "step_count": torch.tensor(7)}
    for name, path in _write_forms(sd, tmp_path).items():
        got = CR.load_reference_state_dict(path)
        want = root_tool.load_reference_state_dict(path)
        assert sorted(got) == sorted(want) == sorted(sd), name
        for k, v in got.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=f"{name} {k}")
    with pytest.raises(FileNotFoundError, match="no pytorch_model.bin"):
        CR.load_reference_state_dict(str(tmp_path))


@pytest.mark.parametrize("files,over", [
    (["overall/ID.yaml", "IDNet/sasrec.yaml"], {}),
    (LLM_FILES, {"use_image": True}),
], ids=["another_model", "use_image"])
def test_refusals_carry_the_root_tools_messages(synth_dir, tmp_path, files, over):
    args = ["--data_path", synth_dir["data_path"], "--dataset", synth_dir["name"]]
    for k, v in over.items():
        args += [f"--{k}", str(v)]
    with pytest.raises(NotImplementedError) as want:
        root_tool.main(["--ckpt", str(tmp_path / "x.pt"), "--config_file", *files, "--", *args])
    with pytest.raises(NotImplementedError) as got:
        CR.main(["--ckpt", str(tmp_path / "x.pt"), "--config_file", *files, "--",
                 "--device", "cpu", *args])
    assert str(got.value) == str(want.value)


def test_reference_checkpoint_phase_serves_through_the_cli(tmp_path, capsys):
    """``chip_smoke.py``'s reference-checkpoint phase at a few widths on the
    CPU: the written ``full_model_fp32.pt``, converted by the CLI's entry
    point and served with ``--val_only True``, gives the metrics of the
    same tensors put straight into a model (the card's launch count is not
    held here)."""
    data_kw = dict(num_users=64, num_items=500, seq_len=20, num_categories=8, eval_pred_len=8,
                   max_item_list_length=6, seed=0)
    chip_smoke.reference_ckpt_phase(data_kw, str(tmp_path), device="cpu", n_layers=2,
                                    n_heads=2, item_embedding_size=128,
                                    hstu_embedding_size=128, eval_batch_size=32,
                                    eval_item_chunk_size=300, MAX_ITEM_LIST_LENGTH=6)
    rec = next(json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"phase": "reference_ckpt"'))
    assert all(ok for k, ok in rec["checks"].items() if k != "launches"), rec
    assert rec["tensors"] > 20 and rec["users"] == 64
