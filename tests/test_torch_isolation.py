"""The port stands alone: ``mhrec_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX and nothing of the JAX package, and the serving and training
paths that ``chip_smoke.py`` drives (HSTU serving and training, hstu-1b
with its options, the five baselines, HLLM serving and training, the eval
outputs and modes, gradient accumulation, HLLM towers loaded from local
checkpoints, the image and video item towers) import neither PyYAML nor pandas nor pyarrow
(the machine with the card has none of them), nor, on the HLLM
paths, ``transformers``, ``safetensors``, ``tokenizers``, ``regex`` or
``sentencepiece`` (the HLLM runs read a tower's ``tokenizer.json``). PIL,
``torchvision`` and ``decord`` are imported only inside the functions that
decode images and videos."""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mhrec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the port depends on none of these: it parses .safetensors and reads
# tokenizer.json itself
NEVER = ("jax", "jaxlib", "flax", "optax", "mhrec_tpu", "safetensors", "transformers",
         "tokenizers", "regex", "sentencepiece")
NOT_AT_TOP = ("yaml", "pandas", "pyarrow", "PIL", "torchvision", "decord", "wandb",
              "tensorboardX")
# scipy is a dependency of the offline tools alone
SCIPY_ONLY_UNDER = ROOT / "mhrec_tpu_torch" / "tools"


def _imports(source):
    """(module, at module level?) for every import statement and
    ``importlib.import_module`` / ``__import__`` call with a literal name."""
    tree = ast.parse(source)
    out = []

    def walk(node, top):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((a.name, top) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module, top))
            elif isinstance(child, ast.Call) and child.args \
                    and isinstance(child.args[0], ast.Constant) \
                    and isinstance(child.args[0].value, str) \
                    and getattr(child.func, "attr", getattr(child.func, "id", None)) \
                    in ("import_module", "__import__"):
                out.append((child.args[0].value.split("{")[0], top))
            walk(child, top and not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    walk(tree, True)
    return out


def _root(module):
    return module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    for module, top in _imports(path.read_text()):
        assert _root(module) not in NEVER, f"{path.name} imports {module}"
        if top:
            assert _root(module) not in NOT_AT_TOP, f"{path.name} imports {module} at module level"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_scipy_only_in_the_tools(path):
    if SCIPY_ONLY_UNDER in path.parents:
        return
    assert all(_root(module) != "scipy" for module, _ in _imports(path.read_text())), path.name


def test_scanner_sees_what_it_looks_for():
    src = ("import jax\nfrom mhrec_tpu.ops import x\nimport mhrec_tpu_torch\n"
           "def f():\n    import pandas\n    importlib.import_module('mhrec_tpu.data')\n")
    assert _imports(src) == [("jax", True), ("mhrec_tpu.ops", True), ("mhrec_tpu_torch", True),
                             ("pandas", False), ("mhrec_tpu.data", False)]


_SERVE = """
import sys
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.run import serve
import mhrec_tpu_torch.convert, mhrec_tpu_torch.models.factory

torch.set_num_threads(2)
cfg = chip_smoke.serve_config()
for k, v in dict(n_layers=1, n_heads=2, item_embedding_size=128, hstu_embedding_size=128,
                 eval_batch_size=32, eval_item_chunk_size=700, MAX_ITEM_LIST_LENGTH=6).items():
    cfg[k] = v
data = InMemoryInteractionData(num_users=40, num_items=1000, seq_len=2 * 6 + 16,
                               num_categories=8, eval_pred_len=8, max_item_list_length=6)
_, _, result = serve(cfg, data, device="cpu")
assert "pred_7" in result and "shared" in result
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu",
                                    "yaml", "pandas", "pyarrow"})
print("BAD", bad)
"""


def test_serving_path_imports_nothing_it_must_not():
    """Drive a tiny serve on the CPU in a fresh interpreter and look at what
    it loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SERVE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


_TRAIN = """
import sys, tempfile
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.run import train

torch.set_num_threads(2)
cfg = chip_smoke.train_config(tempfile.mkdtemp())
for k, v in dict(n_layers=1, n_heads=2, item_embedding_size=128, hstu_embedding_size=128,
                 eval_batch_size=32, eval_item_chunk_size=700, MAX_ITEM_LIST_LENGTH=6,
                 train_batch_size=8, num_negatives=64, total_iters=2, eval_interval=2).items():
    cfg[k] = v
data = InMemoryInteractionData(num_users=40, num_items=1000, seq_len=2 * 6 + 16,
                               num_categories=8, eval_pred_len=8, max_item_list_length=6)
trainer, stats, result = train(cfg, data, device="cpu")
assert stats["iters"] == 2 and "pred_7" in result
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu",
                                    "yaml", "pandas", "pyarrow"})
print("BAD", bad)
"""


def test_training_path_imports_nothing_it_must_not():
    """Drive a tiny training run on the CPU in a fresh interpreter (the
    configuration chip_smoke.py trains, cut to a few widths) and look at
    what it loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _TRAIN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


_HLLM_SERVE = """
import json, os, sys, tempfile
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.run import serve

torch.set_num_threads(2)
work = tempfile.mkdtemp()
tower = os.path.join(work, "tower")
os.makedirs(tower)
# chip_smoke.py's TinyLlama config.json, cut to LLMConfig.tiny's widths
with open(os.path.join(tower, "config.json"), "w") as fh:
    json.dump(dict(chip_smoke.TINYLLAMA_1B, vocab_size=1024, hidden_size=64,
                   intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2), fh)
cfg = chip_smoke.hllm_config(tower, work)
for k, v in dict(MAX_TEXT_LENGTH=24, MAX_ITEM_LIST_LENGTH=6, train_batch_size=8,
                 eval_batch_size=32, pack_chunk=128).items():
    cfg[k] = v
data = InMemoryInteractionData(num_users=40, num_items=300, seq_len=2 * 6 + 16,
                               num_categories=11, eval_pred_len=8, max_item_list_length=6,
                               item_texts=True, max_filler_words=12)
trainer, _, result = serve(cfg, data, device="cpu")
assert "pred_7" in result and "shared" in result
assert trainer.compute_item_feature().shape == (300, 64)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu",
                                    "yaml", "pandas", "pyarrow", "transformers"})
print("BAD", bad)
"""


def test_hllm_serving_path_imports_nothing_it_must_not():
    """Drive a tiny HLLM serve on the CPU in a fresh interpreter (the
    configuration chip_smoke.py serves, cut to a few widths, with the packed
    corpus pass) and look at what it loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _HLLM_SERVE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


_HLLM_TRAIN = """
import json, os, sys, tempfile
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.run import train

torch.set_num_threads(2)
work = tempfile.mkdtemp()
tower = os.path.join(work, "tower")
os.makedirs(tower)
with open(os.path.join(tower, "config.json"), "w") as fh:
    json.dump(dict(chip_smoke.TINYLLAMA_1B, vocab_size=1024, hidden_size=64,
                   intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2), fh)
cfg = chip_smoke.hllm_train_config(tower, work)
for k, v in dict(MAX_TEXT_LENGTH=24, MAX_ITEM_LIST_LENGTH=6, eval_batch_size=32,
                 pack_chunk=128, num_negatives=16, total_iters=2, eval_interval=2).items():
    cfg[k] = v
data = InMemoryInteractionData(num_users=40, num_items=300, seq_len=2 * 6 + 16,
                               num_categories=11, eval_pred_len=8, max_item_list_length=6,
                               item_texts=True, max_filler_words=12)
trainer, stats, result = train(cfg, data, device="cpu")
assert stats["iters"] == 2 and "pred_7" in result and trainer.checkpoint_stats["bytes"] > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu",
                                    "yaml", "pandas", "pyarrow", "transformers"})
print("BAD", bad)
"""


def test_hllm_training_path_imports_nothing_it_must_not():
    """Drive a tiny HLLM training run on the CPU in a fresh interpreter (the
    configuration chip_smoke.py trains, cut to a few widths: two steps, an
    evaluation with a checkpoint save, the test split from the checkpoint)
    and look at what it loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _HLLM_TRAIN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


_EVAL_MODES = """
import glob, json, os, sys, tempfile

# what the port runs without: importing it fails
LACKING = ("pandas", "yaml", "pyarrow", "transformers", "tokenizers", "regex", "sentencepiece")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.run import serve, train

torch.set_num_threads(2)
work = tempfile.mkdtemp()
small = dict(n_layers=1, n_heads=2, item_embedding_size=128, hstu_embedding_size=128,
             eval_batch_size=32, eval_item_chunk_size=700, MAX_ITEM_LIST_LENGTH=6)
data = InMemoryInteractionData(num_users=40, num_items=1000, seq_len=2 * 6 + 16,
                               num_categories=8, eval_pred_len=8, max_item_list_length=6)
# the eval outputs and the streamed GAUC / VALUE metrics
cfg = chip_smoke.serve_config()
for k, v in dict(small, log_detailed_results=True, save_for_eval=True, checkpoint_dir=work,
                 metrics=chip_smoke.STREAMED_METRICS).items():
    cfg[k] = v
trainer, _, result = serve(cfg, data, device="cpu")
assert {"gauc", "auc", "mae", "rmse", "logloss"} <= set(result["pred_7"])
out = trainer.saved_model_dir
assert glob.glob(os.path.join(out, "detailed", "*.npz"))
assert glob.glob(os.path.join(out, "saved_eval", "eval_chunk_*.npz"))
assert not os.path.exists(os.path.join(out, "results.pkl"))
# gradient accumulation under sparse_item_adam
cfg = chip_smoke.train_config(work)
for k, v in dict(small, train_batch_size=8, num_negatives=64, total_iters=2, eval_interval=2,
                 accumulate_grad=2).items():
    cfg[k] = v
trainer, stats, result = train(cfg, data, device="cpu")
assert stats["iters"] == 4 and trainer.step == 4 and "pred_7" in result
# the HLLM corpus table in host memory
tower = os.path.join(work, "tower")
os.makedirs(tower)
with open(os.path.join(tower, "config.json"), "w") as fh:
    json.dump(dict(chip_smoke.TINYLLAMA_1B, vocab_size=1024, hidden_size=64,
                   intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2), fh)
cfg = chip_smoke.hllm_config(tower, work)
for k, v in dict(MAX_TEXT_LENGTH=24, MAX_ITEM_LIST_LENGTH=6, train_batch_size=8,
                 eval_batch_size=32, pack_chunk=128, eval_item_chunk_size=128,
                 host_item_table=True).items():
    cfg[k] = v
hdata = InMemoryInteractionData(num_users=40, num_items=300, seq_len=2 * 6 + 16,
                                num_categories=11, eval_pred_len=8, max_item_list_length=6,
                                item_texts=True, max_filler_words=12)
# the tower's tokenizer.json (chip_smoke.py's TinyLlama layout, vocabulary 1024)
chip_smoke.write_llama_tokenizer(tower, chip_smoke.rendered_texts(cfg, hdata.item_text, 300),
                                 1024)
trainer, _, result = serve(cfg, hdata, device="cpu")
assert "pred_7" in result and trainer.host_table_stats["chunks"] == 3
assert trainer._corpus_batcher.text_cache.tokenizer.kind == "hf:LlamaTokenizerFast"
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu", *LACKING})
print("BAD", bad)
"""


def test_eval_modes_and_accumulation_run_without_what_the_card_lacks():
    """Drive the eval outputs (``log_detailed_results``, ``save_for_eval``),
    the streamed GAUC / VALUE metrics, gradient accumulation and the HLLM
    host-memory corpus table (its tower directory holding a tokenizer.json)
    on the CPU in a fresh interpreter where pandas, PyYAML, pyarrow,
    transformers, tokenizers, regex and sentencepiece cannot be imported
    (chip_smoke.py's configurations, cut to a few widths): each runs,
    ``results.pkl`` is skipped with one warning, the corpus pass tokenizes
    with the port's HF tokenizer, and nothing forbidden is loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _EVAL_MODES], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
    assert proc.stderr.count("pandas is not installed: results.pkl is not written") == 1


_HSTU_1B = """
import json, sys, tempfile

# what the port runs without: importing it fails
LACKING = ("pandas", "yaml", "pyarrow", "transformers", "tokenizers", "regex", "sentencepiece")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

torch.set_num_threads(2)
data = InMemoryInteractionData(num_users=40, num_items=1000, seq_len=2 * 6 + 16,
                               num_categories=8, eval_pred_len=8, max_item_list_length=6)
# chip_smoke.py's hstu_1b phase (scan_layers, the f32 and the bf16 table,
# the stacked loss, TF32 serving), cut to a few widths
paths, failed = chip_smoke.hstu_1b_phase(
    data, tempfile.mkdtemp(), device="cpu", n_layers=2, n_heads=2, item_embedding_size=128,
    hstu_embedding_size=128, eval_batch_size=32, eval_item_chunk_size=700,
    MAX_ITEM_LIST_LENGTH=6, train_batch_size=8, num_negatives=64, total_iters=2,
    eval_interval=2)
assert set(paths) == {"hstu_1b_serve", "hstu_1b_train", "hstu_1b_train_bf16_table",
                      "hstu_1b_train_stacked"}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu",
                                    "safetensors"})
print("BAD", bad)
"""


def test_hstu_1b_phase_runs_without_what_the_card_lacks():
    """chip_smoke.py's hstu_1b phase, cut to a few widths, on the CPU in a
    fresh interpreter where PyYAML, pandas, pyarrow, ``transformers``,
    ``tokenizers``, ``regex`` and ``sentencepiece`` cannot be imported: it
    runs every record (the launch counts are the card's, so its checks fail
    here) and loads nothing of JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _HSTU_1B], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout[-3000:]
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"phase"')]
    assert [r["phase"] for r in recs] == ["hstu_1b_serve", "hstu_1b_serve_tf32",
                                          "hstu_1b_train", "hstu_1b_train_bf16_table",
                                          "hstu_1b_train_stacked"]
    # the row update of one more f32 step, held against the plain version
    row = recs[2]["row_adamw_vs_plain"]
    assert row["ok"] and row["bit_equal"] and row["D"] == 128 and row["real_ids"] > 0, row


_PRETRAINED = """
import os, sys, tempfile

# what the port runs without: importing it fails
LACKING = ("safetensors", "transformers", "pandas", "yaml", "pyarrow", "tokenizers", "regex",
           "sentencepiece")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData
from mhrec_tpu_torch.run import serve, train

torch.set_num_threads(2)
work = tempfile.mkdtemp()
tiny = dict(chip_smoke.TINYLLAMA_1B, vocab_size=1024, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
data = InMemoryInteractionData(num_users=40, num_items=300, seq_len=2 * 6 + 16,
                               num_categories=11, eval_pred_len=8, max_item_list_length=6,
                               item_texts=True, max_filler_words=12)
small = dict(MAX_TEXT_LENGTH=24, MAX_ITEM_LIST_LENGTH=6, eval_batch_size=32, pack_chunk=128)
for fmt, shards in (("safetensors", 2), ("bin", 1)):
    tower = os.path.join(work, fmt)
    sd = chip_smoke.hf_state_dict(tiny, seed=0, device="cpu", dtype=torch.bfloat16)
    chip_smoke.write_hf_checkpoint(tower, tiny, sd, fmt=fmt, shards=shards)
    cfg = chip_smoke.hllm_config(tower, work, **small)
    # the tower's tokenizer.json (chip_smoke.py's TinyLlama layout)
    chip_smoke.write_llama_tokenizer(tower, chip_smoke.rendered_texts(cfg, data.item_text, 300),
                                     tiny["vocab_size"])
    trainer, _, result = serve(cfg, data, device="cpu")
    equal, n = chip_smoke.loaded_equal_written(trainer.model, sd, tower)
    assert equal and n > 20 and "pred_7" in result, (fmt, equal, n)
    assert set(trainer.model.tower_load_stats) == {"item_llm", "user_llm"}
    assert trainer._corpus_batcher.text_cache.tokenizer.kind == "hf:LlamaTokenizerFast"
cfg = chip_smoke.hllm_train_config(tower, work, num_negatives=16, total_iters=2,
                                   eval_interval=2, **small)
trainer, stats, result = train(cfg, data, device="cpu")
assert stats["iters"] == 2 and trainer.checkpoint_stats["asynchronous"]
assert trainer.checkpoint_stats["bytes"] > 0 and "pred_7" in result
assert trainer._corpus_batcher.text_cache.tokenizer.kind == "hf:LlamaTokenizerFast"
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu", *LACKING})
print("BAD", bad)
"""


_BASELINES = """
import sys, tempfile

# what the port runs without: importing it fails
LACKING = ("pandas", "yaml", "pyarrow", "transformers", "tokenizers", "regex", "sentencepiece",
           "safetensors")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke
from mhrec_tpu_torch.data.synthetic import InMemoryInteractionData

torch.set_num_threads(2)
data = InMemoryInteractionData(num_users=40, num_items=1000, seq_len=2 * 6 + 16,
                               num_categories=8, eval_pred_len=8, max_item_list_length=6)
# chip_smoke.py's baselines phase (the five families trained, saved, reloaded
# and served through run.train / run.serve), cut to a few widths
tower = dict(chip_smoke.TINYLLAMA_1B, vocab_size=1024, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
paths, failed, kernels = chip_smoke.baselines_phase(
    data, tempfile.mkdtemp(), device="cpu", position_negatives=8, user_llm=tower,
    n_layers=2, n_heads=2, item_embedding_size=128, hstu_embedding_size=128, embedding_size=32,
    item_embed_dim=32, eval_batch_size=32, eval_item_chunk_size=700, MAX_ITEM_LIST_LENGTH=6,
    train_batch_size=8, num_negatives=64, total_iters=2, eval_interval=2)
assert sorted(paths) == sorted(f"baselines_{f}{s}" for f in chip_smoke.BASELINE_FILES
                               for s in ("", "_serve"))
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu", *LACKING})
print("BAD", bad)
"""


def test_baselines_phase_runs_without_what_the_card_lacks():
    """chip_smoke.py's baselines phase, cut to a few widths, on the CPU in a
    fresh interpreter where PyYAML, pandas, pyarrow, ``transformers``,
    ``tokenizers``, ``regex``, ``sentencepiece`` and ``safetensors`` cannot
    be imported: every family trains, saves, reloads and serves with its
    checks but the card's launch counts passing (the serve run's metrics
    equal the training run's test metrics and a warm repeat's, the streamed
    top-k a dense sort's, a second run from the seed the first loss, #7 at
    SASRec's step bit-equal to the plain update), and nothing of JAX is
    loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BASELINES], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout[-3000:]
    recs = {r["phase"]: r for r in (json.loads(line) for line in proc.stdout.splitlines()
                                    if line.startswith('{"phase"'))}
    assert sorted(recs) == sorted(f"baselines_{f}" for f in
                                  ("ComiRec", "REMI", "DualVAE", "SASRec", "LLMIDRec"))
    for name, r in recs.items():
        assert r["serve_equals_train_test"] and r["repeat_matches"], name
        assert r["streamed_topk_matches_dense"] and r["same_seed_matches"], name
        assert all(math.isfinite(loss) for _, loss in r["losses"]), name
    assert recs["baselines_ComiRec"]["heads"] == 4 and recs["baselines_REMI"]["heads"] == 4
    row = recs["baselines_SASRec"]["row_adamw_vs_plain"]
    assert row["ok"] and row["bit_equal"] and row["D"] == 32, row
    assert recs["baselines_LLMIDRec"]["cuts"]["position_negatives"] == 8

_DISTRIBUTED = """
import json, sys, tempfile

LACKING = ("pandas", "yaml", "pyarrow", "transformers", "tokenizers", "regex", "sentencepiece")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke

torch.set_num_threads(2)
data_kw = dict(num_users=300, num_items=1000, seq_len=2 * 6 + 16, num_categories=8,
               eval_pred_len=8, max_item_list_length=6, seed=0)
tower = dict(vocab_size=1024, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2)
# chip_smoke.py's distributed phase, cut to a few widths and 4 steps (HLLM:
# 64-wide towers, chunk rows of 128 tokens, over 128 users and 384 items, 3
# steps; the baselines: 2 steps at a global batch of 8 over the HSTU
# catalog; the sharded table at 1,500 items after its reference at 701, two
# chunks of 700 rows and a one-row tail; (f) at fsdp_min_size 256, so that
# the small parameters shard; (g2)'s Qwen2 tower 96 wide, its 12 heads
# over 2 KV heads kept), over gloo on the CPU
chip_smoke.distributed_phase(
    tempfile.mkdtemp(), "cpu", device="cpu", data_kw=data_kw, n_layers=2, n_heads=2,
    item_embedding_size=128, hstu_embedding_size=128, eval_batch_size=32,
    eval_item_chunk_size=700, MAX_ITEM_LIST_LENGTH=6, num_negatives=64, total_iters=4,
    eval_interval=4, fsdp_min_size=256,
    hllm_over=dict(MAX_TEXT_LENGTH=24, eval_batch_size=64, pack_chunk=128, fsdp_min_size=256),
    hllm_tower=tower, hllm_data=dict(chip_smoke.DIST_HLLM_DATA, num_users=128, num_items=384),
    tp_qwen_tower=dict(vocab_size=1024, hidden_size=96, intermediate_size=128),
    base_over=dict(n_layers=2, n_heads=2, item_embedding_size=128, hstu_embedding_size=128,
                   embedding_size=32, item_embed_dim=32, eval_batch_size=32,
                   eval_item_chunk_size=700, MAX_ITEM_LIST_LENGTH=6, train_batch_size=8,
                   num_negatives=64),
    base_tower=tower, base_data=data_kw, table_data=data_kw, table_items=(701, 1500))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu"})
print("BAD", bad)
"""


def test_distributed_phase_runs_without_what_the_card_lacks():
    """chip_smoke.py's distributed phase, cut to a few widths and 4 steps,
    on the CPU (gloo for every group) in a fresh interpreter where PyYAML,
    pandas and pyarrow cannot be imported: the one-rank group's CLI run
    equals the ungrouped one bit for bit; the two-rank runs (HSTU with the
    table replicated and sharded, HLLM with the packed tower, each of the
    five baselines) finish with the two ranks in one state and hold every
    check against the rank-order oracle (loss, checksum, metrics, the
    checkpoint served by one process, ZeRO-2), whose parameters equal
    theirs; (f) HSTU under zero_stage 3 and HLLM under fsdp equal their
    ZeRO-2 runs bit for bit with fewer persistent bytes a rank and no whole
    sharded tensor alive after a step; (g) HLLM over four ranks at tp_size 2
    (data 2 × model 2) and, at Qwen2-1.5B's head counts, tp_size 4 hold their
    oracles and their checkpoints serve at one process; the sharded table holds half the
    rows a rank, and neither rank
    makes a tensor of the whole table but rank 0's host assembly for the
    file and the checkpoint read into host memory, in (b) and in (e); and
    nothing of JAX is loaded (the card's launch counts and memory are not
    held here)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    # about 135 s alone; the limit guards against a hang, with room for a
    # machine that other test workers share
    proc = subprocess.run([sys.executable, "-c", _DISTRIBUTED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout[-3000:]
    rec = next(json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith('{"phase": "distributed"'))
    w1 = rec["world1_nccl_cli"]
    assert w1["ok"] and w1["losses_bit_equal"] and w1["checksum_bit_equal"], w1
    assert w1["metrics_bit_equal"]
    for name in ("gloo_replicated", "gloo_sharded", "gloo_hllm"):
        g = rec[name]
        assert g["between_ranks_rel_diff"] <= 1e-6, g
        assert g["final_loss_rel_diff"] <= 2e-4 and g["checksum_rel_diff"] <= 1e-5, g
        assert g["collective_bytes_per_step"]["pool_gather"] > 0, g
        assert all(ok for check, ok in g["checks"].items() if check != "launches"), g
        assert g["params_max_abs_diff_vs_oracle"] <= 1e-6 and g["oracle_pool_probe_exact"], g
    assert rec["gloo_hllm"]["collective_bytes_per_step"]["corpus_gather"] > 0
    assert rec["sharded_table_bytes_halved"]
    assert rec["gloo_sharded"]["table_rows"] == [500, 500]
    # (d): every family over two ranks against its oracle
    base = rec["gloo_baselines"]
    assert sorted(base) == ["ComiRec", "DualVAE", "LLMIDRec", "REMI", "SASRec"], base.keys()
    for family, g in base.items():
        assert g["between_ranks_rel_diff"] <= 1e-6, (family, g)
        assert g["final_loss_rel_diff"] <= 2e-4 and g["checksum_rel_diff"] <= 1e-5, (family, g)
        assert all(ok for check, ok in g["checks"].items() if check != "launches"), (family, g)
        assert g["params_max_abs_diff_vs_oracle"] <= 1e-6, (family, g)
    for family in ("ComiRec", "REMI", "DualVAE"):
        assert base[family]["collective_bytes_per_step"]["pool_gather"] > 0, family
    # (e) and (b)'s sharded run: no whole table in either rank but rank 0's
    # host assembly for the file and the checkpoint read into host memory
    table = rec["gloo_table"]
    assert table["checks"]["memory"], table
    assert table["items"] == 1500 and table["reference_items"] == 701, table
    for r in table["ranks"] + rec["gloo_sharded"]["table_memory"]:
        assert r["table_hits_ok"], r
    # (e) saves without a test split; (b) also loads for its test split
    assert [p for p, _ in table["ranks"][0]["table_hits_by_phase_device"]] == ["save"]
    assert table["ranks"][1]["table_hits_by_phase_device"] == []
    # (f): HSTU under zero_stage 3 and HLLM under fsdp, against their
    # oracles and their ZeRO-2 runs
    for name in ("gloo_fsdp_hstu", "gloo_fsdp_hllm"):
        g = rec[name]
        assert all(ok for check, ok in g["checks"].items() if check != "launches"), (name, g)
        assert g["bit_equal_to_zero2"] and g["params_max_abs_diff_vs_oracle"] <= 1e-6, g
        assert all(r["live_whole_after_steps"] == 0 and r["total_gb"] < r["zero2_total_gb"]
                   for r in g["ranks"]), g
        assert g["fsdp_collective_bytes_per_step"]["fsdp_reduce_scatter"] > 0, g
    # (g): tensor parallelism over four ranks, against (c)'s oracle and
    # checkpoint and against one process
    for name in ("gloo_tp_tinyllama", "gloo_tp_qwen2"):
        g = rec[name]
        assert all(ok for check, ok in g["checks"].items() if check != "launches"), (name, g)
        assert g["final_loss_rel_diff"] <= 2e-4 and g["checksum_rel_diff"] <= 1e-5, g
        assert g["between_ranks_rel_diff"] <= 1e-6, g
        assert g["model_group_bytes_per_step"]["tp_reduce"] > 0, g
    assert rec["gloo_tp_tinyllama"]["checks"]["t1_checkpoint"]
    assert rec["gloo_tp_qwen2"]["model_group_bytes_per_step"]["tp_whole_grad"] > 0
    shard_mem = rec["gloo_sharded"]["table_memory"]
    assert [p for p, _ in shard_mem[0]["table_hits_by_phase_device"]] == ["load", "save"]
    assert [p for p, _ in shard_mem[1]["table_hits_by_phase_device"]] == ["load"]
    assert all(r["table_chunk_bytes_per_eval"] > 0 for r in table["ranks"])


def test_tp_size_builds_and_an_indivisible_world_raises(synth_dir, tmp_path):
    """``tp_size: 2`` no longer raises "not ported yet": an HLLM built
    outside a process group keeps its towers whole (``tp_shard`` set, no
    model group); a trainer whose world (1) does not divide by ``tp_size``
    raises with the JAX assert's numbers (W, T), as ``make_mesh`` does over
    any such world."""
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import InteractionData
    from mhrec_tpu_torch.models.hllm.hllm import hllm_from_config
    from mhrec_tpu_torch.parallel import make_mesh
    from mhrec_tpu_torch.parallel.tensor import split_params
    from mhrec_tpu_torch.trainer import Trainer

    over = dict(data_path=synth_dir["data_path"], dataset=synth_dir["name"],
                text_path=synth_dir["text_path"], random_init_towers=True, tp_size=2,
                MAX_ITEM_LIST_LENGTH=4, MAX_TEXT_LENGTH=8, tag_version="v1",
                checkpoint_dir=str(tmp_path))
    cfg = Config(config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"],
                 config_dict=over).finalize()
    data = InteractionData(cfg).build()
    model = hllm_from_config(cfg, data)
    assert model.item_llm.config.tp_shard and model.user_llm.config.tp_shard
    assert split_params(model) == {}
    with pytest.raises(ValueError, match=r"\(1, 2\)"):
        Trainer(cfg, data, device="cpu")
    with pytest.raises(ValueError, match=r"\(1, 3\)"):
        make_mesh(3)
    assert make_mesh(1).world == 1


def test_pretrained_towers_load_without_what_the_card_lacks():
    """HLLM towers from checkpoints written by ``chip_smoke.py``'s own
    writer (bfloat16, two ``.safetensors`` shards with an index, and a
    ``pytorch_model.bin``) and a tokenizer.json beside them, served and
    trained (an asynchronous best-checkpoint save) on the CPU in a fresh
    interpreter where safetensors, transformers, tokenizers, regex,
    sentencepiece, pandas, PyYAML and pyarrow cannot be imported: every
    loaded tensor equals the written one, both paths tokenize with the
    port's HF tokenizer, and nothing forbidden, JAX included, is loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PRETRAINED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    """Alone in a directory the script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


_IMAGE = """
import sys, tempfile

# what the port runs without: importing it fails
LACKING = ("pandas", "yaml", "pyarrow", "transformers", "tokenizers", "regex", "sentencepiece",
           "safetensors", "torchvision", "decord")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke as c

torch.set_num_threads(2)
# chip_smoke.py's Qwen2-VL-2B / Qwen2.5-1.5B / CLIP-L LLaVA configs cut to a
# few widths (the vocabulary stays: the vision tokens' ids are 151,652+)
small = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2)
item = dict(c.QWEN2_VL_2B, **small, rope_scaling={"type": "mrope", "mrope_section": [2, 1, 1]},
            vision_config=dict(c.QWEN2_VL_2B["vision_config"], depth=2, embed_dim=16,
                               num_heads=4, mlp_ratio=2, patch_size=4, hidden_size=32))
user = dict(c.QWEN25_1_5B, **small)
llava = dict(c.CLIP_L14_LLAVA, text_config=user, vision_config=dict(
    c.CLIP_L14_LLAVA["vision_config"], hidden_size=16, num_hidden_layers=3,
    num_attention_heads=4, intermediate_size=32, patch_size=4, image_size=16))
paths, failed = c.hllm_image_phase(tempfile.mkdtemp(), device="cpu", item_cfg=item,
                                   user_cfg=user, n_users=40, n_items=256, img_height=16,
                                   img_width=16, MAX_TEXT_LENGTH=32, eval_batch_size=32)
assert not failed and set(paths) == {"hllm_image_serve", "hllm_image_train"}, failed
paths, failed = c.hllm_image_variants_phase(tempfile.mkdtemp(), device="cpu", n_users=40,
                                            n_items=256, widths=(item, user, llava), img=16,
                                            image_min_pixels=4 * 64, image_max_pixels=16 * 64)
assert not failed and set(paths) == {f"hllm_image_{v}_{p}" for p in ("serve", "train")
                                     for v in ("video", "dynamic", "llava_anyres",
                                               "llava_dynamic")}
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu", *LACKING})
print("BAD", bad)
"""


def test_image_phases_run_without_what_the_card_lacks():
    """chip_smoke.py's hllm_image and hllm_image_variants phases (the
    Qwen2-VL image tower serving and training, video, dynamic resolution,
    the LLaVA towers with fixed and dynamic AnyRes, the vision weights from
    a checkpoint), cut to a few widths, on the CPU in a fresh interpreter
    where pandas, PyYAML, pyarrow, ``transformers``, ``tokenizers``,
    ``regex``, ``sentencepiece``, ``safetensors``, ``torchvision`` and
    ``decord`` cannot be imported: every check of both phases passes (no
    kernel of the port runs on these paths) and nothing forbidden is
    loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMAGE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout[-3000:]
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"phase"')]
    phases = [r["phase"] for r in recs]
    assert phases[:3] == ["hllm_image_setup", "hllm_image_serve", "hllm_image_train"]
    assert phases[-1] == "hllm_image_variants" and recs[-1]["ok"]
    assert recs[1]["towers"]["image_tokens"] == 4


_REFERENCE = """
import json, sys, tempfile

LACKING = ("pandas", "yaml", "pyarrow", "transformers", "tokenizers", "regex", "sentencepiece",
           "scipy", "wandb", "tensorboardX")
sys.modules.update({name: None for name in LACKING})
import torch
import chip_smoke

torch.set_num_threads(2)
data_kw = dict(num_users=64, num_items=500, seq_len=20, num_categories=8, eval_pred_len=8,
               max_item_list_length=6, seed=0)
chip_smoke.reference_ckpt_phase(data_kw, tempfile.mkdtemp(), device="cpu", n_layers=2,
                                n_heads=2, item_embedding_size=128, hstu_embedding_size=128,
                                eval_batch_size=32, eval_item_chunk_size=300,
                                MAX_ITEM_LIST_LENGTH=6)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "mhrec_tpu", *LACKING})
print("BAD", bad)
"""


def test_reference_ckpt_phase_runs_without_what_the_card_lacks():
    """chip_smoke.py's reference-checkpoint phase at a few widths on the
    CPU in a fresh interpreter where pandas, PyYAML, pyarrow, scipy, wandb,
    tensorboardX and the tokenizer packages cannot be imported: the written
    reference checkpoint converts through the CLI's entry point and serves
    at the directly loaded tensors' metrics, and nothing of JAX is
    loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout[-3000:]
    rec = next(json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith('{"phase": "reference_ckpt"'))
    assert all(ok for k, ok in rec["checks"].items() if k != "launches"), rec
