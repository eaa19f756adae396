"""``python -m mhrec_tpu_torch.run --device cpu`` trains each of the five
baselines (fit with an evaluation and a best-checkpoint save, then the test
split from that checkpoint) and serves it (``--val_only True``, from the
checkpoint), on the synthetic fixture at small widths with
``sparse_item_adam`` on. LLMIDRec, given no user pretrain directory, takes
the dummy tower, as in the JAX package."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["SASRec", "ComiRec", "REMI", "DualVAE", "LLMIDRec"]


def _cli(synth_dir, tmp_path, family, extra):
    files = {"SASRec": ["IDNet/sasrec.yaml"], "ComiRec": ["IDNet/comirec.yaml"],
             "REMI": ["IDNet/remi.yaml"], "DualVAE": ["IDNet/dualvae.yaml"],
             "LLMIDRec": ["IDNet/llama_id.yaml"]}[family]
    cmd = [sys.executable, "-m", "mhrec_tpu_torch.run", "--device", "cpu", "--config_file",
           *files, "overall/ID.yaml", "--", "--model", family,
           "--data_path", synth_dir["data_path"], "--dataset", synth_dir["name"],
           "--text_path", synth_dir["text_path"], "--MAX_ITEM_LIST_LENGTH", "8",
           "--train_batch_size", "8", "--eval_batch_size", "32", "--num_negatives", "16",
           "--n_layers", "1", "--n_heads", "2", "--embedding_size", "32",
           "--item_embedding_size", "128", "--hstu_embedding_size", "128",
           "--item_embed_dim", "32", "--topk", "[5,10]", "--total_iters", "2",
           "--eval_interval", "2", "--tag_version", "v1", "--sparse_item_adam", "True",
           "--checkpoint_dir", str(tmp_path), *extra]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout + proc.stderr


@pytest.mark.parametrize("family", FAMILIES)
def test_run_trains_and_serves_on_the_cpu(synth_dir, tmp_path, family):
    """``run.py`` trains (fit with an evaluation and a best-checkpoint
    save, the test split from it), then ``--val_only True`` serves from
    that checkpoint."""
    log = _cli(synth_dir, tmp_path, family, [])
    assert "fit done: 2 steps" in log and "pred_0: {" in log
    ckpt = tmp_path / f"{family}-SynthRec" / "ckpt" / "checkpoint.pt"
    assert ckpt.is_file()
    log = _cli(synth_dir, tmp_path, family, ["--val_only", "True"])
    assert "pred_0: {" in log and "fit done" not in log
