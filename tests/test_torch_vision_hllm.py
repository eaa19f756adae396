"""The port's HLLM with an image or video item tower against the JAX
package's, on the CPU.

Both packages build HLLM from the same tiny Qwen2-VL ``config.json`` (no
weight files: the towers start at random): a text tower 32 wide, 2 layers,
4 heads over 2 KV heads, q/k/v biases and M-RoPE sections (2, 1, 1), and a
vision tower 16 wide, 2 blocks, 4 heads, patch 4, temporal patch 2, merge 2,
quick-GELU. Hierarchical prior heads (4 categories × 2 segment heads, one
medusa layer), ``precision: 32``, the dense item tower, on the parquet
fixture of ``generate_synthetic_dataset`` (120 users, 300 items), with
JPEGs of mixed sizes for the first 24 items (the rest take the black
fallback) or, for video, 4-frame directories of PNGs for the first 12.
The JAX parameters are drawn with numpy over the shapes of the model's init
and carried into the port with ``convert.py``; the batches are the JAX
batcher's, fed to both. The cases:

* ``image``: 16×16 images (a 4×4 patch grid, 4 image tokens an item);
* ``dynamic``: ``dynamic_image_res`` (smart-resize grids of 1-6 tokens, the
  ``img_src`` splice and the host's M-RoPE positions);
* ``video``: ``use_video`` with 4 frames (grid_t 2, 8 video tokens);
* ``llava``: a CLIP-arch LLaVA tower (16 wide, 2 layers, patch 4) with the
  fixed ``anyres_grid`` [2, 2] (24 image tokens), over a Llama text tower;
* ``llava_dynamic``: that tower with dynamic AnyRes (pinpoints 16×8 and
  8×16 over 8×8 crops: the ``tok_src`` gather, 4-16 image tokens an item).

For each: the batches of both text batchers equal; one batch's loss (rtol
1e-5) and every gradient (relative L2 error 2e-4, a tensor's norm taken as
at least 1e-4 of the largest one's: float32 summation order, as in
``test_torch_hllm_train.py``) against ``jax.value_and_grad`` of
``HLLM.__call__``; the corpus item table (1e-5) and every metric of the
test split's evaluation (1e-6; rounded to 7 places) against the JAX
``Trainer``. Last, ``python -m mhrec_tpu_torch.run --device cpu`` trains
and evaluates the ``image`` case from the CLI.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.data import InteractionData as JaxData
from mhrec_tpu.data import build_dataloader as jax_build_dataloader
from mhrec_tpu.data.textset import TextSEQTrainBatcher as JaxTextBatcher
from mhrec_tpu.trainer import Trainer as JaxTrainer
from mhrec_tpu_torch.config import Config
from mhrec_tpu_torch.convert import state_dict_from_flax
from mhrec_tpu_torch.data import InteractionData, build_eval_dataloaders
from mhrec_tpu_torch.data.textset import TextSEQTrainBatcher
from mhrec_tpu_torch.run import main
from mhrec_tpu_torch.trainer import Trainer

PIL = pytest.importorskip("PIL")
torch.set_num_threads(2)

YAMLS = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
TABLE_TOL = 1e-5
METRIC_TOL = 1e-6
IMAGE_SIZES = [(8, 8), (16, 8), (16, 24), (8, 32)]


def write_qwen2vl_config(dirpath):
    """A tiny ``qwen2_vl`` ``config.json`` (the layout of
    ``tests/test_vision.py:_write_tiny_qwen2vl_ckpt``), no weights."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump({"model_type": "qwen2_vl", "vocab_size": 96, "hidden_size": 32,
                   "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
                   "rope_scaling": {"type": "mrope", "mrope_section": [2, 1, 1]},
                   "vision_config": {"embed_dim": 16, "depth": 2, "num_heads": 4,
                                     "mlp_ratio": 2, "patch_size": 4, "temporal_patch_size": 2,
                                     "spatial_merge_size": 2, "hidden_size": 32,
                                     "hidden_act": "quick_gelu"}}, fh)
    return str(dirpath)


def write_llava_config(dirpath):
    """A tiny ``llava_next`` ``config.json`` (``tests/test_vision.py:
    _write_tiny_llava_ckpt``'s layout), no weights."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as fh:
        json.dump({"model_type": "llava_next",
                   "text_config": {"model_type": "llama", "vocab_size": 96, "hidden_size": 32,
                                   "intermediate_size": 64, "num_hidden_layers": 2,
                                   "num_attention_heads": 4, "num_key_value_heads": 2,
                                   "rms_norm_eps": 1e-5},
                   "vision_config": {"model_type": "clip_vision_model", "hidden_size": 16,
                                     "num_hidden_layers": 2, "num_attention_heads": 4,
                                     "intermediate_size": 32, "patch_size": 4, "image_size": 8,
                                     "hidden_act": "quick_gelu"}}, fh)
    return str(dirpath)


def write_images(root, n, seed=5):
    """JPEGs of IMAGE_SIZES (cycled) for items i0..i{n-1} under ``root``."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = IMAGE_SIZES[i % len(IMAGE_SIZES)]
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8), "RGB").save(
            os.path.join(root, f"i{i}.jpg"))


def write_frame_dirs(root, n, frames=4, seed=6):
    """Directories of ``frames`` PNG frames for items i0..i{n-1}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        d = os.path.join(root, f"i{i}")
        os.makedirs(d)
        for t in range(frames):
            Image.fromarray(rng.integers(0, 255, (20, 24, 3), np.uint8), "RGB").save(
                os.path.join(d, f"f{t:02d}.png"))


CASES = {
    "image": dict(use_image=True, img_height=16, img_width=16),
    "dynamic": dict(use_image=True, dynamic_image_res=True, image_min_pixels=64,
                    image_max_pixels=384),
    "video": dict(use_video=True, video_nframes=4, img_height=16, img_width=16),
    "llava": dict(use_image=True, anyres_grid=[2, 2], img_height=8, img_width=8,
                  MAX_TEXT_LENGTH=40),
    "llava_dynamic": dict(use_image=True, dynamic_image_res=True,
                          image_grid_pinpoints=[[16, 8], [8, 16]], img_height=8, img_width=8,
                          MAX_TEXT_LENGTH=40),
}


@pytest.fixture(scope="module")
def fixture(synth_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_vision_hllm")
    write_images(str(tmp / "images" / synth_dir["name"]), 24)
    write_frame_dirs(str(tmp / "videos" / synth_dir["name"]), 12)
    return dict(tmp=tmp, synth=synth_dir, qwen=write_qwen2vl_config(tmp / "qwen2vl"),
                llava=write_llava_config(tmp / "llava"))


def _overrides(f, case, **over):
    tower = f["llava"] if case.startswith("llava") else f["qwen"]
    s = f["synth"]
    d = dict(
        data_path=s["data_path"], dataset=s["name"], text_path=s["text_path"],
        precision="32", item_pretrain_dir=tower, user_pretrain_dir=tower,
        image_dir=str(f["tmp"] / "images"), use_native_sampler=False,
        MAX_ITEM_LIST_LENGTH=4, MAX_TEXT_LENGTH=24, train_batch_size=2, eval_batch_size=32,
        num_negatives=8, tag_version="v1", loss="prior", eval_num_cats=4, num_prior_head=4,
        num_segment_head=2, head_interaction="hierarchical", medusa_num_layers=1,
        pred_len=2, eval_pred_len=2, topk=[5, 10], packed_item_tower=False,
        suppress_history=False, token_cache_dir=False, scheduler_args={"type": "constant"},
        checkpoint_dir=str(f["tmp"] / f"ckpt_{case}"),
    )
    d.update(CASES[case])
    if case == "video":
        d.pop("image_dir")
        d["video_dir"] = str(f["tmp"] / "videos")
    d.update(over)
    return d


def _random_params(jt, seed):
    """Parameters at the shapes the JAX model's init makes (``jax.eval_shape``,
    no compile): normal / sqrt(fan in) kernels, normal 0.02 biases and
    embedding tables, 1 + 0.1·normal norm scales, unit-normal token
    embeddings and emb-token slots, logit scale ln(1/0.07). Narrower
    kernels leave the 2-layer towers close to the identity: every item's
    embedding would be its emb-token slot's, the cosines would sit above
    the loss's 0.99 NCE threshold and every gradient would vanish."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "mix", "neg"))}
    shapes = jax.eval_shape(lambda: jt.model.init(rngs, jt._example_batch(minimal=True),
                                                  deterministic=False))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        if "logit_scale" in key:
            return np.full(x.shape, np.log(1 / 0.07), np.float32)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if "norm" in key or key.endswith("['scale']"):
            return 1.0 + 0.1 * noise
        if "embed_tokens" in key or "item_emb_tokens" in key:
            return noise
        if key.endswith("['kernel']"):
            return noise / np.sqrt(x.shape[0])
        return 0.02 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, fixture):
    """The JAX model of a case at random parameters, its first batch, the
    loss and gradients of ``HLLM.__call__``, and the port's trainer at the
    same parameters."""
    name = request.param
    over = _overrides(fixture, name)
    jcfg = JaxConfig(config_file_list=YAMLS, config_dict=over).finalize()
    tcfg = Config(config_file_list=YAMLS, config_dict=over).finalize()
    jdata = JaxData(jcfg).build()
    jt = JaxTrainer(jcfg, jdata)
    params = _random_params(jt, seed=1)
    if name.startswith("llava"):
        # the JAX model's init batch has no AnyRes crops, so flax makes the
        # image_newline row only at the first call with them: drawn here
        params["visual"]["image_newline"] = np.random.default_rng(2).normal(
            size=32).astype(np.float32)
    batch = next(JaxTextBatcher(jcfg, jdata).epoch_batches(0))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "mix", "neg"))}

    def loss_fn(p):
        out = jt.model.apply({"params": p}, {k: jnp.asarray(v) for k, v in batch.items()},
                             deterministic=False, rngs=rngs)
        return out["loss"], out

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    data = InteractionData(tcfg).build()
    tt = Trainer(tcfg, data, device="cpu")
    tt.setup_model()
    tt.model.load_state_dict(state_dict_from_flax(params, tcfg), strict=True)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jdata=jdata, data=data, jt=jt, params=params,
                batch=batch, loss=float(loss), grads=jax.tree.map(np.asarray, grads), tt=tt)


def test_text_batcher_matches_jax(case):
    """The port's train batches (tokens with the image span, patches, the
    dynamic maps) equal the JAX package's."""
    ours = TextSEQTrainBatcher(case["tcfg"], case["data"]).epoch_batches(0)
    ref = JaxTextBatcher(case["jcfg"], case["jdata"]).epoch_batches(0)
    for _ in range(2):
        b, r = next(ours), next(ref)
        assert set(b) == set(r) and "pos_pixel_patches" in r
        for key in r:
            np.testing.assert_array_equal(b[key], r[key], err_msg=key)


def _rel_l2(a, b, floor):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def test_loss_and_grads_match_jax(case):
    model = case["tt"].model
    assert hasattr(model, "visual")
    model.zero_grad(set_to_none=True)
    out = model(case["tt"]._train_device_batch(case["batch"]),
                generator=case["tt"].step_generator(0))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), case["loss"], rtol=LOSS_TOL)
    want = state_dict_from_flax(case["grads"], case["tcfg"])
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    assert any(k.startswith("visual.") for k in want)
    floor = 1e-4 * max(float(np.linalg.norm(g.numpy())) for g in want.values())
    for name, g in want.items():
        err = _rel_l2(named[name].grad.numpy(), g.numpy(), floor)
        assert err <= GRAD_TOL, (case["name"], name, err)
    # the images reach the loss: the vision tower's gradients are not noise
    vis = max(float(np.linalg.norm(g.numpy())) for k, g in want.items()
              if k.startswith("visual."))
    assert vis > floor


def test_corpus_table_and_evaluation_match_jax(case):
    """The corpus pass (the item tower over every item with its image) and
    the test split's evaluation against the JAX ``Trainer``'s."""
    jt, tt = case["jt"], case["tt"]
    jt.state = SimpleNamespace(params=jax.tree.map(jnp.asarray, case["params"]))
    jt.extra_vars = {}
    ref_table = np.asarray(jt.compute_item_feature())
    table = tt.compute_item_feature().numpy()
    np.testing.assert_allclose(table, ref_table, rtol=TABLE_TOL, atol=TABLE_TOL)
    jtest = jax_build_dataloader(case["jcfg"], case["jdata"])[2]
    ref = jt.evaluate(jtest, load_best_model=False)
    out = tt.evaluate(build_eval_dataloaders(case["tcfg"], case["data"])[1])
    assert set(out) == set(ref)
    for section in ref:
        for key, v in ref[section].items():
            assert out[section][key] == pytest.approx(float(v), abs=METRIC_TOL), (section, key)


def test_run_trains_an_image_tower_on_the_cpu(fixture, tmp_path):
    """``python -m mhrec_tpu_torch.run --device cpu`` with ``--use_image
    True`` (the HLLM-Pixel8M scripts' flags, at the tiny widths): a fit of 2
    steps with gradient checkpointing, an evaluation with a best-checkpoint
    save, and the test split from that checkpoint."""
    over = _overrides(fixture, "image", checkpoint_dir=str(tmp_path / "ckpt"))
    args = ["--config_file", *YAMLS, "--device", "cpu", "--"]
    for key in ("data_path", "dataset", "text_path", "item_pretrain_dir", "user_pretrain_dir",
                "image_dir", "img_height", "img_width", "precision", "MAX_ITEM_LIST_LENGTH",
                "MAX_TEXT_LENGTH", "train_batch_size", "eval_batch_size", "num_negatives",
                "tag_version", "loss", "eval_num_cats", "num_prior_head", "num_segment_head",
                "head_interaction", "medusa_num_layers", "pred_len", "eval_pred_len",
                "checkpoint_dir"):
        args += [f"--{key}", str(over[key])]
    args += ["--use_image", "True", "--use_image_online", "False", "--packed_item_tower",
             "False", "--gradient_checkpointing", "True", "--total_iters", "2",
             "--eval_interval", "2", "--topk", "[5,10]", "--token_cache_dir", "false"]
    out = main(args)
    assert "pred_1" in out and all(np.isfinite(v) for v in out["pred_1"].values())
    assert (tmp_path / "ckpt" / f"HLLM-{over['dataset']}" / "ckpt" / "checkpoint.pt").is_file()
