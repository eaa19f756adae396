"""The port's vision modules against the JAX package's, on the CPU: the
host-side preprocessing (``data/vision.py``), the rotary tables and M-RoPE,
the Qwen2-VL and CLIP / LLaVA towers (``models/llm/vision.py``), the
dynamic-resolution arrays of the text batcher, and the HF weight maps.

Each case of ``tests/test_vision.py`` has its counterpart here, on inputs
drawn with numpy from a seed:

* the patchifiers, the black fallback, the AnyRes crops, the dynamic and
  AnyRes capacity arrays, the video patches, frame lists and store, and
  the ``smart_resize`` / ``select_best_resolution`` / ``smart_nframes``
  integers: exactly equal (the same numpy and PIL code);
* the rotary tables, the per-image ones and ``mrope_rotary_embedding``:
  within 1e-6;
* ``VisionTower`` static, dynamic and video, ``ClipVisionTower`` plain,
  fixed AnyRes and dynamic AnyRes, at tiny widths (``VisionConfig.tiny``: 2
  blocks 32 wide; CLIP 16 wide), the JAX parameters carried across by
  ``convert.py``: float32 within 1e-5 relative to the largest output; one
  bfloat16 case within 2 bfloat16 ulps of the largest output (3.9e-3
  relative: the products round to bfloat16 in a different order);
* the weight maps of a tiny Qwen2-VL and a tiny LLaVA checkpoint: the
  port's state dict equal to the JAX map's carried through ``convert.py``,
  and ``load_pretrained_towers`` loading them into the port's HLLM.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhrec_tpu.data import vision as jdv
from mhrec_tpu.models.llm import llama as jllama
from mhrec_tpu.models.llm import vision as jvis
from mhrec_tpu_torch.convert import vision_state_dict_from_flax
from mhrec_tpu_torch.data import vision as tdv
from mhrec_tpu_torch.models.llm import llama as tllama
from mhrec_tpu_torch.models.llm import vision as tvis
from test_vision import _write_tiny_llava_ckpt, _write_tiny_qwen2vl_ckpt

Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

ROPE_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -8  # two bfloat16 ulps, relative to the largest output


def _jpeg(path, h, w, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8), "RGB").save(path)
    return str(path)


def _same(a, b):
    """Equal arrays, or equal tuples of arrays."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- host preprocessing ---------------------------------------------------------
@pytest.mark.parametrize("geom", [(8, 8, 2, 2, 2), (16, 24, 4, 2, 2), (12, 12, 2, 1, 3)],
                         ids=["8x8", "16x24", "tps1_m3"])
def test_patchify_matches_jax(geom):
    """The HF Qwen2-VL patch order: random pixels, and the pixel-coordinate
    mapping of ``test_patchify_pixel_mapping``."""
    H, W, ps, tps, m = geom
    kw = dict(patch_size=ps, temporal_patch_size=tps, spatial_merge_size=m)
    ours, ref = tdv.ImagePreprocessor(H, W, **kw), jdv.ImagePreprocessor(H, W, **kw)
    chw = np.random.default_rng(0).normal(size=(3, H, W)).astype(np.float32)
    _same(ours._patchify(chw), ref._patchify(chw))
    coords = np.zeros((3, H, W), np.float32)
    coords[0], coords[1] = np.arange(H)[:, None], np.arange(W)[None, :]
    patches = ours._patchify(coords)
    gw = W // ps
    for p in range(ours.n_patches):
        hb, rem = divmod(p, (gw // m) * m * m)
        wb, rem2 = divmod(rem, m * m)
        mh, mw = divmod(rem2, m)
        row0, col0 = (hb * m + mh) * ps, (wb * m + mw) * ps
        vec = patches[p].reshape(3, tps, ps, ps)
        np.testing.assert_array_equal(vec[0, 0], coords[0, row0:row0 + ps, col0:col0 + ps])
        np.testing.assert_array_equal(vec[:, 0], vec[:, -1])  # the frame over tps


def test_black_fallback_and_load_match_jax(tmp_path):
    kw = dict(patch_size=2, temporal_patch_size=2, spatial_merge_size=2)
    ours, ref = tdv.ImagePreprocessor(8, 8, **kw), jdv.ImagePreprocessor(8, 8, **kw)
    _same(ours.load(None), ref.load(None))
    _same(ours.load(str(tmp_path / "missing.jpg")), ref.load(None))
    broken = tmp_path / "broken.jpg"
    broken.write_bytes(b"not a jpeg")
    _same(ours.load(str(broken)), ref.load(None))  # broken: the black image, as in JAX
    paths = [_jpeg(tmp_path / f"x{i}.jpg", 12 + i, 10, i) for i in range(6)] + [None, None]
    _same(ours.batch(paths), ref.batch(paths))
    assert not np.array_equal(ours.load(paths[0]), ours.load(None))


def test_anyres_crops_match_jax():
    kw = dict(patch_size=4, temporal_patch_size=1, spatial_merge_size=1, anyres_grid=(2, 2))
    ours, ref = tdv.ImagePreprocessor(8, 8, **kw), jdv.ImagePreprocessor(8, 8, **kw)
    assert (ours.n_crops, ours.n_tokens) == (ref.n_crops, ref.n_tokens) == (5, 4 + 4 * 5)
    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (32, 48, 3), np.uint8))
    _same(ours.preprocess(img), ref.preprocess(img))
    _same(ours._black, ref._black)


def test_smart_resize_and_best_resolution_match_jax():
    for h in (1, 7, 28, 30, 100, 280, 481, 1024, 2000, 3001):
        for w in (1, 13, 28, 50, 300, 560, 641, 768, 2800):
            for lo, hi in ((4 * 784, 256 * 784), (4 * 784, 16384 * 784), (64, 384)):
                for factor in (28, 8):
                    assert (tdv.smart_resize(h, w, factor, lo, hi)
                            == jdv.smart_resize(h, w, factor, lo, hi)), (h, w, lo, hi, factor)
    pins = [(32, 16), (16, 32), (32, 32), (48, 16), (16, 48)]
    for oh in (1, 10, 16, 17, 20, 40, 100, 300):
        for ow in (1, 10, 16, 33, 40, 300):
            assert (tdv.select_best_resolution(oh, ow, pins)
                    == jdv.select_best_resolution(oh, ow, pins))


def test_smart_nframes_matches_jax():
    eles = [{}, {"nframes": 5}, {"nframes": 7}, {"fps": 30.0, "max_frames": 8},
            {"fps": 1.0}, {"min_frames": 6}, {"nframes": 2}]
    for ele in eles:
        for total in (4, 10, 100, 1000):
            for fps in (24.0, 30.0):
                try:
                    want = jdv.smart_nframes(ele, total_frames=total, video_fps=fps)
                except ValueError:
                    with pytest.raises(ValueError):
                        tdv.smart_nframes(ele, total_frames=total, video_fps=fps)
                    continue
                assert tdv.smart_nframes(ele, total_frames=total, video_fps=fps) == want
    with pytest.raises(AssertionError):
        tdv.smart_nframes({"nframes": 4, "fps": 2}, total_frames=100, video_fps=30)


def test_dynamic_and_anyres_preprocessors_match_jax(tmp_path):
    kw = dict(patch_size=4, temporal_patch_size=2, spatial_merge_size=2, min_pixels=4 * 64,
              max_pixels=16 * 64)
    ours, ref = tdv.DynamicImagePreprocessor(**kw), jdv.DynamicImagePreprocessor(**kw)
    paths = [_jpeg(tmp_path / f"d{i}.png", h, w, i)
             for i, (h, w) in enumerate([(16, 32), (8, 8), (40, 12), (64, 64)])]
    for p in paths + [None]:
        _same(ours.load(p), ref.load(p))
        assert ours.grid_for_path(p) == ref.grid_for_path(p)
    a_kw = dict(patch_size=4, image_size=16, pinpoints=[(32, 16), (16, 32), (32, 32)])
    ours, ref = tdv.AnyResPreprocessor(**a_kw), jdv.AnyResPreprocessor(**a_kw)
    for p in [_jpeg(tmp_path / f"a{i}.jpg", h, w, i)
              for i, (h, w) in enumerate([(16, 64), (64, 16), (20, 20), (33, 17)])] + [None]:
        _same(ours.load(p), ref.load(p))
    for oh, ow in ((16, 64), (64, 16), (20, 20), (33, 17), (5, 90)):
        assert ours.count_for_size(oh, ow) == ref.count_for_size(oh, ow)


def test_video_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for T, H, W in ((4, 56, 84), (3, 28, 28)):
        frames = rng.uniform(0, 255, (T, 3, H, W)).astype(np.float32)
        _same(tdv.patchify_video(frames), jdv.patchify_video(frames))
    pil = [Image.fromarray(rng.integers(0, 255, (40, 52, 3), np.uint8)) for _ in range(3)]
    ours, ref = tdv.fetch_video({"video": pil}), jdv.fetch_video({"video": pil})
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        _same(np.asarray(a), np.asarray(b))
    d = tmp_path / "frames"
    d.mkdir()
    for t in range(5):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), np.uint8)).save(d / f"f{t:02d}.png")
    kw = dict(nframes=4, patch_size=4, temporal_patch_size=2, spatial_merge_size=2)
    ours, ref = tdv.VideoPreprocessor(16, 16, **kw), jdv.VideoPreprocessor(16, 16, **kw)
    _same(ours.preprocess(str(d)), ref.preprocess(str(d)))
    _same(ours.preprocess([]), ref.preprocess([]))


def test_video_file_decode_unavailable_is_loud():
    """A video file without torchvision or decord raises ImportError naming
    the way out, as the JAX package does."""
    try:
        import torchvision  # noqa: F401
        pytest.skip("torchvision available; the decode path would run")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="list of frame images"):
        tdv.fetch_video({"video": "/nonexistent/clip.mp4"})


def test_item_stores_and_dynamic_arrays_match_jax(synth_dir, tmp_path):
    """``ItemImageStore`` (static, smart-resize dynamic, LLaVA AnyRes) and
    ``ItemVideoStore``, and the text batcher's dynamic maps (``img_src``,
    ``img_pos``, ``tok_src``), against the JAX package's on the same items:
    images for some, none for others (black), item 0 (padding)."""
    from mhrec_tpu.config import Config as JaxConfig
    from mhrec_tpu.data import InteractionData as JaxData
    from mhrec_tpu.data import textset as jts
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import textset as tts

    q = tmp_path / "qwen2vl"
    _write_tiny_qwen2vl_ckpt(str(q))
    llava = tmp_path / "llava"
    _write_tiny_llava_ckpt(str(llava))
    root = tmp_path / "images" / synth_dir["name"]
    root.mkdir(parents=True)
    for i, (h, w) in enumerate([(8, 8), (16, 8), (16, 24), (8, 32), (20, 20), (16, 48)]):
        _jpeg(root / f"i{i}.jpg", h, w, i)
    vroot = tmp_path / "videos" / synth_dir["name"] / "i1"
    vroot.mkdir(parents=True)
    for t in range(4):
        _jpeg(vroot / f"f{t}.png", 20, 24, 10 + t)
    base = dict(data_path=synth_dir["data_path"], dataset=synth_dir["name"],
                text_path=synth_dir["text_path"], item_pretrain_dir=str(q),
                image_dir=str(tmp_path / "images"), MAX_ITEM_LIST_LENGTH=4,
                MAX_TEXT_LENGTH=40, tag_version="v1", eval_pred_len=2, pred_len=2)
    yamls = ["overall/LLM.yaml", "HLLM/HLLM.yaml"]
    cases = {
        "static": dict(use_image=True, img_height=16, img_width=16),
        "smart": dict(use_image=True, dynamic_image_res=True, image_min_pixels=64,
                      image_max_pixels=384),
        "anyres": dict(use_image=True, dynamic_image_res=True, item_pretrain_dir=str(llava),
                       image_grid_pinpoints=[[32, 16], [16, 32]], img_height=16, img_width=16,
                       MAX_TEXT_LENGTH=64),
        "video": dict(use_video=True, video_nframes=4, img_height=16, img_width=16,
                      video_dir=str(tmp_path / "videos")),
    }
    for name, over in cases.items():
        d = dict(base, **over)
        jcfg = JaxConfig(config_file_list=yamls, config_dict=d).finalize()
        tcfg = Config(config_file_list=yamls, config_dict=d).finalize()
        data = JaxData(jcfg).build()
        tokens = list(data.id2token["item_id"])
        ids = [0] + [tokens.index(f"i{i}") for i in range(6)] + [tokens.index("i100")]
        if name == "video":
            ours, ref = tdv.ItemVideoStore(tcfg, data), jdv.ItemVideoStore(jcfg, data)
            _same(ours.batch(ids), ref.batch(ids))
            continue
        ours, ref = tdv.ItemImageStore(tcfg, data), jdv.ItemImageStore(jcfg, data)
        if name == "static":
            _same(ours.batch(ids), ref.batch(ids))
            _same(ours.batch(ids[::-1]), ref.batch(ids[::-1]))  # through the LRU
            continue
        assert [ours.n_tokens(i) for i in ids] == [ref.n_tokens(i) for i in ids]
        T = d["MAX_TEXT_LENGTH"] + 1
        got = tts.dynamic_image_arrays(np.asarray(ids), ours, T)
        want = jts.dynamic_image_arrays(np.asarray(ids), None, ref, T)
        assert set(got) == set(want), name
        for key in want:
            _same(got[key], want[key])


# -- rotary tables ----------------------------------------------------------------
@pytest.mark.parametrize("grid", [(4, 4, 2, 8), (6, 8, 2, 16), (3, 6, 3, 8)])
def test_vision_rotary_tables_match_jax(grid):
    gh, gw, m, dh = grid
    for a, b in zip(tvis.vision_rotary_tables(gh, gw, m, dh),
                    jvis.vision_rotary_tables(gh, gw, m, dh)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ROPE_TOL)
    hw = np.random.default_rng(0).integers(0, 40, size=(3, 10, 2)).astype(np.int32)
    for a, b in zip(tvis.vision_rotary_from_hw(torch.from_numpy(hw), dh),
                    jvis.vision_rotary_from_hw(jnp.asarray(hw), dh)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ROPE_TOL)


@pytest.mark.parametrize("section,theta", [((2, 1, 1), 1e4), ((16, 24, 24), 1e6),
                                           ((4, 2, 2), 5e5)])
def test_mrope_matches_jax(section, theta):
    dh = 2 * sum(section)
    pos = np.random.default_rng(1).integers(0, 300, size=(3, 2, 7)).astype(np.int32)
    for a, b in zip(tllama.mrope_rotary_embedding(torch.from_numpy(pos), dh, theta, section),
                    jllama.mrope_rotary_embedding(jnp.asarray(pos), dh, theta, section)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ROPE_TOL)
    # text-only positions (t = h = w): M-RoPE is the 1-D rotary embedding
    flat = np.broadcast_to(np.arange(7)[None], (2, 7))
    c3, s3 = tllama.mrope_rotary_embedding(torch.from_numpy(np.stack([flat] * 3)), dh, theta,
                                           section)
    c1, s1 = tllama.rotary_embedding(torch.from_numpy(np.ascontiguousarray(flat)), dh, theta)
    np.testing.assert_allclose(c3.numpy(), c1.numpy(), rtol=0, atol=ROPE_TOL)
    np.testing.assert_allclose(s3.numpy(), s1.numpy(), rtol=0, atol=ROPE_TOL)


@pytest.mark.parametrize("grid", [(1, 4, 6), (1, 8, 4), (2, 4, 4)], ids=["4x6", "8x4", "video"])
def test_mrope_positions_match_transformers(grid, tmp_path):
    """The item layout's M-RoPE positions ([vision_start][pads][vision_end]
    [text]: ``HLLM._image_mrope_positions`` on a static grid or a video, and
    ``dynamic_image_arrays``' per-item ``img_pos`` on the same grid) equal
    ``transformers``' Qwen2-VL ``get_rope_index`` exactly."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.qwen2_vl.modeling_qwen2_vl import Qwen2VLModel

    from mhrec_tpu_torch.data.textset import dynamic_image_arrays
    from mhrec_tpu_torch.models.hllm.hllm import HLLM
    from mhrec_tpu_torch.models.llm.config import LLMConfig

    gt, gh, gw = grid
    hf = Qwen2VLModel(transformers.Qwen2VLConfig(
        vocab_size=200, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=4, num_key_value_heads=2, vision_start_token_id=150,
        vision_end_token_id=151, image_token_id=152, video_token_id=153,
        rope_scaling={"type": "mrope", "mrope_section": [2, 1, 1]},
        vision_config=dict(depth=1, embed_dim=16, num_heads=4, mlp_ratio=2, patch_size=4,
                           spatial_merge_size=2, temporal_patch_size=2, hidden_size=32)))
    n, T = gt * gh * gw // 4, 40
    ids = torch.tensor([[150] + [152 if gt == 1 else 153] * n + [151] + [5] * (T - n - 2)])
    thw = torch.tensor([[gt, gh, gw]])
    want, _ = hf.get_rope_index(ids, attention_mask=torch.ones_like(ids),
                                **({"image_grid_thw": thw} if gt == 1 else {"video_grid_thw": thw}))
    want = want[:, 0].numpy()
    vcfg = tvis.VisionConfig.tiny(hidden_size=64)
    model = HLLM(LLMConfig.tiny(), LLMConfig.tiny(), max_seq_length=4, pred_len=1,
                 use_image=True, vision_config=vcfg, img_grid=(gh, gw), vid_grid_t=gt)
    np.testing.assert_array_equal(model._image_mrope_positions(T), want)
    if gt == 1:  # the dynamic path's host positions for an image of that grid
        dyn = tdv.DynamicImagePreprocessor(patch_size=4, temporal_patch_size=2,
                                           spatial_merge_size=2)
        hw = np.zeros((1, dyn.patch_cap, 2), np.int32)
        hw[0, :gh * gw] = dyn._positions(gh, gw)

        class Store:
            dyn_kind = "smart"

            def __init__(self):
                self.dyn = dyn

            def dynamic_batch(self, ids):
                return {"hw": hw, "n_tokens": np.asarray([n], np.int32)}

        got = dynamic_image_arrays([1], Store(), T)["img_pos"][0]
        np.testing.assert_array_equal(got, want)


# -- towers -----------------------------------------------------------------------
def _port_config(jcfg):
    return tvis.VisionConfig(**dataclasses.asdict(jcfg))


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max() / np.abs(ref).max())
    assert err <= tol, err


@pytest.mark.parametrize("case,dtype", [("static", "float32"), ("video", "float32"),
                                        ("dynamic", "float32"), ("static", "bfloat16")])
def test_vision_tower_matches_jax(case, dtype):
    """The Qwen2-VL tower on a 4×4 grid: static, video (grid_t 2: tiled
    rotary tables, block-diagonal attention) and dynamic (per-image (h, w)
    positions and a key mask over padded patches) in float32; static in
    bfloat16."""
    jcfg = jvis.VisionConfig.tiny(hidden_size=48)
    gt = 2 if case == "video" else 1
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, gt * 16, jcfg.patch_dim)).astype(np.float32)
    tower = jvis.VisionTower(jcfg, grid_h=4, grid_w=4, dtype=jdt, grid_t=gt)
    args, targs = [jnp.asarray(x)], [torch.from_numpy(x)]
    if case == "dynamic":
        valid = np.ones((3, 16), bool)
        valid[0, 8:] = False
        valid[2, 4:] = False
        hw = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1).reshape(16, 2)
        hw = np.broadcast_to(hw, (3, 16, 2)).astype(np.int32) * valid[..., None]
        args += [jnp.asarray(valid), jnp.asarray(hw)]
        targs += [torch.from_numpy(valid), torch.from_numpy(np.ascontiguousarray(hw))]
    params = tower.init(jax.random.PRNGKey(0), *args)["params"]
    ref = tower.apply({"params": params}, *args)
    ours = tvis.VisionTower(_port_config(jcfg), 4, 4, dtype=tdt, grid_t=gt)
    ours.load_state_dict(vision_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = ours(*targs)
    assert out.shape == (3, gt * 4, 48) and out.dtype == tdt
    _close(out, ref, F32_TOL if dtype == "float32" else BF16_TOL)


CLIP_CASES = ("plain", "anyres", "dynamic")


@pytest.mark.parametrize("case", CLIP_CASES)
def test_clip_tower_matches_jax(case):
    """The CLIP / LLaVA tower: plain (class token, pre-LN, the penultimate
    layer, the exact-GELU projector), fixed AnyRes (base crop, 2×2 grid,
    image_newline per row) and dynamic AnyRes (the ``tok_src`` gather)."""
    jcfg = jvis.VisionConfig(arch="clip", embed_dim=16, depth=3, num_heads=2,
                             intermediate_size=32, patch_size=4, temporal_patch_size=1,
                             spatial_merge_size=1, hidden_size=24, hidden_act="gelu",
                             layer_norm_eps=1e-5, n_positions=10)
    if case != "plain":
        jcfg = dataclasses.replace(jcfg, anyres_grid=(2, 2), dynamic_anyres=case == "dynamic")
    rng = np.random.default_rng(4)
    shape = (3, 4, jcfg.patch_dim) if case == "plain" else (3, 5, 4, jcfg.patch_dim)
    x = rng.normal(size=shape).astype(np.float32)
    args, kw, tkw = [jnp.asarray(x)], {}, {}
    if case == "dynamic":
        tok = rng.integers(-1, 21, size=(3, 30)).astype(np.int32)
        kw, tkw = {"tok_src": jnp.asarray(tok)}, {"tok_src": torch.from_numpy(tok)}
    tower = jvis.ClipVisionTower(jcfg, grid_h=2, grid_w=2, dtype=jnp.float32)
    params = tower.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    ref = tower.apply({"params": params}, *args, **kw)
    ours = tvis.ClipVisionTower(_port_config(jcfg), 2, 2, dtype=torch.float32)
    ours.load_state_dict(vision_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = ours(torch.from_numpy(x), **tkw)
    _close(out, ref, F32_TOL)


def test_towers_init_from_the_flax_families():
    """A port tower's own random initialisation: flax's families (lecun
    normal kernels, zero biases, unit LayerNorms) and finite outputs."""
    cfg = tvis.VisionConfig.tiny(hidden_size=48)
    tower = tvis.VisionTower(cfg, 4, 4, dtype=torch.float32)
    tower.init_parameters(torch.Generator().manual_seed(0))
    w = tower.blocks[0].fc1.weight.detach()
    assert abs(float(w.std()) * cfg.embed_dim ** 0.5 - 1.0) < 0.15
    assert not tower.blocks[0].fc1.bias.any() and bool((tower.ln_q.weight == 1).all())
    with torch.no_grad():
        out = tower(torch.randn(2, 16, cfg.patch_dim))
    assert out.shape == (2, 4, 48) and torch.isfinite(out).all()


# -- HF weight maps --------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2vl", "llava"])
def test_weight_maps_match_jax(tmp_path, arch):
    """The HF checkpoint's vision weights through the port's loader and map
    equal the JAX package's map carried through ``convert.py``; the configs
    parse alike."""
    from mhrec_tpu.models.llm.loader import _load_state_dict
    from mhrec_tpu_torch.models.llm import loader

    d = str(tmp_path / arch)
    (_write_tiny_qwen2vl_ckpt if arch == "qwen2vl" else _write_tiny_llava_ckpt)(d)
    jcfg = jvis.VisionConfig.from_pretrained_dir(d)
    tcfg = tvis.VisionConfig.from_pretrained_dir(d)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if arch == "llava":  # the AnyRes newline row: the JAX package's fresh draw
        jcfg = dataclasses.replace(jcfg, anyres_grid=(2, 2))
        tcfg = dataclasses.replace(tcfg, anyres_grid=(2, 2))
    jsd = _load_state_dict(d)
    want = vision_state_dict_from_flax(jvis.load_any_vision_params(jsd, jcfg))
    sd = loader.load_state_dict(d)
    assert tvis.has_vision_weights(sd) and jvis.has_vision_weights(jsd)
    got = tvis.load_any_vision_params(sd, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].numpy(), err_msg=k)


def test_load_pretrained_towers_loads_the_vision_tower(synth_dir, tmp_path):
    """``load_pretrained_towers`` with a Qwen2-VL item checkpoint: the
    ``visual.*`` branch fills the port's vision tower bit for bit."""
    from mhrec_tpu_torch.config import Config
    from mhrec_tpu_torch.data import InteractionData
    from mhrec_tpu_torch.models.llm import loader
    from mhrec_tpu_torch.trainer import Trainer

    d = str(tmp_path / "qwen2vl")
    _write_tiny_qwen2vl_ckpt(d)
    cfg = Config(config_file_list=["overall/LLM.yaml", "HLLM/HLLM.yaml"], config_dict=dict(
        data_path=synth_dir["data_path"], dataset=synth_dir["name"],
        text_path=synth_dir["text_path"], item_pretrain_dir=d, user_pretrain_dir=d,
        use_image=True, img_height=16, img_width=16, MAX_ITEM_LIST_LENGTH=4,
        MAX_TEXT_LENGTH=16, tag_version="v1", eval_pred_len=2, pred_len=2,
        packed_item_tower=False, token_cache_dir=False,
        checkpoint_dir=str(tmp_path / "ckpt"))).finalize()
    t = Trainer(cfg, InteractionData(cfg).build(), device="cpu")
    t.setup_model()
    assert set(t.model.tower_load_stats) == {"item_llm", "user_llm", "visual"}
    want = tvis.load_vision_params(loader.load_state_dict(d), t.model.visual.config)
    for name, p in t.model.visual.named_parameters():
        assert torch.equal(p.detach(), want[name].float()), name
    with open(os.path.join(d, "config.json")) as fh:
        assert json.load(fh)["vision_config"]["depth"] == len(t.model.visual.blocks)
