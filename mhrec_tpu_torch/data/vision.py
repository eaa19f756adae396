"""Host-side image and video loading and patch extraction for the HLLM
vision item towers (a copy of ``mhrec_tpu/data/vision.py``: numpy and PIL,
PIL imported inside the functions that decode).

Images are resized to the configured ``img_height × img_width`` (the
reference passes ``resized_height/width`` to the Qwen processor,
trainset.py:133-136), normalized with the CLIP mean/std, and flattened into
Qwen2-VL patch vectors ``[n_patches, C·tps·ps²]`` in the HF image
processor's order — channel-major per patch, the frame duplicated over the
temporal patch, 2×2 spatial-merge blocks row-major — so pretrained
``visual.patch_embed`` weights and the PatchMerger apply unchanged. The
resolution is fixed per run, so every item yields the same patch count,
unless ``dynamic_image_res`` asks for per-image smart-resize grids
(``DynamicImagePreprocessor``) or LLaVA AnyRes pinpoints
(``AnyResPreprocessor``), which resolve every shape-dependent choice on the
host into fixed-capacity arrays. Items without an image, or with a file
that does not decode, take a black image (reference trainset.py:441-442).
Video: ``smart_nframes``, ``fetch_video`` (frame lists through PIL; a video
file needs torchvision or decord, imported inside the function, and raises
loudly without either), ``patchify_video`` and ``VideoPreprocessor``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

OPENAI_CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


class ImagePreprocessor:
    def __init__(self, img_height: int, img_width: int, patch_size: int = 14,
                 temporal_patch_size: int = 2, spatial_merge_size: int = 2,
                 anyres_grid: Optional[tuple] = None):
        assert img_height % (patch_size * spatial_merge_size) == 0, (
            f"img_height={img_height} must be a multiple of "
            f"patch_size*merge={patch_size * spatial_merge_size}"
        )
        assert img_width % (patch_size * spatial_merge_size) == 0
        self.img_height = img_height
        self.img_width = img_width
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = spatial_merge_size
        self.grid_h = img_height // patch_size
        self.grid_w = img_width // patch_size
        self.n_patches = self.grid_h * self.grid_w
        self.n_tokens = self.n_patches // spatial_merge_size ** 2
        self.patch_dim = 3 * temporal_patch_size * patch_size ** 2
        # fixed-grid AnyRes (reference modeling_llava_next.py
        # get_image_patches semantics at one pinned pinpoint): one base
        # resize + gh×gw crops of a (gh·H, gw·W) resize. Crop count — and
        # hence the image-token count incl. per-row newline tokens — is a
        # fixed per run, unlike HF's per-aspect-ratio pinpoints.
        self.anyres_grid = tuple(anyres_grid) if anyres_grid else None
        if self.anyres_grid:
            assert spatial_merge_size == 1 and temporal_patch_size == 1, (
                "anyres_grid requires a CLIP-arch tower (merge=1, tps=1)"
            )
            gh, gw = self.anyres_grid
            self.n_crops = 1 + gh * gw
            self.n_tokens = self.n_patches + (gh * self.grid_h) * (
                gw * self.grid_w + 1
            )
        else:
            self.n_crops = 1
        self._black = self._multiply_crops(
            np.broadcast_to(
                ((0.0 - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD)[:, None, None],
                (3, img_height, img_width),
            ).astype(np.float32)
        )

    def _multiply_crops(self, chw: np.ndarray) -> np.ndarray:
        """Uniform-color helper: all crops of a constant image are equal."""
        base = self._patchify(np.ascontiguousarray(chw))
        if not self.anyres_grid:
            return base
        return np.broadcast_to(
            base[None], (self.n_crops, self.n_patches, self.patch_dim)
        ).copy()

    def _patchify(self, chw: np.ndarray) -> np.ndarray:
        """[3, H, W] normalized → [n_patches, patch_dim], HF Qwen2-VL order."""
        ps, m, tps = self.patch_size, self.merge_size, self.temporal_patch_size
        gh, gw = self.grid_h, self.grid_w
        # duplicate the frame across the temporal patch (HF does the same
        # for still images), then block into merge-groups of patches
        x = np.broadcast_to(chw[None], (tps, 3, self.img_height, self.img_width))
        x = x.reshape(1, tps, 3, gh // m, m, ps, gw // m, m, ps)
        x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        return np.ascontiguousarray(x.reshape(self.n_patches, self.patch_dim))

    def _norm_chw(self, img, w: int, h: int) -> np.ndarray:
        arr = np.asarray(img.resize((w, h)), np.float32) / 255.0  # [H, W, 3]
        arr = (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
        return np.ascontiguousarray(arr.transpose(2, 0, 1))

    def preprocess(self, image) -> np.ndarray:
        """PIL image → [n_patches, patch_dim] float32 ([n_crops, P, dim]
        under anyres_grid: base crop first, then grid crops row-major —
        reference modeling_llava_next.py image_feature[0] = base)."""
        img = image.convert("RGB")
        base = self._patchify(self._norm_chw(img, self.img_width, self.img_height))
        if not self.anyres_grid:
            return base
        gh, gw = self.anyres_grid
        H, W = self.img_height, self.img_width
        hi = self._norm_chw(img, gw * W, gh * H)            # [3, gh·H, gw·W]
        crops = [base]
        for r in range(gh):                                 # HF divide_to_patches order
            for c in range(gw):
                crops.append(self._patchify(np.ascontiguousarray(
                    hi[:, r * H:(r + 1) * H, c * W:(c + 1) * W]
                )))
        return np.stack(crops, axis=0)

    def load(self, path: Optional[str]) -> np.ndarray:
        """Path (or None) → patches; black image on missing/broken files."""
        if not path or not os.path.isfile(path):
            return self._black
        try:
            from PIL import Image

            with Image.open(path) as img:
                return self.preprocess(img)
        except Exception:
            return self._black

    def batch(self, paths: Sequence[Optional[str]], workers: int = 16) -> np.ndarray:
        """Decode+patchify a batch. Pillow releases the GIL during JPEG
        decode/resize, so a thread pool keeps the host path off the train
        step's critical path (the reference uses 8 DataLoader workers)."""
        out = np.empty((len(paths),) + self._black.shape, np.float32)
        real = [(i, p) for i, p in enumerate(paths) if p]
        for i, p in enumerate(paths):
            if not p:
                out[i] = self._black
        if real:
            if len(real) > 4 and workers > 1:
                from concurrent.futures import ThreadPoolExecutor

                if not hasattr(self, "_pool"):
                    self._pool = ThreadPoolExecutor(max_workers=workers)
                for (i, _), patches in zip(
                    real, self._pool.map(self.load, [p for _, p in real])
                ):
                    out[i] = patches
            else:
                for i, p in real:
                    out[i] = self.load(p)
        return out


# ---------------------------------------------------------------------------
# Video inputs (reference qwen_vl_utils.py:29-35, 132-303)
#
# No reference protocol/dataset ever feeds a video (the datasets render item
# text + still images); like the reference, these are the preprocessing
# utilities the Qwen-VL chat path exposes: frame-count selection, video
# fetching (frame lists decode-free; files need torchvision/decord), and the
# [T, C, H, W] → Qwen2-VL patch flattening with real temporal pairs.
# ---------------------------------------------------------------------------
FRAME_FACTOR = 2
VIDEO_FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768
VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28


def _round_by_factor(n, f):
    return round(n / f) * f


def _ceil_by_factor(n, f):
    import math

    return math.ceil(n / f) * f


def _floor_by_factor(n, f):
    import math

    return math.floor(n / f) * f


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Frame count for model input (reference qwen_vl_utils.py:132-166):
    either an explicit ``nframes`` (rounded to FRAME_FACTOR) or derived from
    ``fps`` (default 2.0) clamped to [min_frames, max_frames]."""
    assert not ("fps" in ele and "nframes" in ele), (
        "Only accept either `fps` or `nframes`"
    )
    if "nframes" in ele:
        nframes = _round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", VIDEO_FPS)
        min_frames = _ceil_by_factor(
            ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = _floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_frames), max_frames)
        nframes = _round_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], "
            f"but got {nframes}."
        )
    return int(nframes)


def fetch_video(ele: dict, image_factor: int = 28):
    """Reference qwen_vl_utils.py:260-303.

    ``ele['video']`` as a list/tuple of frames (paths or PIL images):
    each frame is smart-resized like a still image and the list is padded
    to a FRAME_FACTOR multiple by repeating the last frame — returns a list
    of PIL images. As a path string: decoded via torchvision.io / decord
    when importable (without either it raises ImportError, as the
    reference does without its optional readers), frames selected by
    ``smart_nframes`` at uniform spacing, bicubic-resized to the
    video-budget smart_resize target — returns float32 [T, 3, H, W] in
    0..255 scale (the reference returns the un-normalized resized tensor).
    """
    from PIL import Image

    video = ele["video"]
    if isinstance(video, (list, tuple)):
        frames = []
        min_px = ele.get("min_pixels", 4 * 28 * 28)
        max_px = ele.get("max_pixels", 16384 * 28 * 28)
        for f in video:
            img = f if not isinstance(f, str) else Image.open(f)
            img = img.convert("RGB")
            if "resized_height" in ele and "resized_width" in ele:
                h, w = smart_resize(ele["resized_height"], ele["resized_width"],
                                    factor=image_factor)
            else:
                h, w = smart_resize(img.height, img.width, factor=image_factor,
                                    min_pixels=min_px, max_pixels=max_px)
            frames.append(img.resize((w, h), Image.Resampling.BICUBIC))
        nframes = _ceil_by_factor(len(frames), FRAME_FACTOR)
        frames.extend([frames[-1]] * (nframes - len(frames)))
        return frames

    # file path → decoder required
    frames_np = fps = None
    try:
        from torchvision import io as tv_io  # noqa: F401

        path = video[7:] if video.startswith("file://") else video
        vid, _, info = tv_io.read_video(path, pts_unit="sec",
                                        output_format="TCHW")
        frames_np, fps = vid.numpy().astype(np.float32), info["video_fps"]
    except ImportError:
        try:
            import decord

            vr = decord.VideoReader(video)
            fps = vr.get_avg_fps()
            frames_np = vr.get_batch(range(len(vr))).asnumpy()
            frames_np = frames_np.transpose(0, 3, 1, 2).astype(np.float32)
        except ImportError:
            raise ImportError(
                "decoding a video FILE needs torchvision or decord (neither "
                "installed); pass ele['video'] as a list of frame images "
                "instead"
            )
    total = frames_np.shape[0]
    nframes = smart_nframes(ele, total_frames=total, video_fps=fps)
    idx = np.linspace(0, total - 1, nframes).round().astype(int)
    frames_np = frames_np[idx]
    T, _, H, W = frames_np.shape
    min_px = ele.get("min_pixels", VIDEO_MIN_PIXELS)
    total_px = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
    max_px = ele.get("max_pixels", max(
        min(VIDEO_MAX_PIXELS, total_px / T * FRAME_FACTOR),
        int(min_px * 1.05),
    ))
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(ele["resized_height"], ele["resized_width"],
                              factor=image_factor)
    else:
        rh, rw = smart_resize(H, W, factor=image_factor,
                              min_pixels=min_px, max_pixels=max_px)
    from PIL import Image as _I

    out = np.empty((T, 3, rh, rw), np.float32)
    for t in range(T):
        img = _I.fromarray(
            frames_np[t].transpose(1, 2, 0).clip(0, 255).astype(np.uint8))
        out[t] = np.asarray(
            img.resize((rw, rh), _I.Resampling.BICUBIC), np.float32
        ).transpose(2, 0, 1)
    return out


def patchify_video(frames, patch_size: int = 14, temporal_patch_size: int = 2,
                   merge_size: int = 2):
    """[T, 3, H, W] (0..255 float / uint8, or PIL list) → Qwen2-VL video
    patches with REAL temporal pairs (the still-image path duplicates one
    frame instead, `_patchify` above).

    Returns (patches [grid_t·gh·gw, 3·tps·ps²] float32, (grid_t, gh, gw)) in
    the HF Qwen2VLImageProcessor ``_preprocess`` flattening order, so
    pretrained patch-embed weights consume it unchanged. T is padded to a
    ``temporal_patch_size`` multiple by repeating the last frame (HF does
    the same).
    """
    if isinstance(frames, (list, tuple)):
        frames = np.stack(
            [np.asarray(f, np.float32).transpose(2, 0, 1) for f in frames]
        )
    frames = np.asarray(frames, np.float32)
    frames = (frames / 255.0 - OPENAI_CLIP_MEAN[:, None, None]) / (
        OPENAI_CLIP_STD[:, None, None]
    )
    T, C, H, W = frames.shape
    ps, tps, m = patch_size, temporal_patch_size, merge_size
    assert H % (ps * m) == 0 and W % (ps * m) == 0, (H, W, ps, m)
    if T % tps:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], tps - T % tps, axis=0)], axis=0)
        T = frames.shape[0]
    grid_t, gh, gw = T // tps, H // ps, W // ps
    x = frames.reshape(grid_t, tps, C, gh // m, m, ps, gw // m, m, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = np.ascontiguousarray(
        x.reshape(grid_t * gh * gw, C * tps * ps * ps))
    return patches, (grid_t, gh, gw)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 16384 * 28 * 28):
    """Qwen2-VL dynamic-resolution target (reference qwen_vl_utils.py:53-79):
    both dims divisible by ``factor``, pixel count within
    [min_pixels, max_pixels], aspect ratio preserved as closely as possible.
    """
    import math

    if max(height, width) / max(min(height, width), 1) > 200:
        # degenerate aspect: treat like the reference's failure fallback
        height = width = max(factor, min(height, width))
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


class DynamicImagePreprocessor:
    """Per-image smart-resize grids with STATIC device shapes.

    The reference's dynamic-resolution Qwen2-VL path
    (qwen_vl_utils.py smart_resize + the varlen vision flash-attention in
    modeling_qwen2_vl.py): every host-side decision that depends on the
    image's native size — the target grid, the RoPE (h, w) position of each
    patch, which patch slots are real — is precomputed here into
    fixed-capacity arrays, so the device work keeps static shapes:

      patches  [P_cap, patch_dim]  zero-padded, whole merge-blocks only
      valid    [P_cap]             patch validity mask (vision attention mask)
      hw       [P_cap, 2]          per-patch (h, w) RoPE positions
      n_tokens                     post-merger image-token count (gh·gw/m²)

    ``P_cap = max_pixels / patch_size²`` bounds capacity; real patch counts
    vary per image underneath it.
    """

    def __init__(self, patch_size: int = 14, temporal_patch_size: int = 2,
                 spatial_merge_size: int = 2,
                 min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 256 * 28 * 28):
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = spatial_merge_size
        self.factor = patch_size * spatial_merge_size
        self.min_pixels = int(min_pixels)
        self.max_pixels = int(max_pixels)
        # capacity in whole merge blocks (the merger reshape needs it)
        self.token_cap = self.max_pixels // self.factor ** 2
        self.patch_cap = self.token_cap * spatial_merge_size ** 2
        self.patch_dim = 3 * temporal_patch_size * patch_size ** 2
        # missing/broken images fall back to a small black square
        # (reference trainset.py:441-442) at the min grid
        side = max(self.factor, int((self.min_pixels ** 0.5) // self.factor)
                   * self.factor)
        self.default_grid = (side // patch_size, side // patch_size)

    def grid_for_size(self, width: int, height: int):
        h, w = smart_resize(height, width, self.factor,
                            self.min_pixels, self.max_pixels)
        return h // self.patch_size, w // self.patch_size

    def grid_for_path(self, path: Optional[str]):
        """Image grid from the file header only (PIL lazy open)."""
        if not path or not os.path.isfile(path):
            return self.default_grid
        try:
            from PIL import Image

            with Image.open(path) as img:
                # force a full decode: a truncated file whose HEADER parses
                # would otherwise report a size here while load() falls back
                # to the default grid — a silent per-item token skew between
                # the cached text prefix and the spliced image span
                img.load()
                return self.grid_for_size(*img.size)
        except Exception:
            return self.default_grid

    def _positions(self, gh: int, gw: int) -> np.ndarray:
        """[gh·gw, 2] (h, w) positions in merge-block patch order."""
        m = self.merge_size
        shape = (gh // m, gw // m, m, m)
        hb = np.arange(gh).reshape(gh // m, 1, m, 1)
        wb = np.arange(gw).reshape(1, gw // m, 1, m)
        return np.stack([
            np.broadcast_to(hb, shape).ravel(),
            np.broadcast_to(wb, shape).ravel(),
        ], axis=-1).astype(np.int32)

    def _patchify(self, chw: np.ndarray, gh: int, gw: int) -> np.ndarray:
        ps, m, tps = self.patch_size, self.merge_size, self.temporal_patch_size
        H, W = gh * ps, gw * ps
        x = np.broadcast_to(chw[None], (tps, 3, H, W))
        x = x.reshape(1, tps, 3, gh // m, m, ps, gw // m, m, ps)
        x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        return np.ascontiguousarray(x.reshape(gh * gw, self.patch_dim))

    def load(self, path: Optional[str]):
        """→ (patches [P_cap, dim] f32, valid [P_cap] bool, hw [P_cap, 2],
        n_tokens int). Black fallback on missing/broken files."""
        gh, gw = self.default_grid
        chw = None
        if path and os.path.isfile(path):
            try:
                from PIL import Image

                with Image.open(path) as img:
                    gh, gw = self.grid_for_size(*img.size)
                    arr = np.asarray(
                        img.convert("RGB").resize(
                            (gw * self.patch_size, gh * self.patch_size)
                        ), np.float32,
                    ) / 255.0
                chw = np.ascontiguousarray(
                    ((arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD).transpose(2, 0, 1)
                )
            except Exception:
                gh, gw = self.default_grid
                chw = None
        if chw is None:
            chw = np.broadcast_to(
                ((0.0 - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD)[:, None, None],
                (3, gh * self.patch_size, gw * self.patch_size),
            ).astype(np.float32)
        n = gh * gw
        patches = np.zeros((self.patch_cap, self.patch_dim), np.float32)
        patches[:n] = self._patchify(chw, gh, gw)
        valid = np.zeros(self.patch_cap, bool)
        valid[:n] = True
        hw = np.zeros((self.patch_cap, 2), np.int32)
        hw[:n] = self._positions(gh, gw)
        return patches, valid, hw, n // self.merge_size ** 2


def select_best_resolution(orig_h: int, orig_w: int, pinpoints):
    """HF ``select_best_resolution`` semantics (reference
    modeling_llava_next.py:73,102 via transformers.image_processing_utils):
    choose the pinpoint maximizing the effective (downscale-fit) resolution,
    tie-broken by minimum wasted area. pinpoints: [(H, W), ...]."""
    best, best_eff, best_waste = None, -1, None
    for (th, tw) in pinpoints:
        scale = min(tw / orig_w, th / orig_h)
        dw, dh = int(orig_w * scale), int(orig_h * scale)
        eff = min(dw * dh, orig_w * orig_h)
        waste = th * tw - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (th, tw), eff, waste
    return best


class AnyResPreprocessor:
    """LLaVA-Next dynamic AnyRes with STATIC device shapes.

    The reference (modeling_llava_next.py get_image_patches /
    pack_image_features) picks a per-image pinpoint, resizes
    aspect-preserving + pads, crops into base-resolution tiles, and after
    the tower UNPADS the stitched feature grid and inserts a newline token
    per row — all shape-dynamic. Here every choice is made host-side into
    fixed-capacity arrays:

      crops    [C_cap, P, patch_dim]  base crop first, then tiles (padded)
      tok_src  [T_cap]                per packed image token: flat index
                                      into [C_cap·P] crop features, or
                                      NEWLINE (= C_cap·P), or -1 (unused)

    and the device side is one gather over [crops·P + 1] rows — the unpad
    is exact because pad rows simply never appear in ``tok_src``.
    """

    NEWLINE = -2  # sentinel inside build; emitted as C_cap*P in tok_src

    def __init__(self, patch_size: int, image_size: int, pinpoints):
        assert image_size % patch_size == 0
        self.patch_size = patch_size
        self.image_size = image_size                # base crop side (square)
        self.gb = image_size // patch_size          # per-crop grid side
        self.P = self.gb * self.gb
        self.patch_dim = 3 * patch_size ** 2
        self.pinpoints = [(int(h), int(w)) for h, w in pinpoints]
        for (th, tw) in self.pinpoints:
            assert th % image_size == 0 and tw % image_size == 0, (
                "pinpoints must be multiples of the base image_size"
            )
        self.c_cap = 1 + max(
            (th // image_size) * (tw // image_size) for th, tw in self.pinpoints
        )
        self.token_cap = self.P + max(
            (th // patch_size) * (tw // patch_size + 1)
            for th, tw in self.pinpoints
        )

    def _patchify(self, chw: np.ndarray) -> np.ndarray:
        ps, g = self.patch_size, self.gb
        x = chw.reshape(3, g, ps, g, ps)
        return np.ascontiguousarray(
            x.transpose(1, 3, 0, 2, 4).reshape(self.P, self.patch_dim)
        )

    def _norm(self, img, w, h):
        arr = np.asarray(img.resize((w, h)), np.float32) / 255.0
        arr = (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
        return np.ascontiguousarray(arr.transpose(2, 0, 1))

    def _unpad_ranges(self, oh, ow, gh, gw):
        """Kept (row, col) ranges of the stitched feature grid — HF
        ``unpad_image`` in feature units."""
        ch, cw = gh * self.gb, gw * self.gb
        if ow / oh > cw / ch:        # original wider → rows were padded
            new_h = int(round(oh * cw / ow))
            prow = (ch - new_h) // 2
            return range(prow, ch - prow), range(cw)
        new_w = int(round(ow * ch / oh))
        pcol = (cw - new_w) // 2
        return range(ch), range(pcol, cw - pcol)

    def count_for_size(self, oh: int, ow: int) -> int:
        """Image-token count from the header size alone (for the text
        cache's per-item span, no pixel decode)."""
        th, tw = select_best_resolution(oh, ow, self.pinpoints)
        rows, cols = self._unpad_ranges(oh, ow, th // self.image_size,
                                        tw // self.image_size)
        return self.P + len(rows) * (len(cols) + 1)

    def load(self, path: Optional[str]):
        """→ (crops [C_cap, P, dim], tok_src [T_cap], n_tokens)."""
        crops = np.zeros((self.c_cap, self.P, self.patch_dim), np.float32)
        tok_src = np.full(self.token_cap, -1, np.int32)
        S = self.image_size
        black = np.broadcast_to(
            ((0.0 - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD)[:, None, None],
            (3, S, S),
        ).astype(np.float32)
        img = None
        if path and os.path.isfile(path):
            try:
                from PIL import Image

                img = Image.open(path).convert("RGB")
            except Exception:
                img = None
        if img is None:
            # missing: base crop only (black), no grid tokens
            crops[0] = self._patchify(black)
            tok_src[: self.P] = np.arange(self.P)
            return crops, tok_src, self.P
        ow, oh = img.size
        th, tw = select_best_resolution(oh, ow, self.pinpoints)
        gh, gw = th // S, tw // S
        # aspect-preserving resize + centered pad (HF resize_and_pad)
        scale = min(tw / ow, th / oh)
        nw, nh = max(1, int(ow * scale)), max(1, int(oh * scale))
        pad_t, pad_l = (th - nh) // 2, (tw - nw) // 2
        canvas = np.broadcast_to(
            ((0.0 - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD)[:, None, None],
            (3, th, tw),
        ).astype(np.float32).copy()
        canvas[:, pad_t:pad_t + nh, pad_l:pad_l + nw] = self._norm(img, nw, nh)
        crops[0] = self._patchify(self._norm(img, S, S))     # base crop
        ci = 1
        for r in range(gh):
            for c in range(gw):
                crops[ci] = self._patchify(
                    np.ascontiguousarray(
                        canvas[:, r * S:(r + 1) * S, c * S:(c + 1) * S]
                    )
                )
                ci += 1
        # token map: base first, then the UNPADDED stitched grid with one
        # newline per kept row (reference unpad_image + pack_image_features)
        rows, cols = self._unpad_ranges(oh, ow, gh, gw)
        tok_src[: self.P] = np.arange(self.P)
        j = self.P
        newline = self.c_cap * self.P
        for r in rows:
            for c in cols:
                crop = 1 + (r // self.gb) * gw + (c // self.gb)
                pos = (r % self.gb) * self.gb + (c % self.gb)
                tok_src[j] = crop * self.P + pos
                j += 1
            tok_src[j] = newline
            j += 1
        return crops, tok_src, j


def resolve_patch_geometry(config):
    """(patch_size, temporal_patch_size, merge) — must match the model-side
    VisionConfig (from the item checkpoint dir, else the tiny default)."""
    from mhrec_tpu_torch.models.llm.vision import VisionConfig

    item_dir = config.get("item_pretrain_dir")
    v = None
    if item_dir and os.path.isdir(str(item_dir)):
        try:
            v = VisionConfig.from_pretrained_dir(str(item_dir))
        except Exception:
            v = None
    if v is None:
        v = VisionConfig.tiny()
    return v.patch_size, v.temporal_patch_size, v.spatial_merge_size


class ItemImageStore:
    """item internal id → image path (reference dataload.py:213-218:
    ``{image_dir}/{dataset}/{item_token}.jpg``, missing → None)."""

    def __init__(self, config, dataload):
        ps, tps, merge = resolve_patch_geometry(config)
        anyres = config.get("anyres_grid") or None
        self.dynamic = bool(config.get("dynamic_image_res", False))
        self.dyn_kind = None
        if self.dynamic:
            self._grids: Dict[int, tuple] = {}
            pinpoints = config.get("image_grid_pinpoints")
            if tps == 1 and merge == 1:
                # CLIP/SigLIP tower → LLaVA-Next dynamic AnyRes
                self.dyn_kind = "anyres"
                S = int(config.get("img_height", 224))
                if not pinpoints:  # HF llava-1.6 default shape set, scaled
                    pinpoints = [(2 * S, S), (S, 2 * S), (2 * S, 2 * S),
                                 (3 * S, S), (S, 3 * S)]
                self.dyn = AnyResPreprocessor(
                    patch_size=ps, image_size=S, pinpoints=pinpoints,
                )
                T = int(config.get("MAX_TEXT_LENGTH", 64))
                assert self.dyn.token_cap + 2 < T, (
                    f"MAX_TEXT_LENGTH={T} too small for the AnyRes token "
                    f"capacity {self.dyn.token_cap}; raise it or shrink the "
                    f"pinpoints/img_height"
                )
            else:
                self.dyn_kind = "smart"
                # image-token capacity must leave text room: cap max_pixels
                # so the largest span (+2 delimiters) fits MAX_TEXT_LENGTH
                T = int(config.get("MAX_TEXT_LENGTH", 64))
                budget_px = max(1, (T - 8)) * (ps * merge) ** 2
                min_px = int(config.get("image_min_pixels", 4 * 28 * 28))
                max_px = min(
                    int(config.get("image_max_pixels", 256 * 28 * 28)),
                    budget_px,
                )
                # a MAX_TEXT_LENGTH budget below min_pixels would make
                # smart_resize emit grids past patch_cap and crash at
                # data-loading time with a shape error.
                # ValueError, not assert: config validation must survive
                # `python -O`
                if min_px > max_px:
                    raise ValueError(
                        f"MAX_TEXT_LENGTH={T} leaves an image budget of "
                        f"{max_px} px < image_min_pixels={min_px}; raise "
                        f"MAX_TEXT_LENGTH or lower image_min_pixels"
                    )
                self.dyn = DynamicImagePreprocessor(
                    patch_size=ps, temporal_patch_size=tps,
                    spatial_merge_size=merge,
                    min_pixels=min_px,
                    max_pixels=max_px,
                )
        self.prep = ImagePreprocessor(
            int(config.get("img_height", 224)), int(config.get("img_width", 224)),
            patch_size=ps, temporal_patch_size=tps, spatial_merge_size=merge,
            anyres_grid=tuple(int(x) for x in anyres) if anyres else None,
        )
        image_dir = config.get("image_dir") or ""
        dataset = config["dataset"]
        self.root = os.path.join(str(image_dir), str(dataset)) if image_dir else ""
        self.id2token = dataload.id2token["item_id"]
        self._paths: Dict[int, Optional[str]] = {}
        # use_image_online: the item parquet carries a per-item ``image``
        # path column (reference dataload.py:205); takes precedence over the
        # derived {image_dir}/{dataset}/{token}.jpg layout
        self._online_paths: Dict[int, str] = {}
        if config.get("use_image_online"):
            item_text = getattr(dataload, "item_text", None)
            if item_text is not None and "image" in getattr(item_text, "columns", ()):
                self._online_paths = {
                    int(i): str(p)
                    for i, p in zip(
                        item_text["int_item_id"].to_numpy(), item_text["image"]
                    )
                    if p
                }
        # bounded LRU of preprocessed patches: training batches revisit
        # popular items constantly; 2048 entries ≈ 2.5 GB at 224²/14
        self._cache_cap = int(config.get("image_cache_items", 2048))
        from collections import OrderedDict

        self._patch_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def path(self, item_id: int) -> Optional[str]:
        if item_id in self._paths:
            return self._paths[item_id]
        p = None
        if item_id > 0 and item_id in self._online_paths:
            cand = self._online_paths[item_id]
            p = cand if os.path.isfile(cand) else None
        elif self.root and item_id > 0:
            cand = os.path.join(self.root, f"{self.id2token[item_id]}.jpg")
            p = cand if os.path.isfile(cand) else None
        self._paths[item_id] = p
        return p

    def n_tokens(self, item_id: int) -> int:
        """Dynamic mode: image-token count for this item (from the file
        header only; cached)."""
        n = self._grids.get(item_id)
        if n is not None:
            return n
        path = self.path(int(item_id))
        if self.dyn_kind == "anyres":
            n = self.dyn.P  # missing-image fallback: base crop only
            if path:
                try:
                    from PIL import Image

                    with Image.open(path) as img:
                        img.load()  # decode — header-only size can lie for
                        # truncated files while load() falls back
                        ow, oh = img.size
                    n = self.dyn.count_for_size(oh, ow)
                except Exception:
                    pass
        else:
            g = self.dyn.grid_for_path(path)
            n = (g[0] * g[1]) // self.dyn.merge_size ** 2
        self._grids[item_id] = n
        return n

    def _dyn_load_cached(self, iid: int):
        hit = self._patch_cache.get(iid)
        if hit is None:
            hit = self.dyn.load(self.path(iid))
            self._patch_cache[iid] = hit
            if len(self._patch_cache) > self._cache_cap:
                self._patch_cache.popitem(last=False)
        else:
            self._patch_cache.move_to_end(iid)
        return hit

    def dynamic_batch(self, item_ids) -> Dict[str, np.ndarray]:
        """Dynamic mode: → dict of fixed-capacity arrays (see
        DynamicImagePreprocessor.load / AnyResPreprocessor.load). Cached
        per item like ``batch``."""
        ids = [int(i) for i in item_ids]
        N = len(ids)
        if self.dyn_kind == "anyres":
            d = self.dyn
            crops = np.zeros((N, d.c_cap, d.P, d.patch_dim), np.float32)
            tok_src = np.full((N, d.token_cap), -1, np.int32)
            ntok = np.zeros(N, np.int32)
            for row, iid in enumerate(ids):
                crops[row], tok_src[row], ntok[row] = self._dyn_load_cached(iid)
            return {"patches": crops, "tok_src": tok_src, "n_tokens": ntok}
        P = self.dyn.patch_cap
        patches = np.zeros((N, P, self.dyn.patch_dim), np.float32)
        valid = np.zeros((N, P), bool)
        hw = np.zeros((N, P, 2), np.int32)
        ntok = np.zeros(N, np.int32)
        for row, iid in enumerate(ids):
            patches[row], valid[row], hw[row], ntok[row] = \
                self._dyn_load_cached(iid)
        return {"patches": patches, "valid": valid, "hw": hw, "n_tokens": ntok}

    def batch(self, item_ids) -> np.ndarray:
        ids = [int(i) for i in item_ids]
        out = np.empty((len(ids),) + self.prep._black.shape, np.float32)
        missing = []
        for row, iid in enumerate(ids):
            hit = self._patch_cache.get(iid)
            if hit is not None:
                self._patch_cache.move_to_end(iid)
                out[row] = hit
            else:
                missing.append((row, iid))
        if missing:
            patches = self.prep.batch([self.path(i) for _, i in missing])
            for k, (row, iid) in enumerate(missing):
                out[row] = patches[k]
                self._patch_cache[iid] = patches[k]
                if len(self._patch_cache) > self._cache_cap:
                    self._patch_cache.popitem(last=False)
        return out


class VideoPreprocessor:
    """Static-shape video preprocessor: every item video becomes EXACTLY
    ``nframes`` frames at a fixed ``img_height × img_width`` resize →
    ``[grid_t·gh·gw, 3·tps·ps²]`` Qwen2-VL patches with real temporal pairs
    (``patchify_video`` order — pretrained patch-embed weights consume it
    unchanged). Static shapes, like the still-image ``ImagePreprocessor``."""

    def __init__(self, img_height: int, img_width: int, nframes: int,
                 patch_size: int = 14, temporal_patch_size: int = 2,
                 spatial_merge_size: int = 2):
        assert img_height % (patch_size * spatial_merge_size) == 0
        assert img_width % (patch_size * spatial_merge_size) == 0
        assert nframes % temporal_patch_size == 0, (
            f"video_nframes={nframes} must be a multiple of "
            f"temporal_patch_size={temporal_patch_size}"
        )
        self.img_height = img_height
        self.img_width = img_width
        self.nframes = nframes
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = spatial_merge_size
        self.grid_t = nframes // temporal_patch_size
        self.grid_h = img_height // patch_size
        self.grid_w = img_width // patch_size
        self.n_patches = self.grid_t * self.grid_h * self.grid_w
        self.n_tokens = self.n_patches // spatial_merge_size ** 2
        self.patch_dim = 3 * temporal_patch_size * patch_size ** 2
        black = np.broadcast_to(
            np.zeros(3, np.float32)[:, None, None],
            (3, img_height, img_width),
        ).astype(np.float32)
        self._black, _ = patchify_video(
            np.broadcast_to(black[None], (nframes, 3, img_height, img_width)),
            patch_size, temporal_patch_size, spatial_merge_size,
        )

    def _resample(self, frames):
        """Uniformly select exactly ``nframes`` frames from a list."""
        if len(frames) == self.nframes:
            return list(frames)
        idx = np.linspace(0, len(frames) - 1, self.nframes).round().astype(int)
        return [frames[i] for i in idx]

    def _exact_resize(self, frames) -> np.ndarray:
        """frame list (paths / PIL / [C,H,W] arrays) → float32
        [nframes, 3, img_height, img_width] in 0..255 scale, resized to the
        EXACT static target (``fetch_video``'s smart_resize branch enforces
        its pixel minimums, which a tiny static grid must override)."""
        from PIL import Image

        out = np.empty(
            (self.nframes, 3, self.img_height, self.img_width), np.float32
        )
        for t, f in enumerate(self._resample(list(frames))):
            if isinstance(f, str):
                img = Image.open(f).convert("RGB")
            elif isinstance(f, np.ndarray):
                img = Image.fromarray(
                    f.transpose(1, 2, 0).clip(0, 255).astype(np.uint8))
            else:
                img = f.convert("RGB")
            img = img.resize(
                (self.img_width, self.img_height), Image.Resampling.BICUBIC
            )
            out[t] = np.asarray(img, np.float32).transpose(2, 0, 1)
        return out

    def preprocess(self, source) -> np.ndarray:
        """source = video file path | directory of frame images | list of
        frames (paths/PIL) → [n_patches, patch_dim] float32."""
        if isinstance(source, str) and os.path.isdir(source):
            source = sorted(
                os.path.join(source, f) for f in os.listdir(source)
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
            )
        if isinstance(source, (list, tuple)):
            if not source:
                return self._black.copy()
            frames = self._exact_resize(source)
        else:
            # video FILE: decode + frame-select via fetch_video (needs
            # torchvision/decord), then resize to the exact static target
            decoded = fetch_video(
                {"video": source, "nframes": self.nframes},
                image_factor=self.patch_size * self.merge_size,
            )
            frames = self._exact_resize(list(decoded))
        patches, grid = patchify_video(
            frames, self.patch_size, self.temporal_patch_size, self.merge_size
        )
        assert grid == (self.grid_t, self.grid_h, self.grid_w), (
            f"video grid {grid} != static {(self.grid_t, self.grid_h, self.grid_w)}"
        )
        return patches


class ItemVideoStore:
    """item internal id → video source, static-grid preprocessing + LRU
    (the video analogue of ``ItemImageStore``'s static mode). Sources, in
    precedence order: a per-item ``video`` column in the item parquet
    (path to a video file OR a directory of frame images), else
    ``{video_dir}/{dataset}/{item_token}.mp4`` / a same-named frame
    directory. Missing/broken videos fall back to black frames (the
    reference's still-image fallback semantics, trainset.py:441-442)."""

    dynamic = False

    def __init__(self, config, dataload):
        ps, tps, merge = resolve_patch_geometry(config)
        self.prep = VideoPreprocessor(
            int(config.get("img_height", 224)), int(config.get("img_width", 224)),
            nframes=int(config.get("video_nframes", 4) or 4),
            patch_size=ps, temporal_patch_size=tps, spatial_merge_size=merge,
        )
        video_dir = config.get("video_dir") or ""
        dataset = config["dataset"]
        self.root = os.path.join(str(video_dir), str(dataset)) if video_dir else ""
        self.id2token = dataload.id2token["item_id"]
        self._paths: Dict[int, Optional[str]] = {}
        self._online_paths: Dict[int, str] = {}
        item_text = getattr(dataload, "item_text", None)
        if item_text is not None and "video" in getattr(item_text, "columns", ()):
            self._online_paths = {
                int(i): str(p)
                for i, p in zip(
                    item_text["int_item_id"].to_numpy(), item_text["video"]
                )
                if p
            }
        self._cache_cap = int(config.get("image_cache_items", 2048))
        from collections import OrderedDict

        self._patch_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def path(self, item_id: int) -> Optional[str]:
        if item_id in self._paths:
            return self._paths[item_id]
        p = None
        if item_id > 0 and item_id in self._online_paths:
            cand = self._online_paths[item_id]
            p = cand if os.path.exists(cand) else None
        elif self.root and item_id > 0:
            stem = os.path.join(self.root, str(self.id2token[item_id]))
            for cand in (f"{stem}.mp4", f"{stem}.avi", f"{stem}.mov", stem):
                if os.path.exists(cand):
                    p = cand
                    break
        self._paths[item_id] = p
        return p

    def _load(self, iid: int) -> np.ndarray:
        p = self.path(iid)
        if p is None:
            return self._black()
        try:
            return self.prep.preprocess(p)
        except Exception:
            return self._black()

    def _black(self) -> np.ndarray:
        return self.prep._black.copy()

    def batch(self, item_ids) -> np.ndarray:
        ids = [int(i) for i in item_ids]
        out = np.empty(
            (len(ids), self.prep.n_patches, self.prep.patch_dim), np.float32
        )
        for row, iid in enumerate(ids):
            hit = self._patch_cache.get(iid)
            if hit is None:
                hit = self._load(iid)
                self._patch_cache[iid] = hit
                if len(self._patch_cache) > self._cache_cap:
                    self._patch_cache.popitem(last=False)
            else:
                self._patch_cache.move_to_end(iid)
            out[row] = hit
        return out
