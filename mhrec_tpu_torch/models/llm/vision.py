"""Vision towers for image and video item encoding (port of
``mhrec_tpu/models/llm/vision.py``).

* ``VisionTower``: the Qwen2-VL vision stack (reference
  ``modeling_qwen2_vl.py`` Qwen2VisionTransformerPretrainedModel): a ViT over
  14×14×(2 temporal) patches with 2-D rotary position embeddings, then a 2×2
  spatial PatchMerger projecting into the text tower's width. The Conv3d
  patch embedding (stride = kernel) is a linear layer over the flattened
  patch. The grid is static per run (``grid_h × grid_w``, and ``grid_t``
  temporal groups for video, whose attention is block-diagonal per group),
  or dynamic: per-image (h, w) positions and a key mask over a fixed patch
  capacity (``patch_valid`` / ``patch_hw``, from ``data/vision.py``).
* ``ClipVisionTower``: a CLIP / SigLIP ViT and the LLaVA projector (reference
  ``modeling_llava_next.py``): the penultimate layer's features without the
  class token, an exact-GELU projector, and AnyRes packing — fixed
  (``anyres_grid``: a base crop and a gh×gw grid of crops stitched with an
  ``image_newline`` per row) or dynamic (``tok_src``: a host-computed gather
  over the crops' features).

Patches arrive in the host patchifier's order (2×2 merge blocks row-major,
then the rows within each block), which the rotary tables follow, so the
merger is a reshape. Parameters are float32; the layers compute in
``dtype``, as flax's ``Dense(dtype=...)`` does; LayerNorms compute and return
float32 (flax ``LayerNorm(dtype=float32)``), so the Qwen2-VL residual stream
stays in ``dtype`` and a CLIP tower's turns float32 after its pre-LN, as in
the JAX package. Attention scores are products in ``dtype``, divided by
√dh in float32 (the JAX package divides by an ``np.float64``, which
promotes), masked with float32's lowest value and normalized in float32.
The GELUs of the PatchMerger and of non-quick-GELU blocks are the tanh form
(flax ``nn.gelu``'s default; HF's merger uses the exact one), the CLIP
projector's the exact one. The attention is plain PyTorch (an ``einsum``
and a ``softmax`` in the JAX package too, outside any Pallas kernel).

``load_vision_params`` / ``load_clip_vision_params`` map an HF state dict
(``visual.*``; ``vision_tower.vision_model.*`` and
``multi_modal_projector.*``) onto these modules' state-dict names.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mhrec_tpu_torch.models.layers import LayerNorm, trunc_normal_init


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    # arch: "qwen2vl" (2D-RoPE ViT + 2x2 PatchMerger) or "clip" (CLIP/SigLIP
    # ViT + multimodal projector — the LLaVA-family item towers)
    arch: str = "qwen2vl"
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: int = 4
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_size: int = 1536          # output dim = text tower hidden size
    hidden_act: str = "quick_gelu"
    intermediate_size: int = 0       # clip: explicit MLP width
    use_cls_token: bool = True       # clip: learned class token + abs pos emb
    layer_norm_eps: float = 1e-6
    patch_bias: bool = False         # siglip: conv patch embedding has a bias
    use_pre_ln: bool = True          # siglip: no pre-LN before the blocks
    # fixed-grid AnyRes (clip arch only): (gh, gw) grid crops + base crop,
    # packed with per-row image_newline tokens
    anyres_grid: Optional[tuple] = None
    # dynamic per-image AnyRes pinpoints (clip arch): host-side maps, see
    # data/vision.py AnyResPreprocessor — only affects which params exist
    dynamic_anyres: bool = False
    # checkpoint-native position-table length (clip: (image_size/ps)² + cls);
    # 0 → sized from the run grid
    n_positions: int = 0

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.intermediate_size or self.embed_dim * self.mlp_ratio

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "VisionConfig":
        with open(os.path.join(path, "config.json")) as fh:
            raw = json.load(fh)
        v = raw.get("vision_config")
        if v is None:
            raise ValueError(f"{path}/config.json has no vision_config")
        text_hidden = raw.get("hidden_size") or (
            raw.get("text_config", {}).get("hidden_size", 1536))
        if v.get("model_type") in ("clip_vision_model", "siglip_vision_model") \
                or raw.get("model_type", "").startswith("llava"):
            siglip = v.get("model_type") == "siglip_vision_model"
            return cls(
                arch="clip",
                embed_dim=v.get("hidden_size", 1024),
                depth=v.get("num_hidden_layers", 24),
                num_heads=v.get("num_attention_heads", 16),
                intermediate_size=v.get("intermediate_size", 4096),
                in_channels=v.get("num_channels", 3),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=1,
                spatial_merge_size=1,
                hidden_size=text_hidden,
                hidden_act=v.get("hidden_act", "quick_gelu"),
                use_cls_token=not siglip,
                layer_norm_eps=v.get("layer_norm_eps", 1e-5),
                patch_bias=siglip,
                use_pre_ln=not siglip,
                n_positions=(v.get("image_size", 224) // v.get("patch_size", 14)) ** 2
                + (0 if siglip else 1),
            )
        return cls(
            embed_dim=v.get("embed_dim", 1280),
            depth=v.get("depth", 32),
            num_heads=v.get("num_heads", 16),
            mlp_ratio=v.get("mlp_ratio", 4),
            in_channels=v.get("in_channels", 3),
            patch_size=v.get("patch_size", 14),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            hidden_size=v.get("hidden_size", text_hidden),
            hidden_act=v.get("hidden_act", "quick_gelu"),
        )

    @classmethod
    def tiny(cls, hidden_size: int = 64) -> "VisionConfig":
        return cls(embed_dim=32, depth=2, num_heads=4, mlp_ratio=2,
                   patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                   hidden_size=hidden_size)


def vision_rotary_tables(grid_h: int, grid_w: int, merge: int, head_dim: int,
                         theta: float = 10000.0):
    """cos/sin tables [P, head_dim] float32 numpy for the 2-D vision RoPE.

    Patch order matches the host patchifier: merge blocks row-major, then
    rows within each block (reference Qwen2VL ``rot_pos_emb``)."""
    hb = np.arange(grid_h).reshape(grid_h // merge, 1, merge, 1)
    wb = np.arange(grid_w).reshape(1, grid_w // merge, 1, merge)
    shape = (grid_h // merge, grid_w // merge, merge, merge)
    hpos = np.broadcast_to(hb, shape).ravel()
    wpos = np.broadcast_to(wb, shape).ravel()
    dim = head_dim // 2  # rotary dim per spatial axis pair
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freq_h = hpos[:, None].astype(np.float32) * inv_freq[None, :]
    freq_w = wpos[:, None].astype(np.float32) * inv_freq[None, :]
    freqs = np.concatenate([freq_h, freq_w], axis=-1)       # [P, head_dim//2]
    emb = np.concatenate([freqs, freqs], axis=-1)           # [P, head_dim]
    return np.cos(emb), np.sin(emb)


def vision_rotary_from_hw(patch_hw: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """Per-image RoPE tables from host-computed patch positions: patch_hw
    [N, P, 2] (h, w of each patch, the dynamic smart-resize path) → cos/sin
    [N, P, head_dim] float32; the math of ``vision_rotary_tables`` with the
    positions given."""
    dim = head_dim // 2
    inv = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))).to(patch_hw.device)
    freq_h = patch_hw[..., 0:1].float() * inv
    freq_w = patch_hw[..., 1:2].float() * inv
    freqs = torch.cat([freq_h, freq_w], dim=-1)   # [N, P, Dh//2]
    emb = torch.cat([freqs, freqs], dim=-1)       # [N, P, Dh]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def apply_vision_rope(x, cos, sin):
    """x [N, P, H, Dh]; cos/sin [P, Dh] (static grid) or [N, P, Dh]
    (per-image grids); computed in float32, cast back to x's type."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def _linear(layer: nn.Linear, x, dtype):
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _act(h, hidden_act: str):
    if hidden_act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h, approximate="tanh")  # flax nn.gelu's default


def _attention(q, k, v, dtype, valid=None, seg=None):
    """q, k, v [N, P, H, dh] in ``dtype`` → context [N, P, H·dh]."""
    N, P, H, dh = q.shape
    scores = torch.einsum("nphd,nqhd->nhpq", q, k).float() / math.sqrt(dh)
    low = torch.finfo(torch.float32).min
    if valid is not None:  # dynamic grids: padded patch keys masked
        scores = torch.where(valid[:, None, None, :], scores, low)
    if seg is not None:  # video: block-diagonal per temporal patch group
        scores = torch.where((seg[:, None] == seg[None, :])[None, None], scores, low)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("nhpq,nqhd->nphd", probs, v).reshape(N, P, H * dh)


@torch.no_grad()
def _init_linears(module: nn.Module, gen: torch.Generator):
    """flax ``Dense``'s defaults: lecun-normal kernels (truncated normal of
    std 1/sqrt(fan in)), zero biases; unit LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_init(m.weight, gen, std=m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class VisionBlock(nn.Module):
    def __init__(self, config: VisionConfig, dtype=torch.bfloat16):
        super().__init__()
        self.config, self.dtype = config, dtype
        D = config.embed_dim
        self.norm1 = LayerNorm(D, 1e-6, dtype=torch.float32)
        self.qkv = nn.Linear(D, 3 * D)
        self.proj = nn.Linear(D, D)
        self.norm2 = LayerNorm(D, 1e-6, dtype=torch.float32)
        self.fc1 = nn.Linear(D, D * config.mlp_ratio)
        self.fc2 = nn.Linear(D * config.mlp_ratio, D)

    def forward(self, x, cos, sin, valid=None, seg=None):
        c, dt = self.config, self.dtype
        N, P, D = x.shape
        qkv = _linear(self.qkv, self.norm1(x), dt).view(N, P, 3, c.num_heads, c.head_dim)
        q, k, v = qkv.unbind(2)
        q, k = apply_vision_rope(q, cos, sin), apply_vision_rope(k, cos, sin)
        x = x + _linear(self.proj, _attention(q, k, v, dt, valid, seg), dt)
        h = _act(_linear(self.fc1, self.norm2(x), dt), c.hidden_act)
        return x + _linear(self.fc2, h, dt)


def _run_blocks(blocks, x, remat: bool, *args):
    for block in blocks:
        if remat:
            # non-reentrant: the backward reruns the block; no random draws
            x = checkpoint(block, x, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, *args)
    return x


class VisionTower(nn.Module):
    """Patches [N, P, patch_dim] → image tokens [N, P/merge², hidden_size]."""

    def __init__(self, config: VisionConfig, grid_h: int, grid_w: int, dtype=torch.bfloat16,
                 gradient_checkpointing: bool = False, grid_t: int = 1):
        """``grid_t`` > 1 (video): temporal patch groups of grid_h·grid_w
        patches each; the rotary tables tile per group and attention is
        block-diagonal per group (reference Qwen2VL rot_pos_emb
        ``.repeat(t, 1)`` and cu_seqlens)."""
        super().__init__()
        c = self.config = config
        self.grid_h, self.grid_w, self.grid_t = grid_h, grid_w, grid_t
        self.dtype = dtype
        self.gradient_checkpointing = gradient_checkpointing
        m, D = c.spatial_merge_size, c.embed_dim
        self.patch_embed = nn.Linear(c.patch_dim, D, bias=False)
        self.blocks = nn.ModuleList(VisionBlock(c, dtype) for _ in range(c.depth))
        self.ln_q = LayerNorm(D, 1e-6, dtype=torch.float32)
        self.merger_fc1 = nn.Linear(m * m * D, m * m * D)
        self.merger_fc2 = nn.Linear(m * m * D, c.hidden_size)
        cos, sin = vision_rotary_tables(grid_h, grid_w, m, c.head_dim)
        if grid_t > 1:
            cos, sin = np.tile(cos, (grid_t, 1)), np.tile(sin, (grid_t, 1))
        self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)
        self.register_buffer("seg", torch.arange(grid_t).repeat_interleave(grid_h * grid_w),
                             persistent=False)

    def init_parameters(self, gen: torch.Generator):
        _init_linears(self, gen)

    def forward(self, patches, patch_valid=None, patch_hw=None):
        """Static grid: rope from (grid_h, grid_w). Dynamic smart-resize
        (patch_valid [N, P] / patch_hw [N, P, 2] given): per-image rope
        positions and masked attention over the padded patch capacity;
        padded merge blocks yield tokens the backbone's gather-splice never
        reads."""
        c, dt = self.config, self.dtype
        m = c.spatial_merge_size
        x = _linear(self.patch_embed, patches, dt)
        if patch_hw is not None:
            cos, sin = vision_rotary_from_hw(patch_hw, c.head_dim)
        else:
            cos, sin = self.rope_cos, self.rope_sin
        seg = self.seg if self.grid_t > 1 else None
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        x = _run_blocks(self.blocks, x, remat, cos, sin, patch_valid, seg)
        # PatchMerger (reference modeling_qwen2_vl.py:1089): LN, then each
        # 2×2 group (consecutive in patch order) into one token
        x = self.ln_q(x)
        N, P, D = x.shape
        x = x.reshape(N, P // (m * m), m * m * D)
        h = F.gelu(_linear(self.merger_fc1, x, dt), approximate="tanh")
        return _linear(self.merger_fc2, h, dt)


class ClipVisionBlock(nn.Module):
    def __init__(self, config: VisionConfig, dtype=torch.bfloat16):
        super().__init__()
        self.config, self.dtype = config, dtype
        D, eps = config.embed_dim, config.layer_norm_eps
        self.layer_norm1 = LayerNorm(D, eps, dtype=torch.float32)
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(D, D) for _ in range(3))
        self.out_proj = nn.Linear(D, D)
        self.layer_norm2 = LayerNorm(D, eps, dtype=torch.float32)
        self.fc1 = nn.Linear(D, config.mlp_dim)
        self.fc2 = nn.Linear(config.mlp_dim, D)

    def forward(self, x):
        c, dt = self.config, self.dtype
        N, P, D = x.shape
        h = self.layer_norm1(x)
        q, k, v = (_linear(p, h, dt).view(N, P, c.num_heads, c.head_dim)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        x = x + _linear(self.out_proj, _attention(q, k, v, dt), dt)
        h = _act(_linear(self.fc1, self.layer_norm2(x), dt), c.hidden_act)
        return x + _linear(self.fc2, h, dt)


class ClipVisionTower(nn.Module):
    """CLIP/SigLIP ViT + LLaVA multimodal projector. Patches [N, P,
    patch_dim] → image tokens [N, P, hidden_size]: the penultimate layer's
    hidden states (``vision_feature_layer=-2``), class token dropped;
    rank-4 patches [N, n_crops, P, dim] are AnyRes crops."""

    feature_layer_offset = 1  # -2 ⇒ the last block is not run

    def __init__(self, config: VisionConfig, grid_h: int, grid_w: int, dtype=torch.bfloat16,
                 gradient_checkpointing: bool = False):
        super().__init__()
        c = self.config = config
        self.grid_h, self.grid_w = grid_h, grid_w
        self.dtype = dtype
        self.gradient_checkpointing = gradient_checkpointing
        D = c.embed_dim
        self.patch_embed = nn.Linear(c.patch_dim, D, bias=c.patch_bias)
        n_pos = grid_h * grid_w + (1 if c.use_cls_token else 0)
        # a pretrained table for a larger grid is sliced at apply time
        self.position_embedding = nn.Parameter(torch.empty(max(n_pos, c.n_positions), D))
        if c.use_cls_token:
            self.class_embedding = nn.Parameter(torch.empty(D))
        if c.use_pre_ln:
            self.pre_layernorm = LayerNorm(D, c.layer_norm_eps, dtype=torch.float32)
        self.blocks = nn.ModuleList(ClipVisionBlock(c, dtype)
                                    for _ in range(c.depth - self.feature_layer_offset))
        self.proj_fc1 = nn.Linear(D, c.hidden_size)
        self.proj_fc2 = nn.Linear(c.hidden_size, c.hidden_size)
        if c.anyres_grid or c.dynamic_anyres:
            self.image_newline = nn.Parameter(torch.empty(c.hidden_size))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """flax's initialisers: ``_init_linears``, normal 0.02 position and
        class embeddings, normal 1/sqrt(hidden) image_newline."""
        _init_linears(self, gen)
        self.position_embedding.normal_(0.0, 0.02, generator=gen)
        if hasattr(self, "class_embedding"):
            self.class_embedding.normal_(0.0, 0.02, generator=gen)
        if hasattr(self, "image_newline"):
            self.image_newline.normal_(0.0, self.config.hidden_size ** -0.5, generator=gen)

    def forward(self, patches, tok_src=None):
        """``tok_src`` (dynamic AnyRes, data/vision.py AnyResPreprocessor):
        [N, T_cap] gather map over the flat [n_crops·P (+1 newline)] crop
        features; padded crops are computed but never gathered."""
        c, dt = self.config, self.dtype
        n_crops = 1
        if patches.dim() == 4:  # [N, n_crops, P, dim] — AnyRes crops
            n_items, n_crops = patches.shape[:2]
            if tok_src is None and (not c.anyres_grid or
                                    n_crops != 1 + c.anyres_grid[0] * c.anyres_grid[1]):
                raise ValueError(f"rank-4 patches need anyres_grid with {n_crops} crops")
            patches = patches.reshape((-1,) + tuple(patches.shape[2:]))
        N, P, _ = patches.shape
        x = _linear(self.patch_embed, patches, dt)
        n_pos = P + (1 if c.use_cls_token else 0)
        if c.use_cls_token:
            cls = self.class_embedding.to(dt)[None, None, :].expand(N, 1, c.embed_dim)
            x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding[:n_pos].to(dt)[None]
        if c.use_pre_ln:
            x = self.pre_layernorm(x)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        x = _run_blocks(self.blocks, x, remat)
        if c.use_cls_token:
            x = x[:, 1:]  # drop CLS (LLaVA "default" strategy)
        h = F.gelu(_linear(self.proj_fc1, x, dt))  # HF LLaVA projector: exact gelu
        feats = _linear(self.proj_fc2, h, dt)
        D = c.hidden_size
        if tok_src is not None:
            # dynamic AnyRes: the crops' features flattened, the newline row
            # appended (index n_crops·P), the host's packing gathered: base
            # crop, unpadded grid, per-row newlines (pack_image_features)
            N_ = tok_src.shape[0]
            newline = self.image_newline.to(feats.dtype)
            flat = torch.cat([feats.reshape(N_, n_crops * P, D),
                              newline[None, None, :].expand(N_, 1, D)], dim=1)
            idx = torch.clamp(tok_src.long(), 0, n_crops * P)
            take = torch.gather(flat, 1, idx[..., None].expand(-1, -1, D))
            return torch.where((tok_src >= 0)[..., None], take, torch.zeros((), dtype=take.dtype,
                                                                             device=take.device))
        if n_crops == 1:
            return feats
        # pack_image_features (reference modeling_llava_next.py:407-): base
        # crop first, grid crops stitched into the (gh·grid_h, gw·grid_w)
        # feature map with an image_newline per row; unpad is a no-op here
        # (the host resizes every image to the pinned pinpoint)
        gh, gw = c.anyres_grid
        newline = self.image_newline.to(feats.dtype)
        feats = feats.reshape(n_items, n_crops, P, D)
        base = feats[:, 0]
        grid = feats[:, 1:].reshape(n_items, gh, gw, self.grid_h, self.grid_w, D)
        grid = grid.permute(0, 1, 3, 2, 4, 5).reshape(
            n_items, gh * self.grid_h, gw * self.grid_w, D)
        nl = newline[None, None, None, :].expand(n_items, gh * self.grid_h, 1, D)
        grid = torch.cat([grid, nl], dim=2).reshape(n_items, -1, D)
        return torch.cat([base, grid], dim=1)


# -- HF checkpoint weights → the towers' state dicts -----------------------------
def has_vision_weights(sd: Dict[str, torch.Tensor]) -> bool:
    return any(k.startswith("visual.") or k.startswith("vision_tower.") for k in sd)


def load_vision_params(sd: Dict[str, torch.Tensor], config: VisionConfig) -> Dict:
    """HF ``visual.*`` weights → ``VisionTower`` state-dict names (HF's
    ``nn.Linear`` layout is the port's; the Conv3d [E, C, tps, ps, ps]
    weight flattens to the patch embedding's [E, patch_dim])."""
    def t(name):
        return sd[f"visual.{name}"]

    out = {
        "patch_embed.weight": t("patch_embed.proj.weight").reshape(config.embed_dim, -1),
        "ln_q.weight": t("merger.ln_q.weight"), "ln_q.bias": t("merger.ln_q.bias"),
        "merger_fc1.weight": t("merger.mlp.0.weight"), "merger_fc1.bias": t("merger.mlp.0.bias"),
        "merger_fc2.weight": t("merger.mlp.2.weight"), "merger_fc2.bias": t("merger.mlp.2.bias"),
    }
    for i in range(config.depth):
        pre, dst = f"blocks.{i}", f"blocks.{i}"
        for src, name in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "qkv"),
                          ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            out[f"{dst}.{name}.weight"] = t(f"{pre}.{src}.weight")
            out[f"{dst}.{name}.bias"] = t(f"{pre}.{src}.bias")
    return out


def load_clip_vision_params(sd: Dict[str, torch.Tensor], config: VisionConfig) -> Dict:
    """HF LLaVA ``vision_tower.vision_model.*`` and projector weights →
    ``ClipVisionTower`` state-dict names. A checkpoint without
    ``image_newline`` (not an AnyRes one) gets the JAX package's fresh
    draw: numpy ``default_rng(0)`` normal / sqrt(hidden)."""
    pre = "vision_tower.vision_model"
    out = {
        "patch_embed.weight": sd[f"{pre}.embeddings.patch_embedding.weight"].reshape(
            config.embed_dim, -1),
        "position_embedding": sd[f"{pre}.embeddings.position_embedding.weight"],
        "proj_fc1.weight": sd["multi_modal_projector.linear_1.weight"],
        "proj_fc1.bias": sd["multi_modal_projector.linear_1.bias"],
        "proj_fc2.weight": sd["multi_modal_projector.linear_2.weight"],
        "proj_fc2.bias": sd["multi_modal_projector.linear_2.bias"],
    }
    if config.patch_bias:
        out["patch_embed.bias"] = sd[f"{pre}.embeddings.patch_embedding.bias"]
    if config.use_pre_ln:  # HF spells it "pre_layrnorm"
        out["pre_layernorm.weight"] = sd[f"{pre}.pre_layrnorm.weight"]
        out["pre_layernorm.bias"] = sd[f"{pre}.pre_layrnorm.bias"]
    if config.use_cls_token:
        out["class_embedding"] = sd[f"{pre}.embeddings.class_embedding"]
    if config.anyres_grid or config.dynamic_anyres:
        if "image_newline" in sd:
            out["image_newline"] = sd["image_newline"]
        else:
            rng = np.random.default_rng(0)
            out["image_newline"] = torch.from_numpy(
                (rng.standard_normal(config.hidden_size)
                 / np.sqrt(config.hidden_size)).astype(np.float32))
    for i in range(config.depth - ClipVisionTower.feature_layer_offset):
        lp, dst = f"{pre}.encoder.layers.{i}", f"blocks.{i}"
        for src, name in (("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
                          ("self_attn.q_proj", "q_proj"), ("self_attn.k_proj", "k_proj"),
                          ("self_attn.v_proj", "v_proj"), ("self_attn.out_proj", "out_proj"),
                          ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            out[f"{dst}.{name}.weight"] = sd[f"{lp}.{src}.weight"]
            out[f"{dst}.{name}.bias"] = sd[f"{lp}.{src}.bias"]
    return out


def load_any_vision_params(sd: Dict[str, torch.Tensor], config: VisionConfig) -> Dict:
    """Dispatch on the tower architecture."""
    if config.arch == "clip":
        return load_clip_vision_params(sd, config)
    return load_vision_params(sd, config)
