"""Pretrained ViT weight import from a timm-format state dict.

Counterpart of ``eavit_tpu/models/pretrained.py`` (reference vit.py:170-251
``load_pretrain``). It maps a timm ViT state dict (the "jx" releases the
reference points at) onto a backbone's ``state_dict``:

    pos_embed                  -> pos_embedding (grid resized when the patch
                                  counts differ)
    patch_embed.proj.{w,b}     -> patch_proj (the conv kernel flattened to
                                  patchify's (p1, p2, c) feature order)
    cls_token                  -> cls_token, or both exploration_token and
                                  exploitation_token (the dual-token init
                                  from CLS, the reference's TODO at
                                  vit.py:171)
    blocks.i.norm1/attn.qkv/attn.proj -> attn_i.{norm,to_qkv,to_out}
    blocks.i.norm2/mlp.fc1/fc2        -> ff_i.{norm,fc1,fc2}
    norm.{w,b}                 -> the encoder's final norm

timm weights are already torch's ``[out, in]``, so only the patch kernel
changes layout. A checkpoint with other channels than the model (RGB against
a 4-frame stack) gives each channel the mean over the checkpoint's. The
function fills :class:`~eavit_tpu_torch.models.vit.DualTokenViT`'s tree
(``transformer``), as the JAX one does; a qkv bias is taken from
``attn.qkv.bias`` where the tree has one.

The position grid is resized as ``jax.image.resize(..., "bilinear")``
resizes it (``jax/_src/image/scale.py``): a triangle kernel per axis whose
support widens by the shrink factor when the grid shrinks (antialiasing),
each output's weights divided by their sum. ``F.interpolate(mode="bilinear",
align_corners=False)`` gives the same only when the grid grows, so the
weights are computed here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _resize_weights(src: int, dst: int) -> np.ndarray:
    """``compute_weight_mat`` of the triangle kernel, antialiased, for a
    resize of ``src`` samples to ``dst``: ``[src, dst]`` float32."""
    f32 = np.float32
    inv_scale = f32(1.0 / (dst / src))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def interp_pos_embed(pos: np.ndarray, num_patches: int) -> np.ndarray:
    """[1, 1+P_src, D] -> [1, 1+P_dst, D]: the square patch grid resized
    bilinearly (module doc), the token row kept."""
    tok, grid = pos[:, :1], pos[0, 1:]
    src = int(np.sqrt(grid.shape[0]))
    dst = int(np.sqrt(num_patches))
    if src * src != grid.shape[0] or dst * dst != num_patches:
        raise ValueError("non-square position grids cannot be interpolated")
    if src == dst:
        return pos
    w = _resize_weights(src, dst).astype(np.float64)
    g = grid.reshape(src, src, -1).astype(np.float64)
    out = np.einsum("abd,ai,bj->ijd", g, w, w).astype(np.float32)
    return np.concatenate([tok, out.reshape(1, dst * dst, -1)], axis=1)


def adapt_patch_kernel(w: np.ndarray, channels: int, patch: int) -> np.ndarray:
    """timm conv kernel ``[D, C_src, p, p]`` -> the Dense weight ``[D,
    (p1 p2 c)]`` over ``patchify``'s features, channels mean-replicated when
    ``C_src != channels``."""
    d, c_src, p, _ = w.shape
    if p != patch:
        raise ValueError(f"patch size mismatch: checkpoint {p} vs model {patch}")
    if c_src != channels:
        w = np.repeat(w.mean(axis=1, keepdims=True), channels, axis=1)
    return w.transpose(0, 2, 3, 1).reshape(d, patch * patch * channels)


def load_pretrained_timm(params: Mapping[str, torch.Tensor],
                         state_dict: Mapping[str, Any], *, channels: int,
                         patch_size: int) -> Dict[str, torch.Tensor]:
    """A copy of the backbone state dict ``params`` (``model.state_dict()``)
    with its weights replaced from the timm ``state_dict``; raises on a
    shape that does not match. Load it with ``model.load_state_dict``."""
    sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}
    new: Dict[str, np.ndarray] = {}
    num_patches = params["pos_embedding"].shape[1] - 1
    new["pos_embedding"] = interp_pos_embed(sd["pos_embed"], num_patches)
    if "cls_token" in params:
        new["cls_token"] = sd["cls_token"]
    else:  # the dual-token init from the pretrained CLS
        new["exploration_token"] = sd["cls_token"]
        new["exploitation_token"] = sd["cls_token"]
    new["patch_proj.weight"] = adapt_patch_kernel(
        sd["patch_embed.proj.weight"], channels, patch_size)
    new["patch_proj.bias"] = sd["patch_embed.proj.bias"]

    depth = sum(1 for k in params
                if k.startswith("transformer.attn_") and k.endswith("norm.weight"))
    pairs = {"attn_{i}.norm": "norm1", "attn_{i}.to_qkv": "attn.qkv",
             "attn_{i}.to_out": "attn.proj", "ff_{i}.norm": "norm2",
             "ff_{i}.fc1": "mlp.fc1", "ff_{i}.fc2": "mlp.fc2"}
    for i in range(depth):
        for ours, theirs in pairs.items():
            ours = f"transformer.{ours.format(i=i)}"
            for leaf in ("weight", "bias"):
                if f"{ours}.{leaf}" in params:
                    new[f"{ours}.{leaf}"] = sd[f"blocks.{i}.{theirs}.{leaf}"]
    if "norm.weight" in sd:
        new["transformer.norm.weight"] = sd["norm.weight"]
        new["transformer.norm.bias"] = sd["norm.bias"]

    out = dict(params)
    for name, value in new.items():
        old = params[name]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(old.shape)} "
                             f"vs {tuple(value.shape)}")
        out[name] = torch.from_numpy(np.array(value, copy=True)).to(old.device, old.dtype)
    return out


def load_pretrain(params: Mapping[str, torch.Tensor], path: str, *, channels: int,
                  patch_size: int) -> Dict[str, torch.Tensor]:
    """:func:`load_pretrained_timm` from a ``torch.save`` file, a flat state
    dict or one wrapped under ``state_dict`` or ``model`` (timm and
    lightning conventions)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if wrapper in sd and isinstance(sd[wrapper], Mapping):
            sd = sd[wrapper]
            break
    return load_pretrained_timm(params, sd, channels=channels, patch_size=patch_size)
