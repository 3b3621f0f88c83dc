"""Batched image augmentations of the SSL heads.

Counterpart of ``eavit_tpu/ops/augment.py:31-145``: RandomResizedCrop,
RandomHorizontalFlip(0.5) and the 3-tap Gaussian blur (sigma ~ U(0.1, 2.0))
applied with probability ``p``; one view is crop -> flip -> blur, and
``ssl_augment_pair`` makes two views of one batch.

Drawing is split from applying. :func:`draw_params` draws the per-sample
parameters of one view (crop ``top, left, crop_h, crop_w``, ``flip``, blur
``apply`` and ``sigma``) on the frames' device from an explicit generator,
with no host sync; :func:`augment` applies given parameters. The draws follow
the JAX package's distributions (one attempt of area U(0.08, 1) and
log-aspect U(log 3/4, log 4/3), clamped to the image); their values come
from the generator, so a test hands the JAX draws to :func:`augment`.
``same_on_batch`` draws one set and broadcasts it to the batch
(``augment.py:51-54``).

The crop and resize is ``jax.image.scale_and_translate``'s bilinear
exactly (``jax/_src/image/scale.py`` ``compute_weight_mat``): per sample
and per axis a ``[in, out]`` triangle-kernel weight matrix at the sample
points ``(arange(out) + 0.5) / scale - translation / scale - 0.5``, each
column divided by its sum (0 where the sum is below ``1000 * eps32``), and
every column whose sample point lies outside ``[-0.5, in - 0.5]`` zeroed;
then two batched contractions in full float32 (TF32 off). ``F.interpolate``
and ``F.grid_sample`` treat the edges otherwise. The arithmetic rounds as
XLA compiles the JAX function under ``jit``, as the JAX package runs it:
``1 / scale`` is ``crop * fl(1 / size)`` (XLA's rewrite of ``1 / (size /
crop)``) and the sample points' product and difference round once (a fused
multiply-add). The weights sit on the kinks of a triangle, so one unit in
the last place of a sample point (2^-17 at 84 pixels) moves a weight by as
much; JAX's op-by-op evaluation rounds both steps otherwise and differs
from its own ``jit`` by that.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Tuple

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


class AugmentParams(NamedTuple):
    """The parameters of one view, one entry per sample ([B] each)."""

    top: torch.Tensor  # float32, crop corner row
    left: torch.Tensor  # float32, crop corner column
    crop_h: torch.Tensor  # float32
    crop_w: torch.Tensor  # float32
    flip: torch.Tensor  # bool, horizontal flip
    blur: torch.Tensor  # bool, blur applied
    sigma: torch.Tensor  # float32, blur sigma


def draw_params(gen: torch.Generator, b: int, h: int, w: int, blur_p: float,
                same_on_batch: bool = False, device=None) -> AugmentParams:
    """Draw one view's parameters for ``b`` frames of ``h x w`` from ``gen``
    on ``device`` (``_sample_crop_params``, ``random_hflip``,
    ``random_gaussian_blur`` of the JAX module)."""
    n = 1 if same_on_batch else b

    def uniform(lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

    area = h * w * uniform(0.08, 1.0)
    ratio = torch.exp(uniform(math.log(3.0 / 4.0), math.log(4.0 / 3.0)))
    crop_w = torch.clamp(torch.sqrt(area * ratio), 1.0, float(w))
    crop_h = torch.clamp(torch.sqrt(area / ratio), 1.0, float(h))
    top = uniform() * (h - crop_h)
    left = uniform() * (w - crop_w)
    flip = uniform() < 0.5
    blur = uniform() < blur_p
    sigma = uniform(0.1, 2.0)
    params = AugmentParams(top, left, crop_h, crop_w, flip, blur, sigma)
    if same_on_batch:
        params = AugmentParams(*(v.expand(b) for v in params))
    return params


@contextlib.contextmanager
def _full_float32():
    """Matrix products in IEEE float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _weight_mats(size: int, crop: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """``compute_weight_mat`` for the triangle kernel at ``scale = size /
    crop``, per sample: ``[B, in, out]`` with ``in = out = size``."""
    f32 = torch.float32
    dev = crop.device
    inv_scale = crop * torch.tensor(1.0 / size, dtype=f32, device=dev)
    kernel_scale = torch.clamp(inv_scale, min=1.0)  # antialias: max(1 / scale, 1)
    grid = torch.arange(size, dtype=f32, device=dev)
    # one rounding of ``(i + 0.5) * inv_scale - translation * inv_scale``: the
    # float64 product of two float32 numbers is exact
    shift = (translation * inv_scale).double()[:, None]
    sample_f = ((grid[None, :] + 0.5).double() * inv_scale.double()[:, None]
                - shift).to(f32) - 0.5  # [B, out]
    x = (sample_f[:, None, :] - grid[None, :, None]).abs() / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x, min=0.0)  # [B, in, out]
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def resized_crop(imgs: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """Crop ``(top, left, crop_h, crop_w)`` of each sample of ``imgs`` [B, C,
    H, W] float32 and resize it back to ``H x W`` (``random_resized_crop``)."""
    _, _, h, w = imgs.shape
    wh = _weight_mats(h, p.crop_h, -p.top * h / p.crop_h)  # [B, H, H]
    ww = _weight_mats(w, p.crop_w, -p.left * w / p.crop_w)  # [B, W, W]
    with _full_float32():
        x = torch.matmul(imgs, ww[:, None])  # [B, C, H, W_out]
        return torch.matmul(wh.transpose(1, 2)[:, None], x)  # [B, C, H_out, W_out]


def hflip(imgs: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], imgs.flip(-1), imgs)


def gaussian_blur(imgs: torch.Tensor, apply: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 3-tap blur along H then W with edge padding, where ``apply``
    (``random_gaussian_blur``)."""
    e = torch.exp(-0.5 / torch.square(sigma))
    taps = torch.stack([e, torch.ones_like(e), e], dim=-1)
    taps = taps / taps.sum(dim=-1, keepdim=True)  # [B, 3]
    t0, t1, t2 = (taps[:, i, None, None, None] for i in range(3))
    pad_h = torch.cat([imgs[:, :, :1], imgs, imgs[:, :, -1:]], dim=2)
    blur_h = t0 * pad_h[:, :, :-2] + t1 * pad_h[:, :, 1:-1] + t2 * pad_h[:, :, 2:]
    pad_w = torch.cat([blur_h[..., :1], blur_h, blur_h[..., -1:]], dim=3)
    blurred = t0 * pad_w[..., :-2] + t1 * pad_w[..., 1:-1] + t2 * pad_w[..., 2:]
    return torch.where(apply[:, None, None, None], blurred, imgs)


def augment(imgs: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """One view of ``imgs`` [B, C, H, W] float32 in [0, 1]: crop -> flip ->
    blur with the parameters ``p`` (``ssl_augment``)."""
    x = resized_crop(imgs, p)
    x = hflip(x, p.flip)
    return gaussian_blur(x, p.blur, p.sigma)


def ssl_augment_pair(imgs: torch.Tensor, params: Tuple[AugmentParams, AugmentParams]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two views of one batch, one per set of parameters
    (``ssl_augment_pair``)."""
    return augment(imgs, params[0]), augment(imgs, params[1])
