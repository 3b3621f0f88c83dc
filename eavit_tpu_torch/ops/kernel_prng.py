"""Dropout PRNG contract shared by the CUDA kernels and their plain versions.

Counterpart of ``eavit_tpu/ops/kernel_prng.py:29-55``. The quantisation is
the same: a 24-bit keep threshold (keep probability ``thresh / 2^24``) and
the unbiased inverse scale ``2^24 / thresh``. The TPU's on-core generator
has no GPU twin, so the bits come from Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC'11), keyed so that a
mask depends only on the element's logical index:

- key = the two 32-bit seed words drawn for the call;
- element ``e`` (a 64-bit index into the row-major mask) takes word
  ``e % 4`` of ``Philox(counter=(lo32(e // 4), hi32(e // 4), stream, 0), key)``;
- ``keep = (bits >> 8) < thresh``.

No blocking of any kernel enters the mask, so a forward and a backward
kernel with different tilings regenerate the same bits. ``stream`` tells
two masks of one call apart (the FFN draws mask1 on stream 0 and mask2 on
stream 1). ``csrc/philox.cuh`` is the device side of the same function;
:func:`philox4x32_10` below is the plain torch side (uint32 arithmetic
carried in int64).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """24-bit keep threshold; keep probability = thresh / 2^24 exactly."""
    return min(1 << 24, int(round((1.0 - rate) * (1 << 24))))


def inv_keep_scale(thresh: int) -> float:
    """Unbiased inverse-keep scale; 0.0 at rate=1.0 (thresh=0: everything
    is dropped and the scale is never applied)."""
    return float((1 << 24) / thresh) if thresh else 0.0


def dropout_args(seeds, rate: float) -> Tuple[Optional[int], float, Tuple[int, int]]:
    """What one kernel call needs for its masks: ``(thresh, inv_keep, (s0,
    s1))``, with ``thresh`` None at ``rate == 0`` (nothing is drawn then)."""
    if rate <= 0.0:
        return None, 1.0, (0, 0)
    if seeds is None:
        raise ValueError("rate > 0 requires seeds")
    thresh = keep_threshold(rate)
    return thresh, inv_keep_scale(thresh), (int(seeds[0]), int(seeds[1]))


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``m * x`` for a 32-bit constant ``m`` and
    int64 tensor ``x`` holding uint32 values. The product is split on
    ``x``'s 16-bit halves so no intermediate leaves int64's range."""
    x_lo = x & 0xFFFF
    x_hi = x >> 16
    p_lo = m * x_lo  # < 2^48
    p_hi = m * x_hi  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    lo = mid & _MASK32
    hi = (p_hi >> 16) + (mid >> 32)
    return hi & _MASK32, lo


def philox4x32_10(
    ctr: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: Tuple[int, int],
) -> Tuple[torch.Tensor, ...]:
    """Philox4x32 with 10 rounds on int64 tensors holding uint32 words.

    ``ctr`` is four broadcastable int64 tensors, ``key`` two ints. Returns
    the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def raw_bits24(
    numel: int, seeds: Tuple[int, int], stream: int, device=None
) -> torch.Tensor:
    """The 24-bit values ``bits >> 8`` of elements ``0 .. numel-1`` of one
    mask, as int32 [numel] (the plain twin of the replay kernels)."""
    groups = (numel + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(
        (g & _MASK32, g >> 32, zero + (stream & _MASK32), zero), seeds
    )
    bits = torch.stack(words, dim=1).reshape(-1)[:numel]
    return (bits >> 8).to(torch.int32)


def keep_mask(
    shape, seeds: Tuple[int, int], stream: int, thresh: int, device=None
) -> torch.Tensor:
    """Boolean keep mask of ``shape`` (row-major element index ``e``)."""
    numel = 1
    for d in shape:
        numel *= int(d)
    return (raw_bits24(numel, seeds, stream, device) < thresh).reshape(shape)


def seeds_from_generator(gen: torch.Generator) -> Tuple[int, int]:
    """Two 32-bit seed words drawn from a host (CPU) generator, so that
    handing them to a kernel needs no device synchronisation."""
    w = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=gen)
    return int(w[0]), int(w[1])
