"""The random draws of one PPO+RND iteration, replayed for the reference.

The program draws from two generators of one stream, both seeded from the
run's seed: a host (CPU) ``torch.Generator`` that gives each dropout kernel
call two 32-bit seed words, and a device ``torch.Generator`` that gives
16-bit dropout bits, the Gumbel (exponential) action draws, the epoch
permutations and the RND update mask. The reference makes the same calls on
generators seeded the same way, so it sees the same bits.

The kernels' dropout masks are Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC'11) on the element's row-major index
``e``: word ``e % 4`` of ``Philox(counter=(lo32(e // 4), hi32(e // 4),
stream, 0), key=seed words)``, kept where ``bits >> 8`` is under a 24-bit
threshold. This file is a frozen, independent copy of that function.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
# the device generator's seed is the host one's plus this constant
DEVICE_SEED_OFFSET = 0x9E3779B9


def generators(seed: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """``(host, device)`` generators of the stream seeded by ``seed``."""
    host = torch.Generator("cpu")
    host.manual_seed(seed)
    dev = torch.Generator(torch.device(device))
    dev.manual_seed(seed + DEVICE_SEED_OFFSET)
    return host, dev


def seed_words(host: torch.Generator) -> Tuple[int, int]:
    w = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=host)
    return int(w[0]), int(w[1])


def dropout16_keep(shape, rate: float, dev: torch.Generator, device) -> Tuple[torch.Tensor, float]:
    """The keep mask of a 16-bit dropout of ``shape`` and its scale, or
    ``(None, 1)`` where the rate draws nothing."""
    thresh = int(round((1.0 - rate) * 65536))
    if thresh >= 65536:
        return None, 1.0
    bits = torch.randint(0, 65536, tuple(shape), generator=dev, device=device,
                         dtype=torch.int32)
    return bits < thresh, 65536.0 / thresh


def _mulhilo(m: int, x: torch.Tensor):
    x_lo, x_hi = x & 0xFFFF, x >> 16
    p_lo, p_hi = m * x_lo, m * x_hi
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & _MASK32, mid & _MASK32


def _philox(g: torch.Tensor, stream: int, key: Tuple[int, int]):
    c0, c1 = g & _MASK32, g >> 32
    c2 = torch.full_like(g, stream & _MASK32)
    c3 = torch.zeros_like(g)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def kernel_keep(shape, seeds: Tuple[int, int], stream: int, rate: float,
                device) -> Tuple[torch.Tensor, float]:
    """A kernel's keep mask of ``shape`` and its scale ``2^24 / thresh``."""
    thresh = min(1 << 24, int(round((1.0 - rate) * (1 << 24))))
    numel = 1
    for d in shape:
        numel *= int(d)
    g = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    bits = torch.stack(_philox(g, stream, seeds), dim=1).reshape(-1)[:numel]
    return ((bits >> 8) < thresh).reshape(tuple(shape)), float((1 << 24) / thresh)
