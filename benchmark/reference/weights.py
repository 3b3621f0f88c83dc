"""The agent's weights, made from the run's seed on the device.

The benchmark makes the weights once for the program under test and again,
from the same seed, for the reference: both sides start from the same
numbers and neither takes them from the other. Leaves are taken in name
order and drawn in two calls, one uniform and one normal, so making them
costs a few launches whatever the model's size.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from benchmark.reference.model import LeafSpec

# the weights' generator is its own stream, apart from the run's act and
# update draws
WEIGHT_SEED_SALT = 0x5DEECE66D


def make_weights(specs: Iterable[LeafSpec], seed: int, device) -> Dict[str, torch.Tensor]:
    specs = sorted(specs, key=lambda s: s[0])
    gen = torch.Generator(torch.device(device))
    gen.manual_seed((seed ^ WEIGHT_SEED_SALT) & 0xFFFFFFFFFFFF)

    def numel(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    n_uni = sum(numel(s[1]) for s in specs if s[2] == "uniform")
    n_nrm = sum(numel(s[1]) for s in specs if s[2] == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2.0).sub_(1.0)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    iu = inr = 0
    for name, shape, kind, scale in specs:
        n = numel(shape)
        if kind == "uniform":
            out[name] = uni[iu:iu + n].view(shape) * scale
            iu += n
        elif kind == "normal":
            out[name] = nrm[inr:inr + n].view(shape) * scale
            inr += n
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
