"""Shared layers: dense layers with the JAX package's dtype rule, inits,
the NoisyNet linear, the 16-bit dropout module and the generators a
stochastic forward draws from.

Counterpart of ``eavit_tpu/models/layers.py`` (lines 1-131):

- :class:`Dense` is ``flax.linen.Dense``'s arithmetic in torch. With a
  compute dtype (``ComputeDtype = bfloat16``) the input, weight and bias are
  cast to it and the output stays in it; without one the layer computes in
  float32. Parameters are float32 and use torch's ``[out, in]`` layout.
- Inits: torch ``nn.Linear``'s default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  (``torch_linear_kernel_init``, lines 20-36), orthogonal with a gain and
  zero bias for heads (``make_dense``, lines 69-86). Each layer records its
  init and :func:`init_module` applies them from one ``torch.Generator``.
- :class:`Dropout16` (lines 49-66) over ``ops/attention.dropout16``.
- :class:`NoisyLinear` (lines 89-131): the Gaussian NoisyNet layer with
  its noise-free eval forward.
- :class:`Rng`: explicit generators in place of JAX keys, and
  :class:`RecordedRng`, the draws of one sublayer kept for a region that
  ``EncoderRemat`` recomputes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eavit_tpu_torch.ops.attention import dropout16
from eavit_tpu_torch.ops.kernel_prng import seeds_from_generator

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class Rng:
    """The generators of one stochastic stream. ``device`` draws dropout
    masks and action samples on the activations' device; ``host`` draws
    the 32-bit seed words handed to the CUDA kernels, so that passing them
    needs no device synchronisation."""

    def __init__(self, seed: int, device) -> None:
        device = torch.device(device)
        self.host = torch.Generator("cpu")
        self.host.manual_seed(seed)
        self.device = torch.Generator(device)
        self.device.manual_seed(seed + 0x9E3779B9)

    def seeds(self) -> Tuple[int, int]:
        return seeds_from_generator(self.host)

    def record(self) -> "RecordedRng":
        """The draws of one sublayer from here on, kept for a replay."""
        return RecordedRng(self)


class RecordedRng:
    """The draws of one sublayer, kept for the region that a
    rematerialising backward runs again. :meth:`rewind` before each run of
    the sublayer. On the first run :meth:`seeds` draws the kernel seed words
    from the parent stream and keeps them; after a rewind it hands the kept
    words out again in order. ``device`` restarts from the parent's
    generator state at :meth:`Rng.record`, so the recompute draws the first
    run's masks. ``torch.utils.checkpoint``'s ``preserve_rng_state``
    restores only the default generators, not these. :meth:`advance` moves
    the parent's device generator past what the first run drew, so that the
    stream goes on as without the recompute."""

    def __init__(self, parent: Rng) -> None:
        self._parent = parent
        self._seeds: List[Tuple[int, int]] = []
        self._start = parent.device.get_state()
        self.device = torch.Generator(parent.device.device)
        self._next = 0

    def rewind(self) -> None:
        self._next = 0
        self.device.set_state(self._start)

    def seeds(self) -> Tuple[int, int]:
        if self._next == len(self._seeds):
            self._seeds.append(self._parent.seeds())
        words = self._seeds[self._next]
        self._next += 1
        return words

    def advance(self) -> None:
        self._parent.device.set_state(self.device.get_state())


class Dense(nn.Linear):
    """``flax.linen.Dense(features, dtype=...)`` in torch (module doc).

    ``init`` is ``"torch"`` (U(+-1/sqrt(fan_in)) kernel and bias) or
    ``("orthogonal", gain)`` with a zero bias."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init=("torch",)) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.init = init if isinstance(init, tuple) else (init,)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        if self.init[0] == "orthogonal":
            nn.init.orthogonal_(self.weight, gain=self.init[1], generator=gen)
            if self.bias is not None:
                self.bias.zero_()
            return
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=gen)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=gen)


class NoisyLinear(nn.Module):
    """Gaussian NoisyNet linear layer (``eavit_tpu/models/layers.py:89-131``).

    ``y = x W + b + x (W_noisy * outer(eps_in, eps_out)) + b_noisy * eps_out``
    with ``eps ~ N(0, 1) * sigma0 / sqrt(fan_in)`` drawn at every forward
    that gets an ``Rng``, from its device generator (no host sync). Without
    one the forward is noise-free: the JAX package's documented divergence
    from the reference's stale eval-time noise. All four parameters are
    U(+-1/sqrt(fan_in)) in torch's ``[out, in]`` layout and float32; the
    layer computes in its input's dtype, as the JAX layer does, and keeps
    the two products apart (each weight cast on its own, so bf16 rounds as
    there)."""

    def __init__(self, in_features: int, out_features: int, sigma0: float = 0.5) -> None:
        super().__init__()
        self.in_features, self.out_features, self.sigma0 = in_features, out_features, sigma0
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.noisy_weight = nn.Parameter(torch.empty(out_features, in_features))
        self.noisy_bias = nn.Parameter(torch.empty(out_features))

    def sample_noise(self, rng: Rng, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(eps_in [in], eps_out [out])`` from ``rng.device``."""
        std = self.sigma0 / math.sqrt(self.in_features)
        eps_in = torch.randn(self.in_features, generator=rng.device, device=device)
        eps_out = torch.randn(self.out_features, generator=rng.device, device=device)
        return eps_in * std, eps_out * std

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None) -> torch.Tensor:
        dt = x.dtype
        y = F.linear(x, self.weight.to(dt), self.bias.to(dt))
        if rng is None:
            return y
        eps_in, eps_out = self.sample_noise(rng, x.device)
        noisy_w = self.noisy_weight * torch.outer(eps_out, eps_in)
        return y + F.linear(x, noisy_w.to(dt), (self.noisy_bias * eps_out).to(dt))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        for p in (self.weight, self.bias, self.noisy_weight, self.noisy_bias):
            p.uniform_(-bound, bound, generator=gen)


class Conv(nn.Conv2d):
    """VALID convolution with an orthogonal(gain) kernel and zero bias
    (the RND trunk's ``nn.Conv``, eavit_tpu/models/rnd.py:35-45)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 gain: float) -> None:
        super().__init__(in_ch, out_ch, kernel, stride=stride)
        self.gain = gain

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        # orthogonalise the [out, in*kh*kw] matrix, as flax's initializer
        # does on the flattened HWIO kernel (fan-in rows)
        nn.init.orthogonal_(self.weight, gain=self.gain, generator=gen)
        self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm`` with float32 parameters: statistics in f32
    and a float32 output whatever the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


class Dropout16(nn.Module):
    """Dropout from 16-bit random integers (``ops/attention.dropout16``).
    Identity when ``rng`` is None (the deterministic forward)."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None) -> torch.Tensor:
        if rng is None or self.rate <= 0.0:
            return x
        return dropout16(x, self.rate, rng.device)


@torch.no_grad()
def init_module(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every layer of ``module`` that declares ``init_params``,
    and every direct ``nn.Parameter`` that a module lists in
    ``normal_params`` (tokens and position embeddings, N(0, 1))."""
    for m in module.modules():
        if hasattr(m, "init_params"):
            m.init_params(gen)
        for name in getattr(m, "normal_params", ()):
            getattr(m, name).normal_(0.0, 1.0, generator=gen)
