"""Self-supervised auxiliary heads: BYOL and Barlow Twins.

Counterpart of ``eavit_tpu/models/ssl.py:36-225`` (reference BYOL.py:10-224,
BarlowTwins.py:11-167). Both heads share the policy's backbone: their losses
run ``network.feature``, the module the PPO loss differentiates, so one
optimizer step updates both paths.

- :func:`batch_norm` is train-mode BatchNorm over the batch (biased
  variance, eps 1e-5) that tracks no running statistics: the heads are only
  ever used in training.
- :class:`BNMLP` (``fc1``, ``bn_scale``, ``bn_bias``, ``fc2``) is BYOL's
  projector and predictor; the predictor's hidden width is twice the
  projection size (``ssl.py:140-141``).
- :class:`BTProjector` (``fc{i}``, ``bn{i}_scale``, ``bn{i}_bias``,
  ``fc_out``, no biases) is Barlow Twins' projector.
- :class:`BYOLModule` holds the online projector and predictor; its target
  (:meth:`BYOLModule.make_target`) is a copy of ``feature`` and
  ``projector`` whose parameters take no gradient, run under
  ``torch.no_grad()`` and moved by the EMA ``t * decay + o * (1 - decay)``
  after every optimizer step.
- :class:`BarlowTwinsModule` computes the cross-correlation loss.

The backbone runs deterministically for these losses (the JAX call passes
``deterministic=True``, ``ssl.py:111``), so its kernels run at rate 0, and
once per view: the projector's BatchNorm takes each view's own batch
statistics. The views come from ``ops/augment.py`` with parameters the
caller draws (:meth:`_SSLBase.draw`), so a test can hand in the JAX draws.
The parameter names mirror the flax tree, so ``convert.load_jax_params``
maps one onto the other by name.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eavit_tpu_torch.config import Config, RepresentationMethod
from eavit_tpu_torch.models.layers import Dense
from eavit_tpu_torch.ops.augment import AugmentParams, draw_params, ssl_augment_pair

Views = Tuple[AugmentParams, AugmentParams]


def batch_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Stateless train-mode BatchNorm1d over the batch axis (``_batch_norm``)."""
    mean = x.mean(dim=0, keepdim=True)
    var = x.var(dim=0, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale + bias
    return y


class BNMLP(nn.Module):
    """Linear -> BN -> ReLU -> Linear (reference BYOL.MLP, BYOL.py:64-77)."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int) -> None:
        super().__init__()
        self.fc1 = Dense(in_size, hidden_size)
        self.bn_scale = nn.Parameter(torch.ones(hidden_size))
        self.bn_bias = nn.Parameter(torch.zeros(hidden_size))
        self.fc2 = Dense(hidden_size, out_size)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        self.bn_scale.fill_(1.0)
        self.bn_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(batch_norm(self.fc1(x), self.bn_scale, self.bn_bias)))


class BTProjector(nn.Module):
    """(Linear without bias -> BN -> ReLU) per hidden size, then a Linear
    without bias (reference BarlowTwins.py:17-25)."""

    def __init__(self, in_size: int, sizes: Sequence[int]) -> None:
        super().__init__()
        self.hidden = len(sizes) - 1
        prev = in_size
        for i, s in enumerate(sizes[:-1]):
            self.add_module(f"fc{i}", Dense(prev, s, bias=False))
            self.register_parameter(f"bn{i}_scale", nn.Parameter(torch.ones(s)))
            self.register_parameter(f"bn{i}_bias", nn.Parameter(torch.zeros(s)))
            prev = s
        self.fc_out = Dense(prev, sizes[-1], bias=False)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        for i in range(self.hidden):
            getattr(self, f"bn{i}_scale").fill_(1.0)
            getattr(self, f"bn{i}_bias").zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.hidden):
            x = getattr(self, f"fc{i}")(x)
            x = F.relu(batch_norm(x, getattr(self, f"bn{i}_scale"),
                                  getattr(self, f"bn{i}_bias")))
        return self.fc_out(x)


def byol_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``2 - 2 * cos_sim`` per sample, with ``+ 1e-12`` on each norm
    (reference BYOL.py:96-100; ``F.normalize`` clamps instead)."""
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-12)
    return 2.0 - 2.0 * (x * y).sum(dim=-1)


def embed(backbone: nn.Module, imgs: torch.Tensor) -> torch.Tensor:
    """The deterministic backbone embedding the heads take: the mean of the
    two tokens with explorative attention, else the CLS stream, in float32
    (``_SSLBase._embed``)."""
    feats = backbone(imgs, None)
    if len(feats) == 2:
        return (0.5 * (feats[0] + feats[1])).float()
    return feats[0].float()


class _SSLBase(nn.Module):
    """What ``RNDAgent`` and ``SSLPretrainer`` call: ``draw``, ``loss``,
    ``make_target`` and ``update_target``."""

    blur_p: float
    loss_coef: float

    def __init__(self, cfg: Config) -> None:
        super().__init__()
        self.same_on_batch = cfg.ssl.apply_same_transform_to_batch

    def draw(self, gen: torch.Generator, b: int, h: int, w: int, device) -> Views:
        """The augment parameters of the two views of ``b`` frames."""
        return tuple(draw_params(gen, b, h, w, self.blur_p, self.same_on_batch, device)
                     for _ in range(2))

    def views(self, states_u8: torch.Tensor, views: Views) -> Tuple[torch.Tensor, torch.Tensor]:
        return ssl_augment_pair(states_u8.float() / 255.0, views)

    def make_target(self, feature: nn.Module) -> Optional[nn.ModuleDict]:
        return None

    @torch.no_grad()
    def update_target(self, target: Optional[nn.ModuleDict], feature: nn.Module) -> None:
        pass


class BYOLModule(_SSLBase):
    """BYOL's online heads and the EMA target (reference BYOL.py:115-203)."""

    blur_p = 0.5

    def __init__(self, cfg: Config) -> None:
        super().__init__(cfg)
        s = cfg.ssl
        self.loss_coef = s.byol_representation_loss_coef
        self.decay = s.byol_moving_average_decay
        self.projector = BNMLP(cfg.backbone_dim, s.byol_projection_hidden_size,
                               s.byol_projection_size)
        self.predictor = BNMLP(s.byol_projection_size, 2 * s.byol_projection_size,
                               s.byol_projection_size)

    def make_target(self, feature: nn.Module) -> nn.ModuleDict:
        """A copy of ``feature`` and the projector that takes no gradient
        (reference BYOL.py:163-166)."""
        target = nn.ModuleDict({"feature": copy.deepcopy(feature),
                                "projector": copy.deepcopy(self.projector)})
        return target.requires_grad_(False)

    @torch.no_grad()
    def copy_to_target(self, target: nn.ModuleDict, feature: nn.Module) -> None:
        """Set the target to the online ``feature`` and projector."""
        for t, o in zip(target.parameters(), self._online(feature)):
            t.copy_(o)

    def _online(self, feature: nn.Module):
        return list(feature.parameters()) + list(self.projector.parameters())

    def loss(self, feature: nn.Module, target: nn.ModuleDict, states_u8: torch.Tensor,
             views: Views) -> torch.Tensor:
        v1, v2 = self.views(states_u8, views)

        def online(v):
            return self.predictor(self.projector(embed(feature, v)))

        @torch.no_grad()
        def target_proj(v):
            return target["projector"](embed(target["feature"], v))

        loss = (byol_loss(online(v1), target_proj(v2))
                + byol_loss(online(v2), target_proj(v1)))
        return loss.mean()

    @torch.no_grad()
    def update_target(self, target: nn.ModuleDict, feature: nn.Module) -> None:
        """EMA ``target <- target * decay + online * (1 - decay)`` (reference
        BYOL.py:168-176), after every optimizer step (agents.py:531-532)."""
        t = list(target.parameters())
        torch._foreach_mul_(t, self.decay)
        torch._foreach_add_(t, torch._foreach_mul(self._online(feature), 1.0 - self.decay))


class BarlowTwinsModule(_SSLBase):
    """Barlow Twins' cross-correlation loss (reference BarlowTwins.py:50-64)."""

    blur_p = 0.1

    def __init__(self, cfg: Config) -> None:
        super().__init__(cfg)
        s = cfg.ssl
        self.loss_coef = s.barlow_twins_representation_loss_coef
        self.lambd = s.barlow_twins_lambda
        self.projector = BTProjector(cfg.backbone_dim, tuple(s.barlow_twins_projection_sizes))

    def loss(self, feature: nn.Module, target: None, states_u8: torch.Tensor,
             views: Views) -> torch.Tensor:
        v1, v2 = self.views(states_u8, views)
        z1 = self.projector(embed(feature, v1))
        z2 = self.projector(embed(feature, v2))
        c = batch_norm(z1).T @ batch_norm(z2) / z1.shape[0]  # [P, P]
        diag = torch.diagonal(c)
        on_diag = torch.square(diag - 1.0).sum()
        off_diag = torch.square(c).sum() - torch.square(diag).sum()
        return on_diag + self.lambd * off_diag


def make_ssl(cfg: Config) -> Optional[_SSLBase]:
    """The head ``representationLearningMethod`` names, or None."""
    method = cfg.representation_lr_method
    if method == RepresentationMethod.NONE:
        return None
    if method == RepresentationMethod.BYOL:
        return BYOLModule(cfg)
    if method == RepresentationMethod.BARLOW_TWINS:
        return BarlowTwinsModule(cfg)
    raise ValueError(method)
