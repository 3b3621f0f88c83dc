"""Actor-critic network over the dual-token ViT backbone.

Counterpart of ``eavit_tpu/models/policy.py`` (lines 1-185; reference
model.py:85-354). Heads:

- actor: Dense(D, D) -> ReLU -> Dense(D, A) (then tanh for continuous
  actions, with a learnt float32 ``log_std [A]`` initialised to -0.5);
- extra_fc: Dense(D, D) -> ReLU, shared by both critics;
- critic_ext / critic_int: Dense(D, 1) on ``relu(extra_fc(x)) + x``;
- orthogonal init: actor and critics gain 0.01, extra_fc gain 0.1, zero
  biases;
- ``UseNoisyNet = True``: the five heads are ``NoisyLinear`` layers, with
  noise when the forward gets an ``Rng``.

Token routing with explorative attention (policy.py:138-172): the
exploration token feeds ``critic_int``, the exploitation token feeds
``critic_ext``, and their mean feeds the actor. Without it the CLS stream
feeds everything.

The backbone is the lucidrains ``DualTokenViT`` (``ViT_implementation_type
= 0``) or the HF-flavour ``DualTokenViTHG`` (type 1), whose image size and
channels default to ``PreProcHeight`` and ``StateStackSize`` when
``ViTHG_PreProcHeight`` / ``ViTHG_StateStackSize`` are not set.
"""

from __future__ import annotations

from enum import Enum
from typing import NamedTuple, Optional

import torch
from torch import nn

from eavit_tpu_torch.config import (
    Config,
    ViTImplementation,
    attention_route,
    ffn_route,
)
from eavit_tpu_torch.models.layers import Dense, NoisyLinear, Rng, compute_dtype
from eavit_tpu_torch.models.vit import DualTokenViT, DualTokenViTHG


class ActionSpaceType(str, Enum):
    DISCRETE = "discrete"
    CONTINUOUS = "continuous"


class PolicyOutput(NamedTuple):
    policy: torch.Tensor  # [B, A] logits (discrete) or tanh mean (continuous)
    std: Optional[torch.Tensor]  # [A] (continuous only)
    value_ext: torch.Tensor  # [B, 1]
    value_int: torch.Tensor  # [B, 1]
    features: torch.Tensor  # [B, D] aggregated backbone features


def build_backbone(cfg: Config) -> nn.Module:
    """The backbone ``cfg`` names (policy.py:55-83)."""
    routes = dict(attention_route=attention_route(cfg), ffn_route=ffn_route(cfg),
                  shared_patch_stream=cfg.shared_patch_stream,
                  dtype=compute_dtype(cfg.compute_dtype), remat=cfg.encoder_remat)
    if cfg.vit_implementation_type == ViTImplementation.LUCIDRAINS:
        return DualTokenViT(cfg.vit, image_size=cfg.pre_proc_height,
                            channels=cfg.state_stack_size, **routes)
    return DualTokenViTHG(cfg.vit_hg,
                          image_size=cfg.vit_hg.image_size or cfg.pre_proc_height,
                          channels=cfg.vit_hg.num_channels or cfg.state_stack_size,
                          **routes)


class ActorCritic(nn.Module):
    """Backbone + heads (policy.py:86-185)."""

    def __init__(self, cfg: Config, output_size: int,
                 action_space: ActionSpaceType = ActionSpaceType.DISCRETE) -> None:
        super().__init__()
        self.action_space = ActionSpaceType(action_space)
        self.noisy = cfg.use_noisy_net
        dim = cfg.backbone_dim
        dt = compute_dtype(cfg.compute_dtype)
        self.feature = build_backbone(cfg)

        def head(n_in, n_out, gain):
            if self.noisy:
                return NoisyLinear(n_in, n_out)
            return Dense(n_in, n_out, dtype=dt, init=("orthogonal", gain))

        self.actor_fc1 = head(dim, dim, 0.01)
        self.actor_fc2 = head(dim, output_size, 0.01)
        self.extra_fc = head(dim, dim, 0.1)
        self.critic_ext = head(dim, 1, 0.01)
        self.critic_int = head(dim, 1, 0.01)
        if self.action_space == ActionSpaceType.CONTINUOUS:
            self.log_std = nn.Parameter(torch.full((output_size,), -0.5))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        if self.action_space == ActionSpaceType.CONTINUOUS:
            self.log_std.fill_(-0.5)

    def _head(self, layer, x: torch.Tensor, rng: Optional[Rng]) -> torch.Tensor:
        return layer(x, rng) if self.noisy else layer(x)

    def _critic(self, layer, x: torch.Tensor, rng: Optional[Rng]) -> torch.Tensor:
        resid = torch.relu(self._head(self.extra_fc, x, rng)) + x
        return self._head(layer, resid, rng).float()

    def forward(self, state: torch.Tensor, rng: Optional[Rng] = None) -> PolicyOutput:
        feats = self.feature(state, rng)
        if len(feats) == 2:
            x_explore, x_exploit = feats
            value_int = self._critic(self.critic_int, x_explore, rng)
            value_ext = self._critic(self.critic_ext, x_exploit, rng)
            x_comb = 0.5 * (x_explore + x_exploit)  # the "mean" aggregation
        else:
            (x_comb,) = feats
            value_int = self._critic(self.critic_int, x_comb, rng)
            value_ext = self._critic(self.critic_ext, x_comb, rng)
        policy = self._head(self.actor_fc2,
                            torch.relu(self._head(self.actor_fc1, x_comb, rng)), rng)
        std = None
        if self.action_space == ActionSpaceType.CONTINUOUS:
            policy = torch.tanh(policy)
            std = torch.exp(self.log_std)
        return PolicyOutput(policy=policy.float(), std=std, value_ext=value_ext,
                            value_int=value_int, features=x_comb.float())

    def extract_features(self, state: torch.Tensor) -> torch.Tensor:
        """Aggregated backbone embedding, deterministic (policy.py:174-185)."""
        feats = self.feature(state, None)
        if len(feats) == 2:
            return (0.5 * (feats[0] + feats[1])).float()
        return feats[0].float()
