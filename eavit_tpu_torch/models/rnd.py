"""Random Network Distillation predictor/target pair.

Counterpart of ``eavit_tpu/models/rnd.py`` (lines 1-134; reference
model.py:357-461):

Two trunks, chosen by ``pixel_input`` as in rnd.py:82-110:

- ``original_RND``: a conv trunk over the last raw frame [B, 1, 84, 84] --
  8x8/4, 4x4/2, 3x3/1 convs with LeakyReLU(0.01) -- flattened in NHWC order
  (H*W*C, as ``ConvTrunk`` does at rnd.py:61-65, so the head weights of the
  JAX tree load unpermuted);
- ``modified_RND``: an MLP trunk over the backbone embedding [B, D] --
  64 -> 128 -> 256 with LeakyReLU(0.01) (rnd.py:68-79).

Then a 3-layer 512 MLP predictor against a single-linear target.

All weights orthogonal(sqrt(2)) with zero biases, all float32. The
intrinsic reward is the feature-mean squared error (rnd.py:112-116); the
predictor's loss is the same error over a random ``UpdateProportion`` of the
samples (rnd.py:119-134).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from eavit_tpu_torch.models.layers import Conv, Dense

_GAIN = math.sqrt(2)


def _dense(n_in: int, n_out: int) -> Dense:
    return Dense(n_in, n_out, init=("orthogonal", _GAIN))


class ConvTrunk(nn.Module):
    """[B, 1, H, W] -> [B, 7*7*64] at H=W=84, NHWC flatten order."""

    def __init__(self, height: int, width: int) -> None:
        super().__init__()
        self.conv1 = Conv(1, 32, 8, 4, _GAIN)
        self.conv2 = Conv(32, 64, 4, 2, _GAIN)
        self.conv3 = Conv(64, 64, 3, 1, _GAIN)
        h, w = height, width
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = (h - k) // s + 1, (w - k) // s + 1
        self.out_features = h * w * 64

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = F.leaky_relu(self.conv1(x), 0.01)
        x = F.leaky_relu(self.conv2(x), 0.01)
        x = F.leaky_relu(self.conv3(x), 0.01)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class MlpTrunk(nn.Module):
    """[B, D] -> [B, 256]: fc1-fc3 with LeakyReLU(0.01), float32."""

    def __init__(self, in_features: int) -> None:
        super().__init__()
        self.fc1 = _dense(in_features, 64)
        self.fc2 = _dense(64, 128)
        self.fc3 = _dense(128, 256)
        self.out_features = 256

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for fc in (self.fc1, self.fc2, self.fc3):
            x = F.leaky_relu(fc(x), 0.01)
        return x


def _trunk(pixel_input: bool, in_shape) -> nn.Module:
    """``in_shape`` is ``(H, W)`` of the frame for the conv trunk, ``(D,)``
    of the embedding for the MLP trunk."""
    return ConvTrunk(*in_shape) if pixel_input else MlpTrunk(*in_shape)


class RNDPredictor(nn.Module):
    """Trainable predictor: trunk -> 3-layer 512 MLP head (rnd.py:82-95)."""

    def __init__(self, in_shape, pixel_input: bool = True, output_size: int = 512) -> None:
        super().__init__()
        self.trunk = _trunk(pixel_input, in_shape)
        self.head1 = _dense(self.trunk.out_features, output_size)
        self.head2 = _dense(output_size, output_size)
        self.head3 = _dense(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.head1(self.trunk(x)))
        h = torch.relu(self.head2(h))
        return self.head3(h).float()


class RNDTarget(nn.Module):
    """Frozen random target: trunk -> single linear (rnd.py:98-109)."""

    def __init__(self, in_shape, pixel_input: bool = True, output_size: int = 512) -> None:
        super().__init__()
        self.trunk = _trunk(pixel_input, in_shape)
        self.head = _dense(self.trunk.out_features, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x)).float()


def intrinsic_reward(target_feat: torch.Tensor, pred_feat: torch.Tensor) -> torch.Tensor:
    """[B, F] x2 -> [B]; MSE over the feature dim (reference agents.py:216)."""
    return torch.mean(torch.square(target_feat - pred_feat), dim=-1)


def rnd_loss(target_feat: torch.Tensor, pred_feat: torch.Tensor,
             mask_uniform: torch.Tensor, update_proportion: float) -> torch.Tensor:
    """Masked predictor MSE (reference agents.py:331-338): samples with
    ``mask_uniform < update_proportion`` contribute and the sum is divided
    by ``max(num_selected, 1)``. The target is detached."""
    per_sample = torch.mean(torch.square(pred_feat - target_feat.detach()), dim=-1)
    mask = (mask_uniform < update_proportion).float()
    return (per_sample * mask).sum() / torch.clamp(mask.sum(), min=1.0)
