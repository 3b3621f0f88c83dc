"""The standalone SSL pretraining phase.

Counterpart of ``eavit_tpu/rl/ssl_pretrain.py:22-102`` (reference
train.py:292-499). Its own ``torch.optim.Adam`` (lr ``LearningRate``, eps
1e-8, no clipping) steps the backbone ``feature`` and the online SSL
parameters: a second optimizer over the same ``Parameter`` objects as the
agent's, whose state it leaves untouched (the reference builds a dedicated
``SSL_optimizer``, train.py:334). Each epoch (:meth:`SSLPretrainer.epoch`):

- a permutation of the training frames, cut to ``max(1, m // batch_size)``
  minibatches, each an Adam step on the SSL loss followed by an EMA step;
- an evaluation pass without gradients over consecutive slices of the
  held-out frames;
- both mean losses.

The permutation comes from :meth:`SSLPretrainer._permutation` and each
minibatch's augment parameters from the agent's ``_augment_params``, so a
test can hand in the JAX draws. Under the agent's process group the
gradients are averaged over the ranks before each step, as the update's
are, so the replicas stay equal; ``eavit_tpu`` pretrains on its unsharded
agent (``eavit_tpu/train.py:258-270``) and has no such step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eavit_tpu_torch.config import Config
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.parallel import dp
from eavit_tpu_torch.rl.agent import RNDAgent


class SSLPretrainer:
    def __init__(self, cfg: Config, agent: RNDAgent):
        if agent.ssl is None:
            raise ValueError("SSL pretraining needs a representation learning method")
        self.cfg = cfg
        self.agent = agent
        self.params = list(agent.network.feature.parameters()) + list(agent.ssl.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=cfg.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def _permutation(self, rng: Rng, m: int) -> torch.Tensor:
        """One epoch's frame order, drawn on the agent's device."""
        return torch.randperm(m, generator=rng.device, device=self.agent.device)

    def _loss(self, frames_u8: torch.Tensor, rng: Rng) -> torch.Tensor:
        agent = self.agent
        views = agent._augment_params(rng, frames_u8.shape[0])
        return agent.ssl.loss(agent.network.feature, agent.ssl_target, frames_u8, views)

    def epoch(self, train_u8: torch.Tensor, eval_u8: torch.Tensor,
              rng: Rng) -> Tuple[torch.Tensor, torch.Tensor]:
        """One pass over ``train_u8`` and an evaluation over ``eval_u8``
        ([M, C, H, W] uint8 on the agent's device); returns the mean training
        and evaluation losses (0-dim tensors)."""
        agent = self.agent
        batch_size = self.cfg.batch_size
        num_batches = max(1, train_u8.shape[0] // batch_size)
        perm = self._permutation(rng, train_u8.shape[0])[: num_batches * batch_size]
        losses = []
        for idx in perm.reshape(num_batches, batch_size):
            for p in self.params:
                p.grad = None
            loss = self._loss(train_u8[idx], rng)
            loss.backward()
            for p in self.params:  # as optax: a parameter not reached gets zeros
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            dp.all_reduce_mean_([p.grad for p in self.params], agent.process_group)
            self.optimizer.step()
            agent.ssl.update_target(agent.ssl_target, agent.network.feature)
            losses.append(loss.detach())
        with torch.no_grad():
            num_eval = max(1, eval_u8.shape[0] // batch_size)
            eval_losses = [self._loss(eval_u8[i * batch_size:(i + 1) * batch_size], rng)
                           for i in range(num_eval)]
        for p in self.params:
            p.grad = None
        return torch.stack(losses).mean(), torch.stack(eval_losses).mean()
