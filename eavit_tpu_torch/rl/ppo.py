"""PPO loss math, the action distributions and sampling (counterpart of
``eavit_tpu/rl/ppo.py`` lines 25-123; reference agents.py:454-493).

Combined objective per minibatch (reference agents.py:493)::

    loss = actor_loss + 0.5 * critic_loss - ent_coef * entropy + rnd_loss

with ``actor_loss = -mean(min(ratio * adv, clip(ratio) * adv))``,
``critic_loss = MSE(v_ext, target_ext) + MSE(v_int, target_int)`` and the
diagnostics ``approx_kl`` / ``max_kl`` / ``clipfrac``. Continuous actions
use a diagonal Normal over the tanh mean with a learnt ``std``
(ppo.py:43-70; reference agents.py:197-203).
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple, Optional, Tuple

import torch


def categorical_log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a|s) from raw logits; [B, A], [B] -> [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, actions.long()[:, None])[:, 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of softmax(logits); [B, A] -> [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def sample_categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Sample one action per row from softmax(logits) with an explicit
    generator on the logits' device; [B, A] -> [B] int64.

    Gumbel-max in its exponential form, ``argmax(p / q)`` with ``q ~
    Exp(1)``, as ``jax.random.categorical`` samples: the same draws and the
    same result as ``torch.multinomial(p, 1)``, whose check of the
    distribution reads a device value back and so waits for the card."""
    probs = torch.softmax(logits.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return torch.argmax(probs / q, dim=-1)


def normal_log_prob(mu: torch.Tensor, std: torch.Tensor,
                    actions: torch.Tensor) -> torch.Tensor:
    """Sum of the per-dimension Normal log-probs; [B, A], [A], [B, A] -> [B]."""
    var = torch.square(std)
    logp = -0.5 * (torch.square(actions - mu) / var + torch.log(2 * math.pi * var))
    return logp.sum(dim=-1)


def normal_entropy(std: torch.Tensor, batch: int) -> torch.Tensor:
    """The MEAN over action dimensions of the Normal entropies, broadcast to
    ``[batch]``: the reference's bonus is ``m.entropy().mean()``
    (agents.py:462), which averages over the batch and the dimensions."""
    ent = torch.mean(0.5 * torch.log(2 * math.pi * math.e * torch.square(std)))
    return ent.expand(batch)


def sample_normal(mu: torch.Tensor, std: torch.Tensor,
                  gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mu + std * eps, its log-prob)`` with ``eps ~ N(0, 1)`` drawn from
    ``gen`` on ``mu``'s device; [B, A] -> [B, A], [B]."""
    a = mu + std * torch.randn(mu.shape, generator=gen, device=mu.device)
    return a, normal_log_prob(mu, std, a)


class PPOLossOut(NamedTuple):
    actor_loss: torch.Tensor
    critic_ext_loss: torch.Tensor
    critic_int_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    max_kl: torch.Tensor
    clipfrac: torch.Tensor


def ppo_surrogate(
    log_prob: torch.Tensor,  # [B]
    log_prob_old: torch.Tensor,  # [B]
    adv: torch.Tensor,  # [B]
    value_ext: torch.Tensor,  # [B, 1]
    target_ext: torch.Tensor,  # [B]
    entropy: torch.Tensor,  # [B]
    ppo_eps: float,
    value_int: Optional[torch.Tensor] = None,  # [B, 1]
    target_int: Optional[torch.Tensor] = None,  # [B]
) -> PPOLossOut:
    ratio = torch.exp(log_prob - log_prob_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - ppo_eps, 1.0 + ppo_eps) * adv
    actor_loss = -torch.minimum(surr1, surr2).mean()

    critic_ext_loss = torch.square(value_ext.sum(dim=1) - target_ext).mean()
    if value_int is not None and target_int is not None:
        critic_int_loss = torch.square(value_int.sum(dim=1) - target_int).mean()
    else:
        critic_int_loss = torch.zeros((), device=log_prob.device)

    kl = (log_prob_old - log_prob).detach()
    clipped = (ratio > 1.0 + ppo_eps) | (ratio < 1.0 - ppo_eps)
    return PPOLossOut(
        actor_loss=actor_loss,
        critic_ext_loss=critic_ext_loss,
        critic_int_loss=critic_int_loss,
        entropy=entropy.mean(),
        approx_kl=kl.mean(),
        max_kl=kl.max(),
        clipfrac=clipped.float().mean(),
    )


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squared elements) over all gradients (reference
    utils.py:141-170), a float32 scalar on the gradients' device."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: gradients are scaled by
    ``max_norm / norm`` only when ``norm >= max_norm`` (no epsilon in the
    divisor, unlike ``torch.nn.utils.clip_grad_norm_``). No host sync."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
