"""Running normalisation statistics as small immutable states of tensors.

Counterpart of ``eavit_tpu/rl/normalizer.py`` (lines 1-140; reference
utils.py:70-128): the Chan et al. parallel-moments ``RunningMeanStd`` and
the discounted ``RewardForwardFilter``. Functions return new states and
never modify their inputs; counts are float32 as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from eavit_tpu_torch.parallel import dp


class RMSState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # float32 scalar, epsilon-initialised


def rms_init(shape: Sequence[int] = (), epsilon: float = 1e-4, device=None) -> RMSState:
    return RMSState(
        mean=torch.zeros(tuple(shape), dtype=torch.float32, device=device),
        var=torch.ones(tuple(shape), dtype=torch.float32, device=device),
        count=torch.tensor(epsilon, dtype=torch.float32, device=device),
    )


def rms_update_from_moments(state: RMSState, batch_mean, batch_var,
                            batch_count) -> RMSState:
    """Parallel-moments merge (reference utils.py:102-115)."""
    batch_count = torch.as_tensor(batch_count, dtype=torch.float32,
                                  device=state.count.device)
    delta = batch_mean - state.mean
    tot_count = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot_count
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + torch.square(delta) * state.count * batch_count / tot_count
    return RMSState(mean=new_mean, var=m2 / tot_count, count=tot_count)


def rms_update(state: RMSState, x: torch.Tensor, group=None) -> RMSState:
    """Fold a batch (moments over axis 0) into the statistics; the state's
    shape decides the reduction, as in normalizer.py:54-94. With a process
    ``group`` the batch is every rank's together: ``sum``, ``sumsq`` and
    ``count`` are summed over the ranks (``parallel/dp.pooled_moments``;
    normalizer.py:87-90), so every rank folds in the same moments."""
    x = x.float()
    if x.dim() == state.mean.dim() + 1:
        batch_sum = x.sum(dim=0)
        batch_sumsq = torch.square(x).sum(dim=0)
    elif x.dim() == state.mean.dim() and tuple(state.mean.shape[:1]) == (1,):
        batch_sum = x.sum(dim=0, keepdim=True)
        batch_sumsq = torch.square(x).sum(dim=0, keepdim=True)
    else:
        raise ValueError(
            f"cannot reduce batch of shape {tuple(x.shape)} into RMS of shape "
            f"{tuple(state.mean.shape)}")
    n = float(x.shape[0])
    if group is not None:
        return rms_update_from_moments(state, *dp.pooled_moments(batch_sum, batch_sumsq, n,
                                                                 group))
    batch_mean = batch_sum / n
    batch_var = batch_sumsq / n - torch.square(batch_mean)
    return rms_update_from_moments(state, batch_mean, batch_var, n)


def rms_normalize(state: RMSState, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    """``((x - mean) / sqrt(var)).clip(-clip, clip)`` (reference train.py:665)."""
    return torch.clamp((x.float() - state.mean) / torch.sqrt(state.var), -clip, clip)


class RewardFilterState(NamedTuple):
    rewems: torch.Tensor  # [N]


def reward_filter_init(num_env: int, device=None) -> RewardFilterState:
    return RewardFilterState(rewems=torch.zeros(num_env, dtype=torch.float32,
                                                device=device))


def reward_filter_scan(state: RewardFilterState, int_reward: torch.Tensor,
                       gamma: float) -> Tuple[RewardFilterState, torch.Tensor]:
    """Run the filter over a rollout ``[N, T]``; returns the new state and the
    per-step filtered returns ``[T, N]`` (normalizer.py:126-140)."""
    rewems = state.rewems
    rows = []
    for r_t in int_reward.float().T:
        rewems = rewems * gamma + r_t
        rows.append(rewems)
    return RewardFilterState(rewems=rewems), torch.stack(rows)
