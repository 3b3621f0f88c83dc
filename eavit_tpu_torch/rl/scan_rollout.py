"""The zero-host rollout: act + env step + buffering on the agent's device.

Counterpart of ``eavit_tpu/rl/scan_rollout.py`` (lines 29-216) without its
``mesh`` branch (data parallelism is ROADMAP.md Queue 1, item 9). The JAX
package compiles the rollout into one ``lax.scan``; here it is a Python loop
over ``NumStep`` steps whose every operation is queued on the device: the
policy forward (``RNDAgent.act``, dropout live, its kernel seed words drawn
on the host from ``Rng.host``; under ``UseNoisyNet`` the heads' noise drawn
from ``Rng.device``), the sampled actions, the env step of
``envs/device_env.py`` and the writes into buffers allocated once per
rollout. Nothing in the loop reads a device value back, so the host only
queues work and the card never waits for it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from eavit_tpu_torch.config import Config, TrainMethod
from eavit_tpu_torch.envs.device_env import (
    DeviceEnvParams,
    DeviceEnvState,
    device_env_step,
)
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout


class ScanRolloutCollector:
    """Rollouts of ``agent`` over the device env ``env_params`` (the env
    state is a tuple of tensors on the agent's device)."""

    def __init__(self, cfg: Config, agent: RNDAgent, env_params: DeviceEnvParams):
        self.cfg = cfg
        self.agent = agent
        self.env_params = env_params
        self._pixel_rnd = cfg.train_method == TrainMethod.ORIGINAL_RND

    def collect(
        self, env_state: DeviceEnvState, rng: Rng
    ) -> Tuple[Rollout, DeviceEnvState, Dict[str, torch.Tensor]]:
        """One ``NumStep`` rollout: the time-major ``Rollout`` that
        ``RolloutCollector.collect`` returns, the env state after it and the
        episode metrics as 0-d tensors on the device (``scan_rollout.py:
        196-215``, under the same names)."""
        T = self.cfg.num_step
        stack = env_state.stack
        n = stack.shape[0]
        dev = stack.device
        obs_shape = tuple(stack.shape[1:])
        next_shape = (1,) + obs_shape[1:] if self._pixel_rnd else obs_shape
        states = torch.empty((T, n) + obs_shape, dtype=torch.uint8, device=dev)
        next_obs = torch.empty((T, n) + next_shape, dtype=torch.uint8, device=dev)
        actions = torch.empty((T, n), dtype=torch.int64, device=dev)
        rewards = torch.empty((T, n), dtype=torch.float32, device=dev)
        dones = torch.empty((T, n), dtype=torch.bool, device=dev)
        policy = torch.empty((T, n, self.agent.output_size), dtype=torch.float32, device=dev)
        value_ext = torch.empty((T + 1, n), dtype=torch.float32, device=dev)
        value_int = torch.empty((T + 1, n), dtype=torch.float32, device=dev)

        for t in range(T):
            stack = env_state.stack
            action, v_ext, v_int, logits = self.agent.act(stack, rng)
            states[t] = stack
            actions[t] = action
            value_ext[t] = v_ext
            value_int[t] = v_int
            policy[t] = logits
            env_state, reward, done, _ = device_env_step(self.env_params, env_state, action)
            rewards[t] = reward
            dones[t] = done
            next_obs[t] = env_state.stack[:, -1:] if self._pixel_rnd else env_state.stack

        # bootstrap value (reference train.py:701-704)
        _, v_ext, v_int, _ = self.agent.act(env_state.stack, rng)
        value_ext[T] = v_ext
        value_int[T] = v_int

        rollout = Rollout(states=states, actions=actions, rewards=rewards, dones=dones,
                          next_obs=next_obs, value_ext=value_ext, value_int=value_int,
                          policy=policy)
        return rollout, env_state, episode_metrics(env_state)


def episode_metrics(env_state: DeviceEnvState) -> Dict[str, torch.Tensor]:
    """The device env's episode bookkeeping as 0-d float32 tensors, under
    ``eavit_tpu``'s names (``scan_rollout.py:196-215``)."""
    ever = env_state.ever_visited
    return {
        "data/num_episodes": env_state.finished_episodes.sum().float(),
        "data/mean_undiscounted_episode_return": env_state.last_episode_return.mean(),
        "data/mean_number_of_visited_rooms": env_state.last_episode_rooms.float().mean(),
        # cumulative exploration: rooms ever visited (per-env mean and fleet
        # union), the monotone signal the per-episode metric cannot show
        "data/mean_rooms_discovered": ever.sum(dim=1).float().mean(),
        "data/total_rooms_discovered": ever.any(dim=0).sum().float(),
    }
