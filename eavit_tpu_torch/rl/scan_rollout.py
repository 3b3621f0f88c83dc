"""The zero-host rollout: act + env step + buffering on the agent's device.

Counterpart of ``eavit_tpu/rl/scan_rollout.py`` (lines 29-216). The JAX
package compiles the rollout into one ``lax.scan``; here it is a Python loop
over ``NumStep`` steps whose every operation is queued on the device: the
policy forward (``RNDAgent.act``, dropout live, its kernel seed words drawn
on the host from ``Rng.host``; under ``UseNoisyNet`` the heads' noise drawn
from ``Rng.device``), the sampled actions, the env step of
``envs/device_env.py`` and the writes into buffers allocated once per
rollout. Nothing in the loop reads a device value back, so the host only
queues work and the card never waits for it.

Under the agent's process group (its ``mesh`` branch, lines 60-137) every
rank builds the one fleet of ``NumEnvPerProcess`` envs from ``cfg.seed``
and steps its slice ``[r * n / W, (r + 1) * n / W)`` (:meth:`shard_env_state`);
a shared world stays whole. The rollout metrics are pooled as there:
``num_episodes`` summed over the ranks, ``total_rooms_discovered`` counted on
the union of every rank's ever-visited rooms, the rest averaged. Each rank
acts from its own ``Rng`` stream (``train`` seeds it with
``parallel/dp.rank_seed``, JAX's ``fold_in(rng, axis_index)``).
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
from eavit_tpu_torch.parallel import dp
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from eavit_tpu_torch.utils.trace import span


class ScanRolloutCollector:
    """Rollouts of ``agent`` over the device env ``env_params`` (the env
    state is a tuple of tensors on the agent's device); under the agent's
    process group over this rank's slice of the fleet, whose per-env worlds
    it keeps."""

    def __init__(self, cfg: Config, agent: RNDAgent, env_params: DeviceEnvParams):
        self.cfg = cfg
        self.agent = agent
        self.group = agent.process_group
        n = cfg.num_env_per_process
        self._lo, self._hi = dp.env_slice(n, self.group)
        if self.group is not None and env_params.frames.shape[0] == n:
            world = slice(self._lo, self._hi)
            env_params = env_params._replace(
                frames=env_params.frames[world], walls=env_params.walls[world],
                goal_rooms=None if env_params.goal_rooms is None
                else env_params.goal_rooms[world])
        self.env_params = env_params
        self._pixel_rnd = cfg.train_method == TrainMethod.ORIGINAL_RND

    def shard_env_state(self, env_state: DeviceEnvState) -> DeviceEnvState:
        """This rank's envs of the whole fleet's state (all of it without a
        process group)."""
        if self.group is None:
            return env_state
        return DeviceEnvState(*(t[self._lo:self._hi] for t in env_state))

    def collect(
        self, env_state: DeviceEnvState, rng: Rng
    ) -> Tuple[Rollout, DeviceEnvState, Dict[str, torch.Tensor]]:
        """One ``NumStep`` rollout: the time-major ``Rollout`` that
        ``RolloutCollector.collect`` returns, the env state after it and the
        episode metrics as 0-d tensors on the device (``scan_rollout.py:
        196-215``, under the same names)."""
        with span("eavit.collect"):
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
            policy = torch.empty((T, n, self.agent.output_size), dtype=torch.float32,
                                 device=dev)
            value_ext = torch.empty((T + 1, n), dtype=torch.float32, device=dev)
            value_int = torch.empty((T + 1, n), dtype=torch.float32, device=dev)

            for t in range(T):
                with span("eavit.act"):
                    stack = env_state.stack
                    action, v_ext, v_int, logits = self.agent.act(stack, rng)
                    states[t] = stack
                    actions[t] = action
                    value_ext[t] = v_ext
                    value_int[t] = v_int
                    policy[t] = logits
                with span("eavit.env_step"):
                    env_state, reward, done, _ = device_env_step(self.env_params, env_state,
                                                                 action)
                    rewards[t] = reward
                    dones[t] = done
                    next_obs[t] = env_state.stack[:, -1:] if self._pixel_rnd \
                        else env_state.stack

            # bootstrap value (reference train.py:701-704)
            with span("eavit.act"):
                _, v_ext, v_int, _ = self.agent.act(env_state.stack, rng)
                value_ext[T] = v_ext
                value_int[T] = v_int

            rollout = Rollout(states=states, actions=actions, rewards=rewards, dones=dones,
                              next_obs=next_obs, value_ext=value_ext, value_int=value_int,
                              policy=policy)
            return rollout, env_state, episode_metrics(env_state, self.group)

def episode_metrics(env_state: DeviceEnvState, group=None) -> Dict[str, torch.Tensor]:
    """The device env's episode bookkeeping as 0-d float32 tensors, under
    ``eavit_tpu``'s names (``scan_rollout.py:196-215``), over every rank of
    ``group`` (``scan_rollout.py:89-105``)."""
    ever = env_state.ever_visited
    rooms = ever.any(dim=0).float()
    dp.all_reduce_max_(rooms, group)  # the union of every rank's rooms
    out = {
        "data/num_episodes": env_state.finished_episodes.sum().float(),
        "data/mean_undiscounted_episode_return": env_state.last_episode_return.mean(),
        "data/mean_number_of_visited_rooms": env_state.last_episode_rooms.float().mean(),
        # cumulative exploration: rooms ever visited (per-env mean and fleet
        # union), the monotone signal the per-episode metric cannot show
        "data/mean_rooms_discovered": ever.sum(dim=1).float().mean(),
        "data/total_rooms_discovered": rooms.sum(),
    }
    dp.psum_([out["data/num_episodes"]], group)
    dp.all_reduce_mean_([out[k] for k in ("data/mean_undiscounted_episode_return",
                                          "data/mean_number_of_visited_rooms",
                                          "data/mean_rooms_discovered")], group)
    return out
