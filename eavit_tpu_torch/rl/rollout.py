"""Host-side rollout collection feeding the agent on the device.

Counterpart of ``eavit_tpu/rl/rollout.py`` (lines 1-190; reference
train.py:604-704): a vectorised env pool stepped on the host and one
``act`` call per step. Frames stay uint8 on the host; the per-step values
and logits (log-probs for continuous actions) stay on the device and only
the actions come back. The rollout moves to the device once, at the end.
``train`` runs ``rl/device_rollout.DeviceRolloutCollector``, which keeps the
frame stack on the device too and builds on this class; this one stays for
the callers that step frames on the host (``chip_smoke.py``'s comparisons,
tests).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from eavit_tpu_torch.config import Config, TrainMethod
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import AgentState, RNDAgent, Rollout
from eavit_tpu_torch.utils.trace import span


class EpisodeStats:
    """Rolling episode bookkeeping with its checkpoint snapshot
    (rollout.py:22-80; reference train.py:570-578, 651-654)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.returns: List[float] = []
        self.lengths: List[int] = []
        self.rooms_per_episode: List[int] = []
        self.total_visited_rooms: set = set()
        self.num_episodes = 0

    def add(self, info: Dict[str, Any]) -> None:
        ep = info.get("episode")
        if not ep:
            return
        self.num_episodes += 1
        self.returns.append(float(ep["r"]))
        self.lengths.append(int(ep["l"]))
        rooms = ep.get("visited_rooms")
        if rooms is not None:
            self.rooms_per_episode.append(len(rooms))
            self.total_visited_rooms |= set(rooms)
        self.returns = self.returns[-self.window:]
        self.lengths = self.lengths[-self.window:]
        self.rooms_per_episode = self.rooms_per_episode[-self.window:]

    def to_state(self) -> Dict[str, Any]:
        """Serializable snapshot (checkpointed like the reference's metric
        deques and room sets, train.py:926-956)."""
        return {
            "returns": list(self.returns),
            "lengths": list(self.lengths),
            "rooms_per_episode": list(self.rooms_per_episode),
            "total_visited_rooms": sorted(self.total_visited_rooms),
            "num_episodes": self.num_episodes,
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.returns = [float(x) for x in state.get("returns", [])]
        self.lengths = [int(x) for x in state.get("lengths", [])]
        self.rooms_per_episode = [int(x) for x in state.get("rooms_per_episode", [])]
        self.total_visited_rooms = set(state.get("total_visited_rooms", []))
        self.num_episodes = int(state.get("num_episodes", 0))

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"data/num_episodes": float(self.num_episodes)}
        if self.returns:
            out["data/mean_undiscounted_episode_return"] = float(np.mean(self.returns))
            out["data/mean_episode_length"] = float(np.mean(self.lengths))
        if self.rooms_per_episode:
            out["data/mean_number_of_visited_rooms"] = float(
                np.mean(self.rooms_per_episode))
            out["data/total_number_of_visited_rooms"] = float(
                len(self.total_visited_rooms))
        return out


class RolloutCollector:
    """Collects rollouts with ``agent`` on its device (CUDA unless the
    agent was built with ``device="cpu"``). A ``renderer``
    (``utils/renderer.py``) shows the last frame of every env after each
    step (reference train.py:693-698)."""

    def __init__(self, cfg: Config, agent: RNDAgent, env: Any, renderer: Any = None):
        self.cfg = cfg
        self.agent = agent
        self.env = env
        self.renderer = renderer
        self.stats = EpisodeStats()
        self._pixel_rnd = cfg.train_method == TrainMethod.ORIGINAL_RND

    def _next_obs_of(self, states: np.ndarray) -> np.ndarray:
        """RND observation source: last frame (original) or the full stack
        (modified) -- reference train.py:636-641."""
        if self._pixel_rnd:
            return states[:, -1:, :, :]
        return states

    def warmup_obs_rms(
        self, state: AgentState, states_u8: np.ndarray, rng: Rng
    ) -> Tuple[AgentState, np.ndarray]:
        """``ObsNormStep`` batches of ``NumStep`` random steps folded into
        obs_rms (rollout.py:98-123; reference train.py:502-569)."""
        cfg = self.cfg
        if not self.agent.use_rnd or cfg.load_model:
            return state, states_u8
        # random actions from a numpy generator seeded off the host stream,
        # the env's own sampler where it has one (continuous Box bounds)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng.host))
        rng_np = np.random.default_rng(seed)

        def random_actions():
            if hasattr(self.env, "sample_random_actions"):
                return self.env.sample_random_actions(rng_np)
            return rng_np.integers(0, self.env.action_space_n, size=self.env.num_envs)

        for _ in range(cfg.obs_norm_step):
            batch = []
            for _ in range(cfg.num_step):
                states_u8, _, _, _, _ = self.env.step(random_actions())
                batch.append(self._next_obs_of(states_u8))
            state = self.agent.update_obs_rms(state, np.concatenate(batch))
        return state, states_u8

    def collect(self, states_u8: np.ndarray, rng: Rng) -> Tuple[Rollout, np.ndarray]:
        """One n-step rollout (rollout.py:125-190). Returns the time-major
        Rollout on the agent's device and the final host states."""
        with span("eavit.collect"):
            T, N = self.cfg.num_step, self.env.num_envs
            dev = self.agent.device
            states_buf = np.empty((T, N) + states_u8.shape[1:], np.uint8)
            next_obs_buf = np.empty((T, N) + self._next_obs_of(states_u8).shape[1:], np.uint8)
            rewards_buf = np.empty((T, N), np.float32)
            dones_buf = np.empty((T, N), np.bool_)
            A = self.agent.output_size
            if self.agent.discrete:
                actions_dev = torch.empty((T, N), dtype=torch.int64, device=dev)
                policy_dev = torch.empty((T, N, A), dtype=torch.float32, device=dev)
            else:  # actions [T, N, A] and their log-probs (rollout.py:144-149)
                actions_dev = torch.empty((T, N, A), dtype=torch.float32, device=dev)
                policy_dev = torch.empty((T, N, 1), dtype=torch.float32, device=dev)
            value_ext_dev = torch.empty((T + 1, N), dtype=torch.float32, device=dev)
            value_int_dev = torch.empty((T + 1, N), dtype=torch.float32, device=dev)

            for t in range(T):
                with span("eavit.act"):
                    actions, v_ext, v_int, policy = self.agent.act(states_u8, rng)
                    states_buf[t] = states_u8
                    actions_dev[t] = actions
                    value_ext_dev[t] = v_ext
                    value_int_dev[t] = v_int
                    policy_dev[t] = policy
                with span("eavit.act_sync"):
                    actions = actions.cpu().numpy()
                with span("eavit.env_step"):
                    states_u8, rewards, dones, _truns, infos = self.env.step(actions)
                    rewards_buf[t] = rewards
                    dones_buf[t] = dones
                    next_obs_buf[t] = self._next_obs_of(states_u8)
                    for info in infos:
                        self.stats.add(info)
                if self.renderer is not None:
                    self.renderer.render(states_u8[:, -1:])

            # bootstrap value (reference train.py:701-704)
            with span("eavit.act"):
                _, v_ext, v_int, _ = self.agent.act(states_u8, rng)
                value_ext_dev[T] = v_ext
                value_int_dev[T] = v_int

            rollout = Rollout(
                states=torch.from_numpy(states_buf).to(dev),
                actions=actions_dev,
                rewards=torch.from_numpy(rewards_buf).to(dev),
                dones=torch.from_numpy(dones_buf).to(dev),
                next_obs=torch.from_numpy(next_obs_buf).to(dev),
                value_ext=value_ext_dev,
                value_int=value_int_dev,
                policy=policy_dev,
            )
            return rollout, states_u8
