"""Gymnasium wrapper stack with the reference's preprocessing (the port's
own copy of ``eavit_tpu/envs/wrappers.py``; reference envs.py:63-245,
464-486, 582-623).

Stack order for Atari (reference envs.py:272-284):
StickyAction -> MaxAndSkip(4) -> ResizeAndGrayScale(84x84) -> FrameStack(4)
-> MaxStepPerEpisode -> Monitor -> MontezumaInfo.

Divergences from the reference (documented):
- Frames flow as uint8, not float64 (the reference pickles float64 frames
  over pipes -- 8x the bytes for identical values, envs.py:153). Values are
  the same 0..255 grayscale levels.
- ``FrameStackWrapper.observation_space`` correctly declares (stack, H, W);
  the reference declares (H, W, C) but emits (C, H, W) (envs.py:153-163).
- cv2.resize receives (width, height) in the correct order (the reference
  passes (h, w), benign only because 84 == 84, envs.py:218).

gymnasium and cv2 are imported when this module is, if they are there:
without gymnasium the module still imports (the GPU machine has none) and
building a wrapper raises ``ImportError``; without cv2 the resize falls back
to nearest-neighbour sampling.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Any, Dict, Set

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:  # pragma: no cover - exercised on machines without it

    class _NoGymnasium:
        def __init__(self, *args, **kwargs):
            raise ImportError("the env wrappers need gymnasium, which is not installed")

    gym = SimpleNamespace(Wrapper=_NoGymnasium, ActionWrapper=_NoGymnasium,
                          ObservationWrapper=_NoGymnasium)
    spaces = None

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class StickyActionWrapper(gym.Wrapper):
    """Repeat the previous action with probability p (reference
    envs.py:172-189); per-env RNG seeded at construction."""

    def __init__(self, env, p: float = 0.25, seed: int = 0):
        super().__init__(env)
        self.p = p
        self.last_action = 0
        self.rng = np.random.default_rng(seed)

    def reset(self, **kw):
        self.last_action = 0
        return self.env.reset(**kw)

    def step(self, action):
        if self.rng.random() <= self.p:
            action = self.last_action
        self.last_action = action
        return self.env.step(action)


class MaxAndSkipWrapper(gym.Wrapper):
    """Repeat each action ``skip`` times; observation is the pixelwise max
    of the last two frames (reference envs.py:63-123)."""

    def __init__(self, env, skip: int = 4):
        super().__init__(env)
        self._skip = skip
        self._obs_buffer = np.zeros((2,) + env.observation_space.shape, np.uint8)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        self._obs_buffer[0] = obs
        self._obs_buffer[1] = obs
        return obs, info

    def step(self, action):
        total_reward = 0.0
        terminated = truncated = False
        info: Dict[str, Any] = {}
        for i in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += float(reward)
            if terminated or truncated:
                break
        max_frame = self._obs_buffer.max(axis=0)
        return max_frame, total_reward, terminated, truncated, info


class ResizeAndGrayScaleWrapper(gym.ObservationWrapper):
    """RGB -> ITU-R 601-2 luma grayscale -> (w, h) resize, uint8
    (reference envs.py:191-219 uses PIL convert('L') + cv2.resize)."""

    def __init__(self, env, height: int = 84, width: int = 84):
        super().__init__(env)
        self.h, self.w = height, width
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(height, width), dtype=np.uint8
        )

    def observation(self, frame):
        frame = np.asarray(frame)
        if frame.ndim == 3:
            # PIL 'L' luma coefficients
            frame = (
                frame[..., 0] * 0.299 + frame[..., 1] * 0.587 + frame[..., 2] * 0.114
            )
        frame = frame.astype(np.float32)
        if cv2 is not None:
            frame = cv2.resize(frame, (self.w, self.h), interpolation=cv2.INTER_LINEAR)
        else:  # pragma: no cover
            ys = np.linspace(0, frame.shape[0] - 1, self.h).astype(int)
            xs = np.linspace(0, frame.shape[1] - 1, self.w).astype(int)
            frame = frame[ys][:, xs]
        return np.clip(frame, 0, 255).astype(np.uint8)


class FrameStackWrapper(gym.Wrapper):
    """Rolling stack of the last ``stack`` frames as channels
    (reference envs.py:148-169); reset fills every slot with the reset
    frame (envs.py:166-169)."""

    def __init__(self, env, stack: int = 4):
        super().__init__(env)
        self.stack = stack
        h, w = env.observation_space.shape
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(stack, h, w), dtype=np.uint8
        )
        self.history = np.zeros((stack, h, w), np.uint8)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        self.history[:] = obs[None]
        return self.history.copy(), info

    def step(self, action):
        obs, r, d, t, info = self.env.step(action)
        self.history[:-1] = self.history[1:]
        self.history[-1] = obs
        return self.history.copy(), r, d, t, info


class MaxStepPerEpisodeWrapper(gym.Wrapper):
    """Truncate episodes at ``max_step`` (reference envs.py:126-146)."""

    def __init__(self, env, max_step: int):
        super().__init__(env)
        self.max_step = max_step
        self.steps = 0

    def reset(self, **kw):
        self.steps = 0
        return self.env.reset(**kw)

    def step(self, action):
        obs, r, d, t, info = self.env.step(action)
        self.steps += 1
        if self.steps >= self.max_step:
            t = True
        return obs, r, d, t, info


class MonitorWrapper(gym.Wrapper):
    """Episode return/length/time bookkeeping (reference envs.py:582-623);
    attaches an ``info['episode']`` dict at episode end like gym's Monitor."""

    def __init__(self, env):
        super().__init__(env)
        self.rewards: list = []
        self.t0 = time.time()
        self.num_episodes = 0

    def reset(self, **kw):
        self.rewards = []
        return self.env.reset(**kw)

    def step(self, action):
        obs, r, d, t, info = self.env.step(action)
        self.rewards.append(float(r))
        if d or t:
            self.num_episodes += 1
            info = dict(info)
            ep = info.get("episode", {})
            ep = dict(ep)
            ep.update(
                r=sum(self.rewards),
                l=len(self.rewards),
                t=round(time.time() - self.t0, 6),
                num_finished_episodes=self.num_episodes,
            )
            info["episode"] = ep
        return obs, r, d, t, info


class MontezumaInfoWrapper(gym.Wrapper):
    """Track visited rooms from Atari RAM address 3
    (reference envs.py:222-245)."""

    def __init__(self, env, room_address: int = 3):
        super().__init__(env)
        self.room_address = room_address
        self.visited_rooms: Set[int] = set()

    def _room(self) -> int:
        ram = self.env.unwrapped.ale.getRAM()
        return int(ram[self.room_address])

    def reset(self, **kw):
        out = self.env.reset(**kw)
        self.visited_rooms = {self._room()}
        return out

    def step(self, action):
        obs, r, d, t, info = self.env.step(action)
        self.visited_rooms.add(self._room())
        info = dict(info)
        info["visited_rooms"] = set(self.visited_rooms)
        if (d or t) and "episode" in info:
            info["episode"] = dict(info["episode"])
            info["episode"]["visited_rooms"] = set(self.visited_rooms)
            info["episode"]["number_of_visited_rooms"] = len(self.visited_rooms)
        return obs, r, d, t, info


class RGBArrayAsObservationWrapper(gym.Wrapper):
    """Classic-control: use the rendered rgb_array as the observation
    (reference envs.py:464-486)."""

    def __init__(self, env):
        super().__init__(env)
        frame = self._render()
        self.observation_space = spaces.Box(
            low=0, high=255, shape=frame.shape, dtype=np.uint8
        )

    def _render(self) -> np.ndarray:
        frame = self.env.render()
        return np.asarray(frame, dtype=np.uint8)

    def reset(self, **kw):
        self.env.reset(**kw)
        return self._render(), {}

    def step(self, action):
        _, r, d, t, info = self.env.step(action)
        return self._render(), r, d, t, info


class MarioRewardWrapper(gym.Wrapper):
    """Super Mario Bros reward shaping: reward/15, optional life-done
    (reference envs.py:377-431)."""

    def __init__(self, env, life_done: bool = False):
        super().__init__(env)
        self.life_done = life_done
        self.lives = None

    def reset(self, **kw):
        self.lives = None
        return self.env.reset(**kw)

    def step(self, action):
        obs, r, d, t, info = self.env.step(action)
        if self.life_done and "life" in info:
            if self.lives is not None and info["life"] < self.lives:
                d = True
            self.lives = info["life"]
        return obs, float(r) / 15.0, d, t, info


class ActionScaleWrapper(gym.ActionWrapper):
    """Affine-map policy actions from [-1, 1] to the env's Box bounds.

    The continuous policy head emits tanh-mu in [-1, 1] (reference
    model.py:226-238) and the reference never rescales -- it only ever ran
    discrete envs. For Box envs with other bounds (Pendulum-v1 torque is
    [-2, 2]) the canonical continuous-control idiom applies: declare the
    agent-facing action space as [-1, 1]^d and rescale on the way in."""

    def __init__(self, env):
        super().__init__(env)
        box = env.action_space
        self.low = np.asarray(box.low, np.float32)
        self.high = np.asarray(box.high, np.float32)
        self.action_space = spaces.Box(-1.0, 1.0, box.shape, np.float32)

    def action(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        return self.low + 0.5 * (a + 1.0) * (self.high - self.low)


class RewardScaleWrapper(gym.Wrapper):
    """Multiply the env reward by a constant before the wrapper stack
    (TPU-repo extension; generalizes the reference's Mario ``reward/15``,
    envs.py:421). The PPO update clips extrinsic rewards to [-1, 1]
    (reference train.py:708), so dense-reward tasks whose per-step reward
    lives outside that range -- e.g. Pendulum-v1's [-16.27, 0] -- need a
    pre-clip scale for the signal to survive."""

    def __init__(self, env, scale: float):
        super().__init__(env)
        self.scale = float(scale)

    def step(self, action):
        obs, r, d, t, info = self.env.step(action)
        return obs, float(r) * self.scale, d, t, info


class ActionOffsetWrapper(gym.Wrapper):
    """Shift the discrete action id by +k -- used to strip Breakout's NOOP
    (reference train.py:91-92: ``action += 1`` when EnvID starts with
    Breakout, with output_size reduced by 1)."""

    def __init__(self, env, offset: int = 1):
        super().__init__(env)
        self.offset = offset
        self.action_space = spaces.Discrete(env.action_space.n - offset)

    def step(self, action):
        return self.env.step(int(action) + self.offset)
