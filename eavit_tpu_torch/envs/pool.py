"""Vectorised environment pools (the port's own copy of
``eavit_tpu/envs/pool.py``).

They replace the reference's one-OS-process-per-env Pipe fleet
(dist_utils.py:84-117, envs.py:305-343): a synchronous in-process loop
(``SyncVectorEnv``) or one persistent worker thread per env
(``ThreadVectorEnv``; gym envs release the GIL in their C cores), both with
auto-reset (the reference worker resets and sends the fresh state in the
same step, envs.py:333) and ``sample_random_actions`` for the obs-norm
warm-up. The builders seed env ``idx`` with ``seed + rank * num_env + idx``
(dist_utils.py:108-109).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional

import numpy as np


def _space_info(space):
    """(action_space_n, action_dim, low, high) from a gym space."""
    n = getattr(space, "n", None)
    if n is not None:
        return int(n), None, None, None
    shape = getattr(space, "shape", None) or (1,)
    low = np.asarray(getattr(space, "low", -1.0), np.float32)
    high = np.asarray(getattr(space, "high", 1.0), np.float32)
    return None, int(np.prod(shape)), low, high


class SyncVectorEnv:
    """Minimal synchronous pool over gymnasium-style envs."""

    def __init__(self, env_fns: List[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        (self.action_space_n, self.action_dim,
         self.action_low, self.action_high) = _space_info(self.envs[0].action_space)

    def sample_random_actions(self, rng: np.random.Generator) -> np.ndarray:
        """Random actions for warm-up. Continuous spaces sample across the
        Box bounds (divergence: the reference samples U[0,1) regardless of
        bounds, train.py:515 -- biased coverage for envs like Pendulum's
        [-2, 2] torque; we sample the full range)."""
        if self.action_space_n is not None:
            return rng.integers(0, self.action_space_n, size=self.num_envs)
        low = np.broadcast_to(self.action_low, (self.action_dim,))
        high = np.broadcast_to(self.action_high, (self.action_dim,))
        low = np.where(np.isfinite(low), low, -1.0)
        high = np.where(np.isfinite(high), high, 1.0)
        return rng.uniform(
            low, high, size=(self.num_envs, self.action_dim)
        ).astype(np.float32)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset()[0] for e in self.envs])

    def step(self, actions: np.ndarray):
        return self.step_slice(0, self.num_envs, actions)

    def step_slice(self, lo: int, hi: int, actions: np.ndarray):
        """Step only envs [lo, hi) (double-buffered rollout pipelining:
        the host steps one half-fleet while the device acts on the other)."""
        states, rewards, dones, truns, infos = [], [], [], [], []
        for env, a in zip(self.envs[lo:hi], actions):
            s, r, d, t, info = env.step(a)
            if d or t:
                s, _ = env.reset()
            states.append(s)
            rewards.append(r)
            dones.append(d)
            truns.append(t)
            infos.append(info)
        return (
            np.stack(states),
            np.asarray(rewards, np.float32),
            np.asarray(dones, np.bool_),
            np.asarray(truns, np.bool_),
            infos,
        )

    def close(self) -> None:
        for e in self.envs:
            if hasattr(e, "close"):
                e.close()


_RESET = object()


class ThreadVectorEnv:
    """Persistent worker threads, one env each; all envs step concurrently.

    The host-side analogue of the reference's env-worker processes without
    pickling frames over pipes. Worker exceptions (env construction or
    stepping) are captured and re-raised in the caller -- never a silent
    hang.
    """

    def __init__(self, env_fns: List[Callable[[], Any]]):
        self.num_envs = len(env_fns)
        self._in: List[queue.Queue] = [queue.Queue(1) for _ in env_fns]
        self._done: queue.Queue = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._results: List[Any] = [None] * self.num_envs
        self._errors: List[Optional[BaseException]] = [None] * self.num_envs
        self._ready = threading.Barrier(self.num_envs + 1)
        self.action_space_n: Optional[int] = None
        self.action_dim: Optional[int] = None
        self.action_low = self.action_high = None

        def worker(idx: int, fn: Callable[[], Any]):
            env = None
            try:
                env = fn()
                if idx == 0:
                    (self.action_space_n, self.action_dim,
                     self.action_low, self.action_high) = _space_info(env.action_space)
                s, _ = env.reset()
                self._results[idx] = (s, 0.0, False, False, {})
            except BaseException as e:  # noqa: BLE001 - re-raised in caller
                self._errors[idx] = e
            finally:
                self._ready.wait()
            if self._errors[idx] is not None:
                return
            while True:
                msg = self._in[idx].get()
                if msg is None:
                    if hasattr(env, "close"):
                        env.close()
                    return
                try:
                    if msg is _RESET:
                        s, _ = env.reset()
                        self._results[idx] = (s, 0.0, False, False, {})
                    else:
                        s, r, d, t, info = env.step(msg)
                        if d or t:
                            s, _ = env.reset()
                        self._results[idx] = (s, r, d, t, info)
                except BaseException as e:  # noqa: BLE001
                    self._errors[idx] = e
                self._done.put(idx)
                if self._errors[idx] is not None:
                    return

        for i, fn in enumerate(env_fns):
            th = threading.Thread(target=worker, args=(i, fn), daemon=True)
            th.start()
            self._threads.append(th)
        self._ready.wait()
        self._raise_worker_errors()

    def _raise_worker_errors(self) -> None:
        for e in self._errors:
            if e is not None:
                raise RuntimeError("env worker failed") from e

    def reset(self) -> np.ndarray:
        """Reset every env (matching SyncVectorEnv.reset semantics)."""
        for q in self._in:
            q.put(_RESET)
        for _ in range(self.num_envs):
            self._done.get()
        self._raise_worker_errors()
        return np.stack([r[0] for r in self._results])

    def step(self, actions: np.ndarray):
        return self.step_slice(0, self.num_envs, actions)

    def step_slice(self, lo: int, hi: int, actions: np.ndarray):
        """Step only envs [lo, hi). At most one slice may be in flight at a
        time (the pipelined collector alternates halves from one thread)."""
        for q, a in zip(self._in[lo:hi], actions):
            q.put(a)
        for _ in range(hi - lo):
            self._done.get()
        self._raise_worker_errors()
        res = self._results[lo:hi]
        states = np.stack([r[0] for r in res])
        rewards = np.asarray([r[1] for r in res], np.float32)
        dones = np.asarray([r[2] for r in res], np.bool_)
        truns = np.asarray([r[3] for r in res], np.bool_)
        infos = [r[4] for r in res]
        return states, rewards, dones, truns, infos

    sample_random_actions = SyncVectorEnv.sample_random_actions

    def close(self) -> None:
        for q in self._in:
            q.put(None)
