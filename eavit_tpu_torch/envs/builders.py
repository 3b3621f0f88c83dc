"""Environment builders per EnvType (the port's counterpart of
``eavit_tpu/envs/builders.py``; reference envs.py:248-578).

Each builder assembles the reference's wrapper stack (``envs/wrappers.py``)
for one env; :func:`make_vector_env` seeds env ``idx`` with ``seed + rank *
num_env + idx`` (reference dist_utils.py:108-109) and pools the envs in a
``ThreadVectorEnv`` under ``AsyncEnvPool = True``, else a ``SyncVectorEnv``.
``EnvType = synthetic`` builds the host synthetic fleet;
``synthetic_device`` needs no builder (``envs/device_env.py``).

gymnasium, its emulators and cv2 are imported only when an env of theirs is
built, so this module imports without them. A missing one raises
``ImportError`` naming the package; no other env is put in its place. The
Atari and Mario makers are copied from the JAX package but cannot be run
where ``ale_py`` or ``gym_super_mario_bros`` / ``nes_py`` are missing.
"""

from __future__ import annotations

from typing import Any, Callable, List

from eavit_tpu_torch.config import Config, EnvType
from eavit_tpu_torch.envs.pool import SyncVectorEnv, ThreadVectorEnv
from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv


def _gymnasium():
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            "EnvType atari / classic_control needs the gymnasium package, which is "
            "not installed") from e
    return gymnasium


def _wrap_common(env, cfg: Config, seed: int, *, montezuma: bool):
    from eavit_tpu_torch.envs import wrappers as W

    if cfg.sticky_action:
        env = W.StickyActionWrapper(env, cfg.action_prob, seed)
    env = W.MaxAndSkipWrapper(env, skip=4)
    env = W.ResizeAndGrayScaleWrapper(env, cfg.pre_proc_height, cfg.pre_proc_width)
    env = W.FrameStackWrapper(env, cfg.state_stack_size)
    env = W.MaxStepPerEpisodeWrapper(env, cfg.max_step_per_episode)
    env = W.MonitorWrapper(env)
    if montezuma:
        env = W.MontezumaInfoWrapper(env, room_address=3)
    return env


def make_atari_env(cfg: Config, seed: int, render: bool = False) -> Callable[[], Any]:
    def thunk():
        gym = _gymnasium()
        try:
            import ale_py
        except ImportError as e:
            raise ImportError(
                "EnvType = atari needs the ale_py package, which is not installed") from e
        gym.register_envs(ale_py)
        env = gym.make(cfg.env_id, render_mode="rgb_array" if render else None)
        env.reset(seed=seed)
        env = _wrap_common(env, cfg, seed, montezuma="Montezuma" in cfg.env_id)
        if cfg.env_id.startswith("Breakout"):
            from eavit_tpu_torch.envs.wrappers import ActionOffsetWrapper

            env = ActionOffsetWrapper(env, 1)  # NOOP removal (train.py:91-92)
        return env

    return thunk


def make_mario_env(cfg: Config, seed: int, render: bool = False) -> Callable[[], Any]:
    def thunk():
        try:
            import gym_super_mario_bros
            from gym_super_mario_bros.actions import COMPLEX_MOVEMENT
            from nes_py.wrappers import JoypadSpace
        except ImportError as e:
            raise ImportError(
                "EnvType = mario needs the gym_super_mario_bros and nes_py packages, "
                "which are not installed") from e
        from eavit_tpu_torch.envs import wrappers as W

        env = gym_super_mario_bros.make(cfg.env_id)
        env = JoypadSpace(env, COMPLEX_MOVEMENT)
        env = W.MarioRewardWrapper(env, life_done=cfg.life_done)
        return _wrap_common(env, cfg, seed, montezuma=False)

    return thunk


def make_classic_control_env(cfg: Config, seed: int,
                             render: bool = False) -> Callable[[], Any]:
    def thunk():
        gym = _gymnasium()
        from eavit_tpu_torch.envs import wrappers as W

        env = gym.make(cfg.env_id, render_mode="rgb_array")
        # classic-control envs render at fixed sizes (Pendulum 500x500,
        # CartPole 600x400) that the stack resizes to PreProc* at once;
        # rendering at twice the target size costs a quarter of the host time
        target = 2 * max(cfg.pre_proc_height, cfg.pre_proc_width)
        u = env.unwrapped
        if hasattr(u, "screen_dim") and u.screen_dim > target:
            u.screen_dim = target
        elif hasattr(u, "screen_width") and u.screen_width > target:
            scale = target / u.screen_width
            u.screen_width = target
            u.screen_height = max(1, int(u.screen_height * scale))
        env.reset(seed=seed)
        # no StickyAction and no MaxAndSkip, as the reference has them
        # commented out (envs.py:513-517): reward scale -> action scale ->
        # rgb render -> gray/resize -> stack -> step cap -> monitor
        if cfg.reward_scale != 1.0:
            env = W.RewardScaleWrapper(env, cfg.reward_scale)
        if hasattr(env.action_space, "low"):
            # continuous Box env: the policy emits a tanh mean in [-1, 1]
            env = W.ActionScaleWrapper(env)
        env = W.RGBArrayAsObservationWrapper(env)
        env = W.ResizeAndGrayScaleWrapper(env, cfg.pre_proc_height, cfg.pre_proc_width)
        env = W.FrameStackWrapper(env, cfg.state_stack_size)
        env = W.MaxStepPerEpisodeWrapper(env, cfg.max_step_per_episode)
        env = W.MonitorWrapper(env)
        return env

    return thunk


def fleet_seeds(cfg: Config, rank: int = 0) -> List[int]:
    """The env seeds of rank ``rank``'s fleet: ``seed + rank * num_env +
    idx`` (reference dist_utils.py:108-109), disjoint between ranks."""
    n = cfg.num_env_per_process
    return [cfg.seed + rank * n + i for i in range(n)]


def make_vector_env(cfg: Config, rank: int = 0, render: bool = False):
    """Build the per-process env fleet (reference
    create_parallel_env_processes, dist_utils.py:84-117)."""
    n = cfg.num_env_per_process
    if cfg.env_type == EnvType.SYNTHETIC:
        return SyntheticVectorEnv(
            n,
            seed=cfg.seed,
            rank=rank,
            stack=cfg.state_stack_size,
            height=cfg.pre_proc_height,
            width=cfg.pre_proc_width,
            max_episode_steps=cfg.max_step_per_episode,
            sticky_action=cfg.sticky_action,
            grid=cfg.synthetic_grid,
        )
    makers = {
        EnvType.ATARI: make_atari_env,
        EnvType.MARIO: make_mario_env,
        EnvType.CLASSIC_CONTROL: make_classic_control_env,
    }
    if cfg.env_type not in makers:
        raise ValueError(f"EnvType = {cfg.env_type.value} has no host env fleet "
                         "(synthetic_device runs on the device, envs/device_env.py)")
    fns = [makers[cfg.env_type](cfg, s, render) for s in fleet_seeds(cfg, rank)]
    pool_cls = ThreadVectorEnv if cfg.async_env_pool else SyncVectorEnv
    return pool_cls(fns)
