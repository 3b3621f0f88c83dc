"""Environment builders per EnvType (counterpart of
``eavit_tpu/envs/builders.py``; reference envs.py:248-578).

The port has the synthetic env only. The emulator-backed and
``classic_control`` types need the wrapper stack, the env pools and the
renderer (``eavit_tpu/envs/wrappers.py``, ``envs/pool.py``,
``utils/renderer.py``), which are not ported yet: asking for them raises
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from eavit_tpu_torch.config import Config, EnvType
from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv


def make_vector_env(cfg: Config, rank: int = 0, render: bool = False):
    """Build the per-process env fleet (reference
    create_parallel_env_processes, dist_utils.py:84-117)."""
    if cfg.env_type == EnvType.SYNTHETIC:
        return SyntheticVectorEnv(
            cfg.num_env_per_process,
            seed=cfg.seed,
            rank=rank,
            stack=cfg.state_stack_size,
            height=cfg.pre_proc_height,
            width=cfg.pre_proc_width,
            max_episode_steps=cfg.max_step_per_episode,
            sticky_action=cfg.sticky_action,
            grid=cfg.synthetic_grid,
        )
    raise NotImplementedError(
        f"EnvType = {cfg.env_type.value} is not ported to the torch package yet "
        "(ROADMAP.md Queue 1, item 11: envs/wrappers.py, envs/pool.py, "
        "classic_control and utils/renderer.py); use EnvType = synthetic")
