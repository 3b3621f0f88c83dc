"""Training entry point (counterpart of ``eavit_tpu/train.py``, host-env path,
lines 313-464; reference train.py:21-878).

Phases, in reference order: logger; env fleet; agent; checkpoint resume;
obs-norm warm-up (skipped on resume, reference train.py:503); then the
rollout -> update loop with scheduled and best checkpoints, metric logging
and a profile-N-updates-then-exit mode. The loop runs forever unless
``total_updates`` is set (the reference is killed externally).

Single device: the agent runs on CUDA unless ``device="cpu"`` (CLI
``--device cpu``) is given, and raises when there is no GPU and no device was
named. ``EnvType = synthetic_device``, the SSL methods, ``Render = True``
and ``DataAxisSize > 1`` are not ported yet and raise
``NotImplementedError`` naming their ROADMAP items. ``SSL_pretraining =
True`` with no representation method trains without SSL, as the reference
pretrains only when both are set (``eavit_tpu/train.py:258``, ``:392``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from eavit_tpu_torch.config import (
    Config,
    EnvType,
    RepresentationMethod,
    config_from_args,
)
from eavit_tpu_torch.envs.builders import make_vector_env
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.rl.rollout import RolloutCollector
from eavit_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from eavit_tpu_torch.utils.logger import Logger
from eavit_tpu_torch.utils.seed import set_seed


def check_ported(cfg: Config) -> None:
    """Raise for what the torch package cannot train yet."""
    if cfg.env_type == EnvType.SYNTHETIC_DEVICE:
        raise NotImplementedError(
            "EnvType = synthetic_device is not ported to the torch package yet "
            "(ROADMAP.md Queue 1, item 6)")
    if cfg.representation_lr_method != RepresentationMethod.NONE:
        raise NotImplementedError(
            "SSL pretraining and BYOL / Barlow-Twins are not ported to the torch "
            "package yet (ROADMAP.md Queue 1, item 7)")
    if cfg.render:
        raise NotImplementedError(
            "rendering is not ported to the torch package yet (ROADMAP.md Queue 1, "
            "item 11: utils/renderer.py)")
    if cfg.data_axis_size > 1:
        raise NotImplementedError(
            "DataAxisSize > 1 (data parallel) is not ported to the torch package "
            "yet (ROADMAP.md Queue 1, item 9)")


def train(cfg: Config, total_updates: Optional[int] = None, profile_updates: int = 0,
          log_dir: str = "logs", device=None) -> Dict[str, Any]:
    """Run the training loop; returns the last update's metrics as floats."""
    if total_updates is None and cfg.total_updates >= 0:
        # direct train(cfg) callers get cfg.total_updates, same as the CLI
        total_updates = cfg.total_updates
    check_ported(cfg)

    set_seed(cfg.seed)
    env = make_vector_env(cfg, rank=0, render=cfg.render)
    agent = RNDAgent(cfg, env.action_space_n, device=device)  # raises without CUDA
    logger = Logger(cfg.log_name, log_dir=log_dir, use_wandb=cfg.use_wandb,
                    verbose=cfg.verbose_logging)
    logger.log(f"device: {agent.device}")
    logger.log(f"config: {cfg}")

    state = agent.init_state(cfg.seed)
    rng = Rng(cfg.seed + 1, agent.device)
    collector = RolloutCollector(cfg, agent, env)

    ckpt = CheckpointManager(cfg.save_model_path, cfg.log_name, cfg.save_ckpt_every)
    start_update = 0
    resumed = bool(cfg.load_model and cfg.load_model_path)
    if resumed:
        state, meta = load_checkpoint(cfg.load_model_path, agent)
        start_update = int(meta.get("global_update", state.global_update))
        ckpt.restore_best(meta)
        if "episode_stats" in meta:  # episode bookkeeping (reference train.py:926-956)
            collector.stats.load_state(meta["episode_stats"])
        logger.log(f"resumed from {cfg.load_model_path} @ update {start_update}")

    states = env.reset()
    if not cfg.load_model:
        logger.log("obs-norm warm-up...")
        state, states = collector.warmup_obs_rms(state, states, rng)

    if profile_updates:
        logger.start_profiling(profile_updates)

    logger.log("entering training loop")
    update = start_update
    last_metrics: Dict[str, Any] = {}
    while total_updates is None or total_updates < 0 or update < total_updates:
        rollout, states = collector.collect(states, rng)
        state, metrics = agent.update(state, rollout, rng)
        update += 1

        grads = metrics.pop("_grads", None)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics.update(collector.stats.summary())
        logger.log_scalars(metrics, step=update)
        if cfg.verbose_logging:
            # parameter and gradient histograms (reference utils.py:345-419)
            logger.log_params_histograms(dict(agent.network.named_parameters()), "PPO")
            if agent.use_rnd:
                logger.log_params_histograms(
                    dict(agent.rnd_pred.named_parameters()), "RND")
            if grads is not None:
                logger.log_params_histograms(grads["policy"], "PPO_grads")
                if agent.use_rnd:
                    logger.log_params_histograms(grads["rnd_pred"], "RND_grads")
        last_metrics = metrics
        ret = metrics.get("data/mean_undiscounted_episode_return")
        logger.log(
            f"update {update} | global_step {state.global_step} | "
            f"loss {metrics.get('train/loss', float('nan')):.4f} | "
            f"return {f'{ret:.2f}' if ret is not None else '-'} | "
            f"rooms {metrics.get('data/total_number_of_visited_rooms', 0):.0f}"
        )

        ckpt.maybe_save(
            agent, state, update,
            {"global_update": update, "global_step": state.global_step,
             "stats": collector.stats.summary(),
             "episode_stats": collector.stats.to_state(), "config": cfg},
            mean_rollout_reward=metrics.get("data/ext_reward_per_rollout_mean"),
            mean_episode_return=metrics.get("data/mean_undiscounted_episode_return"),
        )
        if logger.step_profiler():
            break

    env.close()
    logger.close()
    return last_metrics


def main(args) -> None:
    cfg = config_from_args(args)
    total = cfg.total_updates if cfg.total_updates >= 0 else None
    train(cfg, total_updates=total, profile_updates=args.profile_updates,
          device=args.device)
