"""Training entry point (counterpart of ``eavit_tpu/train.py``: the host-env
path, lines 313-464, and the device-env path, lines 177-310; reference
train.py:21-878).

Phases, in reference order: logger; env fleet; agent; checkpoint resume;
SSL pretraining when ``SSL_pretraining`` and a representation method are
both set (:func:`ssl_pretrain`); obs-norm warm-up (skipped on resume,
reference train.py:503); then the
rollout -> update loop with scheduled and best checkpoints, metric logging
and a profile-N-updates-then-exit mode. The loop runs forever unless
``total_updates`` is set (the reference is killed externally).

Single device: the agent runs on CUDA unless ``device="cpu"`` (CLI
``--device cpu``) is given, and raises when there is no GPU and no device was
named. ``EnvType = synthetic_device`` runs the zero-host path: the env of
``envs/device_env.py`` and ``rl/scan_rollout.py``'s collector keep the frames,
the env state and the rollout on the agent's device, the obs-norm warm-up
runs policy rollouts through that collector, and a checkpoint carries the
env's episode bookkeeping. On the host-env path ``rl/device_rollout.py``'s
collector keeps the frame stack and the rollout on the agent's device and,
under ``AsyncEnvPool = True``, pipelines two half fleets
(``eavit_tpu/train.py:379``); its ``warmup_obs_rms`` runs the obs-norm
warm-up, and a resume restores its episode bookkeeping. The action space comes from
the env fleet (discrete ``action_space_n`` or continuous ``action_dim``,
``eavit_tpu/train.py:34-39``, ``:341-342``), and ``Render = True`` shows the
rollout frames in a matplotlib grid (``utils/renderer.py``). BYOL and Barlow
Twins train jointly with PPO+RND (``rl/agent.py``) and, with
``SSL_pretraining = True``, are pretrained on random-action rollouts first:
on the host-env path before the obs-norm warm-up, on the device-env path
after the resume and before the warm-up, through
:class:`_DeviceEnvHostAdapter` (``eavit_tpu/train.py:149-174``, ``:258-267``,
``:392-400``). ``SSL_pretraining = True`` with no representation method
trains without SSL, as the reference pretrains only when both are set.
``DataAxisSize > 1`` is not ported yet and raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from eavit_tpu_torch.config import (
    Config,
    EnvType,
    RepresentationMethod,
    config_from_args,
)
from eavit_tpu_torch.envs.builders import make_vector_env
from eavit_tpu_torch.envs.device_env import (
    DeviceEnvState,
    device_env_reset,
    device_env_step,
    make_device_env,
)
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.models.policy import ActionSpaceType
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector
from eavit_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from eavit_tpu_torch.utils.logger import Logger
from eavit_tpu_torch.utils.seed import set_seed


def check_ported(cfg: Config) -> None:
    """Raise for what the torch package cannot train yet."""
    if cfg.data_axis_size > 1:
        raise NotImplementedError(
            "DataAxisSize > 1 (data parallel) is not ported to the torch package "
            "yet (ROADMAP.md Queue 1, item 9)")


def _detect_action_space(env) -> ActionSpaceType:
    """Discrete when the fleet has ``action_space_n``, else continuous."""
    if getattr(env, "action_space_n", None):
        return ActionSpaceType.DISCRETE
    return ActionSpaceType.CONTINUOUS


def _pretrains(cfg: Config) -> bool:
    return (cfg.ssl_pretraining
            and cfg.representation_lr_method != RepresentationMethod.NONE)


def ssl_pretrain(cfg: Config, agent: RNDAgent, state, env, logger: Logger,
                 ckpt: CheckpointManager, rng: Rng, num_epochs: int):
    """SSL pretraining (``eavit_tpu/train.py:57-130``; reference
    train.py:292-499): random-action rollouts from
    ``np.random.default_rng(cfg.seed)`` become training data; the first
    rollout is held out for evaluation; ``max(1, Epoch)`` passes of
    :class:`~eavit_tpu_torch.rl.ssl_pretrain.SSLPretrainer` over each
    collected rollout; the best evaluation loss is checkpointed under the SSL
    suffix. The frames go to the agent's device as they come. Returns
    ``(state, env states)``; the modules are updated in place."""
    from eavit_tpu_torch.rl.ssl_pretrain import SSLPretrainer

    if num_epochs < 0:
        # the reference's SSL loop is a while-True killed externally
        # (train.py:342); make the contract loud so a bounded
        # --total_updates run isn't mistaken for a hang
        logger.log(
            "SSLEpochs < 0: SSL pretraining runs FOREVER (reference "
            "while-True semantics); PPO never starts. Set SSLEpochs to "
            "bound it."
        )
    pretrainer = SSLPretrainer(cfg, agent)
    n = env.num_envs
    rng_np = np.random.default_rng(cfg.seed)

    def random_rollout(states):
        frames = []
        for _ in range(cfg.num_step):
            if hasattr(env, "sample_random_actions"):
                actions = env.sample_random_actions(rng_np)
            else:
                actions = rng_np.integers(0, env.action_space_n, size=n)
            states, _, _, _, _ = env.step(actions)
            frames.append(torch.as_tensor(states).to(agent.device, copy=True))
        return torch.cat(frames), states

    states = env.reset()
    eval_states, states = random_rollout(states)
    method = cfg.representation_lr_method.value
    epoch = 0
    while num_epochs < 0 or epoch < num_epochs:
        train_states, states = random_rollout(states)
        # Epoch passes over each collected rollout (reference train.py:404
        # runs `for k in range(epoch)` over the dataset before collecting
        # the next)
        for _ in range(max(1, cfg.epoch)):
            train_loss, eval_loss = pretrainer.epoch(train_states, eval_states, rng)
        train_loss, eval_loss = float(train_loss), float(eval_loss)
        logger.log_scalars(
            {
                f"SSL_pretraining/Representation_loss({method})(training dataset) vs epoch": train_loss,
                f"SSL_pretraining/Representation_loss({method})(evaluation dataset) vs epoch": eval_loss,
            }
        )
        logger.log(
            f"SSL_pretraining_epoch: {epoch}, training_representation_loss: "
            f"{train_loss:.6f}, evaluation_representation_loss: {eval_loss:.6f}"
        )
        ckpt.maybe_save(
            agent, state, epoch + 1, {"phase": "ssl_pretraining", "epoch": epoch},
            ssl_loss=eval_loss,
        )
        epoch += 1
    return state, states


class _DeviceEnvHostAdapter:
    """The device env behind the vector-env interface ``ssl_pretrain`` steps
    (reset, step with the 5-tuple, ``sample_random_actions``;
    ``eavit_tpu/train.py:149-174``): random-action device rollouts feed the
    pretrainer under ``EnvType = synthetic_device``. The frames stay on the
    env's device; the actions come from the host's numpy generator."""

    def __init__(self, env_params, num_envs: int):
        self.params = env_params
        self.num_envs = num_envs
        self.action_space_n = 5
        self._state: Optional[DeviceEnvState] = None

    def reset(self) -> torch.Tensor:
        self._state = device_env_reset(self.params, self.num_envs)
        return self._state.stack

    def step(self, actions):
        acts = torch.as_tensor(actions).to(self.params.frames.device)
        self._state, r, d, t = device_env_step(self.params, self._state, acts)
        return self._state.stack, r, d, t, []

    def sample_random_actions(self, rng: np.random.Generator) -> np.ndarray:
        return rng.integers(0, self.action_space_n, size=self.num_envs)


def _device_env_stats_meta(env_state: DeviceEnvState) -> Dict[str, Any]:
    """The device env's episode bookkeeping as a JSON-able dict, in
    ``eavit_tpu``'s sidecar format (``eavit_tpu/train.py:177-188``: the
    cumulative ever-visited bits packed and hex-encoded)."""
    ev = env_state.ever_visited.cpu().numpy().astype(bool)
    return {
        "finished_episodes": env_state.finished_episodes.cpu().tolist(),
        "last_episode_return": env_state.last_episode_return.cpu().tolist(),
        "last_episode_rooms": env_state.last_episode_rooms.cpu().tolist(),
        "ever_visited_hex": np.packbits(ev, axis=None).tobytes().hex(),
        "ever_visited_shape": list(ev.shape),
    }


def _restore_device_env_stats(env_state: DeviceEnvState,
                              metadata: Dict[str, Any]) -> DeviceEnvState:
    """Resume the ever-visited frontier and the last-episode aggregates from
    a checkpoint sidecar (``eavit_tpu/train.py:191-210``); positions and
    stacks start fresh, like the reference's env workers on resume."""
    d = metadata.get("device_env_stats")
    if not d:
        return env_state
    dev = env_state.stack.device
    shape = tuple(d["ever_visited_shape"])
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(d["ever_visited_hex"]), np.uint8))
    bits = bits[:int(np.prod(shape))].reshape(shape).astype(bool)
    return env_state._replace(
        finished_episodes=torch.tensor(d["finished_episodes"], dtype=torch.int32, device=dev),
        last_episode_return=torch.tensor(d["last_episode_return"], dtype=torch.float32,
                                         device=dev),
        last_episode_rooms=torch.tensor(d["last_episode_rooms"], dtype=torch.int32,
                                        device=dev),
        ever_visited=torch.from_numpy(bits).to(dev),
    )


def _log_histograms(cfg: Config, logger: Logger, agent: RNDAgent, grads) -> None:
    """Parameter and gradient histograms (reference utils.py:345-419)."""
    if not cfg.verbose_logging:
        return
    logger.log_params_histograms(dict(agent.network.named_parameters()), "PPO")
    if agent.use_rnd:
        logger.log_params_histograms(dict(agent.rnd_pred.named_parameters()), "RND")
    if grads is not None:
        logger.log_params_histograms(grads["policy"], "PPO_grads")
        if agent.use_rnd:
            logger.log_params_histograms(grads["rnd_pred"], "RND_grads")


def _train_device_env(cfg: Config, total_updates: Optional[int], profile_updates: int,
                      log_dir: str, device) -> Dict[str, Any]:
    """The zero-host training loop over the device env
    (``eavit_tpu/train.py:212-310``): rollouts from ``ScanRolloutCollector``
    on the agent's device, then ``RNDAgent.update`` as on the host path."""
    agent = RNDAgent(cfg, 5, device=device)  # the device env's action set is 5
    logger = Logger(cfg.log_name, log_dir=log_dir, use_wandb=cfg.use_wandb,
                    verbose=cfg.verbose_logging)
    logger.log(f"device: {agent.device}")
    logger.log(f"config: {cfg}")
    env_params, env_state = make_device_env(
        cfg.num_env_per_process,
        seed=cfg.seed,
        grid=cfg.synthetic_grid,
        stack=cfg.state_stack_size,
        height=cfg.pre_proc_height,
        width=cfg.pre_proc_width,
        max_episode_steps=cfg.max_step_per_episode,
        maze=cfg.synthetic_maze,
        texture=cfg.synthetic_texture,
        shared_world=cfg.synthetic_shared_world,
        variants=cfg.synthetic_variants,
        sparse_goal=cfg.synthetic_sparse_goal,
        goal_depth=cfg.synthetic_goal_depth,
        device=agent.device,
    )
    state = agent.init_state(cfg.seed)
    rng = Rng(cfg.seed + 1, agent.device)
    collector = ScanRolloutCollector(cfg, agent, env_params)
    ckpt = CheckpointManager(cfg.save_model_path, cfg.log_name, cfg.save_ckpt_every)

    update = 0
    if cfg.load_model and cfg.load_model_path:
        state, meta = load_checkpoint(cfg.load_model_path, agent)
        update = int(meta.get("global_update", state.global_update))
        ckpt.restore_best(meta)
        env_state = _restore_device_env_stats(env_state, meta)
        logger.log(f"resumed from {cfg.load_model_path} @ update {update}")

    if _pretrains(cfg):
        # the reference's SSL-pretraining phase is unconditional on env type
        # (train.py:292-499): random-action device rollouts feed it here
        state, _ = ssl_pretrain(
            cfg, agent, state, _DeviceEnvHostAdapter(env_params, cfg.num_env_per_process),
            logger, ckpt, rng, cfg.ssl_pretrain_epochs)

    # warm-up: policy rollouts feed obs_rms (eavit_tpu/train.py:269-275)
    if agent.use_rnd and not cfg.load_model:
        logger.log("obs-norm warm-up...")
        for _ in range(max(1, cfg.obs_norm_step)):
            ro, env_state, _ = collector.collect(env_state, rng)
            state = agent.update_obs_rms(
                state, ro.next_obs.reshape((-1,) + tuple(ro.next_obs.shape[2:])))

    if profile_updates:
        logger.start_profiling(profile_updates)
    logger.log("entering training loop")
    last_metrics: Dict[str, Any] = {}
    while total_updates is None or total_updates < 0 or update < total_updates:
        rollout, env_state, env_metrics = collector.collect(env_state, rng)
        state, metrics = agent.update(state, rollout, rng)
        update += 1
        grads = metrics.pop("_grads", None)
        metrics = {k: float(v) for k, v in {**metrics, **env_metrics}.items()}
        logger.log_scalars(metrics, step=update)
        _log_histograms(cfg, logger, agent, grads)
        last_metrics = metrics
        logger.log(
            f"update {update} | global_step {state.global_step} | "
            f"loss {metrics['train/loss']:.4f} | "
            f"return {metrics['data/mean_undiscounted_episode_return']:.2f} | "
            f"rooms {metrics['data/total_rooms_discovered']:.0f}"
        )
        ckpt.maybe_save(
            agent, state, update,
            # a callable: the env bookkeeping is read back only when a
            # checkpoint is written
            lambda u=update, st=state, es=env_state: {
                "global_update": u, "global_step": st.global_step,
                "device_env_stats": _device_env_stats_meta(es), "config": cfg},
            mean_episode_return=metrics["data/mean_undiscounted_episode_return"],
        )
        if logger.step_profiler():
            break
    logger.close()
    return last_metrics


def train(cfg: Config, total_updates: Optional[int] = None, profile_updates: int = 0,
          log_dir: str = "logs", device=None) -> Dict[str, Any]:
    """Run the training loop; returns the last update's metrics as floats."""
    if total_updates is None and cfg.total_updates >= 0:
        # direct train(cfg) callers get cfg.total_updates, same as the CLI
        total_updates = cfg.total_updates
    check_ported(cfg)

    set_seed(cfg.seed)
    if cfg.env_type == EnvType.SYNTHETIC_DEVICE:
        return _train_device_env(cfg, total_updates, profile_updates, log_dir, device)
    env = make_vector_env(cfg, rank=0, render=cfg.render)
    # the number of discrete actions or the continuous action dimension
    output_size = env.action_space_n or getattr(env, "action_dim", 1) or 1
    agent = RNDAgent(cfg, output_size, _detect_action_space(env),
                     device=device)  # raises without CUDA
    logger = Logger(cfg.log_name, log_dir=log_dir, use_wandb=cfg.use_wandb,
                    verbose=cfg.verbose_logging)
    logger.log(f"device: {agent.device}")
    logger.log(f"config: {cfg}")

    state = agent.init_state(cfg.seed)
    rng = Rng(cfg.seed + 1, agent.device)
    renderer = None
    if cfg.render:
        from eavit_tpu_torch.utils.renderer import ParallelizedEnvironmentRenderer

        renderer = ParallelizedEnvironmentRenderer(cfg.num_env_per_process)
    collector = DeviceRolloutCollector(cfg, agent, env, renderer=renderer)

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
    if _pretrains(cfg):
        # a dedicated SSL epoch budget, independent of the PPO update budget;
        # -1 runs forever, as documented on SSLEpochs
        state, states = ssl_pretrain(cfg, agent, state, env, logger, ckpt, rng,
                                     cfg.ssl_pretrain_epochs)
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
        _log_histograms(cfg, logger, agent, grads)
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

    if renderer is not None:
        renderer.close()
    env.close()
    logger.close()
    return last_metrics


def main(args) -> None:
    cfg = config_from_args(args)
    total = cfg.total_updates if cfg.total_updates >= 0 else None
    train(cfg, total_updates=total, profile_updates=args.profile_updates,
          device=args.device)
