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

The agent runs on CUDA unless ``device="cpu"`` (CLI ``--device cpu``) is
given, and raises when there is no GPU and no device was named. Data
parallelism (``parallel/dp.py``): one process per device, as ``torchrun
--nproc_per_node W`` launches it. :func:`train` first joins the ranks'
process group (``nccl`` on CUDA, ``gloo`` on the CPU; a process launched
alone is world size 1), then runs on ``cuda:{LOCAL_RANK}`` unless the caller
names a device. ``DataAxisSize`` 0 means every rank, any other value must
equal the number of ranks (``dp.data_axis_size``). Each rank's host fleet is
seeded by its rank; on the device-env path every rank builds the one fleet
and steps its slice. Each rank acts and draws from its own stream (rank 0
from the stream of a run of one process), the agent averages over the ranks,
rank 0 alone writes checkpoints and scalars, and a checkpoint holds every
rank's per-env state in rank order. ``EnvType = synthetic_device`` runs the
zero-host path: the env of
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
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from eavit_tpu_torch.config import (
    Config,
    EnvType,
    RepresentationMethod,
    config_from_args,
)
from eavit_tpu_torch.envs.builders import fleet_seeds, make_vector_env
from eavit_tpu_torch.envs.device_env import (
    DeviceEnvState,
    device_env_reset,
    device_env_step,
    make_device_env,
)
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.models.policy import ActionSpaceType
from eavit_tpu_torch.parallel import dp
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector
from eavit_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from eavit_tpu_torch.utils.logger import Logger
from eavit_tpu_torch.utils.seed import set_seed
from eavit_tpu_torch.utils.trace import span


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


def _device_env_stats_meta(env_state: DeviceEnvState, group=None) -> Dict[str, Any]:
    """The device env's episode bookkeeping as a JSON-able dict, in
    ``eavit_tpu``'s sidecar format (``eavit_tpu/train.py:177-188``: the
    cumulative ever-visited bits packed and hex-encoded); every rank's envs
    in rank order under a process ``group``."""
    def whole(t):
        return dp.gather_envs(t, group).cpu()

    ev = whole(env_state.ever_visited).numpy().astype(bool)
    return {
        "finished_episodes": whole(env_state.finished_episodes).tolist(),
        "last_episode_return": whole(env_state.last_episode_return).tolist(),
        "last_episode_rooms": whole(env_state.last_episode_rooms).tolist(),
        "ever_visited_hex": np.packbits(ev, axis=None).tobytes().hex(),
        "ever_visited_shape": list(ev.shape),
    }


def _restore_device_env_stats(env_state: DeviceEnvState,
                              metadata: Dict[str, Any]) -> DeviceEnvState:
    """Resume the ever-visited frontier and the last-episode aggregates of
    the whole fleet from a checkpoint sidecar (``eavit_tpu/train.py:191-210``);
    positions and stacks start fresh, like the reference's env workers on
    resume."""
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


def _param_digest(agent: RNDAgent) -> str:
    """SHA-256 of every module's parameters and buffers, in order: equal on
    every rank while the replicas agree bit for bit."""
    h = hashlib.sha256()
    for m in agent._modules().values():
        for t in m.state_dict().values():
            h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _start(cfg: Config, log_dir: str, agent: RNDAgent, rank: int, world: int) -> Logger:
    """The rank's logger, with the device and the config in its log."""
    logger = Logger(cfg.log_name, log_dir=log_dir, use_wandb=cfg.use_wandb,
                    verbose=cfg.verbose_logging, rank=rank)
    logger.log(f"device: {agent.device} (rank {rank} of {world})")
    logger.log(f"config: {cfg}")
    return logger


def _finish(logger: Logger, agent: RNDAgent, world: int) -> None:
    if world > 1:  # the replicas' digests, rank by rank in their logs
        logger.log(f"parameter digest {_param_digest(agent)}")
    logger.close()


def iteration(collector, agent: RNDAgent, state, env_state, rng: Rng):
    """One pass of the training loop's body: a rollout from ``collector``
    (``DeviceRolloutCollector`` over host env states, or
    ``ScanRolloutCollector`` over a device env state), ``agent.update`` on
    it, and every metric read back to a host float (with the host fleet's
    episode stats, or the device env's episode metrics). Returns the new
    agent state, the new env state, the metrics and the last minibatch's
    gradients (None unless ``verbose_logging``)."""
    with span("eavit.iteration"):
        if isinstance(collector, ScanRolloutCollector):
            rollout, env_state, env_metrics = collector.collect(env_state, rng)
        else:
            rollout, env_state = collector.collect(env_state, rng)
            env_metrics = None
        state, metrics = agent.update(state, rollout, rng)
        with span("eavit.readback"):
            grads = metrics.pop("_grads", None)
            if env_metrics is None:
                env_metrics = collector.stats.summary()
            metrics = {k: float(v) for k, v in {**metrics, **env_metrics}.items()}
    return state, env_state, metrics, grads


def _train_device_env(cfg: Config, total_updates: Optional[int], profile_updates: int,
                      log_dir: str, device, rank: int, world: int) -> Dict[str, Any]:
    """The zero-host training loop over the device env
    (``eavit_tpu/train.py:212-310``): rollouts from ``ScanRolloutCollector``
    on the agent's device, then ``RNDAgent.update`` as on the host path.
    Under data parallelism each rank steps its slice of the one fleet."""
    lo, hi = dp.env_slice(cfg.num_env_per_process, dp.default_group())
    # the device env's action set is 5
    agent = dp.build_agent(cfg, 5, device=device, num_envs=hi - lo)
    logger = _start(cfg, log_dir, agent, rank, world)
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
    rng = Rng(dp.rank_seed(cfg.seed + 1, rank), agent.device)
    collector = ScanRolloutCollector(cfg, agent, env_params)
    ckpt = CheckpointManager(cfg.save_model_path, cfg.log_name, cfg.save_ckpt_every,
                             agent.process_group)

    update = 0
    if cfg.load_model and cfg.load_model_path:
        state, meta = load_checkpoint(cfg.load_model_path, agent)
        update = int(meta.get("global_update", state.global_update))
        ckpt.restore_best(meta)
        env_state = _restore_device_env_stats(env_state, meta)
        logger.log(f"resumed from {cfg.load_model_path} @ update {update}")
    env_state = collector.shard_env_state(env_state)
    logger.log(f"device env: envs {lo}..{hi - 1} of {cfg.num_env_per_process}")

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
        state, env_state, metrics, grads = iteration(collector, agent, state, env_state, rng)
        update += 1
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
                "device_env_stats": _device_env_stats_meta(es, agent.process_group),
                "config": cfg},
            mean_episode_return=metrics["data/mean_undiscounted_episode_return"],
        )
        if logger.step_profiler():
            break
    _finish(logger, agent, world)
    return last_metrics


def _rank_device(device, world: int, local_rank: int):
    """The named device, else ``cuda:{local_rank}`` under data parallelism
    on a machine with CUDA (else None: ``resolve_device``'s rule). A CUDA
    device becomes the current one, where NCCL runs this rank's
    collectives."""
    if device is None and world > 1 and torch.cuda.is_available():
        device = f"cuda:{local_rank}"
    if device is not None and torch.device(device).type == "cuda" \
            and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    return device


def train(cfg: Config, total_updates: Optional[int] = None, profile_updates: int = 0,
          log_dir: str = "logs", device=None) -> Dict[str, Any]:
    """Run the training loop; returns the last update's metrics as floats."""
    if total_updates is None and cfg.total_updates >= 0:
        # direct train(cfg) callers get cfg.total_updates, same as the CLI
        total_updates = cfg.total_updates
    # join the ranks before the first device query (eavit_tpu/train.py:321-324);
    # a no-op in a process launched alone
    dp.init_distributed(backend=dp.backend_for(device))
    world, rank, _, local_rank = dp.get_dist_info()
    dp.data_axis_size(cfg, world)  # before any env is built
    device = _rank_device(device, world, local_rank)

    set_seed(cfg.seed)
    if cfg.env_type == EnvType.SYNTHETIC_DEVICE:
        return _train_device_env(cfg, total_updates, profile_updates, log_dir, device,
                                 rank, world)
    # the rank's own fleet, seeded by the rank (eavit_tpu/train.py:338-340)
    env = make_vector_env(cfg, rank=rank, render=cfg.render)
    # the number of discrete actions or the continuous action dimension
    output_size = env.action_space_n or getattr(env, "action_dim", 1) or 1
    agent = dp.build_agent(cfg, output_size, _detect_action_space(env),
                           device=device)  # raises without CUDA
    logger = _start(cfg, log_dir, agent, rank, world)
    seeds = fleet_seeds(cfg, rank)
    logger.log(f"env fleet: {len(seeds)} envs, seeds {seeds[0]}..{seeds[-1]}")

    state = agent.init_state(cfg.seed)
    rng = Rng(dp.rank_seed(cfg.seed + 1, rank), agent.device)
    renderer = None
    if cfg.render:
        from eavit_tpu_torch.utils.renderer import ParallelizedEnvironmentRenderer

        renderer = ParallelizedEnvironmentRenderer(cfg.num_env_per_process)
    collector = DeviceRolloutCollector(cfg, agent, env, renderer=renderer)

    ckpt = CheckpointManager(cfg.save_model_path, cfg.log_name, cfg.save_ckpt_every,
                             agent.process_group)
    start_update = 0
    resumed = bool(cfg.load_model and cfg.load_model_path)
    if resumed:
        state, meta = load_checkpoint(cfg.load_model_path, agent)
        start_update = int(meta.get("global_update", state.global_update))
        ckpt.restore_best(meta)
        # episode bookkeeping (reference train.py:926-956), this rank's where
        # the checkpoint holds every rank's
        by_rank = meta.get("episode_stats_by_rank") or [meta.get("episode_stats")]
        if by_rank[0] is not None:
            collector.stats.load_state(by_rank[rank if rank < len(by_rank) else 0])
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
        state, states, metrics, grads = iteration(collector, agent, state, states, rng)
        update += 1
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
            lambda u=update, st=state: {
                "global_update": u, "global_step": st.global_step,
                "stats": collector.stats.summary(),
                "episode_stats": collector.stats.to_state(),
                **({"episode_stats_by_rank": dp.gather_objects(
                    collector.stats.to_state(), agent.process_group)} if world > 1 else {}),
                "config": cfg},
            mean_rollout_reward=metrics.get("data/ext_reward_per_rollout_mean"),
            mean_episode_return=metrics.get("data/mean_undiscounted_episode_return"),
        )
        if logger.step_profiler():
            break

    if renderer is not None:
        renderer.close()
    env.close()
    _finish(logger, agent, world)
    return last_metrics


def main(args) -> None:
    cfg = config_from_args(args)
    total = cfg.total_updates if cfg.total_updates >= 0 else None
    train(cfg, total_updates=total, profile_updates=args.profile_updates,
          device=args.device)
