"""Evaluation entry point (counterpart of ``eavit_tpu/eval.py``; reference
eval.py:16-302): single-env playback of a checkpoint in eval mode
(deterministic forwards, no NoisyNet noise), sampling from the policy unless
``greedy`` (the argmax, or the mean action for a continuous policy), with
the per-step intrinsic-reward trace and, with ``render``, the frames in a
matplotlib window (``utils/renderer.py``). Any host env of
``envs/builders.py`` plays back, classic control included. A checkpoint of
an SSL run loads the same way; its SSL heads and target play no part in
acting. Runs on CUDA unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from eavit_tpu_torch.config import Config, EnvType, config_from_args
from eavit_tpu_torch.envs.builders import make_vector_env
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.train import _detect_action_space
from eavit_tpu_torch.utils.checkpoint import load_checkpoint
from eavit_tpu_torch.utils.logger import Logger


def evaluate(
    cfg: Config,
    num_episodes: int = 1,
    render: bool = False,
    save_intrinsic_trace: Optional[str] = None,
    greedy: bool = False,
    log_dir: str = "logs",
    device=None,
) -> Dict[str, Any]:
    if cfg.env_type == EnvType.SYNTHETIC_DEVICE:
        # playback on the host synthetic env: the same dynamics
        cfg = cfg.replace(env_type=EnvType.SYNTHETIC)
    cfg = cfg.replace(num_env_per_process=1)  # single env (reference eval.py:23)
    env = make_vector_env(cfg, rank=0, render=render)
    output_size = env.action_space_n or getattr(env, "action_dim", 1) or 1
    agent = RNDAgent(cfg, output_size, _detect_action_space(env),
                     device=device)  # raises without CUDA
    logger = Logger(cfg.log_name + "_eval", log_dir=log_dir, use_tensorboard=False)

    state = agent.init_state(cfg.seed)
    if cfg.load_model_path:
        state, _ = load_checkpoint(cfg.load_model_path, agent)
        logger.log(f"loaded checkpoint {cfg.load_model_path}")
    rng = Rng(cfg.seed + 1, agent.device)
    renderer = None
    if render:
        from eavit_tpu_torch.utils.renderer import ParallelizedEnvironmentRenderer

        renderer = ParallelizedEnvironmentRenderer(1)

    states = env.reset()
    episodes = steps = 0
    returns: List[float] = []
    intrinsic_trace: List[float] = []
    ep_return = 0.0
    # num_episodes < 0 = run forever (reference eval.py:198 plays until killed)
    while num_episodes < 0 or episodes < num_episodes:
        # eval mode: deterministic forwards; the reference still samples from
        # the softmax (eval.py:198-299), argmax playback is behind ``greedy``
        actions, _, _, _ = agent.act(states, rng, deterministic_model=True,
                                     greedy=greedy)
        states, rewards, dones, truns, _ = env.step(actions.cpu().numpy())
        ep_return += float(rewards[0])
        steps += 1
        if agent.use_rnd:
            next_obs = states[:, -1:] if agent.pixel_rnd else states
            int_r = agent.compute_intrinsic_reward(state, next_obs)
            intrinsic_trace.append(float(int_r[0]))
        if renderer is not None:
            renderer.render(states[:, -1:])
        if dones[0] or truns[0]:
            episodes += 1
            logger.log(f"episode {episodes}: return={ep_return:.2f} length={steps}")
            returns.append(ep_return)
            ep_return, steps = 0.0, 0

    if renderer is not None:
        renderer.close()
    if save_intrinsic_trace and intrinsic_trace:
        # producer for the reference's make_animation (eval.py:286-290)
        with open(save_intrinsic_trace, "wb") as f:
            pickle.dump(intrinsic_trace, f)
    env.close()
    logger.close()
    return {
        "mean_return": float(np.mean(returns)) if returns else 0.0,
        "episodes": episodes,
        "intrinsic_trace_len": len(intrinsic_trace),
    }


def main(args) -> None:
    cfg = config_from_args(args)
    # the episode budget has its own knob (--num_episodes / EvalEpisodes);
    # -1 matches the reference's run-forever playback (eval.py:198)
    out = evaluate(
        cfg,
        num_episodes=cfg.eval_episodes,
        render=cfg.render,
        save_intrinsic_trace=args.save_intrinsic_trace,
        greedy=args.greedy,
        device=args.device,
    )
    print(out)
