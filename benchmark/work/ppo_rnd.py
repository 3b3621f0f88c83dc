"""The work of one PPO+RND iteration (``collect`` then ``update``) by
group, from the cell's shapes and the iteration's structure:

- ``NumStep + 1`` acts (each step and the bootstrap), one policy forward
  over the envs each;
- the batch preparation: the RND target and predictor forward over every
  collected frame;
- ``Epoch x MiniBatch`` minibatch steps, each a policy forward and backward
  and the RND target forward and predictor forward and backward over the
  minibatch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from benchmark.work import rnd_conv
from benchmark.work._ops import add, backward, forward


def iteration(arch, hp: Dict[str, Any]) -> Dict[str, Tuple[float, float]]:
    """``group -> (operations, bytes)`` of one iteration."""
    pol = arch.policy_ops(hp)
    tgt, pred = rnd_conv.target_ops(hp), rnd_conv.predictor_ops(hp)
    envs, steps = hp["num_envs"], hp["num_step"]
    frames = envs * steps
    mb = frames // hp["mini_batch"]
    n_mb = hp["epoch"] * hp["mini_batch"]
    act = add(forward(pol, envs), scale=steps + 1)
    prep = add(forward(tgt, frames), forward(pred, frames))
    step = add(forward(pol, mb), backward(pol, mb), forward(tgt, mb), forward(pred, mb),
               backward(pred, mb))
    return add(act, prep, add(step, scale=n_mb))


def calls(hp: Dict[str, Any]) -> Dict[str, int]:
    """Calls of the attention and FFN functions per iteration, each call one
    layer's forward or backward."""
    fwd = hp["depth"] * (hp["num_step"] + 1 + hp["epoch"] * hp["mini_batch"])
    bwd = hp["depth"] * hp["epoch"] * hp["mini_batch"]
    return {"attn_fwd": fwd, "attn_bwd": bwd, "ffn_fwd": fwd, "ffn_bwd": bwd}


def model_flops(arch, hp: Dict[str, Any]) -> float:
    """Every operation of the iteration, all groups together."""
    return sum(f for f, _ in iteration(arch, hp).values())
