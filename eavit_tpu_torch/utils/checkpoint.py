"""Checkpoint save and restore with the reference's semantics.

Counterpart of ``eavit_tpu/utils/checkpoint.py`` (reference
train.py:883-961): scheduled saves every ``saveCkptEvery`` updates and three
"best model" variants under suffixed file names (verbatim), a JSON sidecar
with the host-side metadata (episode stats, counters, config snapshot, the
best-metric watermarks), and a resume that restores everything and skips the
obs-norm warm-up.

The device state -- the modules' parameters, the Adam state, the normalisers
and counters, as ``RNDAgent.state_dict`` lays them out -- goes through
``torch.save`` into ``<path>.pt``; it holds tensors and plain numbers only,
so it is read back with ``weights_only=True``.

Under data parallelism (``parallel/dp.py``) every rank calls
:meth:`CheckpointManager.maybe_save` on every update: the ranks take rank
0's metrics to decide what to write, build the payload together (the
per-env state is gathered in rank order) and rank 0 alone writes it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from eavit_tpu_torch.parallel import dp

BEST_SUFFIXES = {
    "rollout_reward": "__BestModelForMeanExtrinsicRolloutRewards",
    "episode_return": "__BestModelForMeanUndiscountedEpisodeReturn",
    "ssl_loss": "__BestModelForSSLEvaluationEpochLoss",
}
_EXT = ".pt"


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, set):
        return sorted(_to_jsonable(v) for v in obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if dataclasses.is_dataclass(obj):
        return _to_jsonable(dataclasses.asdict(obj))
    if hasattr(obj, "value") and not isinstance(obj, (int, float, str)):
        return obj.value  # enums
    return obj


def _write(path: str, payload: Dict[str, Any], metadata: Optional[Dict[str, Any]]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + _EXT + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path + _EXT)  # a reader never sees half a file
    with open(path + ".json", "w") as f:
        json.dump(_to_jsonable(metadata or {}), f, indent=2, default=str)
    return path


def save_checkpoint(path: str, agent, state,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<path>.pt`` (``agent.state_dict(state)``) and ``<path>.json``
    (``metadata``). ``path`` is a file prefix."""
    return _write(path, agent.state_dict(state), metadata)


def load_checkpoint(path: str, agent) -> Tuple[Any, Dict[str, Any]]:
    """Restore ``agent`` (modules and optimizer, in place) from a checkpoint
    prefix or its ``.pt`` file; returns ``(AgentState, metadata)``."""
    if path.endswith(_EXT):
        path = path[: -len(_EXT)]
    payload = torch.load(path + _EXT, map_location=agent.device, weights_only=True)
    state = agent.load_state_dict(payload)
    metadata: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            metadata = json.load(f)
    return state, metadata


class CheckpointManager:
    """Scheduled + best-metric checkpointing (reference train.py:883-961);
    with a process ``group`` rank 0 writes for every rank (module doc)."""

    def __init__(self, directory: str, run_name: str, save_every: int, group=None):
        self.directory = directory
        self.group = group
        self.run_name = run_name
        self.save_every = max(1, save_every)
        self.best: Dict[str, float] = {
            "rollout_reward": -float("inf"),
            "episode_return": -float("inf"),
            "ssl_loss": float("inf"),
        }

    def restore_best(self, metadata: Dict[str, Any]) -> None:
        """Resume the best-metric watermarks from a checkpoint sidecar, so a
        restart does not overwrite the best-model files with the first
        mediocre metric."""
        for k, v in (metadata.get("best_metrics") or {}).items():
            if k in self.best and v is not None:
                self.best[k] = float(v)

    def path(self, suffix: str = "") -> str:
        return os.path.join(self.directory, self.run_name + suffix)

    def maybe_save(
        self,
        agent,
        state,
        global_update: int,
        metadata: Union[Dict[str, Any], Callable[[], Dict[str, Any]]],
        mean_rollout_reward: Optional[float] = None,
        mean_episode_return: Optional[float] = None,
        ssl_loss: Optional[float] = None,
    ) -> Dict[str, str]:
        """Returns ``{kind: path}`` for every checkpoint written by this
        call. ``metadata`` may be a zero-argument callable, evaluated only
        when something is written."""
        if dp.group_size(self.group) > 1:  # every rank decides on rank 0's metrics
            mean_rollout_reward, mean_episode_return, ssl_loss = dp.broadcast_object(
                (mean_rollout_reward, mean_episode_return, ssl_loss), self.group)
        written: Dict[str, str] = {}
        # watermarks first, so every sidecar written now carries the new ones
        new_best = []
        if (mean_rollout_reward is not None
                and mean_rollout_reward > self.best["rollout_reward"]):
            self.best["rollout_reward"] = mean_rollout_reward
            new_best.append("rollout_reward")
        if (mean_episode_return is not None
                and mean_episode_return > self.best["episode_return"]):
            self.best["episode_return"] = mean_episode_return
            new_best.append("episode_return")
        if ssl_loss is not None and ssl_loss < self.best["ssl_loss"]:
            self.best["ssl_loss"] = ssl_loss
            new_best.append("ssl_loss")

        scheduled = global_update % self.save_every == 0
        if not (scheduled or new_best):
            return written
        metadata = dict(metadata() if callable(metadata) else metadata)
        metadata["best_metrics"] = {
            k: (v if math.isfinite(v) else None) for k, v in self.best.items()}
        payload = agent.state_dict(state)
        if dp.group_rank(self.group) != 0:
            return written
        if scheduled:
            written["scheduled"] = _write(self.path(), payload, metadata)
        for kind in new_best:
            written[kind] = _write(self.path(BEST_SUFFIXES[kind]), payload, metadata)
        return written
