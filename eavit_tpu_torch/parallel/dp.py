"""Data parallelism: one process per GPU, explicit collectives.

Counterpart of ``eavit_tpu/parallel/dp.py`` (lines 1-248). ``eavit_tpu``
runs one program over a 1-D ``data`` mesh (``shard_map``) with ``pmean`` /
``psum`` inside its jitted update; the port runs one process per GPU, the
form ``torchrun`` launches (as the reference launched its DDP ranks), and
calls ``torch.distributed`` at the same points:

- gradients: :func:`all_reduce_mean_` after the ``FreezeSharedBackbone``
  zeroing and before the global norm, the clip and Adam
  (``rl/agent.py``, ``rl/ssl_pretrain.py``);
- normaliser moments: :func:`pooled_moments` sums ``sum``, ``sumsq`` and
  ``count`` over the ranks (``rl/normalizer.py``; the reward RMS in
  ``rl/agent.py``): exact pooled moments, not a mean of variances;
- metrics: the mean of every metric at the end of ``update``; the device
  env's rollout metrics in ``rl/scan_rollout.py``.

Parameters, optimizer state and normalisers are replicated: ``init_state``
broadcasts rank 0's modules once (:func:`broadcast_`), and averaged
gradients keep the replicas equal bit for bit. Per-env state
(``reward_filter.rewems``, the device env's episode bookkeeping) stays with
its rank; :func:`gather_envs` puts it in rank order for a checkpoint, and
:func:`rank_slice` takes a rank's part back on resume.

``DistributedDataParallel`` is not used: one backward covers the policy,
the RND predictor and the SSL heads, some parameters get no gradient, the
backbone runs more than once per backward under SSL and ``EncoderRemat``,
and ``eavit_tpu`` averages after the freeze zeroing, where DDP's reducer
averages inside the backward.

A ``group`` of ``None`` means no data parallelism: every function here is
then the identity. The backend is ``nccl`` for CUDA and ``gloo`` for the
CPU (:func:`backend_for`), chosen by the caller; under ``gloo`` a CUDA
tensor goes through a host copy, so two ranks may share one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def get_dist_info() -> Tuple[int, int, int, int]:
    """``(world_size, rank, local_world_size, local_rank)`` of the
    initialised process group, else ``(1, 0, 1, 0)``. The local numbers come
    from ``torchrun``'s ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK`` where it set
    them (reference dist_utils.py:9-14)."""
    if not dist.is_initialized():
        return 1, 0, 1, 0
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return world, rank, local_world, local_rank


def backend_for(device=None) -> str:
    """``nccl`` for a CUDA device (and for ``None``, which means CUDA),
    ``gloo`` for the CPU."""
    if device is None:
        return "nccl"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> None:
    """Join the process group (``eavit_tpu/parallel/dp.py:89-112``).

    Idempotent. With explicit arguments it initialises directly (the tests
    pass a ``file://`` store); otherwise it initialises from ``torchrun``'s
    variables when ``WORLD_SIZE > 1`` and is a no-op in a process launched
    alone. ``backend`` defaults to :func:`backend_for` of CUDA; a failing
    backend raises, and no other is tried. ``timeout`` in seconds bounds
    every collective."""
    if dist.is_initialized():
        return
    kw: Dict[str, Any] = {"backend": backend or backend_for(None)}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if init_method is not None or world_size is not None:
        dist.init_process_group(init_method=init_method, world_size=world_size,
                                rank=rank, **kw)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(init_method="env://", **kw)


def default_group():
    """The world's group when a process group is initialised, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _run(t: torch.Tensor, collective: Callable[[torch.Tensor], None], group) -> None:
    """``collective(t)`` in place; under gloo a CUDA tensor goes through a
    host copy."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        collective(host)
        t.copy_(host)
    else:
        collective(t)


def _coalesced(tensors: Iterable[torch.Tensor],
               collective: Callable[[torch.Tensor], None], group) -> None:
    """``collective`` on one flat buffer per dtype and device, copied back
    into ``tensors`` (one multi-tensor copy: the update that calls this a
    minibatch is bound by the host's launches)."""
    buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            _run(flat, collective, group)
            parts = torch.split(flat, [t.numel() for t in ts])
            torch._foreach_copy_(ts, [p.view_as(t) for p, t in zip(parts, ts)])


def psum_(tensors: Iterable[torch.Tensor], group) -> None:
    """Sum over the ranks, in place (``psum``)."""
    if group is not None:
        _coalesced(tensors, lambda t: dist.all_reduce(t, dist.ReduceOp.SUM, group), group)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Mean over the ranks, in place (``pmean``): one flat buffer per dtype,
    summed, then divided by the world size. At world size 1 no bit
    changes."""
    if group is None:
        return
    world = dist.get_world_size(group)

    def mean(t: torch.Tensor) -> None:
        dist.all_reduce(t, dist.ReduceOp.SUM, group)
        t.div_(world)

    _coalesced(tensors, mean, group)


def all_reduce_max_(t: torch.Tensor, group) -> None:
    """Elementwise maximum over the ranks, in place (``pmax``)."""
    if group is not None:
        _run(t, lambda x: dist.all_reduce(x, dist.ReduceOp.MAX, group), group)


def pooled_moments(batch_sum: torch.Tensor, batch_sumsq: torch.Tensor, count: float,
                   group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, var, count)`` of the batch of every rank together, from
    each rank's ``sum``, ``sumsq`` and ``count`` summed over the ranks
    (``eavit_tpu/rl/normalizer.py:87-93``, ``rl/agent.py:373-382``); the
    sums are summed in place."""
    count_t = torch.tensor(float(count), dtype=torch.float32, device=batch_sum.device)
    psum_([batch_sum, batch_sumsq, count_t], group)
    mean = batch_sum / count_t
    return mean, batch_sumsq / count_t - torch.square(mean), count_t


def broadcast_(tensors: Union[nn.Module, Iterable[torch.Tensor]], group, src: int = 0) -> None:
    """Overwrite ``tensors`` (or a module's parameters and buffers) with
    rank ``src``'s, in place."""
    if group is None:
        return
    if isinstance(tensors, nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    _coalesced(tensors, lambda t: dist.broadcast(t, src, group), group)


def gather_envs(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's per-env tensor ``[n, ...]`` concatenated in rank order
    along the env axis, on every rank: the one global array ``eavit_tpu``
    keeps for a sharded ``[N]``."""
    if group is None:
        return t
    world = dist.get_world_size(group)
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group)
    out = torch.cat(parts).to(t.device)
    return out.bool() if t.dtype == torch.bool else out


def gather_objects(obj: Any, group) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if group is None:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group)
    return out


def broadcast_object(obj: Any, group, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group)
    return box[0]


# ---------------------------------------------------------------------------
# the env axis
# ---------------------------------------------------------------------------


def env_slice(num_envs: int, group) -> Tuple[int, int]:
    """The envs ``[lo, hi)`` of this rank when one fleet of ``num_envs`` is
    split over the ranks; raises when the world size does not divide it
    (``eavit_tpu/parallel/dp.py:127``)."""
    world, rank = group_size(group), group_rank(group)
    if num_envs % world:
        raise ValueError(f"NumEnvPerProcess = {num_envs} must divide over {world} ranks")
    n = num_envs // world
    return rank * n, (rank + 1) * n


def rank_slice(t: torch.Tensor, num_local: int, group) -> torch.Tensor:
    """This rank's part of a per-env array read from a checkpoint: the array
    as it is without a group or when it holds ``num_local`` envs (a run of
    one rank, or a fleet every rank repeats), else rank r's ``[r *
    num_local, (r + 1) * num_local)`` when it holds every rank's."""
    n = t.shape[0]
    if group is None or n == num_local:
        return t
    world, rank = group_size(group), group_rank(group)
    if n != world * num_local:
        raise ValueError(f"a per-env array of {n} envs fits neither {num_local} envs "
                         f"nor {world} ranks x {num_local}")
    return t[rank * num_local:(rank + 1) * num_local]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own stream: ``seed`` itself on rank 0, so
    that one rank draws what a run without data parallelism draws, and a
    mix of (seed, rank) elsewhere (the role of ``fold_in(rng,
    axis_index)`` in ``eavit_tpu``)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint32)[0])


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------


def data_axis_size(cfg, world_size: int) -> int:
    """``DataAxisSize`` checked against the ranks that were launched: 0
    means all of them; any other value must equal their number, because a
    process has one device and the port has no virtual devices."""
    want = cfg.data_axis_size
    if want == 0 or want == world_size:
        return world_size
    raise ValueError(
        f"DataAxisSize = {want} but {world_size} rank(s) were launched: one process "
        f"runs per device, so launch with `torchrun --nproc_per_node {max(want, 1)}` "
        f"or set DataAxisSize = 0 (all ranks) or {world_size}")


def build_agent(cfg, output_size: int, action_space=None, device=None,
                num_envs: Optional[int] = None):
    """The agent of this rank (``eavit_tpu/train.py:42-54``): an
    :class:`~eavit_tpu_torch.rl.agent.RNDAgent` on ``device`` that averages
    over the world's group when a process group is initialised (a group of
    one included), after :func:`data_axis_size` has checked the config.
    ``num_envs`` is this rank's env count (default ``NumEnvPerProcess``)."""
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.rl.agent import RNDAgent

    world, _, _, _ = get_dist_info()
    data_axis_size(cfg, world)
    return RNDAgent(cfg, output_size,
                    ActionSpaceType.DISCRETE if action_space is None else action_space,
                    device=device, process_group=default_group(), num_envs=num_envs)


def flatten_tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / list of tensors, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flatten_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in flatten_tensors(x)]
    return []

