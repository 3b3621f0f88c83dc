"""Load a JAX agent's parameters and training state into the port's agent.

The JAX package keeps parameters as nested dicts (flax trees); the port's
modules mirror their names (``feature.transformer.attn_0.to_qkv`` ...), so
the mapping is by path, with these conversions:

- Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed), and
  NoisyLinear's ``noisy_kernel`` -> ``noisy_weight`` the same way (its
  ``noisy_bias`` and the continuous head's ``log_std`` keep their names);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm ``scale`` -> ``weight``;
- the RND trunks, auto-named ``ConvTrunk_0`` / ``MlpTrunk_0`` by flax, are
  the port's ``trunk``. The conv trunk flattens in NHWC order in both
  packages, so ``head1`` / ``head`` rows need no permutation;
- the SSL heads' BatchNorm parameters (``bn_scale``, ``bn{i}_scale``, ...)
  keep their names: ``params["ssl"]`` goes into ``agent.ssl`` and BYOL's
  ``ssl_target`` (``feature`` and ``projector``) into ``agent.ssl_target``.

Every parameter of the module must be covered and every shape must match,
or :func:`load_flax_tree` raises.

:func:`load_jax_state` carries a whole ``eavit_tpu`` ``AgentState`` over:
parameters, the normalisers and counters, and the optax Adam moments
(``mu``, ``nu`` and ``count`` of ``ScaleByAdamState``, which sit under the
same tree paths as the parameters and are transposed like them), so that the
port can continue a JAX run. The state comes in as numpy arrays (the caller
converts, e.g. ``jax.tree_util.tree_map(np.asarray, state)``); this module
imports neither JAX nor optax and finds the Adam state by its field names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_RENAME = {"ConvTrunk_0": "trunk", "MlpTrunk_0": "trunk"}
_TRANSPOSED = {"kernel": "weight", "noisy_kernel": "noisy_weight"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = _RENAME.get(key, key)
        path = f"{prefix}{name}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def _to_torch(path: str, value: np.ndarray) -> tuple:
    leaf = path.rsplit(".", 1)[-1]
    if leaf in _TRANSPOSED:
        path = path[: -len(leaf)] + _TRANSPOSED[leaf]
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
    elif leaf == "scale":
        path = path[: -len("scale")] + "weight"
    return path, value


def flax_tree_to_torch(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A flax param tree as ``{torch parameter name: array in torch layout}``."""
    return dict(_to_torch(path, value) for path, value in _flatten(tree).items())


def _matched(module: nn.Module, tree: Mapping[str, Any]):
    """``(parameter, converted array)`` pairs; raises unless the tree covers
    every parameter of ``module`` with the right shapes."""
    params = dict(module.named_parameters())
    arrays = flax_tree_to_torch(tree)
    unknown = sorted(set(arrays) - set(params))
    if unknown:
        raise KeyError(f"no torch parameter for flax leaves {unknown}")
    missing = sorted(set(params) - set(arrays))
    if missing:
        raise KeyError(f"torch parameters not in the flax tree: {missing}")
    for name, value in arrays.items():
        p = params[name]
        if tuple(p.shape) != tuple(value.shape):
            raise ValueError(f"{name}: torch shape {tuple(p.shape)} != "
                             f"converted flax shape {tuple(value.shape)}")
        yield p, value


def _tensor_like(p: torch.Tensor, value: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(value, copy=True)).to(p.device, p.dtype)


@torch.no_grad()
def load_flax_tree(module: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a flax param tree (numpy or jax arrays) into ``module``."""
    for p, value in _matched(module, tree):
        p.copy_(_tensor_like(p, value))


def load_jax_params(agent, params_np: Mapping[str, Any],
                    rnd_target_np: Optional[Mapping[str, Any]] = None,
                    ssl_target_np: Optional[Mapping[str, Any]] = None) -> None:
    """Load ``AgentState.params`` of an ``eavit_tpu`` agent (``{"policy":
    ..., "rnd_pred": ..., "ssl": ...}``), its ``rnd_target`` and its
    ``ssl_target`` into an :class:`~eavit_tpu_torch.rl.agent.RNDAgent`."""
    load_flax_tree(agent.network, params_np["policy"])
    if agent.use_rnd:
        load_flax_tree(agent.rnd_pred, params_np["rnd_pred"])
        if rnd_target_np is None:
            raise ValueError("an RND agent needs the JAX rnd_target tree too")
        load_flax_tree(agent.rnd_target, rnd_target_np)
    if agent.ssl is not None:
        load_flax_tree(agent.ssl, params_np["ssl"])
    if agent.ssl_target is not None:
        if ssl_target_np is None:
            raise ValueError("a BYOL agent needs the JAX ssl_target tree too")
        load_flax_tree(agent.ssl_target, ssl_target_np)


def _find_adam_state(opt_state: Any) -> Optional[Any]:
    """The ``ScaleByAdamState`` inside an optax chain state (nested tuples),
    recognised by its ``count`` / ``mu`` / ``nu`` fields."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def _f32(x: Any, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def load_jax_state(agent, state_np: Any):
    """Load a whole ``eavit_tpu`` ``AgentState`` (as numpy) into ``agent``
    and its optimizer; returns the port's ``AgentState`` (module doc)."""
    from eavit_tpu_torch.rl import normalizer as norm
    from eavit_tpu_torch.rl.agent import AgentState

    load_jax_params(agent, state_np.params, state_np.rnd_target, state_np.ssl_target)
    adam = _find_adam_state(state_np.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    trees = [(agent.network, "policy")]
    if agent.use_rnd:
        trees.append((agent.rnd_pred, "rnd_pred"))
    if agent.ssl is not None:
        trees.append((agent.ssl, "ssl"))
    agent.optimizer = agent._make_optimizer()
    step = float(np.asarray(adam.count))
    for module, key in trees:
        moments = zip(_matched(module, adam.mu[key]), _matched(module, adam.nu[key]))
        for (p, mu), (_, nu) in moments:
            agent.optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": _tensor_like(p, mu),
                "exp_avg_sq": _tensor_like(p, nu),
            }
    dev = agent.device

    def rms(s):
        return norm.RMSState(*(_f32(x, dev) for x in s))

    hi, lo = (int(v) for v in np.asarray(state_np.global_step))
    return AgentState(
        obs_rms=None if state_np.obs_rms is None else rms(state_np.obs_rms),
        reward_rms=rms(state_np.reward_rms),
        reward_filter=norm.RewardFilterState(
            rewems=_f32(state_np.reward_filter.rewems, dev)),
        global_update=int(np.asarray(state_np.global_update)),
        # the JAX counter is a [hi, lo] pair in base 2**30 (agent.py:52-61)
        global_step=hi * (1 << 30) + lo,
    )
