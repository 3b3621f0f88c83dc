"""One rank of the port's data-parallel update (tests/test_torch_port_dp.py).

    python tests/_torch_dp_worker.py <inputs.pkl> <rank> <world> <init file>

Joins a gloo group through the ``file://`` store ``<init file>``, builds the
agent of the inputs with the process group, loads the JAX parameters, takes
its rank's half of the warm-up frames, of the rollout and of the moment
batches, and writes ``<inputs.pkl>.rank<rank>`` (a pickle of numpy values):

- ``moments``: ``rms_update`` over the group of its halves of the pixel and
  embedding batches;
- ``prepared``: ``obs_rms``, ``reward_rms`` and ``rewems`` after
  ``prepare_batch`` on its half of the rollout;
- ``metrics``, ``state``, ``params``: after one ``update`` on its half of
  the rollout with the permutations of the inputs (every rank draws the
  same, as ``DataParallelAgent`` replicates its key).

Imports torch and the port only.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from eavit_tpu_torch import config as port_config  # noqa: E402
from eavit_tpu_torch.convert import load_jax_params  # noqa: E402
from eavit_tpu_torch.models.layers import Rng  # noqa: E402
from eavit_tpu_torch.parallel import dp  # noqa: E402
from eavit_tpu_torch.rl import normalizer as norm  # noqa: E402
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout  # noqa: E402


def halve(x: np.ndarray, rank: int, world: int, axis: int = 0) -> np.ndarray:
    n = x.shape[axis] // world
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


def to_np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    return tree


def main() -> None:
    path, rank, world, init_file = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        inp = pickle.load(f)
    dp.init_distributed(f"file://{init_file}", world, rank, backend="gloo", timeout=120)
    group = dp.default_group()
    out = {}
    try:
        out["moments"] = {
            name: tuple(t.numpy() for t in norm.rms_update(
                norm.rms_init(state_shape), torch.from_numpy(halve(x, rank, world)), group))
            for name, (x, state_shape) in inp["moments"].items()}

        cfg = port_config.Config(vit=port_config.ViTConfig(**inp["vit"]), **inp["cfg"])
        n_local = cfg.num_env_per_process // world
        agent = RNDAgent(cfg, inp["n_act"], device="cpu", process_group=group,
                         num_envs=n_local)
        state = agent.init_state(rank)  # another draw on each rank: the load replaces it
        load_jax_params(agent, inp["params"], inp["rnd_target"])
        state = agent.update_obs_rms(state, halve(inp["frames"], rank, world))
        ro = Rollout(**{k: torch.from_numpy(halve(v, rank, world, axis=1))
                        for k, v in inp["rollout"].items()})

        prepared, _, _ = agent.prepare_batch(state, ro)
        out["prepared"] = to_np({"obs_rms": tuple(prepared.obs_rms),
                                 "reward_rms": tuple(prepared.reward_rms),
                                 "rewems": prepared.reward_filter.rewems})

        perms = iter(inp["perms"])
        agent._permutation = lambda rng, n: torch.tensor(next(perms), dtype=torch.int64)
        new, metrics = agent.update(state, ro, Rng(11 + rank, "cpu"))
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["state"] = to_np({"obs_rms": tuple(new.obs_rms),
                              "reward_rms": tuple(new.reward_rms),
                              "rewems": new.reward_filter.rewems,
                              "global_update": new.global_update,
                              "global_step": new.global_step})
        out["params"] = {key: {n: p.detach().numpy().copy()
                               for n, p in module.named_parameters()}
                         for key, module in (("policy", agent.network),
                                             ("rnd_pred", agent.rnd_pred))}
    finally:
        torch.distributed.destroy_process_group()
    with open(f"{path}.rank{rank}", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
