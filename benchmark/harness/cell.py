"""One cell's training job, built as ``eavit_tpu_torch.train.train`` builds
it, and its iteration.

:class:`Job` mirrors ``train.train``'s set-up and the body of its loop,
which is no function the benchmark could call: on the host-env path
``make_vector_env``, ``dp.build_agent``, ``agent.init_state``, ``Rng``,
``DeviceRolloutCollector`` and ``collector.warmup_obs_rms``; on the
device-env path ``make_device_env`` and ``ScanRolloutCollector`` with the
warm-up rollouts. One iteration is ``collector.collect``, ``agent.update``
and the read-back of every metric to a host ``float``. Logging and
checkpoints are left out. The weights are the benchmark's, made from the
seed (``reference/weights.py``), and copied over the ones ``init_state``
drew.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from benchmark.reference import model as ref_model
from benchmark.reference.weights import make_weights


def _conf_text(keys: Dict[str, Any]) -> str:
    return "[DEFAULT]\n" + "".join(f"{k} = {v}\n" for k, v in keys.items())


def make_config(cell: Dict[str, Any], seed: int):
    """The port's ``Config`` of ``cell`` (its configuration's keys, then its
    traffic's) for ``seed``."""
    from eavit_tpu_torch.config import load_config

    keys = dict(cell["config_spec"]["conf"])
    keys.update(cell["traffic_spec"].get("conf", {}))
    fd, path = tempfile.mkstemp(suffix=".conf")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(_conf_text(keys))
        overrides = dict(cell["traffic_spec"].get("overrides", {}))
        overrides["seed"] = seed
        return load_config(path, overrides=overrides)
    finally:
        os.unlink(path)


def hyper(cfg, cell: Dict[str, Any]) -> Dict[str, Any]:
    """The plain numbers the reference and the work model need."""
    from eavit_tpu_torch.config import EnvType, ViTImplementation

    lucid = cfg.vit_implementation_type == ViTImplementation.LUCIDRAINS
    v, g = cfg.vit, cfg.vit_hg
    image = cfg.pre_proc_height if lucid else (g.image_size or cfg.pre_proc_height)
    patch = v.patch_size if lucid else g.patch_size
    return {
        "arch": "dual_token_vit" if lucid else "dual_token_vit_hg",
        "image": image,
        "channels": cfg.state_stack_size if lucid else (g.num_channels or cfg.state_stack_size),
        "patch": patch,
        "tokens": (image // patch) ** 2 + 2,
        "dim": v.dim if lucid else g.hidden_size,
        "depth": v.depth if lucid else g.num_hidden_layers,
        "heads": v.heads if lucid else g.num_attention_heads,
        "dim_head": v.dim_head if lucid else g.hidden_size // g.num_attention_heads,
        "mlp": v.mlp_dim if lucid else g.intermediate_size,
        "dropout": v.dropout if lucid else g.hidden_dropout_prob,
        "emb_dropout": v.emb_dropout if lucid else g.hidden_dropout_prob,
        "norm_eps": 1e-5 if lucid else g.layer_norm_eps,
        "qkv_bias": False if lucid else g.qkv_bias,
        # the lucidrains residual stream is float32, so its FFN is too; the
        # HF flavour's is in the compute dtype
        "ffn_stated": "f32" if lucid else "bf16",
        "embedding_std": cell["config_spec"]["weights"]["embedding_std"],
        "actions": 5,
        "frame": (cfg.pre_proc_height, cfg.pre_proc_width),
        "env": "device" if cfg.env_type == EnvType.SYNTHETIC_DEVICE else "host",
        "num_step": cfg.num_step,
        "num_envs": cfg.num_env_per_process,
        "obs_norm_step": cfg.obs_norm_step,
        "epoch": cfg.epoch,
        "mini_batch": cfg.mini_batch,
        "gamma": cfg.gamma, "int_gamma": cfg.int_gamma, "lam": cfg.gae_lambda,
        "ext_coef": cfg.ext_coef, "int_coef": cfg.int_coef, "ppo_eps": cfg.ppo_eps,
        "ent_coef": cfg.entropy_coef, "update_proportion": cfg.update_proportion,
        "lr": cfg.learning_rate, "adam_eps": cfg.stable_eps,
        "clip": cfg.use_grad_clipping, "max_grad_norm": cfg.max_grad_norm,
    }


def program_leaf_specs(agent, hp) -> List[ref_model.LeafSpec]:
    """The agent's parameters as leaf specs, their kinds read from the
    module types (LayerNorm, dense or conv, free parameter)."""
    out = []
    for prefix, mod in (("policy", agent.network), ("rnd_pred", agent.rnd_pred),
                        ("rnd_target", agent.rnd_target)):
        for mname, m in mod.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                name = ".".join(x for x in (prefix, mname, pname) if x)
                shape = tuple(p.shape)
                if isinstance(m, torch.nn.LayerNorm):
                    out.append((name, shape, "one" if pname == "weight" else "zero",
                                1.0 if pname == "weight" else 0.0))
                elif isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                    fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                    out.append((name, shape, "uniform", 1.0 / math.sqrt(fan_in)))
                else:
                    out.append((name, shape, "normal", hp["embedding_std"]))
    return out


def named_params(agent) -> Dict[str, torch.nn.Parameter]:
    out = {}
    for prefix, mod in (("policy", agent.network), ("rnd_pred", agent.rnd_pred),
                        ("rnd_target", agent.rnd_target)):
        for n, p in mod.named_parameters():
            out[f"{prefix}.{n}"] = p
    return out


class Spans:
    """Host-clock spans of the window's iterations; with ``sync`` each span
    ends in a ``torch.cuda.synchronize`` (the traced run)."""

    def __init__(self, sync: bool) -> None:
        self.sync = sync
        self.rows: List[Dict[str, float]] = []

    def mark(self, device) -> float:
        if self.sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()


class Job:
    """The training job of a cell, in one process on one device."""

    def __init__(self, cell: Dict[str, Any], seed: int, device) -> None:
        from eavit_tpu_torch.parallel import dp
        from eavit_tpu_torch.utils.seed import set_seed

        self.cell, self.seed = cell, seed
        self.world, self.rank, _, _ = dp.get_dist_info()
        self.cfg = make_config(cell, seed)
        dp.data_axis_size(self.cfg, self.world)
        self.hp = hyper(self.cfg, cell)
        self.device = torch.device(device)
        set_seed(self.cfg.seed)
        self.iterations = 0

    # -- set-up, as train.train does it ------------------------------------

    def build(self) -> None:
        from eavit_tpu_torch.config import EnvType
        from eavit_tpu_torch.models.layers import Rng
        from eavit_tpu_torch.parallel import dp

        cfg = self.cfg
        if cfg.env_type == EnvType.SYNTHETIC_DEVICE:
            from eavit_tpu_torch.envs.device_env import make_device_env
            from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector

            lo, hi = dp.env_slice(cfg.num_env_per_process, dp.default_group())
            self.agent = dp.build_agent(cfg, 5, device=self.device, num_envs=hi - lo)
            env_params, env_state = make_device_env(
                cfg.num_env_per_process, seed=cfg.seed, grid=cfg.synthetic_grid,
                stack=cfg.state_stack_size, height=cfg.pre_proc_height,
                width=cfg.pre_proc_width, max_episode_steps=cfg.max_step_per_episode,
                maze=cfg.synthetic_maze, texture=cfg.synthetic_texture,
                shared_world=cfg.synthetic_shared_world, variants=cfg.synthetic_variants,
                sparse_goal=cfg.synthetic_sparse_goal, goal_depth=cfg.synthetic_goal_depth,
                device=self.agent.device)
            self.state = self.agent.init_state(cfg.seed)
            self._load_weights()
            self.rng = Rng(dp.rank_seed(cfg.seed + 1, self.rank), self.agent.device)
            self.collector = ScanRolloutCollector(cfg, self.agent, env_params)
            self.env = None
            self.env_state = self.collector.shard_env_state(env_state)
        else:
            from eavit_tpu_torch.envs.builders import make_vector_env
            from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector

            self.env = make_vector_env(cfg, rank=self.rank)
            self.agent = dp.build_agent(cfg, self.env.action_space_n, device=self.device)
            self.state = self.agent.init_state(cfg.seed)
            self._load_weights()
            self.rng = Rng(dp.rank_seed(cfg.seed + 1, self.rank), self.agent.device)
            self.collector = DeviceRolloutCollector(cfg, self.agent, self.env)
            self.states = self.env.reset()

    def _load_weights(self) -> None:
        specs = program_leaf_specs(self.agent, self.hp)
        if sorted(specs) != sorted(ref_model.leaf_specs(self.hp)):
            raise RuntimeError("the program's parameters are not the reference's: "
                               "the benchmark cannot make one set of weights for both")
        w = make_weights(specs, self.seed, self.agent.device)
        with torch.no_grad():
            for name, p in named_params(self.agent).items():
                p.copy_(w[name])

    def warm_up_obs_norm(self) -> None:
        """The obs-norm warm-up of ``train.train`` on either env path."""
        if self.env is None:
            for _ in range(max(1, self.cfg.obs_norm_step)):
                ro, self.env_state, _ = self.collector.collect(self.env_state, self.rng)
                self.state = self.agent.update_obs_rms(
                    self.state, ro.next_obs.reshape((-1,) + tuple(ro.next_obs.shape[2:])))
        else:
            self.state, self.states = self.collector.warmup_obs_rms(
                self.state, self.states, self.rng)

    # -- one iteration, as the body of train.train's loop ------------------

    def frames_per_iteration(self) -> int:
        """Env frames collected and learned from per iteration."""
        return self.cfg.num_step * self.hp["num_envs"]

    def iterate(self, spans: Optional[Spans] = None) -> Dict[str, float]:
        dev = self.agent.device
        t0 = spans.mark(dev) if spans else 0.0
        with torch.profiler.record_function("collect"):
            if self.env is None:
                rollout, self.env_state, env_metrics = self.collector.collect(
                    self.env_state, self.rng)
            else:
                rollout, self.states = self.collector.collect(self.states, self.rng)
                env_metrics = {}
        t1 = spans.mark(dev) if spans else 0.0
        with torch.profiler.record_function("update"):
            self.state, metrics = self.agent.update(self.state, rollout, self.rng)
        t2 = spans.mark(dev) if spans else 0.0
        with torch.profiler.record_function("readback"):
            metrics.pop("_grads", None)
            metrics = {k: float(v) for k, v in {**metrics, **env_metrics}.items()}
            if self.env is not None:
                metrics.update(self.collector.stats.summary())
        if spans:
            t3 = spans.mark(dev)
            spans.rows.append({"collect": t1 - t0, "update": t2 - t1, "iteration": t3 - t0})
        self.iterations += 1
        return metrics

    def close(self) -> None:
        if self.env is not None:
            self.env.close()
        for name in ("agent", "collector", "env", "state", "rng", "states", "env_state"):
            if hasattr(self, name):
                delattr(self, name)


def rollout_capture(job: Job) -> Tuple[Dict[str, Any], Callable[[], None]]:
    """Observe the job's first iteration (the set-up's warm iteration): the
    trajectory the env fleet produced, the program's outputs that the
    reference judges, and the first three minibatch steps. Returns the
    record and a function that removes the observers. The observers read;
    the calls they wrap run as they are."""
    agent, collector = job.agent, job.collector
    cap: Dict[str, Any] = {"warm_obs": [], "loss": []}
    params = named_params(agent)
    trainable = {k: p for k, p in params.items() if not k.startswith("rnd_target.")}
    start = {k: p.detach().clone() for k, p in trainable.items()}

    def cpu(t):
        return torch.as_tensor(t).detach().to("cpu", copy=True)

    orig_obs = agent.update_obs_rms

    def update_obs_rms(state, next_obs_u8):
        cap["warm_obs"].append(cpu(next_obs_u8))
        return orig_obs(state, next_obs_u8)

    orig_collect = collector.collect

    def collect(*args):
        out = orig_collect(*args)
        ro = out[0]
        if cap.get("armed") and "states" not in cap:
            final = out[1].stack if job.env is None else out[1]
            cap.update(states=cpu(ro.states), final=cpu(final), actions=cpu(ro.actions),
                       rewards=cpu(ro.rewards), dones=cpu(ro.dones),
                       next_obs=cpu(ro.next_obs),
                       values=torch.stack([cpu(ro.value_ext), cpu(ro.value_int)], dim=-1),
                       logits=cpu(ro.policy))
        return out

    orig_prepare = agent.prepare_batch

    def prepare_batch(state, ro):
        new_state, batch, metrics = orig_prepare(state, ro)
        if "adv" not in cap:
            cap.update(adv=cpu(batch.adv), ext_target=cpu(batch.ext_target),
                       int_target=cpu(batch.int_target))
        return new_state, batch, metrics

    orig_step = agent._minibatch_step
    count = [0]

    def minibatch_step(batch, idx, rng, plist):
        k = count[0]
        count[0] += 1
        if k == 3:
            cap["change"] = {n: (p.detach() - start[n]).cpu() for n, p in trainable.items()}
            start.clear()
        aux = orig_step(batch, idx, rng, plist)
        if k < 3:
            cap["loss"].append(float(aux["train/loss"]))
        if k == 0:
            opt = agent.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            # a step that never reached the optimizer leaves no state: no gradient
            cap["grad_norms"] = {
                n: float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for n, p in trainable.items()}
        return aux

    agent.update_obs_rms = update_obs_rms
    collector.collect = collect
    agent.prepare_batch = prepare_batch
    agent._minibatch_step = minibatch_step

    def remove() -> None:
        for obj, name in ((agent, "update_obs_rms"), (collector, "collect"),
                          (agent, "prepare_batch"), (agent, "_minibatch_step")):
            obj.__dict__.pop(name, None)
        start.clear()

    return cap, remove
