"""The RND/PPO agent: modules, optimizer, normaliser state, act and update.

Counterpart of ``eavit_tpu/rl/agent.py`` (reference agents.py:30-624 and
train.py:580-870):

- :meth:`RNDAgent.act` -- policy forward and sampling, one call per env
  step (agent.py:211-260); dropout and the NoisyNet noise are live unless
  ``deterministic_model``. Discrete actions sample the softmax; continuous
  ones the Normal over the tanh mean, and the agent returns their
  log-probs ``[N, 1]`` in place of logits.
- :meth:`RNDAgent.compute_intrinsic_reward` and
  :meth:`RNDAgent.update_obs_rms` (agent.py:267-318). ``original_RND``
  normalises the raw last frame; ``modified_RND`` the deterministic
  backbone embedding of the whole next-obs stack (``extract_features``, run
  in chunks of ``feature_chunk`` frames), through an ``obs_rms`` of shape
  ``[1, D]``.
- :meth:`RNDAgent.prepare_batch` -- steps 1-4 of ``_update_impl``
  (agent.py:341-446) in the same order: reward clip, RND intrinsic rewards
  with the PRE-update ``obs_rms``, the reward filter and reward RMS, dual
  GAE and advantage mixing, then the ``obs_rms`` update and the RND train
  input normalised with the POST-update ``obs_rms`` (reference
  train.py:662-673 vs 772-779). Under ``modified_RND`` the JAX package runs
  the backbone over the next-obs three times with the same parameters
  (agent.py:360, :437, :445); its forward is deterministic, so the port
  runs it once and uses the embedding for all three.

- :meth:`RNDAgent.update` -- ``prepare_batch`` and then step 5
  (agent.py:448-614): ``Epoch`` passes of ``MiniBatch`` Adam steps over one
  permutation each, dropout live, loss ``actor + 0.5 * critic - Entropy *
  entropy + rnd + coef * representation``, the metrics averaged over
  minibatches and then epochs under the JAX names.
- With ``representationLearningMethod`` set, ``self.ssl`` holds the SSL
  head (``models/ssl.py``) and, under BYOL, ``self.ssl_target`` its EMA
  target. The representation term (unless ``freeze_shared_backbone``) runs
  on the minibatch's frames, two views whose augment parameters
  :meth:`RNDAgent._augment_params` draws; the EMA steps after every
  optimizer step, under the freeze too (agent.py:492-506, :568-569).

Parameters live in the agent's modules on ``self.device`` and are updated
in place by the agent's ``torch.optim.Adam`` (the JAX package threads
params and the optax state through ``AgentState``); the normalisers and
counters live in an :class:`AgentState`. Gradient clipping follows
``optax.clip_by_global_norm``. ``EncoderRemat = full | dots`` recomputes
the encoder's sublayers in the backward (``models/vit.py``). The agent runs
on CUDA unless the caller passes ``device="cpu"``; with no GPU and no
device it raises.

Data parallelism (``eavit_tpu``'s ``axis_name``, agent.py:106-111): with a
``process_group`` (``parallel/dp.py``) each rank updates from its own envs'
rollout and the agent calls the collectives where the JAX agent has
``pmean`` / ``psum``: ``obs_rms`` and the reward RMS pool their moments
(agent.py:317, :373-385, :434, :444), the gradients are averaged after the
freeze zeroing and before the norm, the clip and Adam (:563-564), and every
metric is averaged at the end of :meth:`RNDAgent.update` (:599-601).
``global_step`` adds the rank's own ``T * N`` (:332, :611). ``init_state``
broadcasts rank 0's modules, so the replicas start and stay equal; a
checkpoint holds every rank's ``reward_filter.rewems`` in rank order.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from eavit_tpu_torch.config import Config, TrainMethod
from eavit_tpu_torch.models.layers import Rng, init_module
from eavit_tpu_torch.models.policy import ActionSpaceType, ActorCritic
from eavit_tpu_torch.models.rnd import (
    RNDPredictor,
    RNDTarget,
    intrinsic_reward,
    rnd_loss,
)
from eavit_tpu_torch.models.ssl import Views, make_ssl
from eavit_tpu_torch.ops.gae import make_train_data
from eavit_tpu_torch.parallel import dp
from eavit_tpu_torch.rl import normalizer as norm
from eavit_tpu_torch.rl.ppo import (
    categorical_entropy,
    categorical_log_prob,
    clip_by_global_norm_,
    global_grad_norm,
    normal_entropy,
    normal_log_prob,
    ppo_surrogate,
    sample_categorical,
    sample_normal,
)
from eavit_tpu_torch.utils.trace import span


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or CUDA; raises when CUDA is missing and no
    device was named (no silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch path on the CPU")
    return torch.device("cuda")


class AgentState(NamedTuple):
    """Normaliser state and counters (the agent's modules hold the params)."""

    obs_rms: Optional[norm.RMSState]  # None in PPO mode
    reward_rms: norm.RMSState
    reward_filter: norm.RewardFilterState
    global_update: int  # updates done (the int_coef decay reads it)
    global_step: int = 0  # env frames consumed


class Rollout(NamedTuple):
    """One n-step rollout, time-major [T, N, ...] (uint8 frames)."""

    states: torch.Tensor  # [T, N, C, H, W] uint8
    actions: torch.Tensor  # [T, N] int64 (discrete) | [T, N, A] f32 (continuous)
    rewards: torch.Tensor  # [T, N] f32 raw env rewards
    dones: torch.Tensor  # [T, N] bool
    next_obs: torch.Tensor  # [T, N, 1|C, H, W] uint8
    value_ext: torch.Tensor  # [T+1, N] f32
    value_int: torch.Tensor  # [T+1, N] f32
    policy: torch.Tensor  # [T, N, A] logits | [T, N, 1] log-probs (continuous)


class TrainBatch(NamedTuple):
    """Env-major [N*T, ...] inputs of the SGD loop."""

    states: torch.Tensor
    actions: torch.Tensor
    old_policy: torch.Tensor
    adv: torch.Tensor
    ext_target: torch.Tensor
    int_target: Optional[torch.Tensor]
    rnd_in: Optional[torch.Tensor]


class RNDAgent:
    """Owns the policy and RND modules on one device."""

    # frames per backbone call of the modified_RND embedding pass: bounds its
    # activations (0.42 GB a float32 [2048, 198, 256] tensor at the
    # flagship width); the embedding of a frame does not depend on it
    feature_chunk = 2048

    def __init__(
        self,
        cfg: Config,
        output_size: int,
        action_space: ActionSpaceType = ActionSpaceType.DISCRETE,
        device=None,
        process_group=None,
        num_envs: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        # the ranks that average with this one (None: no data parallelism),
        # and the envs of this rank's rollouts
        self.process_group = process_group
        self.num_envs = cfg.num_env_per_process if num_envs is None else num_envs
        self.output_size = output_size
        self.action_space = action_space
        self.train_method = cfg.train_method
        self.network = ActorCritic(cfg, output_size, action_space)
        self.discrete = ActionSpaceType(action_space) == ActionSpaceType.DISCRETE
        self.use_rnd = self.train_method in (TrainMethod.ORIGINAL_RND,
                                             TrainMethod.MODIFIED_RND)
        self.pixel_rnd = self.train_method == TrainMethod.ORIGINAL_RND
        self.rnd_pred = self.rnd_target = None
        if self.use_rnd:
            self.rnd_pred = RNDPredictor(self._rnd_shape(), self.pixel_rnd)
            self.rnd_target = RNDTarget(self._rnd_shape(),
                                        self.pixel_rnd).requires_grad_(False)
        # the SSL head and, under BYOL, its target: a copy of the backbone
        # and the projector that init_state overwrites with the online ones
        self.ssl = make_ssl(cfg)
        self.ssl_target = None
        if self.ssl is not None:
            self.ssl_target = self.ssl.make_target(self.network.feature)
        for m in self._modules().values():
            m.to(self.device)
        self.optimizer = self._make_optimizer()

    def _rnd_shape(self) -> Tuple[int, ...]:
        """The RND input of one sample: a frame ``(H, W)`` or an embedding
        ``(D,)``."""
        if self.pixel_rnd:
            return (self.cfg.pre_proc_height, self.cfg.pre_proc_width)
        return (self.cfg.backbone_dim,)

    def _modules(self) -> Dict[str, nn.Module]:
        named = {"policy": self.network, "rnd_pred": self.rnd_pred,
                 "rnd_target": self.rnd_target, "ssl": self.ssl,
                 "ssl_target": self.ssl_target}
        return {k: m for k, m in named.items() if m is not None}

    def trainable_parameters(self) -> List[nn.Parameter]:
        """Policy, ``rnd_pred`` and the online SSL parameters: what the
        optimizer steps (the optax state covers ``params["ssl"]``,
        agent.py:183-195)."""
        params = list(self.network.parameters())
        if self.use_rnd:
            params += list(self.rnd_pred.parameters())
        if self.ssl is not None:
            params += list(self.ssl.parameters())
        return params

    def _make_optimizer(self) -> torch.optim.Adam:
        # torch.optim.Adam defaults with StableEps as eps (agent.py:148-163)
        return torch.optim.Adam(self.trainable_parameters(), lr=self.cfg.learning_rate,
                                betas=(0.9, 0.999), eps=self.cfg.stable_eps)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> AgentState:
        """Initialise every module from ``seed``, reset the optimizer and
        return fresh normalisers (agent.py:165-205). With a process group the
        modules then take rank 0's values."""
        cfg = self.cfg
        gen = torch.Generator("cpu")
        gen.manual_seed(seed)
        for k, m in self._modules().items():
            if k == "ssl_target":
                continue  # a copy of the online modules, below
            m.to("cpu")
            init_module(m, gen)
            m.to(self.device)
        if self.ssl_target is not None:
            self.ssl.copy_to_target(self.ssl_target, self.network.feature)
        for m in self._modules().values():
            dp.broadcast_(m, self.process_group)
        self.optimizer = self._make_optimizer()
        obs_rms = None
        if self.use_rnd:
            obs_rms = norm.rms_init((1,) + self._rnd_shape(), device=self.device)
        return AgentState(
            obs_rms=obs_rms,
            reward_rms=norm.rms_init((), device=self.device),
            reward_filter=norm.reward_filter_init(self.num_envs, self.device),
            global_update=0,
            global_step=0,
        )

    # ------------------------------------------------------------------
    # everything a checkpoint holds
    # ------------------------------------------------------------------

    def state_dict(self, state: AgentState) -> Dict[str, Any]:
        """Modules, optimizer and ``state`` as one dict of tensors and plain
        Python numbers (what ``utils/checkpoint.py`` saves). With a process
        group every rank calls it: ``rewems`` is gathered in rank order."""
        out: Dict[str, Any] = {k: m.state_dict() for k, m in self._modules().items()}
        out["optimizer"] = self.optimizer.state_dict()
        out["agent_state"] = {
            "obs_rms": None if state.obs_rms is None else tuple(state.obs_rms),
            "reward_rms": tuple(state.reward_rms),
            "reward_filter": (dp.gather_envs(state.reward_filter.rewems,
                                             self.process_group),),
            "global_update": int(state.global_update),
            "global_step": int(state.global_step),
        }
        return out

    def load_state_dict(self, payload: Dict[str, Any]) -> AgentState:
        """Inverse of :meth:`state_dict`: loads modules and optimizer in
        place and returns the ``AgentState`` on the agent's device, with
        this rank's part of ``rewems``."""
        for k, m in self._modules().items():
            m.load_state_dict(payload[k])
        self.optimizer.load_state_dict(payload["optimizer"])
        st = payload["agent_state"]

        def on_device(ts):
            return [t.to(self.device) for t in ts]

        obs_rms = st["obs_rms"]
        return AgentState(
            obs_rms=None if obs_rms is None else norm.RMSState(*on_device(obs_rms)),
            reward_rms=norm.RMSState(*on_device(st["reward_rms"])),
            reward_filter=norm.RewardFilterState(dp.rank_slice(
                *on_device(st["reward_filter"]), self.num_envs, self.process_group)),
            global_update=int(st["global_update"]),
            global_step=int(st["global_step"]),
        )

    def _obs(self, obs_u8) -> torch.Tensor:
        return torch.as_tensor(obs_u8).to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # act
    # ------------------------------------------------------------------

    @torch.no_grad()
    def act(self, obs_u8, rng: Rng, deterministic_model: bool = False,
            greedy: bool = False):
        """Policy forward + sampling (agent.py:211-260). ``obs_u8`` is
        [N, C, H, W] uint8 (numpy or tensor). Returns ``(actions, value_ext
        [N], value_int [N], policy)`` on the device: actions [N] and logits
        [N, A] for discrete actions, actions [N, A] and their log-probs
        [N, 1] for continuous ones, whose greedy action is the mean."""
        obs = self._obs(obs_u8).float() / 255.0
        out = self.network(obs, None if deterministic_model else rng)
        v_ext, v_int = out.value_ext[:, 0], out.value_int[:, 0]
        if self.discrete:
            if greedy:
                actions = torch.argmax(out.policy, dim=-1)
            else:
                actions = sample_categorical(out.policy, rng.device)
            return actions, v_ext, v_int, out.policy
        if greedy:
            actions = out.policy
            logp = normal_log_prob(out.policy, out.std, actions)
        else:
            actions, logp = sample_normal(out.policy, out.std, rng.device)
        return actions, v_ext, v_int, logp[:, None]

    # ------------------------------------------------------------------
    # intrinsic reward and obs normalisation
    # ------------------------------------------------------------------

    def _rnd_source(self, next_obs_u8: torch.Tensor) -> torch.Tensor:
        """What ``obs_rms`` normalises (agent.py:273-289): the raw 0..255
        pixels of the last frame (``original_RND``, reference
        train.py:662-666), or the deterministic backbone embedding of
        ``next_obs / 255`` (``modified_RND``, train.py:667-673), computed
        ``feature_chunk`` frames at a time."""
        if self.pixel_rnd:
            return next_obs_u8.float()
        return torch.cat([self.network.extract_features(c.float() / 255.0)
                          for c in torch.split(next_obs_u8, self.feature_chunk)])

    def _intrinsic(self, obs_rms, source: torch.Tensor) -> torch.Tensor:
        x = norm.rms_normalize(obs_rms, source)
        return intrinsic_reward(self.rnd_target(x), self.rnd_pred(x))

    @torch.no_grad()
    def compute_intrinsic_reward(self, state: AgentState, next_obs_u8) -> torch.Tensor:
        if not self.use_rnd:
            raise ValueError('RND cannot be used with TrainMethod == "PPO"')
        return self._intrinsic(state.obs_rms, self._rnd_source(self._obs(next_obs_u8)))

    @torch.no_grad()
    def update_obs_rms(self, state: AgentState, next_obs_u8) -> AgentState:
        """Fold a batch of raw next-obs into obs_rms (agent.py:300-318)."""
        if not self.use_rnd:
            return state
        x = self._rnd_source(self._obs(next_obs_u8))
        return state._replace(obs_rms=norm.rms_update(state.obs_rms, x, self.process_group))

    # ------------------------------------------------------------------
    # steps 1-4 of the update
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prepare_batch(
        self, state: AgentState, ro: Rollout
    ) -> Tuple[AgentState, TrainBatch, Dict[str, torch.Tensor]]:
        """Rewards, intrinsic rewards, normalisers, dual GAE and the RND
        train input (agent.py:341-446), in that order. Returns the state
        with the new ``obs_rms`` / ``reward_rms`` / ``reward_filter``, the
        env-major batch the SGD loop consumes, and the data metrics."""
        cfg = self.cfg
        T, N = ro.rewards.shape
        num_samples = T * N

        def env_major(x):  # [T, N, ...] -> [N*T, ...]
            return x.transpose(0, 1).reshape((num_samples,) + tuple(x.shape[2:]))

        total_reward = torch.clamp(ro.rewards.T.float(), -1.0, 1.0)  # [N, T]
        total_done = ro.dones.T.float()
        value_ext, value_int = ro.value_ext.T, ro.value_int.T
        new_obs_rms, new_reward_rms = state.obs_rms, state.reward_rms
        new_reward_filter = state.reward_filter
        int_target = rnd_train_in = None
        metrics: Dict[str, torch.Tensor] = {}

        if self.use_rnd:
            source = self._rnd_source(env_major(ro.next_obs))
            # intrinsic rewards with the PRE-update obs_rms
            total_int_reward = self._intrinsic(state.obs_rms, source).reshape(N, T)
            new_reward_filter, per_step = norm.reward_filter_scan(
                state.reward_filter, total_int_reward, cfg.int_gamma)
            flat = per_step.reshape(-1)
            if dp.group_size(self.process_group) > 1:
                # every rank's filtered returns together (agent.py:373-382)
                mean, var, _ = dp.pooled_moments(flat.sum(), torch.square(flat).sum(),
                                                  flat.numel(), self.process_group)
            else:
                mean, var = flat.mean(), flat.var(unbiased=False)
            new_reward_rms = norm.rms_update_from_moments(
                state.reward_rms, mean, var, per_step.shape[0])
            total_int_reward = total_int_reward / torch.sqrt(new_reward_rms.var)
            metrics["data/int_reward_per_epi"] = total_int_reward.sum(dim=1).mean()
            metrics["data/int_reward_per_rollout"] = total_int_reward.mean()

        ext_target, ext_adv = make_train_data(
            total_reward, total_done, value_ext, cfg.gamma, cfg.gae_lambda, cfg.use_gae)
        if self.use_rnd:
            int_tgt, int_adv = make_train_data(
                total_int_reward, torch.zeros_like(total_int_reward), value_int,
                cfg.int_gamma, cfg.gae_lambda, cfg.use_gae)
            int_coef = cfg.int_coef
            if cfg.int_coef_decay_updates > 0:
                frac = min(max(1.0 - state.global_update / cfg.int_coef_decay_updates,
                               0.0), 1.0)
                int_coef = cfg.int_coef * frac
                metrics["train/int_coef"] = torch.tensor(int_coef, device=self.device)
            total_adv = int_adv * int_coef + ext_adv * cfg.ext_coef
            int_target = int_tgt.reshape(-1)
        else:
            total_adv = ext_adv * cfg.ext_coef

        if self.use_rnd:
            # obs_rms update, then the RND train input with the POST-update stats
            new_obs_rms = norm.rms_update(state.obs_rms, source, self.process_group)
            rnd_train_in = norm.rms_normalize(new_obs_rms, source)

        metrics["data/ext_reward_per_rollout_mean"] = total_reward.mean()
        metrics["data/ext_reward_per_rollout_sum"] = total_reward.sum()
        batch = TrainBatch(
            states=env_major(ro.states),
            actions=env_major(ro.actions),
            old_policy=env_major(ro.policy),
            adv=total_adv.reshape(-1),
            ext_target=ext_target.reshape(-1),
            int_target=int_target,
            rnd_in=rnd_train_in,
        )
        new_state = state._replace(
            obs_rms=new_obs_rms, reward_rms=new_reward_rms,
            reward_filter=new_reward_filter)
        return new_state, batch, metrics

    # ------------------------------------------------------------------
    # step 5: the SGD loop
    # ------------------------------------------------------------------

    def _permutation(self, rng: Rng, n: int) -> torch.Tensor:
        """One epoch's sample order, drawn on the agent's device."""
        return torch.randperm(n, generator=rng.device, device=self.device)

    def _augment_params(self, rng: Rng, n: int) -> Views:
        """The augment parameters of the two SSL views of ``n`` frames, drawn
        on the agent's device."""
        cfg = self.cfg
        return self.ssl.draw(rng.device, n, cfg.pre_proc_height, cfg.pre_proc_width,
                             self.device)

    def _loss(self, batch: TrainBatch, idx: torch.Tensor,
              rng: Rng) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss of the minibatch ``idx`` with dropout live (``loss_fn``,
        agent.py:453-522)."""
        cfg = self.cfg
        obs = batch.states[idx].float() / 255.0
        out = self.network(obs, rng)
        actions = batch.actions[idx]
        if self.discrete:
            log_prob = categorical_log_prob(out.policy, actions)
            log_prob_old = categorical_log_prob(batch.old_policy[idx], actions)
            entropy = categorical_entropy(out.policy)
        else:  # the rollout stored log-probs, not logits (agent.py:463-469)
            log_prob = normal_log_prob(out.policy, out.std, actions)
            log_prob_old = batch.old_policy[idx][:, 0]
            entropy = normal_entropy(out.std, obs.shape[0])
        ppo = ppo_surrogate(
            log_prob, log_prob_old,
            batch.adv[idx], out.value_ext, batch.ext_target[idx],
            entropy, cfg.ppo_eps,
            out.value_int if self.use_rnd else None,
            batch.int_target[idx] if self.use_rnd else None,
        )
        critic_loss = ppo.critic_ext_loss + ppo.critic_int_loss
        rl = torch.zeros((), device=self.device)
        if self.use_rnd:
            x = batch.rnd_in[idx]
            with torch.no_grad():
                target = self.rnd_target(x)
            mask_u = torch.rand(x.shape[0], generator=rng.device, device=self.device)
            rl = rnd_loss(target, self.rnd_pred(x), mask_u, cfg.update_proportion)
        repr_term = torch.zeros((), device=self.device)
        if self.ssl is not None and not cfg.freeze_shared_backbone:
            # the EMA target as the last optimizer step left it
            repr_loss = self.ssl.loss(self.network.feature, self.ssl_target,
                                      batch.states[idx],
                                      self._augment_params(rng, idx.shape[0]))
            repr_term = self.ssl.loss_coef * repr_loss
        loss = (ppo.actor_loss + 0.5 * critic_loss - cfg.entropy_coef * ppo.entropy + rl
                + repr_term)
        aux = {
            "train/loss": loss,
            "train/actor_loss": ppo.actor_loss,
            "train/critic_loss": 0.5 * critic_loss,
            "train/critic_ext_loss": 0.5 * ppo.critic_ext_loss,
            "train/critic_int_loss": 0.5 * ppo.critic_int_loss,
            "train/entropy": ppo.entropy,
            "train/entropy_loss": -cfg.entropy_coef * ppo.entropy,
            "train/approx_kl": ppo.approx_kl,
            "train/max_kl": ppo.max_kl,
            "train/clipfrac": ppo.clipfrac,
            "train/rnd_loss": rl,
            "train/representation_loss": repr_term,
        }
        return loss, {k: v.detach() for k, v in aux.items()}

    def _minibatch_step(self, batch: TrainBatch, idx: torch.Tensor, rng: Rng,
                        params: List[nn.Parameter]) -> Dict[str, torch.Tensor]:
        """One Adam step on the minibatch ``idx`` (``minibatch_step``,
        agent.py:553-571); with a process group on the gradients averaged
        over the ranks."""
        cfg = self.cfg
        with span("eavit.minibatch"):
            for p in params:
                p.grad = None
            with span("eavit.forward"):
                loss, aux = self._loss(batch, idx, rng)
            with span("eavit.backward"):
                loss.backward()
                for p in params:  # a parameter the loss does not reach gets zeros
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if cfg.freeze_shared_backbone:
                    for p in self.network.feature.parameters():
                        p.grad.zero_()
            grads = [p.grad for p in params]
            with span("eavit.allreduce"):
                dp.all_reduce_mean_(grads, self.process_group)
            with span("eavit.optimizer"):
                norm_unclipped = global_grad_norm(grads)
                aux["train/grad_norm_unclipped"] = norm_unclipped
                if cfg.use_grad_clipping:
                    clip_by_global_norm_(grads, norm_unclipped, cfg.max_grad_norm)
                self.optimizer.step()
                if self.ssl is not None:
                    self.ssl.update_target(self.ssl_target, self.network.feature)
            return aux

    def _named_grads(self) -> Dict[str, Dict[str, torch.Tensor]]:
        out = {"policy": {n: p.grad.clone() for n, p in self.network.named_parameters()}}
        if self.use_rnd:
            out["rnd_pred"] = {n: p.grad.clone()
                               for n, p in self.rnd_pred.named_parameters()}
        if self.ssl is not None:
            out["ssl"] = {n: p.grad.clone() for n, p in self.ssl.named_parameters()}
        return out

    def update(self, state: AgentState, rollout: Rollout,
               rng: Rng) -> Tuple[AgentState, Dict[str, Any]]:
        """Everything between two rollouts (``_update_impl``,
        agent.py:329-614): :meth:`prepare_batch`, then ``Epoch`` x
        ``MiniBatch`` Adam steps. The modules and the optimizer are updated
        in place; returns the new ``AgentState`` and the metrics (0-dim
        tensors on the device; ``_grads`` holds the last minibatch's
        gradients under ``verbose_logging``), averaged over the ranks of the
        process group."""
        with span("eavit.update"):
            cfg = self.cfg
            with span("eavit.prepare_batch"):
                state, batch, metrics = self.prepare_batch(state, rollout)
            num_samples = batch.adv.shape[0]
            merge = max(1, cfg.minibatch_merge)
            if cfg.mini_batch % merge:
                raise ValueError(f"MiniBatch {cfg.mini_batch} is not a multiple of "
                                 f"MiniBatchMerge {merge}")
            n_mb = cfg.mini_batch // merge
            batch_size = num_samples // n_mb
            params = self.trainable_parameters()

            epoch_means: List[Dict[str, torch.Tensor]] = []
            for _ in range(cfg.epoch):
                perm = self._permutation(rng, num_samples)[: n_mb * batch_size]
                auxs = [self._minibatch_step(batch, idx, rng, params)
                        for idx in perm.reshape(n_mb, batch_size)]
                epoch_means.append({k: torch.stack([a[k] for a in auxs]).mean()
                                    for k in auxs[0]})
            if epoch_means:
                metrics.update({k: torch.stack([e[k] for e in epoch_means]).mean()
                                for k in epoch_means[0]})
                if cfg.verbose_logging:
                    metrics["_grads"] = self._named_grads()
            # every rank's metrics averaged (agent.py:599-601)
            dp.all_reduce_mean_(dp.flatten_tensors(metrics), self.process_group)
            new_state = state._replace(
                global_step=state.global_step + num_samples,
                global_update=state.global_update + 1)
            return new_state, metrics
