"""The port's ``DeviceRolloutCollector`` (``eavit_tpu_torch/rl/device_rollout.py``)
on the CPU at a tiny width, against the port's ``RolloutCollector`` and the
JAX package.

- Serial mode equals ``RolloutCollector`` bit for bit on one ``Rng`` seed,
  dropout live, episodes of 4 steps (so mid-rollout resets fill the device
  stack), over two collects, for ``original_RND`` (next-obs the last frame),
  ``modified_RND`` (the whole stack) and continuous actions under PPO with
  NoisyNet (``pendulum_continuous.conf``'s kind: float ``[T, N, 1]`` actions
  and ``[T, N, 1]`` log-probs, on ``chip_smoke.ContinuousSmokeEnv``), and the
  episode stats agree. A returned array whose newest frames were edited in
  place is uploaded again, not continued from stale device stacks.
- Both modes replayed through the JAX network and env, as
  ``test_torch_port_device_env.py::test_collector_replays_through_jax`` does:
  at dropout 0 with one flax tree in both networks (drawn with numpy in the
  shapes of ``jax.eval_shape(init)``), states, next_obs, rewards and dones
  equal, values and logits within 1e-5.
- Pipelined mode in lockstep with the env per half fleet
  (``tests/test_device_rollout.py:121``), through resets.
- ``train.train`` collects with it (``AsyncEnvPool = True``: pipelined) and a
  resume restores the episode bookkeeping into it.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ContinuousSmokeEnv, HalfRecorder
from eavit_tpu import config as jax_config
from eavit_tpu.envs.synthetic import SyntheticVectorEnv as JaxEnv
from eavit_tpu.models.policy import ActorCritic as JaxActorCritic
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch import train as port_train
from eavit_tpu_torch.convert import load_flax_tree
from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.models.policy import ActionSpaceType
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
from eavit_tpu_torch.rl.rollout import RolloutCollector

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
VIT = dict(dim=32, patch_size=21, depth=1, heads=2, dim_head=16, mlp_dim=64)
N_ENV, N_STEP, N_ACT = 4, 6, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, epoch=1, mini_batch=2, obs_norm_step=1,
              max_step_per_episode=4)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _port_agent(continuous=False, **kw):
    cfg = port_config.Config(vit=port_config.ViTConfig(**VIT), attention_impl="pallas_qkv",
                             fused_ffn=True, **{**COMMON, **kw})
    space = ActionSpaceType.CONTINUOUS if continuous else ActionSpaceType.DISCRETE
    agent = RNDAgent(cfg, 1 if continuous else N_ACT, space, device="cpu")
    agent.init_state(0)
    return cfg, agent


def _env(continuous, seed):
    if continuous:
        return ContinuousSmokeEnv(N_ENV, seed=seed, max_steps=4)
    return SyntheticVectorEnv(N_ENV, seed=seed, max_episode_steps=4)


@pytest.mark.parametrize("method", ["original_RND", "modified_RND", "continuous"])
def test_serial_rollout_equals_rollout_collector(method):
    continuous = method == "continuous"
    if continuous:
        cfg, agent = _port_agent(True, train_method=port_config.TrainMethod.PPO,
                                 use_noisy_net=True)
    else:
        cfg, agent = _port_agent(train_method=port_config.TrainMethod(method))
    rollouts = []
    for cls in (RolloutCollector, DeviceRolloutCollector):
        env = _env(continuous, 5)
        col = cls(cfg, agent, env)
        rng = Rng(11, "cpu")
        states = env.reset()
        first, states = col.collect(states, rng)
        second, states = col.collect(states, rng)
        rollouts.append((first, second, states, col.stats.to_state()))
    (h1, h2, hs, hstats), (d1, d2, ds, dstats) = rollouts
    for ref, ours in ((h1, d1), (h2, d2)):
        for name in ref._fields:
            a, b = getattr(ref, name), getattr(ours, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name
    np.testing.assert_array_equal(hs, ds)
    assert hstats == dstats and dstats["num_episodes"] > 0
    assert d1.next_obs.shape[2] == (1 if method == "original_RND" else 4)
    if continuous:
        assert d1.actions.dtype == torch.float32
        assert d1.actions.shape == d1.policy.shape == (N_STEP, N_ENV, 1)


def test_edited_states_are_uploaded_again():
    cfg, agent = _port_agent()
    col = DeviceRolloutCollector(cfg, agent, SyntheticVectorEnv(N_ENV, seed=5))
    _, states = col.collect(col.env.reset(), Rng(1, "cpu"))
    states[:, -1] = 7  # in place: the same array, other newest frames
    ro, _ = col.collect(states, Rng(2, "cpu"))
    np.testing.assert_array_equal(_np(ro.states[0]), states)


@functools.lru_cache(maxsize=None)
def _jax_network():
    """A JAX policy network at dropout 0, its parameters drawn with numpy in
    the shapes of ``jax.eval_shape(init)`` (no init to compile), and its
    jitted deterministic forward on uint8 stacks."""
    cfg = jax_config.Config(vit=jax_config.ViTConfig(**VIT, dropout=0.0, emb_dropout=0.0),
                            attention_impl="xla", fused_ffn=False, **COMMON)
    net = JaxActorCritic(cfg=cfg, output_size=N_ACT)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 84, 84), jnp.float32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1])))
                   ).astype(np.float32), shapes)
    apply = jax.jit(lambda s: net.apply({"params": params}, s.astype(jnp.float32) / 255.0))
    return params, apply


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
def test_rollout_replays_through_jax(pipelined):
    vit = dict(VIT, dropout=0.0, emb_dropout=0.0)
    pcfg = port_config.Config(vit=port_config.ViTConfig(**vit), attention_impl="pallas_qkv",
                              fused_ffn=True, **dict(COMMON, async_env_pool=pipelined))
    params, apply = _jax_network()
    pag = RNDAgent(pcfg, N_ACT, device="cpu")
    pag.init_state(0)
    load_flax_tree(pag.network, params)
    col = DeviceRolloutCollector(pcfg, pag, SyntheticVectorEnv(N_ENV, seed=9,
                                                               max_episode_steps=4))
    assert col.pipelined == pipelined
    ro, _ = col.collect(col.env.reset(), Rng(3, "cpu"))

    jenv = JaxEnv(N_ENV, seed=9, max_episode_steps=4)
    js = jenv.reset()
    for t in range(N_STEP + 1):
        out = apply(jnp.asarray(js))
        np.testing.assert_allclose(_np(ro.value_ext[t]), _np(out.value_ext[:, 0]), **TOL)
        np.testing.assert_allclose(_np(ro.value_int[t]), _np(out.value_int[:, 0]), **TOL)
        if t == N_STEP:
            break
        np.testing.assert_array_equal(_np(ro.states[t]), js)
        np.testing.assert_allclose(_np(ro.policy[t]), _np(out.policy), **TOL)
        js, jr, jd, _, _ = jenv.step(_np(ro.actions[t]))
        np.testing.assert_array_equal(_np(ro.rewards[t]), jr)
        np.testing.assert_array_equal(_np(ro.dones[t]), jd)
        np.testing.assert_array_equal(_np(ro.next_obs[t]), js[:, -1:])


def test_pipelined_rollout_matches_env_lockstep():
    cfg, agent = _port_agent(async_env_pool=True)
    env = HalfRecorder(SyntheticVectorEnv(N_ENV, seed=7, max_episode_steps=4))
    col = DeviceRolloutCollector(cfg, agent, env)
    assert col.pipelined
    ro, final = col.collect(env.reset(), Rng(1, "cpu"))
    h = N_ENV // 2
    for lo in (0, h):
        recorded = env.rec[lo]
        assert len(recorded) == N_STEP + 1
        for t in range(N_STEP):
            np.testing.assert_array_equal(_np(ro.states[t, lo:lo + h]), recorded[t])
            np.testing.assert_array_equal(_np(ro.next_obs[t, lo:lo + h])[:, 0],
                                          recorded[t + 1][:, -1])
    np.testing.assert_array_equal(final, np.concatenate([env.rec[0][-1], env.rec[h][-1]]))
    assert col.stats.num_episodes > 0
    # the second collect carries the device stacks over
    ro2, _ = col.collect(final, Rng(2, "cpu"))
    np.testing.assert_array_equal(_np(ro2.states[0]), final)


def test_train_collects_on_the_device_and_resume_restores_the_stats(tmp_path, monkeypatch):
    made = []

    class Spy(DeviceRolloutCollector):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(port_train, "DeviceRolloutCollector", Spy)
    cfg = port_config.Config(vit=port_config.ViTConfig(**VIT), attention_impl="pallas_qkv",
                             fused_ffn=True, save_model_path=str(tmp_path / "ck"),
                             log_name="dr", save_ckpt_every=2,
                             env_type=port_config.EnvType.SYNTHETIC,
                             **dict(COMMON, async_env_pool=True))
    metrics = port_train.train(cfg, total_updates=2, log_dir=str(tmp_path / "logs"),
                               device="cpu")
    assert np.isfinite(metrics["train/loss"]) and made[0].pipelined
    saved = json.loads((tmp_path / "ck" / "dr.json").read_text())["episode_stats"]
    assert saved == made[0].stats.to_state() and saved["num_episodes"] > 0

    resumed = cfg.replace(load_model=True, load_model_path=str(tmp_path / "ck" / "dr"),
                          save_model_path=str(tmp_path / "ck2"))
    def stop(self, *args):  # the state as the loop would first see it
        raise RuntimeError("restored")

    monkeypatch.setattr(Spy, "collect", stop)
    with pytest.raises(RuntimeError, match="restored"):
        port_train.train(resumed, total_updates=3, log_dir=str(tmp_path / "logs"),
                         device="cpu")
    assert made[1].stats.to_state() == saved
