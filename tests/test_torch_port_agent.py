"""The torch port's acting path (eavit_tpu_torch/rl) against the JAX package.

A JAX ``RNDAgent`` at a tiny width is initialised, its parameters are
loaded into the port's agent with ``convert.load_jax_params``, and both see
the same numpy inputs, at float32 (tolerance 1e-5 relative). The JAX side
uses ``AttentionImpl = xla`` without the fused FFN (the kernels' own
parity is in test_torch_port_flash_qkv / _fused_ffn / _vit); the port side
runs its kernel routes, which take their plain versions on the CPU.

Covered: RND intrinsic rewards (which catch the NHWC flatten of the conv
trunk), ``prepare_batch`` against the JAX pieces composed as in
``eavit_tpu/rl/agent.py:344-446`` and against the normalisers returned by
the JAX ``update``, a greedy deterministic 2-env x 8-step rollout, GAE and
the normalisers, and that no entry point falls back to the CPU silently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.envs.synthetic import SyntheticVectorEnv as JaxEnv
from eavit_tpu.ops.gae import make_train_data as jax_gae
from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import load_jax_params
from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.ops import flash_qkv, fused_ffn
from eavit_tpu_torch.ops.gae import make_train_data
from eavit_tpu_torch.rl import agent as port_agent
from eavit_tpu_torch.rl import normalizer as norm
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from eavit_tpu_torch.rl.rollout import RolloutCollector

from _torch_port_jax_state import agent_state

# One intra-op thread: the suite runs several test processes on one host, and
# torch's thread pools spinning against each other (and against XLA's) make
# these many small ops an order of magnitude slower than one thread does.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# one layer: the model parity at depth 2 is test_torch_port_vit's
TINY = dict(dim=48, patch_size=12, depth=1, heads=4, dim_head=12, mlp_dim=96)
N_ENV, N_STEP, N_ACT = 2, 8, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, epoch=1, mini_batch=1, obs_norm_step=1)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    """(jax_agent, jax_state, port_agent, port_state) with equal params."""
    jcfg = jax_config.Config(vit=jax_config.ViTConfig(**TINY), attention_impl="xla",
                             fused_ffn=False, **COMMON)
    pcfg = port_config.Config(vit=port_config.ViTConfig(**TINY),
                              attention_impl="pallas_qkv", fused_ffn=True, **COMMON)
    jag = JaxAgent(jcfg, N_ACT)
    jst = agent_state(jag, 0)  # drawn with numpy: no init_state to compile
    pag = RNDAgent(pcfg, N_ACT, device="cpu")
    pst = pag.init_state(0)
    load_jax_params(pag, jax.tree_util.tree_map(_np, jst.params),
                    jax.tree_util.tree_map(_np, jst.rnd_target))
    frames = np.random.default_rng(0).integers(0, 256, (16, 1, 84, 84), dtype=np.uint8)
    return jag, jag.update_obs_rms(jst, jnp.asarray(frames)), pag, pag.update_obs_rms(pst, frames)


def _rollout(seed):
    rng = np.random.default_rng(seed)
    T, N = N_STEP, N_ENV
    return dict(
        states=rng.integers(0, 256, (T, N, 4, 84, 84), dtype=np.uint8),
        actions=rng.integers(0, N_ACT, (T, N)).astype(np.int32),
        rewards=rng.choice([0.0, 1.0, 3.0], (T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        next_obs=rng.integers(0, 256, (T, N, 1, 84, 84), dtype=np.uint8),
        value_ext=rng.standard_normal((T + 1, N)).astype(np.float32),
        value_int=rng.standard_normal((T + 1, N)).astype(np.float32),
        policy=rng.standard_normal((T, N, N_ACT)).astype(np.float32),
    )


def test_obs_rms_and_intrinsic_reward_match_jax(pair):
    jag, jst, pag, pst = pair
    for a, b in zip(pst.obs_rms, jst.obs_rms):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    nxt = np.random.default_rng(1).integers(0, 256, (6, 1, 84, 84), dtype=np.uint8)
    ours = pag.compute_intrinsic_reward(pst, nxt)
    ref = jag.compute_intrinsic_reward(jst, jnp.asarray(nxt))
    assert ours.shape == (6,)
    np.testing.assert_allclose(ours.numpy(), _np(ref), **TOL)


def test_prepare_batch_matches_jax(pair):
    jag, jst, pag, pst = pair
    cfg = jag.cfg
    ro = _rollout(2)
    new, batch, metrics = pag.prepare_batch(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}))

    # the JAX pieces, composed as in eavit_tpu/rl/agent.py:344-446
    T, N = N_STEP, N_ENV
    env_major = lambda x: jnp.swapaxes(jnp.asarray(x), 0, 1).reshape((T * N,) + x.shape[2:])  # noqa: E731
    total_reward = jnp.clip(jnp.asarray(ro["rewards"]).T, -1.0, 1.0)
    nxt = env_major(ro["next_obs"])
    int_r = jag._intrinsic_impl(jst.params, jst.rnd_target, jst.obs_rms, nxt).reshape(N, T)
    filt, per_step = jax_norm.reward_filter_scan(jst.reward_filter, int_r, cfg.int_gamma)
    rrms = jax_norm.rms_update_from_moments(
        jst.reward_rms, jnp.mean(per_step), jnp.var(per_step), per_step.shape[0])
    int_r = int_r / jnp.sqrt(rrms.var)
    ext_t, ext_a = jax_gae(total_reward, jnp.asarray(ro["dones"]).T.astype(jnp.float32),
                           jnp.asarray(ro["value_ext"]).T, cfg.gamma, cfg.gae_lambda)
    int_t, int_a = jax_gae(int_r, jnp.zeros_like(int_r), jnp.asarray(ro["value_int"]).T,
                           cfg.int_gamma, cfg.gae_lambda)
    obs_rms = jax_norm.rms_update(jst.obs_rms, nxt.astype(jnp.float32))
    rnd_in = jag._rnd_input(jst.params, obs_rms, nxt)

    np.testing.assert_allclose(batch.adv.numpy(),
                               _np(int_a * cfg.int_coef + ext_a * cfg.ext_coef).reshape(-1), **TOL)
    np.testing.assert_allclose(batch.ext_target.numpy(), _np(ext_t).reshape(-1), **TOL)
    np.testing.assert_allclose(batch.int_target.numpy(), _np(int_t).reshape(-1), **TOL)
    np.testing.assert_allclose(batch.rnd_in.numpy(), _np(rnd_in), **TOL)
    np.testing.assert_array_equal(batch.states.numpy(), _np(env_major(ro["states"])))
    np.testing.assert_allclose(float(metrics["data/int_reward_per_rollout"]),
                               float(jnp.mean(int_r)), **TOL)

    # ... and the normalisers the JAX update returns (it donates its state)
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()})
    jnew, _ = jag.update(jax.tree_util.tree_map(jnp.copy, jst), jro, jax.random.PRNGKey(3))
    pairs = [(new.obs_rms, jnew.obs_rms), (new.reward_rms, jnew.reward_rms),
             (new.reward_filter, jnew.reward_filter)]
    for ours, ref in pairs:
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def test_greedy_deterministic_rollout_matches_jax(pair):
    jag, jst, pag, pst = pair
    jenv, penv = JaxEnv(N_ENV, seed=7), SyntheticVectorEnv(N_ENV, seed=7)
    jobs, pobs = jenv.reset(), penv.reset()
    rng = Rng(0, "cpu")
    for t in range(N_STEP):
        np.testing.assert_array_equal(pobs, jobs)
        ja, jv_ext, jv_int, jlogits = jag.act(jst.params, jnp.asarray(jobs),
                                              jax.random.PRNGKey(t),
                                              deterministic_model=True, greedy=True)
        pa, pv_ext, pv_int, plogits = pag.act(pobs, rng, deterministic_model=True,
                                              greedy=True)
        np.testing.assert_array_equal(pa.numpy(), _np(ja))
        np.testing.assert_allclose(pv_ext.numpy(), _np(jv_ext), **TOL)
        np.testing.assert_allclose(pv_int.numpy(), _np(jv_int), **TOL)
        np.testing.assert_allclose(plogits.numpy(), _np(jlogits), **TOL)
        jobs = jenv.step(_np(ja))[0]
        pobs = penv.step(pa.numpy())[0]


def test_collect_on_cpu_runs_the_plain_path(pair):
    _, _, pag, pst = pair
    env = SyntheticVectorEnv(N_ENV, seed=3)
    col = RolloutCollector(pag.cfg, pag, env)
    rng = Rng(1, "cpu")
    before = (flash_qkv.launches["flash_qkv_fwd"], fused_ffn.launches["fused_ffn_fwd"])
    st, states = col.warmup_obs_rms(pst, env.reset(), rng)
    ro, states = col.collect(states, rng)
    assert ro.states.shape == (N_STEP, N_ENV, 4, 84, 84)
    assert ro.next_obs.shape == (N_STEP, N_ENV, 1, 84, 84)
    assert ro.value_ext.shape == (N_STEP + 1, N_ENV)
    assert ro.policy.shape == (N_STEP, N_ENV, N_ACT)
    st, batch, _ = pag.prepare_batch(st, ro)
    assert batch.adv.shape == (N_STEP * N_ENV,)
    assert torch.isfinite(batch.adv).all() and torch.isfinite(batch.ext_target).all()
    # CPU tensors take the plain versions: no kernel was launched
    assert (flash_qkv.launches["flash_qkv_fwd"], fused_ffn.launches["fused_ffn_fwd"]) == before


@pytest.mark.parametrize("use_gae", [True, False])
def test_gae_matches_jax(use_gae):
    rng = np.random.default_rng(4)
    r = rng.standard_normal((3, 9)).astype(np.float32)
    d = (rng.random((3, 9)) < 0.3).astype(np.float32)
    v = rng.standard_normal((3, 10)).astype(np.float32)
    ours = make_train_data(torch.tensor(r), torch.tensor(d), torch.tensor(v), 0.99, 0.95,
                           use_gae)
    ref = jax_gae(jnp.asarray(r), jnp.asarray(d), jnp.asarray(v), 0.99, 0.95, use_gae)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def test_normalizers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 1, 3, 3)).astype(np.float32) * 3 + 1
    ours = norm.rms_update(norm.rms_init((1, 3, 3)), torch.tensor(x))
    ref = jax_norm.rms_update(jax_norm.rms_init((1, 3, 3)), jnp.asarray(x))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    np.testing.assert_allclose(norm.rms_normalize(ours, torch.tensor(x)).numpy(),
                               _np(jax_norm.rms_normalize(ref, jnp.asarray(x))), **TOL)
    rew = rng.standard_normal((4, 6)).astype(np.float32)
    of, ops = norm.reward_filter_scan(norm.reward_filter_init(4), torch.tensor(rew), 0.99)
    jf, jps = jax_norm.reward_filter_scan(jax_norm.reward_filter_init(4), jnp.asarray(rew), 0.99)
    np.testing.assert_allclose(of.rewems.numpy(), _np(jf.rewems), **TOL)
    np.testing.assert_allclose(ops.numpy(), _np(jps), **TOL)


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.Config(vit=port_config.ViTConfig(**TINY), **COMMON)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RNDAgent(cfg, N_ACT)
    with pytest.raises(RuntimeError):
        port_agent.resolve_device()
    assert port_agent.resolve_device("cpu").type == "cpu"


def test_ppo_mode_prepare_batch_is_the_extrinsic_gae():
    cfg = port_config.Config(vit=port_config.ViTConfig(**TINY),
                             train_method=port_config.TrainMethod.PPO, **COMMON)
    agent = RNDAgent(cfg, N_ACT, device="cpu")
    state = agent.init_state(0)
    assert agent.rnd_pred is None and state.obs_rms is None
    ro = _rollout(6)
    new, batch, _ = agent.prepare_batch(
        state, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}))
    ext_t, ext_a = jax_gae(jnp.clip(jnp.asarray(ro["rewards"]).T, -1.0, 1.0),
                           jnp.asarray(ro["dones"]).T.astype(jnp.float32),
                           jnp.asarray(ro["value_ext"]).T, cfg.gamma, cfg.gae_lambda)
    np.testing.assert_allclose(batch.adv.numpy(), _np(ext_a * cfg.ext_coef).reshape(-1), **TOL)
    np.testing.assert_allclose(batch.ext_target.numpy(), _np(ext_t).reshape(-1), **TOL)
    assert batch.int_target is None and batch.rnd_in is None
    assert new.reward_rms is state.reward_rms  # untouched without RND


def test_unported_modes_raise():
    base = dict(vit=port_config.ViTConfig(**TINY), **COMMON)
    # modified_RND and the SSL methods are ported
    # (tests/test_torch_port_continuous.py, tests/test_torch_port_ssl.py)
    for method, target in ((port_config.RepresentationMethod.BYOL, True),
                           (port_config.RepresentationMethod.BARLOW_TWINS, False)):
        small = port_config.SSLConfig(byol_projection_hidden_size=32, byol_projection_size=16,
                                      barlow_twins_projection_sizes=(32, 32))
        agent = RNDAgent(port_config.Config(representation_lr_method=method, ssl=small,
                                            **base), N_ACT, device="cpu")
        agent.init_state(0)
        assert agent.ssl is not None and (agent.ssl_target is not None) == target
        assert set(agent.state_dict(agent.init_state(0))) >= {"ssl", "policy"}
    # the HF flavour is ported too (tests/test_torch_port_hg.py): it builds
    # its own backbone where it raised before
    from eavit_tpu_torch.models.vit import DualTokenViTHG

    hg = port_config.ViTHGConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                 intermediate_size=64)
    agent = RNDAgent(port_config.Config(vit_implementation_type=1, vit_hg=hg, **base), N_ACT,
                     device="cpu")
    assert isinstance(agent.network.feature, DualTokenViTHG)


def test_categorical_log_prob_matches_jax():
    from eavit_tpu.rl.ppo import categorical_log_prob as jax_logp
    from eavit_tpu_torch.rl.ppo import categorical_log_prob, sample_categorical

    rng = np.random.default_rng(8)
    logits = rng.standard_normal((6, N_ACT)).astype(np.float32)
    acts = rng.integers(0, N_ACT, 6)
    np.testing.assert_allclose(
        categorical_log_prob(torch.tensor(logits), torch.tensor(acts)).numpy(),
        _np(jax_logp(jnp.asarray(logits), jnp.asarray(acts))), **TOL)
    # sampling follows softmax(logits): a dominant logit is always drawn
    big = torch.zeros(5, N_ACT)
    big[:, 3] = 50.0
    gen = torch.Generator().manual_seed(0)
    assert sample_categorical(big, gen).tolist() == [3] * 5
