"""Continuous actions, NoisyNet and ``modified_RND`` in the torch port against
the JAX package.

Pieces, from one numpy seed: ``NoisyLinear`` (the eval forward at 1e-6 in
float32 and 2e-2 in bf16; the noisy forward with its eps drawn once in numpy
against the JAX layer's formula; the spread of its own eps), the Normal
helpers at 1e-6, the continuous ``ActorCritic`` (policy, std, both values,
with and without NoisyNet heads) and the ``MlpTrunk`` RND pair at rate 0,
each loaded from a flax tree with ``convert.load_flax_tree``. The trees are
drawn with numpy from a seed in the shapes ``jax.eval_shape`` gives the JAX
``init`` (compiling the JAX inits, orthogonal ones included, would take
most of this file's time).

The slice as a whole: ``RNDAgent.update`` against the JAX agent's for
continuous actions + PPO and for discrete actions + ``modified_RND``, float32,
dropout 0, NoisyNet off, ``StableEps = 1e-3``, two epochs of two minibatches
(four Adam steps) on the JAX permutations: every metric within 1e-4
relative, every parameter within 2e-5 absolute, the normalisers (the
embedding's ``obs_rms`` moments included) within 1e-5. The models run the
plain attention and FFN (``AttentionImpl = xla``): this slice adds no
kernel, and the kernel routes are held elsewhere. Then the port alone: the
NoisyNet update is finite and differs from the same update without noise;
the next-obs embedding does not depend on the chunk size; ``log_std`` and the
noisy parameters go through a checkpoint, and ``convert.load_jax_state``
carries the JAX state after its update, Adam moments of ``log_std`` and the
MLP trunk included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models.layers import NoisyLinear as JaxNoisyLinear
from eavit_tpu.models.policy import ActionSpaceType as JaxSpace
from eavit_tpu.models.policy import ActorCritic as JaxActorCritic
from eavit_tpu.models.rnd import RNDPredictor as JaxRNDPredictor
from eavit_tpu.models.rnd import RNDTarget as JaxRNDTarget
from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl import ppo as jax_ppo
from eavit_tpu.rl.agent import AgentState as JaxAgentState
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu.rl.agent import global_step_value
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import (
    flax_tree_to_torch,
    load_flax_tree,
    load_jax_params,
    load_jax_state,
)
from eavit_tpu_torch.models.layers import NoisyLinear, Rng
from eavit_tpu_torch.models.policy import ActionSpaceType, ActorCritic
from eavit_tpu_torch.models.rnd import RNDPredictor, RNDTarget
from eavit_tpu_torch.rl import ppo
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from eavit_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
NET_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 2e-5
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TINY = dict(dim=32, patch_size=21, depth=1, heads=2, dim_head=16, mlp_dim=64,
            dropout=0.0, emb_dropout=0.0)
N_ENV, N_STEP, A_DIM, N_ACT = 2, 8, 2, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, obs_norm_step=1, update_proportion=1.0,
              learning_rate=1e-3, stable_eps=1e-3, attention_impl="xla",
              fused_ffn=False, epoch=2, mini_batch=2)


def _np(x):
    return np.asarray(x)


def _random_tree(shapes, seed: int):
    """A flax parameter tree of the shapes of ``shapes`` drawn from ``seed``:
    kernels N(0, 1/fan_in), LayerNorm scales near 1, biases near 0,
    ``log_std`` near -0.5, tokens and position embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("kernel", "noisy_kernel"):
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "noisy_bias"):
            x = 0.1 * rng.standard_normal(shape)
        elif name == "log_std":
            x = -0.5 + 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cfgs(**kw):
    kw = {**COMMON, **kw}
    return (jax_config.Config(vit=jax_config.ViTConfig(**TINY), **kw),
            port_config.Config(vit=port_config.ViTConfig(**TINY), **kw))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noisy_linear_matches_jax(dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(0)
    n_in, n_out = 24, 7
    x = rng.standard_normal((5, n_in)).astype(np.float32)
    jlayer = JaxNoisyLinear(n_out, dtype=jdt)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    layer = NoisyLinear(n_in, n_out)
    load_flax_tree(layer, params)
    xj, xt = jnp.asarray(x).astype(jdt), torch.tensor(x).to(tdt)

    # the eval forward: no noise in either package
    ref = jlayer.apply({"params": params}, xj, True)
    with torch.no_grad():
        out = layer(xt)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), _np(ref.astype(jnp.float32)),
                               **TOL[dtype])

    # the noisy forward with one eps drawn in numpy, against the JAX layer's
    # formula (layers.py:119-131): each product cast to the input dtype apart
    std = 0.5 / np.sqrt(n_in)
    eps_in = (rng.standard_normal(n_in) * std).astype(np.float32)
    eps_out = (rng.standard_normal(n_out) * std).astype(np.float32)
    w, b = params["kernel"], params["bias"]
    noisy_w = params["noisy_kernel"] * jnp.outer(eps_in, eps_out)
    ref = (xj @ w.astype(jdt) + b.astype(jdt)
           + xj @ noisy_w.astype(jdt) + (params["noisy_bias"] * eps_out).astype(jdt))
    layer.sample_noise = lambda r, d: (torch.tensor(eps_in), torch.tensor(eps_out))
    with torch.no_grad():
        out = layer(xt, Rng(0, "cpu"))
    np.testing.assert_allclose(out.float().numpy(), _np(ref.astype(jnp.float32)),
                               **TOL[dtype])


def test_noisy_linear_noise_has_the_jax_spread():
    n_in, n_out = 4096, 2048
    layer = NoisyLinear(n_in, n_out)
    eps_in, eps_out = layer.sample_noise(Rng(3, "cpu"), "cpu")
    want = 0.5 / np.sqrt(n_in)
    for eps in (eps_in, eps_out):  # the std estimate errs by about 1/sqrt(2n)
        assert abs(float(eps.std()) / want - 1.0) < 5.0 / np.sqrt(2 * eps.numel())
        assert abs(float(eps.mean())) < 5.0 * want / np.sqrt(eps.numel())
    again = layer.sample_noise(Rng(3, "cpu"), "cpu")
    assert torch.equal(again[0], eps_in)  # drawn from the Rng, reproducibly


def test_normal_helpers_match_jax():
    rng = np.random.default_rng(1)
    b, a = 6, 3
    mu = np.tanh(rng.standard_normal((b, a))).astype(np.float32)
    std = np.exp(rng.standard_normal(a) * 0.3 - 0.5).astype(np.float32)
    acts = rng.uniform(-1, 1, (b, a)).astype(np.float32)
    tol = TOL["float32"]
    np.testing.assert_allclose(
        ppo.normal_log_prob(torch.tensor(mu), torch.tensor(std), torch.tensor(acts)).numpy(),
        _np(jax_ppo.normal_log_prob(jnp.asarray(mu), jnp.asarray(std), jnp.asarray(acts))),
        **tol)
    ent = ppo.normal_entropy(torch.tensor(std), b)
    assert ent.shape == (b,)
    np.testing.assert_allclose(ent.numpy(), _np(jax_ppo.normal_entropy(jnp.asarray(std), b)),
                               **tol)
    a_t, logp = ppo.sample_normal(torch.tensor(mu), torch.tensor(std), torch.Generator())
    assert a_t.shape == (b, a)
    np.testing.assert_allclose(
        logp.numpy(), _np(jax_ppo.normal_log_prob(jnp.asarray(mu), jnp.asarray(std),
                                                  jnp.asarray(a_t.numpy()))), **tol)


@pytest.mark.parametrize("noisy,dtype", [(False, "float32"), (True, "float32"),
                                         (False, "bfloat16"), (True, "bfloat16")])
def test_continuous_actor_critic_matches_jax(noisy, dtype):
    jcfg, pcfg = _cfgs(use_noisy_net=noisy, compute_dtype=dtype)
    img = np.random.default_rng(2).random((3, 4, 84, 84)).astype(np.float32)
    jnet = JaxActorCritic(cfg=jcfg, output_size=A_DIM, action_space=JaxSpace.CONTINUOUS)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(1), jnp.asarray(img))
    params = _random_tree(shapes["params"], 1)
    ref = jax.jit(jnet.apply)({"params": params}, jnp.asarray(img))
    net = ActorCritic(pcfg, A_DIM, ActionSpaceType.CONTINUOUS)
    assert net.log_std.dtype == torch.float32 and float(net.log_std.detach()[0]) == -0.5
    load_flax_tree(net, params)
    with torch.no_grad():
        out = net(torch.tensor(img))
    for name in ("policy", "std", "value_ext", "value_int"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   _np(getattr(ref, name)), err_msg=name, **NET_TOL[dtype])
    assert float(out.policy.abs().max()) <= 1.0  # the tanh mean


@pytest.mark.parametrize("which", ["predictor", "target"])
def test_mlp_trunk_rnd_pair_matches_jax(which):
    d = 32
    x = np.random.default_rng(3).standard_normal((6, d)).astype(np.float32)
    jcls, pcls = {"predictor": (JaxRNDPredictor, RNDPredictor),
                  "target": (JaxRNDTarget, RNDTarget)}[which]
    jmod = jcls(pixel_input=False)
    params = _random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(4),
                                         jnp.asarray(x))["params"], 4)
    mod = pcls((d,), pixel_input=False)
    load_flax_tree(mod, params)
    assert [n for n, _ in mod.trunk.named_children()] == ["fc1", "fc2", "fc3"]
    with torch.no_grad():
        out = mod(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), _np(jmod.apply({"params": params},
                                                           jnp.asarray(x))),
                               **NET_TOL["float32"])


# ---------------------------------------------------------------------------
# the update as a whole
# ---------------------------------------------------------------------------


def _frames(rng, shape):
    """uint8 frames whose channels each have a level of their own: white noise
    alone gives every frame nearly the same embedding, and ``obs_rms`` would
    then divide the two packages' float32 rounding by a spread of almost 0."""
    levels = rng.integers(0, 256, shape[:-2] + (1, 1))
    return np.clip(levels + rng.integers(-24, 25, shape), 0, 255).astype(np.uint8)


def _rollout(seed, continuous: bool):
    rng = np.random.default_rng(seed)
    T, N = N_STEP, N_ENV
    ro = dict(
        states=_frames(rng, (T, N, 4, 84, 84)),
        rewards=rng.choice([0.0, 1.0, -0.5], (T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        value_ext=rng.standard_normal((T + 1, N)).astype(np.float32),
        value_int=rng.standard_normal((T + 1, N)).astype(np.float32),
    )
    if continuous:  # PPO: the next-obs are not read
        ro["actions"] = rng.uniform(-1, 1, (T, N, A_DIM)).astype(np.float32)
        ro["policy"] = (rng.standard_normal((T, N, 1)) * 0.3 - 1.5).astype(np.float32)
        ro["next_obs"] = np.zeros((T, N, 1, 84, 84), np.uint8)
    else:  # modified_RND: the whole next-obs stack
        ro["actions"] = rng.integers(0, N_ACT, (T, N)).astype(np.int32)
        ro["policy"] = rng.standard_normal((T, N, N_ACT)).astype(np.float32)
        ro["next_obs"] = _frames(rng, (T, N, 4, 84, 84))
    return ro


def _pair(continuous: bool, **kw):
    method = (port_config.TrainMethod.PPO if continuous
              else port_config.TrainMethod.MODIFIED_RND)
    jcfg, pcfg = _cfgs(train_method=method, **kw)
    n_out = A_DIM if continuous else N_ACT
    jspace = JaxSpace.CONTINUOUS if continuous else JaxSpace.DISCRETE
    space = ActionSpaceType.CONTINUOUS if continuous else ActionSpaceType.DISCRETE
    jag = JaxAgent(jcfg, n_out, action_space=jspace)
    shapes = jax.eval_shape(jag.init_state, jax.random.PRNGKey(0))
    params = _random_tree(shapes.params, 0)
    rnd_target = None if shapes.rnd_target is None else _random_tree(shapes.rnd_target, 1)
    jst = JaxAgentState(  # what init_state builds around its parameters
        params=params, rnd_target=rnd_target, ssl_target=None,
        opt_state=jag.tx.init(params),
        obs_rms=None if shapes.obs_rms is None else jax_norm.rms_init(
            shapes.obs_rms.mean.shape),
        reward_rms=jax_norm.rms_init(()), reward_filter=jax_norm.reward_filter_init(N_ENV),
        global_step=jnp.zeros((2,), jnp.int32), global_update=jnp.zeros((), jnp.int32))
    pag = RNDAgent(pcfg, n_out, space, device="cpu")
    pst = pag.init_state(0)
    load_jax_params(pag, jax.tree_util.tree_map(_np, jst.params),
                    None if jst.rnd_target is None
                    else jax.tree_util.tree_map(_np, jst.rnd_target))
    frames = _frames(np.random.default_rng(0), (16, 4, 84, 84))
    return (jag, jag.update_obs_rms(jst, jnp.asarray(frames)), pag,
            pag.update_obs_rms(pst, frames))


def jax_mu(opt_state):
    """The first moments of the Adam state inside an optax chain state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    found = [jax_mu(sub) for sub in opt_state if isinstance(sub, tuple)]
    return next(m for m in found if m is not None) if found else None


def _jax_permutations(key, epochs, n):
    """The permutations ``_update_impl`` draws (agent.py:573-586)."""
    return [_np(jax.random.permutation(jax.random.split(k)[0], n))
            for k in jax.random.split(key, epochs)]


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous_ppo",
                                                           "discrete_modified_rnd"])
def test_update_matches_jax(continuous, monkeypatch):
    jag, jst, pag, pst = _pair(continuous)
    if not continuous:
        assert tuple(pst.obs_rms.mean.shape) == (1, TINY["dim"])
        for a, b in zip(pst.obs_rms, jst.obs_rms):  # the warm-up's embedding moments
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)
    ro = _rollout(5 if continuous else 6, continuous)
    key = jax.random.PRNGKey(9)
    perms = iter(_jax_permutations(key, COMMON["epoch"], N_STEP * N_ENV))
    monkeypatch.setattr(pag, "_permutation",
                        lambda rng, n: torch.tensor(next(perms), dtype=torch.int64))
    jnew, jm = jag.update(jst, JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()}), key)
    pnew, pm = pag.update(pst, Rollout(**{k: torch.from_numpy(np.asarray(v))
                                          for k, v in ro.items()}), Rng(0, "cpu"))
    assert next(perms, None) is None
    jm = {k: float(v) for k, v in jm.items()}
    pm = {k: float(v) for k, v in pm.items()}
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **METRIC_TOL)
    if continuous:  # the entropy of a Normal: its mean over the action dims
        assert pm["train/entropy"] != 0.0
    else:
        assert pm["train/rnd_loss"] > 0.0
    states = ((pnew.reward_rms, jnew.reward_rms), (pnew.reward_filter, jnew.reward_filter))
    if not continuous:
        states += ((pnew.obs_rms, jnew.obs_rms),)
    for ours, ref in states:
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)
    assert pnew.global_step == global_step_value(jnew) == N_STEP * N_ENV
    modules = {"policy": pag.network}
    if not continuous:
        modules["rnd_pred"] = pag.rnd_pred
    for key_, module in modules.items():
        ref = flax_tree_to_torch(jax.tree_util.tree_map(_np, jnew.params[key_]))
        ours = dict(module.named_parameters())
        assert set(ours) == set(ref)
        for name, value in ref.items():
            np.testing.assert_allclose(ours[name].detach().numpy(), value,
                                       err_msg=f"{key_}.{name}", rtol=0, atol=PARAM_ATOL)
    if continuous:  # log_std is trained, as the JAX optax chain trains it
        assert not torch.equal(pag.network.log_std.detach(), torch.full((A_DIM,), -0.5))

    # the JAX state after its update, Adam moments included, carried into a
    # fresh port agent: log_std and the MLP trunk arrive with their moments
    fresh, _ = _port_agent(continuous)
    carried = load_jax_state(fresh, jax.tree_util.tree_map(_np, jnew))
    assert carried.global_step == pnew.global_step
    key_ = "log_std" if continuous else "trunk.fc1.weight"
    module = fresh.network if continuous else fresh.rnd_pred
    ref = flax_tree_to_torch(jax.tree_util.tree_map(
        _np, jax_mu(jnew.opt_state)["policy" if continuous else "rnd_pred"]))[key_]
    param = dict(module.named_parameters())[key_]
    np.testing.assert_array_equal(fresh.optimizer.state[param]["exp_avg"].numpy(), ref)


def _port_agent(continuous: bool, **kw):
    method = (port_config.TrainMethod.PPO if continuous
              else port_config.TrainMethod.MODIFIED_RND)
    _, pcfg = _cfgs(train_method=method, **kw)
    space = ActionSpaceType.CONTINUOUS if continuous else ActionSpaceType.DISCRETE
    agent = RNDAgent(pcfg, A_DIM if continuous else N_ACT, space, device="cpu")
    return agent, agent.init_state(0)


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous_ppo",
                                                           "discrete_modified_rnd"])
def test_noisy_net_update_is_finite_and_differs_without_noise(continuous):
    ro = _rollout(7, continuous)
    after = []
    for noise in (True, False):
        agent, state = _port_agent(continuous, use_noisy_net=True, epoch=1)
        heads = [m for m in agent.network.modules() if isinstance(m, NoisyLinear)]
        assert len(heads) == 5
        if not noise:
            for m in heads:
                m.sample_noise = lambda r, d, m=m: (torch.zeros(m.in_features),
                                                    torch.zeros(m.out_features))
        rollout = Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()})
        _, metrics = agent.update(state, rollout, Rng(1, "cpu"))
        assert all(np.isfinite(float(v)) for v in metrics.values())
        after.append([p.detach().clone() for p in agent.network.parameters()])
    assert any(not torch.equal(a, b) for a, b in zip(*after))


def test_next_obs_embedding_does_not_depend_on_the_chunk_size():
    agent, _ = _port_agent(False)
    obs = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (10, 4, 84, 84),
                                                             dtype=np.uint8))
    outs = []
    for chunk in (10, 4, 1):
        agent.feature_chunk = chunk
        with torch.no_grad():
            outs.append(agent._rnd_source(obs))
    assert outs[0].shape == (10, TINY["dim"])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_log_std_and_noisy_parameters_go_through_a_checkpoint(tmp_path):
    agent, state = _port_agent(True, use_noisy_net=True, epoch=1)
    rollout = Rollout(**{k: torch.from_numpy(np.asarray(v))
                         for k, v in _rollout(9, True).items()})
    state, _ = agent.update(state, rollout, Rng(2, "cpu"))
    save_checkpoint(str(tmp_path / "c"), agent, state)
    fresh, _ = _port_agent(True, use_noisy_net=True, epoch=1)
    loaded, _ = load_checkpoint(str(tmp_path / "c"), fresh)
    names = {n for n, _ in fresh.network.named_parameters()}
    assert "log_std" in names and "actor_fc2.noisy_weight" in names
    for (n, p), q in zip(agent.network.named_parameters(), fresh.network.parameters()):
        assert torch.equal(p, q), n
    assert loaded.global_step == state.global_step
    opt = fresh.optimizer.state[fresh.network.log_std]
    assert torch.equal(opt["exp_avg"], agent.optimizer.state[agent.network.log_std]["exp_avg"])
