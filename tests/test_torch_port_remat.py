"""``EncoderRemat`` (``full`` / ``dots``) in the torch port.

- At dropout 0.1 on the plain path (the kernel routes' plain versions and the
  torch layers), one loss and backward under ``full`` and ``dots`` give the
  gradients of ``none`` with equal bits: the recomputed sublayers replay the
  first run's seed words and device draws (``models/layers.RecordedRng``).
  With the replay broken (the device generator not restored) they differ,
  so the comparison sees a redrawn mask.
- ``RNDAgent.update`` under each mode at dropout 0 against the JAX agent's
  under ``full`` (remat changes no value in the JAX package; PPO, the plain
  attention and FFN, ``StableEps = 1e-3``, two minibatches on the JAX
  permutation): every metric within 1e-4 relative, every parameter within
  2e-5 absolute. The JAX trees are drawn with numpy in the shapes
  ``jax.eval_shape`` gives.
- The ``state_dict`` keys and the parameter names do not change with the
  mode, as ``nn.remat`` keeps the flax tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl.agent import AgentState as JaxAgentState
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import flax_tree_to_torch, load_jax_params
from eavit_tpu_torch.models import layers
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout, TrainBatch

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

TINY = dict(dim=32, patch_size=21, depth=2, heads=2, dim_head=16, mlp_dim=64,
            dropout=0.1, emb_dropout=0.0)
N_ENV, N_STEP, N_ACT = 2, 8, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, obs_norm_step=1, update_proportion=1.0,
              learning_rate=1e-3, stable_eps=1e-3, epoch=1, mini_batch=2)
ROUTES = {"kernel": dict(attention_impl="pallas_qkv", fused_ffn=True),
          "flash": dict(attention_impl="pallas", fused_ffn=True),
          "plain": dict(attention_impl="xla", fused_ffn=False)}
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 2e-5


def _port(mode, route, **kw):
    vit = port_config.ViTConfig(**{**TINY, **kw.pop("vit", {})})
    cfg = port_config.Config(vit=vit, encoder_remat=mode, **COMMON, **ROUTES[route], **kw)
    agent = RNDAgent(cfg, N_ACT, device="cpu")
    return agent, agent.init_state(0)


def _batch(n=6):
    rng = np.random.default_rng(1)
    return TrainBatch(
        states=torch.from_numpy(rng.integers(0, 256, (n, 4, 84, 84), dtype=np.uint8)),
        actions=torch.from_numpy(rng.integers(0, N_ACT, n)),
        old_policy=torch.from_numpy(rng.standard_normal((n, N_ACT)).astype(np.float32)),
        adv=torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
        ext_target=torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
        int_target=torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
        rnd_in=torch.from_numpy(rng.standard_normal((n, 1, 84, 84)).astype(np.float32)))


def _grads(mode, route):
    """The loss of one minibatch with dropout live and its gradients."""
    agent, _ = _port(mode, route)
    batch = _batch()
    rng = Rng(7, "cpu")
    loss, _ = agent._loss(batch, torch.arange(6), rng)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in agent.network.named_parameters()
             if p.grad is not None}
    # what the stream draws next: the recompute left it where ``none`` does
    return loss.detach(), grads, torch.rand(4, generator=rng.device), rng.seeds()


@pytest.mark.parametrize("route", ["kernel", "flash", "plain"])
def test_remat_gradients_have_the_bits_of_none(route):
    loss0, g0, next0, seeds0 = _grads("none", route)
    assert len(g0) == len(list(_port("none", route)[0].network.parameters()))
    for mode in ("full", "dots"):
        loss, g, nxt, seeds = _grads(mode, route)
        assert torch.equal(loss, loss0), mode
        assert g.keys() == g0.keys()
        for name, grad in g.items():
            assert torch.equal(grad, g0[name]), f"{mode}: {name}"
        assert torch.equal(nxt, next0) and seeds == seeds0
    # dropout was live: another stream gives another loss
    agent, _ = _port("none", route)
    other, _ = agent._loss(_batch(), torch.arange(6), Rng(8, "cpu"))
    assert not torch.equal(other.detach(), loss0)


def test_a_recompute_without_the_replay_would_show(monkeypatch):
    """The mutation the test above guards against: a recompute that redraws
    its device masks gives other gradients."""
    _, g0, _, _ = _grads("none", "plain")
    monkeypatch.setattr(layers.RecordedRng, "rewind",
                        lambda self: setattr(self, "_next", 0))
    _, g, _, _ = _grads("full", "plain")
    assert any(not torch.equal(g[n], g0[n]) for n in g0)


def test_state_dict_keys_do_not_change():
    keys = {}
    for mode in ("none", "full", "dots"):
        agent, state = _port(mode, "kernel")
        sd = agent.state_dict(state)
        keys[mode] = {k: set(v) for k, v in sd.items() if isinstance(v, dict)}
        keys[mode]["policy"] = set(sd["policy"])
    assert keys["full"] == keys["none"] == keys["dots"]
    # a checkpoint of one mode loads into another
    a, s = _port("full", "kernel")
    b, _ = _port("none", "kernel")
    b.load_state_dict(a.state_dict(s))


# ---------------------------------------------------------------------------
# update parity with the JAX package under each mode
# ---------------------------------------------------------------------------


def _random_tree(shapes, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rollout(seed):
    rng = np.random.default_rng(seed)
    T, N = N_STEP, N_ENV
    level = rng.integers(30, 220, (T, N, 4, 1, 1))
    states = np.clip(level + rng.integers(-30, 31, (T, N, 4, 84, 84)), 0, 255)
    return dict(
        states=states.astype(np.uint8),
        actions=rng.integers(0, N_ACT, (T, N)).astype(np.int32),
        rewards=rng.choice([0.0, 1.0, 3.0], (T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        next_obs=rng.integers(0, 256, (T, N, 1, 84, 84), dtype=np.uint8),
        value_ext=rng.standard_normal((T + 1, N)).astype(np.float32),
        value_int=rng.standard_normal((T + 1, N)).astype(np.float32),
        policy=rng.standard_normal((T, N, N_ACT)).astype(np.float32),
    )


def test_update_matches_jax_under_remat(monkeypatch):
    """The port's ``update`` under ``full`` and under ``dots`` against one JAX
    ``update`` under ``full``: remat changes no value in the JAX package
    (``tests/test_remat.py``), so one compile is the reference for both."""
    kw = dict(COMMON, **ROUTES["plain"], encoder_remat="full",
              train_method=port_config.TrainMethod.PPO)
    vit = dict(TINY, dropout=0.0, depth=1)
    jag = JaxAgent(jax_config.Config(vit=jax_config.ViTConfig(**vit), **kw), N_ACT)
    shapes = jax.eval_shape(jag.init_state, jax.random.PRNGKey(0))
    params = _random_tree(shapes.params, 0)
    jst = JaxAgentState(
        params=params, rnd_target=None, ssl_target=None, opt_state=jag.tx.init(params),
        obs_rms=None, reward_rms=jax_norm.rms_init(()),
        reward_filter=jax_norm.reward_filter_init(N_ENV),
        global_step=jnp.zeros((2,), jnp.int32), global_update=jnp.zeros((), jnp.int32))
    ro = _rollout(3)
    key = jax.random.PRNGKey(9)
    k_perm = jax.random.split(jax.random.split(key, 1)[0])[0]
    perm = np.asarray(jax.random.permutation(k_perm, N_STEP * N_ENV))
    jnew, jm = jag.update(jst, JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()}), key)
    jm = {k: float(v) for k, v in jm.items()}
    ref = flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, jnew.params["policy"]))
    for mode in ("full", "dots"):
        pag, pst = _port(mode, "plain", vit=dict(dropout=0.0, depth=1),
                         train_method=port_config.TrainMethod.PPO)
        load_jax_params(pag, params)
        monkeypatch.setattr(pag, "_permutation",
                            lambda rng, n: torch.tensor(perm, dtype=torch.int64))
        _, pm = pag.update(pst, Rollout(**{k: torch.from_numpy(np.asarray(v))
                                           for k, v in ro.items()}), Rng(0, "cpu"))
        pm = {k: float(v) for k, v in pm.items()}
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], err_msg=f"{mode}: {k}", **METRIC_TOL)
        ours = dict(pag.network.named_parameters())
        assert set(ours) == set(ref)
        for name, value in ref.items():
            np.testing.assert_allclose(ours[name].detach().numpy(), value,
                                       err_msg=f"{mode}: {name}", rtol=0, atol=PARAM_ATOL)
