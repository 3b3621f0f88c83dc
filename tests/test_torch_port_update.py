"""The torch port's update (eavit_tpu_torch/rl/agent.RNDAgent.update) and its
loss pieces against the JAX package.

Pieces: ``ppo_surrogate``, the categorical entropy, ``rnd_loss``, the global
gradient norm with optax-style clipping and Adam with a non-default
``StableEps``, each on numpy inputs against the JAX function (1e-5).

The slice as a whole: a JAX ``RNDAgent`` with the Pallas qkv attention and the
fused FFN (interpret mode on the CPU, so ``jax.grad`` runs the backward
kernels) and the port's agent with the same parameters, float32, dropout 0,
``UpdateProportion = 1.0`` so that no random draw enters the loss. With
``MiniBatch = 1`` the loss does not depend on the permutation; with
``MiniBatch = 4`` the JAX permutations are handed to the port through
``RNDAgent._permutation``. Compared after ``update``: every ``train/*`` and
``data/*`` metric (rtol 1e-4, atol 1e-5), the normalisers and counters (1e-5)
and the parameters (atol 2e-5 after up to eight Adam steps of ``lr = 1e-3``).
Adam divides by the gradient's own magnitude, so float32 noise in a small
gradient is amplified up to ``lr * noise / StableEps``: with the default
1e-8 single elements of the RND convolutions differ by 2.5e-4 between the
two frameworks. The tests set ``StableEps = 1e-3``, which bounds that
amplification and also makes a mis-wired eps visible (every small-gradient
element would then move by a full ``lr``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models.rnd import rnd_loss as jax_rnd_loss
from eavit_tpu.rl import ppo as jax_ppo
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu.rl.agent import global_step_value
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import flax_tree_to_torch, load_jax_params
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.models.rnd import rnd_loss
from eavit_tpu_torch.rl import ppo
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout

from _torch_port_jax_state import agent_state

# One intra-op thread: the suite runs several test processes on one host, and
# torch's thread pools spinning against each other (and against XLA's) make
# these many small ops an order of magnitude slower than one thread does.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 2e-5
TINY = dict(dim=48, patch_size=12, depth=1, heads=4, dim_head=12, mlp_dim=96,
            dropout=0.0, emb_dropout=0.0)
N_ENV, N_STEP, N_ACT = 2, 8, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, obs_norm_step=1, update_proportion=1.0,
              learning_rate=1e-3, stable_eps=1e-3, attention_impl="pallas_qkv",
              fused_ffn=True)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_int", [True, False])
def test_ppo_surrogate_and_entropy_match_jax(with_int):
    rng = np.random.default_rng(0)
    b = 12
    logits = rng.standard_normal((b, N_ACT)).astype(np.float32)
    old = logits + 0.3 * rng.standard_normal((b, N_ACT)).astype(np.float32)
    acts = rng.integers(0, N_ACT, b)
    adv = rng.standard_normal(b).astype(np.float32)
    v_ext, v_int = (rng.standard_normal((b, 1)).astype(np.float32) for _ in range(2))
    t_ext, t_int = (rng.standard_normal(b).astype(np.float32) for _ in range(2))

    ent = ppo.categorical_entropy(torch.tensor(logits))
    jent = jax_ppo.categorical_entropy(jnp.asarray(logits))
    np.testing.assert_allclose(ent.numpy(), _np(jent), **TOL)

    ours = ppo.ppo_surrogate(
        ppo.categorical_log_prob(torch.tensor(logits), torch.tensor(acts)),
        ppo.categorical_log_prob(torch.tensor(old), torch.tensor(acts)),
        torch.tensor(adv), torch.tensor(v_ext), torch.tensor(t_ext), ent, 0.1,
        torch.tensor(v_int) if with_int else None,
        torch.tensor(t_int) if with_int else None)
    ref = jax_ppo.ppo_surrogate(
        jax_ppo.categorical_log_prob(jnp.asarray(logits), jnp.asarray(acts)),
        jax_ppo.categorical_log_prob(jnp.asarray(old), jnp.asarray(acts)),
        jnp.asarray(adv), jnp.asarray(v_ext), jnp.asarray(t_ext), jent, 0.1,
        jnp.asarray(v_int) if with_int else None,
        jnp.asarray(t_int) if with_int else None)
    assert ours._fields == ref._fields
    for name in ours._fields:
        np.testing.assert_allclose(getattr(ours, name).numpy(), _np(getattr(ref, name)),
                                   err_msg=name, **TOL)
    assert float(ours.clipfrac) > 0.0  # the clip really bites on these inputs


@pytest.mark.parametrize("proportion", [0.25, 1.0, 0.0])
def test_rnd_loss_matches_jax(proportion):
    rng = np.random.default_rng(1)
    t, p = (rng.standard_normal((9, 16)).astype(np.float32) for _ in range(2))
    u = rng.random(9).astype(np.float32)
    pred = torch.tensor(p, requires_grad=True)
    target = torch.tensor(t, requires_grad=True)
    ours = rnd_loss(target, pred, torch.tensor(u), proportion)
    ref = jax_rnd_loss(jnp.asarray(t), jnp.asarray(p), jnp.asarray(u), proportion)
    np.testing.assert_allclose(ours.detach().numpy(), _np(ref), **TOL)
    ours.backward()
    assert target.grad is None  # the target is detached
    jgrad = jax.grad(lambda q: jax_rnd_loss(jnp.asarray(t), q, jnp.asarray(u),
                                            proportion))(jnp.asarray(p))
    np.testing.assert_allclose(pred.grad.numpy(), _np(jgrad), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipping_and_adam_match_optax(max_norm):
    """Two steps of clip_by_global_norm + adam(eps = StableEps) on one tree."""
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    lr, eps = 1e-2, 1e-3
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adam(lr, b1=0.9, b2=0.999, eps=eps))
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = torch.optim.Adam(tp, lr=lr, betas=(0.9, 0.999), eps=eps)
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        tg = [p.grad for p in tp]
        norm = ppo.global_grad_norm(tg)
        np.testing.assert_allclose(float(norm), float(jax_ppo.global_grad_norm(jg)),
                                   rtol=1e-6)
        ppo.clip_by_global_norm_(tg, norm, max_norm)
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


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


def _pair(**overrides):
    kw = {**COMMON, **overrides}
    jag = JaxAgent(jax_config.Config(vit=jax_config.ViTConfig(**TINY), **kw), N_ACT)
    jst = agent_state(jag, 0)  # drawn with numpy: no init_state to compile
    pag = RNDAgent(port_config.Config(vit=port_config.ViTConfig(**TINY), **kw), N_ACT,
                   device="cpu")
    pst = pag.init_state(0)
    load_jax_params(pag, jax.tree_util.tree_map(_np, jst.params),
                    jax.tree_util.tree_map(_np, jst.rnd_target))
    frames = np.random.default_rng(0).integers(0, 256, (16, 1, 84, 84), dtype=np.uint8)
    return jag, jag.update_obs_rms(jst, jnp.asarray(frames)), pag, pag.update_obs_rms(
        pst, frames)


def _port_only(**overrides):
    """The port's agent alone (own init), for what needs no reference."""
    cfg = port_config.Config(vit=port_config.ViTConfig(**TINY), **{**COMMON, **overrides})
    agent = RNDAgent(cfg, N_ACT, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (16, 1, 84, 84), dtype=np.uint8)
    return agent, agent.update_obs_rms(agent.init_state(0), frames)


def _jax_permutations(key, epochs, n):
    """The permutations ``_update_impl`` draws (agent.py:573-586)."""
    perms = []
    for k in jax.random.split(key, epochs):
        k_perm, _ = jax.random.split(k)
        perms.append(_np(jax.random.permutation(k_perm, n)))
    return perms


def _compare_after_update(jag, jnew, jmetrics, pag, pnew, pmetrics):
    jm = {k: float(v) for k, v in jmetrics.items()}
    pm = {k: float(v) for k, v in pmetrics.items()}
    assert set(pm) == set(jm)
    assert any(k.startswith("train/") for k in pm) and any(
        k.startswith("data/") for k in pm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **METRIC_TOL)
    parts = ("train/actor_loss", "train/critic_loss", "train/entropy_loss",
             "train/rnd_loss")
    np.testing.assert_allclose(pm["train/loss"], sum(pm[k] for k in parts), **TOL)

    for ours, ref in ((pnew.obs_rms, jnew.obs_rms), (pnew.reward_rms, jnew.reward_rms),
                      (pnew.reward_filter, jnew.reward_filter)):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    assert pnew.global_update == int(jnew.global_update) == 1
    assert pnew.global_step == global_step_value(jnew) == N_STEP * N_ENV

    modules = {"policy": pag.network, "rnd_pred": pag.rnd_pred}
    for key, module in modules.items():
        ref = flax_tree_to_torch(jax.tree_util.tree_map(_np, jnew.params[key]))
        ours = dict(module.named_parameters())
        assert set(ours) == set(ref)
        for name, value in ref.items():
            np.testing.assert_allclose(ours[name].detach().numpy(), value,
                                       err_msg=f"{key}.{name}", rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("epoch,clip", [(1, False), (2, True)])
def test_update_matches_jax_with_one_minibatch(epoch, clip):
    jag, jst, pag, pst = _pair(epoch=epoch, mini_batch=1, use_grad_clipping=clip,
                               max_grad_norm=0.5)
    before = [p.detach().clone() for p in pag.trainable_parameters()]
    target_before = [p.detach().clone() for p in pag.rnd_target.parameters()]
    ro = _rollout(3)
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()})
    jnew, jmetrics = jag.update(jst, jro, jax.random.PRNGKey(5))
    pnew, pmetrics = pag.update(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}),
        Rng(0, "cpu"))
    _compare_after_update(jag, jnew, jmetrics, pag, pnew, pmetrics)
    # the update really moved the trainable parameters, and only those
    moved = [not torch.equal(a, b) for a, b in zip(before, pag.trainable_parameters())]
    assert all(moved)
    for a, b in zip(target_before, pag.rnd_target.parameters()):
        assert torch.equal(a, b)
    if clip:  # the clip was active: the unclipped norm exceeds MaxGradNorm
        assert float(pmetrics["train/grad_norm_unclipped"]) > 0.5


def test_update_matches_jax_with_the_jax_permutations(monkeypatch):
    epochs = 2
    jag, jst, pag, pst = _pair(epoch=epochs, mini_batch=4)
    ro = _rollout(4)
    key = jax.random.PRNGKey(9)
    perms = iter(_jax_permutations(key, epochs, N_STEP * N_ENV))
    monkeypatch.setattr(pag, "_permutation",
                        lambda rng, n: torch.tensor(next(perms), dtype=torch.int64))
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()})
    jnew, jmetrics = jag.update(jst, jro, key)
    pnew, pmetrics = pag.update(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}),
        Rng(0, "cpu"))
    _compare_after_update(jag, jnew, jmetrics, pag, pnew, pmetrics)
    assert next(perms, None) is None  # one permutation per epoch was drawn


def test_update_matches_jax_on_the_pallas_route(monkeypatch):
    """``AttentionImpl = pallas`` at dropout 0: the port's K4 (plain on the
    CPU) against ``jax.grad`` through the Pallas ``ops/flash.py`` kernels."""
    epochs = 1
    jag, jst, pag, pst = _pair(epoch=epochs, mini_batch=2, attention_impl="pallas")
    ro = _rollout(7)
    key = jax.random.PRNGKey(11)
    perms = iter(_jax_permutations(key, epochs, N_STEP * N_ENV))
    monkeypatch.setattr(pag, "_permutation",
                        lambda rng, n: torch.tensor(next(perms), dtype=torch.int64))
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()})
    jnew, jmetrics = jag.update(jst, jro, key)
    pnew, pmetrics = pag.update(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}),
        Rng(0, "cpu"))
    _compare_after_update(jag, jnew, jmetrics, pag, pnew, pmetrics)


def test_update_matches_jax_on_the_pallas_stream_route():
    """``AttentionImpl = pallas_stream`` at dropout 0: the port's K5 (plain on
    the CPU) against ``jax.grad`` through the Pallas ``ops/flash_stream.py``
    kernels. One minibatch, one epoch and the plain FFN keep the interpret-mode
    kernels to the attention's."""
    jag, jst, pag, pst = _pair(epoch=1, mini_batch=1, attention_impl="pallas_stream",
                               fused_ffn=False)
    ro = _rollout(8)
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()})
    jnew, jmetrics = jag.update(jst, jro, jax.random.PRNGKey(12))
    pnew, pmetrics = pag.update(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}),
        Rng(0, "cpu"))
    _compare_after_update(jag, jnew, jmetrics, pag, pnew, pmetrics)


def test_own_permutation_is_a_permutation_on_the_agents_device():
    pag, _ = _port_only(epoch=1, mini_batch=1)
    perm = pag._permutation(Rng(3, "cpu"), 16)
    assert perm.device.type == "cpu" and sorted(perm.tolist()) == list(range(16))


def test_minibatch_merge_freeze_and_verbose_grads():
    pag, pst = _port_only(epoch=1, mini_batch=4, minibatch_merge=2,
                          freeze_shared_backbone=True, verbose_logging=True)
    feature_before = [p.detach().clone() for p in pag.network.feature.parameters()]
    head_before = pag.network.actor_fc2.weight.detach().clone()
    ro = _rollout(5)
    pnew, metrics = pag.update(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}),
        Rng(0, "cpu"))
    grads = metrics.pop("_grads")
    assert set(grads) == {"policy", "rnd_pred"}
    # frozen backbone: zero (not missing) gradients, unchanged parameters
    assert all(float(g.abs().max()) == 0.0 for n, g in grads["policy"].items()
               if n.startswith("feature."))
    for a, b in zip(feature_before, pag.network.feature.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(head_before, pag.network.actor_fc2.weight)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_unported_update_options_raise():
    """``EncoderRemat`` is ported (Queue 1 item 10, tests/test_torch_port_remat.py):
    ``full`` now updates, every trainable parameter moves and the metrics are
    finite."""
    pag, pst = _port_only(epoch=1, mini_batch=1, encoder_remat="full")
    before = [p.detach().clone() for p in pag.trainable_parameters()]
    ro = _rollout(6)
    pnew, metrics = pag.update(pst, Rollout(**{k: torch.from_numpy(np.asarray(v))
                                               for k, v in ro.items()}), Rng(0, "cpu"))
    assert pnew.global_update == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, pag.trainable_parameters()))
