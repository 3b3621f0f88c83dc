"""BYOL and Barlow Twins in the torch port against the JAX package.

Pieces, from one numpy seed: each augment step (crop and resize, flip, blur)
and the pair, with ``same_on_batch`` off and on, given the draws that the JAX
functions make from the same keys as ``eavit_tpu/ops/augment.py:124-145``
splits them (1e-6, the JAX functions under ``jit``, as the package runs them); the port's own draws
(their ranges, one set per batch under ``same_on_batch``, two views that
differ); ``BNMLP``, ``BTProjector``, both losses and the BYOL EMA at 1e-5,
loaded from flax trees drawn with numpy in the shapes ``jax.eval_shape``
gives (compiling the JAX inits would take most of this file's time).

The slice as a whole: ``RNDAgent.update`` under BYOL and under Barlow Twins
against the JAX agent's at the scale of ``tests/test_ssl.py`` on
``pallas_qkv`` with the fused FFN (interpret mode), dropout 0,
``UpdateProportion = 1`` and ``StableEps = 1e-3``; the JAX permutations and
the JAX augment draws of each minibatch (``k_ssl``,
``eavit_tpu/rl/agent.py:454``) are handed to the port. Every metric within
1e-4 relative (``train/representation_loss`` included), every parameter
within 2e-5 absolute (the SSL heads and the EMA target included). One
``SSLPretrainer.epoch`` against JAX's the same way, both pretrainers' Adam eps
set to 1e-3 (their own 1e-8 turns float32 noise in gradients that are 0 in
exact arithmetic into whole-lr steps). Then the port alone:
``train.train`` on ``configs/ssl_pretrain_demo.conf`` cut in size, with BYOL
on the host-env path and Barlow Twins on the device-env path (its log
keys, the ``__BestModelForSSLEvaluationEpochLoss`` checkpoint, a resume and
``evaluate`` from the checkpoint), and ``freeze_shared_backbone`` (``feature``
unchanged, the representation term 0, the EMA still stepping); and
``convert.load_jax_state`` carrying the SSL heads, the target and their Adam
moments.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models import ssl as jax_ssl
from eavit_tpu.ops import augment as jax_aug
from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl.agent import AgentState as JaxAgentState
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu.rl.ssl_pretrain import SSLPretrainer as JaxPretrainer
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.config import EnvType, RepresentationMethod, load_config
from eavit_tpu_torch.convert import (
    flax_tree_to_torch,
    load_flax_tree,
    load_jax_params,
    load_jax_state,
)
from eavit_tpu_torch.eval import evaluate
from eavit_tpu_torch.models import ssl
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.ops import augment
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from eavit_tpu_torch.rl.ssl_pretrain import SSLPretrainer
from eavit_tpu_torch.train import train
from eavit_tpu_torch.utils.checkpoint import BEST_SUFFIXES, load_checkpoint

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
AUG_TOL = dict(rtol=0, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 2e-5
# tests/test_ssl.py:17-43: dim 32, one layer, 16 patches
TINY = dict(dim=32, patch_size=21, depth=1, heads=2, dim_head=16, mlp_dim=64,
            dropout=0.0, emb_dropout=0.0)
SSL = dict(byol_projection_hidden_size=64, byol_projection_size=32,
           byol_representation_loss_coef=1.0, barlow_twins_projection_sizes=(64, 64),
           barlow_twins_representation_loss_coef=1.0)
N_ENV, N_STEP, N_ACT = 4, 8, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, obs_norm_step=1, update_proportion=1.0,
              learning_rate=1e-3, stable_eps=1e-3, attention_impl="pallas_qkv",
              fused_ffn=True, epoch=1, mini_batch=2)
BYOL, BT = RepresentationMethod.BYOL, RepresentationMethod.BARLOW_TWINS


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the augmentations
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_draws(key, b, h, w, blur_p, same_on_batch):
    n = 1 if same_on_batch else b
    k1, k2, k3 = jax.random.split(key, 3)
    top, left, ch, cw = jax_aug._sample_crop_params(k1, n, h, w)
    flip = jax.random.uniform(k2, (n,)) < 0.5
    k_p, k_sigma = jax.random.split(k3)
    apply = jax.random.uniform(k_p, (n,)) < blur_p
    sigma = jax.random.uniform(k_sigma, (n,), minval=0.1, maxval=2.0)
    return tuple(jnp.broadcast_to(v, (b,)) for v in (top, left, ch, cw, flip, apply, sigma))


def jax_view_draws(key, b, h, w, blur_p, same_on_batch):
    """The parameters ``ssl_augment(key, ...)`` draws (augment.py:124-131),
    as the port's ``AugmentParams``, each broadcast to ``b``. Under ``jit``,
    as the JAX package runs it: XLA computes ``area / ratio`` as ``area *
    exp(-log_ratio)``, which rounds otherwise than JAX's op-by-op evaluation."""
    return augment.AugmentParams(*(_t(v) for v in _jax_draws(key, b, h, w, blur_p,
                                                           same_on_batch)))


def jax_pair_draws(key, b, h, w, blur_p, same_on_batch):
    """The two views' parameters of ``ssl_augment_pair(key, ...)``."""
    return tuple(jax_view_draws(k, b, h, w, blur_p, same_on_batch)
                 for k in jax.random.split(key))


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_augment(key, x, same_on_batch):
    """Each step of one view and the pair (blur p 0.1) from ``key``, under
    ``jit`` as the package runs them."""
    k1, k2, k3 = jax.random.split(key, 3)
    crop = jax_aug.random_resized_crop(k1, x, same_on_batch)
    flipped = jax_aug.random_hflip(k2, crop, 0.5, same_on_batch)
    blurred = jax_aug.random_gaussian_blur(k3, flipped, 0.5, (0.1, 2.0), same_on_batch)
    return crop, flipped, blurred, jax_aug.ssl_augment_pair(key, x, 0.1, same_on_batch)


@pytest.mark.parametrize("same_on_batch", [False, True])
def test_augment_steps_and_pair_match_jax(same_on_batch):
    imgs = np.random.default_rng(0).random((6, 4, 84, 84)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    p = jax_view_draws(key, 6, 84, 84, 0.5, same_on_batch)
    crop, flipped, blurred, ref = _jax_augment(key, jnp.asarray(imgs), same_on_batch)
    np.testing.assert_allclose(augment.resized_crop(_t(imgs), p).numpy(), _np(crop), **AUG_TOL)
    np.testing.assert_array_equal(augment.hflip(_t(crop), p.flip).numpy(), _np(flipped))
    np.testing.assert_allclose(augment.gaussian_blur(_t(flipped), p.blur, p.sigma).numpy(),
                               _np(blurred), **AUG_TOL)
    # the draws did something: a flip, a blur, a crop that is not the image
    assert p.flip.any() and p.blur.any() and (p.crop_h < 84).any()
    views = augment.ssl_augment_pair(_t(imgs), jax_pair_draws(key, 6, 84, 84, 0.1,
                                                              same_on_batch))
    for a, b in zip(views, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), **AUG_TOL)


def test_port_draws_ranges_and_two_views_differ():
    gen = torch.Generator().manual_seed(5)
    n, h, w = 4000, 84, 84
    p = augment.draw_params(gen, n, h, w, 0.1)
    area = p.crop_h * p.crop_w / (h * w)
    ratio = p.crop_w / p.crop_h
    assert ((p.crop_h >= 1) & (p.crop_h <= h) & (p.crop_w >= 1) & (p.crop_w <= w)).all()
    assert area.max() <= 1.0 + 1e-6 and area.min() >= 0.08 * 0.75 - 1e-6
    assert ratio.min() >= 0.75 * 0.75 and ratio.max() <= (4 / 3) / 0.75
    assert ((p.top >= 0) & (p.top <= h - p.crop_h) & (p.left >= 0)
            & (p.left <= w - p.crop_w)).all()
    assert ((p.sigma >= 0.1) & (p.sigma <= 2.0)).all()
    assert abs(p.flip.float().mean().item() - 0.5) < 0.05
    assert abs(p.blur.float().mean().item() - 0.1) < 0.03
    one = augment.draw_params(gen, 8, h, w, 0.5, same_on_batch=True)
    assert all(bool((v == v[0]).all()) for v in one)
    # the agent's two views of one batch differ
    cfg = port_config.Config(vit=port_config.ViTConfig(**TINY), ssl=port_config.SSLConfig(**SSL),
                             representation_lr_method=BYOL, **COMMON)
    agent = RNDAgent(cfg, N_ACT, device="cpu")
    v1, v2 = agent._augment_params(Rng(1, "cpu"), 8)
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (8, 4, 84, 84),
                                                              dtype=np.uint8))
    a, b = agent.ssl.views(imgs, (v1, v2))
    assert a.shape == b.shape == (8, 4, 84, 84) and not torch.allclose(a, b)
    assert not torch.equal(v1.top, v2.top)


# ---------------------------------------------------------------------------
# the heads, the losses and the EMA
# ---------------------------------------------------------------------------


def _random_tree(shapes, seed: int):
    """A flax tree of the shapes of ``shapes`` drawn from ``seed``: kernels
    N(0, 1/fan_in), scales (LayerNorm, BatchNorm) near 1, biases near 0,
    tokens and position embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("scale"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_heads_batch_norm_and_byol_loss_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 32)).astype(np.float32)
    for jmod, ours in ((jax_ssl.BNMLP(48, 16), ssl.BNMLP(32, 48, 16)),
                       (jax_ssl.BTProjector((40, 24, 16)), ssl.BTProjector(32, (40, 24, 16)))):
        tree = _random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"], 3)
        load_flax_tree(ours, tree)
        np.testing.assert_allclose(ours(_t(x)).detach().numpy(),
                                   _np(jmod.apply({"params": tree}, jnp.asarray(x))), **TOL)
    y = rng.standard_normal((12, 16)).astype(np.float32)
    z = rng.standard_normal((12, 16)).astype(np.float32)
    np.testing.assert_allclose(ssl.byol_loss(_t(y), _t(z)).numpy(),
                               _np(jax_ssl._byol_loss_fn(jnp.asarray(y), jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(ssl.batch_norm(_t(y)).numpy(),
                               _np(jax_ssl._batch_norm(jnp.asarray(y))), **TOL)


# ---------------------------------------------------------------------------
# one JAX agent and one port agent with the same parameters, per method
# ---------------------------------------------------------------------------


def _cfgs(method, **kw):
    vit = dict(TINY, **kw.pop("vit", {}))
    args = dict(COMMON, representation_lr_method=method, **kw)
    return (jax_config.Config(vit=jax_config.ViTConfig(**vit),
                              ssl=jax_config.SSLConfig(**SSL), **args),
            port_config.Config(vit=port_config.ViTConfig(**vit),
                               ssl=port_config.SSLConfig(**SSL), **args))


def _frames(rng, shape):
    """uint8 frames with a level per channel and noise on it: white noise
    alone gives every frame nearly one embedding."""
    level = rng.integers(30, 220, shape[:-2] + (1, 1))
    return np.clip(level + rng.integers(-30, 31, shape), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_agent(method, kw_items):
    """The JAX agent of ``_cfgs(method, **dict(kw_items))`` and the shapes of
    its state, built once per module: the agent keeps its compiled
    programs."""
    jag = JaxAgent(_cfgs(method, **dict(kw_items))[0], N_ACT)
    return jag, jax.eval_shape(jag.init_state, jax.random.PRNGKey(0))


def _pair(method, **kw):
    """A JAX agent and a port agent with the same random parameters and EMA
    target (a perturbed copy of the online ones, so that the EMA moves it),
    both with ``obs_rms`` folded over the same frames."""
    pcfg = _cfgs(method, **kw)[1]
    jag, shapes = _jax_agent(method, tuple(sorted(kw.items())))
    params = _random_tree(shapes.params, 0)
    rnd_target = None if shapes.rnd_target is None else _random_tree(shapes.rnd_target, 1)
    ssl_target = None
    if shapes.ssl_target is not None:
        noise = _random_tree(shapes.ssl_target, 2)
        ssl_target = jax.tree_util.tree_map(
            lambda o, e: (o + 0.05 * e).astype(np.float32),
            {"feature": params["policy"]["feature"], "projector": params["ssl"]["projector"]},
            noise)
    jst = JaxAgentState(
        params=params, rnd_target=rnd_target, ssl_target=ssl_target,
        opt_state=jag.tx.init(params),
        obs_rms=None if shapes.obs_rms is None else jax_norm.rms_init(shapes.obs_rms.mean.shape),
        reward_rms=jax_norm.rms_init(()), reward_filter=jax_norm.reward_filter_init(N_ENV),
        global_step=jnp.zeros((2,), jnp.int32), global_update=jnp.zeros((), jnp.int32))
    pag = RNDAgent(pcfg, N_ACT, device="cpu")
    pst = pag.init_state(0)
    load_jax_params(pag, params, rnd_target, ssl_target)
    frames = _frames(np.random.default_rng(0), (16, 1, 84, 84))
    if jst.obs_rms is not None:
        # the warm-up's fold, op by op: jag.update_obs_rms would compile a program
        jst = jst._replace(obs_rms=jax_norm.rms_update(jst.obs_rms,
                                                       jnp.asarray(frames, jnp.float32)))
    return jag, jst, pag, pag.update_obs_rms(pst, frames)


def _check_params(pag, jparams, jtarget):
    modules = {"policy": (pag.network, jparams["policy"]), "ssl": (pag.ssl, jparams["ssl"])}
    if pag.rnd_pred is not None:
        modules["rnd_pred"] = (pag.rnd_pred, jparams["rnd_pred"])
    if pag.ssl_target is not None:
        modules["ssl_target"] = (pag.ssl_target, jtarget)
    for key, (module, tree) in modules.items():
        ref = flax_tree_to_torch(jax.tree_util.tree_map(_np, tree))
        ours = dict(module.named_parameters())
        assert set(ours) == set(ref), key
        for name, value in ref.items():
            np.testing.assert_allclose(ours[name].detach().numpy(), value,
                                       err_msg=f"{key}.{name}", rtol=0, atol=PARAM_ATOL)


class _JaxStubBackbone:
    """Stands in for the JAX backbone: two tokens ``(x w, 0.5 x w + 0.1)``
    of the stub images ``x`` [B, 8], ``w`` the ``feature`` tree's only leaf."""

    def apply(self, variables, x, deterministic):
        t = x @ variables["params"]["w"]
        return t, 0.5 * t + 0.1


class _StubBackbone(torch.nn.Module):
    """The port's twin of ``_JaxStubBackbone``."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(_t(w))

    def forward(self, x, rng=None):
        t = x @ self.w
        return t, 0.5 * t + 0.1


@pytest.mark.parametrize("method", [BYOL, BT], ids=["byol", "barlow_twins"])
def test_losses_and_ema_match_jax(method):
    """Each loss from given views through a stub backbone (the views and the
    backbone are held elsewhere): the embedding's token mean, the heads, the
    loss, BYOL's target path; then one EMA step of BYOL's target."""
    jcfg, pcfg = _cfgs(method)
    jmod, ours = (jax_ssl.BYOLModule(jcfg) if method == BYOL
                  else jax_ssl.BarlowTwinsModule(jcfg)), ssl.make_ssl(pcfg)
    rng = np.random.default_rng(8)
    w_online, w_target = (rng.standard_normal((8, 32)).astype(np.float32) / 3 for _ in range(2))
    v1, v2 = (rng.standard_normal((12, 8)).astype(np.float32) for _ in range(2))
    jmod.backbone = _JaxStubBackbone()
    jmod._views = lambda key, states, blur_p: (jnp.asarray(v1), jnp.asarray(v2))
    ours.views = lambda states, views: (_t(v1), _t(v2))
    policy = {"feature": {"w": w_online}}
    ssl_params = _random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), policy)[0], 5)
    load_flax_tree(ours, ssl_params)
    params = {"policy": policy, "ssl": ssl_params}
    feature = _StubBackbone(w_online)
    target = ours.make_target(feature)
    jtarget = None
    if method == BYOL:
        jtarget = {"feature": {"w": w_target},
                   "projector": _random_tree(jax.eval_shape(
                       lambda: ssl_params["projector"]), 6)}
        load_flax_tree(target, jtarget)
    ref = jmod.loss(params, jtarget, None, None)
    loss = ours.loss(feature, target, None, None)
    np.testing.assert_allclose(float(loss), float(ref), **TOL)
    assert float(loss) > 0.0
    if method == BYOL:  # one EMA step after the online parameters moved
        moved = jax.tree_util.tree_map(lambda x: x + 0.5, params)
        with torch.no_grad():
            for p in list(feature.parameters()) + list(ours.parameters()):
                p.add_(0.5)
        ours.update_target(target, feature)
        ref_t = flax_tree_to_torch(jmod.update_target(moved, jtarget))
        got = dict(target.named_parameters())
        assert set(got) == set(ref_t)
        for name, value in ref_t.items():
            np.testing.assert_allclose(got[name].detach().numpy(), value, err_msg=name, **TOL)
        assert all(not p.requires_grad for p in target.parameters())


# ---------------------------------------------------------------------------
# the update and the pretraining epoch
# ---------------------------------------------------------------------------


def _rollout(seed):
    rng = np.random.default_rng(seed)
    T, N = N_STEP, N_ENV
    return dict(
        states=_frames(rng, (T, N, 4, 84, 84)),
        actions=rng.integers(0, N_ACT, (T, N)).astype(np.int32),
        rewards=rng.choice([0.0, 1.0, 3.0], (T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        next_obs=_frames(rng, (T, N, 1, 84, 84)),
        value_ext=rng.standard_normal((T + 1, N)).astype(np.float32),
        value_int=rng.standard_normal((T + 1, N)).astype(np.float32),
        policy=rng.standard_normal((T, N, N_ACT)).astype(np.float32),
    )


def _jax_update_draws(key, epochs, n, n_mb, blur_p, same_on_batch):
    """The permutation of each epoch and the augment draws of each minibatch
    that ``_update_impl`` makes from ``key`` (agent.py:453-454, :573-586)."""
    perms, views = [], []
    for k in jax.random.split(key, epochs):
        k_perm, k_mb = jax.random.split(k)
        perms.append(_np(jax.random.permutation(k_perm, n)))
        for k_step in jax.random.split(k_mb, n_mb):
            k_ssl = jax.random.split(k_step, 4)[3]
            views.append(jax_pair_draws(k_ssl, n // n_mb, 84, 84, blur_p, same_on_batch))
    return perms, views


@pytest.mark.parametrize("method", [BYOL, BT], ids=["byol", "barlow_twins"])
def test_update_matches_jax(method, monkeypatch):
    jag, jst, pag, pst = _pair(method)
    ro = _rollout(3)
    key = jax.random.PRNGKey(9)
    n = N_STEP * N_ENV
    perms, views = _jax_update_draws(key, COMMON["epoch"], n, COMMON["mini_batch"],
                                     pag.ssl.blur_p, False)
    perms, views = iter(perms), iter(views)
    monkeypatch.setattr(pag, "_permutation",
                        lambda rng, m: torch.tensor(next(perms), dtype=torch.int64))
    monkeypatch.setattr(pag, "_augment_params", lambda rng, m: next(views))
    jnew, jm = jag.update(jst, JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()}), key)
    pnew, pm = pag.update(pst, Rollout(**{k: _t(v) for k, v in ro.items()}), Rng(0, "cpu"))
    assert next(perms, None) is None and next(views, None) is None
    jm = {k: float(v) for k, v in jm.items()}
    pm = {k: float(v) for k, v in pm.items()}
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **METRIC_TOL)
    assert pm["train/representation_loss"] > 0.0
    parts = ("train/actor_loss", "train/critic_loss", "train/entropy_loss",
             "train/rnd_loss", "train/representation_loss")
    np.testing.assert_allclose(pm["train/loss"], sum(pm[k] for k in parts), **TOL)
    _check_params(pag, jnew.params, jnew.ssl_target)


def test_pretrainer_epoch_matches_jax(monkeypatch):
    # the plain backbone: the kernel routes are held by the update above
    jag, jst, pag, pst = _pair(BYOL, attention_impl="xla", fused_ffn=False)
    rng = np.random.default_rng(7)
    train_u8, eval_u8 = (_frames(rng, (32, 4, 84, 84)) for _ in range(2))
    jpre = JaxPretrainer(jag.cfg, jag)
    pre = SSLPretrainer(pag.cfg, pag)
    # Adam eps 1e-3 on both sides, as the update tests' StableEps: the
    # pretrainers' 1e-8 turns float32 noise in gradients that are 0 in exact
    # arithmetic (the final LayerNorm's bias: the projector's BatchNorm
    # removes any shift of the embedding) into steps of a whole lr
    jpre.tx = optax.adam(jag.cfg.learning_rate, b1=0.9, b2=0.999, eps=1e-3)
    for group in pre.optimizer.param_groups:
        assert group["eps"] == 1e-8  # the pretrainer's own, as JAX's
        group["eps"] = 1e-3
    key = jax.random.PRNGKey(11)
    bs = jag.cfg.batch_size
    k_perm, k_mb, k_eval = jax.random.split(key, 3)
    perm = _np(jax.random.permutation(k_perm, 32))
    views = iter([jax_pair_draws(k, bs, 84, 84, 0.5, False)
                  for k in (*jax.random.split(k_mb, 32 // bs), *jax.random.split(k_eval, 32 // bs))])
    monkeypatch.setattr(pre, "_permutation", lambda rng, m: torch.tensor(perm, dtype=torch.int64))
    monkeypatch.setattr(pag, "_augment_params", lambda rng, m: next(views))
    adam_before = {id(p): {k: v.clone() for k, v in st.items()}
                   for p, st in pag.optimizer.state.items()}
    jnew, _, jtrain, jeval = jpre.epoch(jst, jpre.init_opt(jst), jnp.asarray(train_u8),
                                        jnp.asarray(eval_u8), key)
    ptrain, peval = pre.epoch(_t(train_u8), _t(eval_u8), Rng(0, "cpu"))
    assert next(views, None) is None
    np.testing.assert_allclose(float(ptrain), float(jtrain), **METRIC_TOL)
    np.testing.assert_allclose(float(peval), float(jeval), **METRIC_TOL)
    _check_params(pag, jnew.params, jnew.ssl_target)
    # the agent's own optimizer state is left as it was
    assert {id(p): st for p, st in pag.optimizer.state.items()}.keys() == adam_before.keys()


# ---------------------------------------------------------------------------
# the port alone: train, resume, evaluate; freeze_shared_backbone
# ---------------------------------------------------------------------------


def _demo_cfg(tmp_path, env_type, method):
    """``configs/ssl_pretrain_demo.conf`` cut in size: a one-layer dim-16 ViT,
    small heads, 2 envs x 8 steps, 2 pretraining epochs."""
    cfg = load_config(str(REPO / "configs" / "ssl_pretrain_demo.conf"))
    assert cfg.ssl_pretraining and cfg.representation_lr_method == BYOL
    return cfg.replace(
        vit=port_config.ViTConfig(dim=16, patch_size=12, depth=1, heads=2, dim_head=8,
                                  mlp_dim=32),
        ssl=port_config.SSLConfig(byol_projection_hidden_size=32, byol_projection_size=16,
                                  barlow_twins_projection_sizes=(32, 32, 32)),
        representation_lr_method=method, env_type=env_type, num_env_per_process=2,
        num_step=8, epoch=1, mini_batch=2, obs_norm_step=1, ssl_pretrain_epochs=2,
        max_step_per_episode=12, save_ckpt_every=1, log_name="ssl_demo",
        save_model_path=str(tmp_path / "ckpt"))


@pytest.mark.parametrize("env_type,method", [(EnvType.SYNTHETIC, BYOL),
                                             (EnvType.SYNTHETIC_DEVICE, BT)],
                         ids=["host_env-byol", "device_env-barlow_twins"])
def test_train_ssl_pretrain_demo_resume_and_evaluate(tmp_path, env_type, method):
    cfg = _demo_cfg(tmp_path, env_type, method)
    logs = tmp_path / "logs"
    metrics = train(cfg, total_updates=1, log_dir=str(logs), device="cpu")
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["train/representation_loss"] > 0.0
    lines = [json.loads(x) for x in (logs / "ssl_demo_scalars.jsonl").read_text().splitlines()]
    tags = {f"SSL_pretraining/Representation_loss({method.value})({d} dataset) vs epoch"
            for d in ("training", "evaluation")}
    pre = [ln for ln in lines if tags <= set(ln)]
    assert len(pre) == 2 and all(np.isfinite(ln[t]) for ln in pre for t in tags)
    text = (logs / "ssl_demo_rank0.log").read_text()
    assert "SSL_pretraining_epoch: 1, training_representation_loss:" in text
    assert text.index("SSL_pretraining_epoch: 0") < text.index("entering training loop")
    best = cfg.save_model_path + "/ssl_demo" + BEST_SUFFIXES["ssl_loss"]
    meta = json.loads(pathlib.Path(best + ".json").read_text())
    assert meta["phase"] == "ssl_pretraining" and np.isfinite(meta["best_metrics"]["ssl_loss"])
    agent = RNDAgent(cfg, 5, device="cpu")
    agent.init_state(cfg.seed)
    load_checkpoint(best, agent)  # the SSL modules come back

    main = cfg.save_model_path + "/ssl_demo"
    resumed = train(cfg.replace(load_model=True, load_model_path=main), total_updates=2,
                    log_dir=str(logs), device="cpu")
    assert np.isfinite(resumed["train/loss"]) and resumed["train/representation_loss"] > 0
    assert "@ update 1" in (logs / "ssl_demo_rank0.log").read_text()
    state, meta = load_checkpoint(main, agent)
    assert meta["global_update"] == 2 and state.global_update == 2
    out = evaluate(cfg.replace(load_model_path=main), num_episodes=1, log_dir=str(logs),
                   device="cpu")
    assert out["episodes"] == 1 and out["intrinsic_trace_len"] > 0


def test_freeze_shared_backbone_keeps_the_backbone_and_steps_the_ema():
    pcfg = _cfgs(BYOL, freeze_shared_backbone=True)[1]
    agent = RNDAgent(pcfg, N_ACT, device="cpu")
    state = agent.init_state(0)
    frames = _frames(np.random.default_rng(0), (16, 1, 84, 84))
    state = agent.update_obs_rms(state, frames)
    with torch.no_grad():  # a target apart from the online modules, so the EMA shows
        for p in agent.ssl_target.parameters():
            p.add_(0.1)
    feature = [p.detach().clone() for p in agent.network.feature.parameters()]
    target = [p.detach().clone() for p in agent.ssl_target.parameters()]
    head = agent.network.actor_fc2.weight.detach().clone()
    _, metrics = agent.update(state, Rollout(**{k: _t(v) for k, v in _rollout(4).items()}),
                              Rng(0, "cpu"))
    assert float(metrics["train/representation_loss"]) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(feature, agent.network.feature.parameters()))
    assert not torch.equal(head, agent.network.actor_fc2.weight)
    # the EMA stepped once a minibatch toward the (unchanged) online backbone
    decay, steps = pcfg.ssl.byol_moving_average_decay, COMMON["mini_batch"]
    for t0, t1, o in zip(target, agent.ssl_target["feature"].parameters(),
                         agent.network.feature.parameters()):
        np.testing.assert_allclose((t1 - o).detach().numpy(),
                                   ((t0 - o) * decay ** steps).detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_load_jax_state_carries_the_ssl_heads_target_and_moments():
    jag, jst, pag, _ = _pair(BYOL, attention_impl="xla", fused_ffn=False)
    # Adam moments that differ from the parameters, so a mix-up shows
    mu = _random_tree(jax.eval_shape(lambda: jst.params), 7)
    nu = jax.tree_util.tree_map(np.abs, _random_tree(jax.eval_shape(lambda: jst.params), 8))

    def with_moments(opt):  # the ScaleByAdamState inside the optax chain state
        if hasattr(opt, "mu"):
            return opt._replace(mu=mu, nu=nu, count=np.asarray(3, np.int32))
        return tuple(with_moments(o) for o in opt) if type(opt) is tuple else opt

    state_np = jax.tree_util.tree_map(np.asarray,
                                      jst._replace(opt_state=with_moments(jst.opt_state)))
    ours = load_jax_state(pag, state_np)
    assert ours.global_update == 0
    _check_params(pag, state_np.params, state_np.ssl_target)
    ref = flax_tree_to_torch(mu["ssl"])
    for name, p in pag.ssl.named_parameters():
        st = pag.optimizer.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), ref[name], err_msg=name)
        assert float(st["step"]) == 3.0
