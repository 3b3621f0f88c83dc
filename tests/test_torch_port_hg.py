"""The HF-flavour backbone ``DualTokenViTHG`` of the torch port against the
JAX package, on the CPU at a tiny width (hidden 32, one layer, 2 heads,
patch 12, so 50 tokens stacked and 51 shared, as the full-size model has).

- Forward and input gradient, the three variants (shared patch stream,
  exact stacked, CLS) on every route the CPU runs (``plain``, and the
  ``kernel``, ``flash`` and ``stream`` routes, which take their kernels'
  plain versions here), against the JAX module on its ``xla`` route with
  one random parameter tree (qkv bias, LayerNorm eps 1e-12, a non-zero conv
  bias): 1e-5 in float32, 2e-2 (the repo's bf16 tolerance) in bfloat16.
- The patch projection: the flax conv kernel ``[p, p, C, D]`` loads into
  the port's Dense over ``patchify``'s features, and the port's parameter
  names mirror the JAX tree (``encoder``, ``to_qkv.bias``).
- One HG ``update`` against ``eavit_tpu``'s at the criteria of
  ``test_torch_port_update.py`` (metrics rtol 1e-4, parameters 2e-5), the
  JAX agent on ``xla`` and the port's on its kernel routes, and
  ``load_jax_state`` of the HG agent.
- ``python -m eavit_tpu_torch --train`` (the CLI's ``main``, in process) on
  a tiny HG ``.conf`` for two updates with ``--device cpu``; the initial
  tokens, positions and patch kernel have flax's truncated-normal spread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models.vit import DualTokenViTHG as JaxHG
from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import load_flax_tree, load_jax_params, load_jax_state
from eavit_tpu_torch.models.layers import Rng, init_module
from eavit_tpu_torch.models.policy import build_backbone
from eavit_tpu_torch.models.vit import DualTokenViTHG
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from tests.test_torch_port_update import (
    N_ACT,
    _compare_after_update,
    _jax_permutations,
    _rollout,
)

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

HG = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
          intermediate_size=64, patch_size=12)
IMG, CH = 84, 4
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {"shared": (True, True), "stacked": (False, True), "cls": (False, False)}


def _np(x):
    return np.asarray(x)


def _random_tree(shapes, seed):
    """A parameter tree in the shapes ``jax.eval_shape(init)`` gives (no
    init to compile), drawn with numpy: LayerNorm scales 1 + N(0, 0.05),
    kernels N(0, 1 / fan_in), the rest (biases, positions, tokens) N(0,
    0.05), so that every parameter takes part."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(s.shape)
        if name == "scale":
            x = 1.0 + 0.05 * x
        elif name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        else:
            x = 0.05 * x
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_reference(variant, dtype):
    """(params, img, cotangents, outputs, input gradient) of the JAX module."""
    shared, explore = VARIANTS[variant]
    jdt, _ = DT[dtype]
    vit = JaxHG(cfg=jax_config.ViTHGConfig(**HG, use_explorative_attn=explore),
                image_size=IMG, channels=CH, shared_patch_stream=shared, dtype=jdt)
    rng = np.random.default_rng(1)
    img = rng.random((2, CH, IMG, IMG)).astype(np.float32)
    params = _random_tree(jax.eval_shape(vit.init, jax.random.PRNGKey(0),
                                         jnp.asarray(img))["params"], 2)
    cots = [rng.standard_normal((2, HG["hidden_size"])).astype(np.float32)
            for _ in range(2 if explore else 1)]

    def loss(x):
        outs = vit.apply({"params": params}, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, outs), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(img))
    return params, img, cots, [_np(o) for o in outs], _np(grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["plain", "kernel", "flash", "stream"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hg_forward_and_input_gradient_match_jax(variant, route, dtype):
    params, img, cots, ref, ref_grad = _jax_reference(variant, dtype)
    shared, explore = VARIANTS[variant]
    vit = DualTokenViTHG(port_config.ViTHGConfig(**HG, use_explorative_attn=explore),
                         IMG, CH, attention_route=route,
                         ffn_route="plain" if route == "plain" else "kernel",
                         shared_patch_stream=shared, dtype=DT[dtype][1])
    load_flax_tree(vit, params)
    x = torch.tensor(img, requires_grad=True)
    outs = vit(x)
    assert len(outs) == len(ref)
    for o, r in zip(outs, ref):
        assert o.dtype == torch.float32 and o.shape == (2, HG["hidden_size"])
        np.testing.assert_allclose(o.detach().numpy(), r, **TOL[dtype])
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    scale = float(np.abs(ref_grad).max())
    tol = TOL[dtype]
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def test_hg_parameter_names_and_patch_projection():
    """The port's tree is the JAX tree under its names, and the Dense over
    ``patchify``'d patches computes the flax conv."""
    params = _jax_reference("stacked", "float32")[0]
    vit = DualTokenViTHG(port_config.ViTHGConfig(**HG), IMG, CH)
    load_flax_tree(vit, params)
    names = dict(vit.named_parameters())
    assert "encoder.attn_0.to_qkv.bias" in names and "encoder.norm.weight" in names
    assert names["patch_proj.weight"].shape == (32, 12 * 12 * CH)
    assert vit.encoder.norm.eps == 1e-12 and vit.encoder.ff_0.norm.eps == 1e-12
    img = np.random.default_rng(3).random((2, CH, IMG, IMG)).astype(np.float32)
    conv = jax.lax.conv_general_dilated(
        jnp.asarray(img).transpose(0, 2, 3, 1), params["patch_proj"]["kernel"], (12, 12),
        "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")) + params["patch_proj"]["bias"]
    from eavit_tpu_torch.models.vit import patchify
    with torch.no_grad():
        ours = vit.patch_proj(patchify(torch.tensor(img), 12))
    np.testing.assert_allclose(ours.numpy(), _np(conv).reshape(2, 49, 32), rtol=1e-5,
                               atol=1e-5)


def test_hg_init_has_the_truncated_normal_spread():
    cfg = port_config.Config(vit_implementation_type=port_config.ViTImplementation.HG,
                             vit_hg=port_config.ViTHGConfig(**HG))
    vit = build_backbone(cfg)
    assert isinstance(vit, DualTokenViTHG)
    gen = torch.Generator().manual_seed(0)
    init_module(vit, gen)
    for name in ("pos_embedding", "exploration_token", "patch_proj.weight"):
        p = dict(vit.named_parameters())[name].detach()
        # flax's truncated_normal(0.02): cut at 2 / 0.8796 standard deviations
        assert float(p.abs().max()) <= 0.02 * 2 / 0.87962566103423978 + 1e-7, name
        if p.numel() > 1000:
            assert abs(float(p.std()) - 0.02) < 0.002, name
    assert float(vit.patch_proj.bias.detach().abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the agent: update, state, train
# ---------------------------------------------------------------------------


def _hg_cfgs(**kw):
    kw = dict(vit_implementation_type=jax_config.ViTImplementation.HG, num_env_per_process=2,
              num_step=8, compute_dtype="float32", shared_patch_stream=True,
              obs_norm_step=1, update_proportion=1.0, learning_rate=1e-3,
              stable_eps=1e-3, **kw)
    jcfg = jax_config.Config(vit_hg=jax_config.ViTHGConfig(**HG), attention_impl="xla",
                             fused_ffn=False, **kw)
    pcfg = port_config.Config(
        vit_hg=port_config.ViTHGConfig(**HG), attention_impl="pallas_qkv", fused_ffn=True,
        **dict(kw, vit_implementation_type=port_config.ViTImplementation.HG))
    return jcfg, pcfg


def test_hg_update_matches_jax(monkeypatch):
    epochs = 2
    jcfg, pcfg = _hg_cfgs(epoch=epochs, mini_batch=2)
    jag = JaxAgent(jcfg, N_ACT)
    # the JAX state in the shapes of init_state, its trees drawn with numpy
    # (compiling the JAX init costs more than the update)
    shapes = jax.eval_shape(jag.init_state, jax.random.PRNGKey(0))
    params = _random_tree(shapes.params, 4)
    jst = shapes._replace(
        params=params, rnd_target=_random_tree(shapes.rnd_target, 5),
        opt_state=jag.tx.init(params), obs_rms=jax_norm.rms_init((1, 84, 84)),
        reward_rms=jax_norm.rms_init(()), reward_filter=jax_norm.reward_filter_init(2),
        global_step=jnp.zeros((2,), jnp.int32), global_update=jnp.zeros((), jnp.int32))
    pag = RNDAgent(pcfg, N_ACT, device="cpu")
    pst = pag.init_state(0)
    load_jax_params(pag, jax.tree_util.tree_map(_np, jst.params),
                    jax.tree_util.tree_map(_np, jst.rnd_target))
    frames = np.random.default_rng(0).integers(0, 256, (16, 1, 84, 84), dtype=np.uint8)
    jst, pst = jag.update_obs_rms(jst, jnp.asarray(frames)), pag.update_obs_rms(pst, frames)
    ro = _rollout(6)
    key = jax.random.PRNGKey(13)
    perms = iter(_jax_permutations(key, epochs, 16))
    monkeypatch.setattr(pag, "_permutation",
                        lambda rng, n: torch.tensor(next(perms), dtype=torch.int64))
    jnew, jmetrics = jag.update(jst, JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()}),
                                key)
    pnew, pmetrics = pag.update(
        pst, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()}),
        Rng(0, "cpu"))
    _compare_after_update(jag, jnew, jmetrics, pag, pnew, pmetrics)

    # the whole JAX state (parameters, Adam moments, normalisers) carries over
    again = RNDAgent(pcfg, N_ACT, device="cpu")
    again.init_state(1)
    state = load_jax_state(again, jax.tree_util.tree_map(_np, jnew))
    assert state.global_update == 1
    for (name, a), b in zip(pag.network.named_parameters(), again.network.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    conv_mu = again.optimizer.state[again.network.feature.patch_proj.weight]["exp_avg"]
    assert conv_mu.shape == (32, 12 * 12 * 4) and float(conv_mu.abs().max()) > 0


HG_KEYS = dict(ViT_implementation_type="1", ViTHG_hidden_size="32",
               ViTHG_num_hidden_layers="1", ViTHG_num_attention_heads="2",
               ViTHG_intermediate_size="64", ViTHG_patch_size="21",
               ViTHG_hidden_dropout_prob="0.1", AttentionImpl="pallas_qkv",
               FusedFFN="True", SharedPatchStream="True", NumStep="8", Epoch="1",
               MiniBatch="2", ObsNormStep="1")


def test_cli_trains_an_hg_config_on_the_cpu(tmp_path, capsys):
    """``synthetic_demo.conf`` with the HF flavour at hidden 32, one layer,
    patch 21 and dropout 0.1 live, through the CLI's ``main``."""
    import os

    from eavit_tpu_torch.__main__ import main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = open(os.path.join(repo, "configs", "synthetic_demo.conf")).read().splitlines()
    keep = [ln for ln in lines if ln.split("=")[0].strip() not in HG_KEYS]
    conf = tmp_path / "hg.conf"
    conf.write_text("\n".join(keep + [f"{k} = {v}" for k, v in HG_KEYS.items()]) + "\n")
    main(["--train", "--config_path", str(conf), "--total_updates", "2", "--device", "cpu",
          "--log_name", "hg", "--save_model_path", str(tmp_path / "ck")])
    assert "update 2 | global_step" in capsys.readouterr().out
    payload = torch.load(tmp_path / "ck" / "hg.pt", weights_only=True)
    policy = payload["policy"]
    assert policy["feature.encoder.attn_0.to_qkv.bias"].shape == (96,)
    assert policy["feature.patch_proj.weight"].shape == (32, 21 * 21 * 4)
