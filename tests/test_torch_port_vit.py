"""Models and configuration of the torch port against the JAX package.

``DualTokenViT`` (shared-patch-stream and exact stacked modes) and
``ActorCritic`` are built in both packages at a tiny width, the JAX
parameters are loaded into the port with ``convert.load_flax_tree``, and
the same numpy inputs go through both. The JAX side runs the flagship
implementations (``pallas_qkv`` attention, fused FFN) in interpret mode,
as its own CPU tests do. Tolerances: 1e-5 at float32; 2e-2 at bfloat16,
where the Dense layers round to bf16 at the same points in both packages.
Also: every ``configs/*.conf`` parses to the same ``Config`` in both
packages, and importing the port pulls in neither JAX nor ``eavit_tpu``.
"""

import dataclasses
import functools
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models.policy import ActorCritic as JaxActorCritic
from eavit_tpu.models.vit import DualTokenViT as JaxViT
from eavit_tpu.models.vit import patchify as jax_patchify
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import load_flax_tree
from eavit_tpu_torch.models.policy import ActorCritic
from eavit_tpu_torch.models.vit import DualTokenViT, patchify

from _torch_port_jax_state import random_tree

# One intra-op thread: the suite runs several test processes on one host, and
# torch's thread pools spinning against each other (and against XLA's) make
# these many small ops an order of magnitude slower than one thread does.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=48, patch_size=12, depth=2, heads=4, dim_head=12, mlp_dim=96)
IMG, CH = 84, 4
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _img(seed, b=3):
    return np.random.default_rng(seed).random((b, CH, IMG, IMG)).astype(np.float32)


def _variables(module, img, seed):
    """``module.init``'s variables without running it: the parameter tree in
    the shapes ``jax.eval_shape`` gives, drawn with numpy (``random_tree``)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), jnp.asarray(img))
    assert set(shapes) == {"params"}
    return {"params": random_tree(shapes["params"], seed)}


def test_patchify_matches():
    x = _img(0, 2)
    np.testing.assert_array_equal(patchify(torch.tensor(x), 12).numpy(),
                                  np.asarray(jax_patchify(jnp.asarray(x), 12)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False])
def test_dual_token_vit_matches_jax(shared, dtype):
    jdt, tdt = DT[dtype]
    def jax_vit(**impl):
        return JaxViT(cfg=jax_config.ViTConfig(**TINY), image_size=IMG, channels=CH,
                      shared_patch_stream=shared, dtype=jdt, **impl)

    img = _img(1)
    # the XLA twin has the same parameter tree
    variables = _variables(jax_vit(), img, 0)
    ref = jax_vit(attention_impl="pallas_qkv", ffn_impl="pallas").apply(
        variables, jnp.asarray(img))

    vit = DualTokenViT(port_config.ViTConfig(**TINY), IMG, CH, attention_route="kernel",
                       ffn_route="kernel", shared_patch_stream=shared, dtype=tdt)
    load_flax_tree(vit, variables["params"])
    with torch.no_grad():
        out = vit(torch.tensor(img))
    assert len(out) == 2
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _actor_critic_variables(dtype):
    """The JAX ActorCritic's init on ``_img(2)``, shared by both routes: the
    XLA twin has the same parameter tree."""
    cfg = jax_config.Config(vit=jax_config.ViTConfig(**TINY), shared_patch_stream=True,
                            compute_dtype=dtype, attention_impl="xla", fused_ffn=False)
    return JaxActorCritic(cfg=cfg, output_size=5).init(jax.random.PRNGKey(1),
                                                       jnp.asarray(_img(2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_actor_critic_matches_jax(route, dtype):
    impl = {"kernel": dict(attention_impl="pallas_qkv", fused_ffn=True),
            "plain": dict(attention_impl="xla", fused_ffn=False)}[route]
    kw = dict(vit=None, shared_patch_stream=True, compute_dtype=dtype, **impl)
    jcfg = jax_config.Config(**{**kw, "vit": jax_config.ViTConfig(**TINY)})
    pcfg = port_config.Config(**{**kw, "vit": port_config.ViTConfig(**TINY)})
    img = _img(2)
    variables = _actor_critic_variables(dtype)
    ref = JaxActorCritic(cfg=jcfg, output_size=5).apply(variables, jnp.asarray(img))

    net = ActorCritic(pcfg, 5)
    load_flax_tree(net, variables["params"])
    with torch.no_grad():
        out = net(torch.tensor(img))
    for name in ("policy", "value_ext", "value_int", "features"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL[dtype])


@pytest.mark.parametrize("shared", [True, False])
def test_dual_token_vit_pallas_route_matches_jax(shared):
    """``AttentionImpl = pallas`` (the port's flash route, K4 at a
    deterministic forward) against the JAX module on that route, whose
    parameter tree loads into the port as it is."""
    def jax_vit(**impl):
        return JaxViT(cfg=jax_config.ViTConfig(**TINY), image_size=IMG, channels=CH,
                      shared_patch_stream=shared, dtype=jnp.float32, **impl)

    img = _img(4)
    variables = _variables(jax_vit(attention_impl="pallas"), img, 3)
    ref = jax_vit(attention_impl="pallas", ffn_impl="pallas").apply(
        variables, jnp.asarray(img))
    vit = DualTokenViT(port_config.ViTConfig(**TINY), IMG, CH, attention_route="flash",
                       ffn_route="kernel", shared_patch_stream=shared, dtype=torch.float32)
    load_flax_tree(vit, variables["params"])
    with torch.no_grad():
        out = vit(torch.tensor(img))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL["float32"])


@pytest.mark.parametrize("shared", [True, False])
def test_dual_token_vit_pallas_stream_route_matches_jax(shared):
    """``AttentionImpl = pallas_stream`` (the port's stream route, K5 at a
    deterministic forward) against the JAX module on that route, whose
    parameter tree loads into the port as it is. One layer and the plain FFN
    on both sides keep the interpret-mode kernels to the attention's."""
    cfg = dict(TINY, depth=1)

    def jax_vit():
        return JaxViT(cfg=jax_config.ViTConfig(**cfg), image_size=IMG, channels=CH,
                      shared_patch_stream=shared, dtype=jnp.float32,
                      attention_impl="pallas_stream")

    img = _img(5)
    variables = _variables(jax_vit(), img, 4)
    ref = jax_vit().apply(variables, jnp.asarray(img))
    vit = DualTokenViT(port_config.ViTConfig(**cfg), IMG, CH, attention_route="stream",
                       shared_patch_stream=shared, dtype=torch.float32)
    load_flax_tree(vit, variables["params"])
    with torch.no_grad():
        out = vit(torch.tensor(img))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL["float32"])


def test_cls_token_vit_matches_jax():
    # without explorative attention the single CLS stream feeds everything
    cfg = dict(TINY, use_explorative_attn=False)
    jvit = JaxViT(cfg=jax_config.ViTConfig(**cfg), image_size=IMG, channels=CH,
                  dtype=jnp.float32)
    img = _img(3, 2)
    variables = _variables(jvit, img, 2)
    (ref,) = jvit.apply(variables, jnp.asarray(img))
    vit = DualTokenViT(port_config.ViTConfig(**cfg), IMG, CH, dtype=torch.float32)
    load_flax_tree(vit, variables["params"])
    with torch.no_grad():
        (out,) = vit(torch.tensor(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


def _as_plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return getattr(obj, "value", obj)  # enums compare by value


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "configs", "*.conf"))),
    ids=os.path.basename)
def test_config_parses_like_jax(path):
    assert _as_plain(port_config.load_config(path)) == _as_plain(jax_config.load_config(path))


def test_attention_routes():
    c = port_config.Config
    assert port_config.attention_route(c(attention_impl="pallas_qkv")) == "kernel"
    assert port_config.attention_route(c(attention_impl="xla")) == "plain"
    assert port_config.attention_route(c()) == "plain"
    assert port_config.attention_route(c(attention_impl="pallas")) == "flash"
    assert port_config.attention_route(c(use_pallas_attention=True)) == "flash"
    assert port_config.attention_route(c(attention_impl="pallas_stream")) == "stream"
    assert port_config.ffn_route(c(fused_ffn=True)) == "kernel"
    with pytest.raises(ValueError):
        port_config.attention_route(c(attention_impl="flashy"))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import eavit_tpu_torch\n"
        "for m in pkgutil.walk_packages(eavit_tpu_torch.__path__, 'eavit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'flax', 'eavit_tpu')\n"
        "       or n.startswith(('jax.', 'flax.', 'eavit_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
