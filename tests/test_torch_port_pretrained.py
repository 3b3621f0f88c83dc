"""timm weight import of the torch port (``eavit_tpu_torch/models/pretrained.py``)
against the JAX package's ``load_pretrained_timm``.

Timm-format state dicts are built in the test from a seed (no checkpoint is
downloaded). The JAX function fills a ``DualTokenViT`` tree drawn with numpy
in the shapes of ``jax.eval_shape(init)``; the port's fills the state dict of
the port's ``DualTokenViT`` holding the same tree. The results agree within
1e-6 for position grids of equal size, grown (4 x 4 to 7 x 7) and shrunk
(14 x 14 and 16 x 16 to 7 x 7: ``jax.image.resize`` antialiases there, and
``F.interpolate`` does not), for 3 -> 4 and 4 -> 4 channels, dual-token and
CLS trees, and a ``torch.save`` file that holds the dict flat or under
``state_dict`` or ``model``. The loaded model's forward equals the JAX one's
on the loaded tree (1e-5). A wrong patch size, width or a non-square grid
raises in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models.pretrained import load_pretrain as jax_load_pretrain
from eavit_tpu.models.pretrained import load_pretrained_timm as jax_load
from eavit_tpu.models.vit import DualTokenViT as JaxViT
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import flax_tree_to_torch, load_flax_tree
from eavit_tpu_torch.models.pretrained import load_pretrain, load_pretrained_timm
from eavit_tpu_torch.models.vit import DualTokenViT

torch.set_num_threads(1)

DIM, HEADS, DH, MLP, PATCH, DEPTH = 32, 4, 8, 64, 12, 2
IMG, CH = 84, 4


def timm_state_dict(grid, channels, rng, qkv_bias=False):
    """A timm ViT state dict at ``grid x grid`` patches (``tests/test_pretrained``'s
    layout), float32 from ``rng``."""
    inner = HEADS * DH

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"pos_embed": r(1, grid * grid + 1, DIM), "cls_token": r(1, 1, DIM),
          "patch_embed.proj.weight": r(DIM, channels, PATCH, PATCH),
          "patch_embed.proj.bias": r(DIM), "norm.weight": r(DIM), "norm.bias": r(DIM)}
    for i in range(DEPTH):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": r(DIM), p + "norm1.bias": r(DIM),
                   p + "attn.qkv.weight": r(3 * inner, DIM),
                   p + "attn.proj.weight": r(DIM, inner), p + "attn.proj.bias": r(DIM),
                   p + "norm2.weight": r(DIM), p + "norm2.bias": r(DIM),
                   p + "mlp.fc1.weight": r(MLP, DIM), p + "mlp.fc1.bias": r(MLP),
                   p + "mlp.fc2.weight": r(DIM, MLP), p + "mlp.fc2.bias": r(DIM)})
        if qkv_bias:
            sd[p + "attn.qkv.bias"] = r(3 * inner)
    return sd


def _vit_cfg(explore):
    return dict(dim=DIM, patch_size=PATCH, depth=DEPTH, heads=HEADS, dim_head=DH,
                mlp_dim=MLP, dropout=0.0, emb_dropout=0.0, use_explorative_attn=explore)


def _pair(explore, seed=0):
    """(jax module, numpy tree, port module holding the tree)."""
    jvit = JaxViT(cfg=jax_config.ViTConfig(**_vit_cfg(explore)), image_size=IMG,
                  channels=CH, dtype=jnp.float32)
    shapes = jax.eval_shape(jvit.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, CH, IMG, IMG), jnp.float32))["params"]
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    vit = DualTokenViT(port_config.ViTConfig(**_vit_cfg(explore)), IMG, CH)
    load_flax_tree(vit, tree)
    return jvit, tree, vit


def _same(ours, jax_tree):
    ref = flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert set(ours) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), value, rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("explore", [True, False], ids=["dual", "cls"])
@pytest.mark.parametrize("grid,channels", [(7, 4), (4, 3), (14, 3), (16, 4)],
                         ids=["equal", "grown", "shrunk", "shrunk16"])
def test_load_pretrained_timm_matches_jax(grid, channels, explore):
    jvit, tree, vit = _pair(explore)
    sd = timm_state_dict(grid, channels, np.random.default_rng(grid + channels))
    ref = jax_load(tree, sd, channels=CH, patch_size=PATCH)
    ours = load_pretrained_timm(vit.state_dict(), sd, channels=CH, patch_size=PATCH)
    _same(ours, ref)
    if explore:
        assert torch.equal(ours["exploration_token"], ours["exploitation_token"])
    # the loaded model computes the JAX model on the loaded tree
    vit.load_state_dict(ours)
    img = np.random.default_rng(5).random((2, CH, IMG, IMG)).astype(np.float32)
    want = jvit.apply({"params": ref}, jnp.asarray(img))
    with torch.no_grad():
        got = vit(torch.tensor(img))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wrapper", [None, "state_dict", "model"])
def test_load_pretrain_reads_a_torch_file(tmp_path, wrapper):
    _, tree, vit = _pair(True, seed=1)
    sd = timm_state_dict(14, 3, np.random.default_rng(9))
    path = tmp_path / "vit.pth"
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save(tensors if wrapper is None else {wrapper: tensors, "epoch": 3}, path)
    ours = load_pretrain(vit.state_dict(), str(path), channels=CH, patch_size=PATCH)
    _same(ours, jax_load_pretrain(tree, str(path), channels=CH, patch_size=PATCH))


@pytest.mark.parametrize("fault,match", [
    ("patch", "patch size"), ("width", "shape mismatch"), ("grid", "non-square")])
def test_shapes_are_checked(fault, match):
    _, tree, vit = _pair(True)
    sd = timm_state_dict(7, 4, np.random.default_rng(3))
    patch = PATCH
    if fault == "patch":
        patch = 16
    elif fault == "width":
        sd["norm.weight"] = sd["norm.weight"][:16]
    else:
        sd["pos_embed"] = sd["pos_embed"][:, :-1]
    with pytest.raises((ValueError, AssertionError), match=match):
        jax_load(tree, sd, channels=CH, patch_size=patch)
    with pytest.raises(ValueError, match=match):
        load_pretrained_timm(vit.state_dict(), sd, channels=CH, patch_size=patch)
