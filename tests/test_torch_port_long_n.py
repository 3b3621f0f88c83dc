"""K1, K3 and K4 of the torch port at sequences past what a whole head in
shared memory held, against the JAX package.

The CUDA kernels of K1, K3 and K4 stream their operands and take any N, as
``eavit_tpu`` does on the ``pallas`` and ``pallas_qkv`` routes (K1 and K3
through their XLA path past ``supports(n)``, K4 by blocking its rows down to
one per grid cell). Their plain versions, which the kernels are held to on a
GPU by test_torch_port_cuda.py, are held here to ``eavit_tpu`` at N = 443
(patch 4) and 786 (patch 3), through whatever path the JAX package takes
there on the CPU (the XLA reference for K1, the Pallas kernels in interpret
mode for K4 and for K3 at rate 0): forward and ``jax.grad`` at float32,
1e-5 of each output's scale; K1 at rate 0.1 against a numpy composition
under its replayed mask (1e-5). ``DualTokenViT`` on ``pallas`` and
``pallas_qkv`` with patch 3 on 84x84 frames (786 tokens in the shared
stream) is held to the JAX module at rate 0 (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.models.vit import DualTokenViT as JaxViT
from eavit_tpu.ops import flash as jax_flash
from eavit_tpu.ops import flash_dropout as jax_fd
from eavit_tpu.ops import flash_qkv as jax_fq
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import load_flax_tree
from eavit_tpu_torch.models.vit import DualTokenViT
from eavit_tpu_torch.ops import flash, flash_dropout, flash_qkv
from eavit_tpu_torch.ops.kernel_prng import inv_keep_scale, keep_threshold

from _torch_port_jax_state import random_tree

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

LONG_N = (443, 786)  # patch 4 and patch 3 on 84x84, shared stream
B, H, DH, NS = 1, 2, 16, 2


def _assert_close(ours, ref, tol=1e-5):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


def _heads(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, n, DH)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("n", LONG_N)
def test_k1_matches_jax_at_long_n(n):
    """Forward and gradient of ``flash_mha_qkv`` at rate 0."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((B, n, 3 * H * DH)).astype(np.float32)
    g = rng.standard_normal((B, n, H * DH)).astype(np.float32)

    def jloss(x_):
        o = jax_fq.flash_mha_qkv(x_, H, DH, num_special=NS)
        return jnp.sum(o * jnp.asarray(g)), o

    (_, ref_o), ref_dx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = flash_qkv.flash_mha_qkv(tx, H, DH, num_special=NS)
    out.backward(torch.tensor(g))
    _assert_close(out.detach().numpy(), np.asarray(ref_o))
    _assert_close(tx.grad.numpy(), np.asarray(ref_dx))


@pytest.mark.parametrize("n", LONG_N)
def test_k1_dropout_is_the_numpy_composition_at_long_n(n):
    """At rate 0.1 (no JAX kernel runs dropout on the CPU): softmax, the mask
    replayed by K1r, the inverse keep scale and the product."""
    rate, seeds = 0.1, (17, 29)
    x = np.random.default_rng(n + 1).standard_normal((B, n, 3 * H * DH)).astype(np.float32)
    scale = DH ** -0.5
    out, _ = flash_qkv.flash_qkv_fwd(torch.tensor(x), H, DH, scale, NS, seeds, rate)
    inner = H * DH
    q, k, v = (x[..., i * inner:(i + 1) * inner].reshape(B, n, H, DH).transpose(0, 2, 1, 3)
               for i in range(3))
    s = np.einsum("bhid,bhjd->bhij", q, k) * scale
    r, c = np.arange(n)[:, None], np.arange(n)[None, :]
    allowed = ((r >= NS) & (c >= NS)) | ((r < NS) & ((c == r) | (c >= NS)))
    s = np.where(allowed, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    sigma = p / p.sum(-1, keepdims=True)
    thresh = keep_threshold(rate)
    keep = flash_qkv.flash_qkv_bits(B, H, n, seeds, "cpu").numpy() < thresh
    sigma = np.where(keep, sigma * inv_keep_scale(thresh), 0.0)
    ref = np.einsum("bhij,bhjd->bhid", sigma, v).transpose(0, 2, 1, 3).reshape(B, n, inner)
    _assert_close(out.numpy(), ref)
    assert not keep.all()


@pytest.mark.parametrize("n", LONG_N)
@pytest.mark.parametrize("kernel", ["k3_rate0", "k4"])
def test_k3_and_k4_match_jax_at_long_n(kernel, n):
    """Forward and gradient of ``flash_attention_dropout`` at rate 0 (which
    is K4 in both packages) and of ``flash_attention``; K4's lse too."""
    q, k, v, g = _heads(n + 2, n)

    def jfwd(q_, k_, v_):
        if kernel == "k4":
            return jax_flash.flash_attention(q_, k_, v_, num_special=NS)
        return jax_fd.flash_attention_dropout(q_, k_, v_, jax.random.PRNGKey(0), 0.0,
                                              num_special=NS)

    def jloss(q_, k_, v_):
        o = jfwd(q_, k_, v_)
        return jnp.sum(o * jnp.asarray(g)), o

    (_, ref_o), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    if kernel == "k4":
        out = flash.flash_attention(*ts, num_special=NS)
    else:
        out = flash_dropout.flash_attention_dropout(*ts, seeds=(1, 2), rate=0.0,
                                                    num_special=NS)
    out.backward(torch.tensor(g))
    _assert_close(out.detach().numpy(), np.asarray(ref_o))
    for t, r in zip(ts, ref_grads):
        _assert_close(t.grad.numpy(), np.asarray(r))
    if kernel == "k4":
        _, ref_lse = jax_flash._fwd(*(jnp.asarray(t) for t in (q, k, v)), DH ** -0.5, NS)
        _, lse = flash.flash_fwd_plain(*(torch.tensor(t) for t in (q, k, v)), DH ** -0.5, NS)
        _assert_close(lse.numpy(), np.asarray(ref_lse))


@pytest.mark.parametrize("attention", ["pallas", "pallas_qkv"])
def test_dual_token_vit_past_576_tokens_matches_jax(attention):
    """One layer at a tiny width, patch 3 on 84x84 (784 patches, 786 tokens
    in the shared stream), on the route's attention and the fused FFN."""
    cfg = dict(dim=32, patch_size=3, depth=1, heads=H, dim_head=DH, mlp_dim=64)

    def jax_vit(**impl):
        return JaxViT(cfg=jax_config.ViTConfig(**cfg), image_size=84, channels=4,
                      shared_patch_stream=True, dtype=jnp.float32, **impl)

    img = np.random.default_rng(7).random((1, 4, 84, 84)).astype(np.float32)
    # the parameter tree in init's shapes, drawn with numpy (no init to run)
    variables = {"params": random_tree(jax.eval_shape(jax_vit().init, jax.random.PRNGKey(5),
                                                      jnp.asarray(img))["params"], 5)}
    ref = jax_vit(attention_impl=attention, ffn_impl="pallas").apply(variables,
                                                                     jnp.asarray(img))
    route = port_config.attention_route(port_config.Config(attention_impl=attention))
    vit = DualTokenViT(port_config.ViTConfig(**cfg), 84, 4, attention_route=route,
                       ffn_route="kernel", shared_patch_stream=True, dtype=torch.float32)
    load_flax_tree(vit, variables["params"])
    with torch.no_grad():
        out = vit(torch.tensor(img))
    for o, r in zip(out, ref):
        _assert_close(o.numpy(), np.asarray(r))
