"""K1 of the torch port (eavit_tpu_torch/ops/flash_qkv) against the JAX package.

At rate 0 the plain torch version is held to ``eavit_tpu``'s Pallas kernel,
run as the JAX package's own tests run it on the CPU (interpret mode), on
ragged sequence lengths with and without the dual-query mask, at float32
(tolerance 1e-5) and bfloat16 (2e-2: bf16 rounding of sigma and of o).
At rate 0.1 the plain version must equal a numpy composition under the
replayed mask. A head width between the kernels' 16 / 32 / 64 runs
zero-padded to the next of them: the merged layout padded by
``_build.pad_heads``, through the plain K1f and K1b at the padded width and
sliced back by ``_build.unpad_heads``, must equal the JAX kernel and
``jax.grad`` of it at the true width (24 and 48, float32, 1e-5). The CUDA
kernel is held to the plain version on a GPU by test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import flash_qkv as jax_fq
from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops import flash_qkv as fq
from eavit_tpu_torch.ops.kernel_prng import inv_keep_scale, keep_threshold

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(seed, b, n, heads, dim_head):
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3 * heads * dim_head)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", [11, 13])
def test_plain_matches_jax_kernel(n, num_special, dtype):
    b, heads, dim_head = 3, 2, 8
    x = _qkv(n, b, n, heads, dim_head)
    scale = dim_head ** -0.5
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    # the JAX forward with its lse (interpret mode on the CPU at rate 0)
    jo, jlse = jax_fq._fwd(jnp.asarray(x, jdt), jnp.zeros((2,), jnp.int32), scale,
                           heads, dim_head, num_special, None)
    to, tlse = fq.flash_qkv_fwd(torch.tensor(x).to(tdt), heads, dim_head, scale,
                                num_special)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert to.dtype == tdt and to.shape == (b, n, heads * dim_head)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), **tol)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:b, :, :n], **tol)
    # the public entry agrees with the JAX public entry too
    out = fq.flash_mha_qkv(torch.tensor(x).to(tdt), heads, dim_head,
                           num_special=num_special)
    ref = jax_fq.flash_mha_qkv(jnp.asarray(x, jdt), heads, dim_head,
                               num_special=num_special)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_dropout_is_the_numpy_composition(num_special):
    b, n, heads, dim_head, rate, seeds = 2, 13, 2, 8, 0.1, (17, 29)
    x = _qkv(5, b, n, heads, dim_head)
    scale = dim_head ** -0.5
    out, _ = fq.flash_qkv_fwd(torch.tensor(x), heads, dim_head, scale, num_special,
                              seeds, rate)

    inner = heads * dim_head
    q, k, v = (x[..., i * inner:(i + 1) * inner].reshape(b, n, heads, dim_head)
               .transpose(0, 2, 1, 3) for i in range(3))
    s = np.einsum("bhid,bhjd->bhij", q, k) * scale
    if num_special:
        r, c = np.arange(n)[:, None], np.arange(n)[None, :]
        allowed = ((r >= num_special) & (c >= num_special)) | (
            (r < num_special) & ((c == r) | (c >= num_special)))
        s = np.where(allowed, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    sigma = p / p.sum(-1, keepdims=True)
    thresh = keep_threshold(rate)
    keep = fq.flash_qkv_bits(b, heads, n, seeds, "cpu").numpy() < thresh
    sigma = np.where(keep, sigma * inv_keep_scale(thresh), 0.0)
    ref = np.einsum("bhij,bhjd->bhid", sigma, v).transpose(0, 2, 1, 3).reshape(b, n, inner)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    # the mask really dropped something, and rate 0 draws nothing
    assert not keep.all()
    out0, _ = fq.flash_qkv_fwd(torch.tensor(x), heads, dim_head, scale, num_special)
    assert not torch.allclose(out0, out)


def test_entry_checks():
    x = torch.zeros(1, 4, 3 * 2 * 8)
    with pytest.raises(ValueError):
        fq.flash_mha_qkv(x, 2, 4)  # last dim is not 3*heads*dim_head
    with pytest.raises(ValueError):
        fq.flash_mha_qkv(x, 2, 8, rate=0.1)  # rate > 0 needs seeds


@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("dim_head", [24, 48, 96, 128])
def test_padded_head_width_is_the_unpadded_function(dim_head, num_special):
    """What the K1 wrappers do for a head width the kernels are not built for:
    the merged ``[B, N, 3*H*Dh]`` layout with each head zero-padded to
    ``_build.kernel_dim_head`` (32, 64, 128; 128 itself unpadded), K1f and K1b at that width with the
    caller's scale, each head sliced back. Held to the JAX kernel (and
    ``jax.grad`` of it) at the true width, rate 0."""
    b, n, heads = 2, 13, 2
    x = _qkv(dim_head, b, n, heads, dim_head)
    g = np.random.default_rng(dim_head + 1).standard_normal(
        (b, n, heads * dim_head)).astype(np.float32)
    scale = dim_head ** -0.5
    width = _build.kernel_dim_head("test", dim_head)
    px = _build.pad_heads(torch.tensor(x), 3 * heads, width)
    assert px.shape == (b, n, 3 * heads * width)
    o, lse = fq.flash_qkv_fwd_plain(px, heads, width, scale, num_special)
    d = fq.flash_qkv_bwd_plain(px, lse, _build.pad_heads(torch.tensor(g), heads, width),
                               heads, width, scale, num_special)
    o, d = _build.unpad_heads(o, heads, dim_head), _build.unpad_heads(d, 3 * heads, dim_head)

    jo, jlse = jax_fq._fwd(jnp.asarray(x), jnp.zeros((2,), jnp.int32), scale, heads,
                           dim_head, num_special, None)
    ref = jax.grad(lambda t: jnp.sum(jax_fq.flash_mha_qkv(
        t, heads, dim_head, num_special=num_special) * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:b, :, :n], **F32_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref), **F32_TOL)
