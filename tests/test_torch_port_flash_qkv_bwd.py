"""K1b of the torch port (the backward of eavit_tpu_torch/ops/flash_qkv)
against the JAX package.

At rate 0 the gradient of ``flash_mha_qkv`` through the port's
``autograd.Function`` (the plain backward on the CPU) is held to ``jax.grad``
of ``eavit_tpu.ops.flash_qkv.flash_mha_qkv``, which runs the Pallas
``_bwd_kernel`` in interpret mode on the CPU, on ragged sequence lengths with
and without the dual-query mask and at the flagship N = 198 (``Dh`` = 32,
``num_special`` = 2), at float32 (1e-5 of the gradient's scale) and bfloat16
(2e-2: the roundings of pd, ds and dqkv to bf16). At rate 0.1 the
explicit plain backward must equal torch autograd through the plain forward,
which proves that it replays the forward's mask (float32, 1e-5). The CUDA
kernel is held to the plain backward on a GPU by test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import flash_qkv as jax_fq
from eavit_tpu_torch.ops import flash_qkv as fq


def _inputs(seed, b, n, heads, dim_head):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * dim_head)).astype(np.float32)
    do = rng.standard_normal((b, n, heads * dim_head)).astype(np.float32)
    return qkv, do


def _assert_close(ours, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


# (n, num_special, dtype, (b, heads, dim_head)): ragged short sequences, and
# the flagship N = 198 at the flagship head width, which the bf16 CUDA kernel
# pads to 13 tiles of 16 rows
JAX_GRAD_CASES = [(n, ns, dt, (3, 2, 8)) for n in (11, 13) for ns in (0, 2)
                  for dt in ("float32", "bfloat16")] + [
    (198, 2, dt, (1, 2, 32)) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("n,num_special,dtype,shape", JAX_GRAD_CASES,
                         ids=[f"{n}-{ns}-{dt}" for n, ns, dt, _ in JAX_GRAD_CASES])
def test_backward_matches_jax_grad_through_the_kernel(n, num_special, dtype, shape):
    b, heads, dim_head = shape
    x, g = _inputs(n, b, n, heads, dim_head)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def jloss(q):
        o = jax_fq.flash_mha_qkv(q, heads, dim_head, num_special=num_special)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g, jdt).astype(jnp.float32))

    ref = jax.grad(jloss)(jnp.asarray(x, jdt))
    qkv = torch.tensor(x).to(tdt).requires_grad_()
    out = fq.flash_mha_qkv(qkv, heads, dim_head, num_special=num_special)
    out.backward(torch.tensor(g).to(tdt))
    assert qkv.grad.dtype == tdt and qkv.grad.shape == qkv.shape
    _assert_close(qkv.grad.float().numpy(), np.asarray(ref, np.float32),
                  1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_backward_is_autograd_of_the_plain_forward(num_special, rate):
    b, n, heads, dim_head, seeds = 2, 13, 2, 8, (17, 29)
    x, g = _inputs(7, b, n, heads, dim_head)
    scale = dim_head ** -0.5
    qkv = torch.tensor(x, requires_grad=True)
    o, lse = fq.flash_qkv_fwd_plain(qkv, heads, dim_head, scale, num_special, seeds, rate)
    (ref,) = torch.autograd.grad(o, qkv, torch.tensor(g))
    ours = fq.flash_qkv_bwd_plain(qkv.detach(), lse.detach(), torch.tensor(g), heads,
                                  dim_head, scale, num_special, seeds, rate)
    _assert_close(ours.numpy(), ref.numpy(), 1e-5)
    if rate:
        # another seed is another mask: the backward depends on the replay
        other = fq.flash_qkv_bwd_plain(qkv.detach(), lse.detach(), torch.tensor(g),
                                       heads, dim_head, scale, num_special, (1, 2), rate)
        assert not torch.allclose(other, ours, atol=1e-3)


def test_function_backward_replays_the_mask_and_counts_no_launch():
    b, n, heads, dim_head, seeds, rate = 2, 11, 2, 8, (3, 4), 0.1
    x, g = _inputs(9, b, n, heads, dim_head)
    before = dict(fq.launches)
    qkv = torch.tensor(x, requires_grad=True)
    fq.flash_mha_qkv(qkv, heads, dim_head, seeds=seeds, rate=rate,
                     num_special=2).backward(torch.tensor(g))
    ref_in = torch.tensor(x, requires_grad=True)
    o, _ = fq.flash_qkv_fwd_plain(ref_in, heads, dim_head, dim_head ** -0.5, 2, seeds, rate)
    o.backward(torch.tensor(g))
    _assert_close(qkv.grad.numpy(), ref_in.grad.numpy(), 1e-5)
    assert fq.launches == before  # CPU tensors take the plain versions
    # an input that needs no gradient gets none, and no error
    out = fq.flash_mha_qkv(torch.tensor(x), heads, dim_head)
    assert not out.requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_attention_route_gradients_match_jax(num_special, dtype):
    """``ops/attention.mha`` (``AttentionImpl = xla``) under torch autograd
    against ``jax.grad`` of the JAX ``mha``. The JAX softmax backward runs on
    the probabilities rounded to v's dtype (``_softmax_cast``), torch's on the
    float32 ones: equal at float32 (1e-5), about 2^-8 apart at bf16 (2e-2)."""
    from eavit_tpu.ops.attention import mha as jax_mha
    from eavit_tpu_torch.ops.attention import mha

    rng = np.random.default_rng(21)
    q, k, v, g = (rng.standard_normal((2, 2, 11, 8)).astype(np.float32) for _ in range(4))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def jloss(q_, k_, v_):
        o = jax_mha(q_, k_, v_, num_special=num_special)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g, jdt).astype(jnp.float32))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(t, jdt) for t in (q, k, v)))
    ts = [torch.tensor(t).to(tdt).requires_grad_() for t in (q, k, v)]
    mha(*ts, num_special=num_special).backward(torch.tensor(g).to(tdt))
    for t, r in zip(ts, ref):
        _assert_close(t.grad.float().numpy(), np.asarray(r, np.float32),
                      1e-5 if dtype == "float32" else 2e-2)
