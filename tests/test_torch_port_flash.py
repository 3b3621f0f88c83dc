"""K4f and K4b of the torch port (eavit_tpu_torch/ops/flash) against the JAX
package.

The forward of ``flash_attention`` and its gradient through the port's
``autograd.Function`` (the plain versions on the CPU) are held to
``eavit_tpu.ops.flash.flash_attention`` and ``jax.grad`` of it, which run the
Pallas ``_fwd_kernel`` and ``_bwd_kernel`` in interpret mode on the CPU, on
ragged sequence lengths with and without the dual-query mask: float32 at 1e-5
of each output's scale, bfloat16 at 2e-2 (the rounding of o, dq, dk and dv to
bf16, and a cotangent that reaches the JAX backward through the bf16 output).
The row log-sum-exp is held to the one the Pallas forward returns (1e-5). The
explicit plain backward must equal torch autograd through the plain forward
(1e-5). A head width between the kernels' 16 / 32 / 64 runs zero-padded to
the next of them: padded by ``_build.pad_last``, through the plain versions
at the padded width and sliced back, it must equal the JAX kernels at the
true width (24 and 48, float32, 1e-5). The CUDA kernels are held to the
plain versions on a GPU by test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import flash as jax_flash
from eavit_tpu_torch.ops import _build, flash

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, h, n, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(4)]


def _assert_close(ours, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", [11, 13])
def test_forward_and_gradient_match_jax(n, num_special, dtype):
    b, h, dh = 3, 2, 8
    q, k, v, g = _inputs(n, b, h, n, dh)
    jdt, tdt = JDT[dtype], TDT[dtype]
    tol = 1e-5 if dtype == "float32" else 2e-2
    jq, jk, jv = (jnp.asarray(t, jdt) for t in (q, k, v))
    jg = jnp.asarray(g, jdt).astype(jnp.float32)

    def jloss(q_, k_, v_):
        o = jax_flash.flash_attention(q_, k_, v_, num_special=num_special)
        return jnp.sum(o.astype(jnp.float32) * jg)

    ref_o = jax_flash.flash_attention(jq, jk, jv, num_special=num_special)
    ref_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    ts = [torch.tensor(t).to(tdt).requires_grad_() for t in (q, k, v)]
    out = flash.flash_attention(*ts, num_special=num_special)
    assert out.dtype == tdt and out.shape == (b, h, n, dh)
    _assert_close(out.detach().float().numpy(), np.asarray(ref_o, np.float32), tol)
    out.backward(torch.tensor(g).to(tdt))
    for t, r in zip(ts, ref_grads):
        assert t.grad.dtype == tdt
        _assert_close(t.grad.float().numpy(), np.asarray(r, np.float32), tol)
    if dtype == "float32":
        _, ref_lse = jax_flash._fwd(jq, jk, jv, dh ** -0.5, num_special)
        _, lse = flash.flash_fwd_plain(*(t.detach() for t in ts), dh ** -0.5, num_special)
        _assert_close(lse.numpy(), np.asarray(ref_lse), 1e-5)


@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_backward_is_autograd_of_the_plain_forward(num_special):
    b, h, n, dh = 2, 2, 13, 8
    q, k, v, g = _inputs(5, b, h, n, dh)
    scale = 0.3
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    o, lse = flash.flash_fwd_plain(*leaves, scale, num_special)
    ref = torch.autograd.grad(o, leaves, torch.tensor(g))
    before = dict(flash.launches)
    ours = flash.flash_bwd(*(t.detach() for t in leaves), o.detach(), lse.detach(),
                           torch.tensor(g), scale, num_special)
    for a, r in zip(ours, ref):
        _assert_close(a.numpy(), r.numpy(), 1e-5)
    assert flash.launches == before  # CPU tensors take the plain versions


def test_mha_dispatches_the_pallas_impl():
    """``mha(impl="pallas")`` is K4 without dropout and K3 with seeds;
    ``pallas_stream`` is K5 (ops/flash_stream), which takes no dropout rate."""
    from eavit_tpu_torch.ops import flash_dropout, flash_stream
    from eavit_tpu_torch.ops.attention import mha

    q, k, v, _ = (torch.tensor(t) for t in _inputs(8, 2, 2, 11, 8))
    assert torch.equal(mha(q, k, v, impl="pallas", num_special=2),
                       flash.flash_attention(q, k, v, num_special=2))
    assert torch.equal(mha(q, k, v, impl="pallas", dropout_rate=0.1, seeds=(3, 4)),
                       flash_dropout.flash_attention_dropout(q, k, v, (3, 4), 0.1))
    assert torch.equal(mha(q, k, v, impl="pallas_stream"),
                       flash_stream.flash_attention_stream(q, k, v))
    with pytest.raises(ValueError, match="pallas_stream"):
        mha(q, k, v, impl="pallas_stream", dropout_rate=0.1, seeds=(3, 4))
    with pytest.raises(ValueError):
        mha(q, k, v, impl="other")


@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("dim_head", [24, 48, 96, 128])
def test_padded_head_width_is_the_unpadded_function(dim_head, num_special):
    """What the K4 wrappers do for a head width the kernels are not built for:
    q, k, v, O and dO zero-padded to ``_build.kernel_dim_head`` (32, 64, 128;
    128 itself unpadded, the widest instantiation), K4f
    and K4b at that width with the caller's scale, the outputs sliced back.
    Held to the JAX kernels (and ``jax.grad``) at the true width."""
    b, h, n = 2, 2, 13
    q, k, v, g = _inputs(dim_head + n, b, h, n, dim_head)
    scale = dim_head ** -0.5
    width = _build.kernel_dim_head("test", dim_head)
    assert width == {24: 32, 48: 64, 96: 128, 128: 128}[dim_head]
    pq, pk, pv, pg = (_build.pad_last(torch.tensor(t), width) for t in (q, k, v, g))
    o, lse = flash.flash_fwd_plain(pq, pk, pv, scale, num_special)
    grads = flash.flash_bwd_plain(pq, pk, pv, o, lse, pg, scale, num_special)

    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))

    def jloss(q_, k_, v_):
        o_ = jax_flash.flash_attention(q_, k_, v_, num_special=num_special)
        return jnp.sum(o_ * jnp.asarray(g))

    ref_o, ref_lse = jax_flash._fwd(jq, jk, jv, scale, num_special)
    _assert_close(o[..., :dim_head].numpy(), np.asarray(ref_o), 1e-5)
    assert not o[..., dim_head:].any()  # zero columns out of zero v columns
    _assert_close(lse.numpy(), np.asarray(ref_lse), 1e-5)
    for a, r in zip(grads, jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)):
        _assert_close(a[..., :dim_head].numpy(), np.asarray(r), 1e-5)
