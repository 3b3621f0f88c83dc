"""K2b of the torch port (the backward of eavit_tpu_torch/ops/fused_ffn)
against the JAX package.

At rate 0 all seven gradients of ``fused_ffn`` through the port's
``autograd.Function`` (the plain backward on the CPU) are held to ``jax.grad``
of ``eavit_tpu.ops.fused_ffn.fused_ffn``, which runs the Pallas
``_bwd_kernel`` in interpret mode on the CPU, on row counts that fill no
block (37 and 130), at float32 (1e-5 of each gradient's scale) and bfloat16
input (2e-2: the roundings of u, gd, dy0, dh and dx to bf16). The JAX weights
are ``[in, out]``, the port's ``[out, in]``. At rate 0.1 the explicit plain
backward must equal torch autograd through the plain forward, which proves
that it replays both masks (float32, 1e-5). The CUDA kernel is held to the
plain backward on a GPU by test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import fused_ffn as jax_ff
from eavit_tpu_torch.ops import fused_ffn as ff

NAMES = ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")


def _inputs(seed, rows, dim, hidden):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(rows, dim), ln_w=1.0 + 0.1 * f(dim), ln_b=0.1 * f(dim),
                w1=f(hidden, dim) / float(np.sqrt(dim)), b1=0.1 * f(hidden),
                w2=f(dim, hidden) / float(np.sqrt(hidden)), b2=0.1 * f(dim)), f(rows, dim)


def _assert_close(ours, ref, tol, name):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [37, 130])
def test_backward_matches_jax_grad_through_the_kernel(rows, dtype):
    dim, hidden = 48, 96
    p, g = _inputs(rows, rows, dim, hidden)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def jloss(x, ln_w, ln_b, w1, b1, w2, b2):
        y = jax_ff.fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g, jdt).astype(jnp.float32))

    jargs = [jnp.asarray(p["x"], jdt), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]),
             jnp.asarray(p["w1"].T), jnp.asarray(p["b1"]), jnp.asarray(p["w2"].T),
             jnp.asarray(p["b2"])]
    ref = dict(zip(NAMES, jax.grad(jloss, argnums=tuple(range(7)))(*jargs)))
    ref["w1"], ref["w2"] = ref["w1"].T, ref["w2"].T  # to [out, in]

    targs = [torch.tensor(p["x"]).to(tdt).requires_grad_()] + [
        torch.tensor(p[k]).requires_grad_() for k in NAMES[1:]]
    ff.fused_ffn(*targs).backward(torch.tensor(g).to(tdt))
    assert targs[0].grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, t in zip(NAMES, targs):
        assert t.grad.shape == t.shape
        if name != "x":
            assert t.grad.dtype == torch.float32
        _assert_close(t.grad.float().numpy(), np.asarray(ref[name], np.float32), tol, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", [37, 130])
def test_plain_backward_is_autograd_of_the_plain_forward(rows, rate):
    dim, hidden, seeds = 48, 96, (5, 6)
    p, g = _inputs(rows + 1, rows, dim, hidden)
    args = [torch.tensor(p[k], requires_grad=True) for k in NAMES]
    y = ff.fused_ffn_fwd_plain(*args, seeds=seeds, rate=rate)
    ref = torch.autograd.grad(y, args, torch.tensor(g))
    with torch.no_grad():
        ours = ff.fused_ffn_bwd_plain(*args[:6], torch.tensor(g), seeds, rate)
    # the explicit order: dx, dln_w, dln_b, dw1, db1, dw2, db2
    for name, a, b in zip(NAMES, ours, ref):
        _assert_close(a.numpy(), b.numpy(), 1e-5, name)
    if rate:
        other = ff.fused_ffn_bwd_plain(*(a.detach() for a in args[:6]), torch.tensor(g),
                                       (1, 2), rate)
        assert not torch.allclose(other[0], ours[0], atol=1e-3)


def test_function_backward_honours_needs_input_grad_and_counts_no_launch():
    p, g = _inputs(3, 37, 48, 96)
    before = dict(ff.launches)
    args = [torch.tensor(p[k]) for k in NAMES]
    args[0].requires_grad_()
    args[3].requires_grad_()  # x and w1 only
    y = ff.fused_ffn(args[0].reshape(1, 37, 48), *args[1:], seeds=(8, 9), rate=0.1)
    assert y.shape == (1, 37, 48)
    y.backward(torch.tensor(g).reshape(1, 37, 48))
    assert args[0].grad is not None and args[3].grad is not None
    assert all(a.grad is None for i, a in enumerate(args) if i not in (0, 3))
    assert ff.launches == before  # CPU tensors take the plain versions
    with pytest.raises(ValueError):
        ff.fused_ffn(args[0], *args[1:], rate=0.1)  # rate > 0 needs seeds
