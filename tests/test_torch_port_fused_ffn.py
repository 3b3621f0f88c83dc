"""K2 of the torch port (eavit_tpu_torch/ops/fused_ffn) against the JAX package.

At rate 0 the plain torch version is held to ``eavit_tpu``'s Pallas kernel
in interpret mode (the JAX package's own CPU path), on a ragged row count,
at float32 (tolerance 1e-5) and bfloat16 (2e-2: the LN output, both weights
and the hidden activations are rounded to bf16). The JAX weights
``[in, out]`` go in transposed, in the torch ``[out, in]`` layout. At rate
0.1 the plain version must equal a numpy composition under the replayed
masks. The numerics of the CUDA kernel's float32 path (fc1 and fc2 on bf16
tensor cores, each operand as hi + lo bf16 planes, three products summed in
f32) are emulated in torch on weights whose fc2 sums nearly cancel and held
to the Pallas kernel at 1e-4 of the output's scale; one bf16 term per
operand must err at least 10x as much. The CUDA kernel is held to the plain
version on a GPU by test_torch_port_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import fused_ffn as jax_ff
from eavit_tpu_torch.ops import fused_ffn as ff
from eavit_tpu_torch.ops.kernel_prng import inv_keep_scale, keep_threshold

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, rows, dim, hidden):
    """x [rows, dim] and JAX-layout params (w1 [dim, hidden], w2 [hidden, dim])."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(rows, dim)
    params = (1.0 + 0.1 * f(dim), 0.1 * f(dim), f(dim, hidden) / math.sqrt(dim),
              0.1 * f(hidden), f(hidden, dim) / math.sqrt(hidden), 0.1 * f(dim))
    return x, params


def _torch_params(params, device="cpu"):
    g, b, w1, c1, w2, c2 = params
    return tuple(torch.tensor(np.ascontiguousarray(p), device=device)
                 for p in (g, b, w1.T, c1, w2.T, c2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [37, 130])
def test_plain_matches_jax_kernel(rows, dtype):
    dim, hidden = 32, 64
    x, params = _inputs(rows, rows, dim, hidden)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = jax_ff.fused_ffn(jnp.asarray(x, jdt), *(jnp.asarray(p) for p in params))
    out = ff.fused_ffn(torch.tensor(x).to(tdt), *_torch_params(params))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out.dtype == tdt and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


def _np_gelu(h):
    return 0.5 * h * (1.0 + ff.erf_as(torch.tensor(h / np.sqrt(2.0))).numpy())


def test_plain_dropout_is_the_numpy_composition():
    rows, dim, hidden, rate, seeds, eps = 21, 32, 64, 0.1, (3, 4), 1e-5
    x, params = _inputs(1, rows, dim, hidden)
    out = ff.fused_ffn(torch.tensor(x).reshape(3, 7, dim), *_torch_params(params),
                       seeds=seeds, rate=rate, eps=eps).reshape(rows, dim)

    g, b, w1, c1, w2, c2 = params
    mu = x.mean(-1, keepdims=True)
    xc = x - mu
    u = xc / np.sqrt((xc * xc).mean(-1, keepdims=True) + eps) * g + b
    thresh = keep_threshold(rate)
    m1, m2 = (m.numpy() < thresh for m in ff.fused_ffn_bits(rows, dim, hidden, seeds, "cpu"))
    h = np.where(m1, _np_gelu(u @ w1 + c1) * inv_keep_scale(thresh), 0.0)
    ref = np.where(m2, (h @ w2 + c2) * inv_keep_scale(thresh), 0.0)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    assert not m1.all() and not m2.all()


def test_erf_is_the_jax_formula():
    h = np.linspace(-6.0, 6.0, 1001).astype(np.float32)
    np.testing.assert_allclose(ff.gelu_exact(torch.tensor(h)).numpy(),
                               np.asarray(jax_ff._gelu_exact(jnp.asarray(h))),
                               rtol=1e-6, atol=1e-7)


def test_entry_checks():
    x, params = _inputs(0, 4, 32, 64)
    with pytest.raises(ValueError):
        ff.fused_ffn(torch.tensor(x), *_torch_params(params), rate=0.1)


def _terms(a, split):
    """An f32 operand as the kernel feeds it to a bf16 mma: ``(hi, lo)``, ``hi
    = bf16(a)`` and ``lo = bf16(a - hi)`` widened back to f32, or
    ``(bf16(a),)`` alone."""
    hi = a.to(torch.bfloat16).float()
    return (hi, (a - hi).to(torch.bfloat16).float()) if split else (hi,)


def _product(a, b, split):
    """``a @ b`` as the kernel takes it: hi hi + hi lo + lo hi, each summed in
    f32 (``split``), or one product of the bf16 roundings."""
    ta, tb = _terms(a, split), _terms(b, split)
    out = torch.matmul(ta[0], tb[0])
    if split:
        out = out + torch.matmul(ta[0], tb[1]) + torch.matmul(ta[1], tb[0])
    return out


def test_three_term_forward_keeps_float32():
    """The float32 K2f on the tensor cores, emulated: LayerNorm in f32, fc1
    and fc2 through :func:`_product`, rate 0. The hidden units come in pairs
    with equal W1 rows and W2 columns of opposite sign plus 10% noise, so
    each output sums terms that cancel to under a fifth of their magnitudes.
    Held to the Pallas kernel within 1e-4 of the output's scale; one bf16
    term per operand errs at least 10x as much. (Each three-term product
    keeps about 2^-16 of its terms' magnitudes, so a sum that cancels to 1%
    of them would keep only about 3e-4 of itself.)"""
    rows, dim, hidden, eps = 37, 64, 128, 1e-5
    rng = np.random.default_rng(7)
    f = lambda *s_: rng.standard_normal(s_).astype(np.float32)  # noqa: E731
    half = hidden // 2
    w1h = f(half, dim) / math.sqrt(dim)
    w2h = f(dim, half) / math.sqrt(hidden)
    w1 = np.concatenate([w1h, w1h + 0.1 * f(half, dim) / math.sqrt(dim)], axis=0)
    w2 = np.concatenate([w2h, -w2h + 0.1 * f(dim, half) / math.sqrt(hidden)], axis=1)
    x, ln_w, ln_b, b1, b2 = f(rows, dim), 1.0 + 0.1 * f(dim), 0.1 * f(dim), 0.1 * f(
        hidden), 0.01 * f(dim)
    b1 = np.concatenate([b1[:half], b1[:half]])
    ref = np.asarray(jax_ff.fused_ffn(*(jnp.asarray(a) for a in (
        x, ln_w, ln_b, w1.T, b1, w2.T, b2))), np.float32)

    t = [torch.tensor(a) for a in (x, ln_w, ln_b, w1, b1, w2, b2)]
    mu = t[0].mean(dim=-1, keepdim=True)
    xc = t[0] - mu
    u = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps) * t[1] + t[2]
    scale = float(np.abs(ref).max())
    g = ff.gelu_exact(u @ t[3].t() + t[4])
    magnitude = float((g.abs() @ t[5].t().abs()).max())
    assert scale < 0.2 * magnitude, (scale, magnitude)  # the sums nearly cancel
    errs = {}
    for split in (True, False):
        g = ff.gelu_exact(_product(u, t[3].t(), split) + t[4])
        y = _product(g, t[5].t(), split) + t[6]
        errs[split] = float(np.abs(y.numpy() - ref).max()) / scale
    assert errs[True] <= 1e-4, errs
    assert errs[False] >= 10 * errs[True], errs
